"""`run_events_analysis.py` -- legacy frontend.

Parity: misopy/run_events_analysis.py.  In modern usage it supplies the
GFF/BAM sanity checks and points users at `miso --run`; the legacy
event-file flags print the same deprecation guidance as the reference.
"""
from __future__ import annotations

import argparse
import os
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="run_events_analysis.py")
    p.add_argument("--check", dest="check", nargs=2, default=None,
                   metavar=("INDEX_DIR", "BAM"),
                   help="Run GFF/BAM consistency checks.")
    p.add_argument("--compute-genes-psi", dest="compute_genes_psi", nargs=2,
                   default=None)
    args = p.parse_args(argv)
    if args.check is not None:
        from miso_jax.io.sanity import check_gff_and_bam, setup_logger
        setup_logger(None)
        warnings = check_gff_and_bam(
            os.path.abspath(args.check[0]), os.path.abspath(args.check[1]))
        print("%d warnings." % len(warnings))
        return 0
    print("run_events_analysis.py is deprecated; use `miso --run` "
          "(see README).", file=sys.stderr)
    return 1


if __name__ == "__main__":
    sys.exit(main())
