"""`compare_miso` CLI.  Flag parity: misopy/run_miso.py:417-428."""
from __future__ import annotations

import argparse
import os
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="compare_miso")
    p.add_argument("--compare-samples", dest="samples", nargs=3, default=None,
                   metavar=("SAMPLES1_DIR", "SAMPLES2_DIR", "OUTPUT_DIR"))
    p.add_argument("--comparison-labels", dest="comparison_labels", nargs=2,
                   default=None)
    p.add_argument("--use-compressed", dest="use_compressed", default=None)
    args = p.parse_args(argv)
    if args.samples is None:
        print("Need --compare-samples DIR1 DIR2 OUTPUT_DIR", file=sys.stderr)
        return 1
    from miso_jax.io.comparison import output_samples_comparison
    d1, d2, out = (os.path.abspath(os.path.expanduser(x))
                   for x in args.samples)
    output_samples_comparison(
        d1, d2, out,
        sample_labels=tuple(args.comparison_labels)
        if args.comparison_labels else None,
        use_compressed=args.use_compressed)
    return 0


if __name__ == "__main__":
    sys.exit(main())
