"""`index_gff` CLI.  Flag parity: misopy/index_gff.py:168-196."""
from __future__ import annotations

import argparse
import os
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="index_gff")
    p.add_argument("--index", dest="index_gff", nargs=2, default=None,
                   metavar=("GFF", "OUTPUT_DIR"))
    p.add_argument("--compress-id", dest="compress_id", action="store_true",
                   default=False)
    args = p.parse_args(argv)
    if args.index_gff is None:
        print("Indexer of GFF files for use with MISO.")
        print("Need to pass --index, for example:\n")
        print("index_gff --index annotation.gff indexed_annotation/")
        return 1
    from miso_jax.io.index import index_gff
    gff_filename = os.path.abspath(os.path.expanduser(args.index_gff[0]))
    output_dir = os.path.abspath(os.path.expanduser(args.index_gff[1]))
    os.makedirs(output_dir, exist_ok=True)
    index_gff(gff_filename, output_dir, compress_id=args.compress_id)
    return 0


if __name__ == "__main__":
    sys.exit(main())
