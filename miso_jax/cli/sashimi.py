"""`sashimi_plot` -- visualization CLI (read densities, junction arcs,
MISO posterior panels).  Parity target: misopy/sashimi_plot/**."""
from __future__ import annotations

import argparse
import os
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="sashimi_plot")
    p.add_argument("--plot-event", dest="plot_event", nargs=3, default=None,
                   metavar=("EVENT_NAME", "INDEX_DIR", "SETTINGS"))
    p.add_argument("--plot-insert-len", dest="plot_insert_len", nargs=2,
                   default=None, metavar=("INSERT_LEN_FILE", "SETTINGS"))
    p.add_argument("--plot-bf-dist", dest="plot_bf_dist", nargs=2,
                   default=None, metavar=("BF_FILE", "SETTINGS"))
    p.add_argument("--output-dir", dest="output_dir", default=None)
    p.add_argument("--plot-title", dest="plot_title", default=None)
    p.add_argument("--plot-label", dest="plot_label", default=None)
    p.add_argument("--no-posteriors", dest="no_posteriors",
                   action="store_true", default=False)
    args = p.parse_args(argv)
    from miso_jax.plot.sashimi import (plot_bf_dist, plot_event,
                                       plot_insert_len)
    if args.output_dir is None:
        print("Need --output-dir", file=sys.stderr)
        return 1
    output_dir = os.path.abspath(os.path.expanduser(args.output_dir))
    os.makedirs(output_dir, exist_ok=True)
    if args.plot_event is not None:
        event_name, index_dir, settings = args.plot_event
        plot_event(event_name, os.path.abspath(index_dir),
                   os.path.abspath(settings), output_dir,
                   no_posteriors=args.no_posteriors,
                   plot_title=args.plot_title, plot_label=args.plot_label)
        return 0
    if args.plot_insert_len is not None:
        insert_len_file, settings = args.plot_insert_len
        plot_insert_len(os.path.abspath(insert_len_file),
                        os.path.abspath(settings), output_dir)
        return 0
    if args.plot_bf_dist is not None:
        bf_file, settings = args.plot_bf_dist
        plot_bf_dist(os.path.abspath(bf_file), os.path.abspath(settings),
                     output_dir)
        return 0
    p.print_help()
    return 1


if __name__ == "__main__":
    sys.exit(main())
