"""Profile the host event-compile phase (ingest -> device tensors) alone.

Usage: python scripts/compile_profile.py [num_genes] [--cprofile]

Replicates compute_all_genes_psi's compile loop (pipeline.py) on the
cached e2e fixture (`bench.py --e2e` builds it) without touching the
device, so the single-thread host compile throughput can be measured
and profiled in isolation.
"""
import cProfile
import os
import pstats
import sys
import time

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np

from miso_jax.pipeline import RunConfig, compile_gene_event, event_output_path
from miso_jax.io import sam as sam_io
from miso_jax.io.index import get_gene_ids_to_filenames, load_indexed_gene


def compile_catalog(idx, bam, cfg):
    from miso_jax.pipeline import _CompileStream
    id_to_fname = get_gene_ids_to_filenames(idx)
    alignments = sam_io.open_alignments(bam)
    items = sorted(id_to_fname.items(), key=lambda kv: (kv[1], kv[0]))
    events = []
    stream = _CompileStream(items, alignments, cfg,
                            output_dir="/nonexistent-output",
                            verbose=False, emit=events.append)
    stream.run()
    return events


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 10000
    fixdir = os.path.join(os.environ.get("MISO_E2E_DIR", os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        ".bench")), "cat%d" % n)
    bam = os.path.join(fixdir, "catalog.bam")
    idx = os.path.join(fixdir, "index")
    assert os.path.isfile(bam), "run bench.py --e2e %d first" % n
    cfg = RunConfig(read_len=36, min_event_reads=20)
    if "--cprofile" in sys.argv:
        pr = cProfile.Profile()
        pr.enable()
        t0 = time.perf_counter()
        events = compile_catalog(idx, bam, cfg)
        dt = time.perf_counter() - t0
        pr.disable()
        stats = pstats.Stats(pr)
        stats.sort_stats("cumulative").print_stats(35)
    else:
        t0 = time.perf_counter()
        events = compile_catalog(idx, bam, cfg)
        dt = time.perf_counter() - t0
    print("compiled %d events in %.2fs = %.0f events/s"
          % (len(events), dt, len(events) / dt))


if __name__ == "__main__":
    main()
