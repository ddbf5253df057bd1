"""`miso` -- main quantification CLI.

Flag parity with misopy/miso.py:429-626 (`miso --run index_dir reads.bam
--output-dir out --read-len N [--paired-end MEAN SD] ...`).  Cluster/fork
flags are accepted for compatibility; execution is single-process with
device-level batch parallelism (the accelerator replaces the process
fan-out).
"""
from __future__ import annotations

import argparse
import os
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="miso")
    p.add_argument("--run", dest="compute_genes_psi", nargs=2, default=None,
                   metavar=("INDEX_DIR", "READS"),
                   help="Quantify events: indexed GFF dir + sorted/indexed "
                        "BAM (or SAM) file.")
    p.add_argument("--settings-filename", dest="settings_filename",
                   default=None)
    p.add_argument("--read-len", dest="read_len", type=int, default=None)
    p.add_argument("--paired-end", dest="paired_end", nargs=2, default=None,
                   metavar=("MEAN", "SD"), type=float)
    p.add_argument("--overhang-len", dest="overhang_len", type=int,
                   default=None)
    p.add_argument("--output-dir", dest="output_dir", default=None)
    p.add_argument("--event-type", dest="event_type", default=None,
                   help="Optional event type tag (informational).")
    p.add_argument("--no-filter-events", dest="no_filter_events",
                   action="store_true", default=False)
    p.add_argument("--prefilter", dest="prefilter", action="store_true",
                   default=False)
    p.add_argument("-p", dest="num_proc", type=int, default=None,
                   help="Accepted for compatibility (device batching is "
                        "used instead of worker processes).")
    p.add_argument("--use-cluster", action="store_true", default=False,
                   help="Accepted for compatibility; use multi-host JAX "
                        "(miso --run ... with jax.distributed) instead.")
    p.add_argument("--chunk-jobs", dest="chunk_jobs", default=None)
    p.add_argument("--job-name", dest="job_name", default=None)
    p.add_argument("--SGEarray", action="store_true", default=False)
    p.add_argument("--no-wait", action="store_true", default=False)
    p.add_argument("--algorithm", dest="algorithm", default="reassign",
                   choices=["reassign", "marginal", "classes"],
                   help="Inference scheme (reference: "
                        "SPLICING_ALGO_* in splicing.h:59-62; 'classes' "
                        "is the fast read-class scheme).")
    p.add_argument("--convergent", action="store_true", default=False,
                   help="Adaptive stopping: run until Gelman-Rubin "
                        "R-hat <= 1.1, extending unconverged events by "
                        "3*iters - 2*burn_in (pysplicing/src/"
                        "miso.c:903-928); equivalent to settings "
                        "[sampler] stop = convergent.")
    p.add_argument("--convergent-growth", dest="convergent_growth",
                   type=float, default=2.0, metavar="G",
                   help="Convergent-mode extension factor: unconverged "
                        "events continue with iters' = iters + "
                        "G*(iters - burn_in) (default 2.0 is exactly "
                        "the reference rule noIter' = 3*noIter - "
                        "2*burnIn, miso.c:920-928; smaller values, "
                        "e.g. 1.0, extend stragglers in cheaper "
                        "increments under the same R-hat test).")
    p.add_argument("--linear-start", action="store_true", default=False,
                   help="Seed every chain from the NNLS linear "
                        "deconvolution instead of the AUTO start "
                        "(MISO_START_LINEAR, pysplicing/src/"
                        "miso.c:410-443; the reference exposes this "
                        "only through its C API).")
    p.add_argument("--pack-output", dest="pack_output",
                   action="store_true", default=False,
                   help="Stream events into per-chromosome .miso_db "
                        "sqlite files during the run (no .miso text "
                        "tree, no miso_pack pass afterwards).")
    p.add_argument("--summary-only", dest="summary_only",
                   action="store_true", default=False,
                   help="Skip .miso sample files: compute posterior "
                        "means + credible intervals ON DEVICE and "
                        "write only the .miso_summary table (the "
                        "run-then-summarize round-trip of "
                        "summarize_miso collapses into the run).")
    p.add_argument("--profile", dest="profile_dir", default=None,
                   metavar="DIR",
                   help="Write a jax.profiler device trace for the run "
                        "to DIR (view with TensorBoard) and log "
                        "per-bucket device time.")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--coordinator", dest="coordinator", default=None,
                   help="Multi-host: coordinator address host:port "
                        "(replaces the reference's qsub cluster layer).")
    p.add_argument("--num-hosts", dest="num_hosts", type=int, default=None)
    p.add_argument("--host-id", dest="host_id", type=int, default=None)
    p.add_argument("--use-compressed", dest="use_compressed", default=None)
    p.add_argument("--view-gene", dest="view_gene", default=None,
                   help="Inspect an indexed gene pickle file.")
    p.add_argument("--version", action="store_true", default=False)
    return p


def view_gene(pickle_path: str) -> None:
    """Ref: misopy/miso.py:593-617."""
    from miso_jax.io.index import load_indexed_gene
    data = load_indexed_gene(pickle_path)
    for gene_id, entry in data.items():
        gene = entry["gene_object"]
        print("Gene %s" % gene_id)
        print("  chrom=%s strand=%s isoforms=%d parts=%d"
              % (gene.chrom, gene.strand, gene.num_isoforms, len(gene.parts)))
        for i, iso in enumerate(gene.isoforms):
            print("  isoform %d (%s): parts=%s len=%d"
                  % (i, iso.label, list(iso.parts), gene.iso_length(i)))


def main(argv=None) -> int:
    from miso_jax import __version__
    from miso_jax.io.settings import Settings
    from miso_jax.pipeline import RunConfig, compute_all_genes_psi

    args = build_parser().parse_args(argv)
    if args.version:
        print("miso_jax v%s" % __version__)
        return 0
    if args.view_gene is not None:
        view_gene(args.view_gene)
        return 0
    if args.compute_genes_psi is None:
        print("Use --run INDEX_DIR READS --output-dir DIR --read-len N",
              file=sys.stderr)
        return 1
    if args.output_dir is None:
        print("Error: need --output-dir.", file=sys.stderr)
        return 1
    if args.read_len is None:
        print("Error: need --read-len.", file=sys.stderr)
        return 1

    index_dir_chk, reads_chk = args.compute_genes_psi
    for path, what in [(index_dir_chk, "index directory"),
                       (reads_chk, "reads file")]:
        p2 = os.path.abspath(os.path.expanduser(path))
        if not os.path.exists(p2):
            print("Error: %s %s does not exist." % (what, p2),
                  file=sys.stderr)
            return 1
    if args.settings_filename is not None and \
            not os.path.isfile(os.path.expanduser(args.settings_filename)):
        print("Error: settings file %s does not exist."
              % args.settings_filename, file=sys.stderr)
        return 1
    settings = Settings.load(args.settings_filename)
    multihost = False
    if args.coordinator or args.num_hosts:
        from miso_jax.parallel.distributed import initialize_distributed
        multihost = initialize_distributed(
            args.coordinator, args.num_hosts, args.host_id)
    index_dir, reads = args.compute_genes_psi
    paired = args.paired_end is not None
    overhang = 1
    if args.overhang_len is not None and not paired:
        overhang = args.overhang_len
    elif args.overhang_len is not None and paired:
        print("Warning: cannot use --overhang-len in paired-end mode. "
              "Using overhang = 1")
    cfg = RunConfig.from_settings(
        settings, args.read_len,
        overhang_len=overhang,
        algorithm=args.algorithm,
        paired_end=paired,
        mean_frag_len=args.paired_end[0] if paired else None,
        frag_variance=(args.paired_end[1] ** 2) if paired else None,
        **({"stop": "convergent"} if args.convergent else {}),
        **({"start": "linear"} if args.linear_start else {}),
        summary_only=args.summary_only,
        pack_output=args.pack_output,
        convergent_growth=args.convergent_growth,
    )
    os.makedirs(args.output_dir, exist_ok=True)
    index_dir = os.path.abspath(os.path.expanduser(index_dir))
    reads = os.path.abspath(os.path.expanduser(reads))
    gene_ids = None
    if multihost:
        from miso_jax.io.index import get_gene_ids_to_filenames
        from miso_jax.parallel.distributed import host_shard
        gene_ids = host_shard(sorted(get_gene_ids_to_filenames(index_dir)))
        print("Host shard: %d genes on this host" % len(gene_ids))
    if args.prefilter:
        from miso_jax.io.sanity import get_ids_passing_filter
        passing = get_ids_passing_filter(
            index_dir, reads, min_reads=settings.get_min_event_reads())
        gene_ids = (passing if gene_ids is None
                    else [g for g in gene_ids if g in set(passing)])
        print("Prefilter: %d genes pass the coverage filter"
              % len(gene_ids))
    compute_all_genes_psi(
        index_dir, reads, args.read_len,
        os.path.abspath(os.path.expanduser(args.output_dir)),
        cfg=cfg, settings=settings, seed=args.seed, gene_ids=gene_ids,
        profile_dir=args.profile_dir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
