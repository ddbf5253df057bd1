"""Benchmark: splice events quantified per second on one chip.

Workload: a catalog of simulated events at the reference's default sampler
cost (5000 iterations x 6 chains, burn-in 500, lag 10 -- the per-event cost
of `miso --run` with stock settings, misopy/settings/miso_settings.txt),
batched on-device.

Baseline: the reference publishes no numbers; the target is >= 1e4
events/s/host.  vs_baseline is measured events/s divided by that target.

Every mode needs a GPU and exits non-zero without one.  Fixtures are
generated from their seeds under <checkout>/.bench (MISO_E2E_DIR
overrides).

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"}.
"""
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.environ.get("MISO_E2E_DIR", os.path.join(ROOT, ".bench"))


def require_gpu():
    """The benchmark measures the GPU: fail, never fall back to the CPU."""
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit("bench.py: no GPU found (JAX platform %r)" % dev.platform)
    return dev


def build_catalog(num_events, reads_per_event=200, seed=0,
                  algorithm="reassign"):
    """Compile the event catalog and bucket it by padded shape exactly
    as the production pipeline does (pipeline.run_events ->
    core/events.bucket_events): 2-isoform events run as I=2 batches,
    3-isoform as I=3.  Returns a list of EventBatch buckets."""
    from miso_jax.core.events import (bucket_events, compile_single_end,
                                      pad_events)
    from miso_jax.core.gene import make_gene
    from miso_jax.core.simulate import simulate_reads
    from miso_jax.sampler.mcmc import EventBatch

    rng = np.random.default_rng(seed)
    genes = [
        make_gene([100, 50, 100], [[1, 2, 3], [1, 3]]),
        make_gene([120, 60, 90], [[1, 2, 3], [1, 3]]),
        make_gene([100, 50, 80, 100], [[1, 2, 3, 4], [1, 3, 4], [1, 4]]),
    ]
    # compile a handful of distinct events, then tile (compilation cost of
    # the catalog is host-side and amortized; device work is identical)
    protos = []
    for e in range(32):
        g = genes[e % len(genes)]
        psi = rng.dirichlet(np.ones(g.num_isoforms))
        _, pos, cig = simulate_reads(g, psi, reads_per_event, 25, rng)
        protos.append(
            compile_single_end(g, pos, cig, read_len=25, name="ev%d" % e,
                               algorithm=algorithm))
    events = [protos[i % len(protos)] for i in range(num_events)]
    batches = []
    for (pad_iso, pad_classes, pad_reads), idxs in bucket_events(events):
        pad = pad_events([events[i] for i in idxs], pad_iso=pad_iso,
                         pad_classes=pad_classes, pad_reads=pad_reads)
        batches.append(
            EventBatch(**{k: np.asarray(v) for k, v in pad.items()}))
    return batches


def run_e2e(num_genes: int, verbose: bool = False,
            summary_only: bool = False, timed_runs: int = 2) -> list:
    """End-to-end benchmark: GFF+BAM catalog -> .miso files, wall-clock.

    Measures the full production path (compute_all_genes_psi: indexed
    annotation load, native BAM ingest, streamed event compile
    overlapping device sampling, quantized readback, .miso writes) on a
    simulated catalog -- the number the reference's per-event wall-clock
    print corresponds to (misopy/miso_sampler.py:373), at catalog scale.
    With summary_only=True the run writes ONLY the device-computed
    .miso_summary (no .miso bodies; the readback is KBs instead of
    ~100 MB).  The fixture is cached across runs.  Returns the list of
    timed events/s values (report best AND median).
    """
    import shutil

    from miso_jax.pipeline import (RunConfig, compute_all_genes_psi,
                                   enable_compilation_cache)

    enable_compilation_cache()
    fixdir = os.path.join(FIXTURES, "cat%d" % num_genes)
    bam = os.path.join(fixdir, "catalog.bam")
    idx = os.path.join(fixdir, "index")
    if not os.path.isfile(bam):
        from miso_jax.testing import build_catalog_fixture
        build_catalog_fixture(fixdir, num_events=num_genes,
                              reads_per_event=300, read_len=36, seed=1)
    if not os.path.isdir(idx):
        from miso_jax.io.index import index_gff
        index_gff(os.path.join(fixdir, "catalog.gff"), idx)
    out = os.path.join(fixdir, "out_summ" if summary_only else "out")
    cfg = RunConfig(read_len=36, iters=5000, burn_in=500, lag=10,
                    chains=6, min_event_reads=20,
                    summary_only=summary_only)
    # warm run compiles device shapes; then timed runs
    vals = []
    for timed in (False,) + (True,) * timed_runs:
        shutil.rmtree(out, ignore_errors=True)
        t0 = time.perf_counter()
        written = compute_all_genes_psi(idx, bam, 36, out, cfg=cfg,
                                        verbose=timed and verbose)
        dt = time.perf_counter() - t0
        if timed:
            vals.append(written / dt)
    return vals


def run_e2e_paired(num_genes: int, verbose: bool = False) -> float:
    """Paired-end end-to-end benchmark: the full production path
    (chromosome pair scans + native paired batch match+collapse +
    fragment-length sampler) at catalog scale.  Returns events/s."""
    import shutil

    from miso_jax.pipeline import (RunConfig, compute_all_genes_psi,
                                   enable_compilation_cache)

    enable_compilation_cache()
    fixdir = os.path.join(FIXTURES, "paired%d" % num_genes)
    bam = os.path.join(fixdir, "catalog.bam")
    idx = os.path.join(fixdir, "index")
    if not os.path.isfile(bam):
        from miso_jax.testing import build_paired_catalog_fixture
        build_paired_catalog_fixture(fixdir, num_events=num_genes,
                                     pairs_per_event=150, read_len=40,
                                     seed=2)
    if not os.path.isdir(idx):
        from miso_jax.io.index import index_gff
        index_gff(os.path.join(fixdir, "catalog.gff"), idx)
    out = os.path.join(fixdir, "out")
    cfg = RunConfig(read_len=40, paired_end=True, mean_frag_len=250.0,
                    frag_variance=15.0 ** 2, iters=5000, burn_in=500,
                    lag=10, chains=6, min_event_reads=20)
    vals = []
    for timed in (False, True, True):
        shutil.rmtree(out, ignore_errors=True)
        t0 = time.perf_counter()
        written = compute_all_genes_psi(idx, bam, 40, out, cfg=cfg,
                                        verbose=timed and verbose)
        dt = time.perf_counter() - t0
        if timed:
            vals.append(written / dt)
    return vals


def run_compare(num_genes: int) -> float:
    """Catalog-scale differential comparison: time compare_miso's
    engine (io/comparison.py, chunked loads + batched KDE/CI stats)
    over the cached e2e catalog's output vs itself.  Returns events/s.
    Ref: misopy/hypothesis_test.py:182-345."""
    import shutil

    fixdir = os.path.join(FIXTURES, "cat%d" % num_genes)
    out = os.path.join(fixdir, "out")
    if not os.path.isdir(out):
        run_e2e(num_genes, timed_runs=1)  # builds + leaves the out tree
    from miso_jax.io.comparison import output_samples_comparison
    cmp_dir = os.path.join(fixdir, "cmp")
    best = 0.0
    for _ in range(2):
        shutil.rmtree(cmp_dir, ignore_errors=True)
        t0 = time.perf_counter()
        output_samples_comparison(out, out, cmp_dir)
        dt = time.perf_counter() - t0
        best = max(best, num_genes / dt)
    return best


def _best_median(vals):
    vals = sorted(vals)
    return (round(vals[-1], 2),
            round(vals[len(vals) // 2] if len(vals) % 2
                  else (vals[len(vals) // 2 - 1]
                        + vals[len(vals) // 2]) / 2, 2))


def main_e2e(num_genes: int, summary_only: bool = False) -> None:
    vals = run_e2e(num_genes, verbose=True, summary_only=summary_only)
    best, median = _best_median(vals)
    target = 1e4
    print(json.dumps({
        "metric": ("events_end_to_end_summary_per_s" if summary_only
                   else "events_end_to_end_per_s"),
        "value": best,
        "median": median,
        "unit": ("events/s (BAM -> .miso_summary, device-side summary)"
                 if summary_only
                 else "events/s (BAM -> .miso, 5000 iters x 6 chains)"),
        "vs_baseline": round(best / target, 4),
    }))


def main():
    import jax
    from miso_jax.pipeline import enable_compilation_cache
    from miso_jax.sampler.mcmc import SamplerConfig, run_batch, select_backend

    dev = require_gpu()
    enable_compilation_cache()

    num_events = int(sys.argv[1]) if len(sys.argv) > 1 else 2048
    # optional 2nd arg: 'reassign' (default; the reference CLI's algorithm,
    # misopy/miso_sampler.py:322) | 'marginal' | 'classes' (the reference's
    # fast single-end scheme, docs/source/updates.rst:20-22)
    algorithm = sys.argv[2] if len(sys.argv) > 2 else "reassign"
    cfg = SamplerConfig(iters=5000, burn_in=500, lag=10, chains=6,
                        algorithm=algorithm)
    batches = build_catalog(num_events, algorithm=algorithm)
    key = jax.random.PRNGKey(0)

    # the sampler `miso --run` would pick for this device and algorithm
    if select_backend("auto", dev.platform, algorithm) == "pallas":
        from miso_jax.sampler.pallas_kernel import run_batch_pallas as runner
    else:
        runner = run_batch

    # compile + warmup outside the timed window
    for batch in batches:
        jax.block_until_ready(runner(key, batch, cfg))

    # best of 5
    dt = float("inf")
    for rep in range(5):
        t0 = time.perf_counter()
        results = [runner(jax.random.PRNGKey(1 + rep), batch, cfg)
                   for batch in batches]
        jax.block_until_ready(results)
        for res in results:
            np.asarray(res.accepted)
        dt = min(dt, time.perf_counter() - t0)

    events_per_s = num_events / dt
    target = 1e4  # events/s/host
    record = {
        "metric": "events_quantified_per_s_per_chip",
        "value": round(events_per_s, 2),
        "unit": "events/s (5000 iters x 6 chains each)",
        "vs_baseline": round(events_per_s / target, 4),
    }
    # the number users experience: full BAM -> .miso wall-clock on a
    # cached 10k-gene catalog (host ingest + streamed compile + device
    # sampling + quantized readback + file writes), best and median of 3
    best, median = _best_median(run_e2e(10000, timed_runs=3))
    record["e2e_events_per_s"] = best
    record["e2e_events_per_s_median"] = median
    # BAM -> .miso_summary with posterior means/CIs computed on device
    # (KBs of readback, no sample files)
    best, median = _best_median(run_e2e(10000, summary_only=True,
                                        timed_runs=3))
    record["e2e_summary_events_per_s"] = best
    record["e2e_summary_events_per_s_median"] = median
    record["device"] = {"platform": dev.platform, "kind": dev.device_kind,
                        "count": len(jax.devices())}
    print(json.dumps(record))


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    require_gpu()
    if "--e2e-paired" in sys.argv:
        sys.argv.remove("--e2e-paired")
        n = int(sys.argv[1]) if len(sys.argv) > 1 else 2000
        best, median = _best_median(run_e2e_paired(n, verbose=True))
        print(json.dumps({
            "metric": "paired_events_end_to_end_per_s",
            "value": best,
            "median": median,
            "unit": "events/s (paired BAM -> .miso, 5000 iters x 6 chains)",
            "vs_baseline": round(best / 1e4, 4),
        }))
    elif "--compare" in sys.argv:
        sys.argv.remove("--compare")
        n = int(sys.argv[1]) if len(sys.argv) > 1 else 10000
        eps = run_compare(n)
        print(json.dumps({
            "metric": "compare_events_per_s",
            "value": round(eps, 2),
            "unit": "events/s (two-sample .miso_bf differential)",
            "vs_baseline": round(eps / 1e4, 4),
        }))
    elif "--e2e-summary" in sys.argv:
        sys.argv.remove("--e2e-summary")
        main_e2e(int(sys.argv[1]) if len(sys.argv) > 1 else 10000,
                 summary_only=True)
    elif "--e2e" in sys.argv:
        sys.argv.remove("--e2e")
        main_e2e(int(sys.argv[1]) if len(sys.argv) > 1 else 10000)
    else:
        main()
