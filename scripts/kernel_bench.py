"""REASSIGN sampler micro-bench: the fused kernel against the XLA scan.

Times one bucket of E events at the reference's stock sampler cost
(5000 iterations x 6 chains, burn-in 500, lag 10) with each backend, in
turns (xla, kernel, kernel, xla), on the first accelerator; compilation
and a warm-up run stay outside the timed window.  Fails when JAX finds
no GPU.

Usage: python scripts/kernel_bench.py [--events E] [--iso 2 3] [--reads R]
       python scripts/kernel_bench.py --sweep   (kernel block shapes only)
       python scripts/kernel_bench.py --e2e [--reps N]
  (--e2e: the `miso --run` engine over chip_smoke.py's 10k-event catalog
   with each sampler, .miso tree and --summary-only, warm, in alternating
   turns)
"""
import argparse
import itertools
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def timed(fn, reps=1):
    """Best wall time of `reps` runs of fn(), each ending in
    block_until_ready; fn() runs once untimed first (compile, warm-up)."""
    import jax
    jax.block_until_ready(fn())
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        best = min(best, time.perf_counter() - t0)
    return best


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--events", type=int, default=2048)
    ap.add_argument("--iso", type=int, nargs="+", default=[2, 3])
    ap.add_argument("--reads", type=int, default=224)
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--e2e", action="store_true")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    if args.e2e:
        return e2e(args.reps)

    import jax
    from miso_jax.pipeline import enable_compilation_cache
    from miso_jax.sampler.mcmc import SamplerConfig, run_batch
    from miso_jax.sampler.pallas_kernel import run_batch_pallas
    from miso_jax.testing import sampler_batch

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit("kernel_bench: no GPU found (platform %r)" % dev.platform)
    enable_compilation_cache()
    cfg = SamplerConfig(iters=5000, burn_in=500, lag=10, chains=6)
    key = jax.random.PRNGKey(0)
    for I in args.iso:
        batch = jax.device_put(sampler_batch(args.events, I, args.reads))
        shape = {"E": args.events, "I": I, "R": args.reads}
        if args.sweep:
            shapes = list(itertools.product((32, 64, 128), (1, 2, 4), (32,)))
            shapes += [(64, 2, 16), (64, 2, 64), (32, 1, 64)]
            for lanes, warps, chunk in shapes:
                t = timed(lambda: run_batch_pallas(
                    key, batch, cfg, max_lanes=lanes, num_warps=warps,
                    max_chunk=chunk).psi_samples)
                print(json.dumps(dict(shape, lanes=lanes, warps=warps,
                                      chunk=chunk, seconds=t)), flush=True)
            continue
        xla = lambda: run_batch(key, batch, cfg).psi_samples  # noqa: E731
        ker = lambda: run_batch_pallas(  # noqa: E731
            key, batch, cfg).psi_samples
        times = {"xla": [], "kernel": []}
        for name in ("xla", "kernel", "kernel", "xla"):
            times[name].append(timed(xla if name == "xla" else ker))
        # same events, different random streams: posterior means agree
        # statistically
        mx = np.asarray(xla()).mean(axis=(1, 2))
        mk = np.asarray(ker()).mean(axis=(1, 2))
        print(json.dumps(dict(shape, xla_s=times["xla"],
                              kernel_s=times["kernel"],
                              max_abs_mean_diff=float(np.abs(mx - mk).max()),
                              device=dev.device_kind)), flush=True)


def e2e(reps):
    """Warm `miso --run` wall-clock per sampler and output mode; turns
    run xla, pallas, pallas, xla, ... so drift hits both alike."""
    import shutil

    import jax
    import chip_smoke as cs

    if jax.devices()[0].platform != "gpu":
        sys.exit("kernel_bench: no GPU found")
    from miso_jax.pipeline import enable_compilation_cache
    enable_compilation_cache()
    shutil.rmtree(cs.WORK, ignore_errors=True)
    os.makedirs(cs.WORK)
    se, _ = cs.build_catalogs(paired=False)
    out = os.path.join(cs.WORK, "out")
    for summary_only in (False, True):         # compile both backends
        for backend in ("xla", "pallas"):
            t, _ = cs.engine_run(se, out, backend, summary_only)
            print(json.dumps({"summary_only": summary_only,
                              "backend": backend, "cold_s": t}), flush=True)
    order = [("xla", "pallas")[(i + 1) // 2 % 2] for i in range(2 * reps)]
    for summary_only in (False, True):
        times = {"xla": [], "pallas": []}
        for backend in order:
            times[backend].append(
                cs.engine_run(se, out, backend, summary_only)[0])
        print(json.dumps({"summary_only": summary_only, "order": order,
                          **times, "device": jax.devices()[0].device_kind}),
              flush=True)
    shutil.rmtree(cs.WORK, ignore_errors=True)


if __name__ == "__main__":
    main()
