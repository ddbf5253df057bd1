"""Hermetic multi-device scaling curve for event-data parallelism.

Two measurements on a virtual 8-device CPU mesh (no multi-GPU host needed):

1. SHARDING OVERHEAD: the same E-event catalog run through
   `run_batch_sharded` on 1/2/4/8-device meshes.  The event axis has no
   cross-device collectives in the run path, so wall-clock must stay
   ~flat as the mesh grows (all virtual devices share this host's
   cores; a multi-GPU host gives each shard its own card).  Any slope
   here would be real overhead (resharding, collectives, dispatch) that
   a multi-GPU host would also pay.

2. PER-SHARD SCALING: the per-device program of an N-device mesh is
   the single-device sampler on E/N events.  T(E)/T(E/N) on ONE device
   is therefore the mesh's expected relative throughput at N devices --
   valid precisely because (1) shows the sharded program adds nothing
   on top.  Expect ~N (compute scales linearly in the event axis).

Usage: JAX_PLATFORMS=cpu python scripts/scaling_bench.py [E] [iters]
Ref: SURVEY.md section 2c ("events/s at 1 chip / 1 host / N hosts");
the reference's only scaling axis is process fan-out
(misopy/miso.py:155-188, cluster_utils.py:63-157).
"""
import os
import sys
import time

import numpy as np

os.environ.setdefault("JAX_PLATFORMS", "cpu")


def build_batch(E, rng, reads=200):
    from miso_jax.core.events import compile_single_end, pad_events
    from miso_jax.core.gene import make_gene
    from miso_jax.core.simulate import simulate_reads
    from miso_jax.sampler.mcmc import EventBatch

    g = make_gene([100, 50, 100], [[1, 2, 3], [1, 3]])
    protos = []
    for _ in range(8):
        psi = rng.dirichlet(np.ones(2))
        _, pos, cig = simulate_reads(g, psi, reads, 25, rng)
        protos.append(compile_single_end(g, pos, cig, read_len=25))
    events = [protos[i % len(protos)] for i in range(E)]
    pad = pad_events(events, pad_iso=2, pad_reads=224)
    return EventBatch(**{k: np.asarray(v) for k, v in pad.items()})


def timed(fn, reps=3):
    fn()  # warm/compile
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def main():
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)
    from jax.sharding import Mesh

    from miso_jax.parallel.mesh import run_batch_sharded
    from miso_jax.sampler.mcmc import SamplerConfig, run_batch

    E = int(sys.argv[1]) if len(sys.argv) > 1 else 1024
    iters = int(sys.argv[2]) if len(sys.argv) > 2 else 400
    cfg = SamplerConfig(iters=iters, burn_in=iters // 5, lag=5, chains=2)
    rng = np.random.default_rng(0)
    batch = build_batch(E, rng)
    key = jax.random.PRNGKey(0)
    devices = jax.devices()

    print("== sharding overhead: same %d-event catalog, growing mesh ==" % E)
    t1 = None
    for n in (1, 2, 4, 8):
        mesh = Mesh(np.array(devices[:n]), ("ev",))

        def run(mesh=mesh):
            r = run_batch_sharded(key, batch, cfg, mesh=mesh,
                                  backend="xla")
            jax.block_until_ready(r.accepted)

        dt = timed(run)
        t1 = t1 or dt
        print("  mesh=%d  %.3fs  (x%.2f vs mesh=1; flat = overhead-free)"
              % (n, dt, t1 / dt))

    print("== per-shard program: one device, E/N events ==")
    t_full = None
    for n in (1, 2, 4, 8):
        sub = type(batch)(*(np.asarray(a)[: E // n] for a in batch))

        def run(sub=sub):
            r = run_batch(key, sub, cfg)
            jax.block_until_ready(r.accepted)

        dt = timed(run)
        t_full = t_full or dt
        print("  shard E/%d=%d  %.3fs  -> mesh-relative throughput x%.2f"
              % (n, E // n, dt, t_full / dt))


if __name__ == "__main__":
    main()
