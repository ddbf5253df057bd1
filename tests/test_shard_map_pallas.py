"""Execution coverage for the `shard_map` + fused-kernel branch.

`parallel/mesh.py::run_batch_sharded(backend="pallas")` is the
configuration a multi-GPU host runs (the replacement for the reference's
qsub fan-out, misopy/cluster_utils.py:63-157).  The CPU suite otherwise
always takes the XLA branch (backend 'auto' picks the kernel only on
GPUs), so these tests force the kernel branch through shard_map on the
virtual 8-device CPU mesh with the kernel in interpret mode.  Each shard
keys its random streams by global lane, so sharded must equal unsharded
EXACTLY -- same math, same draws, different layout.
"""
import numpy as np
import pytest

import jax

from miso_jax.parallel.mesh import make_event_mesh, run_batch_sharded
from miso_jax.sampler.mcmc import EventBatch, SamplerConfig
from miso_jax.sampler.pallas_kernel import run_batch_pallas


def _batch(n_events, seed=11):
    from miso_jax.core.events import compile_single_end, pad_events
    from miso_jax.core.gene import make_gene
    from miso_jax.core.simulate import simulate_reads

    rng = np.random.default_rng(seed)
    g = make_gene([100, 50, 100], [[1, 2, 3], [1, 3]])
    events = []
    for e in range(n_events):
        psi = rng.dirichlet(np.ones(2))
        _, pos, cig = simulate_reads(g, psi, 60 + (e % 3) * 10, 25, rng)
        events.append(compile_single_end(g, pos, cig, read_len=25,
                                         name="ev%d" % e))
    pad = pad_events(events, pad_iso=2, pad_classes=4, pad_reads=128)
    return EventBatch(**{k: np.asarray(v) for k, v in pad.items()})


CFG = SamplerConfig(iters=60, burn_in=20, lag=4, chains=2)


def _assert_same(res, ref, n):
    for name in ref._fields:
        np.testing.assert_array_equal(np.asarray(getattr(res, name))[:n],
                                      np.asarray(getattr(ref, name))[:n],
                                      err_msg=name)


@pytest.mark.parametrize("n_events", [16, 11])
def test_shard_map_pallas_reassign_matches_unsharded(n_events):
    """The fused REASSIGN kernel under shard_map over 8 devices equals
    the unsharded kernel run (n=11 exercises pad_to_devices)."""
    batch = _batch(n_events)
    key = jax.random.PRNGKey(5)
    ref = run_batch_pallas(key, batch, CFG, interpret=True)
    mesh = make_event_mesh()
    assert mesh.devices.size == 8
    res = run_batch_sharded(key, batch, CFG, mesh=mesh,
                            backend="pallas", interpret=True)
    _assert_same(res, ref, n_events)


def test_shard_map_pallas_given_start():
    """The GIVEN-start (start_psi) lane of the shard_map branch -- used
    by convergent-mode continuations -- also matches unsharded."""
    batch = _batch(8)
    rng = np.random.default_rng(3)
    sp = rng.dirichlet(np.ones(2), size=(8, CFG.chains)).astype(np.float32)
    key = jax.random.PRNGKey(2)
    ref = run_batch_pallas(key, batch, CFG, start_psi=jax.numpy.asarray(sp),
                           interpret=True)
    res = run_batch_sharded(key, batch, CFG, mesh=make_event_mesh(),
                            backend="pallas", start_psi=sp,
                            interpret=True)
    _assert_same(res, ref, 8)
