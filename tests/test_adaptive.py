"""Convergent-mean adaptive stopping + R-hat diagnostics."""
import os
import numpy as np

import jax

from miso_jax.core.events import compile_single_end, pad_events
from miso_jax.core.gene import make_gene
from miso_jax.core.simulate import simulate_reads
from miso_jax.sampler.mcmc import (EventBatch, SamplerConfig, run_batch,
                                   run_batch_convergent)
from miso_jax.stats.rhat import batch_rhat, extended_iterations, rhat


def _events(n=3, seed=0):
    rng = np.random.default_rng(seed)
    g = make_gene([100, 50, 100], [[1, 2, 3], [1, 3]])
    evs = []
    for e in range(n):
        psi = rng.uniform(0.2, 0.8)
        _, pos, cig = simulate_reads(g, [psi, 1 - psi], 1000, 25, rng)
        evs.append(compile_single_end(g, pos, cig, read_len=25,
                                      name="ev%d" % e))
    return evs


def test_rhat_converged_chain():
    # well-mixed chains: R-hat near 1
    rng = np.random.default_rng(0)
    samples = rng.normal(0.5, 0.05, size=(200, 4, 2))
    r = np.asarray(rhat(samples))
    assert np.all(r < 1.05), r


def test_rhat_detects_divergent_chains():
    rng = np.random.default_rng(1)
    samples = rng.normal(0.5, 0.01, size=(200, 4, 2))
    samples[:, 0, :] += 0.5  # one chain stuck elsewhere
    r = np.asarray(rhat(samples))
    assert np.any(r > 1.1), r


def test_extension_rule():
    # miso.c:922: noIter' = 3*noIter - 2*burnIn
    assert extended_iterations(5000, 500) == 14000


def test_convergent_batch_runs():
    evs = _events(3)
    batch = EventBatch(**{k: np.asarray(v)
                          for k, v in pad_events(evs).items()})
    cfg = SamplerConfig(iters=600, burn_in=100, lag=5, chains=4)
    results, iters_used = run_batch_convergent(
        jax.random.PRNGKey(0), batch, cfg, max_iters=6000)
    assert all(r is not None for r in results)
    for r in results:
        assert r["samples"].shape[1] == batch.weights.shape[2]
        assert np.all((r["samples"].sum(axis=1) - 1.0) < 1e-3)
    assert np.all(iters_used >= 600)


def test_given_start():
    evs = _events(1, seed=5)
    batch = EventBatch(**{k: np.asarray(v)
                          for k, v in pad_events(evs).items()})
    cfg = SamplerConfig(iters=400, burn_in=100, lag=5, chains=2)
    K, I = cfg.chains, batch.weights.shape[2]
    start = np.full((1, K, I), 0.5, np.float32)
    res = run_batch(jax.random.PRNGKey(1), batch, cfg,
                    start_psi=np.asarray(start))
    s = np.asarray(res.flat_samples())[0]
    assert not np.isnan(s).any()
    assert np.allclose(s.sum(axis=1), 1.0, atol=1e-5)


def test_linear_start_pipeline():
    """MISO_START_LINEAR: NNLS-seeded chains through the pipeline."""
    import dataclasses
    from miso_jax.core.assignment import linear_start_psi
    from miso_jax.pipeline import RunConfig, run_events

    evs = _events(2, seed=11)
    expr = linear_start_psi(evs[0], 25)
    assert expr.shape == (2,) and abs(expr.sum() - 1.0) < 1e-6
    cfg = RunConfig(read_len=25, iters=400, burn_in=100, lag=5, chains=2,
                    start="linear")
    results = run_events(evs, cfg)
    for r in results:
        assert r is not None
        assert np.all(np.isfinite(r["samples"]))


def test_convergent_extension_is_bucketed():
    """An impossible threshold forces one extension round for every
    event; continuation batches are padded to power-of-two event counts
    so compile shapes stay bounded (each new shape is a compile)."""
    evs = _events(5, seed=7)  # 5 -> continuation rounds pad to 8
    batch = EventBatch(**{k: np.asarray(v)
                          for k, v in pad_events(evs).items()})
    cfg = SamplerConfig(iters=200, burn_in=50, lag=2, chains=2)
    results, iters_used = run_batch_convergent(
        jax.random.PRNGKey(2), batch, cfg, max_iters=700,
        rhat_threshold=0.0)
    # round 1: 200 iters, unconverged -> round 2: 3*200-2*50 = 500,
    # next would be 3*500-2*200 = 1100 > 700 -> forced stop
    assert np.all(iters_used == 500), iters_used
    for r in results:
        assert r is not None
        assert r["iters"] == 500 and r["burn_in"] == 200


def test_convergent_pipeline_records_schedule(tmp_path):
    """`miso --run --convergent`: per-event final schedule lands in the
    .miso header (iters=/burn_in=)."""
    from miso_jax.pipeline import (RunConfig, run_events,
                                   write_event_results)

    evs = _events(3, seed=9)
    cfg = RunConfig(read_len=25, iters=300, burn_in=60, lag=3, chains=2,
                    stop="convergent", max_iters=4000)
    results = run_events(evs, cfg, seed=1)
    assert all(r is not None for r in results)
    for r in results:
        assert r["iters"] >= 300 and np.isfinite(r["samples"]).all()
    n = write_event_results(evs, results, str(tmp_path), cfg)
    assert n == 3
    import glob
    headers = []
    for p in glob.glob(str(tmp_path / "*" / "*.miso")):
        with open(p) as f:
            headers.append(f.readline())
    assert len(headers) == 3
    for h, r in zip(sorted(headers), results):
        assert "iters=" in h and "burn_in=" in h


def test_convergent_small_growth_matches_exact_posterior():
    """The opt-in smaller extension factor (iters' = g*iters -
    (g-1)*burn_in) must pass the same R-hat acceptance rule and land on
    the same posterior as the reference 3x rule -- checked against the
    grid-exact posterior oracle."""
    import sys
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from exact_posterior import exact_posterior_mean_2iso
    finally:
        sys.path.pop(0)

    evs = _events(2, seed=11)
    batch = EventBatch(**{k: np.asarray(v)
                          for k, v in pad_events(evs).items()})
    # deliberately short first block so continuation rounds actually run
    cfg = SamplerConfig(iters=300, burn_in=100, lag=2, chains=4)
    for g in (2.0, 1.0):
        results, iters_used = run_batch_convergent(
            jax.random.PRNGKey(2), batch, cfg, max_iters=20000,
            extend_factor=g)
        for ev, r in zip(evs, results):
            exact = exact_posterior_mean_2iso(ev)
            got = float(np.asarray(r["samples"])[:, 0].mean())
            assert abs(got - exact) < 0.03, (g, got, exact)
    # g=1 continuation schedules are strictly cheaper per round
    assert int(round(300 + 1.0 * (300 - 100))) < 3 * 300 - 2 * 100


def test_convergent_growth_validation():
    import pytest

    evs = _events(1)
    batch = EventBatch(**{k: np.asarray(v)
                          for k, v in pad_events(evs).items()})
    cfg = SamplerConfig(iters=200, burn_in=50, lag=2, chains=2)
    with pytest.raises(ValueError):
        run_batch_convergent(jax.random.PRNGKey(0), batch, cfg,
                             extend_factor=0.5)
