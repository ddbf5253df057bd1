"""Simulate-at-known-psi -> recover-psi: the reference's strongest oracle
(tools/extra-tests/miso-multiple.R checks cor(expected, posterior mean))."""
import jax
import numpy as np
import pytest

from miso_jax.core.events import compile_paired_end, compile_single_end, pad_events
from miso_jax.core.gene import make_gene
from miso_jax.core.simulate import simulate_paired_reads, simulate_reads
from miso_jax.sampler.mcmc import EventBatch, SamplerConfig, run_batch


def _run(events, cfg, seed=0):
    batch = EventBatch(**{k: np.asarray(v) for k, v in pad_events(events).items()})
    return run_batch(jax.random.PRNGKey(seed), batch, cfg)


CFG_FAST = SamplerConfig(iters=1500, burn_in=300, lag=5, chains=4)


def test_two_iso_matches_exact_posterior():
    from exact_posterior import exact_posterior_mean_2iso
    g = make_gene([100, 50, 100], [[1, 2, 3], [1, 3]])
    rng = np.random.default_rng(42)
    iso, pos, cig = simulate_reads(g, [0.7, 0.3], 2000, 25, rng)
    ev = compile_single_end(g, pos, cig, read_len=25)
    exact = exact_posterior_mean_2iso(ev)
    res = _run([ev], CFG_FAST)
    samples = np.asarray(res.flat_samples())[0]  # (S, I)
    mean = samples[:, 0].mean()
    assert abs(mean - exact) < 0.02, (mean, exact)


def test_three_iso_matches_exact_posterior():
    from exact_posterior import exact_posterior_mean_3iso
    g = make_gene([100, 50, 80, 100], [[1, 2, 3, 4], [1, 3, 4], [1, 4]])
    rng = np.random.default_rng(7)
    true_psi = np.array([0.5, 0.3, 0.2])
    iso, pos, cig = simulate_reads(g, true_psi, 4000, 25, rng)
    ev = compile_single_end(g, pos, cig, read_len=25)
    exact = exact_posterior_mean_3iso(ev)
    res = _run([ev], CFG_FAST, seed=1)
    samples = np.asarray(res.flat_samples())[0]
    mean = samples.mean(axis=0)[:3]
    assert np.all(np.abs(mean - exact) < 0.03), (mean, exact)


def test_batch_mixed_events_and_padding():
    from exact_posterior import exact_posterior_mean_2iso, exact_posterior_mean_3iso
    rng = np.random.default_rng(3)
    g2 = make_gene([100, 50, 100], [[1, 2, 3], [1, 3]])
    g3 = make_gene([100, 50, 80, 100], [[1, 2, 3, 4], [1, 3, 4], [1, 4]])
    events = []
    for g, psi in [(g2, [0.2, 0.8]), (g3, [0.6, 0.3, 0.1]), (g2, [0.9, 0.1])]:
        iso, pos, cig = simulate_reads(g, psi, 3000, 25, rng)
        events.append(compile_single_end(g, pos, cig, read_len=25))
    res = _run(events, CFG_FAST, seed=2)
    flat = np.asarray(res.flat_samples())
    for e, ev in enumerate(events):
        k = ev.num_iso
        mean = flat[e, :, :k].mean(axis=0)
        if k == 2:
            exact = np.array([exact_posterior_mean_2iso(ev)])
            assert abs(mean[0] - exact[0]) < 0.02, (e, mean, exact)
        else:
            exact = exact_posterior_mean_3iso(ev)
            assert np.all(np.abs(mean - exact) < 0.03), (e, mean, exact)
        # padded isoforms must be exactly 0
        assert np.all(flat[e, :, k:] == 0)
        # psi sums to 1 over real isoforms
        assert np.allclose(flat[e].sum(axis=1), 1.0, atol=1e-5)


def test_paired_end_recovery():
    g = make_gene([600, 100, 600], [[1, 2, 3], [1, 3]])
    rng = np.random.default_rng(11)
    true_psi = 0.65
    iso, pos, cig = simulate_paired_reads(
        g, [true_psi, 1 - true_psi], 1500, 30, 200.0, 100.0, rng=rng)
    ev = compile_paired_end(g, pos, cig, read_len=30,
                            mean_frag_len=200.0, frag_variance=100.0)
    from exact_posterior import exact_posterior_mean_2iso
    exact = exact_posterior_mean_2iso(ev)
    res = _run([ev], CFG_FAST, seed=3)
    samples = np.asarray(res.flat_samples())[0]
    mean = samples[:, 0].mean()
    assert abs(mean - exact) < 0.02, (mean, exact)
    # paired events are strongly identified; also close to truth
    assert abs(mean - true_psi) < 0.08, (mean, true_psi)


def test_acceptance_rate_sane():
    g = make_gene([100, 50, 100], [[1, 2, 3], [1, 3]])
    rng = np.random.default_rng(5)
    iso, pos, cig = simulate_reads(g, [0.5, 0.5], 500, 25, rng)
    ev = compile_single_end(g, pos, cig, read_len=25)
    res = _run([ev], CFG_FAST, seed=4)
    frac = float(res.accepted[0]) / float(res.accepted[0] + res.rejected[0])
    # drift proposals with sigma=0.05 on 2 isoforms accept most of the time
    assert 0.2 < frac < 1.0, frac


def test_num_samples_layout():
    cfg = SamplerConfig(iters=100, burn_in=20, lag=10, chains=3)
    assert cfg.num_records == 8
    assert cfg.num_samples == 24
    g = make_gene([100, 50, 100], [[1, 2, 3], [1, 3]])
    rng = np.random.default_rng(6)
    _, pos, cig = simulate_reads(g, [0.5, 0.5], 100, 25, rng)
    ev = compile_single_end(g, pos, cig, read_len=25)
    res = _run([ev], cfg, seed=5)
    assert res.flat_samples().shape == (1, 24, 2)
    assert res.flat_loglik().shape == (1, 24)


def test_incompatible_reads_only():
    g = make_gene([100, 50, 100], [[1, 2, 3], [1, 3]])
    # reads in iso1's intron but failing iso0 too (overhang violation)
    ev = compile_single_end(g, np.array([1]), ["1M100N24M"], read_len=25,
                            overhang=4)
    assert not ev.any_compatible


def test_classes_algorithm_matches_its_exact_posterior():
    """ALGO_CLASSES (miso.c:282-293): position-class scoring. A different
    likelihood than REASSIGN (no per-read length re-weighting), so it is
    checked against ITS OWN grid-exact posterior."""
    g = make_gene([100, 50, 100], [[1, 2, 3], [1, 3]])
    rng = np.random.default_rng(42)
    _, pos, cig = simulate_reads(g, [0.7, 0.3], 2000, 25, rng)
    ev = compile_single_end(g, pos, cig, read_len=25, algorithm="classes")
    p = np.linspace(1e-6, 1 - 1e-6, 20001)
    psi_grid = np.stack([p, 1 - p], axis=1)
    s = psi_grid @ ev.weights.T
    ll = (np.where(ev.counts[None, :] > 0,
                   np.log(np.maximum(s, 1e-300)) * ev.counts[None, :],
                   0)).sum(axis=1)
    ll -= ll.max()
    w = np.exp(ll)
    exact = (w * p).sum() / w.sum()
    batch = EventBatch(**{k: np.asarray(v)
                          for k, v in pad_events([ev]).items()})
    cfg = SamplerConfig(iters=1500, burn_in=300, lag=5, chains=4,
                        algorithm="marginal")
    res = run_batch(jax.random.PRNGKey(0), batch, cfg)
    mean = float(np.asarray(res.flat_samples())[0][:, 0].mean())
    assert abs(mean - exact) < 0.02, (mean, exact)
    # final assignment counts add up to the compatible reads
    n = ev.final_assignment_counts(np.asarray(res.final_psi)[0, 0])
    assert n.sum() == ev.classes.counts.sum()
