"""Sampler tests on the card: the paths a GPU runs, against the
grid-exact posterior and against each other.

Every test here is marked `gpu`: it skips unless JAX's default device is
a GPU (`python chip_smoke.py` runs them there).  The fused REASSIGN
kernel (sampler/pallas_kernel.py) is the 'auto' sampler on a GPU;
MARGINAL/CLASSES run the XLA scan there.
"""
import numpy as np
import pytest

import jax

pytestmark = pytest.mark.gpu


def _compile_demo(psi, n_reads=2000, seed=42):
    from miso_jax.core.events import compile_single_end
    from miso_jax.core.gene import make_gene
    from miso_jax.core.simulate import simulate_reads

    g = make_gene([100, 50, 100], [[1, 2, 3], [1, 3]])
    rng = np.random.default_rng(seed)
    _, pos, cig = simulate_reads(g, psi, n_reads, 25, rng)
    return compile_single_end(g, pos, cig, read_len=25)


def _batch(events):
    from miso_jax.core.events import pad_events
    from miso_jax.sampler.mcmc import EventBatch

    return EventBatch(**{k: np.asarray(v)
                         for k, v in pad_events(events).items()})


def test_pallas_matches_exact_posterior():
    from exact_posterior import exact_posterior_mean_2iso
    from miso_jax.sampler.mcmc import SamplerConfig
    from miso_jax.sampler.pallas_kernel import run_batch_pallas

    ev = _compile_demo([0.7, 0.3])
    exact = exact_posterior_mean_2iso(ev)
    cfg = SamplerConfig(iters=1500, burn_in=300, lag=5, chains=4)
    res = run_batch_pallas(jax.random.PRNGKey(0), _batch([ev] * 8), cfg)
    means = np.asarray(res.flat_samples())[:, :, 0].mean(axis=1)
    assert np.all(np.abs(means - exact) < 0.02), (means, exact)


def test_pallas_three_isoform_agrees_with_xla():
    """3+ isoform events exercise the multi-dim proposal and the padded
    mask edge (k < I); acceptance agreement guards against a frozen
    chain that would still pass on k=2."""
    from miso_jax.core.events import compile_single_end
    from miso_jax.core.gene import make_gene
    from miso_jax.core.simulate import simulate_reads
    from miso_jax.sampler.mcmc import SamplerConfig, run_batch
    from miso_jax.sampler.pallas_kernel import run_batch_pallas

    g3 = make_gene([100, 50, 80, 100], [[1, 2, 3, 4], [1, 3, 4], [1, 4]])
    _, pos, cig = simulate_reads(g3, [0.5, 0.3, 0.2], 3000, 25,
                                 np.random.default_rng(7))
    ev = compile_single_end(g3, pos, cig, read_len=25)
    batch = _batch([ev] * 8)
    cfg = SamplerConfig(iters=1500, burn_in=300, lag=5, chains=4)
    r1 = run_batch_pallas(jax.random.PRNGKey(2), batch, cfg)
    r2 = run_batch(jax.random.PRNGKey(3), batch, cfg)
    m1 = np.asarray(r1.flat_samples())[0].mean(axis=0)
    m2 = np.asarray(r2.flat_samples())[0].mean(axis=0)
    assert np.all(np.abs(m1 - m2) < 0.03), (m1, m2)
    a1 = float(r1.accepted[0]) / (cfg.iters * cfg.chains)
    a2 = float(r2.accepted[0]) / (cfg.iters * cfg.chains)
    assert abs(a1 - a2) < 0.06, (a1, a2)
    assert a1 > 0.05, ("chain frozen", a1)


def test_pallas_marginal_agrees_with_xla():
    """MARGINAL/CLASSES run the XLA scan on a GPU (select_backend); its
    posterior means match the grid-exact mean of the collapsed model, so
    no f32 contraction on the card loses precision (score_marginal is
    written elementwise)."""
    from miso_jax.core.events import compile_single_end
    from miso_jax.core.gene import make_gene
    from miso_jax.core.simulate import simulate_reads
    from miso_jax.sampler.mcmc import SamplerConfig, run_batch, select_backend

    assert select_backend("auto", "gpu", "marginal") == "xla"
    g = make_gene([100, 50, 100], [[1, 2, 3], [1, 3]])
    rng = np.random.default_rng(42)
    _, pos, cig = simulate_reads(g, [0.7, 0.3], 2000, 25, rng)
    for algo in ("marginal", "classes"):
        ev = compile_single_end(g, pos, cig, read_len=25, algorithm=algo)
        cfg = SamplerConfig(iters=1500, burn_in=300, lag=5, chains=4,
                            algorithm=algo)
        r = run_batch(jax.random.PRNGKey(1), _batch([ev] * 8), cfg)
        m = np.asarray(r.flat_samples())[:, :, 0].mean(axis=1)
        exact = _marginal_exact(ev)
        assert np.all(np.abs(m - exact) < 0.025), (algo, m, exact)
        a = float(r.accepted[0]) / (cfg.iters * cfg.chains)
        assert a > 0.5, (algo, "acceptance", a)


def test_pallas_agrees_with_xla_sampler():
    from miso_jax.sampler.mcmc import SamplerConfig, run_batch
    from miso_jax.sampler.pallas_kernel import run_batch_pallas

    batch = _batch([_compile_demo([0.4, 0.6], seed=3)])
    cfg = SamplerConfig(iters=1200, burn_in=300, lag=5, chains=4)
    r1 = run_batch_pallas(jax.random.PRNGKey(0), batch, cfg)
    r2 = run_batch(jax.random.PRNGKey(0), batch, cfg)
    m1 = float(np.asarray(r1.flat_samples())[0, :, 0].mean())
    m2 = float(np.asarray(r2.flat_samples())[0, :, 0].mean())
    assert abs(m1 - m2) < 0.02, (m1, m2)
    a1 = float(r1.accepted[0]) / (float(r1.accepted[0])
                                  + float(r1.rejected[0]))
    a2 = float(r2.accepted[0]) / (float(r2.accepted[0])
                                  + float(r2.rejected[0]))
    assert abs(a1 - a2) < 0.05, (a1, a2)


def test_pallas_given_start_matches_exact_posterior():
    """GIVEN-start (miso.c:405-409): starting every chain from a
    deliberately wrong psi must still converge to the exact posterior."""
    from exact_posterior import exact_posterior_mean_2iso
    from miso_jax.sampler.mcmc import SamplerConfig
    from miso_jax.sampler.pallas_kernel import run_batch_pallas

    ev = _compile_demo([0.7, 0.3])
    exact = exact_posterior_mean_2iso(ev)
    E, K = 8, 4
    cfg = SamplerConfig(iters=1500, burn_in=300, lag=5, chains=K)
    start = np.tile(np.array([0.05, 0.95], np.float32), (E, K, 1))
    res = run_batch_pallas(jax.random.PRNGKey(3), _batch([ev] * E), cfg,
                           start_psi=start)
    means = np.asarray(res.flat_samples())[:, :, 0].mean(axis=1)
    assert np.all(np.abs(means - exact) < 0.03), (means, exact)


def _marginal_exact(ev):
    """Grid-exact mean of the MARGINAL-algorithm target
    prod_c (sum_j W_cj psi_j)^n_c with W = compat/effLen
    (miso.c:807-815) -- a different likelihood from REASSIGN's."""
    p = np.linspace(1e-6, 1 - 1e-6, 200001)
    W = ev.weights[:, :2]
    s = W[None, :, 0] * p[:, None] + W[None, :, 1] * (1 - p)[:, None]
    ll = np.where(ev.counts[None, :] > 0,
                  ev.counts[None, :] * np.log(np.maximum(s, 1e-300)),
                  0.0).sum(axis=1)
    w = np.exp(ll - ll.max())
    return float((w * p).sum() / w.sum())


def test_pallas_marginal_given_start():
    """The XLA scan's GIVEN start on the card (MARGINAL algorithm)."""
    from miso_jax.core.events import compile_single_end
    from miso_jax.core.gene import make_gene
    from miso_jax.core.simulate import simulate_reads
    from miso_jax.sampler.mcmc import SamplerConfig, run_batch

    g = make_gene([100, 50, 100], [[1, 2, 3], [1, 3]])
    rng = np.random.default_rng(9)
    _, pos, cig = simulate_reads(g, [0.6, 0.4], 2000, 25, rng)
    ev = compile_single_end(g, pos, cig, read_len=25, algorithm="marginal")
    exact = _marginal_exact(ev)
    E, K = 8, 4
    cfg = SamplerConfig(iters=1500, burn_in=300, lag=5, chains=K,
                        algorithm="marginal")
    start = np.tile(np.array([0.95, 0.05], np.float32), (E, K, 1))
    res = run_batch(jax.random.PRNGKey(4), _batch([ev] * E), cfg,
                    start_psi=start)
    means = np.asarray(res.flat_samples())[:, :, 0].mean(axis=1)
    assert np.all(np.abs(means - exact) < 0.03), (means, exact)


def test_production_mesh_shard_map_on_chip():
    """The shard_map + kernel branch a multi-GPU host runs, here over a
    one-device mesh of the card: the posterior must match the grid-exact
    oracle, and one GPU alone runs unsharded (resolve_mesh -> None)."""
    from exact_posterior import exact_posterior_mean_2iso
    from miso_jax.parallel.mesh import make_event_mesh, run_batch_sharded
    from miso_jax.pipeline import resolve_mesh
    from miso_jax.sampler.mcmc import SamplerConfig

    if len(jax.local_devices()) == 1:
        assert resolve_mesh("auto") is None
    ev = _compile_demo([0.4, 0.6])
    exact = exact_posterior_mean_2iso(ev)
    cfg = SamplerConfig(iters=1500, burn_in=300, lag=5, chains=4)
    res = run_batch_sharded(jax.random.PRNGKey(3), _batch([ev] * 8), cfg,
                            mesh=make_event_mesh(jax.devices()[:1]))
    means = np.asarray(res.flat_samples())[:8, :, 0].mean(axis=1)
    assert np.all(np.abs(means - exact) < 0.02), (means, exact)


def test_pallas_paired_agrees_with_xla():
    """Paired-end events through the fused REASSIGN kernel: fragment-
    length-probability weights (not {0,1}) and assscores isoform terms
    (miso_paired.c:241-574 semantics) must sample the same posterior as
    the XLA scan."""
    from miso_jax.core.events import compile_paired_end
    from miso_jax.core.gene import make_gene
    from miso_jax.core.simulate import simulate_paired_reads
    from miso_jax.sampler.mcmc import SamplerConfig, run_batch
    from miso_jax.sampler.pallas_kernel import run_batch_pallas

    g = make_gene([600, 100, 600], [[1, 2, 3], [1, 3]])
    rng = np.random.default_rng(11)
    _, pos, cig = simulate_paired_reads(g, [0.6, 0.4], 400, 40, 250.0,
                                        15.0 ** 2, rng=rng)
    ev = compile_paired_end(g, pos, cig, read_len=40, mean_frag_len=250.0,
                            frag_variance=15.0 ** 2)
    batch = _batch([ev] * 8)
    cfg = SamplerConfig(iters=1500, burn_in=300, lag=5, chains=4)
    r1 = run_batch_pallas(jax.random.PRNGKey(4), batch, cfg)
    r2 = run_batch(jax.random.PRNGKey(5), batch, cfg)
    m1 = np.asarray(r1.flat_samples())[:, :, 0].mean(axis=1)
    m2 = float(np.asarray(r2.flat_samples())[:, :, 0].mean())
    assert np.all(np.abs(m1 - m2) < 0.025), (m1, m2)
    a1 = float(r1.accepted[0]) / (cfg.iters * cfg.chains)
    a2 = float(r2.accepted[0]) / (cfg.iters * cfg.chains)
    assert abs(a1 - a2) < 0.06, (a1, a2)
    assert a1 > 0.05, ("chain frozen", a1)
