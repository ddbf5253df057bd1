"""Deep-event path: a million-read event through the production
pipeline stays O(classes) on device and recovers the exact posterior.

Design note: docs/DEEP_EVENTS.md (why classes-collapse makes read-shard
psum unnecessary; SURVEY section 2c's long-context analogue).
"""
import dataclasses

import numpy as np

from exact_posterior import exact_posterior_mean_2iso
from miso_jax.core.events import compile_single_end, pad_events
from miso_jax.core.gene import make_gene
from miso_jax.core.simulate import simulate_reads


def _deep_event(scale=500, n_base=2000, seed=4):
    """A 2-isoform event with n_base*scale reads: simulate n_base reads,
    then scale the class counts (reads within a class are exchangeable,
    so this IS a deeper realization of the same read-class profile)."""
    g = make_gene([100, 50, 100], [[1, 2, 3], [1, 3]])
    rng = np.random.default_rng(seed)
    _, pos, cig = simulate_reads(g, [0.3, 0.7], n_base, 25, rng)
    ev = compile_single_end(g, pos, cig, read_len=25, name="deep")
    deep = dataclasses.replace(
        ev, counts=ev.counts * scale, num_reads=ev.num_reads * scale)
    return ev, deep


def test_deep_event_skips_per_read_tensors():
    _, deep = _deep_event()
    assert int(deep.counts.sum()) == 1_000_000
    pad = pad_events([deep], per_read=False)
    assert pad["read_w"].shape == (1, 1, pad["weights"].shape[2])
    assert pad["read_logscore"].shape == pad["read_w"].shape
    # the class tensors are identical to the shallow event's shapes
    assert pad["weights"].shape[1] <= 8


def test_pipeline_routes_deep_events_to_multinomial(monkeypatch):
    """run_events must select the O(C) multinomial Gibbs and never
    materialize (E, R, I) for a 1M-read bucket."""
    from miso_jax import pipeline
    from miso_jax.pipeline import RunConfig, run_events

    _, deep = _deep_event()
    seen = {}
    orig = pipeline.pad_events

    def spy(events, **kw):
        seen.update(kw)
        return orig(events, **kw)

    monkeypatch.setattr(pipeline, "pad_events", spy)
    cfg = RunConfig(read_len=25, iters=400, burn_in=100, lag=5, chains=2)
    results = run_events([deep], cfg, seed=0, mesh=None)
    assert seen.get("per_read") is False
    r = results[0]
    assert r is not None and np.isfinite(r["samples"]).all()
    # assignment counts must sum to the full million
    assert abs(float(np.sum(r["final_n"])) - 1_000_000) < 1


def test_deep_event_matches_exact_posterior():
    """The multinomial Gibbs targets the same posterior: at 1M reads the
    posterior concentrates near the exact mean; the sampler must land
    inside MC tolerance."""
    import jax

    from miso_jax.sampler.mcmc import EventBatch, SamplerConfig, run_batch

    shallow, deep = _deep_event()
    exact = exact_posterior_mean_2iso(deep)
    pad = pad_events([deep], per_read=False)
    batch = EventBatch(**{k: np.asarray(v) for k, v in pad.items()})
    cfg = SamplerConfig(iters=800, burn_in=200, lag=4, chains=4,
                        gibbs="multinomial")
    res = run_batch(jax.random.PRNGKey(0), batch, cfg)
    mean = float(np.asarray(res.flat_samples())[0, :, 0].mean())
    assert abs(mean - exact) < 0.02, (mean, exact)


def test_multinomial_and_perread_gibbs_agree():
    """Both Gibbs implementations target the same kernel (the sufficient
    statistic argument in docs/DEEP_EVENTS.md)."""
    import jax

    from miso_jax.sampler.mcmc import EventBatch, SamplerConfig, run_batch

    shallow, _ = _deep_event()
    exact = exact_posterior_mean_2iso(shallow)
    batch_pr = EventBatch(**{k: np.asarray(v)
                             for k, v in pad_events([shallow]).items()})
    batch_mn = EventBatch(**{k: np.asarray(v)
                             for k, v in pad_events(
                                 [shallow], per_read=False).items()})
    means = {}
    for name, batch, gibbs in (("perread", batch_pr, "perread"),
                               ("multinomial", batch_mn, "multinomial")):
        cfg = SamplerConfig(iters=1500, burn_in=300, lag=4, chains=4,
                            gibbs=gibbs)
        res = run_batch(jax.random.PRNGKey(1), batch, cfg)
        means[name] = float(np.asarray(res.flat_samples())[0, :, 0].mean())
    assert abs(means["perread"] - exact) < 0.02, (means, exact)
    assert abs(means["multinomial"] - exact) < 0.02, (means, exact)
