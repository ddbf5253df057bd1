"""Extended reference-parity matrix: paired-end, >2 isoforms, and the
MARGINAL / CLASSES algorithms, each compared head-to-head against the
live reference C engine on identical simulated reads.

tests/test_ref_parity.py covers the shipped real-data fixture (SE,
2 isoforms, REASSIGN); this file completes the acceptance grid over the
sampler variants the reference exposes (pysplicing.c:41-244; enum
splicing.h:59-62).
"""
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(__file__))

from refparity import build_ref_driver, run_ref_miso  # noqa: E402


@pytest.fixture(scope="module")
def ref_driver():
    driver = build_ref_driver()
    if driver is None:
        pytest.skip("reference C engine build unavailable")
    return driver


def _gene_to_gff(gene, gid, path):
    """Write one gene as GFF3 the reference engine can consume.

    Child IDs are PREFIXED with the gene id: the reference's
    gff parser orders records by ID and mis-parses (noiso == 0, then
    heap corruption in the sampler) whenever an mRNA id sorts before
    its gene id -- the shipped event GFFs always use prefixed ids, so
    the quirk never fires there."""
    from miso_jax.io.gff import GFFRecord, write_gff

    lo, hi = gene.genomic_span()
    recs = [GFFRecord(gene.chrom or "chrS", "sim", "gene", lo, hi, None,
                      gene.strand or "+", None, {"ID": [gid]})]
    for k, iso in enumerate(gene.isoforms):
        mid = "%s.%c" % (gid, ord("A") + k)
        recs.append(GFFRecord(gene.chrom or "chrS", "sim", "mRNA", lo, hi,
                              None, gene.strand or "+", None,
                              {"ID": [mid], "Parent": [gid]}))
        for pi in iso.parts:
            p = gene.parts[pi]
            recs.append(GFFRecord(
                gene.chrom or "chrS", "sim", "exon", p.start, p.end, None,
                gene.strand or "+", None,
                {"ID": ["%s.%s" % (mid, p.label)], "Parent": [mid]}))
    write_gff(recs, path)


def _run_ours(ev, algorithm="reassign", chains=6, iters=5000, burn_in=500,
              lag=10, seed=5):
    import jax

    from miso_jax.core.events import pad_events
    from miso_jax.sampler.mcmc import EventBatch, SamplerConfig, run_batch

    batch = EventBatch(**{k: np.asarray(v)
                          for k, v in pad_events([ev]).items()})
    cfg = SamplerConfig(iters=iters, burn_in=burn_in, lag=lag,
                        chains=chains, algorithm=algorithm)
    res = run_batch(jax.random.PRNGKey(seed), batch, cfg)
    return np.asarray(res.flat_samples())[0, :, :ev.num_iso]


def test_paired_end_parity(ref_driver, tmp_path):
    """Paired sampler vs splicing_miso_paired on identical mate pairs
    (fragment pmf from the same normalMean/normalVar/numDevs)."""
    from miso_jax.core.events import compile_paired_end
    from miso_jax.core.gene import make_gene
    from miso_jax.core.simulate import simulate_paired_reads

    g = make_gene([300, 100, 300], [[1, 2, 3], [1, 3]], chrom="chrS",
                  strand="+")
    rng = np.random.default_rng(3)
    _, pos, cig = simulate_paired_reads(g, [0.7, 0.3], 300, 40, 250.0,
                                        15.0 ** 2, rng=rng)
    gff = str(tmp_path / "p.gff")
    _gene_to_gff(g, "pg", gff)
    ref = run_ref_miso(ref_driver, gff, pos, cig, read_len=40,
                       paired={"mean": 250.0, "sd": 15.0, "num_devs": 4},
                       seed=17)
    ev = compile_paired_end(g, np.asarray(pos), list(cig), read_len=40,
                            mean_frag_len=250.0, frag_variance=15.0 ** 2,
                            num_sds=4.0, name="pg")
    ours = _run_ours(ev)
    m_ref = ref.samples[:, 0].mean()
    m_ours = ours[:, 0].mean()
    assert abs(m_ours - m_ref) < 0.05, (m_ours, m_ref)


def test_three_isoform_parity(ref_driver, tmp_path):
    """Per-isoform posterior means agree on a 3-isoform gene."""
    from miso_jax.core.events import compile_single_end
    from miso_jax.core.gene import make_gene
    from miso_jax.core.simulate import simulate_reads

    g = make_gene([100, 50, 80, 100],
                  [[1, 2, 3, 4], [1, 3, 4], [1, 4]], chrom="chrS",
                  strand="+")
    rng = np.random.default_rng(4)
    _, pos, cig = simulate_reads(g, [0.5, 0.3, 0.2], 500, 25, rng)
    gff = str(tmp_path / "t.gff")
    _gene_to_gff(g, "tg", gff)
    ref = run_ref_miso(ref_driver, gff, pos, cig, read_len=25, seed=23)
    ev = compile_single_end(g, np.asarray(pos), list(cig), read_len=25,
                            name="tg")
    ours = _run_ours(ev)
    for i in range(3):
        m_ref = ref.samples[:, i].mean()
        m_ours = ours[:, i].mean()
        assert abs(m_ours - m_ref) < 0.05, (i, m_ours, m_ref)


def test_marginal_algorithm_parity(ref_driver, tmp_path):
    """MARGINAL (miso.c:807-815) vs the reference engine run with the
    same algorithm enum."""
    from miso_jax.core.events import compile_single_end
    from miso_jax.core.gene import make_gene
    from miso_jax.core.simulate import simulate_reads

    g = make_gene([100, 50, 100], [[1, 2, 3], [1, 3]], chrom="chrS",
                  strand="+")
    rng = np.random.default_rng(6)
    _, pos, cig = simulate_reads(g, [0.6, 0.4], 400, 25, rng)
    gff = str(tmp_path / "c.gff")
    _gene_to_gff(g, "cg", gff)
    ref = run_ref_miso(ref_driver, gff, pos, cig, read_len=25,
                       algorithm=1, seed=31)
    ev = compile_single_end(g, np.asarray(pos), list(cig), read_len=25,
                            name="cg", algorithm="marginal")
    ours = _run_ours(ev, algorithm="marginal")
    m_ref = ref.samples[:, 0].mean()
    m_ours = ours[:, 0].mean()
    assert abs(m_ours - m_ref) < 0.05, (m_ours, m_ref)


def test_classes_algorithm_documented_divergence(ref_driver, tmp_path):
    """CLASSES is latent dead code in the reference: its CLI hardcodes
    REASSIGN (misopy/miso_sampler.py:322), and the C path's assignment
    matrix is broken on ordinary SE events -- for this gene it emits
    only 2 position classes (no exclusion-only class at all), silently
    drops every exclusion-only read in getMatchVector, and its
    posterior lands at ~0.30 for simulation truth 0.6.  miso_jax's
    CLASSES samples the documented model (position classes with
    per-isoform position weights) and agrees with its grid-exact
    posterior; this test PINS both facts so the divergence is a
    measured, documented decision rather than silent."""
    from miso_jax.core.events import compile_single_end
    from miso_jax.core.gene import make_gene
    from miso_jax.core.simulate import simulate_reads

    g = make_gene([100, 50, 100], [[1, 2, 3], [1, 3]], chrom="chrS",
                  strand="+")
    rng = np.random.default_rng(6)
    _, pos, cig = simulate_reads(g, [0.6, 0.4], 400, 25, rng)
    gff = str(tmp_path / "k.gff")
    _gene_to_gff(g, "cg", gff)
    ref = run_ref_miso(ref_driver, gff, pos, cig, read_len=25,
                       algorithm=2, seed=31)
    ev = compile_single_end(g, np.asarray(pos), list(cig), read_len=25,
                            name="cg", algorithm="classes")
    ours = _run_ours(ev, algorithm="marginal")
    # ours agrees with the grid-exact posterior of the classes model
    W = ev.weights[:, :2]
    pgrid = np.linspace(1e-6, 1 - 1e-6, 100001)
    s = (W[None, :, 0] * pgrid[:, None]
         + W[None, :, 1] * (1 - pgrid)[:, None])
    ll = np.where(ev.counts[None, :] > 0,
                  ev.counts[None, :] * np.log(np.maximum(s, 1e-300)),
                  0.0).sum(axis=1)
    w = np.exp(ll - ll.max())
    exact = float((pgrid * w).sum() / w.sum())
    assert abs(ours[:, 0].mean() - exact) < 0.03
    # the reference's latent CLASSES path is measurably broken here
    # (first-class evidence the divergence is theirs, not ours)
    assert abs(ref.samples[:, 0].mean() - 0.6) > 0.15


def test_overhang_filter_parity(ref_driver, tmp_path):
    """Overhang > 1 head-to-head: the first/last-CIGAR-run filter
    (solve.c:61) changes which junction reads count; both engines must
    agree on the resulting classes AND the posterior."""
    from miso_jax.core.events import compile_single_end
    from miso_jax.core.gene import make_gene
    from miso_jax.core.simulate import simulate_reads

    g = make_gene([100, 50, 100], [[1, 2, 3], [1, 3]], chrom="chrS",
                  strand="+")
    rng = np.random.default_rng(12)
    _, pos, cig = simulate_reads(g, [0.45, 0.55], 400, 25, rng)
    gff = str(tmp_path / "o.gff")
    _gene_to_gff(g, "og", gff)
    for overhang in (2, 4):
        ref = run_ref_miso(ref_driver, gff, pos, cig, read_len=25,
                           overhang=overhang, seed=41)
        ev = compile_single_end(g, np.asarray(pos), list(cig),
                                read_len=25, overhang=overhang,
                                name="og")
        # identical class decomposition under the overhang filter
        ours_classes = {
            tuple(int(v) for v in ev.classes.templates[:, c]):
                int(ev.classes.counts[c])
            for c in range(ev.classes.num_classes)}
        assert ours_classes == dict(ref.classes), overhang
        ours = _run_ours(ev)
        assert abs(ours[:, 0].mean() - ref.samples[:, 0].mean()) < 0.05, \
            overhang


@pytest.mark.parametrize("num_devs,mean,sd", [(2, 250.0, 15.0),
                                              (4, 180.0, 30.0)])
def test_paired_parity_grid(ref_driver, tmp_path, num_devs, mean, sd):
    """Paired-end head-to-head across the fragment-pmf grid: numDevs
    truncation (miso_paired.c:241-574 takes it as a parameter) and a
    second (mean, sd)."""
    from miso_jax.core.events import compile_paired_end
    from miso_jax.core.gene import make_gene
    from miso_jax.core.simulate import simulate_paired_reads

    g = make_gene([300, 100, 300], [[1, 2, 3], [1, 3]], chrom="chrS",
                  strand="+")
    rng = np.random.default_rng(100 + num_devs)
    _, pos, cig = simulate_paired_reads(g, [0.65, 0.35], 300, 40, mean,
                                        sd ** 2, rng=rng)
    gff = str(tmp_path / "pg.gff")
    _gene_to_gff(g, "pg", gff)
    ref = run_ref_miso(ref_driver, gff, pos, cig, read_len=40,
                       paired={"mean": mean, "sd": sd,
                               "num_devs": num_devs}, seed=53)
    ev = compile_paired_end(g, np.asarray(pos), list(cig), read_len=40,
                            mean_frag_len=mean, frag_variance=sd ** 2,
                            num_sds=float(num_devs), name="pg")
    ours = _run_ours(ev)
    assert abs(ours[:, 0].mean() - ref.samples[:, 0].mean()) < 0.05, (
        num_devs, mean, sd)


def test_five_isoform_parity(ref_driver, tmp_path):
    """Per-isoform posterior means agree on a 5-isoform gene (the
    deep-isoform end of the real-annotation range)."""
    from miso_jax.core.events import compile_single_end
    from miso_jax.core.gene import make_gene
    from miso_jax.core.simulate import simulate_reads

    g = make_gene([120, 60, 80, 50, 90, 110],
                  [[1, 2, 3, 4, 5, 6], [1, 3, 4, 6], [1, 2, 4, 5, 6],
                   [1, 4, 6], [1, 6]], chrom="chrS", strand="+")
    rng = np.random.default_rng(9)
    psi = [0.3, 0.25, 0.2, 0.15, 0.1]
    _, pos, cig = simulate_reads(g, psi, 800, 25, rng)
    gff = str(tmp_path / "f.gff")
    _gene_to_gff(g, "fg", gff)
    ref = run_ref_miso(ref_driver, gff, pos, cig, read_len=25, seed=71)
    ev = compile_single_end(g, np.asarray(pos), list(cig), read_len=25,
                            name="fg")
    ours = _run_ours(ev)
    for i in range(5):
        assert abs(ours[:, i].mean() - ref.samples[:, i].mean()) < 0.05, i


def test_low_coverage_boundary_parity(ref_driver, tmp_path):
    """A min_event_reads-boundary event (exactly 20 reads,
    settings.py:117 default): the wide low-coverage posterior must
    still match the reference engine's."""
    from miso_jax.core.events import compile_single_end
    from miso_jax.core.gene import make_gene
    from miso_jax.core.simulate import simulate_reads

    g = make_gene([100, 50, 100], [[1, 2, 3], [1, 3]], chrom="chrS",
                  strand="+")
    rng = np.random.default_rng(15)
    _, pos, cig = simulate_reads(g, [0.5, 0.5], 20, 25, rng)
    gff = str(tmp_path / "l.gff")
    _gene_to_gff(g, "lg", gff)
    ref = run_ref_miso(ref_driver, gff, pos, cig, read_len=25, seed=83)
    ev = compile_single_end(g, np.asarray(pos), list(cig), read_len=25,
                            name="lg")
    ours = _run_ours(ev)
    # low coverage -> wide posterior; means still agree (looser MC
    # tolerance: posterior sd is ~0.1 at 20 reads)
    assert abs(ours[:, 0].mean() - ref.samples[:, 0].mean()) < 0.07


def test_psi_distribution_ks_parity(ref_driver, tmp_path):
    """Distribution-level assertion beyond means: the two engines'
    retained Psi samples must agree as DISTRIBUTIONS (two-sample KS
    statistic; thresholded on D, not p -- MCMC samples are
    autocorrelated so p-values would be anti-conservative)."""
    from miso_jax.core.events import compile_single_end
    from miso_jax.core.gene import make_gene
    from miso_jax.core.simulate import simulate_reads
    from scipy.stats import ks_2samp

    g = make_gene([100, 50, 100], [[1, 2, 3], [1, 3]], chrom="chrS",
                  strand="+")
    rng = np.random.default_rng(21)
    _, pos, cig = simulate_reads(g, [0.6, 0.4], 400, 25, rng)
    gff = str(tmp_path / "d.gff")
    _gene_to_gff(g, "dg", gff)
    ref = run_ref_miso(ref_driver, gff, pos, cig, read_len=25, seed=91)
    ev = compile_single_end(g, np.asarray(pos), list(cig), read_len=25,
                            name="dg")
    ours = _run_ours(ev)
    D = ks_2samp(ours[:, 0], ref.samples[:, 0]).statistic
    assert D < 0.08, D
