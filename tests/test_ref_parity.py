"""The north-star acceptance test: miso_jax vs the reference C engine
on the reference's own shipped test data (ROADMAP.md criterion).

Four real heart BAMs + one SE event ship with the reference
(misopy/sashimi_plot/test-data, installed by setup.py:128-153).  Both
engines quantify the SAME reads at the SAME sampler settings; we assert

  * identical read-class decomposition (deterministic ingest+match),
  * Psi posterior means within Monte-Carlo tolerance,
  * credible intervals within tolerance,
  * Bayes factors of WT-vs-KO comparisons matching in sign and magnitude,

against the live reference engine (tests/refparity.py builds it from
/root/reference/pysplicing unmodified).  The shipped `.miso` fixtures are
additionally checked for class-count parity and documented-provenance
drift (they predate the fastmiso C engine; docs/PARITY.md).
"""
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(__file__))

from refparity import build_ref_driver, run_ref_miso  # noqa: E402

TESTDATA = "/root/reference/misopy/sashimi_plot/test-data"
EVENTS_GFF = os.path.join(TESTDATA, "events.gff")
EVENT = ("chr17:45816186:45816265:-@chr17:45815912:45815950:-"
         "@chr17:45814875:45814965:-")
SAMPLES = ["heartWT1", "heartWT2", "heartKOa", "heartKOb"]
READ_LEN = 48

pytestmark = pytest.mark.skipif(
    not os.path.isdir(TESTDATA), reason="reference test-data unavailable")


def _fetch_reads(sample):
    from miso_jax.io import sam as sam_io
    from miso_jax.io.gff import load_genes_from_gff

    genes = load_genes_from_gff(EVENTS_GFF)
    (name, gene), = genes.items()
    bam = sam_io.open_alignments(
        os.path.join(TESTDATA, "bam-data", "%s.sorted.bam" % sample))
    lo, hi = gene.genomic_span()
    raw = sam_io.fetch_bam_reads_in_gene(bam, gene.chrom, lo - 1, hi)
    reads, _ = sam_io.sam_parse_reads(raw)
    return gene, name, reads


@pytest.fixture(scope="session")
def ref_driver():
    driver = build_ref_driver()
    if driver is None:
        pytest.skip("reference C engine build unavailable")
    return driver


@pytest.fixture(scope="session")
def quantified(tmp_path_factory):
    """Both engines' posteriors for all four samples at the modern
    defaults (5000/500/10 x 6 chains), plus our written .miso files."""
    from miso_jax.io.index import index_gff
    from miso_jax.io.miso_file import load_miso_file
    from miso_jax.pipeline import RunConfig, compute_all_genes_psi

    root = tmp_path_factory.mktemp("refparity")
    idx = str(root / "index")
    index_gff(EVENTS_GFF, idx)
    cfg = RunConfig(read_len=READ_LEN, iters=5000, burn_in=500, lag=10,
                    chains=6, min_event_reads=20)
    out = {}
    for s in SAMPLES:
        sdir = str(root / "out" / s)
        n = compute_all_genes_psi(
            idx, os.path.join(TESTDATA, "bam-data", "%s.sorted.bam" % s),
            READ_LEN, sdir, cfg=cfg, verbose=False, seed=11)
        assert n == 1
        data = load_miso_file(
            os.path.join(sdir, "chr17", EVENT + ".miso"))
        _, _, reads = _fetch_reads(s)
        out[s] = {"dir": sdir, "data": data, "reads": reads}
    return out


@pytest.fixture(scope="session")
def ref_results(ref_driver, quantified):
    out = {}
    for s in SAMPLES:
        positions, cigars = quantified[s]["reads"]
        out[s] = run_ref_miso(
            ref_driver, EVENTS_GFF, np.asarray(positions) + 1, cigars,
            read_len=READ_LEN, iters=5000, burn_in=500, lag=10, chains=6,
            seed=1234)
    return out


def _parse_counts(counts_str):
    """'(0,0):36,(1,1):23' -> {(0,0): 36, (1,1): 23}."""
    import re

    return {tuple(int(x) for x in tmpl.split(",")): int(cnt)
            for tmpl, cnt in re.findall(r"\((\d+(?:,\d+)*)\):(\d+)",
                                        counts_str)}


def test_read_classes_exact(quantified, ref_results):
    """Ingest -> match -> class collapse must agree EXACTLY (both
    engines see the same BAM reads; the decomposition is
    deterministic).  Ref: solve.c:8-108 + miso.c:763."""
    for s in SAMPLES:
        ref = dict(ref_results[s].classes)
        ours = _parse_counts(quantified[s]["data"].params["counts"])
        assert ours == ref, "%s: class mismatch %r vs %r" % (s, ours, ref)


def test_psi_mean_parity(quantified, ref_results):
    """Posterior means within MC tolerance of the live reference engine.

    Seed-to-seed scatter of the reference engine itself at these
    settings is ~0.012-0.02 sd (docs/PARITY.md); 0.05 is ~2.5 sigma of
    the difference of two independent runs."""
    for s in SAMPLES:
        ours = quantified[s]["data"].samples[:, 0].mean()
        ref = ref_results[s].samples[:, 0].mean()
        assert abs(ours - ref) < 0.05, (
            "%s: ours %.4f vs ref %.4f" % (s, ours, ref))


def test_credible_interval_parity(quantified, ref_results):
    from miso_jax.stats.intervals import compute_credible_intervals

    for s in SAMPLES:
        lo_o, hi_o = compute_credible_intervals(
            quantified[s]["data"].samples[:, 0], 0.95)
        lo_r, hi_r = compute_credible_intervals(
            ref_results[s].samples[:, 0], 0.95)
        assert abs(lo_o - lo_r) < 0.08 and abs(hi_o - hi_r) < 0.08, (
            "%s: CI (%.3f,%.3f) vs ref (%.3f,%.3f)"
            % (s, lo_o, hi_o, lo_r, hi_r))
        # intervals must overlap substantially
        assert min(hi_o, hi_r) - max(lo_o, lo_r) > 0


def test_bayes_factor_parity(quantified, ref_results):
    """WT-vs-KO Bayes factors from both engines' samples agree in sign
    and magnitude (within 10x; BFs span orders of magnitude).
    Ref: misopy/hypothesis_test.py:348-380 Savage-Dickey at delta=0."""
    from miso_jax.stats.bayes import compute_bayes_factors

    for wt, ko in [("heartWT1", "heartKOa"), ("heartWT2", "heartKOb")]:
        bf_ours = compute_bayes_factors(
            quantified[wt]["data"].samples[:, :1],
            quantified[ko]["data"].samples[:, :1])[0]
        bf_ref = compute_bayes_factors(
            ref_results[wt].samples[:, :1],
            ref_results[ko].samples[:, :1])[0]
        assert np.sign(np.log(bf_ours)) == np.sign(np.log(bf_ref))
        # the 1e12 cap (hypothesis_test.py:380) makes exact magnitudes
        # incomparable once either engine saturates: a zero-overlap
        # delta-posterior KDE underflows to the cap, and the density at
        # 0 in the deep tail is set by the handful of most-extreme MC
        # samples (unstable between two runs of the SAME engine).  Both
        # far beyond the Jeffreys "decisive" threshold (>100; we require
        # >1e3) counts as magnitude agreement.
        decisive = bf_ours > 1e3 and bf_ref > 1e3
        assert decisive or abs(np.log10(bf_ours) - np.log10(bf_ref)) < 1.0, (
            "%s vs %s: BF %.3g (ours) vs %.3g (ref)"
            % (wt, ko, bf_ours, bf_ref))


def test_shipped_fixture_class_counts(quantified):
    """The shipped (pre-fastmiso) fixtures' compatible-class counts must
    match ours exactly -- same reads, same deterministic matching.  The
    old sampler dropped incompatible reads before the engine, so the
    (0,0) class is absent from its headers."""
    from miso_jax.io.miso_file import load_miso_file

    for s in SAMPLES:
        ref = load_miso_file(os.path.join(
            TESTDATA, "miso-data", s, "chr17", EVENT + ".miso"))
        ref_counts = _parse_counts(ref.params["counts"])
        ours = {k: v for k, v in
                _parse_counts(quantified[s]["data"].params["counts"]).items()
                if any(k)}
        assert ours == ref_counts, s


def test_shipped_fixture_posterior_drift(quantified):
    """Documented-provenance check: the shipped fixtures were generated
    by the retired pure-Python sampler (2000/200/5 schedule, different
    proposal scale); their means drift up to ~0.08 from the modern
    C engine's posterior (docs/PARITY.md has the full table).  Assert
    they still agree loosely and that CIs overlap -- a regression here
    would mean our ingest or model drifted, not just the sampler."""
    from miso_jax.io.miso_file import load_miso_file
    from miso_jax.stats.intervals import compute_credible_intervals

    for s in SAMPLES:
        ref = load_miso_file(os.path.join(
            TESTDATA, "miso-data", s, "chr17", EVENT + ".miso"))
        ours = quantified[s]["data"].samples[:, 0]
        theirs = ref.samples[:, 0]
        assert abs(ours.mean() - theirs.mean()) < 0.12
        lo_o, hi_o = compute_credible_intervals(ours, 0.95)
        lo_r, hi_r = compute_credible_intervals(theirs, 0.95)
        assert min(hi_o, hi_r) - max(lo_o, lo_r) > 0
