"""Multi-isoform REAL-DATA head-to-head: the Atp2b1 fixture.

The reference's own end-to-end test quantifies
misopy/test-data/sam-data/c2c12.Atp2b1.sam (real mouse C2C12 reads)
against gff-events/mm9/genes/Atp2b1.mm9.gff -- a real 2-isoform gene
with 7/21-exon transcripts (misopy/test_miso.py:134-172) -- but never
checks values.  Here both engines quantify those reads head-to-head at
the modern defaults: read classes must match exactly, and the posterior
must agree within Monte-Carlo tolerance with the live reference C
engine (tests/refparity.py builds it unmodified from
/root/reference/pysplicing).
"""
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(__file__))

from refparity import build_ref_driver, run_ref_miso  # noqa: E402

GFF = "/root/reference/misopy/gff-events/mm9/genes/Atp2b1.mm9.gff"
SAM = "/root/reference/misopy/test-data/sam-data/c2c12.Atp2b1.sam"
READ_LEN = 36

pytestmark = pytest.mark.skipif(
    not (os.path.isfile(GFF) and os.path.isfile(SAM)),
    reason="reference Atp2b1 fixture unavailable")


@pytest.fixture(scope="module")
def ref_driver():
    driver = build_ref_driver()
    if driver is None:
        pytest.skip("reference C engine build unavailable")
    return driver


@pytest.fixture(scope="module")
def quantified(tmp_path_factory):
    """Our full pipeline on the real BAM: index -> sam_to_bam ->
    compute_all_genes_psi -> .miso, plus the exact reads it consumed."""
    from miso_jax.io import sam as sam_io
    from miso_jax.io.gff import load_genes_from_gff
    from miso_jax.io.index import index_gff
    from miso_jax.io.miso_file import load_miso_file
    from miso_jax.pipeline import RunConfig, compute_all_genes_psi

    root = tmp_path_factory.mktemp("atp2b1")
    idx = str(root / "index")
    index_gff(GFF, idx)
    bam = sam_io.sam_to_bam(SAM, str(root / "c2c12.Atp2b1.sorted.bam"))
    cfg = RunConfig(read_len=READ_LEN, iters=5000, burn_in=500, lag=10,
                    chains=6, min_event_reads=20)
    out = str(root / "out")
    n = compute_all_genes_psi(idx, bam, READ_LEN, out, cfg=cfg,
                              verbose=False, seed=5)
    assert n == 1
    genes = load_genes_from_gff(GFF)
    (name, gene), = genes.items()
    data = load_miso_file(os.path.join(
        out, gene.chrom if gene.chrom else "NA", "%s.miso" % name))
    aln = sam_io.open_alignments(bam)
    lo, hi = gene.genomic_span()
    raw = sam_io.fetch_bam_reads_in_gene(aln, gene.chrom, lo - 1, hi)
    reads, _ = sam_io.sam_parse_reads(raw, given_read_len=None)
    return {"gene": gene, "data": data, "reads": reads}


@pytest.fixture(scope="module")
def ref_result(ref_driver, quantified):
    positions, cigars = quantified["reads"]
    return run_ref_miso(
        ref_driver, GFF, np.asarray(positions) + 1, cigars,
        read_len=READ_LEN, iters=5000, burn_in=500, lag=10, chains=6,
        seed=77)


@pytest.fixture(scope="module")
def ref_perm(quantified):
    """ref isoform index -> our isoform index.

    The C engine's OWN GFF reader reindexes mRNAs alphabetically by ID
    (gff.c:386-389 strcmp on mRNA ids inside splicing_gff_reindex);
    the reference PRODUCT loads genes through the Python layer in FILE
    order (gff_utils.py list append -> Gene.py isoform order), which
    is also our order.  Atp2b1's transcripts sort differently than
    they appear, so the driver's isoform axis is a permutation of the
    product's -- map it before comparing."""
    labels = [iso.label for iso in quantified["gene"].isoforms]
    order = sorted(range(len(labels)), key=lambda i: labels[i])
    return order  # ref index r corresponds to our index order[r]


def _parse_counts(counts_str):
    import re

    return {tuple(int(x) for x in tmpl.split(",")): int(cnt)
            for tmpl, cnt in re.findall(r"\((\d+(?:,\d+)*)\):(\d+)",
                                        counts_str)}


def test_atp2b1_read_classes_exact(quantified, ref_result, ref_perm):
    """Both engines decompose the real reads into IDENTICAL
    compatibility classes (deterministic; solve.c:8-108), up to the
    driver's documented isoform-axis permutation."""
    ours = _parse_counts(quantified["data"].params["counts"])
    ref = {}
    for tmpl, cnt in ref_result.classes:
        ours_tmpl = [0] * len(tmpl)
        for r, v in enumerate(tmpl):
            ours_tmpl[ref_perm[r]] = v
        ref[tuple(ours_tmpl)] = cnt
    assert ours == ref


def test_atp2b1_psi_parity(quantified, ref_result, ref_perm):
    """Posterior Psi means within MC tolerance on the real gene."""
    m_ours = np.asarray(quantified["data"].samples).mean(axis=0)
    m_ref_perm = np.empty_like(m_ours)
    m_ref = ref_result.samples.mean(axis=0)
    for r, o in enumerate(ref_perm):
        m_ref_perm[o] = m_ref[r]
    assert np.all(np.abs(m_ours - m_ref_perm) < 0.05), (m_ours,
                                                        m_ref_perm)


def test_atp2b1_ci_parity(quantified, ref_result, ref_perm):
    """Chen-Shao 95% credible intervals within tolerance."""
    from miso_jax.stats.intervals import compute_credible_intervals

    ref_col = ref_perm.index(0)
    ours = np.asarray(quantified["data"].samples)[:, 0]
    ref = ref_result.samples[:, ref_col]
    lo_o, hi_o = compute_credible_intervals(ours, 0.95)
    lo_r, hi_r = compute_credible_intervals(ref, 0.95)
    assert abs(lo_o - lo_r) < 0.08 and abs(hi_o - hi_r) < 0.08, (
        (lo_o, hi_o), (lo_r, hi_r))
