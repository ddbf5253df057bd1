"""Paired-end batch compiler vs the per-gene path: exact equality.

compile_paired_end_many runs ONE native match+collapse call for a whole
chromosome's paired genes (core/events.py); every tensor must equal the
per-gene compile_paired_end run on the same ChromPairs slice --
identical class templates/counts/fragment lengths, weights, scores.
"""
import os
import tempfile

import numpy as np
import pytest

from miso_jax.core.events import compile_paired_end, compile_paired_end_many
from miso_jax.core.gene import make_gene
from miso_jax.core.simulate import simulate_paired_reads
from miso_jax.io import sam as sam_io
from miso_jax.io.sam import AlignedRead, write_bam


@pytest.fixture(scope="module")
def paired_chrom(tmp_path_factory):
    rng = np.random.default_rng(7)
    genes, reads = [], []
    for e in range(10):
        off = 1 + e * 2500
        # alternate structures, incl. a 3-isoform gene
        if e % 3 == 2:
            g = make_gene([300, 80, 120, 300],
                          [[1, 2, 3, 4], [1, 3, 4], [1, 4]],
                          chrom="chr1", strand="+", label="g%d" % e,
                          offset=off)
        else:
            g = make_gene([300, 100, 300], [[1, 2, 3], [1, 3]],
                          chrom="chr1", strand="+", label="g%d" % e,
                          offset=off)
        genes.append(g)
        psi = rng.dirichlet(np.ones(g.num_isoforms))
        n = 30 if e == 5 else 150   # one low-coverage gene (skip rule)
        _, pos, cig = simulate_paired_reads(g, psi, n, 40, 250.0, 225.0,
                                            rng=rng)
        for r in range(len(pos)):
            flag = 0x1 | 0x2 | (0x40 | 0x20 if r % 2 == 0
                                else 0x80 | 0x10)
            reads.append(AlignedRead(
                qname="g%d_p%d" % (e, r // 2), flag=flag, rname="chr1",
                pos=int(pos[r]) - 1, mapq=255, cigar_str=cig[r], rlen=40))
    reads.sort(key=lambda r: r.pos)
    bam = str(tmp_path_factory.mktemp("pb") / "p.bam")
    write_bam(bam, ["chr1"], [30000], reads)
    aln = sam_io.open_alignments(bam)
    scan = aln.scan_chrom_columnar_paired("chr1")
    if scan is None:
        pytest.skip("native scanner unavailable")
    return genes, scan


def test_paired_batch_equals_per_gene(paired_chrom):
    genes, scan = paired_chrom
    kw = dict(read_len=40, mean_frag_len=250.0, frag_variance=225.0,
              num_sds=4.0)
    evs = compile_paired_end_many(
        genes, [g.label for g in genes], scan, min_event_reads=50, **kw)
    if evs is None:
        pytest.skip("native batch matcher unavailable")
    checked = 0
    for g, evb in zip(genes, evs):
        lo, hi = g.genomic_span()
        pos, cig, npairs = scan.slice(lo - 1, hi)
        if npairs < 50:
            assert evb is None  # min_event_reads skip (run_miso.py:141)
            continue
        eva = compile_paired_end(g, np.asarray(pos) + 1, list(cig),
                                 name=g.label, **kw)
        np.testing.assert_array_equal(eva.classes.templates,
                                      evb.classes.templates)
        np.testing.assert_array_equal(eva.classes.counts,
                                      evb.classes.counts)
        np.testing.assert_array_equal(eva.classes.frag_len,
                                      evb.classes.frag_len)
        np.testing.assert_allclose(eva.weights, evb.weights)
        np.testing.assert_allclose(eva.log_read, evb.log_read)
        np.testing.assert_allclose(eva.log_iso_w, evb.log_iso_w)
        assert eva.num_reads == evb.num_reads == npairs
        checked += 1
    assert checked >= 8
    # the CLI-level paired path is covered by
    # tests/test_pipeline.py::test_paired_end_cli, which now routes
    # through compile_paired_end_many


def test_compile_tables_equal_gene_path(tmp_path):
    """The index's precomputed compile tables must drive
    compile_single_end_many to the SAME events as the Gene-object path
    (the tables are a pure cache; any divergence is silent corruption)."""
    import os

    import jax

    from miso_jax.io.index import (get_gene_ids_to_filenames, index_gff,
                                   load_chrom_batch, load_compile_tables)
    from miso_jax.testing import build_catalog_fixture
    from miso_jax.core.events import compile_single_end_many

    fix = build_catalog_fixture(str(tmp_path / "c"), num_events=60,
                                reads_per_event=60, read_len=36, seed=9)
    idx = str(tmp_path / "idx")
    index_gff(fix["gff"], idx)
    aln = sam_io.open_alignments(fix["bam"])
    ids = get_gene_ids_to_filenames(idx)
    d = os.path.dirname(sorted(ids.values())[0])
    batch = load_chrom_batch(d)
    tables = load_compile_tables(d)
    assert batch is not None and tables is not None
    gids = sorted(batch.keys())
    genes = [batch[g]["gene_object"] for g in gids]
    chrom = genes[0].chrom
    genes = [g for g in genes if g.chrom == chrom]
    gids = [g.label for g in genes]
    scan = aln.scan_chrom_columnar(chrom)
    if scan is None:
        pytest.skip("native scanner unavailable")
    kw = dict(read_len=36, min_event_reads=20)
    via_tables = compile_single_end_many(
        genes, gids, scan, tables=tables,
        rows=[tables["row"][g] for g in gids], **kw)
    via_genes = compile_single_end_many(genes, gids, scan, **kw)
    assert via_tables is not None and via_genes is not None
    n = 0
    for a, b in zip(via_tables, via_genes):
        assert (a is None) == (b is None)
        if a is None:
            continue
        np.testing.assert_array_equal(a.classes.templates,
                                      b.classes.templates)
        np.testing.assert_array_equal(a.counts, b.counts)
        np.testing.assert_allclose(a.weights, b.weights)
        np.testing.assert_allclose(a.log_iso_w, b.log_iso_w)
        assert a.num_reads == b.num_reads
        n += 1
    assert n >= 10
