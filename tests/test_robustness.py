"""Adversarial-input robustness: malformed annotations, empty inputs,
degenerate genes -- the pipeline must skip/warn, never crash."""
import os

import numpy as np
import pytest


def test_malformed_gff_lines_skipped(tmp_path):
    from miso_jax.io.gff import load_genes_from_gff
    p = tmp_path / "bad.gff"
    p.write_text(
        "##gff-version 3\n"
        "chr1\tx\tgene\t1\t100\t.\t+\t.\tID=g1\n"
        "chr1\tx\tmRNA\t1\t100\t.\t+\t.\tID=t1;Parent=g1\n"
        "garbage line without tabs\n"
        "chr1\tx\texon\t1\t100\t.\t+\t.\tID=t1.e;Parent=t1\n"
        "chr1\tx\texon\tnot_a_number\n")
    genes = load_genes_from_gff(str(p))
    assert "g1" in genes


def test_gene_with_no_transcripts_skipped(tmp_path):
    from miso_jax.io.gff import load_genes_from_gff
    p = tmp_path / "empty.gff"
    p.write_text("chr1\tx\tgene\t1\t100\t.\t+\t.\tID=lonely\n")
    assert load_genes_from_gff(str(p)) == {}


def test_empty_bam_run(tmp_path):
    """A catalog run against an alignment file with zero reads: every
    event skips, no output, no crash."""
    from miso_jax.cli.index_gff import main as index_main
    from miso_jax.cli.main import main as miso_main
    from miso_jax.io.sam import write_bam
    from miso_jax.testing import make_se_catalog

    rng = np.random.default_rng(0)
    genes, records, _ = make_se_catalog(3, rng)
    from miso_jax.io.gff import write_gff
    gff = str(tmp_path / "c.gff")
    write_gff(records, gff)
    bam = str(tmp_path / "empty.bam")
    write_bam(bam, ["chr1"], [100000], [])
    idx = str(tmp_path / "idx")
    assert index_main(["--index", gff, idx]) == 0
    out = str(tmp_path / "out")
    rc = miso_main(["--run", idx, bam, "--output-dir", out,
                    "--read-len", "36"])
    assert rc == 0
    # no chromosome output dirs with .miso files
    found = []
    for root, _d, files in os.walk(out):
        found += [f for f in files if f.endswith(".miso")]
    assert found == []


def test_single_isoform_gene_skipped(tmp_path):
    from miso_jax.core.gene import make_gene
    from miso_jax.pipeline import RunConfig, compile_gene_event
    g = make_gene([100], [[1]])
    cfg = RunConfig(read_len=20, min_event_reads=1)
    ev = compile_gene_event(g, "solo", ((10, 20), ("20M", "20M")), cfg)
    assert ev is None


def test_reads_on_unknown_chrom(tmp_path):
    from miso_jax.io.sam import AlignedRead, fetch_bam_reads_in_gene, write_bam
    from miso_jax.io.sam import BamReader
    bam = str(tmp_path / "odd.bam")
    write_bam(bam, ["chrZ"], [1000],
              [AlignedRead("r1", 0, "chrZ", 10, 255, "20M", 20)])
    reader = BamReader(bam)
    # gene on a chromosome absent from the BAM -> empty, no crash
    assert fetch_bam_reads_in_gene(reader, "chr1", 0, 1000) == []


def test_unsorted_sam_to_bam(tmp_path):
    """sam_to_bam must coordinate-sort arbitrary input order."""
    from miso_jax.io.sam import BamReader, sam_to_bam
    sam = tmp_path / "u.sam"
    sam.write_text(
        "@SQ\tSN:chr1\tLN:10000\n"
        "r2\t0\tchr1\t500\t255\t20M\t*\t0\t0\tAAAAAAAAAAAAAAAAAAAA\t*\n"
        "r1\t0\tchr1\t100\t255\t20M\t*\t0\t0\tAAAAAAAAAAAAAAAAAAAA\t*\n")
    out = str(tmp_path / "u.bam")
    sam_to_bam(str(sam), out)
    reads = list(BamReader(out))
    assert [r.pos for r in reads] == [99, 499]


def test_zero_length_exon_annotation(tmp_path):
    """Degenerate exon (start == end, 1bp) must not break matching."""
    from miso_jax.core.gene import Exon, Gene, Isoform
    from miso_jax.core.matching import match_iso
    g = Gene(parts=[Exon(1, 100), Exon(150, 150), Exon(200, 300)],
             isoforms=[Isoform((0, 1, 2)), Isoform((0, 2))],
             chrom="chr1", strand="+")
    m = match_iso(g, np.array([10]), ["20M"], read_len=20)
    assert m.shape == (2, 1)


def test_overlapping_genes_catalog(tmp_path):
    """Two genes sharing coordinates: reads are fetched per gene span and
    each event quantifies independently."""
    from miso_jax.core.gene import make_gene
    from miso_jax.core.simulate import simulate_reads
    from miso_jax.pipeline import RunConfig, compile_gene_event, run_events
    rng = np.random.default_rng(1)
    g1 = make_gene([100, 50, 100], [[1, 2, 3], [1, 3]])
    g2 = make_gene([120, 60, 120], [[1, 2, 3], [1, 3]])
    cfg = RunConfig(read_len=25, iters=300, burn_in=100, lag=5, chains=2,
                    min_event_reads=5)
    events = []
    for g in (g1, g2):
        _, pos, cig = simulate_reads(g, [0.5, 0.5], 200, 25, rng)
        ev = compile_gene_event(g, g.label or "g",
                                (tuple(int(p) - 1 for p in pos),
                                 tuple(cig)), cfg)
        assert ev is not None
        events.append(ev)
    results = run_events(events, cfg)
    assert all(r is not None for r in results)
