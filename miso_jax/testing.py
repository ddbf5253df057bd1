"""Synthetic catalog generation: many events -> one GFF3 + one BAM.

The framework-level equivalent of the reference's simulation-backed
tests (misopy/legacy_test_pysplicing.py, read_simulator.py), scaled to
whole catalogs so end-to-end runs and benchmarks are reproducible from
the CLI surface down.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from miso_jax.core.gene import Exon, Gene, Isoform
from miso_jax.core.simulate import simulate_reads
from miso_jax.io.gff import GFFRecord, write_gff
from miso_jax.io.sam import AlignedRead, sam_to_bam, write_bam


def make_se_catalog(
    num_events: int,
    rng: np.random.Generator,
    chroms: int = 4,
    exon_lens=(100, 50, 100),
) -> Tuple[List[Gene], List[GFFRecord], np.ndarray]:
    """num_events SE genes spaced along `chroms` chromosomes.
    Returns (genes, gff_records, true_psi (num_events,))."""
    genes: List[Gene] = []
    records: List[GFFRecord] = []
    true_psi = rng.uniform(0.05, 0.95, size=num_events)
    spacing = sum(exon_lens) + 1000
    for e in range(num_events):
        chrom = "chr%d" % (1 + e % chroms)
        offset = 1 + (e // chroms) * spacing
        starts = np.cumsum([offset] + list(exon_lens[:-1])).tolist()
        parts = [Exon(int(s), int(s + l - 1), label="%s.p%d" % ("ev%d" % e, i))
                 for i, (s, l) in enumerate(zip(starts, exon_lens))]
        gene = Gene(
            parts=parts,
            isoforms=[Isoform((0, 1, 2), label="ev%d.A" % e,
                              desc=["up", "se", "dn"]),
                      Isoform((0, 2), label="ev%d.B" % e,
                              desc=["up", "dn"])],
            label="ev%d" % e, chrom=chrom, strand="+")
        genes.append(gene)
        gid = gene.label
        lo, hi = gene.genomic_span()
        records.append(GFFRecord(chrom, "sim", "gene", lo, hi, None, "+",
                                 None, {"ID": [gid]}))
        for iso in gene.isoforms:
            records.append(GFFRecord(chrom, "sim", "mRNA", lo, hi, None,
                                     "+", None,
                                     {"ID": [iso.label], "Parent": [gid]}))
            for pi in iso.parts:
                p = gene.parts[pi]
                records.append(GFFRecord(
                    chrom, "sim", "exon", p.start, p.end, None, "+", None,
                    {"ID": ["%s.%s" % (iso.label, p.label)],
                     "Parent": [iso.label]}))
    return genes, records, true_psi


def simulate_catalog_bam(
    genes: List[Gene],
    true_psi: np.ndarray,
    reads_per_event: int,
    read_len: int,
    bam_path: str,
    rng: np.random.Generator,
) -> None:
    """Simulate reads for every gene and write one coordinate-sorted BAM."""
    reads: List[AlignedRead] = []
    for e, gene in enumerate(genes):
        psi = [float(true_psi[e]), 1.0 - float(true_psi[e])]
        _, pos, cig = simulate_reads(gene, psi, reads_per_event, read_len,
                                     rng)
        for r in range(len(pos)):
            reads.append(AlignedRead(
                qname="sim_%d_%d" % (e, r), flag=0, rname=gene.chrom,
                pos=int(pos[r]) - 1, mapq=255, cigar_str=cig[r],
                rlen=read_len))
    chroms = sorted({g.chrom for g in genes})
    order = {c: i for i, c in enumerate(chroms)}
    reads.sort(key=lambda r: (order[r.rname], r.pos))
    lengths = [max(g.genomic_span()[1] for g in genes if g.chrom == c)
               + 1000 for c in chroms]
    write_bam(bam_path, chroms, lengths, reads)


def simulate_catalog_bam_paired(
    genes: List[Gene],
    true_psi: np.ndarray,
    pairs_per_event: int,
    read_len: int,
    mean_frag_len: float,
    sd_frag_len: float,
    bam_path: str,
    rng: np.random.Generator,
) -> None:
    """Simulate proper mate pairs for every gene (FR orientation flags,
    as the pairing QC requires, misopy/sam_utils.py:210-289) and write
    one coordinate-sorted BAM."""
    from miso_jax.core.simulate import simulate_paired_reads

    reads: List[AlignedRead] = []
    for e, gene in enumerate(genes):
        psi = [float(true_psi[e]), 1.0 - float(true_psi[e])]
        _, pos, cig = simulate_paired_reads(
            gene, psi, pairs_per_event, read_len, mean_frag_len,
            sd_frag_len ** 2, rng=rng)
        for r in range(len(pos)):
            flag = 0x1 | 0x2 | (0x40 | 0x20 if r % 2 == 0
                                else 0x80 | 0x10)
            reads.append(AlignedRead(
                qname="sim_%d_%d" % (e, r // 2), flag=flag,
                rname=gene.chrom, pos=int(pos[r]) - 1, mapq=255,
                cigar_str=cig[r], rlen=read_len))
    chroms = sorted({g.chrom for g in genes})
    order = {c: i for i, c in enumerate(chroms)}
    reads.sort(key=lambda r: (order[r.rname], r.pos))
    lengths = [max(g.genomic_span()[1] for g in genes if g.chrom == c)
               + 1000 for c in chroms]
    write_bam(bam_path, chroms, lengths, reads)


def build_paired_catalog_fixture(
    out_dir: str,
    num_events: int = 2000,
    pairs_per_event: int = 150,
    read_len: int = 40,
    mean_frag_len: float = 250.0,
    sd_frag_len: float = 15.0,
    seed: int = 0,
) -> Dict[str, object]:
    """Paired-end GFF + BAM + truth table (exons sized so the fragment
    distribution fits both isoforms)."""
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    genes, records, true_psi = make_se_catalog(
        num_events, rng, exon_lens=(300, 100, 300))
    gff_path = os.path.join(out_dir, "catalog.gff")
    write_gff(records, gff_path)
    bam_path = os.path.join(out_dir, "catalog.bam")
    simulate_catalog_bam_paired(genes, true_psi, pairs_per_event,
                                read_len, mean_frag_len, sd_frag_len,
                                bam_path, rng)
    return {"gff": gff_path, "bam": bam_path, "true_psi": true_psi,
            "genes": genes, "read_len": read_len,
            "mean_frag_len": mean_frag_len, "sd_frag_len": sd_frag_len}


def sampler_events(num_events: int, num_iso: int = 2,
                   reads_per_event: int = 200, read_len: int = 25,
                   seed: int = 0):
    """Compiled single-end events with known psi for sampler checks:
    exon-skipping genes (num_iso=2) or a three-isoform cassette pair
    (num_iso=3).  Returns (events, true_psi (num_events, num_iso))."""
    from miso_jax.core.events import compile_single_end
    from miso_jax.core.gene import make_gene

    if num_iso == 2:
        gene = make_gene([100, 50, 100], [[1, 2, 3], [1, 3]])
    elif num_iso == 3:
        gene = make_gene([100, 50, 80, 100],
                         [[1, 2, 3, 4], [1, 3, 4], [1, 4]])
    else:
        raise ValueError("num_iso must be 2 or 3")
    rng = np.random.default_rng(seed)
    events, truth = [], []
    for e in range(num_events):
        psi = rng.dirichlet(np.full(num_iso, 2.0))
        _, pos, cig = simulate_reads(gene, psi, reads_per_event, read_len,
                                     rng)
        events.append(compile_single_end(gene, pos, cig, read_len=read_len,
                                         name="ev%d" % e))
        truth.append(psi)
    return events, np.array(truth)


def sampler_batch(num_events: int, num_iso: int = 2, pad_reads: int = 224,
                  seed: int = 0, distinct: int = 64):
    """An EventBatch of `num_events` events padded to (num_iso, pad_reads):
    `distinct` simulated events tiled over the batch (the device work per
    event is the same as for distinct events)."""
    from miso_jax.core.events import pad_events
    from miso_jax.sampler.mcmc import EventBatch

    protos, _ = sampler_events(min(distinct, num_events), num_iso,
                               reads_per_event=min(200, pad_reads),
                               seed=seed)
    events = [protos[i % len(protos)] for i in range(num_events)]
    pad = pad_events(events, pad_iso=num_iso, pad_reads=pad_reads)
    return EventBatch(**{k: np.asarray(v) for k, v in pad.items()})


def build_catalog_fixture(
    out_dir: str,
    num_events: int = 50,
    reads_per_event: int = 300,
    read_len: int = 36,
    seed: int = 0,
) -> Dict[str, object]:
    """GFF + BAM + truth table under out_dir; returns paths + truth."""
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    genes, records, true_psi = make_se_catalog(num_events, rng)
    gff_path = os.path.join(out_dir, "catalog.gff")
    write_gff(records, gff_path)
    bam_path = os.path.join(out_dir, "catalog.bam")
    simulate_catalog_bam(genes, true_psi, reads_per_event, read_len,
                         bam_path, rng)
    return {"gff": gff_path, "bam": bam_path, "true_psi": true_psi,
            "genes": genes, "read_len": read_len}
