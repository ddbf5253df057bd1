"""RPKM estimation over constitutive exons.

Parity: misopy/sam_rpkm.py:30-238 (compute_rpkm; exploratory module, not
an installed console script in the reference either).
RPKM = (reads in const exons / const-exon kb) / (total reads / 1e6).
"""
from __future__ import annotations

import argparse
import os
import sys
from typing import List

import numpy as np


def gene_const_parts(gene) -> List[int]:
    """Part indices present in every isoform (Gene.py:165-192)."""
    sets = [set(iso.parts) for iso in gene.isoforms]
    if not sets:
        return []
    common = set.intersection(*sets)
    return sorted(common)


def _exon_counts_scan(alignments, by_chrom, read_len: int):
    """(counts dict, total mapped reads) via ONE columnar scan per
    chromosome: the reads-fully-inside predicate (pos+1 >= start and
    pos+read_len-1 <= end, sam_rpkm semantics) is a pure position
    range, so each exon is two binary searches -- per-gene region
    fetches re-inflated BGZF blocks and built per-read objects (287s
    at 50k genes; this path is ~5s)."""
    counts = {}
    total = 0
    seen = set()
    for chrom, items in by_chrom.items():
        c = chrom
        if c not in alignments.references:
            parts = c.split("chr")
            c = parts[0] if len(parts) <= 1 else parts[1]
        try:
            scan = alignments.scan_chrom_columnar(c)
        except KeyError:
            continue
        seen.add(c)
        pos = scan.pos
        total += len(pos)
        for key, start, end in items:
            # predicate parity with the per-read path: pos >= start-1
            # and pos + read_len - 1 <= end with 0-based pos vs the
            # 1-based exon end, i.e. pos <= end - read_len + 1
            lo = int(np.searchsorted(pos, start - 1, "left"))
            hi = int(np.searchsorted(pos, end - read_len + 1, "right"))
            counts[key] = counts.get(key, 0) + max(hi - lo, 0)
    # mapped reads on chromosomes without annotated genes still count
    # toward the library size
    for c in alignments.references:
        if c not in seen:
            try:
                total += len(alignments.scan_chrom_columnar(c).pos)
            except KeyError:
                pass
    return counts, total


def compute_rpkm(gff_filename: str, bam_filename: str, read_len: int,
                 output_dir: str) -> str:
    from collections import defaultdict

    from miso_jax.io.gff import load_genes_from_gff
    from miso_jax.io.sam import fetch_bam_reads_in_gene, open_alignments

    os.makedirs(output_dir, exist_ok=True)
    output_filename = os.path.join(
        output_dir, "%s.rpkm" % os.path.basename(bam_filename))
    genes = load_genes_from_gff(gff_filename)
    alignments = open_alignments(bam_filename)

    gene_rows = []  # (gene_id, total_len, [exon keys])
    by_chrom = defaultdict(list)
    for gene_id, gene in genes.items():
        const = gene_const_parts(gene)
        if not const:
            continue
        keys = []
        total_len = 0
        for p in const:
            exon = gene.parts[p]
            total_len += exon.len
            key = (gene_id, p)
            keys.append(key)
            by_chrom[gene.chrom].append((key, exon.start, exon.end))
        gene_rows.append((gene_id, total_len, keys))

    if hasattr(alignments, "scan_chrom_columnar"):
        counts, num_total_reads = _exon_counts_scan(
            alignments, by_chrom, read_len)
    else:
        num_total_reads = sum(1 for _ in alignments)
        counts = {}
        for chrom, items in by_chrom.items():
            for key, start, end in items:
                reads = fetch_bam_reads_in_gene(
                    alignments, chrom, start - 1, end)
                counts[key] = sum(
                    1 for r in reads
                    if r.pos + 1 >= start and
                    r.pos + read_len - 1 <= end)

    with open(output_filename, "w") as out:
        out.write("gene_id\trpkm\tconst_exon_lens\tnum_reads\n")
        for gene_id, total_len, keys in gene_rows:
            total_reads = sum(counts.get(k, 0) for k in keys)
            if total_len == 0 or num_total_reads == 0:
                continue
            rpkm = (total_reads / (total_len / 1e3)) / (num_total_reads / 1e6)
            out.write("%s\t%.4f\t%d\t%d\n"
                      % (gene_id, rpkm, total_len, total_reads))
    print("Outputting RPKMs to: %s" % output_filename)
    return output_filename


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="miso_rpkm")
    p.add_argument("--compute-rpkm", nargs=2, default=None,
                   metavar=("GFF", "BAM"))
    p.add_argument("--read-len", type=int, required=True)
    p.add_argument("--output-dir", required=True)
    args = p.parse_args(argv)
    if args.compute_rpkm is None:
        print("Need --compute-rpkm GFF BAM", file=sys.stderr)
        return 1
    compute_rpkm(os.path.abspath(args.compute_rpkm[0]),
                 os.path.abspath(args.compute_rpkm[1]),
                 args.read_len, os.path.abspath(args.output_dir))
    return 0


if __name__ == "__main__":
    sys.exit(main())
