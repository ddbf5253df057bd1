"""`miso_simulate` -- synthetic read generation to SAM.

The first-class synthetic data backend (parity with
pysplicing.simulateReads / misopy/read_simulator.py, promoted to a CLI so
benchmarks and tests are reproducible end-to-end through the file formats).
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def write_sam(path, gene, positions, cigars, chrom, paired=False):
    with open(path, "w") as f:
        lo, hi = gene.genomic_span()
        f.write("@HD\tVN:1.0\tSO:coordinate\n")
        f.write("@SQ\tSN:%s\tLN:%d\n" % (chrom, hi + 1000))
        order = np.argsort(positions, kind="stable")
        if paired:
            pair_order = np.argsort(positions[0::2], kind="stable")
            for r in pair_order:
                p1, p2 = positions[2 * r], positions[2 * r + 1]
                c1, c2 = cigars[2 * r], cigars[2 * r + 1]
                name = "sim_read_%d" % r
                f.write("%s\t99\t%s\t%d\t255\t%s\t=\t%d\t0\t*\t*\n"
                        % (name, chrom, p1, c1, p2))
                f.write("%s\t147\t%s\t%d\t255\t%s\t=\t%d\t0\t*\t*\n"
                        % (name, chrom, p2, c2, p1))
        else:
            for i, r in enumerate(order):
                f.write("sim_read_%d\t0\t%s\t%d\t255\t%s\t*\t0\t0\t*\t*\n"
                        % (i, chrom, positions[r], cigars[r]))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="miso_simulate")
    p.add_argument("--gff", required=True, help="GFF3 annotation")
    p.add_argument("--gene", default=None, help="gene ID (default: first)")
    p.add_argument("--psi", required=True,
                   help="comma-separated isoform expression")
    p.add_argument("--num-reads", type=int, default=1000)
    p.add_argument("--read-len", type=int, default=36)
    p.add_argument("--paired-end", nargs=2, type=float, default=None,
                   metavar=("MEAN", "SD"))
    p.add_argument("--output", required=True, help="output SAM path")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    from miso_jax.core.simulate import simulate_paired_reads, simulate_reads
    from miso_jax.io.gff import load_genes_from_gff

    genes = load_genes_from_gff(args.gff)
    if not genes:
        print("No genes in %s" % args.gff, file=sys.stderr)
        return 1
    gene_id = args.gene or next(iter(genes))
    gene = genes[gene_id]
    psi = np.array([float(x) for x in args.psi.split(",")])
    psi = psi / psi.sum()
    if len(psi) != gene.num_isoforms:
        print("psi has %d entries; gene %s has %d isoforms"
              % (len(psi), gene_id, gene.num_isoforms), file=sys.stderr)
        return 1
    rng = np.random.default_rng(args.seed)
    if args.paired_end is not None:
        mean, sd = args.paired_end
        _, pos, cig = simulate_paired_reads(
            gene, psi, args.num_reads, args.read_len, mean, sd * sd, rng=rng)
        write_sam(args.output, gene, pos, cig, gene.chrom or "chr1",
                  paired=True)
    else:
        _, pos, cig = simulate_reads(
            gene, psi, args.num_reads, args.read_len, rng=rng)
        write_sam(args.output, gene, pos, cig, gene.chrom or "chr1")
    print("Wrote %d reads for %s to %s"
          % (args.num_reads, gene_id, args.output))
    return 0


if __name__ == "__main__":
    sys.exit(main())
