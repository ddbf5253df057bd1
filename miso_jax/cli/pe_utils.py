"""`pe_utils` -- paired-end insert-length distribution estimation.

Parity: misopy/pe_utils.py (compute_insert_len :224+,
compute_inserts_from_paired_mates :148-221, compute_insert_len_stats,
summarize_insert_len_dist).  The reference shells out to bedtools
`tagBam`; here reads are tagged against constitutive-exon intervals
natively with the built-in BAM reader.

Output `.insert_len` file: `#mean=X,sdev=Y,dispersion=Z,num_pairs=N`
header followed by `interval<TAB>len1,len2,...` lines.
"""
from __future__ import annotations

import argparse
import math
import os
import sys
from collections import defaultdict
from typing import Dict, List, Tuple

import numpy as np


def parse_insert_len_params(header: str) -> Dict[str, str]:
    """Ref: misopy/pe_utils.py:34-42."""
    header = header.strip()
    if header.startswith("#"):
        header = header[1:]
    return dict(kv.split("=") for kv in header.split(","))


def load_insert_len(path: str) -> Tuple[float, float, float, int]:
    with open(path) as f:
        params = parse_insert_len_params(f.readline())
    return (float(params["mean"]), float(params["sdev"]),
            float(params["dispersion"]), int(params["num_pairs"]))


def compute_insert_len_stats(insert_dist) -> Tuple[float, float, float, int]:
    """mean, sdev, dispersion = sdev/sqrt(mean), n.
    Ref: misopy/pe_utils.py compute_insert_len_stats."""
    arr = np.asarray(insert_dist, dtype=np.float64)
    mu = float(arr.mean())
    sdev = float(arr.std())
    dispersion = sdev / math.sqrt(mu) if mu > 0 else float("nan")
    return mu, sdev, dispersion, len(arr)


def _single_m_span(read) -> Tuple[int, int]:
    """(start, end) 0-based inclusive for a single-M-run read; None-span
    (-1,-1) otherwise (junction reads are excluded; pe_utils.py:179-186)."""
    cig = read.cigar_str
    if not cig or cig == "*" or not cig[:-1].isdigit() or cig[-1] != "M":
        return -1, -1
    n = int(cig[:-1])
    return read.pos, read.pos + n - 1


class _ExonIndex:
    """Containment queries over one chromosome's constitutive exons:
    start-sorted arrays + a prefix max of ends, so find() is one
    binary search plus a scan that stops as soon as no earlier exon
    can reach the query (the naive per-read linear scan over all exons
    made 7.5M-pair catalogs take tens of minutes)."""

    def __init__(self, exons):
        exons = sorted(exons, key=lambda e: e.start)
        self.starts = np.array([e.start - 1 for e in exons],
                               dtype=np.int64)
        self.ends = np.array([e.end - 1 for e in exons], dtype=np.int64)
        self.cummax_end = (np.maximum.accumulate(self.ends)
                           if len(exons) else self.ends)
        self.labels = ["%s:%d-%d:%s" % (e.seqid, e.start, e.end,
                                        e.strand or ".")
                       for e in exons]

    def find(self, start: int, end: int) -> List[str]:
        """Labels of exons fully containing [start, end] (0-based)."""
        i = int(np.searchsorted(self.starts, start, "right")) - 1
        out = []
        while i >= 0 and self.cummax_end[i] >= end:
            if self.ends[i] >= end:  # starts[i] <= start by search
                out.append(self.labels[i])
            i -= 1
        return out


def compute_inserts(alignments, exons) -> Dict[str, List[int]]:
    """Map read pairs fully inside one constitutive exon to insert lengths
    (right.end - left.start + 1).  Ref: pe_utils.py:148-221."""
    from miso_jax.io.sam import pair_sam_reads
    interval_to_dists: Dict[str, List[int]] = defaultdict(list)
    # index exons by chrom for interval lookup
    grouped: Dict[str, List] = defaultdict(list)
    for e in exons:
        grouped[e.seqid].append(e)
    by_chrom = {c: _ExonIndex(es) for c, es in grouped.items()}
    empty = _ExonIndex([])
    num_kept = num_skipped = 0
    paired = pair_sam_reads(list(alignments))
    for _name, (left, right) in paired.items():
        ls, le = _single_m_span(left)
        rs, re_ = _single_m_span(right)
        if ls < 0 or rs < 0:
            num_skipped += 1
            continue
        hits_l = by_chrom.get(left.rname, empty).find(ls, le)
        hits_r = by_chrom.get(right.rname, empty).find(rs, re_)
        if len(hits_l) != 1 or len(hits_r) != 1 or hits_l[0] != hits_r[0]:
            num_skipped += 1
            continue
        insert_len = re_ - ls + 1
        if insert_len <= 0:
            continue
        interval_to_dists[hits_l[0]].append(insert_len)
        num_kept += 1
    print("Used %d paired mates, threw out %d" % (num_kept, num_skipped))
    return interval_to_dists


def compute_insert_len(bam_filename: str, const_exons_gff: str,
                       output_dir: str, min_exon_size: int,
                       sd_max: int = 2) -> str:
    from miso_jax.io.gff import read_gff
    from miso_jax.io.sam import open_alignments

    os.makedirs(output_dir, exist_ok=True)
    exons = [r for r in read_gff(const_exons_gff)
             if r.type == "exon" and (r.end - r.start + 1) >= min_exon_size]
    print("Using %d constitutive exons (>= %d bp)"
          % (len(exons), min_exon_size))
    alignments = open_alignments(bam_filename)
    interval_to_dists = compute_inserts(alignments, exons)

    all_dists = [d for ds in interval_to_dists.values() for d in ds]
    if not all_dists:
        print("WARNING: no insert lengths found.")
        all_dists = [0]
    mu, sdev, dispersion, _ = compute_insert_len_stats(all_dists)
    # outlier filter at sd_max deviations (pe_utils.py filter_insert_len)
    lo, hi = mu - sd_max * sdev, mu + sd_max * sdev
    filtered = {
        k: [d for d in ds if lo <= d <= hi]
        for k, ds in interval_to_dists.items()
    }
    filtered = {k: ds for k, ds in filtered.items() if ds}
    final = [d for ds in filtered.values() for d in ds] or [0]
    mu, sdev, dispersion, num_pairs = compute_insert_len_stats(final)

    out_path = os.path.join(
        output_dir, os.path.basename(bam_filename) + ".insert_len")
    with open(out_path, "w") as f:
        f.write("#%s=%.1f,%s=%.1f,%s=%.1f,%s=%d\n"
                % ("mean", mu, "sdev", sdev,
                   "dispersion", dispersion, "num_pairs", num_pairs))
        for interval, dists in filtered.items():
            f.write("%s\t%s\n" % (interval,
                                  ",".join(str(d) for d in dists)))
    print("Insert length distribution -> %s" % out_path)
    print("  mean=%.1f sdev=%.1f dispersion=%.1f num_pairs=%d"
          % (mu, sdev, dispersion, num_pairs))
    return out_path


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="pe_utils")
    p.add_argument("--compute-insert-len", dest="compute_insert_len",
                   nargs=2, default=None, metavar=("BAMS", "CONST_EXONS_GFF"))
    p.add_argument("--min-exon-size", dest="min_exon_size", type=int,
                   default=500)
    p.add_argument("--sd-max", dest="sd_max", type=int, default=2)
    p.add_argument("--no-bam-filter", action="store_true", default=False)
    p.add_argument("--output-dir", dest="output_dir", default=None)
    args = p.parse_args(argv)
    if args.compute_insert_len is None or args.output_dir is None:
        print("Need --compute-insert-len BAM,.. CONST_EXONS_GFF "
              "--output-dir DIR", file=sys.stderr)
        return 1
    bams, gff = args.compute_insert_len
    for bam in bams.split(","):
        compute_insert_len(
            os.path.abspath(os.path.expanduser(bam)),
            os.path.abspath(os.path.expanduser(gff)),
            os.path.abspath(os.path.expanduser(args.output_dir)),
            args.min_exon_size, sd_max=args.sd_max)
    return 0


if __name__ == "__main__":
    sys.exit(main())
