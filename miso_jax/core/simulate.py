"""Synthetic read simulator: the first-class test/benchmark data backend.

Capability parity with pysplicing/src/simulator.c (splicing_simulate_reads,
splicing_simulate_paired_reads) and misopy/read_simulator.py.  The
generative model:

single-end (simulator.c:69-190):
  isoform ~ Categorical(psi_i * effLen_i),  effLen_i = isolen_i - readLen + 1
  start   ~ Uniform{1..effLen_iso}  (isoform coordinates)
  emit genomic position + `xMyNzM` CIGAR crossing exon junctions.

paired-end (simulator.c:221-440):
  fragment length L ~ fragProb restricted to L <= isolen_i
  isoform ~ Categorical(psi_i * sum_L fragProb(L) * max(isolen_i - L + 1, 0))
  start ~ Uniform over valid starts; mates at isoform coords
  (start, start + L - readLen), both of readLen.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from miso_jax.core.fragments import normal_fragment
from miso_jax.core.gene import Gene


def _iso_coord_to_read(gene: Gene, iso: int, start_ipos: int,
                       read_len: int) -> Tuple[int, str]:
    """Map an isoform-coordinate read start to (genomic pos, CIGAR).
    Ref: pysplicing/src/simulator.c:161-187."""
    starts, ends = gene.iso_exons(iso)
    lens = ends - starts + 1
    cum = np.concatenate([[0], np.cumsum(lens)])
    ex = int(np.searchsorted(cum, start_ipos, side="left")) - 1
    gpos = int(starts[ex] + (start_ipos - cum[ex]) - 1)
    out = []
    rs, rl = gpos, read_len
    while ends[ex] < rs + rl - 1:
        m = int(ends[ex] - rs + 1)
        out.append("%dM%dN" % (m, int(starts[ex + 1] - ends[ex] - 1)))
        rl -= m
        rs = int(starts[ex + 1])
        ex += 1
    out.append("%dM" % rl)
    return gpos, "".join(out)


def simulate_reads(
    gene: Gene,
    psi: np.ndarray,
    num_reads: int,
    read_len: int,
    rng: Optional[np.random.Generator] = None,
) -> Tuple[np.ndarray, np.ndarray, List[str]]:
    """Simulate single-end reads.  Returns (isoform, positions, cigars);
    positions are 1-based genomic."""
    rng = rng or np.random.default_rng()
    psi = np.asarray(psi, dtype=np.float64)
    efflen = np.maximum(gene.iso_lengths - read_len + 1, 0)
    sp = psi * efflen
    if sp.sum() == 0:
        raise ValueError("No isoform is possible")
    sp = sp / sp.sum()
    isoform = rng.choice(len(psi), size=num_reads, p=sp)
    positions = np.zeros(num_reads, dtype=np.int64)
    cigars: List[str] = []
    for r in range(num_reads):
        i = int(isoform[r])
        ipos = int(rng.integers(1, efflen[i] + 1))
        gpos, cig = _iso_coord_to_read(gene, i, ipos, read_len)
        positions[r] = gpos
        cigars.append(cig)
    return isoform, positions, cigars


def simulate_two_iso_reads_with_noise(
    gene: Gene,
    psi: float,
    num_reads: int,
    read_len: int,
    p_ne_loss: float = 0.0,
    p_ne_gain: float = 0.0,
    rng: Optional[np.random.Generator] = None,
) -> Tuple[np.ndarray, np.ndarray, List[str]]:
    """Two-isoform simulation with data-level noise injection: drop
    exclusion-body reads with probability p_ne_loss, or duplicate them
    with probability p_ne_gain -- the reference's closest analogue of
    fault injection (misopy/read_simulator.py:89-148 p_ne_loss/p_ne_gain
    knobs)."""
    rng = rng or np.random.default_rng()
    iso, pos, cig = simulate_reads(gene, [psi, 1 - psi], num_reads,
                                   read_len, rng)
    keep = np.ones(len(pos), dtype=bool)
    extra_pos: List[int] = []
    extra_cig: List[str] = []
    extra_iso: List[int] = []
    for r in range(len(pos)):
        if iso[r] == 1:  # exclusion-isoform read
            if p_ne_loss > 0 and rng.random() < p_ne_loss:
                keep[r] = False
            elif p_ne_gain > 0 and rng.random() < p_ne_gain:
                extra_pos.append(int(pos[r]))
                extra_cig.append(cig[r])
                extra_iso.append(1)
    iso = np.concatenate([iso[keep], np.array(extra_iso, dtype=iso.dtype)])
    pos = np.concatenate([pos[keep], np.array(extra_pos, dtype=pos.dtype)])
    cig = [c for c, k in zip(cig, keep) if k] + extra_cig
    return iso, pos, cig


def simulate_paired_reads(
    gene: Gene,
    psi: np.ndarray,
    num_pairs: int,
    read_len: int,
    mean_frag_len: float,
    frag_variance: float,
    num_sds: float = 4.0,
    rng: Optional[np.random.Generator] = None,
) -> Tuple[np.ndarray, np.ndarray, List[str]]:
    """Simulate paired-end reads; mates are consecutive (2r, 2r+1).

    Returns (isoform (num_pairs,), positions (2*num_pairs,), cigars)."""
    rng = rng or np.random.default_rng()
    psi = np.asarray(psi, dtype=np.float64)
    frag_prob, frag_start = normal_fragment(
        mean_frag_len, frag_variance, num_sds, read_len)
    frag_prob = frag_prob / frag_prob.sum()
    lengths = np.arange(frag_start, frag_start + len(frag_prob))
    isolen = gene.iso_lengths

    # Z[i] = sum_L p(L) * max(isolen_i - L + 1, 0)
    valid_starts = np.maximum(isolen[:, None] - lengths[None, :] + 1, 0)
    Z = (frag_prob[None, :] * valid_starts).sum(axis=1)
    sp = psi * Z
    if sp.sum() == 0:
        raise ValueError("No isoform is possible")
    sp = sp / sp.sum()
    isoform = rng.choice(len(psi), size=num_pairs, p=sp)

    positions = np.zeros(2 * num_pairs, dtype=np.int64)
    cigars: List[str] = [""] * (2 * num_pairs)
    for r in range(num_pairs):
        i = int(isoform[r])
        w = frag_prob * valid_starts[i]
        w = w / w.sum()
        L = int(rng.choice(lengths, p=w))
        start = int(rng.integers(1, isolen[i] - L + 2))
        g1, c1 = _iso_coord_to_read(gene, i, start, read_len)
        g2, c2 = _iso_coord_to_read(gene, i, start + L - read_len, read_len)
        positions[2 * r] = g1
        positions[2 * r + 1] = g2
        cigars[2 * r] = c1
        cigars[2 * r + 1] = c2
    return isoform, positions, cigars
