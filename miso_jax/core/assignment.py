"""Position-sweep assignment-class matrices, linear deconvolution (NNLS),
and gene complexity.

Parity targets:
- assignment matrix: pysplicing/src/assignment.c:90-272
  (splicing_assignment_matrix + splicing_i_assignmat_simplify)
- linear solve:      pysplicing/src/solve.c:308-409 (splicing_solve_gene)
- complexity:        pysplicing/src/complexity.c:5-71

The C implementation sweeps genomic start positions with a run-length
jump (`nextp`): between structural breakpoints the per-isoform local
CIGARs shift uniformly, so the isoform partition is constant and a whole
run of positions contributes one weighted column.  This implementation
keeps that sweep (host-side; it is annotation-only work, done once per
gene) expressed over the gene model instead of mutable numeric-CIGAR
buffers.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from miso_jax.core.gene import Gene


def local_cigar(starts: np.ndarray, ends: np.ndarray, gpos: int,
                read_len: int) -> Optional[Tuple[int, ...]]:
    """Signed-run local CIGAR of a read_len read starting at genomic
    gpos on the exon chain (starts, ends); None if incompatible."""
    ex = int(np.searchsorted(starts, gpos, side="right")) - 1
    if ex < 0 or gpos > ends[ex]:
        return None
    runs: List[int] = []
    rl = read_len
    pos = gpos
    while True:
        avail = int(ends[ex] - pos + 1)
        if avail >= rl:
            runs.append(rl)
            return tuple(runs)
        runs.append(avail)
        rl -= avail
        if ex + 1 >= len(starts):
            return None
        runs.append(-(int(starts[ex + 1]) - int(ends[ex]) - 1))
        pos = int(starts[ex + 1])
        ex += 1


def _next_change(starts: np.ndarray, ends: np.ndarray, gpos: int,
                 read_len: int) -> int:
    """Positions until this isoform's local structure changes (the
    per-isoform term of the C `nextp` computation, assignment.c:182-210)."""
    ex = int(np.searchsorted(starts, gpos, side="right")) - 1
    if ex < 0 or gpos > ends[ex]:
        # in an intron / before the first exon: next exon start
        nxt = int(np.searchsorted(starts, gpos, side="left"))
        if nxt >= len(starts):
            return 1 << 30
        return int(starts[nxt]) - gpos
    cand = int(ends[ex] - gpos + 1)  # first run length
    rl2 = read_len
    e = ex
    pos = gpos
    while e < len(starts):
        avail = int(ends[e] - pos + 1)
        if avail >= rl2:
            p = avail - rl2 + 1
            return min(cand, p)
        rl2 -= avail
        if e + 1 >= len(starts):
            break
        pos = int(starts[e + 1])
        e += 1
    return cand


def assignment_matrix(gene: Gene, read_len: int,
                      overhang: int = 1) -> np.ndarray:
    """(noiso, nclasses) matrix: column c has weight = number of genomic
    start positions generating read class c on each supporting isoform.

    Ref: pysplicing/src/assignment.c:90-272.  As in the reference,
    overhang > 1 is not supported.
    """
    if overhang > 1:
        raise NotImplementedError(
            "Overhang is not implemented in assignment matrix yet.")
    noiso = gene.num_isoforms
    genestart, geneend = gene.genomic_span()
    lastp = geneend - genestart - read_len + 1
    exons = [gene.iso_exons(i) for i in range(noiso)]

    support_weights: Dict[Tuple[int, ...], float] = {}
    p = 0
    while p <= lastp:
        g = genestart + p
        nextp = lastp + 1 - p
        cigs: List[Optional[Tuple[int, ...]]] = []
        for i in range(noiso):
            starts, ends = exons[i]
            cigs.append(local_cigar(starts, ends, g, read_len))
            nc = _next_change(starts, ends, g, read_len)
            if 0 < nc < nextp:
                nextp = nc
        # group isoforms by identical local cigar
        groups: Dict[Tuple[int, ...], List[int]] = {}
        for i, c in enumerate(cigs):
            if c is not None:
                groups.setdefault(c, []).append(i)
        for c, members in groups.items():
            key = tuple(1 if i in members else 0 for i in range(noiso))
            support_weights[key] = support_weights.get(key, 0.0) + nextp
        p += nextp

    keys = sorted(support_weights)
    mat = np.zeros((noiso, len(keys)), dtype=np.float64)
    for col, key in enumerate(keys):
        mat[:, col] = np.array(key, dtype=np.float64) * support_weights[key]
    return mat


def norm_assignment_matrix(mat: np.ndarray) -> np.ndarray:
    """Row-normalize (miso.c:797 splicing_matrix_norm_row): each row sums
    to 1 over classes, giving P(class | isoform)."""
    sums = mat.sum(axis=1, keepdims=True)
    return mat / np.where(sums > 0, sums, 1.0)


def nnls(A: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Lawson-Hanson non-negative least squares.
    Ref: pysplicing/src/nnls.c + lawson_hanson_nnls.c (via scipy)."""
    from scipy.optimize import nnls as scipy_nnls
    x, _ = scipy_nnls(A, b)
    return x


def linear_start_psi(event, read_len: int, overhang: int = 1) -> np.ndarray:
    """MISO_START_LINEAR (miso.c:410-443): NNLS deconvolution of the
    read-class counts against the assignment matrix, from a compiled
    event's stored classes (support patterns + counts are all the match
    vector needs, solve.c:110-137)."""
    from scipy.optimize import nnls as scipy_nnls

    gene = event.gene
    A = assignment_matrix(gene, read_len, overhang)
    class_support = (A > 0)
    mvec = np.zeros(A.shape[1])
    templates = event.classes.templates  # (I, C_read)
    counts = event.classes.counts
    for c in range(templates.shape[1]):
        sup = templates[:, c] > 0
        for cl in range(A.shape[1]):
            if np.array_equal(sup, class_support[:, cl]):
                mvec[cl] += counts[c]
                break
    expr, _ = scipy_nnls(A.T, mvec)
    if expr.sum() <= 0:
        expr = np.full(gene.num_isoforms, 1.0 / gene.num_isoforms)
    expr = np.clip(expr / expr.sum(), 1e-4, None)
    return expr / expr.sum()


def solve_gene(
    gene: Gene,
    read_len: int,
    overhang: int,
    positions: np.ndarray,
    cigars,
    scale: bool = True,
) -> Tuple[np.ndarray, np.ndarray]:
    """Linear deconvolution of isoform expression: NNLS fit of the
    read-class count vector against the assignment matrix.

    Returns (expression (noiso,), residuals (nclasses,)).
    Ref: pysplicing/src/solve.c:308-409 (splicing_solve_gene).
    """
    from miso_jax.core.matching import match_iso, match_vector

    A = assignment_matrix(gene, read_len, overhang)
    match = match_iso(gene, positions, cigars, read_len, overhang)
    mvec = match_vector(match, A)
    expression = nnls(A.T, mvec)
    residuals = mvec - A.T @ expression
    if scale and expression.sum() > 0:
        expression = expression / expression.sum()
    return expression, residuals


def paired_assignment_matrix(
    gene: Gene,
    read_len: int,
    frag_prob: np.ndarray,
    frag_start: int,
    overhang: int = 1,
) -> np.ndarray:
    """Paired-end assignment-class matrix.

    Enumerates, per isoform, every (start, fragment length) generation
    event; read pairs with identical genomic signatures
    (pos1, cigar1, pos2, cigar2) form one class.  Column values are
    per-isoform sums of fragment-length probabilities (each supporting
    isoform implies its OWN fragment length for the signature, exactly as
    splicing_matchIso_paired scores reads), collapsed by support pattern.

    Ref: pysplicing/src/assignment.c:381-611
    (splicing_paired_assignment_matrix).
    """
    if overhang > 1:
        raise NotImplementedError(
            "Overhang is not implemented in assignment matrix yet.")
    noiso = gene.num_isoforms
    frag_prob = np.asarray(frag_prob, dtype=np.float64)
    frag_prob = frag_prob / frag_prob.sum()
    il = len(frag_prob)
    exons = [gene.iso_exons(i) for i in range(noiso)]
    # global cigar interning: Python work is O(unique genomic positions)
    # only; the (start x fragment-length) enumeration itself is numpy
    cigar_ids: Dict[Tuple[int, ...], int] = {}

    def cigar_id_map(iso: int, gposes: np.ndarray) -> np.ndarray:
        """ids (-1 = invalid cigar) for unique genomic positions."""
        starts, ends = exons[iso]
        out = np.empty(len(gposes), np.int64)
        for j, gp in enumerate(gposes):
            c = local_cigar(starts, ends, int(gp), read_len)
            if c is None:
                out[j] = -1
            else:
                out[j] = cigar_ids.setdefault(c, len(cigar_ids))
        return out

    k1_l: List[np.ndarray] = []
    k2_l: List[np.ndarray] = []
    w_l: List[np.ndarray] = []
    iso_l: List[np.ndarray] = []
    for i in range(noiso):
        L_i = gene.iso_length(i)
        # enumerate EVERY (fragment length, start) pair of this isoform
        # in one vectorized pass (per-fragment iso_to_genomic calls
        # recomputed the exon cumsum hundreds of times per isoform)
        frags = np.arange(frag_start, frag_start + il)
        sel = (frags >= read_len) & (frags <= L_i)
        if not sel.any():
            continue
        frags_s = frags[sel]
        probs_s = frag_prob[sel]
        n_starts = (L_i - frags_s + 1).astype(np.int64)
        total = int(n_starts.sum())
        ofs = np.zeros(len(frags_s) + 1, np.int64)
        np.cumsum(n_starts, out=ofs[1:])
        # s1 = 1..n_starts[f] within each fragment block
        s1 = (np.arange(total) - np.repeat(ofs[:-1], n_starts) + 1)
        off = np.repeat(frags_s - read_len, n_starts)
        p = np.repeat(probs_s, n_starts)
        g1 = gene.iso_to_genomic(i, s1)
        g2 = gene.iso_to_genomic(i, s1 + off)
        lo_i, hi_i = gene.iso_genomic_span(i)
        span = hi_i - lo_i + 1
        if span <= max(4 * L_i, 1 << 16):
            # dense span lookup: one local_cigar per genomic position,
            # O(1) id gathers (the 2x~len(g1) unique+inverse this
            # replaces argsorted millions of elements per isoform)
            lut = cigar_id_map(i, np.arange(lo_i, hi_i + 1))
            c1 = lut[g1 - lo_i]
            c2 = lut[g2 - lo_i]
        else:  # huge-intron gene: dedup positions instead
            gall = np.concatenate([g1, g2])
            uniq, inv = np.unique(gall, return_inverse=True)
            cids = cigar_id_map(i, uniq)[inv]
            c1, c2 = cids[:len(g1)], cids[len(g1):]
        ok = (c1 >= 0) & (c2 >= 0)
        # pack each mate's (genomic pos, cigar id) into ONE int64 key:
        # the 4-column np.unique(axis=0) this replaces argsorts a void
        # view at ~15s per long gene; scalar int64 sorts are ~10x faster
        k1_l.append(g1[ok] << 20 | c1[ok])
        k2_l.append(g2[ok] << 20 | c2[ok])
        w_l.append(p[ok])
        iso_l.append(np.full(int(ok.sum()), i, np.int64))
    if not k1_l:
        return np.zeros((noiso, 0))
    if len(cigar_ids) >= (1 << 20):  # key packing bound (never in practice)
        raise ValueError("too many distinct local cigars")
    key1 = np.concatenate(k1_l)
    key2 = np.concatenate(k2_l)
    w = np.concatenate(w_l)
    iso = np.concatenate(iso_l)
    # per-signature per-isoform fragment-prob sums; the signature is
    # (pos1, cigar1, pos2, cigar2), uniqued in two scalar passes
    u1, id1 = np.unique(key1, return_inverse=True)
    u2, id2 = np.unique(key2, return_inverse=True)
    combined = id1.astype(np.int64) * len(u2) + id2
    _, inv = np.unique(combined, return_inverse=True)
    sig_vals = np.zeros((inv.max() + 1, noiso))
    np.add.at(sig_vals, (inv, iso), w)
    # collapse by support pattern (assignment.c simplify), columns in
    # lexicographic support order as before
    supp = sig_vals > 0
    patterns, pinv = np.unique(supp, axis=0, return_inverse=True)
    mat_t = np.zeros((len(patterns), noiso))
    np.add.at(mat_t, pinv, sig_vals)
    # np.unique's row order IS ascending lexicographic, matching the
    # previous sorted(support-tuples) column order
    return mat_t.T


def solve_gene_paired(
    gene: Gene,
    read_len: int,
    overhang: int,
    positions: np.ndarray,
    cigars,
    frag_prob: np.ndarray,
    frag_start: int,
    scale: bool = True,
) -> Tuple[np.ndarray, np.ndarray]:
    """Paired-end linear deconvolution (NNLS).
    Ref: pysplicing/src/solve.c:411-536 (splicing_solve_gene_paired)."""
    from miso_jax.core.matching import match_iso_paired, match_vector

    A = paired_assignment_matrix(gene, read_len, frag_prob, frag_start,
                                 overhang)
    match, _ = match_iso_paired(gene, positions, cigars, read_len,
                                overhang, frag_prob, frag_start)
    mvec = match_vector(match, A)
    expression = nnls(A.T, mvec)
    residuals = mvec - A.T @ expression
    if scale and expression.sum() > 0:
        expression = expression / expression.sum()
    return expression, residuals


def gene_complexity(gene: Gene, read_len: int,
                    overhang: int = 1) -> float:
    """Condition number (sigma_max / sigma_min) of the assignment matrix.
    Ref: pysplicing/src/complexity.c:5-71 (splicing_gene_complexity with
    COMPLEXITY_RELATIVE / ABSOLUTE via SVD)."""
    A = assignment_matrix(gene, read_len, overhang)
    return _condition_number(A)


def gene_complexity_paired(gene: Gene, read_len: int,
                           frag_prob: np.ndarray, frag_start: int,
                           overhang: int = 1) -> float:
    """Paired-end complexity (complexity.c:5-71 paired branch)."""
    A = paired_assignment_matrix(gene, read_len, frag_prob, frag_start,
                                 overhang)
    return _condition_number(A)


def _condition_number(A: np.ndarray) -> float:
    s = np.linalg.svd(A, compute_uv=False)
    smin = s[s > 0].min() if np.any(s > 0) else 0.0
    if smin == 0:
        return float("inf")
    return float(s.max() / smin)
