"""Read <-> isoform compatibility: the host-side half of the sampler.

Builds the {0,1} match matrix (single-end) and the fragment-length-probability
match matrix (paired-end), then collapses reads into *compatibility classes*
so the device only ever sees (num_classes x num_isoforms) dense tensors.

Behavior parity:
- single-end matcher: pysplicing/src/solve.c:8-108 (splicing_matchIso)
- paired-end matcher: pysplicing/src/solve.c:141-218 (splicing_matchIso_paired)
- class collapse:     pysplicing/src/miso_paired.c:576-702
- match vector:       pysplicing/src/solve.c:110-137 (splicing_getMatchVector)

Unlike the reference (per-read C loops), matching is vectorized by first
deduplicating (position, cigar) pairs -- RNA-seq data has massive duplication
of alignment signatures within one gene -- and matching each unique signature
once.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np

from miso_jax.core.cigar import parse_cigar
from miso_jax.core.gene import Gene


@dataclass
class PackedCigars:
    """A read set's CIGAR strings as one NUL-terminated byte buffer plus
    per-read start offsets -- the zero-copy currency between the native
    BAM scanner and the native matcher (per-read Python strings never
    materialize on the columnar ingest path)."""

    buf: bytes
    offsets: np.ndarray  # (n,) int64

    def __len__(self) -> int:
        return len(self.offsets)

    def __getitem__(self, i) -> str:
        o = int(self.offsets[i])
        return self.buf[o:self.buf.index(b"\x00", o)].decode()

    def __iter__(self):
        for i in range(len(self.offsets)):
            yield self[i]


def match_iso(
    gene: Gene,
    positions: np.ndarray,
    cigars: Sequence[str],
    read_len: int,
    overhang: int = 1,
) -> np.ndarray:
    """{0,1} match matrix of shape (num_isoforms, num_reads).

    ``positions`` are 1-based genomic start coordinates.
    Ref: pysplicing/src/solve.c:8-108.  Dispatches to the native C++
    matcher (miso_jax.native) when available; this numpy implementation
    is the reference fallback.
    """
    if overhang == 0:
        overhang = 1
    if overhang < 1:
        raise ValueError("Overhang length invalid. Must be positive")
    if read_len < 0:
        raise ValueError("Read length cannot be negative")
    if len(positions) > 0:
        from miso_jax import native
        out = native.match_iso_native(gene, positions, cigars, read_len,
                                      overhang)
        if out is not None:
            return out
    if isinstance(cigars, PackedCigars):
        cigars = list(cigars)  # numpy fallback decodes per read
    positions = np.asarray(positions, dtype=np.int64)
    noiso = gene.num_isoforms
    noreads = len(positions)
    result = np.zeros((noiso, noreads), dtype=np.float64)

    # dedup unique (pos, cigar) signatures
    sig_index: dict = {}
    read_sig = np.empty(noreads, dtype=np.int64)
    sigs = []
    for r in range(noreads):
        key = (int(positions[r]), cigars[r])
        idx = sig_index.get(key)
        if idx is None:
            idx = len(sigs)
            sig_index[key] = idx
            sigs.append(key)
        read_sig[r] = idx

    sig_match = np.zeros((noiso, len(sigs)), dtype=np.float64)
    cigar_cache: dict = {}
    for s, (pos, cig) in enumerate(sigs):
        hit = cigar_cache.get(cig)
        if hit is None:
            hit = parse_cigar(cig, read_len)
            cigar_cache[cig] = hit
        runs, length = hit
        # read-length filter (solve.c:55) and overhang filter (solve.c:61)
        if length < read_len:
            continue
        if not runs or runs[0] < overhang or runs[-1] < overhang:
            continue
        for i in range(noiso):
            sig_match[i, s] = _match_one(gene, i, pos, runs)
    return sig_match[:, read_sig]


def _match_one(gene: Gene, iso: int, pos: int, runs: Tuple[int, ...]) -> float:
    """Walk one signed-run CIGAR against one isoform's exon chain.

    Ref: pysplicing/src/solve.c:63-95.
    """
    starts, ends = gene.iso_exons(iso)
    nex = len(starts)
    # find exon containing pos
    ex = int(np.searchsorted(starts, pos, side="right")) - 1
    if ex < 0 or pos > ends[ex]:
        return 0.0
    for c in runs:
        if c > 0:  # exon-consuming run
            if pos + c - 1 > ends[ex]:
                return 0.0
            pos += c
        else:  # intron skip
            if pos != ends[ex] + 1:
                return 0.0
            pos += -c
            ex += 1
            if ex >= nex or pos != starts[ex]:
                return 0.0
    return 1.0


def match_iso_paired(
    gene: Gene,
    positions: np.ndarray,
    cigars: Sequence[str],
    read_len: int,
    overhang: int,
    frag_prob: np.ndarray,
    frag_start: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """Paired-end match: mates are consecutive (2r, 2r+1) in the input.

    Returns (match, frag_len) of shapes (noiso, npairs):
    - match[i, r]: fragment-length probability if both mates match isoform i
      and the implied fragment length is within the distribution's support,
      else 0.
    - frag_len[i, r]: implied fragment length, -1 if invalid.

    Ref: pysplicing/src/solve.c:141-218.
    """
    positions = np.asarray(positions, dtype=np.int64)
    noiso = gene.num_isoforms
    il = len(frag_prob)
    single = match_iso(gene, positions, cigars, read_len, overhang)
    npairs = len(positions) // 2

    match = np.zeros((noiso, npairs), dtype=np.float64)
    frag_len = np.full((noiso, npairs), -1, dtype=np.int64)
    for i in range(noiso):
        iso_pos = gene.genomic_to_iso(i, positions)
        both = (single[i, 0::2] > 0) & (single[i, 1::2] > 0)
        frag = iso_pos[1::2] - iso_pos[0::2] + read_len
        ok = both & (frag >= frag_start) & (frag < il + frag_start)
        match[i, ok] = frag_prob[frag[ok] - frag_start]
        frag_len[i, ok] = frag[ok]
    return match, frag_len


# --------------------------------------------------------------------------
# Compatibility classes
# --------------------------------------------------------------------------

@dataclass
class ReadClasses:
    """Reads collapsed into compatibility classes.

    templates: (noiso, nclasses) match values (column patterns).
    counts:    (nclasses,) number of reads in each class.
    frag_len:  optional (noiso, nclasses) fragment lengths (paired-end),
               -1 where the class is incompatible with the isoform.
    """

    templates: np.ndarray
    counts: np.ndarray
    frag_len: Optional[np.ndarray] = None

    @property
    def num_classes(self) -> int:
        return self.templates.shape[1]

    @property
    def num_isoforms(self) -> int:
        return self.templates.shape[0]


def collapse_to_classes(
    match: np.ndarray, frag_len: Optional[np.ndarray] = None
) -> ReadClasses:
    """Group identical match-matrix columns into classes with counts.

    For paired-end data the class key includes the per-isoform fragment
    lengths, which subsumes the match values (match = fragProb[frag_len]) and
    keeps the per-read score term exact (miso_paired.c:157-163 indexes
    isoscores by the read's fragment length on its assigned isoform).

    Ref: pysplicing/src/miso_paired.c:576-619 (splicing_i_miso_classes1).
    """
    noiso, noreads = match.shape
    if noreads == 0:
        return ReadClasses(
            templates=np.zeros((noiso, 0)),
            counts=np.zeros((0,)),
            frag_len=None if frag_len is None else np.zeros((noiso, 0), np.int64),
        )
    if frag_len is None and noiso <= 62:
        mb = match > 0
        if not np.logical_or(match == 0.0, mb & (match == 1.0)).all():
            mb = None  # non-binary single-end weights: generic path
        if mb is not None:
            # bitmask class keys (isoform 0 most significant, so the
            # ascending 1-D unique matches the lexicographic order the
            # axis-unique below produces): ~4x faster than the 2-D
            # void-view sort inside np.unique(axis=0)
            pow2 = 1 << np.arange(noiso - 1, -1, -1, dtype=np.int64)
            _, first_idx, counts = np.unique(
                pow2 @ mb, return_index=True, return_counts=True)
            return ReadClasses(
                templates=match[:, first_idx],
                counts=counts.astype(np.float64), frag_len=None)
    key = match if frag_len is None else np.concatenate([match, frag_len], axis=0)
    _, first_idx, counts = np.unique(
        key.T, axis=0, return_index=True, return_counts=True
    )
    templates = match[:, first_idx]
    fl = None if frag_len is None else frag_len[:, first_idx]
    return ReadClasses(
        templates=templates,
        counts=counts.astype(np.float64),
        frag_len=fl,
    )


def match_classes(
    gene: Gene,
    positions: np.ndarray,
    cigars: Sequence[str],
    read_len: int,
    overhang: int = 1,
) -> Tuple[ReadClasses, bool]:
    """Single-end match + collapse in one step: (classes, any_compatible).

    Dispatches to the fused native kernel (match_classes_native) which
    skips the (I, R) match matrix entirely; identical classes/order to
    collapse_to_classes(match_iso(...)).
    """
    if overhang == 0:
        overhang = 1
    if overhang < 1:
        raise ValueError("Overhang length invalid. Must be positive")
    if read_len < 0:
        raise ValueError("Read length cannot be negative")
    if len(positions) > 0:
        from miso_jax import native
        hit = native.match_classes_native(gene, positions, cigars,
                                          read_len, overhang)
        if hit is not None:
            templates, counts = hit
            classes = ReadClasses(templates=templates, counts=counts)
            return classes, bool(templates.any())
    match = match_iso(gene, positions, cigars, read_len, overhang)
    return collapse_to_classes(match), bool((match > 0).any())


def match_vector_from_classes(
    classes: ReadClasses, assignment_matrix: np.ndarray
) -> np.ndarray:
    """match_vector computed from collapsed classes (each class counts
    `counts[c]` reads toward its first support-matching column).
    Ref: pysplicing/src/solve.c:110-137."""
    noiso, no_classes = assignment_matrix.shape
    out = np.zeros(no_classes, dtype=np.float64)
    read_support = classes.templates > 0          # (noiso, C)
    class_support = assignment_matrix > 0         # (noiso, no_classes)
    eq = (read_support.T[:, None, :]
          == class_support.T[None, :, :]).all(axis=2)
    hit = eq.argmax(axis=1)
    has = eq.any(axis=1)
    np.add.at(out, hit[has], classes.counts[has])
    return out


def match_vector(match: np.ndarray, assignment_matrix: np.ndarray) -> np.ndarray:
    """Count reads per assignment class by support-pattern matching.

    For each read, find the first assignment-matrix column whose support
    (zero/nonzero pattern) equals the read's match-column support, and count
    it there.  Reads matching no class are dropped.

    Ref: pysplicing/src/solve.c:110-137 (splicing_getMatchVector).
    """
    noiso, no_classes = assignment_matrix.shape
    out = np.zeros(no_classes, dtype=np.float64)
    read_support = (match > 0)  # (noiso, noreads)
    class_support = (assignment_matrix > 0)  # (noiso, no_classes)
    # compare all reads against all classes: (noreads, no_classes)
    eq = (read_support.T[:, None, :] == class_support.T[None, :, :]).all(axis=2)
    hit = eq.argmax(axis=1)
    has = eq.any(axis=1)
    np.add.at(out, hit[has], 1.0)
    return out
