import numpy as np
import pytest

from miso_jax.core.gene import make_gene
from miso_jax.core.matching import (collapse_to_classes, match_iso,
                                    match_iso_paired)
from miso_jax.core.fragments import normal_fragment
from miso_jax.core.simulate import simulate_reads


def two_iso_gene():
    # exons of 100, 50, 100; iso0 = 1-2-3 (incl), iso1 = 1-3 (skip)
    return make_gene([100, 50, 100], [[1, 2, 3], [1, 3]])


def test_match_body_read():
    g = two_iso_gene()
    # read entirely inside exon 1: compatible with both
    m = match_iso(g, np.array([10]), ["20M"], read_len=20)
    assert m[:, 0].tolist() == [1.0, 1.0]


def test_match_middle_exon():
    g = two_iso_gene()
    # read inside exon 2 (positions 101-150): only iso0
    m = match_iso(g, np.array([110]), ["20M"], read_len=20)
    assert m[:, 0].tolist() == [1.0, 0.0]


def test_match_contiguous_run_never_crosses_exon_boundary():
    g = two_iso_gene()
    # Reference quirk (solve.c:78-82): a contiguous M run may not overrun
    # the exon it starts in, even when the isoform's next exon is adjacent;
    # crossing requires an explicit run boundary (a 0N works).
    m = match_iso(g, np.array([95]), ["20M"], read_len=20)
    assert m[:, 0].tolist() == [0.0, 0.0]
    m = match_iso(g, np.array([95]), ["6M0N14M"], read_len=20)
    assert m[:, 0].tolist() == [1.0, 0.0]


def test_match_junction_skip():
    g = two_iso_gene()
    # spliced read: 10 in exon1 (91-100), skip 50, 10 in exon3 (151-160)
    m = match_iso(g, np.array([91]), ["10M50N10M"], read_len=20)
    assert m[:, 0].tolist() == [0.0, 1.0]


def test_overhang_filter():
    g = two_iso_gene()
    m = match_iso(g, np.array([99]), ["2M50N18M"], read_len=20, overhang=4)
    assert m[:, 0].tolist() == [0.0, 0.0]


def test_short_read_filtered():
    g = two_iso_gene()
    m = match_iso(g, np.array([10]), ["15M"], read_len=20)
    assert m[:, 0].tolist() == [0.0, 0.0]


def test_intron_read_incompatible():
    g = make_gene([100, 50, 100], [[1, 2, 3], [1, 3]])
    # iso1's intron is 101-150. A read there only fits iso0.
    m = match_iso(g, np.array([120]), ["20M"], read_len=20)
    assert m[:, 0].tolist() == [1.0, 0.0]


def test_simulated_reads_always_match_their_isoform():
    g = two_iso_gene()
    rng = np.random.default_rng(0)
    iso, pos, cig = simulate_reads(g, [0.5, 0.5], 500, 25, rng)
    m = match_iso(g, pos, cig, read_len=25)
    for r in range(500):
        assert m[iso[r], r] == 1.0, (r, iso[r], pos[r], cig[r])


def test_collapse_classes():
    g = two_iso_gene()
    rng = np.random.default_rng(1)
    iso, pos, cig = simulate_reads(g, [0.7, 0.3], 1000, 25, rng)
    m = match_iso(g, pos, cig, read_len=25)
    classes = collapse_to_classes(m)
    assert classes.counts.sum() == 1000
    # 2-iso SE event has at most 4 patterns: (0,0),(0,1),(1,0),(1,1)
    assert classes.num_classes <= 4
    # reconstruct: total reads matching each isoform
    per_iso = (classes.templates * classes.counts[None, :]).sum(axis=1)
    assert np.allclose(per_iso, (m > 0).sum(axis=1))


def test_paired_fragment_lengths():
    g = make_gene([500, 100, 500], [[1, 2, 3], [1, 3]])
    frag_prob, frag_start = normal_fragment(200.0, 100.0, 4.0, 30)
    frag_prob /= frag_prob.sum()
    # pair on iso1 (skipping): mate1 at end of exon1, mate2 at start of exon3
    pos = np.array([441, 601])  # mate1: 441-470 in exon1; mate2 in exon3
    cig = ["30M", "30M"]
    match, fl = match_iso_paired(g, pos, cig, 30, 1, frag_prob, frag_start)
    # iso0 (inclusion): iso coords mate1=441, mate2=601 -> frag = 601-441+30
    assert fl[0, 0] == 190
    # iso1 (skip): exon3 starts at genomic 601 = iso coord 501
    # -> frag = 501-441+30 = 90, below the distribution support -> invalid
    assert match[0, 0] == frag_prob[190 - frag_start]
    if 90 >= frag_start:
        assert fl[1, 0] == 90
    else:
        assert fl[1, 0] == -1 and match[1, 0] == 0.0


def test_native_matcher_equals_python():
    """The C++ matcher (miso_jax/native/matchlib.cpp) must agree exactly
    with the numpy reference implementation."""
    from miso_jax import native
    g = make_gene([300, 150, 300, 100], [[1, 2, 3, 4], [1, 3, 4], [1, 4]])
    rng = np.random.default_rng(9)
    _, pos, cig = simulate_reads(g, [0.5, 0.3, 0.2], 5000, 30, rng)
    m_native = native.match_iso_native(g, pos, cig, 30, 1)
    if m_native is None:
        import pytest
        pytest.skip("native matcher unavailable (no C++ toolchain)")
    real = native.match_iso_native
    try:
        native.match_iso_native = lambda *a, **k: None
        m_py = match_iso(g, pos, cig, read_len=30)
    finally:
        native.match_iso_native = real
    assert np.array_equal(m_native, m_py)


def test_fused_match_classes_random_genes_vs_numpy():
    """Property check: the fused native match+collapse equals the numpy
    oracle (match_iso + collapse_to_classes) on randomized gene
    structures and reads -- classes, counts, order, any_compatible."""
    import os

    import miso_jax.native as nat
    from miso_jax.core.matching import (collapse_to_classes, match_classes,
                                        match_iso)
    from miso_jax.core.simulate import simulate_reads

    if nat.load() is None:
        pytest.skip("native library unavailable")
    rng = np.random.default_rng(17)
    for trial in range(10):
        ni = int(rng.integers(2, 7))
        nparts = int(rng.integers(ni, ni + 3))
        lens = rng.integers(30, 200, nparts).tolist()
        isoforms = []
        for _ in range(ni):
            k = int(rng.integers(1, nparts + 1))
            isoforms.append(sorted(rng.choice(
                np.arange(1, nparts + 1), size=k, replace=False).tolist()))
        g = make_gene(lens, isoforms)
        psi = rng.dirichlet(np.ones(ni))
        _, pos, cig = simulate_reads(g, psi, 200, 25, rng)
        pos = np.asarray(pos)
        cls, anyc = match_classes(g, pos, cig, 25, 1)
        os.environ["MISO_NO_NATIVE"] = "1"
        nat._LIB = None
        nat._TRIED = False
        try:
            m = match_iso(g, pos, cig, 25, 1)
        finally:
            del os.environ["MISO_NO_NATIVE"]
            nat._LIB = None
            nat._TRIED = False
        ref = collapse_to_classes(m)
        np.testing.assert_array_equal(cls.templates, ref.templates,
                                      err_msg="trial %d" % trial)
        np.testing.assert_array_equal(cls.counts, ref.counts)
        assert anyc == bool((m > 0).any())
