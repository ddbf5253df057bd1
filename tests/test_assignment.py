"""Assignment-matrix, NNLS deconvolution, and complexity tests."""
import numpy as np

from miso_jax.core.assignment import (assignment_matrix, gene_complexity,
                                      local_cigar, nnls,
                                      norm_assignment_matrix, solve_gene)
from miso_jax.core.gene import make_gene
from miso_jax.core.matching import match_iso
from miso_jax.core.simulate import simulate_reads


def two_iso_gene():
    return make_gene([100, 50, 100], [[1, 2, 3], [1, 3]])


def test_local_cigar_within_exon():
    g = two_iso_gene()
    starts, ends = g.iso_exons(0)
    assert local_cigar(starts, ends, 10, 20) == (20,)


def test_local_cigar_junction():
    g = two_iso_gene()
    starts, ends = g.iso_exons(1)  # exons 1-100, 151-250
    # read of 20 starting at 91: 10 in exon1, skip 50, 10 in exon3
    assert local_cigar(starts, ends, 91, 20) == (10, -50, 10)


def test_local_cigar_incompatible():
    g = two_iso_gene()
    starts, ends = g.iso_exons(1)
    assert local_cigar(starts, ends, 120, 20) is None  # intron of iso1


def test_assignment_matrix_weights_cover_positions():
    g = two_iso_gene()
    rl = 20
    A = assignment_matrix(g, rl)
    # total weight per isoform row = number of valid start positions
    # = effective length (isolen - rl + 1)
    per_iso = A.sum(axis=1)
    assert per_iso[0] == g.iso_length(0) - rl + 1
    assert per_iso[1] == g.iso_length(1) - rl + 1
    # every read class the matcher can produce corresponds to a column
    norm = norm_assignment_matrix(A)
    assert np.allclose(norm.sum(axis=1), 1.0)


def test_assignment_matrix_consistent_with_matcher():
    """Every genomic position's matcher support pattern must appear in the
    assignment matrix with the right multiplicity."""
    g = two_iso_gene()
    rl = 20
    A = assignment_matrix(g, rl)
    support_weight = {}
    for c in range(A.shape[1]):
        key = tuple((A[:, c] > 0).astype(int))
        support_weight[key] = support_weight.get(key, 0) + A[:, c].max()
    # brute-force: use per-isoform local cigars at every genomic position
    from miso_jax.core.assignment import local_cigar
    brute = {}
    lo, hi = g.genomic_span()
    for gpos in range(lo, hi - rl + 2):
        cigs = {}
        for i in range(g.num_isoforms):
            starts, ends = g.iso_exons(i)
            c = local_cigar(starts, ends, gpos, rl)
            if c is not None:
                cigs.setdefault(c, []).append(i)
        for c, members in cigs.items():
            key = tuple(1 if i in members else 0
                        for i in range(g.num_isoforms))
            brute[key] = brute.get(key, 0) + 1
    assert support_weight == brute, (support_weight, brute)


def test_nnls_recovers_expression():
    g = two_iso_gene()
    rng = np.random.default_rng(0)
    true_psi = np.array([0.7, 0.3])
    _, pos, cig = simulate_reads(g, true_psi, 20000, 20, rng)
    expr, resid = solve_gene(g, 20, 1, pos, cig)
    assert abs(expr[0] - 0.7) < 0.05, expr


def test_complexity_finite():
    g = two_iso_gene()
    c = gene_complexity(g, 20)
    assert np.isfinite(c) and c >= 1.0


def test_paired_assignment_and_solve():
    from miso_jax.core.assignment import (gene_complexity_paired,
                                          paired_assignment_matrix,
                                          solve_gene_paired)
    from miso_jax.core.fragments import normal_fragment
    from miso_jax.core.simulate import simulate_paired_reads

    g = make_gene([300, 100, 300], [[1, 2, 3], [1, 3]])
    frag_prob, frag_start = normal_fragment(150.0, 64.0, 3.0, 30)
    A = paired_assignment_matrix(g, 30, frag_prob, frag_start)
    assert A.shape[0] == 2 and A.shape[1] >= 2
    # per-isoform total weight ~ sum over valid (s, L) of p(L)
    # = sum_L p(L) * (isolen - L + 1)
    fp = frag_prob / frag_prob.sum()
    lens = np.arange(frag_start, frag_start + len(fp))
    for i in range(2):
        expected = (fp * np.maximum(g.iso_length(i) - lens + 1, 0)).sum()
        assert abs(A[i].sum() - expected) < 1e-6, (i, A[i].sum(), expected)

    rng = np.random.default_rng(0)
    _, pos, cig = simulate_paired_reads(g, [0.7, 0.3], 4000, 30,
                                        150.0, 64.0, num_sds=3.0, rng=rng)
    expr, _ = solve_gene_paired(g, 30, 1, pos, cig, frag_prob, frag_start)
    assert abs(expr[0] - 0.7) < 0.08, expr

    c = gene_complexity_paired(g, 30, frag_prob, frag_start)
    assert np.isfinite(c) and c >= 1.0


def test_paired_assignment_matrix_matches_brute_force():
    """Column-level equality of the vectorized paired assignment matrix
    against a naive Python enumeration of every (isoform, fragment
    length, start) generation event (assignment.c:381-611 semantics):
    signatures keyed by (pos1, cigar1, pos2, cigar2), per-isoform
    fragment-probability sums, support-pattern collapse."""
    from miso_jax.core.assignment import paired_assignment_matrix
    from miso_jax.core.fragments import normal_fragment

    g = make_gene([60, 25, 40, 50], [[1, 2, 3, 4], [1, 3, 4], [1, 4]])
    rl = 12
    frag_prob, frag_start = normal_fragment(40.0, 36.0, 3.0, rl)
    fp = np.asarray(frag_prob) / np.asarray(frag_prob).sum()

    sig_vals = {}
    for i in range(g.num_isoforms):
        starts, ends = g.iso_exons(i)
        L = g.iso_length(i)
        for fi, p in enumerate(fp):
            frag = frag_start + fi
            if frag < rl or frag > L:
                continue
            for s in range(1, L - frag + 2):
                g1 = int(g.iso_to_genomic(i, np.array([s]))[0])
                g2 = int(g.iso_to_genomic(
                    i, np.array([s + frag - rl]))[0])
                c1 = local_cigar(starts, ends, g1, rl)
                c2 = local_cigar(starts, ends, g2, rl)
                if c1 is None or c2 is None:
                    continue
                key = (g1, c1, g2, c2)
                row = sig_vals.setdefault(key,
                                          [0.0] * g.num_isoforms)
                row[i] += p
    collapsed = {}
    for vals in sig_vals.values():
        supp = tuple(1 if v > 0 else 0 for v in vals)
        acc = collapsed.setdefault(supp, [0.0] * g.num_isoforms)
        for i, v in enumerate(vals):
            acc[i] += v

    A = paired_assignment_matrix(g, rl, frag_prob, frag_start)
    ours = {}
    for c in range(A.shape[1]):
        supp = tuple((A[:, c] > 0).astype(int))
        acc = ours.setdefault(supp, [0.0] * g.num_isoforms)
        for i in range(g.num_isoforms):
            acc[i] += A[i, c]
    assert set(ours) == set(collapsed), (set(ours), set(collapsed))
    for supp in collapsed:
        np.testing.assert_allclose(ours[supp], collapsed[supp],
                                   atol=1e-9, err_msg=str(supp))
