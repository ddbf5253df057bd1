"""Differential-splicing detection end-to-end: two simulated samples with
known delta-psi; Bayes factors must separate changed from unchanged
events (the scientific contract of compare_miso)."""
import os

import numpy as np
import pytest

FAST_SETTINGS = """\
[sampler]
burn_in = 150
lag = 5
num_iters = 900
num_chains = 2
"""


def test_bayes_factors_separate_changed_events(tmp_path):
    from miso_jax.cli.compare import main as compare_main
    from miso_jax.cli.index_gff import main as index_main
    from miso_jax.cli.main import main as miso_main
    from miso_jax.io.gff import write_gff
    from miso_jax.testing import make_se_catalog, simulate_catalog_bam

    rng = np.random.default_rng(21)
    genes, records, _ = make_se_catalog(12, rng)
    gff = str(tmp_path / "c.gff")
    write_gff(records, gff)
    idx = str(tmp_path / "idx")
    assert index_main(["--index", gff, idx]) == 0
    settings = tmp_path / "s.txt"
    settings.write_text(FAST_SETTINGS)

    # sample 1: psi = 0.8 everywhere; sample 2: first half drops to 0.2
    psi1 = np.full(12, 0.8)
    psi2 = np.where(np.arange(12) < 6, 0.2, 0.8)
    for label, psis in (("s1", psi1), ("s2", psi2)):
        bam = str(tmp_path / ("%s.bam" % label))
        simulate_catalog_bam(genes, psis, 500, 36, bam,
                             np.random.default_rng(hash(label) % 2**31))
        out = str(tmp_path / ("%s_out" % label))
        rc = miso_main(["--run", idx, bam, "--output-dir", out,
                        "--read-len", "36",
                        "--settings-filename", str(settings)])
        assert rc == 0

    cmp_dir = str(tmp_path / "cmp")
    rc = compare_main(["--compare-samples",
                       str(tmp_path / "s1_out"), str(tmp_path / "s2_out"),
                       cmp_dir])
    assert rc == 0
    bf_file = os.path.join(cmp_dir, "s1_out_vs_s2_out", "bayes-factors",
                           "s1_out_vs_s2_out.miso_bf")
    from miso_jax.cli.filter_events import read_bf_file
    _, rows = read_bf_file(bf_file)
    assert len(rows) == 12
    by_event = {r["event_name"]: r for r in rows}
    changed_bfs = [float(by_event["ev%d" % e]["bayes_factor"])
                   for e in range(6)]
    same_bfs = [float(by_event["ev%d" % e]["bayes_factor"])
                for e in range(6, 12)]
    changed_diffs = [float(by_event["ev%d" % e]["diff"]) for e in range(6)]
    same_diffs = [float(by_event["ev%d" % e]["diff"])
                  for e in range(6, 12)]
    # changed events: large positive delta, decisive Bayes factors
    assert all(d > 0.35 for d in changed_diffs), changed_diffs
    assert all(bf > 20 for bf in changed_bfs), changed_bfs
    # unchanged events: small delta.  NOTE: the Savage-Dickey BF itself
    # can be large for weakly-identified same-psi events (a realization
    # difference of ~0.1 puts near-zero KDE mass at delta=0) -- true of
    # the reference too, which is why filter_events combines BF with a
    # delta-psi threshold.
    assert all(abs(d) < 0.3 for d in same_diffs), same_diffs
    # and the filter CLI keeps exactly the changed ones
    from miso_jax.cli.filter_events import main as filter_main
    fdir = str(tmp_path / "filt")
    rc = filter_main(["--filter", bf_file, "--output-dir", fdir,
                      "--bayes-factor", "20", "--delta-psi", "0.3",
                      "--num-inc", "1", "--num-exc", "1"])
    assert rc == 0
    lines = open(os.path.join(
        fdir, "s1_out_vs_s2_out.miso_bf.filtered")).read().splitlines()
    kept = {l.split("\t")[0] for l in lines[1:]}
    assert kept == {"ev%d" % e for e in range(6)}, kept


def test_batch_comparison_matches_scalar_rows():
    """The chunked/batched comparison path (stacked-tensor KDE + order
    statistics) must produce byte-identical .miso_bf rows to the
    per-event scalar path (_comparison_fields) -- including multi-
    isoform events, null self-comparison, and degenerate posteriors."""
    import numpy as np

    from miso_jax.io.comparison import (_comparison_fields,
                                        _comparison_rows)
    from miso_jax.io.miso_file import MISOFileData

    rng = np.random.default_rng(9)

    def fake(nm, samples):
        samples = np.asarray(samples, np.float64)
        header = ("#isoforms=['a','b']\tcounts=(1,0):5\t"
                  "assigned_counts=0:3,1:2\tchrom=chr1\tstrand=+\t"
                  "mRNA_starts=1,1\tmRNA_ends=9,9")
        from miso_jax.io.miso_file import (
            get_counts_from_header, parse_sampler_params_from_header)
        return MISOFileData(
            samples=samples, header=header,
            log_scores=np.zeros(len(samples)),
            sampled_map=list(samples[0]), sampled_map_log_score=0.0,
            counts_info=get_counts_from_header(header),
            params=parse_sampler_params_from_header(header))

    names, s1s, s2s = [], [], []
    for e in range(40):  # 2-isoform events, various separations
        c1 = np.clip(rng.beta(8, 4, 200), 1e-4, 1 - 1e-4)
        shift = [0.0, 0.3, 0.003][e % 3]
        c2 = np.clip(rng.beta(8, 4, 200) - shift, 1e-4, 1 - 1e-4)
        names.append("e%d" % e)
        s1s.append(fake(names[-1], np.stack([c1, 1 - c1], axis=1)))
        s2s.append(fake(names[-1], np.stack([c2, 1 - c2], axis=1)))
    for e in range(12):  # 3-isoform events (csv branches)
        a = rng.dirichlet([4, 3, 2], 200)
        b = rng.dirichlet([2, 3, 4], 200)
        names.append("m%d" % e)
        s1s.append(fake(names[-1], a))
        s2s.append(fake(names[-1], b))
    # degenerate: identical samples (all_same -> BF 0.0)
    names.append("null")
    s1s.append(fake("null", s1s[0].samples))
    s2s.append(fake("null", s1s[0].samples))
    # shape mismatch falls back to scalar
    names.append("ragged")
    s1s.append(fake("ragged", s1s[0].samples[:150]))
    s2s.append(fake("ragged", s2s[0].samples))

    batch = _comparison_rows(names, s1s, s2s, 0.95)
    scalar = [_comparison_fields(nm, a, b, 0.95)
              for nm, a, b in zip(names, s1s, s2s)]
    assert len(batch) == len(scalar)
    for got, want in zip(batch, scalar):
        assert got == want, (got, want)
