"""filter_events: counts parsing, thresholds, and --votes replicate
voting (misopy/filter_events.py:27-82, 83-186)."""
import os

import pytest

from miso_jax.cli.filter_events import (CountThresholds, filter_events,
                                        get_counts, main, multi_filter)


def test_get_counts_two_isoform():
    assert get_counts("(0,0):278,(0,1):2513,(1,1):798") == (0, 2513, 798)
    assert get_counts("(1,0):5,(0,1):3") == (5, 3, 0)


def test_get_counts_rejects_multi_isoform_and_garbage():
    assert get_counts("(1,0,0):5,(0,1,0):3") is None
    assert get_counts("n/a") is None
    assert get_counts("") is None


def test_count_thresholds():
    t = CountThresholds(total=10, inc=1, exc=1, inc_plus_exc=5)
    assert t.passes((4, 3, 5))
    assert not t.passes((4, 0, 10))   # no exclusion reads
    assert not t.passes((2, 2, 3))    # total below 10


def _row(name, bf, dp, c1="(1,0):50,(0,1):50", c2="(1,0):50,(0,1):50"):
    return {"event_name": name, "bayes_factor": str(bf), "diff": str(dp),
            "sample1_counts": c1, "sample2_counts": c2}


def test_single_table_filter():
    rows = [_row("a", 100.0, 0.3), _row("b", 1.0, 0.3),
            _row("c", 100.0, 0.01)]
    out = filter_events(rows, 0, 0, 0, 0, 0.2, 10.0)
    assert [r["event_name"] for r in out] == ["a"]


def test_votes_requires_agreement_across_replicates():
    # event "good": passes everywhere, consistent direction
    # event "flip": strong BF but opposite directions across replicates
    # event "weak": passes in only one replicate
    reps = []
    for sign in (1, -1, 1):
        reps.append([
            _row("good", 50.0, 0.4),
            _row("flip", 50.0, sign * 0.4),
            _row("weak", 50.0 if sign > 0 else 1.0, 0.4),
        ])
    # make "weak" fail BF in replicates 2 and 3
    reps[1][2]["bayes_factor"] = "1.0"
    reps[2][2]["bayes_factor"] = "1.0"
    out = multi_filter(reps, 0, 0, 0, 0, 0.2, 10.0, votes=3)
    names = [{r["event_name"] for r in rows} for rows in out]
    assert all(n == {"good"} for n in names), names


def test_votes_two_of_three():
    reps = []
    for present in (True, True, False):
        rows = [_row("x", 50.0, 0.4)] if present else [_row("x", 1.0, 0.4)]
        reps.append(rows)
    out = multi_filter(reps, 0, 0, 0, 0, 0.2, 10.0, votes=2)
    assert [len(rows) for rows in out] == [1, 1, 0]
    out3 = multi_filter(reps, 0, 0, 0, 0, 0.2, 10.0, votes=3)
    assert [len(rows) for rows in out3] == [0, 0, 0]


def test_cli_votes_roundtrip(tmp_path):
    header = ("event_name\tbayes_factor\tdiff\tsample1_counts\t"
              "sample2_counts\n")
    paths = []
    for i, sign in enumerate((1, 1, -1)):
        p = tmp_path / ("rep%d.miso_bf" % i)
        lines = [header]
        lines.append("ev_ok\t99\t0.5\t(1,0):30,(0,1):30\t(1,0):30,(0,1):30\n")
        lines.append("ev_dir\t99\t%s\t(1,0):30,(0,1):30\t(1,0):30,(0,1):30\n"
                     % (sign * 0.5))
        p.write_text("".join(lines))
        paths.append(str(p))
    outdir = str(tmp_path / "out")
    rc = main(["--filter"] + paths + ["--output-dir", outdir,
               "--bayes-factor", "10", "--delta-psi", "0.2",
               "--votes", "3"])
    assert rc == 0
    for i in range(3):
        got = open(os.path.join(
            outdir, "rep%d.miso_bf.filtered" % i)).read().splitlines()
        assert len(got) == 2  # header + ev_ok only
        assert got[1].startswith("ev_ok\t")
