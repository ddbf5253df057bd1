"""A REAL 2-process multi-host run on the CPU backend.

The reference's cluster layer is qsub scripts + job polling
(misopy/cluster_utils.py:160-300), testable only against a live
scheduler (misopy/test_cluster.py:8-95).  Here two `miso --run`
subprocesses form an actual `jax.distributed` runtime over localhost
(parallel/distributed.py:18-56), shard the gene catalog disjointly
(host_shard), and write one merged reference-layout output tree --
hermetic, no scheduler needed.
"""
import glob
import os
import re
import socket
import subprocess
import sys

import numpy as np
import pytest


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


N_EVENTS = 8
READ_LEN = 36


@pytest.fixture(scope="module")
def catalog(tmp_path_factory):
    from miso_jax.io.index import index_gff
    from miso_jax.io.sam import open_alignments
    from miso_jax.testing import build_catalog_fixture

    root = tmp_path_factory.mktemp("multihost")
    fix = build_catalog_fixture(str(root / "cat"), num_events=N_EVENTS,
                                reads_per_event=150, read_len=READ_LEN,
                                seed=3)
    idx = str(root / "index")
    index_gff(fix["gff"], idx)
    # pre-build the .bai so concurrent subprocesses never race on it
    bam = open_alignments(fix["bam"])
    list(bam.fetch(bam.references[0], 0, 1))
    settings = root / "fast.txt"
    settings.write_text("[sampler]\nburn_in = 100\nlag = 5\n"
                        "num_iters = 600\nnum_chains = 2\n")
    return {"root": root, "fix": fix, "idx": idx,
            "settings": str(settings)}


def _run_cli(args, env):
    return subprocess.Popen(
        [sys.executable, "-m", "miso_jax.cli.main"] + args,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)


def _cpu_env():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.setdefault("PYTHONPATH", os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return env


def test_two_process_run_merges_to_one_tree(catalog):
    """Two hosts, one catalog: disjoint shards, merged output, and the
    merged tree summarizes identically in layout to a single-host run."""
    fix = catalog["fix"]
    out = str(catalog["root"] / "out_multi")
    port = _free_port()
    env = _cpu_env()
    procs = []
    for hid in (0, 1):
        procs.append(_run_cli(
            ["--run", catalog["idx"], fix["bam"],
             "--output-dir", out, "--read-len", str(READ_LEN),
             "--settings-filename", catalog["settings"],
             "--coordinator", "127.0.0.1:%d" % port,
             "--num-hosts", "2", "--host-id", str(hid)], env))
    outputs = []
    try:
        for p in procs:
            o, _ = p.communicate(timeout=420)
            outputs.append(o)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert all(p.returncode == 0 for p in procs), "\n----\n".join(outputs)

    # each host formed the 2-process runtime and took a disjoint,
    # non-empty shard covering the whole catalog
    shards = [int(re.search(r"Host shard: (\d+) genes", o).group(1))
              for o in outputs]
    assert all(s > 0 for s in shards)
    assert sum(shards) == N_EVENTS

    files = glob.glob(os.path.join(out, "chr*", "*.miso"))
    assert len(files) == N_EVENTS  # merged tree: every gene exactly once

    # each host quantified ONLY its shard (its log mentions its count)
    for o, s in zip(outputs, shards):
        m = re.search(r"Quantified (\d+) events", o)
        assert m and int(m.group(1)) == s

    # the merged tree is a valid reference-layout sample dir: summarize
    # it and check posterior means against simulation truth
    from miso_jax.io.miso_file import summarize_sampler_results

    summ = str(catalog["root"] / "summ.miso_summary")
    n = summarize_sampler_results(out, summ)
    assert n == N_EVENTS
    means = {}
    with open(summ) as fh:
        next(fh)
        for line in fh:
            fields = line.split("\t")
            means[fields[0]] = float(fields[1])
    truth = {"ev%d" % e: fix["true_psi"][e] for e in range(N_EVENTS)}
    errs = [abs(means[g] - truth[g]) for g in truth]
    assert np.mean(errs) < 0.06, (means, truth)

    # each host wrote its OWN run summary (per-host filenames; a shared
    # file's read-merge-write would race); together they cover the
    # catalog exactly once
    sfiles = glob.glob(os.path.join(out, "summary",
                                    "*.host*.miso_summary"))
    assert len(sfiles) == 2, sfiles
    names = []
    for f in sfiles:
        with open(f) as fh:
            next(fh)
            names.extend(line.split("\t", 1)[0] for line in fh
                         if line.strip())
    assert sorted(names) == sorted("ev%d" % e for e in range(N_EVENTS))


def test_single_host_without_flags_is_unchanged(catalog):
    """No coordinator flags -> no distributed init, whole catalog on one
    host (regression guard for the flag plumbing)."""
    fix = catalog["fix"]
    out = str(catalog["root"] / "out_single")
    p = _run_cli(
        ["--run", catalog["idx"], fix["bam"],
         "--output-dir", out, "--read-len", str(READ_LEN),
         "--settings-filename", catalog["settings"]], _cpu_env())
    o, _ = p.communicate(timeout=420)
    assert p.returncode == 0, o
    assert "Host shard" not in o
    files = glob.glob(os.path.join(out, "chr*", "*.miso"))
    assert len(files) == N_EVENTS


def test_no_native_fallback_run(catalog):
    """The full CLI run works with the native library disabled
    (MISO_NO_NATIVE=1): pure-Python BGZF decode, matching, and pairing
    fallbacks produce the same set of outputs."""
    fix = catalog["fix"]
    out = str(catalog["root"] / "out_nonative")
    env = _cpu_env()
    env["MISO_NO_NATIVE"] = "1"
    p = _run_cli(
        ["--run", catalog["idx"], fix["bam"],
         "--output-dir", out, "--read-len", str(READ_LEN),
         "--settings-filename", catalog["settings"]], env)
    o, _ = p.communicate(timeout=420)
    assert p.returncode == 0, o
    files = glob.glob(os.path.join(out, "chr*", "*.miso"))
    assert len(files) == N_EVENTS

