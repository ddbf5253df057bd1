#!/usr/bin/env python3
"""Smoke run of miso_jax's main path on one NVIDIA GPU.

Drives the production entry points once at full size: `index_gff` ->
`miso --run` over a 10,000-event simulated single-end catalog (300
reads of 36 bp per event, seed 1) at the reference's stock sampler
settings (5,000 iterations x 6 chains, burn-in 500, lag 10), in both
output modes (.miso tree and --summary-only), plus a 2,000-event
paired-end catalog (2 x 40 bp, insert 250 +- 15) -> `summarize_miso` ->
`compare_miso`.  It checks the posterior means against the simulated
psi, the grid-exact posterior and the XLA sampler on the CPU, runs the
`gpu`-marked tests, and times the fused REASSIGN kernel against the XLA
scan on the same card.

    python chip_smoke.py           # one GPU
    python chip_smoke.py --four    # only the 4-GPU mesh path, compared
                                   # with a 1-GPU mesh in the same process

Any failed phase exits non-zero, and without a GPU the script exits
non-zero before printing a result.  The last line of standard output is
one JSON object:
    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}
"""
import argparse
import glob
import json
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, ".smoke")
SE_EVENTS, SE_READS, SE_LEN, SE_SEED = 10000, 300, 36, 1
PE_EVENTS, PE_PAIRS, PE_LEN, PE_SEED = 2000, 150, 40, 2
PE_MEAN, PE_SD = 250.0, 15.0
ORACLE_EVENTS, CPU_EVENTS, TOL = 64, 32, 0.02
GPU_TEST_FILES = ["tests/test_pallas.py"]


class SmokeError(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeError(msg)


T0 = time.perf_counter()


def say(*parts):
    print("[%6.1fs]" % (time.perf_counter() - T0), *parts, flush=True)


# ------------------------------------------------------------ device
def card_lines():
    """The card's name and power limit, from nvidia-smi (no JAX)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.SubprocessError) as e:
        raise SmokeError("nvidia-smi failed: %r" % e)
    check(out.returncode == 0 and out.stdout.strip(),
          "nvidia-smi failed: %s" % out.stderr.strip())
    return out.stdout.strip().splitlines()


def probe_device(env):
    """JAX's first device, in a child process that exits (and releases
    the card) before the next one starts."""
    code = ("import jax, json; d = jax.devices(); print(json.dumps("
            "{'platform': d[0].platform, 'kind': d[0].device_kind, "
            "'count': len(d)}))")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    check(out.returncode == 0,
          "JAX found no device:\n%s" % out.stderr[-3000:])
    return json.loads(out.stdout.strip().splitlines()[-1])


def run_gpu_tests(env):
    """The `gpu`-marked tests, in a child pytest process on the card."""
    xml = os.path.join(WORK, "gpu_tests.xml")
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "pytest", *GPU_TEST_FILES, "-m", "gpu", "-q",
         "-p", "no:cacheprovider", "--junitxml", xml],
        env=dict(env, MISO_TEST_GPU="1"), cwd=ROOT, capture_output=True,
        text=True, timeout=1200)
    say(out.stdout.strip()[-2000:])
    check(out.returncode == 0, "gpu tests failed:\n%s" % out.stderr[-3000:])
    import xml.etree.ElementTree as ET
    suite = ET.parse(xml).getroot()
    suite = suite if suite.tag == "testsuite" else suite.find("testsuite")
    n, skipped = int(suite.get("tests")), int(suite.get("skipped"))
    bad = int(suite.get("failures")) + int(suite.get("errors"))
    check(n > 0 and skipped == 0 and bad == 0,
          "gpu tests: %d run, %d skipped, %d failed" % (n, skipped, bad))
    say("gpu tests: %d passed in %.1fs" % (n, time.perf_counter() - t0))


# ------------------------------------------------------------- helpers
def cli(name, argv):
    """Run a console entry point (pyproject [project.scripts]) in-process."""
    import importlib
    module = {"miso": "main", "index_gff": "index_gff",
              "summarize_miso": "summarize",
              "compare_miso": "compare"}[name]
    rc = importlib.import_module("miso_jax.cli." + module).main(argv)
    check(rc in (0, None), "%s %s exited %r" % (name, " ".join(argv), rc))


def miso_run(index, bam, out, read_len, *extra):
    shutil.rmtree(out, ignore_errors=True)
    t0 = time.perf_counter()
    cli("miso", ["--run", index, bam, "--output-dir", out,
                 "--read-len", str(read_len), *extra])
    return time.perf_counter() - t0


def engine_run(se, out, backend="auto", summary_only=False, mesh="auto"):
    """The `miso --run` engine (pipeline.compute_all_genes_psi) at the
    stock settings with a chosen sampler and mesh, which the CLI leaves
    at 'auto'.  Returns (seconds, events written)."""
    from miso_jax.io.settings import Settings
    from miso_jax.pipeline import RunConfig, compute_all_genes_psi
    shutil.rmtree(out, ignore_errors=True)
    cfg = RunConfig.from_settings(Settings.load(None), SE_LEN,
                                  backend=backend, summary_only=summary_only)
    t0 = time.perf_counter()
    n = compute_all_genes_psi(se["index"], se["bam"], SE_LEN, out, cfg=cfg,
                              mesh=mesh, verbose=False)
    return time.perf_counter() - t0, n


def miso_files(out):
    return sorted(glob.glob(os.path.join(out, "*", "*.miso")))


def read_summary(path):
    """{event: posterior mean of isoform 1} from a .miso_summary."""
    import numpy as np
    means = {}
    with open(path) as f:
        f.readline()
        for line in f:
            fields = line.rstrip("\n").split("\t")
            means[fields[0]] = [float(v) for v in fields[1].split(",")]
    check(means, "empty summary %s" % path)
    return {k: np.array(v) for k, v in means.items()}


def run_summary(out):
    label = os.path.basename(os.path.normpath(out))
    return os.path.join(out, "summary", "%s.miso_summary" % label)


def truth_corr(means, truth):
    import numpy as np
    names = sorted(means)
    est = np.array([means[n][0] for n in names])
    tru = np.array([truth[int(n[2:])] for n in names])
    return float(np.corrcoef(est, tru)[0, 1])


def build_catalogs(paired=True):
    """Simulated catalogs (generated from their seeds) + index_gff."""
    n_se, n_pe = SE_EVENTS, PE_EVENTS if paired else 0
    from miso_jax.testing import (build_catalog_fixture,
                                  build_paired_catalog_fixture)
    t0 = time.perf_counter()
    se = build_catalog_fixture(os.path.join(WORK, "se"), num_events=n_se,
                               reads_per_event=SE_READS, read_len=SE_LEN,
                               seed=SE_SEED)
    se["index"] = os.path.join(WORK, "se", "index")
    cli("index_gff", ["--index", se["gff"], se["index"]])
    pe = None
    if n_pe:
        pe = build_paired_catalog_fixture(
            os.path.join(WORK, "pe"), num_events=n_pe,
            pairs_per_event=PE_PAIRS, read_len=PE_LEN,
            mean_frag_len=PE_MEAN, sd_frag_len=PE_SD, seed=PE_SEED)
        pe["index"] = os.path.join(WORK, "pe", "index")
        cli("index_gff", ["--index", pe["gff"], pe["index"]])
    say("set-up: catalogs (%d single-end, %d paired-end events) built and "
        "indexed in %.1fs" % (n_se, n_pe, time.perf_counter() - t0))
    return se, pe


def native_library():
    from miso_jax import native
    lib = native.load()
    check(lib is not None, "native host library unavailable: %s"
          % native.STATUS.get("error"))
    st = native.STATUS
    say("native library %s %s (%.1fs)" % (
        "built and loaded:" if st["built"] else "loaded:",
        os.path.relpath(st["path"], ROOT), st["seconds"]))


def peak_memory(dev):
    stats = dev.memory_stats() or {}
    return stats.get("peak_bytes_in_use")


# -------------------------------------------------------------- phases
def main_path(se, pe, dev):
    """miso --run in both output modes + paired-end, on the card."""
    import jax
    from miso_jax.sampler.mcmc import select_backend
    say("sampler backend (auto): %s"
        % select_backend("auto", jax.default_backend()))
    out = os.path.join(WORK, "out_kernel")
    dt = miso_run(se["index"], se["bam"], out, SE_LEN)
    n = len(miso_files(out))
    say("miso --run (.miso tree): %d events written in %.2fs, compile "
        "included (%.1f events/s)" % (n, dt, n / dt))
    check(n == SE_EVENTS, "expected %d .miso files, got %d"
          % (SE_EVENTS, n))
    say("peak device memory after the run: %s bytes" % peak_memory(dev))
    means = read_summary(run_summary(out))
    corr = truth_corr(means, se["true_psi"])
    say("posterior mean vs simulated psi: correlation %.4f over %d events"
        % (corr, len(means)))
    check(corr > 0.9, "correlation with the simulated psi %.4f <= 0.9"
          % corr)

    out_s = os.path.join(WORK, "out_summary")
    prof = os.path.join(WORK, "profile")
    dt = miso_run(se["index"], se["bam"], out_s, SE_LEN, "--summary-only",
                  "--profile", prof)
    ms = read_summary(run_summary(out_s))
    traces = glob.glob(os.path.join(prof, "**", "*.xplane.pb"),
                       recursive=True)
    say("miso --run --summary-only --profile: %d events summarized in "
        "%.2fs (%.1f events/s; profiler on); %d trace file(s), %d bytes"
        % (len(ms), dt, len(ms) / dt, len(traces),
           sum(os.path.getsize(t) for t in traces)))
    check(len(ms) == SE_EVENTS and not miso_files(out_s),
          "--summary-only wrote %d rows, %d .miso files"
          % (len(ms), len(miso_files(out_s))))
    check(traces, "--profile wrote no trace")
    # same draws; the summary-only mean comes from exact device tick
    # sums, the other from the fetched ticks, so a 2-decimal rounding
    # boundary may fall between them
    diff = max(abs(ms[k][0] - means[k][0]) for k in means)
    n_diff = sum(ms[k][0] != means[k][0] for k in means)
    say("--summary-only vs .miso-tree run: %d rows differ, max |mean "
        "diff| %.2e" % (n_diff, diff))
    check(diff <= 0.0100001 and n_diff <= SE_EVENTS // 1000,
          "the two output modes disagree")

    out_p = os.path.join(WORK, "out_paired")
    dt = miso_run(pe["index"], pe["bam"], out_p, PE_LEN,
                  "--paired-end", str(PE_MEAN), str(PE_SD))
    n = len(miso_files(out_p))
    mp = read_summary(run_summary(out_p))
    corr = truth_corr(mp, pe["true_psi"])
    say("miso --run --paired-end: %d events written in %.2fs, compile "
        "included; correlation with simulated psi %.4f" % (n, dt, corr))
    check(n == PE_EVENTS and corr > 0.9,
          "paired-end run: %d events, correlation %.4f" % (n, corr))
    return out, means


def summarize_and_compare(out_kernel, means, out_xla):
    """summarize_miso re-derives the run's summary from the .miso tree;
    compare_miso runs the two-sample test (kernel vs XLA outputs)."""
    import numpy as np
    summ = os.path.join(WORK, "summarized")
    t0 = time.perf_counter()
    cli("summarize_miso", ["--summarize-samples", out_kernel, summ])
    sm = read_summary(os.path.join(summ, "summary", "%s.miso_summary"
                                   % os.path.basename(out_kernel)))
    diff = max(float(np.abs(sm[k] - means[k]).max()) for k in means)
    say("summarize_miso: %d events in %.2fs; max |mean diff| vs the run's "
        "own summary %.2e" % (len(sm), time.perf_counter() - t0, diff))
    check(len(sm) == len(means) and diff == 0.0,
          "summarize_miso disagrees with the run's summary")
    cmp_dir = os.path.join(WORK, "compare")
    t0 = time.perf_counter()
    cli("compare_miso", ["--compare-samples", out_kernel, out_xla, cmp_dir])
    bf = glob.glob(os.path.join(cmp_dir, "*", "bayes-factors", "*.miso_bf"))
    check(len(bf) == 1, "compare_miso wrote %d .miso_bf files" % len(bf))
    with open(bf[0]) as f:
        header = f.readline().rstrip("\n").split("\t")
        rows = [line.rstrip("\n").split("\t") for line in f]
    col = header.index("diff")
    d = np.array([abs(float(r[col].split(",")[0])) for r in rows])
    say("compare_miso (kernel vs XLA outputs): %d events in %.2fs; "
        "|delta psi| median %.4f, 99th percentile %.4f"
        % (len(rows), time.perf_counter() - t0, np.median(d),
           np.percentile(d, 99)))
    check(len(rows) == len(means) and np.median(d) < TOL,
          "kernel and XLA posteriors disagree")


def oracle_checks():
    """Posterior means on the card against the grid-exact posterior (I=2
    and I=3 buckets) and against the XLA sampler on the CPU."""
    import jax
    import numpy as np
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from exact_posterior import (exact_posterior_mean_2iso,
                                 exact_posterior_mean_3iso)
    from miso_jax.core.events import pad_events
    from miso_jax.pipeline import RunConfig, run_events
    from miso_jax.sampler.mcmc import EventBatch, SamplerConfig, run_batch
    from miso_jax.sampler.pallas_kernel import run_batch_pallas
    from miso_jax.testing import sampler_events

    cfg = RunConfig(read_len=SE_LEN)
    for I, exact in ((2, exact_posterior_mean_2iso),
                     (3, exact_posterior_mean_3iso)):
        evs, _ = sampler_events(ORACLE_EVENTS, I, reads_per_event=SE_READS,
                                read_len=SE_LEN, seed=10 + I)
        t0 = time.perf_counter()
        res = run_events(evs, cfg, seed=0)
        dt = time.perf_counter() - t0
        got = np.array([r["samples"].mean(axis=0) for r in res])
        ref = np.array([np.atleast_1d(exact(ev)) for ev in evs])
        worst = float(np.abs(got[:, :ref.shape[1]] - ref).max())
        say("grid-exact oracle, I=%d: %d events through run_events in "
            "%.2fs, max |mean - exact| %.4f (limit %.2f)"
            % (I, len(evs), dt, worst, TOL))
        check(worst <= TOL, "I=%d posterior off the exact oracle" % I)

    evs, _ = sampler_events(CPU_EVENTS, 2, reads_per_event=SE_READS,
                            read_len=SE_LEN, seed=21)
    batch = EventBatch(**{k: np.asarray(v) for k, v in
                          pad_events(evs, pad_iso=2).items()})
    scfg = SamplerConfig()
    key = jax.random.PRNGKey(0)

    def means(res):
        return np.asarray(res.psi_samples).mean(axis=(1, 2))[:, 0]

    kern = means(run_batch_pallas(key, batch, scfg))
    xla_gpu = means(run_batch(key, batch, scfg))
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        xla_cpu = means(run_batch(key, jax.device_put(batch, cpu), scfg))
    d_k = float(np.abs(kern - xla_cpu).max())
    d_x = float(np.abs(xla_gpu - xla_cpu).max())
    say("vs the XLA sampler on the CPU (same keys, %d events): kernel max "
        "|mean diff| %.4f, XLA-on-GPU max |mean diff| %.2e (limit %.2f)"
        % (CPU_EVENTS, d_k, d_x, TOL))
    check(d_k <= TOL and d_x <= TOL, "GPU and CPU samplers disagree")

    def dots(fn, *a):
        txt = str(jax.make_jaxpr(fn)(*a))
        return [p for p in ("dot_general", "conv_general") if p in txt]

    found = (dots(lambda k, b: run_batch(k, b, scfg), key, batch)
             + dots(lambda k, b: run_batch_pallas(k, b, scfg), key, batch))
    say("matrix products on the device path: %s"
        % (", ".join(found) or "none (no f32 dot/conv, so no TF32)"))
    check(not found, "a dot lies on the sampler path: pin its precision")


def kernel_vs_xla(se):
    """The fused kernel and the XLA scan on the same card, in turns."""
    import jax
    import numpy as np
    from miso_jax.sampler.mcmc import SamplerConfig, run_batch
    from miso_jax.sampler.pallas_kernel import run_batch_pallas
    from miso_jax.testing import sampler_batch

    cfg = SamplerConfig()
    key = jax.random.PRNGKey(0)

    def timed(fn):
        jax.block_until_ready(fn())
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        return time.perf_counter() - t0

    for I in (2, 3):
        batch = jax.device_put(sampler_batch(2048, I, 224))
        fns = {"xla": lambda: run_batch(key, batch, cfg).psi_samples,
               "kernel": lambda: run_batch_pallas(key, batch, cfg
                                                  ).psi_samples}
        t = {"xla": [], "kernel": []}
        for name in ("xla", "kernel", "kernel", "xla"):
            t[name].append(timed(fns[name]))
        say("sampler E=2048 K=6 I=%d R=224, 5000 iterations: XLA scan %s s,"
            " kernel %s s" % (I, t["xla"], t["kernel"]))

    big = sampler_batch(4096, 2, 224)
    for name, fn in (("XLA scan", run_batch), ("kernel", run_batch_pallas)):
        t0 = time.perf_counter()
        comp = fn.lower(key, big, cfg).compile()
        mem = comp.memory_analysis()
        say("compile at max_batch_events=4096 (I=2, R=224), %s: %.2fs; "
            "temp %s bytes, output %s bytes" % (
                name, time.perf_counter() - t0,
                getattr(mem, "temp_size_in_bytes", None),
                getattr(mem, "output_size_in_bytes", None)))

    out_x = os.path.join(WORK, "out_xla")
    dt, n = engine_run(se, out_x, backend="xla")
    say("miso --run engine, XLA scan forced (cold, compile included): "
        "%d events in %.2fs" % (n, dt))
    check(n == SE_EVENTS, "XLA run wrote %d events" % n)
    out = os.path.join(WORK, "out_timed")
    for summary_only in (False, True):
        t = {"xla": [], "pallas": []}
        for name in ("xla", "pallas", "pallas", "xla"):
            dt, n = engine_run(se, out, backend=name,
                               summary_only=summary_only)
            check(n == SE_EVENTS, "timed run wrote %d events" % n)
            t[name].append(dt)
        say("miso --run engine, 10k catalog, %s, warm: XLA scan %s s, "
            "kernel %s s; kernel/XLA %.3f" % (
                "--summary-only" if summary_only else ".miso tree",
                t["xla"], t["pallas"],
                float(np.mean(t["pallas"]) / np.mean(t["xla"]))))
    shutil.rmtree(out)
    return out_x


def four_cards(devices):
    """miso --run over a 4-GPU mesh and over a 1-GPU mesh, same process:
    the .miso and .miso_summary outputs must be identical (the event
    axis carries no collectives, and every lane's draws are keyed by its
    global index)."""
    import filecmp
    from miso_jax.io.settings import Settings
    from miso_jax.parallel.mesh import make_event_mesh
    from miso_jax.pipeline import RunConfig, compute_all_genes_psi

    se, _ = build_catalogs(paired=False)
    cfg = RunConfig.from_settings(Settings.load(None), SE_LEN)
    outs = {}
    for label, mesh in (("4-GPU", make_event_mesh(devices)),
                        ("1-GPU", make_event_mesh(devices[:1]))):
        for rep in ("cold", "warm"):
            out = os.path.join(WORK, "out_%s_%s" % (label, rep))
            shutil.rmtree(out, ignore_errors=True)
            t0 = time.perf_counter()
            n = compute_all_genes_psi(se["index"], se["bam"], SE_LEN, out,
                                      cfg=cfg, mesh=mesh, verbose=False)
            say("miso --run over a %s mesh (%s): %d events in %.2fs"
                % (label, rep, n, time.perf_counter() - t0))
            check(n == SE_EVENTS, "%s run wrote %d events" % (label, n))
            outs[label, rep] = out
    for rep in ("cold", "warm"):
        a, b = outs["4-GPU", rep], outs["1-GPU", rep]
        names = [os.path.relpath(p, a) for p in miso_files(a)]
        check(names == [os.path.relpath(p, b) for p in miso_files(b)],
              "the two meshes wrote different event sets")
        _, mismatch, errors = filecmp.cmpfiles(a, b, names, shallow=False)
        with open(run_summary(a)) as fa, open(run_summary(b)) as fb:
            same_summary = fa.read() == fb.read()
        say("4-GPU vs 1-GPU mesh (%s): %d .miso files, %d differ; "
            ".miso_summary %s" % (rep, len(names), len(mismatch) + len(errors),
                                  "identical" if same_summary else "DIFFERS"))
        check(not mismatch and not errors and same_summary,
              "4-GPU and 1-GPU mesh outputs differ")


# ---------------------------------------------------------------- main
def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the 4-GPU mesh path and its 1-GPU "
                         "comparison")
    args = ap.parse_args(argv)
    want = 4 if args.four else 1
    try:
        check(os.path.isdir(os.path.join(ROOT, "miso_jax")),
              "run chip_smoke.py from a miso_jax checkout")
        for line in card_lines():
            print(line, flush=True)
        env = dict(os.environ)
        if not args.four:
            visible = env.get("CUDA_VISIBLE_DEVICES", "0")
            env["CUDA_VISIBLE_DEVICES"] = visible.split(",")[0]
        dev = probe_device(env)
        say("JAX device: platform %s, kind %s, count %d"
            % (dev["platform"], dev["kind"], dev["count"]))
        check(dev["platform"] == "gpu", "JAX found no GPU")
        check(dev["count"] == want, "expected %d GPU(s), JAX sees %d"
              % (want, dev["count"]))
        shutil.rmtree(WORK, ignore_errors=True)
        os.makedirs(WORK)
        if not args.four:
            run_gpu_tests(env)

        os.environ.update(env)
        sys.path.insert(0, ROOT)
        import jax
        from miso_jax.pipeline import enable_compilation_cache
        devices = jax.devices()
        check(devices[0].platform == "gpu" and len(devices) == want,
              "JAX devices: %s" % devices)
        enable_compilation_cache()
        native_library()
        if args.four:
            four_cards(devices)
        else:
            se, pe = build_catalogs()
            out_kernel, means = main_path(se, pe, devices[0])
            out_xla = kernel_vs_xla(se)
            summarize_and_compare(out_kernel, means, out_xla)
            oracle_checks()
        shutil.rmtree(WORK, ignore_errors=True)
        say("all phases passed")
    except SmokeError as e:
        print("chip_smoke FAILED: %s" % e, file=sys.stderr, flush=True)
        return 1
    d = devices[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devices)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
