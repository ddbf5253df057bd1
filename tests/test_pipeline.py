"""End-to-end pipeline test on the reference's checked-in real-data fixture
(mouse C2C12 reads over Atp2b1), driving the actual CLIs:

    index_gff -> sam_to_bam -> miso --run -> summarize_miso -> compare_miso

Mirrors the reference's own integration test (misopy/test_miso.py:9-178)
with numeric checks added.
"""
import os

import numpy as np
import pytest

REF_GFF = "/root/reference/misopy/gff-events/mm9/genes/Atp2b1.mm9.gff"
REF_SAM = "/root/reference/misopy/test-data/sam-data/c2c12.Atp2b1.sam"

pytestmark = pytest.mark.skipif(
    not (os.path.isfile(REF_GFF) and os.path.isfile(REF_SAM)),
    reason="reference fixtures not mounted")

FAST_SETTINGS = """\
[data]
filter_results = True
min_event_reads = 20

[sampler]
burn_in = 100
lag = 5
num_iters = 600
num_chains = 2
"""


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    return tmp_path_factory.mktemp("pipeline")


@pytest.fixture(scope="module")
def settings_file(workdir):
    p = workdir / "settings.txt"
    p.write_text(FAST_SETTINGS)
    return str(p)


@pytest.fixture(scope="module")
def index_dir(workdir):
    from miso_jax.cli.index_gff import main as index_main
    out = str(workdir / "index")
    assert index_main(["--index", REF_GFF, out]) == 0
    return out


@pytest.fixture(scope="module")
def bam_file(workdir):
    from miso_jax.io.sam import sam_to_bam
    out = str(workdir / "reads.bam")
    sam_to_bam(REF_SAM, out)
    return out


def test_index_layout(index_dir):
    assert os.path.isdir(os.path.join(index_dir, "chr10"))
    assert os.path.isfile(os.path.join(index_dir, "genes.gff"))
    files = os.listdir(os.path.join(index_dir, "chr10"))
    assert any(f.endswith(".pickle") for f in files)


def test_bam_roundtrip(bam_file):
    from miso_jax.io.sam import BamReader, read_sam_text
    sam_reads = [r for r in read_sam_text(REF_SAM)]
    bam_reads = list(BamReader(bam_file))
    assert len(bam_reads) == len(sam_reads)
    by_pos = sorted(sam_reads, key=lambda r: r.pos)
    for got, want in zip(bam_reads[:50], by_pos[:50]):
        assert got.pos == want.pos
        assert got.cigar_str == want.cigar_str
        assert got.flag == want.flag


@pytest.fixture(scope="module")
def run_output(workdir, index_dir, bam_file, settings_file):
    from miso_jax.cli.main import main as miso_main
    out = str(workdir / "output")
    rc = miso_main(["--run", index_dir, bam_file,
                    "--output-dir", out, "--read-len", "36",
                    "--settings-filename", settings_file])
    assert rc == 0
    return out


def test_run_produces_miso_file(run_output):
    from miso_jax.io.miso_file import load_miso_file
    chrom_dir = os.path.join(run_output, "10")
    assert os.path.isdir(chrom_dir), os.listdir(run_output)
    miso_files = [f for f in os.listdir(chrom_dir) if f.endswith(".miso")]
    assert len(miso_files) == 1
    data = load_miso_file(os.path.join(chrom_dir, miso_files[0]))
    assert data is not None
    # 2 isoforms; psi in (0,1); header parity fields
    assert data.samples.shape[1] == 2
    assert np.all(data.samples >= 0) and np.all(data.samples <= 1)
    assert np.allclose(data.samples.sum(axis=1), 1.0, atol=2e-4)
    for key in ["isoforms", "exon_lens", "iters", "burn_in", "lag",
                "percent_accept", "proposal_type", "counts",
                "assigned_counts", "chrom", "strand", "mRNA_starts",
                "mRNA_ends"]:
        assert key in data.params, key
    assert data.params["chrom"] == "10"
    assert data.params["strand"] == "+"
    # sampler metadata matches settings
    assert data.params["iters"] == "600"


def test_rerun_is_idempotent(run_output, index_dir, bam_file, settings_file,
                             capsys):
    from miso_jax.cli.main import main as miso_main
    rc = miso_main(["--run", index_dir, bam_file,
                    "--output-dir", run_output, "--read-len", "36",
                    "--settings-filename", settings_file])
    assert rc == 0
    assert "exists, not running" in capsys.readouterr().out


def test_summarize(workdir, run_output):
    from miso_jax.cli.summarize import main as summarize_main
    out = str(workdir / "summary_out")
    rc = summarize_main(["--summarize-samples", run_output, out])
    assert rc == 0
    summary = os.path.join(out, "summary", "output.miso_summary")
    assert os.path.isfile(summary)
    lines = open(summary).read().splitlines()
    assert lines[0].startswith("event_name\tmiso_posterior_mean\tci_low")
    assert len(lines) == 2
    fields = lines[1].split("\t")
    mean = float(fields[1])
    ci_low, ci_high = float(fields[2]), float(fields[3])
    assert 0 <= ci_low <= mean <= ci_high <= 1


def test_compare(workdir, run_output):
    from miso_jax.cli.compare import main as compare_main
    out = str(workdir / "comparison_out")
    rc = compare_main(["--compare-samples", run_output, run_output, out])
    assert rc == 0
    bf_file = os.path.join(out, "output_vs_output", "bayes-factors",
                           "output_vs_output.miso_bf")
    assert os.path.isfile(bf_file)
    lines = open(bf_file).read().splitlines()
    assert len(lines) == 2
    fields = dict(zip(lines[0].split("\t"), lines[1].split("\t")))
    # same sample vs itself: delta ~ 0, BF ~ 0 (posterior peaked at null)
    assert abs(float(fields["diff"])) < 0.02
    assert float(fields["bayes_factor"]) < 1.0


def test_filter_events(workdir):
    from miso_jax.cli.filter_events import main as filter_main
    bf_file = os.path.join(str(workdir), "comparison_out",
                           "output_vs_output", "bayes-factors",
                           "output_vs_output.miso_bf")
    out = str(workdir / "filtered")
    rc = filter_main(["--filter", bf_file, "--output-dir", out,
                      "--bayes-factor", "10"])
    assert rc == 0
    filtered = os.path.join(out, "output_vs_output.miso_bf.filtered")
    lines = open(filtered).read().splitlines()
    assert len(lines) == 1  # header only: same-vs-same has BF ~ 0


def test_pack_and_db_read(workdir, run_output):
    import shutil
    from miso_jax.cli.pack import pack_dir
    from miso_jax.io.miso_file import MISOSamples
    packed = str(workdir / "packed_output")
    shutil.copytree(run_output, packed)
    names_before = MISOSamples(run_output).all_event_names
    assert pack_dir(packed) == 1
    assert not os.path.isdir(os.path.join(packed, "10"))
    assert os.path.isfile(os.path.join(packed, "10.miso_db"))
    obj = MISOSamples(packed)
    assert sorted(obj.all_event_names) == sorted(names_before)
    data = obj.get_event_samples(names_before[0])
    assert data is not None and data.samples.shape[1] == 2
    # miso_pack --view lists the database's event names
    # (misopy/miso_pack.py:102-112)
    from miso_jax.cli.pack import main as pack_main
    out = capsys_run(pack_main,
                     ["--view", os.path.join(packed, "10.miso_db")])
    assert "Database contains %d events" % len(names_before) in out
    for name in names_before:
        assert name in out


def capsys_run(fn, argv):
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert fn(argv) == 0
    return buf.getvalue()


def test_catalog_end_to_end(tmp_path):
    """Many-event catalog: simulate -> index -> run -> summarize; posterior
    means must track the simulation truth (correlation check, the
    reference's own oracle in tools/extra-tests/miso-multiple.R)."""
    from miso_jax.cli.index_gff import main as index_main
    from miso_jax.cli.main import main as miso_main
    from miso_jax.testing import build_catalog_fixture

    fix = build_catalog_fixture(str(tmp_path / "fix"), num_events=25,
                                reads_per_event=400, seed=7)
    settings = tmp_path / "settings.txt"
    settings.write_text(FAST_SETTINGS)
    index_dir = str(tmp_path / "index")
    assert index_main(["--index", fix["gff"], index_dir]) == 0
    out_dir = str(tmp_path / "out")
    rc = miso_main(["--run", index_dir, fix["bam"], "--output-dir", out_dir,
                    "--read-len", str(fix["read_len"]),
                    "--settings-filename", str(settings)])
    assert rc == 0
    from miso_jax.io.miso_file import MISOSamples
    obj = MISOSamples(out_dir)
    assert obj.num_events == 25
    means = np.zeros(25)
    for e in range(25):
        data = obj.get_event_samples("ev%d" % e)
        assert data is not None
        means[e] = data.samples[:, 0].mean()
    truth = fix["true_psi"]
    corr = np.corrcoef(means, truth)[0, 1]
    assert corr > 0.9, (corr, list(zip(means, truth))[:5])
    # length-corrected estimates shouldn't be systematically biased
    assert abs(np.mean(means - truth)) < 0.06


def test_paired_end_cli(tmp_path):
    """Paired-end through the CLI surface: simulate mates -> SAM -> BAM ->
    miso --run --paired-end MEAN SD."""
    import numpy as np
    from miso_jax.cli.index_gff import main as index_main
    from miso_jax.cli.main import main as miso_main
    from miso_jax.cli.simulate import main as sim_main
    from miso_jax.io.gff import GFFRecord, write_gff
    from miso_jax.io.miso_file import MISOSamples
    from miso_jax.io.sam import sam_to_bam

    # one paired-end event gene
    recs = []
    gid = "pe_ev"
    exons = [(1, 600), (701, 800), (901, 1500)]
    recs.append(GFFRecord("chrP", "sim", "gene", 1, 1500, None, "+", None,
                          {"ID": [gid]}))
    for iso, keep in (("A", (0, 1, 2)), ("B", (0, 2))):
        iid = "%s.%s" % (gid, iso)
        recs.append(GFFRecord("chrP", "sim", "mRNA", 1, 1500, None, "+",
                              None, {"ID": [iid], "Parent": [gid]}))
        for k in keep:
            s, e = exons[k]
            recs.append(GFFRecord("chrP", "sim", "exon", s, e, None, "+",
                                  None, {"ID": ["%s.e%d" % (iid, k)],
                                         "Parent": [iid]}))
    gff = str(tmp_path / "pe.gff")
    write_gff(recs, gff)
    sam = str(tmp_path / "pe.sam")
    rc = sim_main(["--gff", gff, "--psi", "0.65,0.35", "--num-reads",
                   "800", "--read-len", "30", "--paired-end", "250", "15",
                   "--output", sam, "--seed", "5"])
    assert rc == 0
    bam = str(tmp_path / "pe.bam")
    sam_to_bam(sam, bam)
    index_dir = str(tmp_path / "idx")
    assert index_main(["--index", gff, index_dir]) == 0
    settings = tmp_path / "s.txt"
    settings.write_text(FAST_SETTINGS)
    out = str(tmp_path / "out")
    rc = miso_main(["--run", index_dir, bam, "--output-dir", out,
                    "--read-len", "30", "--paired-end", "250", "15",
                    "--settings-filename", str(settings)])
    assert rc == 0
    obj = MISOSamples(out)
    data = obj.get_event_samples(gid)
    assert data is not None
    mean = float(data.samples[:, 0].mean())
    # paired-end events are strongly identified
    assert abs(mean - 0.65) < 0.12, mean


def test_multi_isoform_cli(tmp_path):
    """A 4-isoform gene through the CLI (multi-isoform quantitation,
    reference manual 'Advanced uses')."""
    import numpy as np
    from miso_jax.cli.index_gff import main as index_main
    from miso_jax.cli.main import main as miso_main
    from miso_jax.core.gene import make_gene
    from miso_jax.core.simulate import simulate_reads
    from miso_jax.io.gff import GFFRecord, write_gff
    from miso_jax.io.miso_file import MISOSamples
    from miso_jax.io.sam import AlignedRead, write_bam

    gid = "multi4"
    exon_lens = [120, 60, 80, 50, 120]
    isoforms = [[1, 2, 3, 4, 5], [1, 3, 4, 5], [1, 2, 4, 5], [1, 5]]
    g = make_gene(exon_lens, isoforms, chrom="chrM", label=gid)
    g.strand = "+"
    recs = [GFFRecord("chrM", "sim", "gene", *g.genomic_span(), None, "+",
                      None, {"ID": [gid]})]
    for k, iso in enumerate(g.isoforms):
        iid = "%s.i%d" % (gid, k)
        lo, hi = g.iso_genomic_span(k)
        recs.append(GFFRecord("chrM", "sim", "mRNA", lo, hi, None, "+",
                              None, {"ID": [iid], "Parent": [gid]}))
        for p in iso.parts:
            part = g.parts[p]
            recs.append(GFFRecord("chrM", "sim", "exon", part.start,
                                  part.end, None, "+", None,
                                  {"ID": ["%s.e%d" % (iid, p)],
                                   "Parent": [iid]}))
    gff = str(tmp_path / "m.gff")
    write_gff(recs, gff)
    true_psi = np.array([0.4, 0.3, 0.2, 0.1])
    rng = np.random.default_rng(17)
    _, pos, cig = simulate_reads(g, true_psi, 3000, 30, rng)
    reads = [AlignedRead("r%d" % i, 0, "chrM", int(pos[i]) - 1, 255,
                         cig[i], 30) for i in range(len(pos))]
    reads.sort(key=lambda r: r.pos)
    bam = str(tmp_path / "m.bam")
    write_bam(bam, ["chrM"], [10000], reads)
    idx = str(tmp_path / "idx")
    assert index_main(["--index", gff, idx]) == 0
    settings = tmp_path / "s.txt"
    settings.write_text(FAST_SETTINGS)
    out = str(tmp_path / "out")
    rc = miso_main(["--run", idx, bam, "--output-dir", out,
                    "--read-len", "30", "--settings-filename",
                    str(settings)])
    assert rc == 0
    data = MISOSamples(out).get_event_samples(gid)
    assert data is not None and data.samples.shape[1] == 4
    mean = data.samples.mean(axis=0)
    assert np.all(np.abs(mean - true_psi) < 0.15), (mean, true_psi)
    # summary formats multi-isoform means/CIs as comma lists
    from miso_jax.io.miso_file import summarize_sampler_results
    summ = str(tmp_path / "m.miso_summary")
    assert summarize_sampler_results(out, summ) == 1
    line = open(summ).read().splitlines()[1].split("\t")
    assert line[1].count(",") == 3  # 4 comma-separated means
    # the run-integrated DEVICE summary must be byte-identical on the
    # multi-isoform path too ((E, S, I) tick sums + per-column order
    # statistics; the 2-isoform path is covered by
    # test_run_integrated_summary)
    run_lines = open(os.path.join(
        out, "summary", "out.miso_summary")).read().splitlines()
    assert sorted(run_lines) == sorted(open(summ).read().splitlines())


def test_compress_id_roundtrip(tmp_path, index_dir, bam_file,
                               settings_file):
    """--compress-id indexing: outputs named by hash, summarize/compare
    map back with --use-compressed (index_gff.py:22-26, 80-118)."""
    from miso_jax.cli.index_gff import main as index_main
    from miso_jax.cli.main import main as miso_main
    from miso_jax.cli.summarize import main as summarize_main
    from miso_jax.io.gff import COMPRESS_PREFIX

    cidx = str(tmp_path / "cindex")
    assert index_main(["--index", REF_GFF, cidx, "--compress-id"]) == 0
    out = str(tmp_path / "cout")
    rc = miso_main(["--run", cidx, bam_file, "--output-dir", out,
                    "--read-len", "36",
                    "--settings-filename", settings_file])
    assert rc == 0
    miso_files = [f for f in os.listdir(os.path.join(out, "10"))
                  if f.endswith(".miso")]
    assert len(miso_files) == 1
    assert miso_files[0].startswith(COMPRESS_PREFIX)
    sdir = str(tmp_path / "csumm")
    rc = summarize_main(["--summarize-samples", out, sdir,
                         "--use-compressed",
                         os.path.join(cidx,
                                      "compressed_ids_to_genes.shelve")])
    assert rc == 0
    summary = os.path.join(sdir, "summary", "cout.miso_summary")
    lines = open(summary).read().splitlines()
    assert len(lines) == 2
    # event name mapped back to the uncompressed gene ID
    assert lines[1].startswith("ENSMUSG00000019943\t")


def test_linear_start_cli(workdir, index_dir, bam_file, settings_file):
    """--linear-start seeds chains from the NNLS deconvolution
    (MISO_START_LINEAR, miso.c:410-443) -- an API the reference exposes
    only through C; the run must produce a valid .miso."""
    import glob

    from miso_jax.cli.main import main as miso_main
    from miso_jax.io.miso_file import load_miso_file

    out = str(workdir / "linear_out")
    rc = miso_main(["--run", index_dir, bam_file,
                    "--output-dir", out, "--read-len", "36",
                    "--settings-filename", settings_file,
                    "--linear-start"])
    assert rc == 0
    files = glob.glob(out + "/*/*.miso")
    assert len(files) == 1
    data = load_miso_file(files[0])
    assert data.samples.shape[1] == 2
    assert np.all(data.samples >= 0) and np.all(data.samples <= 1)


def test_streaming_pipeline_deterministic(tmp_path):
    """Two identical compute_all_genes_psi runs produce byte-identical
    .miso trees: the streaming producer/dispatch/materializer threads
    must not perturb PRNG chunk keys or output content (chunk keys are
    a pure function of bucket shape + chunk offset)."""
    import filecmp

    from miso_jax.io.index import index_gff
    from miso_jax.pipeline import RunConfig, compute_all_genes_psi
    from miso_jax.testing import build_catalog_fixture

    fix = build_catalog_fixture(str(tmp_path / "cat"), num_events=120,
                                reads_per_event=80, read_len=36, seed=3)
    idx = str(tmp_path / "index")
    index_gff(fix["gff"], idx)
    cfg = RunConfig(read_len=36, iters=200, burn_in=50, lag=5, chains=2,
                    min_event_reads=20)
    outs = []
    for rep in range(2):
        out = str(tmp_path / ("out%d" % rep))
        n = compute_all_genes_psi(idx, fix["bam"], 36, out, cfg=cfg,
                                  verbose=False, seed=42)
        assert n == 120
        outs.append(out)
    files0 = sorted(os.path.join(dp, f)
                    for dp, _, fs in os.walk(outs[0]) for f in fs
                    if f.endswith(".miso"))
    assert len(files0) == 120
    for f0 in files0:
        f1 = f0.replace(outs[0], outs[1], 1)
        assert filecmp.cmp(f0, f1, shallow=False), f0

def test_run_integrated_summary(tmp_path):
    """The run writes .miso_summary straight from the device payload
    (no text round-trip); rows must be byte-identical to what
    summarize_miso produces by re-parsing the .miso tree.  And
    --summary-only yields the same summary with no .miso bodies at
    all (the readback is the per-event summary payload only)."""
    import glob as glob_mod

    from miso_jax.cli.index_gff import main as index_main
    from miso_jax.cli.main import main as miso_main
    from miso_jax.cli.summarize import main as summarize_main
    from miso_jax.testing import build_catalog_fixture

    fix = build_catalog_fixture(str(tmp_path / "fix"), num_events=30,
                                reads_per_event=200, seed=11)
    settings = tmp_path / "settings.txt"
    settings.write_text(FAST_SETTINGS)
    index_dir = str(tmp_path / "index")
    assert index_main(["--index", fix["gff"], index_dir]) == 0
    out_dir = str(tmp_path / "out")
    assert miso_main(["--run", index_dir, fix["bam"],
                      "--output-dir", out_dir,
                      "--read-len", str(fix["read_len"]),
                      "--settings-filename", str(settings)]) == 0
    run_summary = os.path.join(out_dir, "summary", "out.miso_summary")
    assert os.path.isfile(run_summary)
    # the text path over the same .miso tree (the reference's only way:
    # samples_utils.py:263-329)
    summ_dir = str(tmp_path / "textsumm")
    assert summarize_main(["--summarize-samples", out_dir,
                           summ_dir]) == 0
    text_summary = os.path.join(summ_dir, "summary", "out.miso_summary")
    with open(run_summary) as f:
        run_lines = sorted(f.read().splitlines())
    with open(text_summary) as f:
        text_lines = sorted(f.read().splitlines())
    assert len(run_lines) == 31  # header + 30 events
    assert run_lines == text_lines

    # --summary-only: same summary, no .miso bodies
    so_dir = str(tmp_path / "so")
    assert miso_main(["--run", index_dir, fix["bam"],
                      "--output-dir", so_dir,
                      "--read-len", str(fix["read_len"]),
                      "--settings-filename", str(settings),
                      "--summary-only"]) == 0
    so_summary = os.path.join(so_dir, "summary", "so.miso_summary")
    assert os.path.isfile(so_summary)
    assert glob_mod.glob(os.path.join(so_dir, "*", "*.miso")) == []
    with open(so_summary) as f:
        so_lines = sorted(f.read().splitlines())
    # same seed -> identical sampler ticks; CI fields are exact order
    # statistics (identical), the mean differs only by integer-sum vs
    # float64-mean arithmetic (<1e-12, so equal at %.2f except exact
    # rounding boundaries)
    assert len(so_lines) == len(run_lines)
    for a, b in zip(so_lines, run_lines):
        fa, fb = a.split("\t"), b.split("\t")
        assert fa[0] == fb[0]
        assert fa[2:] == fb[2:]
        if fa[0] != "event_name":
            assert abs(float(fa[1]) - float(fb[1])) <= 0.011


def test_pack_output_direct(tmp_path, capsys):
    """`miso --run --pack-output` streams events into per-chromosome
    .miso_db sqlite during the run: no .miso text tree, every event
    reads back through MISOSamples byte-identical to a text run with
    the same seed, and a resumed run skips the packed events."""
    import glob as glob_mod

    from miso_jax.cli.index_gff import main as index_main
    from miso_jax.cli.main import main as miso_main
    from miso_jax.io.miso_file import MISOSamples
    from miso_jax.testing import build_catalog_fixture

    fix = build_catalog_fixture(str(tmp_path / "fix"), num_events=20,
                                reads_per_event=150, seed=23)
    settings = tmp_path / "settings.txt"
    settings.write_text(FAST_SETTINGS)
    index_dir = str(tmp_path / "index")
    assert index_main(["--index", fix["gff"], index_dir]) == 0
    base = ["--run", index_dir, fix["bam"], "--read-len",
            str(fix["read_len"]), "--settings-filename", str(settings)]
    text_dir = str(tmp_path / "text_out")
    assert miso_main(base + ["--output-dir", text_dir]) == 0
    pack_dir = str(tmp_path / "pack_out")
    assert miso_main(base + ["--output-dir", pack_dir,
                             "--pack-output"]) == 0
    # no text tree; per-chromosome .miso_db files exist
    assert glob_mod.glob(os.path.join(pack_dir, "*", "*.miso")) == []
    assert glob_mod.glob(os.path.join(pack_dir, "*.miso_db"))
    text_obj = MISOSamples(text_dir)
    pack_obj = MISOSamples(pack_dir)
    assert sorted(pack_obj.all_event_names) == \
        sorted(text_obj.all_event_names)
    for nm in text_obj.all_event_names:
        a = text_obj.get_event_samples(nm)
        b = pack_obj.get_event_samples(nm)
        assert b is not None
        assert a.header == b.header
        np.testing.assert_array_equal(a.samples, b.samples)
        np.testing.assert_array_equal(a.log_scores, b.log_scores)
    # the run summaries agree too
    with open(os.path.join(text_dir, "summary",
                           "text_out.miso_summary")) as f:
        t = sorted(l.split("\t", 1)[1] for l in f.read().splitlines())
    with open(os.path.join(pack_dir, "summary",
                           "pack_out.miso_summary")) as f:
        p = sorted(l.split("\t", 1)[1] for l in f.read().splitlines())
    assert t == p
    # resume: all 20 packed events are skipped, none duplicated
    capsys.readouterr()
    assert miso_main(base + ["--output-dir", pack_dir,
                             "--pack-output"]) == 0
    assert "exists, not running" in capsys.readouterr().out
    pack_obj2 = MISOSamples(pack_dir)
    assert sorted(pack_obj2.all_event_names) == \
        sorted(text_obj.all_event_names)


def test_resumed_run_summary_is_complete(tmp_path):
    """A run resumed after an interruption must not write a silently
    partial .miso_summary: skip-done events' rows backfill from their
    stored samples when no prior summary exists."""
    from miso_jax.cli.index_gff import main as index_main
    from miso_jax.cli.main import main as miso_main
    from miso_jax.testing import build_catalog_fixture

    fix = build_catalog_fixture(str(tmp_path / "fix"), num_events=12,
                                reads_per_event=150, seed=31)
    settings = tmp_path / "settings.txt"
    settings.write_text(FAST_SETTINGS)
    index_dir = str(tmp_path / "index")
    assert index_main(["--index", fix["gff"], index_dir]) == 0
    out_dir = str(tmp_path / "out")
    base = ["--run", index_dir, fix["bam"], "--output-dir", out_dir,
            "--read-len", str(fix["read_len"]),
            "--settings-filename", str(settings)]
    assert miso_main(base) == 0
    summary = os.path.join(out_dir, "summary", "out.miso_summary")
    full = sorted(open(summary).read().splitlines())
    assert len(full) == 13
    # simulate an interrupted run: half the events done, NO summary
    import shutil
    import glob as glob_mod
    victims = sorted(glob_mod.glob(
        os.path.join(out_dir, "*", "*.miso")))[:6]
    assert len(victims) == 6
    for v in victims:
        os.remove(v)
    shutil.rmtree(os.path.dirname(summary))
    assert miso_main(base) == 0  # resumes: only 6 events re-run
    resumed = sorted(open(summary).read().splitlines())
    assert len(resumed) == 13  # backfilled, not partial
    # CI/count fields identical; means equal at output precision (the
    # re-run events resample under fresh chunk keys)
    assert [l.split("\t")[0] for l in resumed] == \
        [l.split("\t")[0] for l in full]


def test_pack_output_dotted_chrom(tmp_path):
    """--pack-output with scaffold-style chromosome names ('.'/'-' are
    illegal in bare SQL identifiers) must round-trip."""
    import numpy as np
    from miso_jax.cli.index_gff import main as index_main
    from miso_jax.cli.main import main as miso_main
    from miso_jax.core.gene import make_gene
    from miso_jax.core.simulate import simulate_reads
    from miso_jax.io.gff import GFFRecord, write_gff
    from miso_jax.io.miso_file import MISOSamples
    from miso_jax.io.sam import AlignedRead, write_bam

    chrom = "GL000225.1"
    g = make_gene([120, 60, 120], [[1, 2, 3], [1, 3]], chrom=chrom,
                  label="sc1")
    g.strand = "+"
    recs = [GFFRecord(chrom, "sim", "gene", *g.genomic_span(), None,
                      "+", None, {"ID": ["sc1"]})]
    for k, iso in enumerate(g.isoforms):
        iid = "sc1.i%d" % k
        lo, hi = g.iso_genomic_span(k)
        recs.append(GFFRecord(chrom, "sim", "mRNA", lo, hi, None, "+",
                              None, {"ID": [iid], "Parent": ["sc1"]}))
        for p in iso.parts:
            part = g.parts[p]
            recs.append(GFFRecord(chrom, "sim", "exon", part.start,
                                  part.end, None, "+", None,
                                  {"ID": ["%s.e%d" % (iid, p)],
                                   "Parent": [iid]}))
    gff = str(tmp_path / "s.gff")
    write_gff(recs, gff)
    rng = np.random.default_rng(3)
    _, pos, cig = simulate_reads(g, [0.6, 0.4], 400, 30, rng)
    reads = [AlignedRead("r%d" % i, 0, chrom, int(pos[i]) - 1, 255,
                         cig[i], 30) for i in range(len(pos))]
    reads.sort(key=lambda r: r.pos)
    bam = str(tmp_path / "s.bam")
    write_bam(bam, [chrom], [5000], reads)
    idx = str(tmp_path / "idx")
    assert index_main(["--index", gff, idx]) == 0
    settings = tmp_path / "s.txt"
    settings.write_text(FAST_SETTINGS)
    out = str(tmp_path / "out")
    assert miso_main(["--run", idx, bam, "--output-dir", out,
                      "--read-len", "30", "--settings-filename",
                      str(settings), "--pack-output"]) == 0
    obj = MISOSamples(out)
    data = obj.get_event_samples("sc1")
    assert data is not None and data.samples.shape[1] == 2


def test_conflicting_output_flags(tmp_path):
    from miso_jax.pipeline import RunConfig, compute_all_genes_psi

    with pytest.raises(ValueError, match="conflict"):
        compute_all_genes_psi(
            "/nonexistent", "/nonexistent", 36, str(tmp_path / "o"),
            cfg=RunConfig(read_len=36, summary_only=True,
                          pack_output=True))


def test_fully_resumed_run_rebuilds_summary(tmp_path):
    """A re-run where EVERY event is skip-done (prior run completed but
    its summary was lost) must still produce a complete summary."""
    import shutil

    from miso_jax.cli.index_gff import main as index_main
    from miso_jax.cli.main import main as miso_main
    from miso_jax.testing import build_catalog_fixture

    fix = build_catalog_fixture(str(tmp_path / "fix"), num_events=8,
                                reads_per_event=150, seed=37)
    settings = tmp_path / "settings.txt"
    settings.write_text(FAST_SETTINGS)
    index_dir = str(tmp_path / "index")
    assert index_main(["--index", fix["gff"], index_dir]) == 0
    out_dir = str(tmp_path / "out")
    base = ["--run", index_dir, fix["bam"], "--output-dir", out_dir,
            "--read-len", str(fix["read_len"]),
            "--settings-filename", str(settings)]
    assert miso_main(base) == 0
    summary = os.path.join(out_dir, "summary", "out.miso_summary")
    full = sorted(open(summary).read().splitlines())
    shutil.rmtree(os.path.dirname(summary))
    assert miso_main(base) == 0  # everything skip-done
    rebuilt = sorted(open(summary).read().splitlines())
    assert rebuilt == full  # byte-identical backfill from the samples
