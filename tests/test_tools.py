"""Tool-layer tests against the reference's real binary fixtures:
externally-generated BAMs (samtools-produced BGZF), reference-produced
.miso files, sashimi plotting, exon/pe utilities."""
import os

import numpy as np
import pytest

SASHIMI_DATA = "/root/reference/misopy/sashimi_plot/test-data"
EVENTS_GFF = os.path.join(SASHIMI_DATA, "events.gff")
BAM = os.path.join(SASHIMI_DATA, "bam-data", "heartWT1.sorted.bam")
MISO_DATA = os.path.join(SASHIMI_DATA, "miso-data")
ATP_GFF = "/root/reference/misopy/gff-events/mm9/genes/Atp2b1.mm9.gff"

EVENT = ("chr17:45816186:45816265:-@chr17:45815912:45815950:-"
         "@chr17:45814875:45814965:-")

pytestmark = pytest.mark.skipif(
    not os.path.isdir(SASHIMI_DATA), reason="reference fixtures not mounted")


def test_bam_reader_on_samtools_bam():
    from miso_jax.io.sam import BamReader
    reader = BamReader(BAM)
    assert "chr17" in reader.references
    reads = list(reader)
    assert len(reads) > 50
    r = reads[0]
    assert r.rname.startswith("chr")
    assert r.cigar is not None and r.pos >= 0
    # region fetch over the fixture event
    region = list(reader.fetch("chr17", 45814875, 45816265))
    assert len(region) > 10
    assert all(rr.pos < 45816265 for rr in region)


def test_load_reference_produced_miso_file():
    from miso_jax.io.miso_file import MISOSamples, load_miso_file
    obj = MISOSamples(os.path.join(MISO_DATA, "heartWT1"))
    assert EVENT in obj.all_event_names
    data = obj.get_event_samples(EVENT)
    assert data is not None
    assert data.samples.shape[1] == 2
    assert np.all((data.samples >= 0) & (data.samples <= 1))
    # legacy-format header: no chrom/strand fields -> "NA" fallback
    # (samples_utils.py:214-228)
    from miso_jax.io.miso_file import get_gene_info_from_params
    assert get_gene_info_from_params(data.params)["strand"] == "NA"
    assert data.params["counts"] == "(0,1):1,(1,0):21,(1,1):23"


def test_summarize_reference_dir(tmp_path):
    from miso_jax.io.miso_file import summarize_sampler_results
    out = tmp_path / "wt1.miso_summary"
    n = summarize_sampler_results(os.path.join(MISO_DATA, "heartWT1"),
                                  str(out))
    assert n == 1
    lines = out.read_text().splitlines()
    assert len(lines) == 2


def test_compare_reference_dirs(tmp_path):
    from miso_jax.io.comparison import output_samples_comparison
    path = output_samples_comparison(
        os.path.join(MISO_DATA, "heartWT1"),
        os.path.join(MISO_DATA, "heartKOa"),
        str(tmp_path))
    lines = open(path).read().splitlines()
    assert len(lines) == 2
    fields = dict(zip(lines[0].split("\t"), lines[1].split("\t")))
    assert 0 <= abs(float(fields["diff"])) <= 1
    assert float(fields["bayes_factor"]) >= 0


@pytest.fixture(scope="module")
def sashimi_settings(tmp_path_factory):
    d = tmp_path_factory.mktemp("sashimi")
    p = d / "settings.txt"
    p.write_text("""\
[data]
bam_prefix = %s
miso_prefix = %s
bam_files = ["heartWT1.sorted.bam", "heartKOa.sorted.bam"]
miso_files = ["heartWT1", "heartKOa"]

[plotting]
fig_width = 7
fig_height = 5
intron_scale = 30
exon_scale = 4
colors = ["#CC0011", "#FF8800"]
show_posteriors = True
""" % (os.path.join(SASHIMI_DATA, "bam-data"), MISO_DATA))
    return str(p)


@pytest.fixture(scope="module")
def events_index(tmp_path_factory):
    from miso_jax.io.index import index_gff
    out = str(tmp_path_factory.mktemp("events_index"))
    assert index_gff(EVENTS_GFF, out)
    return out


def test_sashimi_plot_event(events_index, sashimi_settings, tmp_path):
    from miso_jax.plot.sashimi import plot_event
    out = plot_event(EVENT, events_index, sashimi_settings, str(tmp_path))
    assert os.path.isfile(out) and os.path.getsize(out) > 5000


def test_genome_transform_reverse():
    """Minus-strand axes run right-to-left; inverse() recovers genomic
    coordinates either way (plot_gene.py:366-391 getScaling)."""
    from miso_jax.plot.sashimi import GenomeTransform
    exons = [(100, 199), (400, 499)]
    fwd = GenomeTransform(exons, 100, 499, intron_scale=30.0,
                          exon_scale=4.0, reverse=False)
    rev = GenomeTransform(exons, 100, 499, intron_scale=30.0,
                          exon_scale=4.0, reverse=True)
    assert float(fwd(100)) < float(fwd(499))
    assert float(rev(100)) > float(rev(499))
    assert abs(float(fwd(100)) + float(rev(100)) - fwd.total) < 1e-9
    for pos in (100, 150, 250, 450, 499):
        assert abs(fwd.inverse(float(fwd(pos))) - pos) <= 1
        assert abs(rev.inverse(float(rev(pos))) - pos) <= 1


def test_sashimi_plot_event_option_paths(events_index, tmp_path,
                                         tmp_path_factory):
    """logged + bar_posteriors + fixed ymax + reverse_minus render path."""
    from miso_jax.plot.sashimi import plot_event
    d = tmp_path_factory.mktemp("sashimi_opts")
    p = d / "settings.txt"
    p.write_text("""\
[data]
bam_prefix = %s
miso_prefix = %s
bam_files = ["heartWT1.sorted.bam", "heartKOa.sorted.bam"]
miso_files = ["heartWT1", "heartKOa"]
coverages = [100000, 120000]

[plotting]
logged = True
bar_posteriors = True
reverse_minus = True
ymax = 3
nyticks = 4
nxticks = 5
show_ylabel = False
sample_labels = ["WT", "KO"]
""" % (os.path.join(SASHIMI_DATA, "bam-data"), MISO_DATA))
    out = plot_event(EVENT, events_index, str(p), str(tmp_path),
                     plot_label="opts")
    assert os.path.isfile(out) and os.path.getsize(out) > 5000


def test_plot_bf_dist(tmp_path, sashimi_settings):
    from miso_jax.io.comparison import output_samples_comparison
    from miso_jax.plot.sashimi import plot_bf_dist
    bf = output_samples_comparison(
        os.path.join(MISO_DATA, "heartWT1"),
        os.path.join(MISO_DATA, "heartKOa"), str(tmp_path))
    out = plot_bf_dist(bf, sashimi_settings, str(tmp_path))
    assert os.path.isfile(out)


def test_const_exons(tmp_path):
    from miso_jax.cli.exon_utils import get_const_exons_by_gene
    out = get_const_exons_by_gene(ATP_GFF, str(tmp_path), min_size=0)
    from miso_jax.io.gff import read_gff
    exons = read_gff(out)
    assert len(exons) > 0
    assert all(e.type == "exon" for e in exons)
    assert all("GeneParent" in e.attributes for e in exons)


def test_pe_utils_runs(tmp_path):
    from miso_jax.cli.exon_utils import get_const_exons_by_gene
    from miso_jax.cli.pe_utils import compute_insert_len
    const = get_const_exons_by_gene(EVENTS_GFF, str(tmp_path), min_size=0,
                                    all_constitutive=True)
    out = compute_insert_len(BAM, const, str(tmp_path), min_exon_size=10)
    assert os.path.isfile(out)
    header = open(out).readline()
    assert header.startswith("#mean=")


def test_insert_len_plot(tmp_path):
    from miso_jax.plot.sashimi import plot_insert_len
    il = tmp_path / "test.insert_len"
    il.write_text("#mean=200.0,sdev=10.0,dispersion=0.7,num_pairs=4\n"
                  "chr1:1-500:+\t190,200,205,210\n")
    settings = tmp_path / "s.txt"
    settings.write_text("[data]\n[plotting]\nfig_width = 5\nfig_height = 4\n")
    out = plot_insert_len(str(il), str(settings), str(tmp_path))
    assert os.path.isfile(out)


def test_miso_zip_roundtrip(tmp_path):
    import shutil
    from miso_jax.cli.zip import unzip_file, zip_dir
    from miso_jax.io.miso_file import MISOSamples
    src = os.path.join(MISO_DATA, "heartWT1")
    work = tmp_path / "wt1"
    shutil.copytree(src, work)
    zp = str(tmp_path / "wt1.misozip")
    zip_dir(str(work), zp)
    assert os.path.isfile(zp)
    out = str(tmp_path / "restored")
    unzip_file(zp, out)
    obj = MISOSamples(os.path.join(out, "wt1"))
    assert obj.num_events == 1
    assert obj.get_event_samples(obj.all_event_names[0]) is not None


def test_noise_simulator():
    from miso_jax.core.gene import make_gene
    from miso_jax.core.simulate import simulate_two_iso_reads_with_noise
    g = make_gene([100, 50, 100], [[1, 2, 3], [1, 3]])
    rng = np.random.default_rng(0)
    iso, pos, cig = simulate_two_iso_reads_with_noise(
        g, 0.5, 2000, 25, p_ne_loss=0.5, rng=rng)
    iso2, pos2, cig2 = simulate_two_iso_reads_with_noise(
        g, 0.5, 2000, 25, p_ne_loss=0.0, rng=np.random.default_rng(0))
    # losing exclusion reads shrinks the read set
    assert len(pos) < len(pos2)
    assert len(pos) == len(cig)


def test_rpkm_cli(tmp_path):
    """miso_rpkm --compute-rpkm over the sashimi fixture BAM.
    Parity: misopy/sam_rpkm.py:64+ (compute_rpkm)."""
    from miso_jax.cli.rpkm import main
    rc = main(["--compute-rpkm", EVENTS_GFF, BAM, "--read-len", "36",
               "--output-dir", str(tmp_path)])
    assert rc == 0
    out = tmp_path / (os.path.basename(BAM) + ".rpkm")
    lines = out.read_text().splitlines()
    assert lines[0].startswith("gene_id\trpkm")
    assert len(lines) >= 2
    vals = lines[1].split("\t")
    assert float(vals[1]) >= 0 and int(vals[2]) > 0


def test_run_events_analysis_check(tmp_path):
    """run_events_analysis.py --check runs the GFF/BAM sanity scan.
    Parity: misopy/run_events_analysis.py:74-194 (check_gff_and_bam)."""
    from miso_jax.cli.index_gff import main as index_main
    from miso_jax.cli.run_events_analysis import main
    idx = str(tmp_path / "index")
    assert index_main(["--index", EVENTS_GFF, idx]) == 0
    assert main(["--check", idx, BAM]) == 0
    # legacy flags point at `miso --run` and fail loudly
    assert main([]) == 1


def test_module_availability_cli():
    """Dependency probe exits 0 with the baked-in stack.
    Parity: misopy/module_availability.py:11-56."""
    from miso_jax.cli.module_availability import main
    assert main([]) == 0


def test_sam_to_bam_roundtrip(tmp_path):
    """sam_to_bam --convert produces a sorted BAM our reader accepts.
    Parity: misopy/sam_to_bam.py:8-42."""
    from miso_jax.cli.sam_to_bam import main
    from miso_jax.io.sam import BamReader
    sam = "/root/reference/misopy/test-data/sam-data/c2c12.Atp2b1.sam"
    out = str(tmp_path / "bams")
    assert main(["--convert", sam, out]) == 0
    bam = os.path.join(out, "c2c12.Atp2b1.sorted.bam")
    assert os.path.isfile(bam)
    reader = BamReader(bam)
    reads = list(reader)
    assert len(reads) > 1000
    # sorted by position
    pos = [r.pos for r in reads if r.rname == reads[0].rname]
    assert pos == sorted(pos)


def test_read_gff_v2_dialect(tmp_path):
    """##gff-version 2 files parse tag-value attributes (quoted and
    bare) and GTF-style records build the gene hierarchy
    (gff_utils.py:687-709,752-810)."""
    from miso_jax.io.gff import load_genes_from_gff, parse_v2_attributes
    attrs = parse_v2_attributes(
        'gene_id "g1"; note value1 "free text" ; empty ; # trailing')
    assert attrs["gene_id"] == ["g1"]
    assert attrs["note"] == ["value1", "free text"]
    assert attrs["empty"] == []
    p = tmp_path / "v2.gff"
    p.write_text(
        "##gff-version 2\n"
        "chr1\tsrc\texon\t100\t199\t.\t+\t.\t"
        'gene_id "g1"; transcript_id "t1"\n'
        "chr1\tsrc\texon\t300\t399\t.\t+\t.\t"
        'gene_id "g1"; transcript_id "t1"\n'
        "chr1\tsrc\texon\t100\t399\t.\t+\t.\t"
        'gene_id "g1"; transcript_id "t2"\n')
    genes = load_genes_from_gff(str(p))
    assert list(genes) == ["g1"]
    assert genes["g1"].num_isoforms == 2


def test_read_gff_v1_dialect(tmp_path):
    """##gff-version 1 rows carry the free-text group column
    (gff_utils.py:664-685)."""
    from miso_jax.io.gff import read_gff
    p = tmp_path / "v1.gff"
    p.write_text(
        "##gff-version 1\n"
        "chr1\tsrc\texon\t100\t199\t0.5\t+\t.\tmy group text\n"
        "chr1\tsrc\texon\t300\t399\t.\t-\t0\n")
    recs = read_gff(str(p))
    assert len(recs) == 2
    assert recs[0].attributes == {"group": ["my group text"]}
    assert recs[0].score == 0.5
    assert recs[1].attributes == {} and recs[1].phase == 0


def test_write_gff_dialect_roundtrip(tmp_path):
    """Writer emits v1/v2/GTF dialects that the Reader round-trips
    (gff_utils.py:846-953)."""
    from miso_jax.io.gff import GFFRecord, read_gff, write_gff
    rec = GFFRecord("chr1", "src", "exon", 100, 199, 0.5, "+", None,
                    {"gene_id": ["g1"], "transcript_id": ["t1"]})
    for version in ("2", "gtf"):
        p = tmp_path / ("out_%s.gff" % version)
        write_gff([rec], str(p), version=version)
        back = read_gff(str(p))
        # GTF-style records are converted to the gene hierarchy
        exons = [r for r in back if r.type == "exon"]
        assert exons[0].start == 100 and exons[0].end == 199
    p1 = tmp_path / "out_v1.gff"
    write_gff([GFFRecord("chr1", "src", "exon", 1, 9, None, "-", None,
                         {"group": ["free text"]})], str(p1), version="1")
    back = read_gff(str(p1))
    assert back[0].attributes == {"group": ["free text"]}
    assert back[0].score == 0.0  # v1 writes missing scores as '0'


def test_format_sample_block_edge_cases():
    """Near-zero negative scores keep their '-0.00' sign, and an empty
    sample block formats to empty bytes instead of crashing."""
    import numpy as np
    from miso_jax.io.miso_file import _format_sample_block

    got = _format_sample_block(np.array([[0.25, 0.75]]),
                               np.array([-0.004]))
    assert got == b"0.2500,0.7500\t-0.00\n"
    assert _format_sample_block(np.zeros((0, 2)), np.zeros(0)) == b""
    got = _format_sample_block(np.array([[1.0, 0.0]]), np.array([-0.0]))
    assert got == b"1.0000,0.0000\t-0.00\n"


def test_text_sam_scale_warning(tmp_path, monkeypatch):
    """Whole-file text-SAM ingest warns above the size threshold
    (io/sam.py SamFile is deliberately in-memory; the reference
    converts via sam_to_bam first, sam_to_bam.py:32-60)."""
    import warnings

    from miso_jax.io import sam as sam_io

    p = tmp_path / "big.sam"
    p.write_text("@SQ\tSN:chr1\tLN:1000\n"
                 "r1\t0\tchr1\t1\t255\t20M\t*\t0\t0\t*\t*\n")
    monkeypatch.setattr(sam_io, "SAM_WARN_BYTES", 1)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        sam_io.SamFile(str(p))
    assert any("Convert to sorted BAM" in str(x.message) for x in w)
    # below the threshold: silent
    monkeypatch.setattr(sam_io, "SAM_WARN_BYTES", 1 << 30)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        sam_io.SamFile(str(p))
    assert not w


def test_native_format_quantized_matches_numpy():
    """The native .miso body formatter (native/formatlib.cpp) must be
    byte-identical to the vectorized numpy formatter across sign,
    magnitude, and isoform-count edges (including -0.00 scores and the
    0/10000 tick extremes)."""
    import numpy as np

    from miso_jax import native
    from miso_jax.io import miso_file

    if native.load() is None:
        import pytest
        pytest.skip("native library unavailable")
    rng = np.random.default_rng(5)
    for I in (1, 2, 3, 7):
        S = 257
        q = rng.integers(0, 10001, (S, I)).astype(np.int64)
        q[0] = 0
        q[1] = 10000
        vals = rng.normal(-1000.0, 2000.0, S)
        vals[2] = -0.004   # "-0.00"
        vals[3] = 0.0
        vals[4] = -123456789.12
        cents = np.round(vals * 100.0).astype(np.int64)
        neg = np.signbit(vals)
        nat_blob, nat_off = native.format_quantized(q, cents, neg)
        # numpy fallback path, forced by disabling the native fast path
        import unittest.mock as mock
        with mock.patch.object(native, "format_quantized",
                               lambda *a: None):
            ref_blob, ref_off = miso_file._format_quantized(
                q, cents, neg, return_offsets=True)
        assert nat_blob == ref_blob
        np.testing.assert_array_equal(nat_off, ref_off)


def test_native_parse_samples_matches_python():
    """parselib.cpp must produce bitwise the same samples/scores as the
    Python .miso parser, and malformed/ragged bodies must fall back."""
    import numpy as np

    from miso_jax import native
    from miso_jax.io import miso_file

    if native.load() is None:
        import pytest
        pytest.skip("native library unavailable")
    rng = np.random.default_rng(3)
    body_lines = []
    S, I = 301, 3
    psi = rng.dirichlet([3, 2, 1], S)
    scores = rng.normal(-5000, 3000, S)
    exact = []
    for s in range(S):
        cells = ["%.4f" % v for v in psi[s]]
        sc = "%.2f" % scores[s]
        body_lines.append(",".join(cells) + "\t" + sc)
        exact.append([float(c) for c in cells] + [float(sc)])
    exact = np.asarray(exact)
    content = ("#isoforms=['a','b','c']\tcounts=(1,0,0):5\t"
               "assigned_counts=0:5\nsampled_psi\tlog_score\n"
               + "\n".join(body_lines) + "\n")
    import tempfile
    with tempfile.NamedTemporaryFile("w", suffix=".miso",
                                     delete=False) as f:
        f.write(content)
        path = f.name
    got = miso_file.load_miso_file(path)
    np.testing.assert_array_equal(got.samples, exact[:, :I])
    np.testing.assert_array_equal(got.log_scores, exact[:, I])
    # python path on the same lines must agree bitwise
    ref = miso_file.load_miso_file(content.splitlines(keepends=True))
    np.testing.assert_array_equal(got.samples, ref.samples)
    np.testing.assert_array_equal(got.log_scores, ref.log_scores)
    assert got.sampled_map == ref.sampled_map
    # ragged body (second line short one psi field): native refuses
    bad_lines = list(body_lines)
    bad_lines[1] = bad_lines[1].split(",", 1)[1]
    assert native.parse_samples(
        ("\n".join(bad_lines) + "\n").encode()) is None
    # junk token: native refuses
    assert native.parse_samples(b"0.1234,abc\t-1.00\n") is None


def test_exon_index_matches_bruteforce():
    """pe_utils' containment index must agree with a brute-force scan
    on random (overlapping, nested) exon sets."""
    import numpy as np

    from miso_jax.cli.pe_utils import _ExonIndex

    class E:
        def __init__(self, seqid, start, end, strand="+"):
            self.seqid, self.start, self.end = seqid, start, end
            self.strand = strand

    rng = np.random.default_rng(8)
    exons = []
    for _ in range(300):
        s = int(rng.integers(1, 5000))
        e = s + int(rng.integers(20, 400))
        exons.append(E("chrT", s, e))
    idx = _ExonIndex(exons)
    for _ in range(500):
        qs = int(rng.integers(0, 5200))
        qe = qs + int(rng.integers(1, 450))
        brute = sorted(
            "%s:%d-%d:%s" % (x.seqid, x.start, x.end, x.strand)
            for x in exons
            if x.start - 1 <= qs and qe <= x.end - 1)
        assert sorted(idx.find(qs, qe)) == brute, (qs, qe)


def test_rpkm_scan_path_matches_fallback(tmp_path):
    """The chromosome-scan RPKM counting must be byte-identical to the
    per-read fallback path."""
    import shutil

    import miso_jax.cli.rpkm as R
    import miso_jax.io.sam as S
    from miso_jax.testing import build_catalog_fixture

    fix = build_catalog_fixture(str(tmp_path / "fix"), num_events=40,
                                reads_per_event=120, seed=44)
    fast = R.compute_rpkm(fix["gff"], fix["bam"], fix["read_len"],
                          str(tmp_path / "fast"))

    class Shim:
        def __init__(self, inner):
            self._i = inner

        def __getattr__(self, k):
            if k == "scan_chrom_columnar":
                raise AttributeError(k)
            return getattr(self._i, k)

        def __iter__(self):
            return iter(self._i)

    real = S.open_alignments
    S.open_alignments = lambda p: Shim(real(p))
    try:
        slow = R.compute_rpkm(fix["gff"], fix["bam"], fix["read_len"],
                              str(tmp_path / "slow"))
    finally:
        S.open_alignments = real
    assert open(fast).read() == open(slow).read()
