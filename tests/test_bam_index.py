"""Indexed streaming BAM: .bai build/read/write + O(region) fetches.

The reference gets O(region) BAM access from pysam's .bai
(misopy/sam_utils.py:154-181); these tests pin the from-scratch
equivalent: fetch results identical to the in-memory reader, index
round-trips through the standard BAI encoding, and a region fetch
touches only the BGZF blocks the region covers.
"""
import os

import numpy as np
import pytest

from miso_jax.io.sam import (BaiIndex, BamReader, IndexedBamReader,
                             reg2bin, reg2bins)


@pytest.fixture(scope="module")
def big_bam(tmp_path_factory):
    """A multi-chromosome, multi-block BAM (~50k reads)."""
    from miso_jax.testing import make_se_catalog, simulate_catalog_bam

    d = tmp_path_factory.mktemp("bigbam")
    rng = np.random.default_rng(11)
    genes, _, true_psi = make_se_catalog(200, rng, chroms=3)
    path = str(d / "big.bam")
    simulate_catalog_bam(genes, true_psi, 250, 36, path, rng)
    return path


def _key(r):
    return (r.qname, r.flag, r.rname, r.pos, r.cigar_str)


def test_reg2bin_spec_anchors():
    # SAM spec: bin 4681 is the first 16kb leaf bin
    assert reg2bin(0, 1) == 4681
    assert reg2bin(1 << 14, (1 << 14) + 1) == 4682
    assert 4681 in reg2bins(0, 100)
    assert 0 in reg2bins(0, 1 << 29)


def test_indexed_fetch_matches_inmemory(big_bam):
    mem = BamReader(big_bam)
    idx = IndexedBamReader(big_bam)
    assert os.path.isfile(big_bam + ".bai")
    assert idx.references == mem.references
    rng = np.random.default_rng(5)
    for _ in range(25):
        chrom = mem.references[rng.integers(len(mem.references))]
        lo = int(rng.integers(0, 60000))
        hi = lo + int(rng.integers(1, 5000))
        want = sorted(map(_key, mem.fetch(chrom, lo, hi)))
        got = sorted(map(_key, idx.fetch(chrom, lo, hi)))
        assert got == want, (chrom, lo, hi)


def test_full_iteration_matches(big_bam):
    mem = list(BamReader(big_bam))
    idx = list(IndexedBamReader(big_bam))
    assert list(map(_key, idx)) == list(map(_key, mem))


def test_bai_roundtrip(big_bam, tmp_path):
    reader = IndexedBamReader(big_bam)
    p = str(tmp_path / "copy.bai")
    reader._index.write(p)
    loaded = BaiIndex.read(p)
    assert len(loaded.bins) == len(reader._index.bins)
    for a, b in zip(loaded.bins, reader._index.bins):
        assert a == b
    for a, b in zip(loaded.linear, reader._index.linear):
        assert a == b


def test_region_fetch_is_partial(big_bam):
    """A small region must not decompress the whole file."""
    reader = IndexedBamReader(big_bam)
    with open(big_bam, "rb") as f:
        f.seek(0, 2)
        fsize = f.tell()
    stream = reader._bgzf
    touched = set()
    orig = stream.block_at

    def counting(coffset):
        touched.add(coffset)
        return orig(coffset)

    stream.block_at = counting
    stream._cache.clear()
    chrom = reader.references[0]
    n = len(list(reader.fetch(chrom, 2000, 3000)))
    stream.block_at = orig
    assert n > 0
    # every block is ~<=64KB compressed; a 1kb region should touch few
    total_blocks = max(fsize // 16384, 1)
    assert len(touched) < max(4, total_blocks // 4), (
        len(touched), total_blocks)


def test_stale_bai_is_rebuilt(tmp_path):
    from miso_jax.testing import make_se_catalog, simulate_catalog_bam

    rng = np.random.default_rng(3)
    genes, _, psi = make_se_catalog(5, rng)
    path = str(tmp_path / "x.bam")
    simulate_catalog_bam(genes, psi, 50, 36, path, rng)
    IndexedBamReader(path)
    # rewrite the BAM with different contents; the old .bai is stale
    genes2, _, psi2 = make_se_catalog(9, rng)
    os.utime(path + ".bai", (1, 1))
    simulate_catalog_bam(genes2, psi2, 80, 36, path, rng)
    reader = IndexedBamReader(path)
    mem = BamReader(path)
    chrom = mem.references[0]
    lo, hi = 0, 10 ** 6
    assert sorted(map(_key, reader.fetch(chrom, lo, hi))) == \
        sorted(map(_key, mem.fetch(chrom, lo, hi)))


def test_atp2b1_fixture_fetch():
    """Real-data anchor: the reference's Atp2b1 reads through both
    readers."""
    ref_sam = "/root/reference/misopy/test-data/sam-data/c2c12.Atp2b1.sam"
    if not os.path.isfile(ref_sam):
        pytest.skip("reference fixtures not mounted")
    import tempfile

    from miso_jax.io.sam import sam_to_bam

    with tempfile.TemporaryDirectory() as d:
        bam = os.path.join(d, "a.bam")
        sam_to_bam(ref_sam, bam)
        assert os.path.isfile(bam + ".bai")
        mem = BamReader(bam)
        idx = IndexedBamReader(bam)
        want = sorted(map(_key, mem.fetch("10", 98377804, 98486420)))
        got = sorted(map(_key, idx.fetch("10", 98377804, 98486420)))
        assert want and got == want


def test_native_scanner_matches_python_decoder(big_bam):
    """The native columnar scanner and the Python record decoder produce
    identical reads over the whole file."""
    from miso_jax.io.sam import _decode_bam_record
    from miso_jax import native
    if native.load() is None:
        pytest.skip("native library unavailable")
    reader = IndexedBamReader(big_bam)
    native_reads = [_key(r) for r in reader]
    py_reads = [
        _key(_decode_bam_record(rec, reader.references))
        for rec in reader._records_from(reader._aln_voffset)]
    assert len(native_reads) == len(py_reads) > 10000
    assert native_reads == py_reads


def test_native_index_matches_python_index(big_bam):
    """Native (vectorized window) and Python (per-record) index builds
    encode byte-identically."""
    import io
    from miso_jax import native
    if native.load() is None:
        pytest.skip("native library unavailable")
    reader = IndexedBamReader(big_bam)
    nat = reader._build_index_native()
    py = reader._build_index_py()
    assert len(nat.bins) == len(py.bins)
    for bn, bp in zip(nat.bins, py.bins):
        assert bn == bp
    assert nat.linear == py.linear


def test_native_scan_batches_small_windows(big_bam):
    """Records crossing window boundaries carry over correctly: tiny
    windows give the same stream as one big window."""
    from miso_jax import native
    if native.load() is None:
        pytest.skip("native library unavailable")
    reader = IndexedBamReader(big_bam)
    big = []
    for scan, voffs, _ in reader._scan_batches(reader._aln_voffset,
                                               window_target=64 << 20):
        big.extend(zip(scan.pos.tolist(), scan.ref_id.tolist(),
                       voffs[:-1].tolist()))
    small = []
    for scan, voffs, _ in reader._scan_batches(reader._aln_voffset,
                                               window_target=1):
        small.extend(zip(scan.pos.tolist(), scan.ref_id.tolist(),
                         voffs[:-1].tolist()))
    assert big == small and len(big) > 10000


def test_fetch_columnar_matches_parse_reads(big_bam):
    """The columnar single-end ingest equals fetch + sam_parse_reads."""
    from miso_jax.io.sam import sam_parse_reads
    from miso_jax import native
    if native.load() is None:
        pytest.skip("native library unavailable")
    reader = IndexedBamReader(big_bam)
    chrom = reader.references[1]
    for (s, e), rl in [((0, 10 ** 9), None), ((1500, 5200), 36),
                       ((1500, 5200), 35)]:
        col = reader.fetch_columnar(chrom, s, e, given_read_len=rl)
        (pos, cig), n = sam_parse_reads(reader.fetch(chrom, s, e),
                                        given_read_len=rl)
        assert col[2] == n
        assert col[0] == pos and col[1] == cig
    assert reader.fetch_columnar(chrom, 0, 10 ** 9)[2] > 1000


def test_fetch_skips_placed_unmapped(tmp_path):
    """Placed-unmapped records (FLAG 0x4 with RNAME/POS copied from the
    mapped mate, CIGAR '*') must not surface from region fetches, as in
    the in-memory reader's _RegionIndex -- they would otherwise count
    toward the --prefilter coverage threshold."""
    from miso_jax.io.sam import AlignedRead, write_bam

    reads = [
        AlignedRead(qname="m%d" % i, flag=0, rname="chrZ", pos=100 + i,
                    mapq=60, cigar_str="36M", rlen=36)
        for i in range(5)
    ] + [
        AlignedRead(qname="u%d" % i, flag=0x4, rname="chrZ", pos=102 + i,
                    mapq=0, cigar_str="*", rlen=36)
        for i in range(3)
    ]
    reads.sort(key=lambda r: r.pos)
    path = str(tmp_path / "mix.bam")
    write_bam(path, ["chrZ"], [10000], reads)
    idx = IndexedBamReader(path)
    got = list(idx.fetch("chrZ", 0, 1000))
    assert sorted(r.qname for r in got) == ["m%d" % i for i in range(5)]
    col = idx.fetch_columnar("chrZ", 0, 1000)
    assert col is None or col[2] == 5


@pytest.fixture(scope="module")
def paired_bam(tmp_path_factory):
    """A paired-end BAM with every pairing edge case: suffixed and
    unsuffixed qnames, singletons, a triple-occurrence name, qcfail /
    mate-unmapped / unpaired-flag records, a same-strand pair, a '*'
    CIGAR mate, and mixed read lengths."""
    from miso_jax.io.sam import AlignedRead, write_bam

    F_PAIR, F_MUNMAP, F_REV, F_QCFAIL = 0x1, 0x8, 0x10, 0x200
    reads = []

    def add(qname, pos, flag, cigar="40M", rlen=40):
        reads.append(AlignedRead(qname=qname, flag=flag, rname="chrP",
                                 pos=pos, mapq=60, cigar_str=cigar,
                                 rlen=rlen))

    rng = np.random.default_rng(7)
    for k in range(40):  # normal pairs, half with /1 /2 suffixes
        p = int(rng.integers(100, 4000))
        rev_first = bool(rng.integers(2))
        n1 = "p%d/1" % k if k % 2 else "p%d" % k
        n2 = "p%d/2" % k if k % 2 else "p%d" % k
        add(n1, p, F_PAIR | (F_REV if rev_first else 0))
        add(n2, p + 120, F_PAIR | (0 if rev_first else F_REV))
    add("solo", 500, F_PAIR)                       # mate never in region
    add("trip", 600, F_PAIR)                       # name seen 3x
    add("trip", 700, F_PAIR | F_REV)
    add("trip", 800, F_PAIR)
    add("qf/1", 900, F_PAIR | F_QCFAIL)            # qcfail drops the pair
    add("qf/2", 1000, F_PAIR | F_REV)
    add("mu/1", 1100, F_PAIR | F_MUNMAP)           # mate-unmapped drops
    add("mu/2", 1200, F_PAIR | F_REV)
    add("np1", 1300, 0)                            # not flagged paired
    add("np1", 1400, F_REV)
    add("ss/1", 1500, F_PAIR)                      # same-strand pair
    add("ss/2", 1600, F_PAIR)
    add("star/1", 1700, F_PAIR, cigar="*")         # '*' CIGAR mate
    add("star/2", 1800, F_PAIR | F_REV)
    add("len/1", 1900, F_PAIR, cigar="30M", rlen=30)  # odd read length
    add("len/2", 2000, F_PAIR | F_REV, cigar="30M", rlen=30)
    reads.sort(key=lambda r: r.pos)
    path = str(tmp_path_factory.mktemp("pairedbam") / "paired.bam")
    write_bam(path, ["chrP"], [10000], reads)
    return path


@pytest.mark.parametrize("strand_rule,target", [
    (None, None), ("fr-unstranded", "+"),
    ("fr-firststrand", "+"), ("fr-firststrand", "-")])
def test_fetch_columnar_paired_matches_parse_reads(paired_bam,
                                                   strand_rule, target):
    """The native-paired columnar ingest equals fetch + sam_parse_reads
    (paired) on every edge case, including strand rules and read-length
    filters."""
    from miso_jax import native
    from miso_jax.io.sam import sam_parse_reads
    if native.load() is None:
        pytest.skip("native library unavailable")
    reader = IndexedBamReader(paired_bam)
    for (s, e), rl in [((0, 10 ** 9), None), ((0, 10 ** 9), 40),
                       ((300, 3000), None)]:
        col = reader.fetch_columnar_paired(
            "chrP", s, e, given_read_len=rl, strand_rule=strand_rule,
            target_strand=target)
        (pos, cig), n = sam_parse_reads(
            reader.fetch("chrP", s, e), paired_end=True,
            strand_rule=strand_rule, target_strand=target,
            given_read_len=rl)
        assert col[2] == n
        assert col[0] == pos and col[1] == cig


def test_fetch_columnar_stranded_matches_parse_reads(paired_bam):
    """Single-end fr-firststrand columnar filter equals the Python
    path's read_matches_strand."""
    from miso_jax import native
    from miso_jax.io.sam import sam_parse_reads
    if native.load() is None:
        pytest.skip("native library unavailable")
    reader = IndexedBamReader(paired_bam)
    for target in ("+", "-"):
        col = reader.fetch_columnar(
            "chrP", 0, 10 ** 9, strand_rule="fr-firststrand",
            target_strand=target)
        (pos, cig), n = sam_parse_reads(
            reader.fetch("chrP", 0, 10 ** 9),
            strand_rule="fr-firststrand", target_strand=target)
        assert col[2] == n and col[0] == pos and col[1] == cig


def test_scan_chrom_columnar_slice_matches_fetch_columnar(big_bam):
    """Whole-chromosome scan + region slice == per-region columnar
    fetch == fetch + sam_parse_reads, for every selection filter."""
    from miso_jax import native
    from miso_jax.io.sam import sam_parse_reads
    if native.load() is None:
        pytest.skip("native library unavailable")
    reader = IndexedBamReader(big_bam)
    chrom = reader.references[0]
    scan = reader.scan_chrom_columnar(chrom)
    for s, e in [(0, 10 ** 9), (1500, 5200), (800, 801), (10 ** 8, 10 ** 9)]:
        p, cg, n = scan.slice(s, e)
        col = reader.fetch_columnar(chrom, s, e)
        assert n == col[2]
        assert tuple(int(x) for x in p) == col[0]
        assert tuple(cg) == col[1]
    # read-length filter variant
    scan35 = reader.scan_chrom_columnar(chrom, given_read_len=35)
    assert scan35.slice(0, 10 ** 9)[2] == \
        reader.fetch_columnar(chrom, 0, 10 ** 9, given_read_len=35)[2]


def test_scan_chrom_columnar_stranded(paired_bam):
    from miso_jax import native
    if native.load() is None:
        pytest.skip("native library unavailable")
    reader = IndexedBamReader(paired_bam)
    for target in ("+", "-"):
        scan = reader.scan_chrom_columnar(
            "chrP", strand_rule="fr-firststrand", target_strand=target)
        p, cg, n = scan.slice(0, 10 ** 9)
        col = reader.fetch_columnar(
            "chrP", 0, 10 ** 9, strand_rule="fr-firststrand",
            target_strand=target)
        assert n == col[2] and tuple(cg) == col[1]


def test_columnar_unknown_strand_rule_raises_like_python_path(paired_bam):
    """An unknown strand rule with a target strand must raise on the
    native columnar paths exactly as read_matches_strand does on the
    Python path -- not silently quantify as unstranded."""
    from miso_jax import native
    if native.load() is None:
        pytest.skip("native library unavailable")
    reader = IndexedBamReader(paired_bam)
    for call in (
        lambda: reader.fetch_columnar(
            "chrP", 0, 10 ** 9, strand_rule="rf-firststrand",
            target_strand="+"),
        lambda: reader.fetch_columnar_paired(
            "chrP", 0, 10 ** 9, strand_rule="rf-firststrand",
            target_strand="+"),
        lambda: reader.scan_chrom_columnar(
            "chrP", strand_rule="fr-secondstrand", target_strand="+"),
    ):
        with pytest.raises(ValueError):
            call()
    # without a target strand the Python path never consults the rule;
    # the columnar paths match (no raise)
    reader.fetch_columnar("chrP", 0, 100, strand_rule="rf-firststrand")


def test_scan_chrom_paired_slice_matches_fetch_columnar_paired(paired_bam):
    """Chromosome-level pairing + region slice == per-region paired
    columnar fetch, across strand rules and read-length filters (every
    name in the fixture has at most 2 same-chromosome records, so the
    pairing scopes coincide -- see scan_chrom_columnar_paired)."""
    from miso_jax import native
    if native.load() is None:
        pytest.skip("native library unavailable")
    reader = IndexedBamReader(paired_bam)
    for rule, target in [(None, None), ("fr-firststrand", "+")]:
        for rl in (None, 40):
            pairs = reader.scan_chrom_columnar_paired(
                "chrP", given_read_len=rl, strand_rule=rule,
                target_strand=target)
            for s, e in [(0, 10 ** 9), (300, 3000), (1650, 1750)]:
                got = pairs.slice(s, e)
                want = reader.fetch_columnar_paired(
                    "chrP", s, e, given_read_len=rl, strand_rule=rule,
                    target_strand=target)
                assert got == want, (rule, rl, s, e)


def test_chrom_paired_scan_survives_secondary_alignments(tmp_path):
    """A multimapper's secondary record elsewhere on the chromosome
    must not break its primary pair in the chromosome-scope pairing
    (secondaries are excluded before pairing there; the region-scope
    path keeps reference name-count semantics instead)."""
    from miso_jax import native
    from miso_jax.io.sam import AlignedRead, write_bam
    if native.load() is None:
        pytest.skip("native library unavailable")
    F_PAIR, F_REV, F_SEC = 0x1, 0x10, 0x100
    reads = [
        AlignedRead(qname="mm", flag=F_PAIR, rname="chrM", pos=100,
                    mapq=60, cigar_str="40M", rlen=40),
        AlignedRead(qname="mm", flag=F_PAIR | F_REV, rname="chrM",
                    pos=260, mapq=60, cigar_str="40M", rlen=40),
        AlignedRead(qname="mm", flag=F_PAIR | F_SEC, rname="chrM",
                    pos=5000, mapq=0, cigar_str="40M", rlen=40),
    ]
    reads.sort(key=lambda r: r.pos)
    path = str(tmp_path / "mm.bam")
    write_bam(path, ["chrM"], [10000], reads)
    reader = IndexedBamReader(path)
    pairs = reader.scan_chrom_columnar_paired("chrM")
    got = pairs.slice(0, 1000)
    assert got[2] == 1 and got[0] == (100, 260)
    # the region path mirrors the reference: 3 same-name records in
    # one region -> no pair
    assert reader.fetch_columnar_paired("chrM", 0, 10000)[2] == 0
