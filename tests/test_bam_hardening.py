"""Adversarial BAM/BGZF/BAI inputs must raise clean ValueErrors --
never over-read buffers, loop forever, or blow up memory.

The reference delegates this hardening to pysam/htslib; the from-scratch
reader (io/sam.py) and native scanner (native/bamlib.cpp) own it here.
Each test corrupts a well-formed BAM at one structural boundary.
"""
import os
import struct
import zlib

import numpy as np
import pytest

from miso_jax.io.sam import AlignedRead, BaiIndex, IndexedBamReader, write_bam


@pytest.fixture()
def good_bam(tmp_path):
    reads = [AlignedRead(qname="r%d" % i, flag=0, rname="chrH",
                         pos=100 + 3 * i, mapq=60, cigar_str="20M",
                         rlen=20)
             for i in range(50)]
    path = str(tmp_path / "good.bam")
    write_bam(path, ["chrH"], [5000], reads)
    return path


def _read_all(path):
    reader = IndexedBamReader(path, build_missing_index=True)
    return list(reader.fetch("chrH", 0, 5000))


def _consume(path):
    """Open + index + fetch, forcing every parse layer."""
    return len(_read_all(path))


def test_good_bam_baseline(good_bam):
    assert _consume(good_bam) == 50


@pytest.mark.parametrize("cut", [4, 10, 17, 30, 100])
def test_truncated_file_raises_or_stops_clean(good_bam, tmp_path, cut):
    """Truncations at every structural layer (gzip header, BC field,
    deflate payload, mid-record) either raise ValueError or yield a
    clean partial result -- never hang or crash."""
    raw = open(good_bam, "rb").read()
    p = str(tmp_path / ("trunc%d.bam" % cut))
    with open(p, "wb") as f:
        f.write(raw[:cut])
    with pytest.raises(ValueError):
        _consume(p)


def test_truncated_mid_stream(good_bam, tmp_path):
    raw = open(good_bam, "rb").read()
    p = str(tmp_path / "mid.bam")
    with open(p, "wb") as f:
        f.write(raw[:len(raw) // 2])
    # either a clean partial fetch (cut fell between blocks) or a
    # clean ValueError (cut fell inside a block/record)
    try:
        n = _consume(p)
        assert 0 <= n <= 50
    except ValueError:
        pass


def test_not_bgzf_raises(tmp_path):
    p = str(tmp_path / "junk.bam")
    with open(p, "wb") as f:
        f.write(b"\x00" * 200)
    with pytest.raises(ValueError):
        IndexedBamReader(p)


def test_text_file_raises(tmp_path):
    p = str(tmp_path / "text.bam")
    with open(p, "wb") as f:
        f.write(b"this is not a bam file, not even gzip\n" * 10)
    with pytest.raises(ValueError):
        IndexedBamReader(p)


def test_gzip_without_bc_field_raises(tmp_path):
    """A plain gzip member (no BGZF BC extra field) must be rejected,
    not mis-sized."""
    payload = zlib.compress(b"x" * 100)
    p = str(tmp_path / "plain.gz.bam")
    with open(p, "wb") as f:
        # gzip header with FEXTRA but a non-BC extra field
        extra = struct.pack("<BBH", 65, 65, 2) + b"\x00\x00"
        f.write(b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff"
                + struct.pack("<H", len(extra)) + extra
                + payload + b"\x00" * 8)
    with pytest.raises(ValueError):
        IndexedBamReader(p)


def test_corrupt_bsize_raises(good_bam, tmp_path):
    """BSIZE smaller than the header+footer would make the compressed
    payload length negative -- must raise, not read the whole file."""
    raw = bytearray(open(good_bam, "rb").read())
    # BC field's BSIZE lives at offset 16..18 of the first block
    struct.pack_into("<H", raw, 16, 5)
    p = str(tmp_path / "bsize.bam")
    with open(p, "wb") as f:
        f.write(raw)
    with pytest.raises(ValueError):
        IndexedBamReader(p)


def test_garbage_deflate_raises(good_bam, tmp_path):
    raw = bytearray(open(good_bam, "rb").read())
    # stomp the deflate payload of the first block
    for i in range(30, 60):
        raw[i] ^= 0xFF
    p = str(tmp_path / "deflate.bam")
    with open(p, "wb") as f:
        f.write(raw)
    with pytest.raises(ValueError):
        IndexedBamReader(p)


def _decompress_first_block(raw):
    xlen = struct.unpack_from("<H", raw, 10)[0]
    bsize = None
    epos = 12
    while epos < 12 + xlen:
        si1, si2, slen = struct.unpack_from("<BBH", raw, epos)
        if si1 == 66 and si2 == 67:
            bsize = struct.unpack_from("<H", raw, epos + 4)[0] + 1
        epos += 4 + slen
    cdata = raw[12 + xlen:bsize - 8]
    return zlib.decompress(cdata, wbits=-15), bsize


def _bgzf_block(data):
    c = zlib.compressobj(6, zlib.DEFLATED, -15)
    comp = c.compress(data) + c.flush()
    bsize = len(comp) + 12 + 6 + 8
    hdr = (b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff"
           + struct.pack("<H", 6)
           + struct.pack("<BBH", 66, 67, 2)
           + struct.pack("<H", bsize - 1))
    return hdr + comp + struct.pack("<I", zlib.crc32(data)) \
        + struct.pack("<I", len(data) & 0xFFFFFFFF)


def _corrupt_first_record(good_bam, tmp_path, name, mutate):
    """Decompress block 0, let `mutate` patch the decoded bytes at the
    first alignment record, and re-pack the file."""
    raw = open(good_bam, "rb").read()
    data, bsize = _decompress_first_block(raw)
    # find the first record: magic, l_text, text, n_ref, (l_name, name,
    # l_ref)
    l_text = struct.unpack_from("<i", data, 4)[0]
    off = 8 + l_text
    n_ref = struct.unpack_from("<i", data, off)[0]
    off += 4
    for _ in range(n_ref):
        l_name = struct.unpack_from("<i", data, off)[0]
        off += 4 + l_name + 4
    data = bytearray(data)
    mutate(data, off)
    p = str(tmp_path / name)
    with open(p, "wb") as f:
        f.write(_bgzf_block(bytes(data)))
        f.write(raw[bsize:])
    return p


def test_negative_record_size_raises(good_bam, tmp_path):
    def mutate(data, off):
        struct.pack_into("<i", data, off, -100)
    p = _corrupt_first_record(good_bam, tmp_path, "negsz.bam", mutate)
    with pytest.raises(ValueError):
        _consume(p)


def test_record_field_overrun_raises(good_bam, tmp_path):
    """l_read_name + n_cigar_op overruns the record: both the native
    scanner (rc -1 -> ValueError) and the Python decoder must reject."""
    def mutate(data, off):
        data[off + 4 + 8] = 255        # l_read_name
        struct.pack_into("<H", data, off + 4 + 12, 60000)  # n_cigar_op
    p = _corrupt_first_record(good_bam, tmp_path, "overrun.bam", mutate)
    with pytest.raises(ValueError):
        _consume(p)
    os.environ["MISO_NO_NATIVE"] = "1"
    try:
        import miso_jax.native as nat
        old = (nat._LIB, nat._TRIED)
        nat._LIB, nat._TRIED = None, False
        with pytest.raises(ValueError):
            _consume(p)
    finally:
        os.environ.pop("MISO_NO_NATIVE", None)
        nat._LIB, nat._TRIED = old


def test_corrupt_bai_raises(good_bam, tmp_path):
    _consume(good_bam)  # builds the .bai
    bai = good_bam + ".bai"
    raw = bytearray(open(bai, "rb").read())
    p = str(tmp_path / "bad.bai")
    with open(p, "wb") as f:
        f.write(raw[:10])  # truncated
    with pytest.raises(ValueError):
        BaiIndex.read(p)
    with open(p, "wb") as f:
        f.write(b"JUNK" + raw[4:])
    with pytest.raises(ValueError):
        BaiIndex.read(p)


def test_bgzf_decompression_bomb_rejected(good_bam, tmp_path):
    """A block claiming BGZF framing but inflating past the 64 KiB spec
    bound must be rejected (deflate expands up to ~1000x)."""
    raw = open(good_bam, "rb").read()
    _, bsize = _decompress_first_block(raw)
    bomb = _bgzf_block(b"\x00" * 70000)  # oversize decompressed block
    p = str(tmp_path / "bomb.bam")
    with open(p, "wb") as f:
        f.write(bomb)
        f.write(raw[bsize:])
    with pytest.raises(ValueError):
        _consume(p)


def test_blocks_run_matches_block_at(tmp_path):
    """The parallel-inflate block-run decoder must yield exactly the
    byte stream the one-block-at-a-time reader produces, for every
    starting offset and window size (io/sam.py blocks_run)."""
    import numpy as np

    from miso_jax.io.sam import AlignedRead, _BgzfStream, write_bam

    reads = [AlignedRead(qname="r%d" % i, flag=0, rname="chr1",
                         pos=i * 7, mapq=255, cigar_str="36M", rlen=36)
             for i in range(5000)]
    bam = str(tmp_path / "x.bam")
    write_bam(bam, ["chr1"], [100000], reads)

    ref = _BgzfStream(bam)
    # serial oracle: full decompressed stream + block boundaries
    blocks = []
    c = 0
    while True:
        data, nxt = ref.block_at(c)
        if nxt == c:
            break
        blocks.append((c, data))
        c = nxt
    whole = b"".join(d for _, d in blocks)

    for max_bytes in (1 << 12, 1 << 16, 1 << 20):
        s = _BgzfStream(bam)
        got = []
        c = 0
        while True:
            bl, nxt = s.blocks_run(c, max_bytes)
            if nxt == c:
                break
            got.extend(bl)
            c = nxt
        assert b"".join(d for _, d in got) == whole, max_bytes
        assert [o for o, _ in got] == [o for o, _ in blocks], max_bytes
