"""SAM/BAM ingestion without pysam: text SAM parser, BGZF/BAM binary
reader, mate pairing, and strand-rule filtering.

Capability parity with misopy/sam_utils.py (load/fetch/pair/strand/parse);
pysam is replaced by a from-scratch reader:

- SAM text: direct field parsing.
- BAM: BGZF block decompression (zlib raw deflate per RFC/SAM spec) + the
  BAM binary alignment encoding.
- Region fetches are O(region), not O(file): `IndexedBamReader` parses
  the standard `.bai` binning/linear index (the same structure pysam
  uses for the reference's fetches, sam_utils.py:154-181) and
  decompresses only the BGZF blocks a region's chunks cover, so
  genome-scale BAMs never need to fit in RAM.  If no `.bai` exists, one
  is built by a single streaming pass and persisted next to the BAM
  (samtools-compatible); if the directory is read-only, the built index
  is kept in memory for the reader's lifetime instead.

Positions are 0-based here (as in pysam); the pipeline shifts +1 before
matching, mirroring misopy/miso_sampler.py:284.
"""
from __future__ import annotations

import gzip
import os
import struct
import zlib
from dataclasses import dataclass
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

# flag bits (SAM spec)
FPAIRED = 0x1
FPROPER = 0x2
FUNMAP = 0x4
FMUNMAP = 0x8
FREVERSE = 0x10
FMREVERSE = 0x20
FREAD1 = 0x40
FREAD2 = 0x80
FSECONDARY = 0x100
FSUPPLEMENTARY = 0x800
FQCFAIL = 0x200
FDUP = 0x400

_BAM_CIGAR_OPS = "MIDNSHP=X"
_BAM_SEQ_CODES = "=ACMGRSVTWYHKDBN"


@dataclass(slots=True)
class AlignedRead:
    """Minimal aligned-read record (pysam.AlignedRead surface subset).
    Slotted: readers materialize millions of these on genome-scale
    catalogs."""

    qname: str
    flag: int
    rname: str          # reference (chromosome) name, "*" if unmapped
    pos: int            # 0-based leftmost position
    mapq: int
    cigar_str: str      # "*" if absent
    rlen: int           # query sequence length

    @property
    def is_paired(self) -> bool:
        return bool(self.flag & FPAIRED)

    @property
    def is_unmapped(self) -> bool:
        return bool(self.flag & FUNMAP)

    @property
    def mate_is_unmapped(self) -> bool:
        return bool(self.flag & FMUNMAP)

    @property
    def is_qcfail(self) -> bool:
        return bool(self.flag & FQCFAIL)

    @property
    def is_reverse(self) -> bool:
        return bool(self.flag & FREVERSE)

    @property
    def is_read1(self) -> bool:
        return bool(self.flag & FREAD1)

    @property
    def is_read2(self) -> bool:
        return bool(self.flag & FREAD2)

    @property
    def cigar(self) -> Optional[str]:
        return None if self.cigar_str in ("*", "") else self.cigar_str


def flag_to_strand(flag: int) -> str:
    """Ref: misopy/sam_utils.py:184-191."""
    return "-" if flag & FREVERSE else "+"


def strip_mate_id(read_name: str) -> str:
    """Ref: misopy/sam_utils.py:194-207."""
    if read_name.endswith(("/1", "/2", "#1", "#2")):
        return read_name[:-2]
    return read_name


# ----------------------------------------------------------------- SAM text

def _cigar_query_len(cigar: str) -> int:
    n = 0
    num = ""
    for ch in cigar:
        if ch.isdigit():
            num += ch
        else:
            if ch in "MIS=X":
                n += int(num)
            num = ""
    return n


def read_sam_text(path_or_lines) -> Iterator[AlignedRead]:
    if isinstance(path_or_lines, str):
        opener = gzip.open if path_or_lines.endswith(".gz") else open
        f = opener(path_or_lines, "rt")
        lines: Iterable[str] = f
    else:
        f = None
        lines = path_or_lines
    try:
        for line in lines:
            if line.startswith("@") or not line.strip():
                continue
            fields = line.rstrip("\n").split("\t")
            if len(fields) < 11:
                continue
            seq = fields[9]
            cigar = fields[5]
            rlen = len(seq) if seq != "*" else (
                _cigar_query_len(cigar) if cigar != "*" else 0)
            yield AlignedRead(
                qname=fields[0], flag=int(fields[1]), rname=fields[2],
                pos=int(fields[3]) - 1, mapq=int(fields[4]),
                cigar_str=cigar, rlen=rlen)
    finally:
        if f is not None:
            f.close()


# --------------------------------------------------------------------- BGZF

def _bgzf_blocks(raw: bytes) -> Iterator[bytes]:
    """Decompress a BGZF (blocked gzip) byte stream."""
    pos = 0
    n = len(raw)
    while pos < n:
        if raw[pos:pos + 2] != b"\x1f\x8b":
            raise ValueError("Not a BGZF/gzip stream at offset %d" % pos)
        xlen = struct.unpack_from("<H", raw, pos + 10)[0]
        extra = raw[pos + 12:pos + 12 + xlen]
        bsize = None
        epos = 0
        while epos < len(extra):
            si1, si2, slen = struct.unpack_from("<BBH", extra, epos)
            if si1 == 66 and si2 == 67:  # 'BC'
                bsize = struct.unpack_from("<H", extra, epos + 4)[0] + 1
            epos += 4 + slen
        if bsize is None:
            # plain gzip member (not BGZF) -- decompress the rest at once
            yield zlib.decompress(raw[pos:], wbits=31)
            return
        cdata = raw[pos + 12 + xlen:pos + bsize - 8]
        yield zlib.decompress(cdata, wbits=-15)
        pos += bsize


def bgzf_decompress(path: str) -> bytes:
    with open(path, "rb") as f:
        raw = f.read()
    return b"".join(_bgzf_blocks(raw))


def bgzf_compress(data: bytes, level: int = 6) -> bytes:
    """Write BGZF blocks (max 64KB uncompressed each) + EOF block."""
    out = []
    MAXB = 65280
    for off in range(0, len(data), MAXB):
        chunk = data[off:off + MAXB]
        co = zlib.compressobj(level, zlib.DEFLATED, -15)
        cdata = co.compress(chunk) + co.flush()
        bsize = len(cdata) + 25 + 1
        header = (b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff" +
                  struct.pack("<H", 6) + b"BC" + struct.pack("<HH", 2, bsize - 1))
        out.append(header + cdata +
                   struct.pack("<II", zlib.crc32(chunk) & 0xFFFFFFFF,
                               len(chunk)))
    # EOF marker block
    out.append(bytes.fromhex(
        "1f8b08040000000000ff0600424302001b0003000000000000000000"))
    return b"".join(out)


# --------------------------------------------- BGZF random access + .bai
#
# Virtual offsets are (compressed_block_offset << 16 | within_block_offset)
# as in the SAM spec; the .bai reader/writer follows the published BAI
# layout (magic, per-ref binning index + 16kb linear index) so indexes are
# interchangeable with samtools/pysam -- the machinery behind the
# reference's pysam region fetches (misopy/sam_utils.py:154-181).

_BAI_MAGIC = b"BAI\x01"
_LINEAR_SHIFT = 14          # 16 kb linear-index windows
_PSEUDO_BIN = 37450         # samtools metadata pseudo-bin (skipped)


def reg2bin(beg: int, end: int) -> int:
    """Smallest bin containing [beg, end) (SAM spec section 5.3)."""
    end -= 1
    if beg >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (beg >> 26)
    return 0


def reg2bins(beg: int, end: int) -> List[int]:
    """All bins overlapping [beg, end) (SAM spec section 5.3)."""
    end -= 1
    bins = [0]
    for shift, off in ((26, 1), (23, 9), (20, 73), (17, 585), (14, 4681)):
        bins.extend(range(off + (beg >> shift), off + (end >> shift) + 1))
    return bins


def _reg2bin_vec(beg, end):
    """Vectorized reg2bin over (beg, end) arrays (0-based half-open)."""
    import numpy as np
    end = end - 1
    out = np.zeros(beg.shape, np.int64)
    done = np.zeros(beg.shape, bool)
    for shift, off in ((14, 4681), (17, 585), (20, 73), (23, 9), (26, 1)):
        hit = (~done) & ((beg >> shift) == (end >> shift))
        out[hit] = off + (beg[hit] >> shift)
        done |= hit
    return out


_INFLATE_POOL = None


def _inflate_pool():
    """Shared 4-thread pool for parallel BGZF inflation (lazy; zlib
    releases the GIL so threads scale on the scan path)."""
    global _INFLATE_POOL
    if _INFLATE_POOL is None:
        from concurrent.futures import ThreadPoolExecutor
        _INFLATE_POOL = ThreadPoolExecutor(max_workers=4)
    return _INFLATE_POOL


class _BgzfStream:
    """Random-access BGZF block reader: per-thread file handles (region
    fetches run under the host compile thread pool) + a shared LRU cache
    of decompressed blocks."""

    def __init__(self, path: str, cache_blocks: int = 256):
        import collections
        import threading
        self.path = path
        self._local = threading.local()
        self._lock = threading.Lock()
        self._cache: "collections.OrderedDict" = collections.OrderedDict()
        self._cache_blocks = cache_blocks

    def _file(self):
        f = getattr(self._local, "f", None)
        if f is None:
            f = open(self.path, "rb")
            self._local.f = f
        return f

    def block_at(self, coffset: int) -> Tuple[bytes, int]:
        """(decompressed block, next block's coffset); at hard EOF the
        returned next-offset equals `coffset`."""
        with self._lock:
            hit = self._cache.get(coffset)
            if hit is not None:
                self._cache.move_to_end(coffset)
                return hit
        f = self._file()
        f.seek(coffset)
        hdr = f.read(12)
        if len(hdr) < 12:
            return b"", coffset
        if hdr[:2] != b"\x1f\x8b":
            raise ValueError("%s: not BGZF at offset %d"
                             % (self.path, coffset))
        xlen = struct.unpack_from("<H", hdr, 10)[0]
        extra = f.read(xlen)
        bsize = None
        epos = 0
        while epos + 6 <= len(extra):
            si1, si2, slen = struct.unpack_from("<BBH", extra, epos)
            if si1 == 66 and si2 == 67 and slen >= 2:
                bsize = struct.unpack_from("<H", extra, epos + 4)[0] + 1
            epos += 4 + slen
        if bsize is None:
            raise ValueError("%s: missing BGZF BC field" % self.path)
        # every field is from the (untrusted) file: the compressed
        # payload length must be positive, and the decompressed block
        # must respect the spec's 64 KiB bound (a deflate bomb would
        # otherwise expand ~1000x per block)
        clen = bsize - 12 - xlen - 8
        if clen < 0:
            raise ValueError("%s: corrupt BGZF BSIZE at offset %d"
                             % (self.path, coffset))
        cdata = f.read(clen)
        try:
            d = zlib.decompressobj(wbits=-15)
            data = d.decompress(cdata, 1 << 16)
            if d.unconsumed_tail:
                raise ValueError(
                    "%s: BGZF block at offset %d exceeds the 64 KiB "
                    "decompressed bound" % (self.path, coffset))
        except zlib.error as e:
            raise ValueError("%s: corrupt BGZF block at offset %d (%s)"
                             % (self.path, coffset, e)) from None
        out = (data, coffset + bsize)
        with self._lock:
            self._cache[coffset] = out
            while len(self._cache) > self._cache_blocks:
                self._cache.popitem(last=False)
        return out

    def blocks_run(self, coffset: int, max_bytes: int):
        """Decode a RUN of consecutive blocks starting at `coffset`:
        one file read of up to `max_bytes` compressed bytes, headers
        parsed sequentially, payloads inflated on a shared thread pool
        (zlib releases the GIL; whole-chromosome scans were
        single-block-serial and decompression-bound at catalog scale).

        Returns (blocks, next_coffset) where blocks is a list of
        (block_coffset, decompressed_bytes); next_coffset == coffset
        signals EOF.  Bypasses the LRU cache -- scans touch each block
        exactly once."""
        f = self._file()
        f.seek(coffset)
        raw = f.read(max_bytes)
        n = len(raw)
        metas = []  # (block offset within raw, cdata slice)
        pos = 0
        while pos + 12 <= n:
            if raw[pos:pos + 2] != b"\x1f\x8b":
                raise ValueError("%s: not BGZF at offset %d"
                                 % (self.path, coffset + pos))
            xlen = struct.unpack_from("<H", raw, pos + 10)[0]
            if pos + 12 + xlen > n:
                break
            extra = raw[pos + 12:pos + 12 + xlen]
            bsize = None
            epos = 0
            while epos + 6 <= len(extra):
                si1, si2, slen = struct.unpack_from("<BBH", extra, epos)
                if si1 == 66 and si2 == 67 and slen >= 2:
                    bsize = struct.unpack_from("<H", extra, epos + 4)[0] + 1
                epos += 4 + slen
            if bsize is None:
                raise ValueError("%s: missing BGZF BC field" % self.path)
            clen = bsize - 12 - xlen - 8
            if clen < 0:
                raise ValueError("%s: corrupt BGZF BSIZE at offset %d"
                                 % (self.path, coffset + pos))
            if pos + bsize > n:
                break  # partial block at the window edge
            cstart = pos + 12 + xlen
            metas.append((pos, raw[cstart:cstart + clen]))
            pos += bsize
        if not metas:
            # EOF, or a block larger than max_bytes: single-block path
            data, nxt = self.block_at(coffset)
            return ([(coffset, data)] if nxt != coffset else []), nxt

        def inflate(cdatas):
            out = []
            for cdata in cdatas:
                try:
                    d = zlib.decompressobj(wbits=-15)
                    data = d.decompress(cdata, 1 << 16)
                    if d.unconsumed_tail:
                        raise ValueError(
                            "%s: BGZF block exceeds the 64 KiB "
                            "decompressed bound" % self.path)
                    out.append(data)
                except zlib.error as e:
                    raise ValueError("%s: corrupt BGZF block (%s)"
                                     % (self.path, e)) from None
            return out

        # a handful of contiguous groups, not one task per 64 KiB block:
        # per-future overhead would otherwise eat the parallel win
        if len(metas) < 8:
            datas = inflate([m[1] for m in metas])
        else:
            pool = _inflate_pool()
            step = (len(metas) + 3) // 4
            groups = [[m[1] for m in metas[i:i + step]]
                      for i in range(0, len(metas), step)]
            datas = [d for grp in pool.map(inflate, groups) for d in grp]
        return ([(coffset + m[0], d) for m, d in zip(metas, datas)],
                coffset + pos)


class _BgzfCursor:
    """Sequential byte reader over BGZF blocks, tracking the virtual
    offset of the next unconsumed byte (`vpos`)."""

    def __init__(self, stream: _BgzfStream, voffset: int = 0):
        import collections
        self._s = stream
        self._next_c = voffset >> 16
        self._skip = voffset & 0xFFFF
        self._segs: "collections.deque" = collections.deque()
        self._avail = 0

    def _fill(self) -> bool:
        data, nxt = self._s.block_at(self._next_c)
        if nxt == self._next_c:
            return False
        if data:
            off = min(self._skip, len(data))
            self._skip = 0
            if off < len(data):
                self._segs.append([self._next_c, data, off])
                self._avail += len(data) - off
        self._next_c = nxt
        return True

    @property
    def vpos(self) -> int:
        while not self._segs:
            if not self._fill():
                return self._next_c << 16
        c, d, o = self._segs[0]
        return (c << 16) | o

    def take(self, n: int) -> Optional[bytes]:
        if n < 0:  # a negative length from a corrupt size field
            return None
        while self._avail < n:
            if not self._fill():
                return None
        parts = []
        need = n
        while need:
            c, d, o = self._segs[0]
            m = min(need, len(d) - o)
            parts.append(d[o:o + m])
            need -= m
            self._avail -= m
            if o + m == len(d):
                self._segs.popleft()
            else:
                self._segs[0][2] = o + m
        return b"".join(parts)


class BaiIndex:
    """Standard .bai: per reference a bin -> [(vbeg, vend)] chunk map and
    a 16kb-window linear index of minimum virtual offsets."""

    def __init__(self, bins: List[Dict[int, List[Tuple[int, int]]]],
                 linear: List[List[int]]):
        self.bins = bins
        self.linear = linear

    @classmethod
    def read(cls, path: str) -> "BaiIndex":
        with open(path, "rb") as f:
            raw = f.read()
        if raw[:4] != _BAI_MAGIC:
            raise ValueError("%s: not a BAI index" % path)
        try:
            n_ref = struct.unpack_from("<i", raw, 4)[0]
            off = 8
            bins, linear = [], []
            if n_ref < 0:
                raise ValueError("%s: negative n_ref" % path)
            for _ in range(n_ref):
                n_bin = struct.unpack_from("<i", raw, off)[0]
                off += 4
                bmap: Dict[int, List[Tuple[int, int]]] = {}
                for _ in range(max(n_bin, 0)):
                    b, n_chunk = struct.unpack_from("<Ii", raw, off)
                    off += 8
                    chunks = []
                    for _ in range(max(n_chunk, 0)):
                        cb, ce = struct.unpack_from("<QQ", raw, off)
                        off += 16
                        chunks.append((cb, ce))
                    if b != _PSEUDO_BIN:
                        bmap[b] = chunks
                n_intv = struct.unpack_from("<i", raw, off)[0]
                off += 4
                lin = list(struct.unpack_from("<%dQ" % max(n_intv, 0),
                                              raw, off))
                off += 8 * max(n_intv, 0)
                bins.append(bmap)
                linear.append(lin)
        except struct.error:
            raise ValueError("%s: truncated or corrupt BAI index"
                             % path) from None
        return cls(bins, linear)

    def write(self, path: str) -> None:
        out = [_BAI_MAGIC, struct.pack("<i", len(self.bins))]
        for bmap, lin in zip(self.bins, self.linear):
            out.append(struct.pack("<i", len(bmap)))
            for b in sorted(bmap):
                chunks = bmap[b]
                out.append(struct.pack("<Ii", b, len(chunks)))
                for cb, ce in chunks:
                    out.append(struct.pack("<QQ", cb, ce))
            out.append(struct.pack("<i", len(lin)))
            out.append(struct.pack("<%dQ" % len(lin), *lin))
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(b"".join(out))
        os.replace(tmp, path)

    def min_offset(self, ref_id: int, start: int) -> int:
        lin = self.linear[ref_id] if ref_id < len(self.linear) else []
        w = start >> _LINEAR_SHIFT
        if not lin:
            return 0
        return lin[min(w, len(lin) - 1)]

    def start_voffset(self, ref_id: int, start: int, end: int
                      ) -> Optional[int]:
        """Smallest virtual offset any overlapping record can start at,
        or None if the index proves the region is empty."""
        if ref_id >= len(self.bins):
            return None
        bmap = self.bins[ref_id]
        min_off = self.min_offset(ref_id, start)
        best = None
        for b in reg2bins(start, end):
            for cb, ce in bmap.get(b, ()):
                if ce <= min_off:
                    continue
                cb = max(cb, min_off)
                if best is None or cb < best:
                    best = cb
        return best


class _NativeUnavailable(Exception):
    """Native scanner not built/loadable: fall back to Python decode."""


def _decode_bam_record(rec: bytes, refs: Sequence[str]) -> AlignedRead:
    # every length below comes from the (untrusted) file: validate
    # against the actual record size before slicing
    if len(rec) < 32:
        raise ValueError("truncated BAM record (%d bytes)" % len(rec))
    (ref_id, pos, l_read_name, mapq, _bin, n_cigar_op, flag,
     l_seq, _next_ref, _next_pos, _tlen) = struct.unpack_from(
         "<iiBBHHHiiii", rec, 0)
    if 32 + l_read_name + 4 * n_cigar_op > len(rec):
        raise ValueError("corrupt BAM record: name/CIGAR fields overrun "
                         "the record")
    p = 32
    qname = rec[p:p + l_read_name - 1].decode(errors="replace")
    p += l_read_name
    cigar_ops = struct.unpack_from("<%dI" % n_cigar_op, rec, p)
    cigar = "".join(
        "%d%s" % (op >> 4, _BAM_CIGAR_OPS[op & 0xF])
        for op in cigar_ops) or "*"
    rname = refs[ref_id] if 0 <= ref_id < len(refs) else "*"
    return AlignedRead(qname=qname, flag=flag, rname=rname, pos=pos,
                       mapq=mapq, cigar_str=cigar, rlen=l_seq)


def _bam_record_ref_span(rec: bytes) -> Tuple[int, int, int]:
    """(ref_id, pos, ref_end) decoded from the fixed fields + CIGAR only."""
    if len(rec) < 32:
        raise ValueError("truncated BAM record (%d bytes)" % len(rec))
    ref_id, pos, l_read_name = struct.unpack_from("<iiB", rec, 0)
    n_cigar_op = struct.unpack_from("<H", rec, 12)[0]
    p = 32 + l_read_name
    if p + 4 * n_cigar_op > len(rec):
        raise ValueError("corrupt BAM record: CIGAR overruns the record")
    span = 0
    for op in struct.unpack_from("<%dI" % n_cigar_op, rec, p):
        if (op & 0xF) in (0, 2, 3, 7, 8):  # M D N = X consume reference
            span += op >> 4
    return ref_id, pos, pos + max(span, 1)


class IndexedBamReader:
    """Streaming BAM reader: O(region) fetches via a .bai index; only the
    BGZF blocks a region covers are decompressed, so files need not fit
    in RAM.  Builds and persists a samtools-compatible .bai in one
    streaming pass when none exists."""

    def __init__(self, path: str, index_path: Optional[str] = None,
                 build_missing_index: bool = True):
        self.path = path
        self._bgzf = _BgzfStream(path)
        cur = _BgzfCursor(self._bgzf, 0)
        magic = cur.take(4)
        if magic != b"BAM\x01":
            raise ValueError("%s: not a BAM file" % path)

        def need(n, what):
            # every length below is read from the (untrusted) file;
            # take() returns None on truncation or a negative length
            b = cur.take(n)
            if b is None:
                raise ValueError("%s: truncated or corrupt BAM header "
                                 "(%s)" % (path, what))
            return b

        l_text = struct.unpack("<i", need(4, "l_text"))[0]
        self.header_text = need(l_text, "header text").decode(
            errors="replace")
        n_ref = struct.unpack("<i", need(4, "n_ref"))[0]
        if n_ref < 0:
            raise ValueError("%s: negative n_ref in BAM header" % path)
        self.references: List[str] = []
        self.lengths: List[int] = []
        for _ in range(n_ref):
            l_name = struct.unpack("<i", need(4, "l_name"))[0]
            self.references.append(
                need(l_name, "reference name")[:-1].decode(
                    errors="replace"))
            self.lengths.append(struct.unpack("<i", need(4, "l_ref"))[0])
        self._ref_ids = {n: i for i, n in enumerate(self.references)}
        self._aln_voffset = cur.vpos
        self._index: Optional[BaiIndex] = None
        self._index_path = index_path
        if index_path is None:
            bam_mtime = os.path.getmtime(path)
            for cand in (path + ".bai", os.path.splitext(path)[0] + ".bai"):
                # a .bai older than the BAM is stale: rebuild
                if os.path.isfile(cand) and \
                        os.path.getmtime(cand) >= bam_mtime:
                    self._index_path = cand
                    break
        if self._index_path is not None and os.path.isfile(self._index_path):
            self._index = BaiIndex.read(self._index_path)
        elif build_missing_index:
            self._index = self._build_index()
            try:
                self._index.write(path + ".bai")
            except OSError:
                pass  # read-only location: keep the in-memory index

    def _records_from(self, voffset: int) -> Iterator[bytes]:
        cur = _BgzfCursor(self._bgzf, voffset)
        while True:
            szb = cur.take(4)
            if szb is None:
                return  # clean EOF between records
            size = struct.unpack("<i", szb)[0]
            if size < 32:  # below the fixed-field size: corrupt
                raise ValueError("%s: corrupt BAM record size %d"
                                 % (self.path, size))
            rec = cur.take(size)
            if rec is None:
                raise ValueError("%s: BAM truncated mid-record"
                                 % self.path)
            yield rec

    # ---- native batch decode: windows of BGZF blocks scanned columnar

    def _scan_batches(self, voffset: int, window_target: int = 4 << 20):
        """Yield (BamScan, voffs, buf) windows decoded by the native
        scanner: voffs[i] is record i's start virtual offset and
        voffs[n] the boundary after the last whole record (block-end
        positions map to the next block's start, matching _BgzfCursor).
        Yields nothing if the native library is unavailable."""
        import numpy as np

        from miso_jax import native
        if native.load() is None:
            raise _NativeUnavailable()
        base_target = window_target
        next_c = voffset >> 16
        skip = voffset & 0xFFFF
        chunks: List[bytes] = []  # window assembled by ONE join per
        wlen = 0                  # batch (bytearray extend + bytes()
        starts: List[int] = []    # cost two full copies per window)
        coffs: List[int] = []     # matching compressed offsets
        first = True
        eof = False
        while True:
            while wlen < window_target and not eof:
                # parallel-inflated run of consecutive blocks (one file
                # read + pooled zlib) instead of block-at-a-time
                blocks, nxt = self._bgzf.blocks_run(
                    next_c, window_target - wlen + (1 << 16))
                if nxt == next_c:
                    eof = True
                    break
                for bc, data in blocks:
                    if not data:
                        continue
                    if first:
                        o = min(skip, len(data))
                        # origin may be negative: the block began o
                        # bytes before this window
                        starts.append(wlen - o)
                        coffs.append(bc)
                        chunks.append(data[o:])
                        wlen += len(data) - o
                        first = False
                    else:
                        starts.append(wlen)
                        coffs.append(bc)
                        chunks.append(data)
                        wlen += len(data)
                next_c = nxt
            if wlen == 0:
                return
            buf = chunks[0] if len(chunks) == 1 else b"".join(chunks)
            chunks = [buf]
            scan = native.bam_scan(buf)
            if scan is None:
                raise _NativeUnavailable()
            if scan.n == 0:
                if eof:
                    return
                # one record larger than the window: grow relative to the
                # current window (the carried tail may already exceed the
                # base target) so each retry admits new blocks
                window_target = max(window_target, wlen) * 2
                continue
            starts_arr = np.array(starts + [len(buf)], np.int64)
            coffs_arr = np.array(coffs + [next_c], np.int64)
            offs = np.concatenate([scan.rec_off,
                                   np.array([scan.consumed], np.int64)])
            j = np.searchsorted(starts_arr, offs, side="right") - 1
            voffs = (coffs_arr[j] << 16) | (offs - starts_arr[j])
            yield scan, voffs, buf
            window_target = base_target  # drop any oversized-record growth
            if eof and scan.consumed >= len(buf):
                return
            # carry the tail: keep blocks not fully consumed
            consumed = scan.consumed
            chunks = [buf[consumed:]]
            wlen = len(buf) - consumed
            keep: List[int] = []
            for k, s in enumerate(starts):
                blk_end = starts_arr[k + 1]
                if blk_end > consumed:
                    keep.append(k)
            starts = [starts[k] - consumed for k in keep]
            coffs = [coffs[k] for k in keep]
            if eof and wlen == 0:
                return

    def _read_from_scan(self, scan, buf, i: int) -> AlignedRead:
        qo, ql = scan.qname_off[i], scan.qname_len[i]
        rid = scan.ref_id[i]
        refs = self.references
        return AlignedRead(
            qname=buf[qo:qo + ql].decode(),
            flag=int(scan.flag[i]),
            rname=refs[rid] if 0 <= rid < len(refs) else "*",
            pos=int(scan.pos[i]), mapq=int(scan.mapq[i]),
            cigar_str=scan.cigar_str(i), rlen=int(scan.l_seq[i]))

    def __iter__(self) -> Iterator[AlignedRead]:
        try:
            for scan, _voffs, buf in self._scan_batches(self._aln_voffset):
                for i in range(scan.n):
                    yield self._read_from_scan(scan, buf, i)
        except _NativeUnavailable:
            refs = self.references
            for rec in self._records_from(self._aln_voffset):
                yield _decode_bam_record(rec, refs)

    def _build_index(self) -> BaiIndex:
        """One streaming pass: record (start, end) virtual offsets per
        record into bins + the linear index (the role of `samtools
        index`).  Uses the native columnar scanner (windows of blocks,
        vectorized bin/linear updates) when available -- ~50x the
        per-record Python loop on genome-scale BAMs -- with the Python
        path as fallback; both produce identical .bai bytes
        (tests/test_bam_index.py)."""
        try:
            return self._build_index_native()
        except _NativeUnavailable:
            return self._build_index_py()

    def _build_index_native(self) -> BaiIndex:
        import numpy as np
        n_ref = len(self.references)
        bins: List[Dict[int, List[Tuple[int, int]]]] = [
            {} for _ in range(n_ref)]
        UNSET = np.int64(2 ** 62)
        lin_arrs: List[Optional["np.ndarray"]] = [None] * n_ref
        lin_hi = [-1] * n_ref
        for scan, voffs, _buf in self._scan_batches(self._aln_voffset):
            ref = scan.ref_id.astype(np.int64)
            ok = (ref >= 0) & (ref < n_ref)
            if not ok.any():
                continue
            pos = scan.pos.astype(np.int64)[ok]
            rend = scan.ref_end.astype(np.int64)[ok]
            v0 = voffs[:-1][ok]
            v1 = voffs[1:][ok]
            ref = ref[ok]
            b = _reg2bin_vec(pos, rend)
            # chunk runs: stable order within (ref, bin); a run breaks
            # where the previous member is not file-adjacent
            order = np.lexsort((np.arange(len(ref)), b, ref))
            rs, bs = ref[order], b[order]
            v0s, v1s = v0[order], v1[order]
            brk = np.ones(len(rs), bool)
            if len(rs) > 1:
                brk[1:] = ((rs[1:] != rs[:-1]) | (bs[1:] != bs[:-1])
                           | (v0s[1:] > v1s[:-1]))
            run_start = np.flatnonzero(brk)
            run_end = np.concatenate([run_start[1:] - 1,
                                      np.array([len(rs) - 1])])
            for si, ei in zip(run_start, run_end):
                r, bb = int(rs[si]), int(bs[si])
                c0, c1 = int(v0s[si]), int(v1s[ei])
                chunks = bins[r].setdefault(bb, [])
                if chunks and chunks[-1][1] >= c0:
                    chunks[-1] = (chunks[-1][0], c1)
                else:
                    chunks.append((c0, c1))
            # linear index: lin[w] = min v0 over records covering w
            w_lo = pos >> _LINEAR_SHIFT
            w_hi = (rend - 1) >> _LINEAR_SHIFT
            for r in np.unique(ref):
                m = ref == r
                hi = int(w_hi[m].max())
                r = int(r)
                arr = lin_arrs[r]
                if arr is None or len(arr) <= hi:
                    grown = np.full(max(hi + 1, 64,
                                        0 if arr is None else 2 * len(arr)),
                                    UNSET, np.int64)
                    if arr is not None:
                        grown[:len(arr)] = arr
                    lin_arrs[r] = arr = grown
                lin_hi[r] = max(lin_hi[r], hi)
                lo_r, hi_r = w_lo[m], w_hi[m]
                v_r = v0[m]
                span = hi_r - lo_r
                k = 0
                while True:
                    mm = span >= k
                    if not mm.any():
                        break
                    np.minimum.at(arr, lo_r[mm] + k, v_r[mm])
                    k += 1
        linear: List[List[int]] = []
        for r in range(n_ref):
            arr, hi = lin_arrs[r], lin_hi[r]
            if arr is None:
                linear.append([])
                continue
            lin = arr[:hi + 1].copy()
            unset = lin >= UNSET
            lin[unset] = 0
            out = lin.tolist()
            prev = 0
            for i, v in enumerate(out):   # fill-forward, as the Python
                if v == 0:                # builder does
                    out[i] = prev
                else:
                    prev = v
            linear.append(out)
        return BaiIndex(bins, linear)

    def _build_index_py(self) -> BaiIndex:
        n_ref = len(self.references)
        bins: List[Dict[int, List[Tuple[int, int]]]] = [
            {} for _ in range(n_ref)]
        linear: List[List[int]] = [[] for _ in range(n_ref)]
        cur = _BgzfCursor(self._bgzf, self._aln_voffset)
        while True:
            v0 = cur.vpos
            szb = cur.take(4)
            if szb is None:
                break
            rec = cur.take(struct.unpack("<i", szb)[0])
            if rec is None:
                break
            v1 = cur.vpos
            ref_id, pos, ref_end = _bam_record_ref_span(rec)
            if ref_id < 0 or ref_id >= n_ref:
                continue
            b = reg2bin(pos, ref_end)
            chunks = bins[ref_id].setdefault(b, [])
            if chunks and chunks[-1][1] >= v0:
                chunks[-1] = (chunks[-1][0], v1)  # merge adjacent
            else:
                chunks.append((v0, v1))
            lin = linear[ref_id]
            w_hi = (ref_end - 1) >> _LINEAR_SHIFT
            if len(lin) <= w_hi:
                lin.extend([0] * (w_hi + 1 - len(lin)))
            for w in range(pos >> _LINEAR_SHIFT, w_hi + 1):
                if lin[w] == 0 or v0 < lin[w]:
                    lin[w] = v0
        for lin in linear:  # fill empty windows with the previous offset
            prev = 0
            for i, v in enumerate(lin):
                if v == 0:
                    lin[i] = prev
                else:
                    prev = v
        return BaiIndex(bins, linear)

    def fetch(self, chrom: str, start: int, end: int
              ) -> Iterator[AlignedRead]:
        """Region fetch (0-based half-open): stream records from the
        index's start offset, stop at the first record past `end`
        (coordinate-sorted input, as the reference requires)."""
        if end <= start:
            return
        tid = self._ref_ids.get(chrom)
        if tid is None:
            raise KeyError(chrom)
        assert self._index is not None
        v0 = self._index.start_voffset(tid, start, end)
        if v0 is None:
            return
        try:
            import numpy as np
            # one block per window: a region fetch must touch only the
            # blocks the region covers (O(region) property)
            for scan, _voffs, buf in self._scan_batches(v0,
                                                        window_target=1):
                ref = scan.ref_id
                # stop at the first record past the region or chromosome
                # (coordinate-sorted input, as the reference requires)
                halt = np.flatnonzero(
                    (ref > tid) | (ref < 0)
                    | ((ref == tid) & (scan.pos >= end)))
                stop = int(halt[0]) if halt.size else scan.n
                # skip placed-unmapped records (FLAG 0x4 with RNAME/POS
                # copied from the mapped mate), as the in-memory
                # reader's _RegionIndex does
                sel = np.flatnonzero((ref[:stop] == tid)
                                     & (scan.ref_end[:stop] > start)
                                     & ((scan.flag[:stop] & FUNMAP) == 0))
                for i in sel:
                    yield self._read_from_scan(scan, buf, int(i))
                if stop < scan.n:
                    return
        except _NativeUnavailable:
            refs = self.references
            for rec in self._records_from(v0):
                ref_id, pos, ref_end = _bam_record_ref_span(rec)
                if ref_id != tid:
                    if ref_id > tid or ref_id < 0:
                        return
                    continue
                if pos >= end:
                    return
                if ref_end > start:
                    read = _decode_bam_record(rec, refs)
                    if not read.is_unmapped:
                        yield read

    def fetch_columnar(self, chrom: str, start: int, end: int,
                       given_read_len: Optional[int] = None,
                       strand_rule: Optional[str] = None,
                       target_strand: Optional[str] = None):
        """Single-end ingest fast path: (positions, cigars, num_reads)
        for the region, skipping AlignedRead construction entirely.
        Matches sam_parse_reads(single-end) exactly: records with no
        CIGAR ('*') or a mismatched read length are dropped, and
        fr-firststrand keeps only reads on `target_strand`
        (read_matches_strand semantics, sam_utils.py:313-350).  Returns
        None when the native scanner is unavailable (callers fall back
        to fetch + sam_parse_reads)."""
        import numpy as np
        if end <= start:
            return (), (), 0
        check_strand = _validate_strand_rule(strand_rule, target_strand)
        tid = self._ref_ids.get(chrom)
        if tid is None:
            raise KeyError(chrom)
        assert self._index is not None
        v0 = self._index.start_voffset(tid, start, end)
        if v0 is None:
            return (), (), 0
        positions: List[int] = []
        cigars: List[str] = []
        try:
            for scan, _voffs, _buf in self._scan_batches(v0,
                                                         window_target=1):
                ref = scan.ref_id
                halt = np.flatnonzero(
                    (ref > tid) | (ref < 0)
                    | ((ref == tid) & (scan.pos >= end)))
                stop = int(halt[0]) if halt.size else scan.n
                sel = ((ref[:stop] == tid) & (scan.ref_end[:stop] > start)
                       & ((scan.flag[:stop] & FUNMAP) == 0))
                if given_read_len is not None:
                    sel &= scan.l_seq[:stop] == given_read_len
                if check_strand:
                    rev = (scan.flag[:stop] & FREVERSE) != 0
                    sel &= rev if target_strand == "-" else ~rev
                co = scan.cigar_off
                cbuf = scan.cigar_buf
                for i in np.flatnonzero(sel):
                    cg = cbuf[co[i]:co[i + 1] - 1]  # strings NUL-packed
                    if cg == b"*":
                        continue
                    positions.append(int(scan.pos[i]))
                    cigars.append(cg.decode())
                if stop < scan.n:
                    break
        except _NativeUnavailable:
            return None
        return tuple(positions), tuple(cigars), len(positions)

    def _scan_paired_columnar(self, tid: int, start: int, end: int,
                              window_target: Optional[int] = None,
                              exclude_secondary: bool = False):
        """Shared paired-scan accumulation for the region and
        whole-chromosome paths: columnar (pos, ref_end, flag, l_seq)
        plus COMPACT packed qname and CIGAR buffers (window buffers are
        released as soon as their qname bytes are gathered -- a deep
        chromosome never pins its raw record bytes).  Returns a dict of
        arrays, or raises _NativeUnavailable."""
        import numpy as np
        assert self._index is not None
        v0 = self._index.start_voffset(tid, start, end)
        cols = {k: [] for k in ("pos", "ref_end", "flag", "lseq",
                                "qoff", "qlen", "coff", "clen")}
        qparts: List[bytes] = []
        cbufs: List[bytes] = []
        qbase = cbase = 0
        if v0 is not None:
            kw = ({} if window_target is None
                  else {"window_target": window_target})
            drop = FUNMAP | FMUNMAP | FQCFAIL
            if exclude_secondary:
                drop |= FSECONDARY | FSUPPLEMENTARY
            for scan, _voffs, buf in self._scan_batches(v0, **kw):
                ref = scan.ref_id
                halt = np.flatnonzero(
                    (ref > tid) | (ref < 0)
                    | ((ref == tid) & (scan.pos >= end)))
                stop = int(halt[0]) if halt.size else scan.n
                fl = scan.flag[:stop]
                sel = ((ref[:stop] == tid) & (scan.ref_end[:stop] > start)
                       & ((fl & drop) == 0) & ((fl & FPAIRED) != 0))
                idxs = np.flatnonzero(sel)
                cols["pos"].append(scan.pos[idxs].astype(np.int64))
                cols["ref_end"].append(scan.ref_end[idxs].astype(np.int64))
                cols["flag"].append(fl[idxs])
                cols["lseq"].append(scan.l_seq[idxs])
                qb, qo = _gather_byte_ranges(buf, scan.qname_off[idxs],
                                             scan.qname_len[idxs])
                qparts.append(qb)
                cols["qoff"].append(qo + qbase)
                cols["qlen"].append(scan.qname_len[idxs])
                co = scan.cigar_off
                cols["coff"].append(co[idxs] + cbase)
                cols["clen"].append(co[idxs + 1] - co[idxs] - 1)  # no NUL
                cbufs.append(scan.cigar_buf)
                qbase += len(qb)
                cbase += len(scan.cigar_buf)
                if stop < scan.n:
                    break
        if not cols["pos"]:
            return None
        d = {k: np.concatenate(v) for k, v in cols.items()}
        d["qbuf"] = b"".join(qparts)
        d["cbuf"] = b"".join(cbufs)
        return d

    @staticmethod
    def _pair_columnar(d: dict, strand_rule: Optional[str],
                       given_read_len: Optional[int]):
        """Shared mate pairing + filters over _scan_paired_columnar
        output: native qname hash pairing, same-strand and '*'-CIGAR
        drops, read-length filter, fr-firststrand forward-mate-first
        reorder.  Returns (first, second) index arrays (None when the
        native pairer is unavailable)."""
        import numpy as np

        from miso_jax import native
        partner = native.pair_qnames(d["qbuf"], d["qoff"], d["qlen"])
        if partner is None:
            return None
        flag, coff, clen, lseq = (d["flag"], d["coff"], d["clen"],
                                  d["lseq"])
        first = np.flatnonzero(partner > np.arange(len(partner)))
        second = partner[first]
        rev1 = (flag[first] & FREVERSE) != 0
        rev2 = (flag[second] & FREVERSE) != 0
        keep = rev1 != rev2  # drop same-strand pairs
        cb = np.frombuffer(d["cbuf"], np.uint8)
        if len(cb):  # drop pairs with a '*' CIGAR mate
            keep &= ~((clen[first] == 1) & (cb[coff[first]] == 0x2A))
            keep &= ~((clen[second] == 1) & (cb[coff[second]] == 0x2A))
        if given_read_len is not None:
            keep &= ((lseq[first] == given_read_len)
                     & (lseq[second] == given_read_len))
        first, second, rev1 = first[keep], second[keep], rev1[keep]
        if strand_rule == "fr-firststrand":
            # forward-strand mate first (the reference's two-swap
            # composition, see pair_sam_reads)
            first, second = (np.where(rev1, second, first),
                             np.where(rev1, first, second))
        return first, second

    def fetch_columnar_paired(self, chrom: str, start: int, end: int,
                              given_read_len: Optional[int] = None,
                              strand_rule: Optional[str] = None,
                              target_strand: Optional[str] = None):
        """Paired-end ingest fast path: mates are paired by qname in
        C++ (native.pair_qnames) over the columnar scan -- no per-read
        Python objects, no Python dict.  Returns (positions, cigars,
        num_pairs) with mates interleaved (2r, 2r+1), exactly matching
        sam_parse_reads(paired_end=True):

        - qcfail / unmapped / mate-unmapped / non-paired records never
          pair (pair_sam_reads filter_reads, sam_utils.py:218-226);
        - only names seen exactly twice pair (dict semantics);
        - same-strand pairs are dropped (sam_utils.py:276-283);
        - fr-firststrand puts the forward-strand mate first (the
          reference's two-swap composition, see pair_sam_reads), after
          which the reference's strand check passes every surviving
          pair; otherwise mates keep file (first-seen) order;
        - pairs with a '*' CIGAR or a mismatched read length drop.

        Returns None when the native scanner/pairer is unavailable.
        """
        import numpy as np
        if end <= start:
            return (), (), 0
        # same validation as the Python fallback: unknown rules (and
        # fr-secondstrand) must error identically on both paths
        _validate_strand_rule(strand_rule, target_strand)
        tid = self._ref_ids.get(chrom)
        if tid is None:
            raise KeyError(chrom)
        try:
            d = self._scan_paired_columnar(tid, start, end,
                                           window_target=1)
        except _NativeUnavailable:
            return None
        if d is None:
            return (), (), 0
        pair = self._pair_columnar(d, strand_rule, given_read_len)
        if pair is None:
            return None
        first, second = pair
        n_pairs = len(first)
        inter = np.empty(2 * n_pairs, np.int64)
        inter[0::2] = first
        inter[1::2] = second
        cbuf = d["cbuf"]
        positions = tuple(int(x) for x in d["pos"][inter])
        cigars = tuple(cbuf[o:o + l].decode()
                       for o, l in zip(d["coff"][inter],
                                       d["clen"][inter]))
        return positions, cigars, n_pairs

    def scan_chrom_columnar_paired(self, chrom: str,
                                   given_read_len: Optional[int] = None,
                                   strand_rule: Optional[str] = None,
                                   target_strand: Optional[str] = None
                                   ) -> Optional["ChromPairs"]:
        """ONE streaming decode + ONE native qname-pairing pass for a
        whole chromosome; per-gene paired region fetches then become
        vectorized slices (ChromPairs.slice).  Catalog-scale paired
        ingest analogue of scan_chrom_columnar.

        Two deliberate scope differences from fetch_columnar_paired:

        - pairing scope is the CHROMOSOME, not the region: for a read
          name with exactly two same-chromosome primary records the
          results are identical (a pair only surfaces from a region
          containing both mates); they differ only for names with 3+
          candidate records of which exactly 2 fall inside a region;
        - secondary/supplementary alignments (FLAG 0x100/0x800) are
          excluded BEFORE pairing, so a multimapper's extra records
          elsewhere on the chromosome cannot break its primary pair --
          the region path (and the reference) would let an in-region
          secondary poison the name count instead.

        Returns None when the native scanner/pairer is unavailable."""
        _validate_strand_rule(strand_rule, target_strand)
        tid = self._ref_ids.get(chrom)
        if tid is None:
            raise KeyError(chrom)
        # chromosome length bounds the bin enumeration in the index
        # lookup (reg2bins over a huge range is minutes of Python)
        clen = self.lengths[tid] if self.lengths[tid] > 0 else (1 << 31)
        try:
            d = self._scan_paired_columnar(tid, 0, clen,
                                           exclude_secondary=True)
        except _NativeUnavailable:
            return None
        if d is None:
            return ChromPairs.empty()
        pair = self._pair_columnar(d, strand_rule, given_read_len)
        if pair is None:
            return None
        first, second = pair
        pos, ref_end = d["pos"], d["ref_end"]
        return ChromPairs(
            p1=pos[first], e1=ref_end[first],
            p2=pos[second], e2=ref_end[second],
            co1=d["coff"][first], cl1=d["clen"][first],
            co2=d["coff"][second], cl2=d["clen"][second],
            cigar_buf=d["cbuf"])

    def scan_chrom_columnar(self, chrom: str,
                            given_read_len: Optional[int] = None,
                            strand_rule: Optional[str] = None,
                            target_strand: Optional[str] = None
                            ) -> Optional["ChromReads"]:
        """ONE streaming decode of a whole chromosome into columnar
        arrays, for catalog-scale ingest: per-gene region fetches then
        become vectorized array slices (ChromReads.slice) instead of
        repeated block decompress + scan passes.  Filters match
        fetch_columnar exactly.  Returns None when the native scanner
        is unavailable."""
        import numpy as np
        check_strand = _validate_strand_rule(strand_rule, target_strand)
        tid = self._ref_ids.get(chrom)
        if tid is None:
            raise KeyError(chrom)
        assert self._index is not None
        clen = self.lengths[tid] if self.lengths[tid] > 0 else (1 << 31)
        v0 = self._index.start_voffset(tid, 0, clen)
        empty = ChromReads(np.zeros(0, np.int64), np.zeros(0, np.int64),
                           b"", np.zeros(0, np.int64))
        if v0 is None:
            return empty
        pos_l: List[np.ndarray] = []
        end_l: List[np.ndarray] = []
        off_l: List[np.ndarray] = []
        buf_l: List[bytes] = []
        base = 0
        try:
            for scan, _voffs, _buf in self._scan_batches(v0):
                ref = scan.ref_id
                halt = np.flatnonzero((ref > tid) | (ref < 0))
                stop = int(halt[0]) if halt.size else scan.n
                sel = ((ref[:stop] == tid)
                       & ((scan.flag[:stop] & FUNMAP) == 0))
                if given_read_len is not None:
                    sel &= scan.l_seq[:stop] == given_read_len
                if check_strand:
                    rev = (scan.flag[:stop] & FREVERSE) != 0
                    sel &= rev if target_strand == "-" else ~rev
                co = scan.cigar_off
                # drop '*' CIGARs ("*\0" entries) vectorized
                cb = np.frombuffer(scan.cigar_buf, np.uint8)
                if cb.size:
                    sel &= ~((co[1:stop + 1] - co[:stop] == 2)
                             & (cb[co[:stop]] == 0x2A))
                idxs = np.flatnonzero(sel)
                pos_l.append(scan.pos[idxs].astype(np.int64))
                end_l.append(scan.ref_end[idxs].astype(np.int64))
                off_l.append(co[idxs] + base)
                buf_l.append(scan.cigar_buf)
                base += len(scan.cigar_buf)
                if stop < scan.n:
                    break
        except _NativeUnavailable:
            return None
        if not pos_l:
            return empty
        return ChromReads(np.concatenate(pos_l), np.concatenate(end_l),
                          b"".join(buf_l), np.concatenate(off_l))


class ChromPairs:
    """A chromosome's mate pairs as columnar arrays, ordered by leftmost
    mate position; `slice` reproduces a paired region fetch (both mates
    must overlap the region, fetch_columnar_paired semantics) as binary
    searches + a mask."""

    __slots__ = ("p1", "e1", "p2", "e2", "co1", "cl1", "co2", "cl2",
                 "cigar_buf", "pmin", "max_span")

    def __init__(self, p1, e1, p2, e2, co1, cl1, co2, cl2,
                 cigar_buf: bytes):
        import numpy as np
        pmin = np.minimum(p1, p2)
        order = np.argsort(pmin, kind="stable")
        self.p1, self.e1 = p1[order], e1[order]
        self.p2, self.e2 = p2[order], e2[order]
        self.co1, self.cl1 = co1[order], cl1[order]
        self.co2, self.cl2 = co2[order], cl2[order]
        self.cigar_buf = cigar_buf
        self.pmin = pmin[order]
        spans = 1
        if len(p1):
            spans = int(max((e1 - p1).max(), (e2 - p2).max()))
        self.max_span = spans

    @classmethod
    def empty(cls) -> "ChromPairs":
        import numpy as np
        z = np.zeros(0, np.int64)
        return cls(z, z, z, z, z, z, z, z, b"")

    def slice(self, start: int, end: int):
        """(positions, cigars, n_pairs) with mates interleaved for the
        0-based half-open region."""
        import numpy as np
        i0 = int(np.searchsorted(self.pmin, start - self.max_span + 1,
                                 "left"))
        i1 = int(np.searchsorted(self.pmin, end, "left"))
        sl = slice(i0, i1)
        m = ((self.p1[sl] < end) & (self.e1[sl] > start)
             & (self.p2[sl] < end) & (self.e2[sl] > start))
        idx = i0 + np.flatnonzero(m)
        n_pairs = len(idx)
        inter_pos = np.empty(2 * n_pairs, np.int64)
        inter_pos[0::2] = self.p1[idx]
        inter_pos[1::2] = self.p2[idx]
        co = np.empty(2 * n_pairs, np.int64)
        co[0::2] = self.co1[idx]
        co[1::2] = self.co2[idx]
        cl = np.empty(2 * n_pairs, np.int64)
        cl[0::2] = self.cl1[idx]
        cl[1::2] = self.cl2[idx]
        buf = self.cigar_buf
        cigars = tuple(buf[o:o + l].decode() for o, l in zip(co, cl))
        return tuple(int(x) for x in inter_pos), cigars, n_pairs


class ChromReads:
    """A chromosome's reads as columnar arrays (positions sorted, as in
    a coordinate-sorted BAM) with CIGARs in one packed NUL-terminated
    buffer.  `slice` reproduces an indexed region fetch as two binary
    searches + a mask -- no file IO, no per-read objects."""

    __slots__ = ("pos", "ref_end", "cigar_buf", "cigar_off", "max_span")

    def __init__(self, pos, ref_end, cigar_buf: bytes, cigar_off):
        self.pos = pos
        self.ref_end = ref_end
        self.cigar_buf = cigar_buf
        self.cigar_off = cigar_off
        self.max_span = int((ref_end - pos).max()) if len(pos) else 1

    def slice(self, start: int, end: int):
        """(positions, PackedCigars, n) for the 0-based half-open
        region, matching fetch_columnar's selection exactly
        (pos < end and ref_end > start)."""
        import numpy as np

        from miso_jax.core.matching import PackedCigars
        i0 = int(np.searchsorted(self.pos, start - self.max_span + 1,
                                 "left"))
        i1 = int(np.searchsorted(self.pos, end, "left"))
        m = self.ref_end[i0:i1] > start
        idx = (np.arange(i0, i1) if m.all()
               else i0 + np.flatnonzero(m))
        return (self.pos[idx],
                PackedCigars(self.cigar_buf, self.cigar_off[idx]),
                len(idx))


# ---------------------------------------------------------------------- BAM

class _RegionIndex:
    """In-memory positional index: per-chromosome read lists sorted by
    start, with a running max of reference end positions so region
    fetches are O(log n + hits) -- the role pysam's .bai index plays in
    the reference (sam_utils.py:154-181), without needing the file."""

    def __init__(self, reads: List[AlignedRead]):
        import bisect
        self._bisect = bisect
        self.by_chrom: dict = {}
        for r in reads:
            if r.rname == "*" or r.is_unmapped:
                continue
            self.by_chrom.setdefault(r.rname, []).append(r)
        self._starts: dict = {}
        self._maxend: dict = {}
        for chrom, rs in self.by_chrom.items():
            rs.sort(key=lambda r: r.pos)
            starts = [r.pos for r in rs]
            maxend = []
            cur = -1
            for r in rs:
                cur = max(cur, r.pos + _cigar_ref_len(r.cigar_str))
                maxend.append(cur)
            self._starts[chrom] = starts
            self._maxend[chrom] = maxend

    def fetch(self, chrom: str, start: int, end: int):
        rs = self.by_chrom.get(chrom)
        if not rs:
            return
        starts = self._starts[chrom]
        maxend = self._maxend[chrom]
        # first read whose running max end exceeds `start`
        lo = self._bisect.bisect_right(maxend, start)
        hi = self._bisect.bisect_left(starts, end)
        for i in range(lo, hi):
            r = rs[i]
            if r.pos + _cigar_ref_len(r.cigar_str) > start:
                yield r


class BamReader:
    """Whole-file BAM reader (BGZF + BAM binary records) with an
    in-memory region index built on first fetch."""

    def __init__(self, path: str):
        self.path = path
        data = bgzf_decompress(path)
        if data[:4] != b"BAM\x01":
            raise ValueError("%s: not a BAM file" % path)
        l_text = struct.unpack_from("<i", data, 4)[0]
        off = 8 + l_text
        n_ref = struct.unpack_from("<i", data, off)[0]
        off += 4
        self.references: List[str] = []
        self.lengths: List[int] = []
        for _ in range(n_ref):
            l_name = struct.unpack_from("<i", data, off)[0]
            name = data[off + 4:off + 4 + l_name - 1].decode()
            l_ref = struct.unpack_from("<i", data, off + 4 + l_name)[0]
            self.references.append(name)
            self.lengths.append(l_ref)
            off += 8 + l_name
        self.header_text = data[8:8 + l_text].decode(errors="replace")
        self._data = data
        self._aln_start = off
        self._index: Optional[_RegionIndex] = None

    def __iter__(self) -> Iterator[AlignedRead]:
        data = self._data
        off = self._aln_start
        n = len(data)
        refs = self.references
        while off + 4 <= n:
            block_size = struct.unpack_from("<i", data, off)[0]
            rec = data[off + 4:off + 4 + block_size]
            off += 4 + block_size
            yield _decode_bam_record(rec, refs)

    def fetch(self, chrom: str, start: int, end: int
              ) -> Iterator[AlignedRead]:
        """Region fetch (0-based half-open) via the in-memory index."""
        if self._index is None:
            self._index = _RegionIndex(list(self))
        return self._index.fetch(chrom, start, end)


def _cigar_ref_len(cigar: str) -> int:
    if cigar in ("*", ""):
        return 1
    n = 0
    num = ""
    for ch in cigar:
        if ch.isdigit():
            num += ch
        else:
            if ch in "MDN=X":
                n += int(num)
            num = ""
    return n


def open_alignments(path: str):
    """Open SAM (.sam/.sam.gz) or BAM transparently; returns an object with
    .references and .fetch(chrom, start, end).

    BAMs open through the streaming IndexedBamReader (O(region) fetches,
    never loads the file); an existing .bai is used, otherwise one is
    built in a single pass and persisted."""
    if path.endswith(".bam"):
        return IndexedBamReader(path)
    try:
        if os.path.getsize(path) > 512 * 1024 * 1024:
            print("Warning: %s is a large text SAM; it will be loaded "
                  "fully into memory.  Convert with sam_to_bam for "
                  "O(region) streaming access." % path)
    except OSError:
        pass
    return SamFile(path)


SAM_WARN_BYTES = 256 << 20  # text-SAM size above which we warn


class SamFile:
    """SAM text file with the BamReader fetch surface (indexed).

    Deliberately in-memory: plain-text SAM has no block structure to
    seek into (pysam cannot region-fetch SAM either; the reference
    converts via sam_to_bam first, sam_to_bam.py:32-60).  Genome-scale
    inputs should be BAM, which streams through IndexedBamReader."""

    def __init__(self, path: str):
        self.path = path
        try:
            if os.path.getsize(path) > SAM_WARN_BYTES:
                import warnings
                warnings.warn(
                    "%s is a %d MB text SAM file: it will be parsed "
                    "whole-file into memory. Convert to sorted BAM "
                    "first (`sam_to_bam --convert`) for streamed, "
                    "indexed ingest." % (path,
                                         os.path.getsize(path) >> 20),
                    ResourceWarning, stacklevel=2)
        except OSError:
            pass
        self._reads = list(read_sam_text(path))
        self.references = sorted({r.rname for r in self._reads
                                  if r.rname != "*"})
        self._index: Optional[_RegionIndex] = None

    def __iter__(self):
        return iter(self._reads)

    def fetch(self, chrom: str, start: int, end: int):
        if self._index is None:
            self._index = _RegionIndex(self._reads)
        return self._index.fetch(chrom, start, end)


def iter_bam_reads_in_gene(alignments, chrom: str, start: int, end: int):
    """Lazy region fetch with the chr-prefix fallback; lets callers that
    only need a threshold count (e.g. the coverage prefilter) stop
    without decoding the whole region."""
    if chrom not in alignments.references:
        parts = chrom.split("chr")
        chrom = parts[0] if len(parts) <= 1 else parts[1]
    try:
        yield from alignments.fetch(chrom, start, end)
    except (ValueError, KeyError):
        print("Cannot fetch reads in region: %s:%d-%d" % (chrom, start, end))


def fetch_bam_reads_in_gene(alignments, chrom: str, start: int, end: int
                            ) -> List[AlignedRead]:
    """Region fetch with the chr-prefix fallback
    (misopy/sam_utils.py:154-181)."""
    return list(iter_bam_reads_in_gene(alignments, chrom, start, end))


# ----------------------------------------------------------- BAM writing

def _encode_cigar(cigar: str) -> bytes:
    if cigar in ("*", ""):
        return b""
    out = []
    num = ""
    for ch in cigar:
        if ch.isdigit():
            num += ch
        else:
            out.append((int(num) << 4) | _BAM_CIGAR_OPS.index(ch))
            num = ""
    return struct.pack("<%dI" % len(out), *out)


def write_bam(path: str, references: Sequence[str],
              lengths: Sequence[int], reads: Sequence[AlignedRead],
              header_text: str = "") -> None:
    """Write a BAM file (BGZF-compressed) from AlignedRead records.

    Replaces the reference's samtools dependency (misopy/sam_to_bam.py)
    with a native encoder; sequences/qualities are not retained (the
    quantifier only consumes name/flag/pos/cigar)."""
    ref_index = {name: i for i, name in enumerate(references)}
    body = [b"BAM\x01", struct.pack("<i", len(header_text)),
            header_text.encode(), struct.pack("<i", len(references))]
    for name, ln in zip(references, lengths):
        nb = name.encode() + b"\x00"
        body.append(struct.pack("<i", len(nb)) + nb + struct.pack("<i", ln))
    for r in reads:
        name_b = r.qname.encode() + b"\x00"
        cig_b = _encode_cigar(r.cigar_str)
        ref_id = ref_index.get(r.rname, -1)
        rbin = reg2bin(r.pos, r.pos + max(_cigar_ref_len(r.cigar_str), 1))
        rec = struct.pack(
            "<iiBBHHHiiii", ref_id, r.pos, len(name_b), r.mapq, rbin,
            len(cig_b) // 4, r.flag, 0, -1, -1, 0) + name_b + cig_b
        body.append(struct.pack("<i", len(rec)) + rec)
    with open(path, "wb") as f:
        f.write(bgzf_compress(b"".join(body)))


def sam_to_bam(sam_filename: str, bam_filename: str) -> str:
    """SAM -> coordinate-sorted BAM, natively (no samtools).
    Capability parity: misopy/sam_to_bam.py:8-42."""
    reads = list(read_sam_text(sam_filename))
    refs: List[str] = []
    lens: List[int] = []
    # take @SQ lines if present
    opener = gzip.open if sam_filename.endswith(".gz") else open
    header_lines = []
    with opener(sam_filename, "rt") as f:
        for line in f:
            if not line.startswith("@"):
                break
            header_lines.append(line)
            if line.startswith("@SQ"):
                d = dict(kv.split(":", 1) for kv in
                         line.strip().split("\t")[1:] if ":" in kv)
                if "SN" in d:
                    refs.append(d["SN"])
                    lens.append(int(d.get("LN", 0)))
    if not refs:
        seen = sorted({r.rname for r in reads if r.rname != "*"})
        refs = seen
        lens = [max((r.pos + r.rlen + 1) for r in reads if r.rname == c)
                for c in seen]
    ref_order = {c: i for i, c in enumerate(refs)}
    reads.sort(key=lambda r: (ref_order.get(r.rname, len(refs)), r.pos))
    write_bam(bam_filename, refs, lens, reads,
              header_text="".join(header_lines))
    # index alongside, as the reference's `samtools index` step does
    # (misopy/sam_to_bam.py:32-39)
    IndexedBamReader(bam_filename, build_missing_index=True)
    return bam_filename


# ------------------------------------------------------------ pair/strand

def pair_sam_reads(reads: Iterable[AlignedRead],
                   filter_reads: bool = True,
                   return_unpaired: bool = False,
                   strand_rule: Optional[str] = None):
    """Pair mates by name; drop same-strand pairs and unpaired reads.
    Ref: misopy/sam_utils.py:210-289 (incl. fr-firststrand mate reorder)."""
    paired: Dict[str, List[AlignedRead]] = {}
    unpaired: Dict[str, object] = {}
    for read in reads:
        name = strip_mate_id(read.qname)
        if filter_reads and (read.is_qcfail or read.is_unmapped or
                             read.mate_is_unmapped or not read.is_paired):
            unpaired[name] = read
            continue
        paired.setdefault(name, []).append(read)
        if len(paired[name]) == 2 and strand_rule == "fr-firststrand":
            # Put the forward-strand mate first.  The reference applies
            # two sequential swaps keyed on (is_read1, is_reverse) then
            # (is_read2, is_reverse) (sam_utils.py:236-247); for
            # opposite-strand pairs -- the only ones that survive the
            # same-strand filter below -- that composition is exactly
            # "swap iff the first-seen mate is reverse".
            if paired[name][0].is_reverse:
                paired[name] = paired[name][::-1]

    to_delete = []
    for name, rs in paired.items():
        if len(rs) != 2:
            unpaired[name] = rs
            to_delete.append(name)
            continue
        left, right = rs
        if flag_to_strand(left.flag) == flag_to_strand(right.flag):
            to_delete.append(name)
    for name in to_delete:
        del paired[name]
    if return_unpaired:
        return paired, unpaired
    return paired


def _gather_byte_ranges(buf, starts, lens):
    """Concatenate buf[starts[i]:starts[i]+lens[i]] slices into one
    compact bytes object, fully vectorized (no per-range Python).
    Returns (packed_bytes, new_start_offsets)."""
    import numpy as np
    starts = np.asarray(starts, np.int64)
    lens = np.asarray(lens, np.int64)
    newoff = np.zeros(len(lens), np.int64)
    if len(lens):
        np.cumsum(lens[:-1], out=newoff[1:])
    tot = int(lens.sum())
    if tot == 0:
        return b"", newoff
    pos = np.arange(tot)
    row = np.searchsorted(np.cumsum(lens), pos, side="right")
    src = starts[row] + (pos - newoff[row])
    return np.frombuffer(buf, np.uint8)[src].tobytes(), newoff


def _validate_strand_rule(strand_rule: Optional[str],
                          target_strand: Optional[str]) -> bool:
    """Shared columnar-path validation, mirroring read_matches_strand's
    semantics exactly (misopy/sam_utils.py:313-350): returns whether a
    strand check applies; raises on an unknown (or the unsupported
    fr-secondstrand) rule ONLY when a target strand is present -- with
    no target the Python path never consults the rule, so neither do
    the columnar paths."""
    if (strand_rule is None or strand_rule == "fr-unstranded"
            or target_strand is None):
        return False
    if strand_rule == "fr-secondstrand":
        raise ValueError("fr-secondstrand currently unsupported.")
    if strand_rule != "fr-firststrand":
        raise ValueError("Unknown strandedness rule.")
    return True


def read_matches_strand(read, target_strand: str, strand_rule: Optional[str],
                        paired_end=None) -> bool:
    """Ref: misopy/sam_utils.py:313-350."""
    if strand_rule == "fr-unstranded" or strand_rule is None:
        return True
    if strand_rule == "fr-secondstrand":
        raise ValueError("fr-secondstrand currently unsupported.")
    if strand_rule != "fr-firststrand":
        raise ValueError("Unknown strandedness rule.")
    if paired_end is not None:
        read1, read2 = read
        if target_strand == "+":
            return flag_to_strand(read1.flag) == "+"
        return flag_to_strand(read2.flag) == "-"
    return flag_to_strand(read.flag) == target_strand


def sam_parse_reads(reads: Iterable[AlignedRead],
                    paired_end: bool = False,
                    strand_rule: Optional[str] = None,
                    target_strand: Optional[str] = None,
                    given_read_len: Optional[int] = None
                    ) -> Tuple[Tuple[Sequence[int], Sequence[str]], int]:
    """Produce ((positions, cigars), num_reads); 0-based positions.
    Ref: misopy/sam_utils.py:353-456."""
    read_positions: List[int] = []
    read_cigars: List[str] = []
    num_reads = 0
    check_strand = not (strand_rule is None or
                        strand_rule == "fr-unstranded" or
                        target_strand is None)
    if paired_end:
        for name, pair in pair_sam_reads(list(reads),
                                         strand_rule=strand_rule).items():
            if check_strand and not read_matches_strand(
                    pair, target_strand, strand_rule, paired_end=True):
                continue
            r1, r2 = pair
            if r1.cigar is None or r2.cigar is None:
                continue
            if given_read_len is not None and (
                    r1.rlen != given_read_len or r2.rlen != given_read_len):
                continue
            read_positions.extend([r1.pos, r2.pos])
            read_cigars.extend([r1.cigar, r2.cigar])
            num_reads += 1
    else:
        for read in reads:
            if read.cigar is None:
                continue
            if given_read_len is not None and read.rlen != given_read_len:
                continue
            if check_strand and not read_matches_strand(
                    read, target_strand, strand_rule):
                continue
            read_positions.append(read.pos)
            read_cigars.append(read.cigar)
            num_reads += 1
    return (tuple(read_positions), tuple(read_cigars)), num_reads
