"""GFF3 parsing, writing, and gene construction.

Capability parity with misopy/gff_utils.py (GFFDatabase, Reader/Writer) and
misopy/Gene.py:868-1016 (load_genes_from_gff / make_gene_from_gff_records),
re-implemented around flat records + a single-pass hierarchy build.

Only the GFF3 dialect is needed by the pipeline (all shipped annotations
are GFF3); attribute parsing follows gff_utils.py:734-769.
"""
from __future__ import annotations

import hashlib
import os
import urllib.parse
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Tuple

from miso_jax.core.gene import Exon, Gene, Isoform

COMPRESS_PREFIX = "misocomp"


@dataclass
class GFFRecord:
    """One GFF3 line. Coordinates 1-based inclusive."""

    seqid: str
    source: str
    type: str
    start: int
    end: int
    score: Optional[float] = None
    strand: Optional[str] = None
    phase: Optional[int] = None
    attributes: Dict[str, List[str]] = field(default_factory=dict)

    def get_id(self) -> Optional[str]:
        v = self.attributes.get("ID")
        return v[0] if v else None

    def get_parents(self) -> List[str]:
        return self.attributes.get("Parent", [])

    def to_line(self) -> str:
        attrs = ";".join(
            "%s=%s" % (k, ",".join(_escape(x) for x in v))
            for k, v in self.attributes.items()
        )
        return "\t".join([
            self.seqid, self.source, self.type,
            str(self.start), str(self.end),
            "." if self.score is None else ("%g" % self.score),
            self.strand or ".",
            "." if self.phase is None else str(self.phase),
            attrs or ".",
        ])


def _unescape(s: str) -> str:
    return urllib.parse.unquote(s) if "%" in s else s


def _escape(s: str) -> str:
    return s.replace(";", "%3B").replace("=", "%3D").replace(",", "%2C")


def parse_attributes(field9: str) -> Dict[str, List[str]]:
    """GFF3 `key=v1,v2;key2=v` attribute parsing
    (gff_utils.py:734-769 semantics)."""
    attrs: Dict[str, List[str]] = {}
    if field9 in (".", ""):
        return attrs
    for part in field9.rstrip(";").split(";"):
        part = part.strip()
        if not part:
            continue
        if "=" in part:
            k, v = part.split("=", 1)
            attrs[k.strip()] = [_unescape(x) for x in v.split(",")]
        else:
            attrs.setdefault(part, [])
    return attrs


def parse_gff_line(line: str) -> Optional[GFFRecord]:
    fields = line.rstrip("\n").split("\t")
    if len(fields) < 9:
        return None
    score = None if fields[5] == "." else float(fields[5])
    strand = None if fields[6] == "." else fields[6]
    phase = None if fields[7] == "." else int(fields[7])
    return GFFRecord(
        seqid=fields[0], source=fields[1], type=fields[2],
        start=int(fields[3]), end=int(fields[4]), score=score,
        strand=strand, phase=phase, attributes=parse_attributes(fields[8]))


_GTF_ATTR_RE = None


def parse_gtf_attributes(field9: str) -> Dict[str, List[str]]:
    """GTF `key "value"; key2 "v2";` attribute parsing
    (gff_utils.py Reader GTF dialect)."""
    global _GTF_ATTR_RE
    if _GTF_ATTR_RE is None:
        import re
        _GTF_ATTR_RE = re.compile(r'(\w+)\s+"([^"]*)"')
    attrs: Dict[str, List[str]] = {}
    for k, v in _GTF_ATTR_RE.findall(field9):
        attrs.setdefault(k, []).append(v)
    return attrs


_V2_TOKEN_RE = None


def parse_v2_attributes(field9: str) -> Dict[str, List[str]]:
    """GFF v2 ``tag value "free text"; tag2 v`` attributes: identifier
    starts a tag, bare words and quoted strings append values, ';'
    separates tags, '#' starts a trailing comment
    (gff_utils.py:752-810 AttributeIterator semantics)."""
    global _V2_TOKEN_RE
    if _V2_TOKEN_RE is None:
        import re
        _V2_TOKEN_RE = re.compile(
            r'\s*(?:(?P<sep>;)|(?P<comment>#.*$)'
            r'|"(?P<quoted>(?:[^"\\]|\\.)*)"'
            r'|(?P<word>[^;#\s"]+))')
    attrs: Dict[str, List[str]] = {}
    tag: Optional[str] = None
    s = field9.rstrip()
    pos = 0
    while pos < len(s):
        m = _V2_TOKEN_RE.match(s, pos)
        if m is None or m.end() == pos:
            break
        pos = m.end()
        if m.group("comment") is not None:
            break
        if m.group("sep") is not None:
            tag = None
            continue
        val = m.group("quoted")
        if val is None:
            val = m.group("word")
        if tag is None:
            tag = val
            attrs.setdefault(tag, [])
        else:
            attrs[tag].append(val.replace('\\"', '"'))
    return attrs


def parse_gff_line_v1(line: str) -> Optional[GFFRecord]:
    """GFF v1: 8 fixed fields + optional free-text group column
    (gff_utils.py:664-685 _parse_record_v1)."""
    fields = line.rstrip("\n").split("\t", 8)
    if len(fields) < 8:
        return None
    attrs = {"group": [fields[8]]} if len(fields) == 9 else {}
    return GFFRecord(
        seqid=fields[0], source=fields[1], type=fields[2],
        start=int(fields[3]), end=int(fields[4]),
        score=None if fields[5] == "." else float(fields[5]),
        strand=None if fields[6] == "." else fields[6],
        phase=None if fields[7] == "." else int(fields[7]),
        attributes=attrs)


def parse_gff_line_v2(line: str) -> Optional[GFFRecord]:
    """GFF v2 / GTF: 8 fixed fields + tag-value attribute column
    (gff_utils.py:687-709 _parse_record_v2)."""
    fields = line.rstrip("\n").split("\t", 8)
    if len(fields) < 8:
        return None
    attrs = parse_v2_attributes(fields[8]) if len(fields) == 9 else {}
    return GFFRecord(
        seqid=fields[0], source=fields[1], type=fields[2],
        start=int(fields[3]), end=int(fields[4]),
        score=None if fields[5] == "." else float(fields[5]),
        strand=None if fields[6] == "." else fields[6],
        phase=None if fields[7] == "." else int(fields[7]),
        attributes=attrs)


def _looks_like_gtf(field9: str) -> bool:
    return '"' in field9 and "=" not in field9.split('"')[0]


def gtf_to_gff3_records(records: List[GFFRecord]) -> List[GFFRecord]:
    """Synthesize the gene -> mRNA -> exon hierarchy GFF3 expects from
    flat GTF exon/CDS lines keyed by gene_id/transcript_id."""
    genes: Dict[str, GFFRecord] = {}
    mrnas: Dict[str, GFFRecord] = {}
    out: List[GFFRecord] = []
    exons: List[GFFRecord] = []
    for rec in records:
        gid = (rec.attributes.get("gene_id") or [None])[0]
        tid = (rec.attributes.get("transcript_id") or [None])[0]
        if rec.type not in ("exon",) or gid is None or tid is None:
            continue
        if gid not in genes:
            genes[gid] = GFFRecord(
                rec.seqid, rec.source, "gene", rec.start, rec.end,
                None, rec.strand, None, {"ID": [gid]})
        g = genes[gid]
        g.start = min(g.start, rec.start)
        g.end = max(g.end, rec.end)
        if tid not in mrnas:
            mrnas[tid] = GFFRecord(
                rec.seqid, rec.source, "mRNA", rec.start, rec.end,
                None, rec.strand, None, {"ID": [tid], "Parent": [gid]})
        m = mrnas[tid]
        m.start = min(m.start, rec.start)
        m.end = max(m.end, rec.end)
        exons.append(GFFRecord(
            rec.seqid, rec.source, "exon", rec.start, rec.end,
            rec.score, rec.strand, rec.phase,
            {"ID": ["%s:%d_%d" % (tid, rec.start, rec.end)],
             "Parent": [tid]}))
    out.extend(genes.values())
    out.extend(mrnas.values())
    out.extend(exons)
    return out


def read_gff(path: str) -> List[GFFRecord]:
    """Read GFF3 (native), GFF v1/v2 (via the ``##gff-version``
    directive), or GTF (auto-detected and converted to the GFF3
    hierarchy).  Ref: misopy/gff_utils.py:509-760 Reader dispatches a
    per-version record parser on the gff-version directive."""
    records = []
    gtf_seen = False
    version = "3"
    with open(path) as f:
        for line in f:
            if line.startswith("##"):
                tokens = line[2:].split(None, 1)
                if len(tokens) == 2 and tokens[0] == "gff-version":
                    version = tokens[1].strip()
                continue
            if line.startswith("#") or not line.strip():
                continue
            if version == "1":
                rec = parse_gff_line_v1(line)
                if rec is not None:
                    records.append(rec)
                continue
            if version.startswith("2"):
                rec = parse_gff_line_v2(line)
                if rec is not None:
                    records.append(rec)
                    if ("gene_id" in rec.attributes
                            and "transcript_id" in rec.attributes):
                        gtf_seen = True
                continue
            fields = line.rstrip("\n").split("\t")
            if len(fields) < 9:
                continue
            if _looks_like_gtf(fields[8]):
                gtf_seen = True
                rec = parse_gff_line(line)
                if rec is not None:
                    rec.attributes = parse_gtf_attributes(fields[8])
                    records.append(rec)
            else:
                rec = parse_gff_line(line)
                if rec is not None:
                    records.append(rec)
    if gtf_seen:
        return gtf_to_gff3_records(records)
    return records


def _format_record_v1(rec: GFFRecord) -> str:
    """gff_utils.py:888-899 _write_rec_v1: score defaults to '0', the
    group column is the single free-text attribute."""
    fields = [rec.seqid, rec.source, rec.type, str(rec.start),
              str(rec.end),
              "0" if rec.score is None else ("%g" % rec.score),
              rec.strand or ".",
              "." if rec.phase is None else str(rec.phase)]
    group = rec.attributes.get("group")
    if group:
        fields.append(group[0])
    return "\t".join(fields)


def _format_record_v2(rec: GFFRecord, gtf: bool = False) -> str:
    """gff_utils.py:901-946 _write_rec_v2/_write_rec_gtf: space-joined
    `tag "value";` attributes; GTF forces gene_id/transcript_id."""
    attrs = dict(rec.attributes)
    if gtf:
        for req in ("gene_id", "transcript_id"):
            attrs.setdefault(req, [""])
    fields = [rec.seqid, rec.source, rec.type, str(rec.start),
              str(rec.end),
              "." if rec.score is None else ("%g" % rec.score),
              rec.strand or ".",
              "." if rec.phase is None else str(rec.phase)]
    if attrs:
        fields.append(" ".join(
            " ".join([tag] + ['"%s"' % v for v in values]) + ";"
            for tag, values in attrs.items()))
    return "\t".join(fields)


def write_gff(records: Iterable[GFFRecord], path: str,
              header: Optional[str] = None, version: str = "3") -> None:
    """Write records in the requested dialect ('1', '2', '2.5'/'gtf',
    '3'); parity: gff_utils.py:846-953 Writer's per-version writers."""
    if header is None:
        header = "##gff-version %s\n" % ("2" if version.lower() == "gtf"
                                         else version)
    v = str(version).strip().lower()
    # normalize the 'N.0' spellings a ##gff-version directive round-trips
    v = {"1.0": "1", "2.0": "2", "3.0": "3"}.get(v, v)
    if v == "1":
        fmt = _format_record_v1
    elif v == "2":
        fmt = _format_record_v2
    elif v in ("2.1", "2.2", "2.5", "gtf"):
        fmt = lambda r: _format_record_v2(r, gtf=True)  # noqa: E731
    elif v == "3":
        fmt = GFFRecord.to_line
    else:
        # the reference Writer raises on unknown versions
        # (gff_utils.py:864-865) rather than silently mixing dialects
        raise ValueError("Unrecognized GFF version: %s" % version)
    with open(path, "w") as f:
        f.write(header)
        for rec in records:
            f.write(fmt(rec) + "\n")


class GFFDatabase:
    """gene -> mRNA -> exon hierarchy over a GFF3 file.

    Parity target: misopy/gff_utils.py:164-313.  Only `mRNA`/`transcript`
    children of genes and `exon` children of transcripts participate in
    gene-model construction (CDS/start_codon etc. are carried through for
    round-tripping but ignored by the quantifier).
    """

    GENE_TYPES = frozenset(["gene"])
    MRNA_TYPES = frozenset(["mRNA", "transcript"])

    def __init__(self, path_or_records):
        if isinstance(path_or_records, str):
            self.records = read_gff(path_or_records)
        else:
            self.records = list(path_or_records)
        self.genes: List[GFFRecord] = []
        self.mrnas_by_gene: Dict[str, List[GFFRecord]] = {}
        self.exons_by_mrna: Dict[str, List[GFFRecord]] = {}
        self._build()

    def _build(self):
        mrna_ids = set()
        for rec in self.records:
            if rec.type in self.GENE_TYPES:
                self.genes.append(rec)
            elif rec.type in self.MRNA_TYPES:
                rid = rec.get_id()
                if rid is not None:
                    mrna_ids.add(rid)
                for p in rec.get_parents():
                    self.mrnas_by_gene.setdefault(p, []).append(rec)
        for rec in self.records:
            if rec.type == "exon":
                for p in rec.get_parents():
                    if p in mrna_ids:
                        self.exons_by_mrna.setdefault(p, []).append(rec)


def make_gene_from_records(
    gene_rec: GFFRecord,
    mrna_recs: List[GFFRecord],
    exons_by_mrna: Dict[str, List[GFFRecord]],
) -> Optional[Gene]:
    """Build a Gene from its hierarchy.
    Ref: misopy/Gene.py:920-1016 (make_gene_from_gff_records): exons of each
    transcript sorted by start; gene parts are the unique exons across
    transcripts; isoform desc = list of exon labels."""
    gene_label = gene_rec.get_id()
    chrom = gene_rec.seqid
    strand = gene_rec.strand

    part_index: Dict[Tuple[int, int], int] = {}
    parts: List[Exon] = []
    isoforms: List[Isoform] = []
    for mrna in mrna_recs:
        mid = mrna.get_id()
        exon_recs = exons_by_mrna.get(mid, [])
        if not exon_recs:
            continue
        chrom = mrna.seqid
        strand = mrna.strand
        exon_recs = sorted(exon_recs, key=lambda r: r.start)
        idxs = []
        labels = []
        for er in exon_recs:
            key = (er.start, er.end)
            if key not in part_index:
                label = er.get_id() or "%d_%d" % key
                part_index[key] = len(parts)
                parts.append(Exon(er.start, er.end, label=label))
            idxs.append(part_index[key])
            # desc uses the transcript's OWN exon labels, not the shared
            # part labels (Gene.py:979-989 collects labels pre-dedup)
            labels.append(er.get_id() or "%d_%d" % key)
        isoforms.append(Isoform(tuple(idxs), label=mid, desc=labels))
    if not isoforms:
        return None
    # re-sort parts by coordinate and remap isoform indices
    order = sorted(range(len(parts)), key=lambda i: (parts[i].start, parts[i].end))
    remap = {old: new for new, old in enumerate(order)}
    parts = [parts[i] for i in order]
    isoforms = [
        Isoform(tuple(remap[i] for i in iso.parts), label=iso.label,
                desc=iso.desc)
        for iso in isoforms
    ]
    return Gene(parts=parts, isoforms=isoforms, label=gene_label,
                chrom=chrom, strand=strand)


def load_genes_from_gff(path: str) -> Dict[str, Gene]:
    """All genes of a GFF3 file, keyed by gene ID, in file order.
    Ref: misopy/Gene.py:868-917."""
    db = GFFDatabase(path)
    out: Dict[str, Gene] = {}
    for gene_rec in db.genes:
        gid = gene_rec.get_id()
        if gid is None:
            continue
        gene = make_gene_from_records(
            gene_rec, db.mrnas_by_gene.get(gid, []), db.exons_by_mrna)
        if gene is not None:
            out[gid] = gene
    return out


def compress_event_name(event_name: str, prefix: str = COMPRESS_PREFIX) -> str:
    """Filename-safe hashed event ID (`--compress-id`).

    Ref: misopy/index_gff.py:22-26 (uses Python2 hash(); we use a stable
    md5-derived value so indices are reproducible across runs)."""
    h = int(hashlib.md5(event_name.encode()).hexdigest()[:15], 16)
    return "%s_%s" % (prefix, h)


def is_compressed_name(event_name: str) -> bool:
    return str(event_name).startswith(COMPRESS_PREFIX)
