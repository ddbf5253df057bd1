"""The `.miso` per-event output format: writer, reader, directory model,
and the `.miso_summary` summarizer.

Format parity targets:
- writer: misopy/miso_sampler.py:376-466 (output_miso_results) -- header
  field order, 4-decimal psi, 2-decimal log score.
- reader: misopy/samples_utils.py:130-228 (load_samples + header parsing).
- directory model: misopy/samples_utils.py:21-120, 332-411 (MISOSamples).
- summary: misopy/samples_utils.py:263-329 (summarize_sampler_results).
"""
from __future__ import annotations

import glob
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from miso_jax.core.events import CompiledEvent
from miso_jax.core.gene import Gene
from miso_jax.stats.intervals import format_credible_intervals


# ------------------------------------------------------------------ writing

def isoforms_str(gene: Gene) -> str:
    """`['iso1','iso2']` with list-descs joined by '_'
    (miso_sampler.py:384-392)."""
    descs = []
    for i in range(gene.num_isoforms):
        descs.append("'" + gene.iso_desc_str(i) + "'")
    return "[" + ",".join(descs) + "]"


def exon_lens_str(gene: Gene) -> str:
    """`('label',len),...` over gene parts (miso_sampler.py:397-398)."""
    return ",".join("('%s',%d)" % (p.label, p.len) for p in gene.parts)


def assigned_counts_str(final_n: np.ndarray, num_iso: int) -> str:
    """`0:n0,1:n1,...` from per-isoform assignment counts
    (miso_sampler.py:424-428, reads_utils.py:38-46)."""
    return ",".join("%d:%d" % (i, int(round(float(final_n[i]))))
                    for i in range(num_iso))


def event_header_str(event: CompiledEvent, iters: int, burn_in: int,
                     lag: int, percent_accept: float,
                     final_n: np.ndarray,
                     proposal_type: str = "drift") -> str:
    """The `.miso` header line (field order:
    misopy/miso_sampler.py:444-455); shared by the file writer and the
    direct sqlite packer."""
    gene = event.gene
    chrom = gene.chrom if gene.chrom is not None else "NA"
    strand = gene.strand if gene.strand is not None else "NA"
    mrna_starts = ",".join(
        str(gene.iso_genomic_span(i)[0]) for i in range(gene.num_isoforms))
    mrna_ends = ",".join(
        str(gene.iso_genomic_span(i)[1]) for i in range(gene.num_isoforms))
    return (
        "#isoforms=%s\texon_lens=%s\titers=%d\tburn_in=%d\tlag=%d\t"
        "percent_accept=%.2f\tproposal_type=%s\t"
        "counts=%s\tassigned_counts=%s\tchrom=%s\tstrand=%s\t"
        "mRNA_starts=%s\tmRNA_ends=%s\n"
        % (isoforms_str(gene), exon_lens_str(gene), iters, burn_in, lag,
           percent_accept, proposal_type, event.counts_str(),
           assigned_counts_str(final_n, event.num_iso), chrom, strand,
           mrna_starts, mrna_ends))


def write_miso_file(
    output_file: str,
    event: CompiledEvent,
    psi_samples: np.ndarray,   # (S, I_real)
    log_scores: np.ndarray,    # (S,)
    iters: int,
    burn_in: int,
    lag: int,
    percent_accept: float,
    final_n: np.ndarray,
    proposal_type: str = "drift",
    psi_ticks: np.ndarray = None,    # (S, I) int 1e-4 ticks (optional)
    score_cents: np.ndarray = None,  # (S,) int centipoints (optional)
    body: bytes = None,              # preformatted sample block (optional)
) -> None:
    """Write one event's `.miso` file (miso_sampler.py:376-466).

    `psi_ticks`/`score_cents`, when given, are the already-quantized
    sample values (the pipeline's device fetch payload is quantized to
    exactly the output precision); the float arrays are then not
    touched, skipping a full re-quantization pass per event."""
    header = event_header_str(event, iters, burn_in, lag, percent_accept,
                              final_n, proposal_type)
    d = os.path.dirname(os.path.abspath(output_file))
    if d not in _made_dirs:  # one makedirs syscall per directory, not per event
        os.makedirs(d, exist_ok=True)
        _made_dirs.add(d)
    # (the open below self-heals if the cached directory was deleted)
    if body is None:
        if psi_ticks is not None and score_cents is not None:
            cents = np.asarray(score_cents, np.int64)
            body = _format_quantized(np.asarray(psi_ticks, np.int64),
                                     cents, cents < 0)
        else:
            body = _format_sample_block(
                np.asarray(psi_samples, np.float64),
                np.asarray(log_scores, np.float64))
    try:
        f = open(output_file, "wb")
    except FileNotFoundError:
        # the cached directory was removed out from under us (e.g. a
        # caller rm -rf'd the output tree between runs): recreate it
        os.makedirs(d, exist_ok=True)
        f = open(output_file, "wb")
    with f:
        f.write(header.encode())
        f.write(b"sampled_psi\tlog_score\n")
        f.write(body)


_made_dirs: set = set()  # (benign under threads: set.add is atomic)


# psi values are written at 1e-4 resolution, so every cell is one of
# 10001 strings: a bytes lookup table makes the per-sample formatting a
# C-speed fancy index instead of a Python-level "%.4f" per element
# (np.char.mod was ~7 ms/event at the default 2700 samples -- the
# dominant cost of a catalog-scale run's output phase)
_PSI_LUT = np.array([("%.4f" % (i / 1e4)).encode() for i in range(10001)],
                    dtype="S6")


def _format_sample_block(psi: np.ndarray, scores: np.ndarray) -> bytes:
    """The sample lines ('psi1,psi2,...\\tlogscore\\n') as one bytes
    blob, matching '%.4f'/'%.2f' formatting (see _format_quantized)."""
    S, I = psi.shape
    if S == 0:
        return b""
    q = np.clip(np.round(psi * 1e4), 0, 10000).astype(np.int64)
    scores = np.asarray(scores, np.float64)
    cents = np.round(scores * 100.0).astype(np.int64)
    # sign from the VALUE, not the rounded cents: '%.2f' % -0.004 is
    # '-0.00' (signbit also covers a literal -0.0)
    return _format_quantized(q, cents, np.signbit(scores))


def _format_quantized(q: np.ndarray, cents: np.ndarray,
                      neg: np.ndarray, return_offsets: bool = False):
    """Sample lines from ALREADY-QUANTIZED values: q (S, I) psi ticks
    (1e-4), cents (S,) score centipoints, neg (S,) sign flags.  The
    catalog pipeline feeds the device's quantized fetch payload straight
    through here -- no float64 materialization or re-quantization pass.
    Hot path: the native formatter (native/formatlib.cpp) runs the whole
    block at memory speed; the vectorized numpy form below (fixed-width
    psi byte matrix + masked right-aligned score scatters) is the
    always-available fallback and the parity oracle
    (tests/test_tools.py pins them byte-equal)."""
    S, I = q.shape
    if S == 0:
        return (b"", np.zeros(1, np.int64)) if return_offsets else b""
    from miso_jax import native
    nat = native.format_quantized(q, cents, neg)
    if nat is not None:
        blob, off = nat
        return (blob, off) if return_offsets else blob
    pc = _PSI_LUT[q]                      # (S, I) 'S6'
    W = 6 * I + (I - 1)
    M = np.empty((S, W + 1), dtype="S1")
    u = pc.view("S1").reshape(S, I, 6)
    col = 0
    for i in range(I):
        M[:, col:col + 6] = u[:, i]
        col += 6
        if i < I - 1:
            M[:, col] = b","
            col += 1
    M[:, W] = b"\t"
    blk = M.view(np.uint8).reshape(S, W + 1)

    a = np.abs(cents)
    ip = a // 100
    frac = a % 100
    # integer-part digit counts (>= 1)
    nd = np.ones(S, np.int64)
    t = 10
    while (ip >= t).any():
        nd += ip >= t
        t *= 10
    score_len = neg + nd + 3              # sign + digits + '.' + 2
    line_len = (W + 1) + score_len + 1    # + '\n'
    off = np.zeros(S + 1, np.int64)
    np.cumsum(line_len, out=off[1:])
    out = np.empty(off[-1], np.uint8)
    out[off[:-1, None] + np.arange(W + 1)[None, :]] = blk
    end = off[1:]                         # one past each line
    out[end - 1] = 0x0A                   # '\n'
    out[end - 2] = 0x30 + (frac % 10)
    out[end - 3] = 0x30 + (frac // 10)
    out[end - 4] = 0x2E                   # '.'
    k, t = 0, 1
    max_nd = int(nd.max())
    while k < max_nd:
        m = k < nd
        out[end[m] - 5 - k] = 0x30 + (ip[m] // t) % 10
        k += 1
        t *= 10
    m = neg
    if m.any():
        out[end[m] - 5 - nd[m]] = 0x2D    # '-'
    if return_offsets:
        return out.tobytes(), off
    return out.tobytes()


# ------------------------------------------------------------------ reading

@dataclass
class MISOFileData:
    samples: np.ndarray          # (S, I)
    header: str
    log_scores: np.ndarray       # (S,)
    sampled_map: List[float]
    sampled_map_log_score: float
    counts_info: Dict[str, str]
    params: Dict[str, str] = field(default_factory=dict)

    # tuple compatibility with reference load_samples return
    def __getitem__(self, i):
        return (self.samples, [self.header], self.log_scores,
                self.sampled_map, self.sampled_map_log_score,
                self.counts_info)[i]


def parse_sampler_params_from_header(header: str) -> Dict[str, str]:
    """One parse for everything the `.miso` header carries: the header
    is tab-separated `key=value` fields (written by write_miso_file
    above; format defined by misopy/miso_sampler.py:444-455).  The
    reference re-parses the line once per consumer
    (samples_utils.py:159-211); here every consumer reads this dict."""
    params = {}
    for fld in header.lstrip("#").rstrip("\n").split("\t"):
        key, eq, value = fld.partition("=")
        if eq:
            params[key] = value
    return params


def get_isoforms_from_header(header: str) -> str:
    """The isoforms= field without its [ ] brackets
    (consumed by the comparison writer, hypothesis_test.py:269)."""
    return parse_sampler_params_from_header(header)["isoforms"][1:-1]


def get_counts_from_header(header: str) -> Dict[str, str]:
    """counts= / assigned_counts= fields; both-or-neither, 'n/a'
    otherwise (the contract of samples_utils.py:192-211)."""
    params = parse_sampler_params_from_header(header)
    if "counts" in params and "assigned_counts" in params:
        return {"counts": params["counts"],
                "assigned_counts": params["assigned_counts"]}
    return {"counts": "n/a", "assigned_counts": "n/a"}


def _miso_file_data(header: str, samples: np.ndarray,
                    scores: np.ndarray) -> MISOFileData:
    map_idx = int(np.argmax(samples[:, 0]))
    return MISOFileData(
        samples=samples, header=header, log_scores=scores,
        sampled_map=[float(v) for v in samples[map_idx]],
        sampled_map_log_score=float(scores[map_idx]),
        counts_info=get_counts_from_header(header),
        params=parse_sampler_params_from_header(header),
    )


def load_miso_file(source) -> Optional[MISOFileData]:
    """Parse a .miso file (path, or iterable of lines).
    Ref: samples_utils.py:130-156."""
    if isinstance(source, str):
        # hot path: native sample-block parse (parselib.cpp) -- releases
        # the GIL, so summarize/compare thread pools use real cores
        from miso_jax import native
        with open(source, "rb") as f:
            data = f.read()
        i1 = data.find(b"\n")
        i2 = data.find(b"\n", i1 + 1) if i1 >= 0 else -1
        if i2 >= 0:
            parsed = native.parse_samples(data[i2 + 1:])
            if parsed is not None:
                header = data[:i1].decode("utf-8", "replace").rstrip("\r")
                return _miso_file_data(header, *parsed)
        lines = data.decode("utf-8", "replace").splitlines(keepends=True)
    else:
        lines = [l for l in source]
    if len(lines) < 3:
        return None
    header = lines[0].rstrip("\n")
    # bulk parse: one delimiter normalization + one C-level float
    # conversion (the per-line Python loop made summarize_miso 3x
    # slower than quantification at 50k events)
    samples = scores = None
    if len(lines) > 2:
        ncols = lines[2].count(",") + 2
        toks = "".join(lines[2:]).replace("\t", ",").replace(
            "\n", ",").split(",")
        while toks and toks[-1] == "":
            toks.pop()
        if toks and len(toks) % ncols == 0:
            try:
                arr = np.asarray(toks, dtype=np.float64
                                 ).reshape(-1, ncols)
                # ragged files with compensating missing/extra fields
                # can still divide evenly; require one parsed row per
                # sample line before trusting the bulk parse.  Only
                # TRAILING blanks are discounted (a full per-line strip
                # pass halved catalog-scale load throughput); interior
                # blank lines mismatch and take the per-line fallback,
                # which handles them.
                n_lines = len(lines) - 2
                while n_lines > 0 and not lines[2 + n_lines - 1].strip():
                    n_lines -= 1
                if len(arr) == n_lines:
                    samples = arr[:, :-1]
                    scores = arr[:, -1]
            except ValueError:
                samples = scores = None
    if samples is None:  # ragged/odd formatting: per-line fallback
        samples = []
        scores = []
        try:
            for line in lines[2:]:
                line = line.strip()
                if not line:
                    continue
                psi_str, score_str = line.split("\t")
                samples.append([float(v) for v in psi_str.split(",")])
                scores.append(float(score_str))
        except ValueError:
            return None
        if not samples:
            return None
        samples = np.array(samples)
        scores = np.array(scores)
    return _miso_file_data(header, samples, scores)


def get_gene_info_from_params(params: Dict[str, str]) -> Dict[str, str]:
    """Ref: samples_utils.py:214-228."""
    out = {"chrom": "NA", "strand": "NA", "mRNA_starts": "NA",
           "mRNA_ends": "NA"}
    for k in out:
        if k in params:
            out[k] = params[k]
    return out


# ------------------------------------------------------------ directory

def is_miso_chrom_dir(dirname: str) -> bool:
    """Ref: samples_utils.py:332-348."""
    if not os.path.isdir(dirname):
        return False
    base = os.path.basename(dirname)
    if base.startswith("chr") or base.isdigit() or base in ("X", "Y"):
        return True
    return len(glob.glob(os.path.join(dirname, "*.miso"))) >= 1


class MISOSamples:
    """A MISO output directory: chromosome subdirs of .miso files (or
    .miso_db sqlite packs).  Ref: samples_utils.py:21-120."""

    def __init__(self, samples_dir: str, use_compressed: Optional[str] = None):
        from miso_jax.io import miso_db
        self.samples_dir = samples_dir
        self.compressed_ids_to_genes = None
        if use_compressed is not None:
            from miso_jax.io.index import load_compressed_ids_to_genes
            self.compressed_ids_to_genes = \
                load_compressed_ids_to_genes(use_compressed)
        self.event_names_to_fnames: Dict[str, str] = {}
        self._dbs: Dict[str, object] = {}
        filenames = self._collect_filenames(samples_dir)
        for fname in filenames:
            if fname.endswith(".miso"):
                name = os.path.basename(fname)[:-len(".miso")]
                if self.compressed_ids_to_genes is not None:
                    name = self.compressed_ids_to_genes.get(name, name)
                self.event_names_to_fnames[name] = fname
            elif miso_db.is_miso_db_fname(fname):
                db = miso_db.MISODatabase(
                    fname, comp_to_uncomp=self.compressed_ids_to_genes)
                self._dbs[fname] = db
                for ev in db.get_all_event_names():
                    self.event_names_to_fnames[str(ev)] = fname
        self.all_event_names = list(self.event_names_to_fnames.keys())
        self.num_events = len(self.all_event_names)

    @staticmethod
    def _collect_filenames(samples_dir: str) -> List[str]:
        from miso_jax.io import miso_db
        dirs = [d for d in glob.glob(os.path.join(samples_dir, "*"))
                if is_miso_chrom_dir(d)]
        filenames = []
        for d in dirs:
            filenames.extend(
                os.path.join(d, f) for f in os.listdir(d))
        filenames.extend(
            os.path.join(samples_dir, f) for f in os.listdir(samples_dir))
        filenames = [f for f in filenames
                     if not os.path.isdir(f)
                     and not os.path.basename(f).startswith(".")]
        return [f for f in filenames
                if f.endswith(".miso") or miso_db.is_miso_db_fname(f)]

    def get_event_samples(self, event_name: str) -> Optional[MISOFileData]:
        from miso_jax.io import miso_db
        fname = self.event_names_to_fnames.get(event_name)
        if fname is None:
            return None
        if fname.endswith(".miso"):
            return load_miso_file(fname)
        # one cached connection per .miso_db (opening sqlite per event
        # bound packed-source summarize/compare)
        db = self._dbs.get(fname)
        if db is None:
            db = miso_db.MISODatabase(
                fname, comp_to_uncomp=self.compressed_ids_to_genes)
            self._dbs[fname] = db
        row = db.get_event_raw(event_name)
        if row is None:
            return None
        body, header_block = row
        # native sample-block parse (same fast path as .miso files)
        from miso_jax import native
        parsed = native.parse_samples(body.encode())
        if parsed is not None:
            header = header_block.split("\n", 1)[0].rstrip("\r")
            return _miso_file_data(header, *parsed)
        import io as io_mod
        return load_miso_file(io_mod.StringIO(header_block + body))


# ------------------------------------------------------------- summarize

SUMMARY_HEADER_FIELDS = [
    "event_name", "miso_posterior_mean", "ci_low", "ci_high",
    "isoforms", "counts", "assigned_counts",
    "chrom", "strand", "mRNA_starts", "mRNA_ends",
]


def summary_row_from_data(event_name: str, data: MISOFileData
                          ) -> List[str]:
    """One `.miso_summary` row from loaded samples (the text path's row
    construction, shared by summarize_sampler_results and the resumed-
    run backfill).  Ref: samples_utils.py:263-329."""
    fields = format_credible_intervals(event_name, data.samples)
    fields.append(get_isoforms_from_header(data.header))
    fields.append(data.counts_info["counts"])
    fields.append(data.counts_info["assigned_counts"])
    gene_info = get_gene_info_from_params(data.params)
    fields.extend([gene_info["chrom"], gene_info["strand"],
                   gene_info["mRNA_starts"], gene_info["mRNA_ends"]])
    return fields


def summary_row_fields(event: CompiledEvent, res: dict
                       ) -> Optional[List[str]]:
    """Build one `.miso_summary` row STRAIGHT from a run result dict --
    no .miso text round-trip (the reference always re-reads the sample
    files it just wrote: samples_utils.py:263-329).  `res['summary']`
    carries (mean, ci_low, ci_high) vectors at tick (1e-4) precision,
    computed on device by the pipeline; every other field is generated
    by the same functions that generate the .miso header, so the row is
    byte-identical to what summarize_miso would produce from the file."""
    summ = res.get("summary")
    if summ is None:
        return None
    mean, lo, hi = summ
    gene = event.gene
    k = event.num_iso
    if k > 2:
        mean_s = ",".join("%.2f" % v for v in mean[:k])
        lo_s = ",".join("%.2f" % v for v in lo[:k])
        hi_s = ",".join("%.2f" % v for v in hi[:k])
    else:
        # 2-isoform events summarize column 0 only
        # (credible_intervals.py:31-55 via format_credible_intervals)
        mean_s, lo_s, hi_s = ("%.2f" % mean[0], "%.2f" % lo[0],
                              "%.2f" % hi[0])
    chrom = gene.chrom if gene.chrom is not None else "NA"
    strand = gene.strand if gene.strand is not None else "NA"
    mrna_starts = ",".join(str(gene.iso_genomic_span(i)[0])
                           for i in range(gene.num_isoforms))
    mrna_ends = ",".join(str(gene.iso_genomic_span(i)[1])
                         for i in range(gene.num_isoforms))
    return [event.name, mean_s, lo_s, hi_s,
            isoforms_str(gene)[1:-1], event.counts_str(),
            assigned_counts_str(res["final_n"], k),
            chrom, strand, mrna_starts, mrna_ends]


def write_summary_file(summary_filename: str, rows: Dict[str, str],
                       merge: bool = True) -> int:
    """Write a `.miso_summary` table from {event_name: row-line} (rows
    are tab-joined field strings, no trailing newline), sorted by event
    name.  With merge=True an existing summary file's rows are kept for
    events not in `rows`, so resumed runs (skip-done events never reach
    the device) do not truncate a previously complete summary."""
    os.makedirs(os.path.dirname(os.path.abspath(summary_filename)),
                exist_ok=True)
    existing: Dict[str, str] = {}
    if merge and os.path.isfile(summary_filename):
        with open(summary_filename) as f:
            f.readline()  # header
            for line in f:
                line = line.rstrip("\n")
                if line:
                    existing[line.split("\t", 1)[0]] = line
    existing.update(rows)
    with open(summary_filename, "w") as out:
        out.write("\t".join(SUMMARY_HEADER_FIELDS) + "\n")
        for name in sorted(existing):
            out.write(existing[name] + "\n")
    return len(existing)


def summarize_sampler_results(samples_dir: str, summary_filename: str,
                              use_compressed: Optional[str] = None) -> int:
    """Write the `.miso_summary` table; returns events summarized.
    Ref: samples_utils.py:263-329."""
    from concurrent.futures import ThreadPoolExecutor

    os.makedirs(os.path.dirname(os.path.abspath(summary_filename)),
                exist_ok=True)
    samples_obj = MISOSamples(samples_dir, use_compressed=use_compressed)
    num_events = 0
    # chunked thread-pool loads: the native sample parser releases the
    # GIL (native/parselib.cpp), so catalog-scale summaries use real
    # cores for the file parse
    names = samples_obj.all_event_names
    with open(summary_filename, "w") as out, \
            ThreadPoolExecutor(max_workers=4) as pool:
        out.write("\t".join(SUMMARY_HEADER_FIELDS) + "\n")
        for lo in range(0, len(names), 512):
            sub = names[lo:lo + 512]
            for event_name, data in zip(
                    sub, pool.map(samples_obj.get_event_samples, sub)):
                if data is None:
                    print("WARNING: Skipping %s" % event_name)
                    continue
                out.write("\t".join(
                    summary_row_from_data(event_name, data)) + "\n")
                num_events += 1
    return num_events
