"""End-to-end quantification pipeline: indexed GFF + alignments -> .miso.

The batched replacement for the reference's process fan-out
(misopy/miso.py:70-337 GenesDispatcher + run_miso.py:34-202
compute_gene_psi): instead of forking a worker per gene batch, a host
producer thread compiles events chromosome-by-chromosome (one streaming
columnar scan + ONE native match+collapse call per chromosome,
prefetched one chromosome ahead) while the main thread buckets finished
events by padded shape and dispatches full buckets to the device -- host
compile, device sampling, quantized readback, and .miso writes all
overlap, so catalog wall-clock is ~max(compile, device+transfer) instead
of their sum.

Per-event skip rules replicated:
- no reads fetched (miso_sampler.py:229-231)
- fewer than min_event_reads (run_miso.py:141-146)
- single-isoform genes (miso_sampler.py:272-276)
- existing .miso output => resume/idempotency (miso_sampler.py:234-238)
- all reads incompatible with the annotation (miso_sampler.py:352-354)
"""
from __future__ import annotations

import dataclasses
import os
import queue as queue_mod
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from miso_jax.core.events import (CompiledEvent, bucket_events, _round_up,
                                  _round_up_iso, _round_up_reads,
                                  compile_paired_end, compile_paired_end_many,
                                  compile_single_end,
                                  compile_single_end_many, pad_events)
from miso_jax.core.gene import Gene
from miso_jax.io import sam as sam_io
from miso_jax.io.index import get_gene_ids_to_filenames, load_indexed_gene
from miso_jax.io.miso_file import write_miso_file
from miso_jax.io.settings import Settings
from miso_jax.sampler.mcmc import (EventBatch, SamplerConfig, run_batch,
                                   select_backend)


@dataclasses.dataclass
class RunConfig:
    read_len: int
    overhang_len: int = 1
    paired_end: bool = False
    mean_frag_len: Optional[float] = None
    frag_variance: Optional[float] = None
    num_sds: float = 4.0
    iters: int = 5000
    burn_in: int = 500
    lag: int = 10
    chains: int = 6
    algorithm: str = "reassign"
    min_event_reads: int = 20
    strand_rule: Optional[str] = None
    max_batch_events: int = 4096
    filter_read_len: Optional[int] = None  # drop reads of other lengths
    # 'auto' -> mcmc.select_backend (the fused REASSIGN kernel on a GPU,
    # the XLA scan otherwise); 'pallas' forces the kernel, 'xla' the scan
    backend: str = "auto"
    # chain start: 'auto' (miso.c:348 AUTO) or 'linear' (MISO_START_LINEAR,
    # miso.c:410-443: NNLS deconvolution seeds every chain)
    start: str = "auto"
    # stop rule: 'fixed' (MISO_STOP_FIXEDNO, the reference CLI default,
    # miso_sampler.py:211) or 'convergent' (R-hat <= 1.1 with the
    # 3*noIter - 2*burnIn adaptive extension, miso.c:903-928)
    stop: str = "fixed"
    max_iters: int = 500000
    # convergent-mode extension factor g: unconverged events continue
    # with iters' = iters + g*(iters - burn_in) (g=2 is the reference
    # rule noIter' = 3*noIter - 2*burnIn, miso.c:920-928; smaller
    # opt-in values extend stragglers in cheaper increments under the
    # same R-hat test)
    convergent_growth: float = 2.0
    # skip .miso sample bodies entirely: posterior mean + Chen-Shao CIs
    # compute ON DEVICE and only the per-event summary payload (a few
    # bytes/event instead of ~10 KB of quantized samples) leaves the
    # device -- the replacement for run-then-summarize
    # (misopy/samples_utils.py:263-329 re-reads every .miso file)
    summary_only: bool = False
    # stream events into per-chromosome .miso_db sqlite DURING the run
    # instead of writing the .miso text tree and re-packing it with
    # miso_pack afterwards (misopy/miso_pack.py:29-79)
    pack_output: bool = False

    @classmethod
    def from_settings(cls, settings: Settings, read_len: int, **kw):
        sp = settings.get_sampler_params()
        return cls(
            read_len=read_len,
            iters=kw.pop("iters", sp["num_iters"]),
            burn_in=kw.pop("burn_in", sp["burn_in"]),
            lag=kw.pop("lag", sp["lag"]),
            chains=kw.pop("chains", sp["num_chains"]),
            min_event_reads=kw.pop("min_event_reads",
                                   settings.get_min_event_reads()),
            strand_rule=kw.pop("strand_rule", settings.get_strand_param()),
            stop=kw.pop("stop", settings.get_stop_rule()),
            max_iters=kw.pop("max_iters", settings.get_max_iters()),
            **kw)


def chrom_output_dir(output_dir: str, chrom: Optional[str]) -> str:
    return os.path.join(output_dir, chrom if chrom else "NA")


def event_output_path(output_dir: str, gene: Gene, name: str) -> str:
    return os.path.join(chrom_output_dir(output_dir, gene.chrom),
                        "%s.miso" % name)


def compile_gene_event(
    gene: Gene,
    name: str,
    reads: Tuple[Sequence[int], Sequence[str]],
    cfg: RunConfig,
) -> Optional[CompiledEvent]:
    """Compile one gene's reads into an event; None if skipped."""
    positions, cigars = reads
    if gene.num_isoforms < 2:
        return None
    num_units = len(positions) // 2 if cfg.paired_end else len(positions)
    if num_units == 0 or num_units < cfg.min_event_reads:
        return None
    # +1: 0-based alignment positions -> 1-based matcher coordinates
    # (miso_sampler.py:284)
    pos1 = np.asarray(positions, dtype=np.int64) + 1
    # PackedCigars pass through untouched (the native matcher consumes
    # the packed buffer zero-copy); only plain sequences are listified
    cig = cigars if hasattr(cigars, "buf") else list(cigars)
    if cfg.paired_end:
        ev = compile_paired_end(
            gene, pos1, cig, read_len=cfg.read_len,
            mean_frag_len=cfg.mean_frag_len, frag_variance=cfg.frag_variance,
            num_sds=cfg.num_sds, overhang=cfg.overhang_len, name=name)
    else:
        ev = compile_single_end(
            gene, pos1, cig, read_len=cfg.read_len,
            overhang=cfg.overhang_len, name=name, algorithm=cfg.algorithm)
    if not ev.any_compatible:
        return None
    return ev


CHECKOUT_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def compilation_cache_dir() -> Optional[str]:
    """Where the persistent compile cache lives: None when
    JAX_COMPILATION_CACHE_DIR is set (JAX reads it itself), else the
    fixed, git-ignored `<checkout>/.jax_cache`."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return os.path.join(CHECKOUT_DIR, ".jax_cache")


def enable_compilation_cache() -> None:
    """Persistent XLA compile cache: each batch shape compiles once per
    cache directory, and later runs of the same shapes load it."""
    import jax

    cache_dir = compilation_cache_dir()
    if cache_dir is None:
        return
    os.makedirs(cache_dir, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1)


def resolve_mesh(mesh="auto"):
    """Resolve the event mesh for production runs.

    'auto' -> 1-D mesh over all LOCAL devices (each host quantifies its
    own gene shard; the event axis has no cross-device traffic, so the
    mesh never spans hosts).  This replaces the reference's
    fork-per-batch fan-out (misopy/miso.py:166-169,263 num_processors
    subprocesses).  A single device runs unsharded (None).
    """
    if mesh != "auto":
        return mesh
    import jax

    devices = jax.local_devices()
    if len(devices) <= 1:
        return None
    from miso_jax.parallel.mesh import make_event_mesh
    return make_event_mesh(devices)


def _bucket_key(ev: CompiledEvent) -> Tuple[int, int, int]:
    return (_round_up_iso(ev.num_iso),
            _round_up(max(ev.num_classes, 1)),
            _round_up_reads(max(int(ev.counts.sum()), 1)))


class _LazyResult(dict):
    """Per-event result dict whose float 'samples'/'loglik' arrays
    materialize on first access from the quantized device payload.
    The streamed .miso writer consumes 'psi_ticks'/'score_cents'
    directly (they ARE the output precision), so catalog runs never
    build the float arrays at all; run_events consumers still see the
    float API unchanged."""

    def __missing__(self, key):
        if key == "samples":
            t = self["psi_ticks"]          # (S, I) uint16
            if t.shape[1] == 2:
                c0 = t[:, 0].astype(np.float64) / 1e4
                v = np.stack([c0, 1.0 - c0], axis=-1)
            else:
                v = t.astype(np.float32) / 1e4
            self[key] = v
            return v
        if key == "loglik":
            v = self["score_cents"].astype(np.float64) / 100.0
            self[key] = v
            return v
        raise KeyError(key)


def _expand_read_tensors(weights, log_read, counts, R: int):
    """Device-side expansion of the per-read tensors from the (E, C, I)
    class tensors: read slot r of event e carries class c's weights,
    where c is the class whose cumulative count interval contains r
    (exactly pad_events' np.repeat layout, class 0 first).  Jitted by
    the caller; uploading the expanded (E, R, I) tensors from the host
    cost ~10 MB of H2D per chunk vs ~0.3 MB for the class tensors."""
    import jax.numpy as jnp

    cum = jnp.cumsum(counts, axis=1)                   # (E, C)
    slots = jnp.arange(R, dtype=counts.dtype)          # (R,)
    cid = jnp.sum(cum[:, :, None] <= slots[None, None, :],
                  axis=1)                              # (E, R)
    valid = slots[None, :] < cum[:, -1:]               # (E, R)
    C = weights.shape[1]
    gather = cid[:, :, None].clip(0, C - 1)
    read_w = jnp.where(
        valid[:, :, None],
        jnp.take_along_axis(weights, gather, axis=1), 0.0)
    read_ls = jnp.where(
        valid[:, :, None],
        jnp.take_along_axis(log_read, gather, axis=1), 0.0)
    return (read_w.astype(jnp.bfloat16), read_ls.astype(jnp.bfloat16))


def _expand_jit(weights, log_read, counts, R: int):
    import jax
    global _EXPAND_JIT
    if _EXPAND_JIT is None:
        _EXPAND_JIT = jax.jit(_expand_read_tensors,
                              static_argnames=("R",))
    return _EXPAND_JIT(weights, log_read, counts, R)


_EXPAND_JIT = None


def _summary_stats(quant, lo: int, hi: int):
    """Device-side posterior summary of the quantized psi ticks:
    per-(event, isoform) tick sums (exact -- the host reduces the
    segment partials in int64 and divides in float64, so the mean
    matches a float64 mean of the 1e-4-quantized samples) plus the
    Chen-Shao order statistics at the lo/hi bound indices
    (credible_intervals.py:31-55 index arithmetic; sorting the ticks
    picks exactly the values sorting the parsed floats would).
    quant: (E, S) two-isoform column 0, or (E, S, I).

    Sums are SEGMENTED: one int32 sum covers at most 131072 samples
    (ticks <= 10^4, so a segment sum <= 1.3e9 < 2^31; a single int32
    sum would overflow for retained counts above ~214k, e.g. lag=1
    schedules), and the (E, n_seg[, I]) partials transfer to the host
    for an exact int64 reduction (device int64 needs x64 mode)."""
    import jax.numpy as jnp

    s = jnp.sort(quant, axis=1)
    SEG = 131072
    S = quant.shape[1]
    partials = [
        jnp.sum(quant[:, i:i + SEG].astype(jnp.int32), axis=1)
        for i in range(0, S, SEG)
    ]
    ssum = jnp.stack(partials, axis=1)  # (E, n_seg[, I])
    return ssum, s[:, lo], s[:, hi]


def _summary_jit(quant, lo: int, hi: int):
    import jax
    global _SUMMARY_JIT
    if _SUMMARY_JIT is None:
        _SUMMARY_JIT = jax.jit(_summary_stats,
                               static_argnames=("lo", "hi"))
    return _SUMMARY_JIT(quant, lo, hi)


_SUMMARY_JIT = None


def _ci_bound_indices(num_samples: int,
                      confidence_level: float = 0.95):
    """(lo, hi) sorted-sample indices, or None if the sample count is
    too small for the interval (the shared Chen-Shao rule)."""
    from miso_jax.stats.intervals import ci_bound_indices
    return ci_bound_indices(num_samples, confidence_level)


class StreamRunner:
    """Streaming device dispatcher: events arrive one at a time (from the
    compile producer), accumulate into (pad_iso, pad_classes, pad_reads)
    shape buckets, and every full bucket is dispatched to the device
    immediately -- device execution overlaps further host compile, and a
    dedicated materializer thread pulls finished chunks back so the
    device->host transfer overlaps both.

    `on_chunk(tags, results)` fires on the materializer thread as soon
    as a chunk's results land on the host (results[i] is the result dict
    for the event added with tags[i]).

    `bucket_stats`, if given, collects one dict per device batch:
    {shape, events, seconds, events_per_s} -- the per-bucket device-time
    counters the reference lacks (its only timer is the per-event
    wall-clock print, miso_sampler.py:373).

    Chunk event axes are padded to a bounded shape set (powers of two up
    to max_batch_events, via _pow2_pad_events) so arbitrary catalog
    sizes never mint new compile shapes.  PRNG chunk keys reproduce the
    batch run_events keys exactly (fold of chunk offset + shape axes).
    """

    MAX_PENDING = 4  # chunks of device-side lookahead (HBM retention)

    def __init__(self, cfg: RunConfig, seed: int = 0, mesh="auto",
                 bucket_stats: Optional[list] = None, on_chunk=None):
        enable_compilation_cache()
        self.cfg = cfg
        self.seed = seed
        self.mesh = resolve_mesh(mesh)
        self.bucket_stats = bucket_stats
        self.on_chunk = on_chunk
        self.sampler_cfg_base = SamplerConfig(
            iters=cfg.iters, burn_in=cfg.burn_in, lag=cfg.lag,
            chains=cfg.chains, algorithm=cfg.algorithm)
        self.buckets: Dict[Tuple[int, int, int], Tuple[list, list]] = {}
        self.bucket_off: Dict[Tuple[int, int, int], int] = {}
        self.bucket_chunks: Dict[Tuple[int, int, int], int] = {}
        self._pending: "queue_mod.Queue" = queue_mod.Queue(
            maxsize=self.MAX_PENDING)
        self._mat_err: list = []
        # one materializer thread: a simple ordered pipeline
        self._mat_threads = [
            threading.Thread(target=self._materialize_loop, daemon=True)]
        for t in self._mat_threads:
            t.start()

    # ------------------------------------------------------------ intake
    def add(self, ev: CompiledEvent, tag=None) -> None:
        key = _bucket_key(ev)
        evs, tags = self.buckets.setdefault(key, ([], []))
        evs.append(ev)
        tags.append(ev if tag is None else tag)
        # progressive chunk sizing (512 -> 1024 -> 2048 -> max): the
        # first chunks of a bucket dispatch early so device execution,
        # transfer, and writes start while the host is still compiling
        # -- a catalog smaller than max_batch_events otherwise pipelines
        # nothing (its whole bucket flushed at finish).  Steady-state
        # chunks stay at max_batch_events; the early shapes are
        # powers of two already minted by the finish-flush slicing.
        # Convergent mode keeps whole buckets: each chunk pays its own
        # multi-round adaptive loop (R-hat fetches, continuation
        # compiles), so splitting multiplies latency instead of
        # overlapping it.
        n_disp = self.bucket_chunks.get(key, 0)
        thresh = (self.cfg.max_batch_events if self.cfg.stop == "convergent"
                  else min(self.cfg.max_batch_events,
                           max(512 << n_disp, 1)))
        if len(evs) >= thresh:
            del self.buckets[key]
            self.bucket_chunks[key] = n_disp + 1
            self._dispatch(key, evs, tags)
        self._check_err()

    def finish(self) -> None:
        """Flush partial buckets, drain pending chunks, join threads.

        Partial buckets flush in sub-chunks: a small catalog (or any
        paired run under max_batch_events) otherwise lands in ONE
        monolithic dispatch at finish, serializing device execution,
        transfer, and writes that the streaming path overlaps.  Slices
        pad to the same power-of-two shapes, and each dispatch consumes
        its own PRNG chunk offset, so results stay deterministic for a
        given catalog."""
        step = (self.cfg.max_batch_events
                if self.cfg.stop == "convergent"
                else max(256, self.cfg.max_batch_events // 8))
        for key in sorted(self.buckets):
            evs, tags = self.buckets[key]
            for lo in range(0, len(evs), step):
                self._dispatch(key, evs[lo:lo + step],
                               tags[lo:lo + step])
        self.buckets.clear()
        for _ in self._mat_threads:
            self._put(None)
        for t in self._mat_threads:
            t.join()
        self._check_err()

    def abort(self) -> None:
        """Error-path shutdown: discard queued chunks and stop the
        materializer without flushing buckets.  Draining first
        guarantees the shutdown sentinel always fits in the bounded
        queue (a full queue previously dropped it, leaving the thread
        blocked on get() forever when the device was still healthy)."""
        self.buckets.clear()
        try:
            while True:
                self._pending.get_nowait()
        except queue_mod.Empty:
            pass
        # only the dispatch thread (this one) refills the queue, so the
        # sentinels fit now
        for _ in self._mat_threads:
            try:
                self._pending.put(None, timeout=5)
            except queue_mod.Full:
                pass
        for t in self._mat_threads:
            t.join(timeout=30)

    def _put(self, item) -> None:
        """Bounded put that cannot deadlock if the materializer died."""
        while True:
            try:
                self._pending.put(item, timeout=5)
                return
            except queue_mod.Full:
                self._check_err()
                if not any(t.is_alive() for t in self._mat_threads):
                    raise RuntimeError("materializer threads died")

    def _check_err(self):
        if self._mat_err:
            raise self._mat_err[0]

    # ---------------------------------------------------------- dispatch
    def _dispatch(self, key, evs, tags) -> None:
        import jax
        import jax.numpy as jnp

        from miso_jax.sampler.mcmc import _pow2_pad_events

        cfg = self.cfg
        pad_iso, pad_classes, pad_reads = key
        t_bucket = time.time()
        # very deep events: per-class multinomial Gibbs keeps device
        # memory and per-iteration work O(classes) instead of O(reads)
        # -- the per-read tensors are never materialized
        # (docs/DEEP_EVENTS.md)
        deep = pad_reads > 16384 and cfg.algorithm == "reassign"
        # fixed-stop: the per-read (E, R, I) tensors are never built on
        # the host -- pad only the class tensors and expand on device
        # below.  Convergent mode re-slices the batch per adaptive
        # round on the host, so it keeps the host-side tensors.
        per_read_host = cfg.stop == "convergent" and not deep
        pad = pad_events(evs, pad_iso=pad_iso, pad_classes=pad_classes,
                         pad_reads=pad_reads, per_read=per_read_host)
        batch = EventBatch(**{k: np.asarray(v) for k, v in pad.items()})
        sampler_cfg = self.sampler_cfg_base
        if deep:
            sampler_cfg = dataclasses.replace(self.sampler_cfg_base,
                                              gibbs="multinomial")
        # key mixing must include EVERY bucket-shape axis AND the chunk
        # offset within the bucket: buckets differing only in pad_reads
        # (or successive chunks) would otherwise replay identical
        # per-(event, chain) random streams, correlating Monte-Carlo
        # error across the catalog
        lo = self.bucket_off.get(key, 0)
        self.bucket_off[key] = lo + cfg.max_batch_events
        kkey = jax.random.fold_in(
            jax.random.fold_in(jax.random.PRNGKey(self.seed),
                               lo + pad_iso * 131071
                               + pad_classes * 8191),
            pad_reads)
        start_psi = None
        if cfg.start == "linear":
            from miso_jax.core.assignment import linear_start_psi
            I_pad = batch.weights.shape[2]
            sp = np.zeros((len(evs), cfg.chains, I_pad), np.float32)
            for j, ev in enumerate(evs):
                try:
                    expr = linear_start_psi(ev, cfg.read_len,
                                            cfg.overhang_len)
                except Exception:
                    expr = np.full(ev.num_iso, 1.0 / ev.num_iso)
                sp[j, :, :ev.num_iso] = expr[None, :]
            start_psi = sp
        backend = select_backend(cfg.backend, jax.default_backend(),
                                 cfg.algorithm, sampler_cfg.gibbs)
        if cfg.stop == "convergent":
            # R-hat <= 1.1 adaptive stopping (miso.c:903-928): only
            # unconverged events re-run, with extended schedules.
            # GIVEN-start kernel support keeps continuation rounds on
            # the fused kernel.  Synchronous on the dispatch
            # thread (each adaptive round needs the previous round's
            # R-hat on the host).
            from miso_jax.sampler.mcmc import run_batch_convergent
            conv_res, _ = run_batch_convergent(
                kkey, batch, sampler_cfg, max_iters=cfg.max_iters,
                mesh=self.mesh, start_psi=start_psi, backend=backend,
                extend_factor=cfg.convergent_growth)
            # posterior summaries at tick precision, BATCHED per
            # adaptive schedule (same-S events stack into one numpy
            # sort/mean pass; the per-event loop cost ~1ms x E of the
            # convergent wall).  Same arithmetic as the device path;
            # convergent results arrive as floats, so
            # quantize-then-summarize on the host.
            sched_groups: Dict[int, list] = {}
            for j in range(len(evs)):
                sched_groups.setdefault(
                    conv_res[j]["samples"].shape[0], []).append(j)
            summaries: Dict[int, tuple] = {}
            for S, idxs in sched_groups.items():
                bounds = _ci_bound_indices(S)
                if bounds is None:
                    continue
                T = np.clip(np.round(np.stack(
                    [conv_res[j]["samples"] for j in idxs]) * 1e4),
                    0, 10000).astype(np.int64)      # (n, S, I_pad)
                st = np.sort(T, axis=1)
                mean = (T.astype(np.float64) / 1e4).mean(axis=1)
                lo = st[:, bounds[0]] / 1e4
                hi = st[:, bounds[1]] / 1e4
                for t_i, j in enumerate(idxs):
                    summaries[j] = (mean[t_i], lo[t_i], hi[t_i])
            results = []
            for j, ev in enumerate(evs):
                r = conv_res[j]
                k = ev.num_iso
                fn = r["final_n"][0, :k]
                if cfg.algorithm != "reassign":
                    # final assignment pass from the END-OF-CHAIN psi
                    # (chain 0), as in the fixed-stop path
                    # (miso.c:935-947)
                    fn = ev.final_assignment_counts(r["final_psi"][0, :k])
                res_d = {
                    "samples": r["samples"][:, :k],
                    "loglik": r["loglik"],
                    "percent_accept": 100.0 * r["accepted"]
                        / max(r["accepted"] + r["rejected"], 1),
                    "final_n": fn,
                    "iters": int(r["iters"]),
                    "burn_in": int(r["burn_in"]),
                }
                if j in summaries:
                    res_d["summary"] = summaries[j]
                results.append(res_d)
            if self.bucket_stats is not None:
                dt = time.time() - t_bucket
                self.bucket_stats.append({
                    "shape": key, "events": len(evs), "seconds": dt,
                    "events_per_s": len(evs) / max(dt, 1e-9),
                    "stop": "convergent"})
            if self.on_chunk is not None:
                self.on_chunk(tags, results)
            return
        # bounded compile shapes: pad the event axis to a power of two
        # (full chunks of max_batch_events stay untouched when it is
        # one) -- arbitrary catalog sizes reuse cached shapes
        batch, start_psi = _pow2_pad_events(batch, start_psi, len(evs))
        if not deep:
            rw, rls = _expand_jit(batch.weights, batch.log_read,
                                  batch.counts, R=pad_reads)
            batch = batch._replace(read_w=rw, read_logscore=rls)
        sp_j = (None if start_psi is None
                else jax.numpy.asarray(start_psi))
        if self.mesh is not None:
            from miso_jax.parallel.mesh import run_batch_sharded
            res = run_batch_sharded(kkey, batch, sampler_cfg,
                                    mesh=self.mesh, backend=backend,
                                    start_psi=start_psi)
        elif backend == "pallas":
            from miso_jax.sampler.pallas_kernel import run_batch_pallas
            res = run_batch_pallas(kkey, batch, sampler_cfg,
                                   start_psi=sp_j)
        else:
            res = run_batch(kkey, batch, sampler_cfg, start_psi=sp_j)
        # fetch psi quantized to 1e-4 on device: exactly the .miso
        # output precision ("%.4f"), at a quarter of the bytes.
        # 2-isoform buckets (the dominant class) fetch ONLY column 0;
        # psi_2 = 1 - psi_1 reconstructs on the host.  Recorded
        # log-scores travel as per-event-offset uint16 centipoints
        # (the ".2f" output precision); rare events whose score range
        # exceeds the uint16 span fall back to their f32 rows.
        # Transfers are NOT forced here: the materializer thread pulls
        # them while this thread dispatches the next chunk.
        flat_psi = res.flat_samples()
        # clip to the 0..10000 tick range before the cast (mirrors
        # _format_sample_block's np.clip): a psi one ULP above 1.0 or a
        # garbage lane would otherwise overflow the uint16 LUT index
        if pad_iso == 2:
            quant = jnp.clip(jnp.round(flat_psi[:, :, 0] * 1e4),
                             0, 10000).astype(jnp.uint16)
        else:
            quant = jnp.clip(jnp.round(flat_psi * 1e4),
                             0, 10000).astype(jnp.uint16)
        # device-side posterior summary (mean tick sums + Chen-Shao
        # order statistics): a few bytes/event of readback; in
        # summary_only mode it is the ONLY per-sample payload fetched
        bounds = _ci_bound_indices(quant.shape[1])
        summ = (None if bounds is None
                else _summary_jit(quant, bounds[0], bounds[1]))
        if cfg.summary_only:
            quant = ll = cmin = cmax = resid = None
        else:
            ll = res.flat_loglik()
            cents = jnp.round(ll * 100.0)
            cmin = jnp.min(cents, axis=1)
            cmax = jnp.max(cents, axis=1)
            resid = jnp.clip(cents - cmin[:, None], 0,
                             65535).astype(jnp.uint16)
        # bound device-memory retention: each pending chunk pins its
        # full-precision loglik (the wide-row fallback source) plus the
        # quantized buffers in HBM; the bounded queue supplies a few
        # chunks of transfer/compute overlap and backpressure beyond it
        self._put({
            "evs": evs, "tags": tags, "quant": quant,
            "two_iso": pad_iso == 2, "summ": summ,
            "n_samples": int(res.flat_samples().shape[1]),
            "ll_min": cmin, "ll_max": cmax, "ll_resid": resid,
            "ll_full": ll, "accepted": res.accepted,
            "rejected": res.rejected, "final_n": res.final_n,
            "final_psi": res.final_psi, "backend": backend,
            "t0": t_bucket, "shape": key})
        self._check_err()

    # ------------------------------------------------------- materialize
    def _materialize_loop(self):
        while True:
            p = self._pending.get()
            if p is None:
                return
            try:
                self._materialize_chunk(p)
            except BaseException as e:  # surfaced on the caller thread
                self._mat_err.append(e)
                return

    def _materialize_chunk(self, p: dict) -> None:
        import jax

        cfg = self.cfg
        evs = p["evs"]
        # ONE device_get for the whole chunk payload (separate
        # np.asarray fetches would pay per-transfer overhead each).
        # summary_only fetches ONLY the summary
        # payload (KBs/chunk) -- the quantized sample matrices never
        # leave the device.
        fetch = {"accepted": p["accepted"], "rejected": p["rejected"],
                 "final_n": p["final_n"], "final_psi": p["final_psi"]}
        if p["quant"] is not None:
            fetch.update(quant=p["quant"], ll_min=p["ll_min"],
                         ll_max=p["ll_max"], ll_resid=p["ll_resid"])
        if p["summ"] is not None:
            fetch["summ"] = p["summ"]
        h = jax.device_get(fetch)
        accepted, rejected = h["accepted"], h["rejected"]
        final_n, final_psi = h["final_n"], h["final_psi"]
        n_real = len(evs)
        S = p["n_samples"]
        # per-event summary vectors at tick precision: the mean from the
        # host ticks when they are here (float64 mean of the quantized
        # samples -- bitwise what summarize_miso computes from the .miso
        # text), else from the exact device tick sums
        summary = None
        if p["summ"] is not None:
            ssum, lo_t, hi_t = h["summ"]
            # segment partials -> exact int64 total (see _summary_stats)
            ssum = ssum.astype(np.int64).sum(axis=1)
            lo_v = lo_t.astype(np.float64) / 1e4
            hi_v = hi_t.astype(np.float64) / 1e4
            if "quant" in h:
                mean_v = (h["quant"].astype(np.float64) / 1e4
                          ).mean(axis=1)
            else:
                mean_v = ssum.astype(np.float64) / S / 1e4
            if p["two_iso"]:  # column-0 scalars -> (E, 1) vectors
                mean_v, lo_v, hi_v = (a.reshape(len(a), 1)
                                      for a in (mean_v, lo_v, hi_v))
            summary = (mean_v, lo_v, hi_v)
        ticks = cmin_i = resid = None
        wide = set()
        if "quant" in h:
            q = h["quant"]
            cmin, cmax, resid = h["ll_min"], h["ll_max"], h["ll_resid"]
            # keep everything QUANTIZED: the ticks/centipoints ARE the
            # .miso output precision, so the writer formats them
            # directly and the float arrays (2 x ~90 MB of float64 per
            # 4096-event chunk) are only materialized lazily if an API
            # consumer asks (_LazyResult)
            if p["two_iso"]:
                ticks = np.empty(q.shape + (2,), np.uint16)
                ticks[:, :, 0] = q
                ticks[:, :, 1] = 10000 - q
            else:
                ticks = q
            with np.errstate(invalid="ignore"):
                # padded events carry NaN score rows; their cmin casts
                # to a garbage int that no real event ever reads
                cmin_i = np.round(np.nan_to_num(cmin.astype(np.float64))
                                  ).astype(np.int64)
            cmax_f = cmax.astype(np.float64)
            # padded events carry NaN score rows (masked lanes); only
            # the real rows matter, and only they may need the f32
            # fallback
            with np.errstate(invalid="ignore"):
                wide = set(np.flatnonzero(
                    (cmax_f[:n_real] - cmin[:n_real]) > 65535).tolist())
        results = []
        for j, ev in enumerate(evs):
            k = ev.num_iso
            fn = final_n[j, 0, :k]  # chain 0
            if cfg.algorithm != "reassign":
                # final assignment pass for non-REASSIGN algorithms
                # (miso.c:935-947)
                fn = ev.final_assignment_counts(final_psi[j, 0, :k])
            res = _LazyResult({
                "percent_accept": 100.0 * accepted[j]
                    / max(accepted[j] + rejected[j], 1),
                "final_n": fn,
            })
            if summary is not None:
                res["summary"] = (summary[0][j], summary[1][j],
                                  summary[2][j])
            if ticks is not None:
                res["psi_ticks"] = ticks[j, :, :k]
                if j in wide:  # rare: full-precision row fetch
                    res["loglik"] = np.asarray(p["ll_full"][int(j)])
                else:
                    res["score_cents"] = (resid[j].astype(np.int64)
                                          + cmin_i[j])
            results.append(res)
        if self.bucket_stats is not None:
            dt = time.time() - p["t0"]
            self.bucket_stats.append({
                "shape": p["shape"],
                "events": len(evs), "seconds": dt,
                "events_per_s": len(evs) / max(dt, 1e-9),
                "backend": p["backend"]})
        if self.on_chunk is not None:
            self.on_chunk(p["tags"], results)


def run_events(
    events: List[CompiledEvent],
    cfg: RunConfig,
    seed: int = 0,
    mesh="auto",
    bucket_stats: Optional[list] = None,
    on_chunk=None,
):
    """Run compiled events through the device sampler, bucketed by shape.

    Batch-list front-end over StreamRunner (production streams events
    straight from the compile producer; this keeps the simple API for
    tests/tools).  Events are sharded over all local devices (see
    `resolve_mesh`); pass mesh=None to force single-device execution, or
    an explicit jax.sharding.Mesh.

    `on_chunk(indices, results)`, if given, fires as soon as each
    chunk's results land in the output list -- the caller can start
    writing files while later chunks are still transferring.

    Returns a list parallel to `events` of per-event result dicts.
    """
    out: List[Optional[dict]] = [None] * len(events)

    def _on_chunk(tags, results):
        for i, res in zip(tags, results):
            out[i] = res
        if on_chunk is not None:
            on_chunk(tags, out)

    runner = StreamRunner(cfg, seed=seed, mesh=mesh,
                          bucket_stats=bucket_stats, on_chunk=_on_chunk)
    # preserve the batch dispatch order (bucket_events groups then sorts
    # by shape key) so PRNG chunk keys match the pre-streaming pipeline
    for key, idxs in bucket_events(events):
        for i in idxs:
            runner.add(events[i], tag=i)
    runner.finish()
    return out


def _write_event(output_dir: str, cfg: RunConfig, ev: CompiledEvent,
                 res: dict, body: bytes = None) -> None:
    """The single shared per-event .miso writer (every writing path --
    batch writer, streamed chunks, write_event_results -- routes here:
    ONE place to change the output contract).  Sample data resolves in
    preference order: a preformatted `body` (the batch formatter),
    the quantized device payload (psi_ticks/score_cents), then the
    float arrays (convergent results, wide-score fallbacks)."""
    path = event_output_path(output_dir, ev.gene, ev.name)
    samples = loglik = ticks = cents = None
    if body is None:
        ticks = res.get("psi_ticks")
        cents = res.get("score_cents")
        if ticks is None or cents is None:
            ticks = cents = None
            samples, loglik = res["samples"], res["loglik"]
    write_miso_file(
        path, ev, samples, loglik,
        # convergent stopping records the per-event final schedule
        iters=res.get("iters", cfg.iters),
        burn_in=res.get("burn_in", cfg.burn_in), lag=cfg.lag,
        percent_accept=res["percent_accept"], final_n=res["final_n"],
        psi_ticks=ticks, score_cents=cents, body=body)


def _iter_bodies(evs, results):
    """(ev, res, body-or-None) for a chunk slice, batch-formatting the
    sample bodies: ONE _format_quantized call covers every
    same-isoform-count event in the slice (per-event numpy formatting
    overhead -- ~20 small array ops each -- dominated the write phase
    at catalog scale).  Events without the quantized payload
    (convergent results, wide-score fallbacks) yield body=None."""
    from miso_jax.io.miso_file import _format_quantized

    groups: Dict[Tuple[int, int], list] = {}
    rest = []
    for ev, res in zip(evs, results):
        if res is None:
            continue
        t = res.get("psi_ticks")
        c = res.get("score_cents")
        if t is not None and c is not None:
            groups.setdefault((t.shape[1], t.shape[0]), []).append(
                (ev, res))
        else:
            rest.append((ev, res))
    for (k, S), items in groups.items():
        T = np.stack([r["psi_ticks"] for _, r in items]
                     ).astype(np.int64).reshape(-1, k)
        C = np.stack([r["score_cents"] for _, r in items]).reshape(-1)
        blob, off = _format_quantized(T, C, C < 0, return_offsets=True)
        for j, (ev, res) in enumerate(items):
            yield ev, res, blob[off[j * S]:off[(j + 1) * S]]
    for ev, res in rest:
        yield ev, res, None


def _write_events_batch(output_dir: str, cfg: RunConfig, evs, results
                        ) -> int:
    written = 0
    for ev, res, body in _iter_bodies(evs, results):
        _write_event(output_dir, cfg, ev, res, body=body)
        written += 1
    return written


def _pack_events_batch(packer, cfg: RunConfig, evs, results) -> int:
    """Stream a chunk slice straight into per-chromosome sqlite
    (`--pack-output`): same header/body bytes as the .miso writer, no
    text tree, no re-pack pass.  Ref: misopy/miso_db.py:144-193."""
    from miso_jax.io.miso_file import (_format_quantized,
                                       _format_sample_block,
                                       event_header_str)

    n = 0
    for ev, res, body in _iter_bodies(evs, results):
        if body is None:
            t = res.get("psi_ticks")
            c = res.get("score_cents")
            if t is not None and c is not None:
                cents = np.asarray(c, np.int64)
                body = _format_quantized(np.asarray(t, np.int64),
                                         cents, cents < 0)
            else:
                body = _format_sample_block(
                    np.asarray(res["samples"], np.float64),
                    np.asarray(res["loglik"], np.float64))
        header = (event_header_str(
            ev, res.get("iters", cfg.iters),
            res.get("burn_in", cfg.burn_in), cfg.lag,
            res["percent_accept"], res["final_n"])
            + "sampled_psi\tlog_score\n")
        packer.add(ev.gene.chrom, ev.name, header, body.decode())
        n += 1
    return n


def write_event_results(
    events: List[CompiledEvent],
    results: List[Optional[dict]],
    output_dir: str,
    cfg: RunConfig,
    workers: int = 4,
) -> int:
    def write_one(pair):
        _write_event(output_dir, cfg, *pair)
        return 1

    todo = [(ev, res) for ev, res in zip(events, results)
            if res is not None]
    if workers > 1 and len(todo) > 64:
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(max_workers=workers) as pool:
            return sum(pool.map(write_one, todo))
    return sum(map(write_one, todo))


class _CompileStream:
    """The host compile producer: walks the indexed catalog in
    per-chromosome-directory groups, loads gene pickles (one batch
    pickle per chromosome when the index provides it), runs the
    whole-chromosome columnar scan + ONE native batch match+collapse
    call per (chromosome, strand) group, and emits CompiledEvents.

    Falls back per-gene (compile_gene_event) for paired-end data,
    non-native alignments, genes missing from the batch call, or
    chromosomes absent from the BAM.
    """

    def __init__(self, items, alignments, cfg: RunConfig, output_dir: str,
                 verbose: bool, emit, workers: int = 1, done=None):
        self.items = items
        self.alignments = alignments
        self.cfg = cfg
        self.output_dir = output_dir
        self.verbose = verbose
        self.emit = emit
        # event names already present in packed output (--pack-output
        # resume); the .miso skip rule checks the filesystem instead
        self.done = done
        # the settings num_processors knob (settings.py:148), applied to
        # the PER-GENE fallback only: the native batch path is faster
        # single-threaded (one C call per chromosome), but non-native
        # readers (text SAM, no C++ toolchain) compile per gene and
        # scale with threads (region fetches release the GIL)
        self.workers = max(1, workers)
        self.skipped = 0
        # resume skips only (existing outputs), distinct from rule
        # skips: gates (and scopes) the summary backfill -- on shared
        # multi-host output trees only THIS host's skipped events may
        # be backfilled, or per-host summaries would overlap
        self.resume_skipped = 0
        self.resume_skipped_names: list = []
        # set by the consumer on its error path: the producer stops at
        # the next gene/subgroup instead of compiling the rest of the
        # catalog into a drain loop
        self.stop = False

        import collections
        from concurrent.futures import ThreadPoolExecutor
        self.scan_cache: "collections.OrderedDict" = \
            collections.OrderedDict()
        self.scan_lock = threading.Lock()
        self.scan_method = ("scan_chrom_columnar_paired" if cfg.paired_end
                           else "scan_chrom_columnar")
        # paired chromosome scans never depend on the target strand
        # (fr-firststrand only reorders mates), so one scan per
        # chromosome serves both strands; single-end stranded scans are
        # per-strand
        self.strandless = (cfg.paired_end
                           or cfg.strand_rule in (None, "fr-unstranded"))
        # 2 workers: the next chromosome's scan runs beside the current
        # one's tail instead of queueing behind it
        self.prefetcher = ThreadPoolExecutor(max_workers=2)
        self.scan_futures: Dict[object, object] = {}
        self.chrom_next: Dict[str, str] = {}

    # ------------------------------------------------------- chrom scans
    def _scan_raw(self, chrom, strand):
        try:
            return getattr(self.alignments, self.scan_method)(
                chrom, given_read_len=self.cfg.filter_read_len,
                strand_rule=self.cfg.strand_rule,
                target_strand=None if self.strandless else strand)
        except KeyError:
            return KeyError  # sentinel: chrom absent from the BAM

    def chrom_scan(self, chrom, strand):
        if not hasattr(self.alignments, self.scan_method):
            return None
        key = (chrom, None if self.strandless else strand)
        with self.scan_lock:
            if key in self.scan_cache:
                self.scan_cache.move_to_end(key)
                hit = self.scan_cache[key]
                if hit is KeyError:  # cached BAM-absent chromosome
                    raise KeyError(chrom)
                return hit
            fut = self.scan_futures.pop(key, None)
            if fut is None:
                fut = self.prefetcher.submit(self._scan_raw, chrom, strand)
            # prefetch the NEXT chromosome while this one resolves /
            # compiles (strandless keys only: stranded keys are
            # per-gene, so the next gene's strand is unknown here)
            nxt = self.chrom_next.get(chrom)
            if (self.strandless and nxt is not None
                    and (nxt, None) not in self.scan_futures
                    and (nxt, None) not in self.scan_cache):
                self.scan_futures[(nxt, None)] = self.prefetcher.submit(
                    self._scan_raw, nxt, None)
        scan = fut.result()
        with self.scan_lock:
            self.scan_cache[key] = scan
            while len(self.scan_cache) > 4:
                self.scan_cache.popitem(last=False)
        if scan is KeyError:
            raise KeyError(chrom)
        return scan

    # --------------------------------------------------------- per gene
    def compile_one(self, gene: Gene, out_name: str):
        """Per-gene fallback: region ingest + compile_gene_event."""
        cfg = self.cfg
        alignments = self.alignments
        lo, hi = gene.genomic_span()
        if hasattr(alignments, "fetch_columnar"):
            # columnar ingest: native batch decode (and native qname
            # pairing for paired-end) straight to (positions, cigars),
            # no per-read Python objects.
            col = None
            try:
                scan = self.chrom_scan(gene.chrom, gene.strand)
                if scan is not None:
                    col = scan.slice(lo - 1, hi)
                elif cfg.paired_end:
                    col = alignments.fetch_columnar_paired(
                        gene.chrom, lo - 1, hi,
                        given_read_len=cfg.filter_read_len,
                        strand_rule=cfg.strand_rule,
                        target_strand=gene.strand)
                else:
                    col = alignments.fetch_columnar(
                        gene.chrom, lo - 1, hi,
                        given_read_len=cfg.filter_read_len,
                        strand_rule=cfg.strand_rule,
                        target_strand=gene.strand)
            except KeyError:
                pass  # chr-prefix fallback below
            if col is not None:
                return compile_gene_event(gene, out_name, col[:2], cfg)
        raw = sam_io.fetch_bam_reads_in_gene(
            alignments, gene.chrom, lo - 1, hi)
        reads, _ = sam_io.sam_parse_reads(
            raw, paired_end=cfg.paired_end, strand_rule=cfg.strand_rule,
            target_strand=gene.strand,
            given_read_len=cfg.filter_read_len)
        return compile_gene_event(gene, out_name, reads, cfg)

    # ------------------------------------------------------------- main
    def run(self) -> None:
        items = self.items
        # group consecutive items by per-chromosome pickle directory
        groups: List[Tuple[str, list]] = []
        for gene_id, fname in items:
            d = os.path.dirname(fname)
            if not groups or groups[-1][0] != d:
                groups.append((d, []))
            groups[-1][1].append((gene_id, fname))

        # chromosome visit order for the prefetcher: resolved lazily as
        # groups are visited (dir names may carry an added 'chr' prefix,
        # io/index.py:41, so they cannot key the prefetch); seeded here
        # from one gene per group so prefetch spans group boundaries
        chrom_seq: List[str] = []
        for d, group in groups:
            gid, fn = group[0]
            try:
                # ONE per-gene pickle per group (not the batch pickle:
                # loading every chromosome's batch upfront would defeat
                # the chromosome-at-a-time streaming)
                g = load_indexed_gene(fn)[gid]["gene_object"]
                if g.chrom and g.chrom not in chrom_seq:
                    chrom_seq.append(g.chrom)
            except Exception:
                pass
        self.chrom_next = {c: chrom_seq[i + 1]
                           for i, c in enumerate(chrom_seq[:-1])}

        try:
            # pickle loads for group k+1 prefetch on the pool while
            # group k compiles (the per-chromosome batch unpickle is a
            # measurable slice of the 50k compile wall)
            entry_fut = (self.prefetcher.submit(self._entries, *groups[0])
                         if groups else None)
            for idx, (d, group) in enumerate(groups):
                if self.stop:
                    break
                entries = entry_fut.result()
                entry_fut = (self.prefetcher.submit(
                    self._entries, *groups[idx + 1])
                    if idx + 1 < len(groups) else None)
                self._run_group(d, group, entries)
        finally:
            # cancel any unconsumed prefetch (e.g. every output of its
            # chromosome already existed) so a whole-chromosome scan
            # does not keep running beside device sampling
            self.prefetcher.shutdown(wait=False, cancel_futures=True)

    def _entries(self, d: str, group):
        """(gene_id, entry) pairs for one directory group -- one batch
        unpickle per chromosome when the index has it (io/index.py),
        per-gene pickles otherwise."""
        from miso_jax.io.index import load_chrom_batch
        batch = load_chrom_batch(d)
        out = []
        for gene_id, fname in group:
            entry = None
            if batch is not None:
                entry = batch.get(gene_id)
            if entry is None:
                entry = load_indexed_gene(fname)[gene_id]
            out.append((gene_id, entry))
        return out

    def _run_group(self, d: str, group, entries=None) -> None:
        cfg = self.cfg
        # resolve genes + output names; apply the resume skip rule.
        # One listdir per output chromosome dir instead of an isfile
        # per event (50k isfile calls cost ~1s of the compile wall);
        # within one run each event is processed once, so a snapshot
        # taken at group start is exact.
        existing_cache: Dict[object, set] = {}

        def existing(chrom) -> set:
            s = existing_cache.get(chrom)
            if s is None:
                try:
                    s = set(os.listdir(
                        chrom_output_dir(self.output_dir, chrom)))
                except OSError:
                    s = set()
                existing_cache[chrom] = s
            return s

        todo: List[Tuple[Gene, str, str]] = []
        if entries is None:
            entries = self._entries(d, group)
        for gene_id, entry in entries:
            gene: Gene = entry["gene_object"]
            # --compress-id indexes name outputs by the hashed ID
            # (index_gff.py:80-99; summarize/compare map back via
            # --use-compressed)
            out_name = entry.get("compressed_id") or gene_id
            if (out_name + ".miso" in existing(gene.chrom)
                    or (self.done is not None
                        and out_name in self.done)):
                out_path = event_output_path(self.output_dir, gene,
                                             out_name)
                if self.verbose:
                    print("Output filename %s exists, not running MISO."
                          % out_path)
                self.skipped += 1
                self.resume_skipped += 1
                self.resume_skipped_names.append(out_name)
                continue
            todo.append((gene, out_name, gene_id))
        if not todo:
            return

        if cfg.paired_end:
            # paired batch path: ONE native paired match+collapse call
            # per chromosome against the columnar pair scan (paired
            # scans are strandless; fr-firststrand only reorders mates)
            from miso_jax.io.index import load_compile_tables
            tables = load_compile_tables(d)
            trow = tables["row"] if tables is not None else {}
            rest: List[Tuple[Gene, str, str]] = []
            chrom = todo[0][0].chrom
            sub = []
            for item in todo:
                if item[0].chrom != chrom or chrom is None:
                    rest.append(item)
                else:
                    sub.append(item)
            done = False
            try:
                scan = self.chrom_scan(chrom, None)
            except KeyError:
                scan = None  # absent from BAM: per-gene fallback
            if scan is not None and hasattr(scan, "p1"):
                rows = None
                if tables is not None and all(
                        gid in trow for _, _, gid in sub):
                    rows = [trow[gid] for _, _, gid in sub]
                evs = compile_paired_end_many(
                    [g for g, _, _ in sub], [nm for _, nm, _ in sub],
                    scan, read_len=cfg.read_len,
                    mean_frag_len=cfg.mean_frag_len,
                    frag_variance=cfg.frag_variance,
                    num_sds=cfg.num_sds, overhang=cfg.overhang_len,
                    min_event_reads=cfg.min_event_reads,
                    tables=tables if rows is not None else None,
                    rows=rows)
                if evs is not None:
                    for ev in evs:
                        if ev is None:
                            self.skipped += 1
                        else:
                            self.emit(ev)
                    done = True
            if not done:
                rest.extend(sub)
            todo = rest
        else:
            # batch path: ONE native match+collapse call per
            # (chromosome, strand) subgroup against the columnar scan,
            # driven by the index's precomputed compile tables when
            # available (zero per-gene Python assembly)
            from miso_jax.io.index import load_compile_tables
            tables = load_compile_tables(d)
            trow = tables["row"] if tables is not None else {}
            by_strand: Dict[object, list] = {}
            rest: List[Tuple[Gene, str]] = []
            chrom = todo[0][0].chrom
            for gene, name, gene_id in todo:
                if gene.chrom != chrom or gene.chrom is None:
                    rest.append((gene, name, gene_id))
                else:
                    skey = None if self.strandless else gene.strand
                    by_strand.setdefault(skey, []).append(
                        (gene, name, gene_id))
            for skey, sub in sorted(by_strand.items(),
                                    key=lambda kv: str(kv[0])):
                done = False
                try:
                    scan = self.chrom_scan(chrom, skey)
                except KeyError:
                    scan = None  # absent from BAM: per-gene fallback
                if scan is not None:
                    rows = None
                    if tables is not None and all(
                            gid in trow for _, _, gid in sub):
                        rows = [trow[gid] for _, _, gid in sub]
                    evs = compile_single_end_many(
                        [g for g, _, _ in sub], [n for _, n, _ in sub],
                        scan, read_len=cfg.read_len,
                        overhang=cfg.overhang_len,
                        algorithm=cfg.algorithm,
                        min_event_reads=cfg.min_event_reads,
                        tables=tables if rows is not None else None,
                        rows=rows)
                    if evs is not None:
                        for ev in evs:
                            if ev is None:
                                self.skipped += 1
                            else:
                                self.emit(ev)
                        done = True
                if not done:
                    rest.extend(sub)
            todo = rest

        if self.workers > 1 and len(todo) > 16:
            from concurrent.futures import ThreadPoolExecutor
            with ThreadPoolExecutor(max_workers=self.workers) as pool:
                # bounded windows, not one map over the whole group:
                # Executor.map submits everything eagerly, so a whole
                # chromosome's CompiledEvents would buffer in futures
                # and defeat the consumer queue's backpressure.  map
                # preserves order within each window, so emitted event
                # order (and with it PRNG chunk keys) stays
                # deterministic.
                window = self.workers * 8
                for lo in range(0, len(todo), window):
                    if self.stop:
                        return
                    for ev in pool.map(
                            lambda t: self.compile_one(t[0], t[1]),
                            todo[lo:lo + window]):
                        if ev is None:
                            self.skipped += 1
                        else:
                            self.emit(ev)
            return
        for gene, name, _gid in todo:
            if self.stop:
                return
            ev = self.compile_one(gene, name)
            if ev is None:
                self.skipped += 1
            else:
                self.emit(ev)


def compute_all_genes_psi(
    index_dir: str,
    alignments_path: str,
    read_len: int,
    output_dir: str,
    cfg: Optional[RunConfig] = None,
    settings: Optional[Settings] = None,
    gene_ids: Optional[List[str]] = None,
    seed: int = 0,
    verbose: bool = True,
    profile_dir: Optional[str] = None,
    mesh="auto",
) -> int:
    """The `miso --run` engine.  Returns the number of events written.

    Ref: misopy/miso.py:340-425 + run_miso.py:34-202, collapsed into one
    process with device-side batch parallelism.  Host event compile runs
    on a producer thread and overlaps device dispatch, device->host
    transfer, and .miso writes (the reference's whole-run wall-clock,
    misopy/miso.py:340-425, is the metric this pipeline shape targets).

    `profile_dir` wraps device execution in a jax.profiler trace
    (view with TensorBoard / xprof) and logs per-bucket device time.
    `mesh` is resolved by `resolve_mesh` ('auto': all local devices).
    """
    from miso_jax.io.sanity import check_gff_and_bam, setup_logger

    settings = settings or Settings.get()
    cfg = cfg or RunConfig.from_settings(settings, read_len)
    if cfg.summary_only and cfg.pack_output:
        raise ValueError(
            "--pack-output and --summary-only conflict: summary-only "
            "runs store no posterior samples to pack")
    if cfg.summary_only:
        # also covers convergent stops: continuation windows only grow
        # (extend_factor >= 1), so a valid initial schedule stays valid
        n_s = ((cfg.iters - cfg.burn_in) // cfg.lag) * cfg.chains
        if _ci_bound_indices(n_s) is None:
            raise ValueError(
                "--summary-only needs enough retained samples for the "
                "95%% credible interval (got %d; need ~40+)" % n_s)
    setup_logger(output_dir)
    check_gff_and_bam(index_dir, alignments_path,
                      given_read_len=cfg.filter_read_len)

    t0 = time.time()
    id_to_fname = get_gene_ids_to_filenames(index_dir)
    if gene_ids is not None:
        id_to_fname = {g: id_to_fname[g] for g in gene_ids if g in id_to_fname}
    alignments = sam_io.open_alignments(alignments_path)

    # group by per-chromosome pickle directory so the whole-chromosome
    # scan cache stays small, then by gene id for determinism
    items = sorted(id_to_fname.items(), key=lambda kv: (kv[1], kv[0]))
    if items and getattr(alignments, "references", None):
        # build the region index once before fanning out threads
        list(alignments.fetch(alignments.references[0], 0, 0))

    mesh = resolve_mesh(mesh)
    if verbose and mesh is not None:
        print("Event catalog sharded over %d local devices"
              % mesh.devices.size)
    import jax

    bucket_stats: List[dict] = []
    # stream writes: as each chunk's results land on the host, its
    # .miso files format+write on a small pool while later chunks are
    # still transferring from the device
    from concurrent.futures import ThreadPoolExecutor

    # one writer per core up to 4: extra writer threads just thrash the
    # GIL against the materializer
    write_pool = ThreadPoolExecutor(
        max_workers=max(2, min(4, os.cpu_count() or 4)))
    write_futures = []
    write_lock = threading.Lock()

    progress = {"done": 0, "t_last": t0}
    # run-integrated posterior summary: rows accumulate as chunks land
    # (device-side means/CIs; see summary_row_fields) and the
    # .miso_summary writes once at the end -- summarize_miso's 3 GB
    # text re-parse at 50k events becomes a no-op
    from miso_jax.io.miso_file import summary_row_fields
    summary_rows: Dict[str, str] = {}
    packer = None
    if cfg.pack_output and not cfg.summary_only:
        from miso_jax.io.miso_db import DirectPacker
        packer = DirectPacker(output_dir)

    def on_chunk(evs, results):
        # summary rows format OUTSIDE the lock (pure string work; the
        # lock guards only the shared containers)
        rows_local = {}
        for ev, res in zip(evs, results):
            if res is None:
                continue
            fields = summary_row_fields(ev, res)
            if fields is not None:
                rows_local[ev.name] = "\t".join(fields)
        # slices of ~512 events per pool task: each batch-formats its
        # sample bodies in one vectorized pass (see _write_events_batch)
        with write_lock:
            if packer is not None:
                for lo in range(0, len(evs), 512):
                    write_futures.append(write_pool.submit(
                        _pack_events_batch, packer, cfg,
                        evs[lo:lo + 512], results[lo:lo + 512]))
            elif not cfg.summary_only:
                for lo in range(0, len(evs), 512):
                    write_futures.append(write_pool.submit(
                        _write_events_batch, output_dir, cfg,
                        evs[lo:lo + 512], results[lo:lo + 512]))
            summary_rows.update(rows_local)
            progress["done"] += len(evs)
            now = time.time()
            if verbose and now - progress["t_last"] > 15:
                # periodic progress (the reference prints per-event
                # wall-clock, miso_sampler.py:373; at batch scale a
                # heartbeat is the usable equivalent)
                progress["t_last"] = now
                print("  ... %d/%d events through the device (%.0f "
                      "events/s)" % (progress["done"], len(items),
                                     progress["done"] / (now - t0)))

    runner = StreamRunner(cfg, seed=seed, mesh=mesh,
                          bucket_stats=bucket_stats, on_chunk=on_chunk)

    # producer thread: host event compile streams into the runner's
    # shape buckets through a bounded queue; full buckets dispatch to
    # the device while later chromosomes are still compiling
    ev_queue: "queue_mod.Queue" = queue_mod.Queue(maxsize=8192)
    compile_done = {}

    # per-gene fallback threading: only useful for non-native readers
    # (the batch path is one C call per chromosome); see _CompileStream
    from miso_jax import native as _native
    workers = 1
    if (not hasattr(alignments, "scan_chrom_columnar")
            or _native.load() is None):
        workers = settings.get_num_processors() or 1
    stream = _CompileStream(items, alignments, cfg, output_dir, verbose,
                            emit=ev_queue.put, workers=workers,
                            done=packer.done_names if packer else None)

    def produce():
        t = time.time()
        try:
            stream.run()
            compile_done["seconds"] = time.time() - t
        except BaseException as e:
            compile_done["error"] = e
        finally:
            ev_queue.put(None)

    producer = threading.Thread(target=produce, daemon=True)

    def consume():
        producer.start()
        try:
            while True:
                ev = ev_queue.get()
                if ev is None:
                    break
                runner.add(ev)
        except BaseException:
            # error-path cleanup: signal the producer to stop at its
            # next gene and drain the bounded queue until the thread
            # exits (its finally cancels the chromosome-scan
            # prefetcher), then stop the runner's materializer -- a
            # failed run leaks neither threads nor queued scans, and a
            # Ctrl-C does not wait out the rest of the host compile
            stream.stop = True
            while producer.is_alive():
                try:
                    while True:
                        ev_queue.get_nowait()
                except queue_mod.Empty:
                    pass
                producer.join(timeout=0.2)
            runner.abort()
            raise
        producer.join()
        if "error" in compile_done:
            # the COMPILE failed: shut the runner down without flushing
            # partial buckets (resume re-runs the missing events)
            runner.abort()
            raise compile_done["error"]
        runner.finish()

    if profile_dir:
        os.makedirs(profile_dir, exist_ok=True)
        with jax.profiler.trace(profile_dir):
            consume()
        if verbose:
            print("jax.profiler trace written to %s" % profile_dir)
    else:
        consume()
    written = 0
    for f in write_futures:
        written += f.result()
    write_pool.shutdown()
    if packer is not None:
        packer.finish()
    if summary_rows or stream.resume_skipped:
        from miso_jax.io.miso_file import write_summary_file
        label = os.path.basename(os.path.normpath(output_dir))
        if jax.process_count() > 1:
            # multi-host runs share output_dir: per-host summary files
            # (concurrent read-merge-writes of one file would race and
            # drop rows; concatenate or summarize_miso to merge)
            label = "%s.host%d" % (label, jax.process_index())
        summary_filename = os.path.join(output_dir, "summary",
                                        "%s.miso_summary" % label)
        if stream.resume_skipped and not cfg.summary_only:
            # resumed runs: skipped events never reach the device, and
            # if the prior run died before writing a summary there is
            # no file to merge with -- backfill their rows from the
            # stored samples so the summary is never silently partial.
            # (Gated on RESUME skips: rule-skipped genes have no stored
            # samples and a fresh run should not pay the rescan.)
            from miso_jax.io.miso_file import (MISOSamples,
                                               summary_row_from_data)
            have = set(summary_rows)
            if os.path.isfile(summary_filename):
                with open(summary_filename) as f:
                    f.readline()
                    have.update(line.split("\t", 1)[0]
                                for line in f if line.strip())
            obj = MISOSamples(output_dir)
            for nm in stream.resume_skipped_names:
                if nm in have or nm not in obj.event_names_to_fnames:
                    continue
                data = obj.get_event_samples(nm)
                if data is None:
                    continue
                try:
                    summary_rows[nm] = "\t".join(
                        summary_row_from_data(nm, data))
                except ValueError:
                    # e.g. a truncated predecessor file with too few
                    # samples for the CI: warn, don't fail the run
                    print("WARNING: cannot summarize resumed event %s "
                          "(too few samples)" % nm)
        n_summ = write_summary_file(summary_filename, summary_rows)
        if verbose:
            print("Posterior summary (%d events, device-side): %s"
                  % (n_summ, summary_filename))
        if cfg.summary_only:
            written = len(summary_rows)
    if verbose:
        dt = time.time() - t0
        n_dev = max(1, len(jax.local_devices()))
        for bs in bucket_stats:
            print("  bucket (iso=%d, classes=%d, reads=%d): %d events "
                  "in %.2fs (%.1f events/s)"
                  % (bs["shape"] + (bs["events"], bs["seconds"],
                                    bs["events_per_s"])))
        print("Quantified %d events (%d skipped) in %.2fs "
              "(host compile %.2fs, overlapped); %.1f events/s "
              "(%.1f events/s/device)"
              % (written, stream.skipped, dt,
                 compile_done.get("seconds", float("nan")),
                 written / max(dt, 1e-9),
                 written / max(dt, 1e-9) / n_dev))
    return written
