"""Batched Metropolis-Hastings-within-Gibbs MISO sampler.

Batched redesign of pysplicing/src/miso.c:638-986 (single-end) and
miso_paired.c:241-574 (paired-end):

- The reference advances 6 chains of ONE gene per process; here a single
  jitted program advances (events x chains) chains in lockstep via
  jax.vmap, with lax.scan over iterations.
- The per-read Gibbs reassignment loop (miso.c:30-91) becomes per-class
  multinomial draws (see sampler/model.py:gibbs_reassign) -- statistically
  identical, and the device tensors are (classes x isoforms), independent
  of read count.
- Burn-in / lag thinning (miso.c:882-893) is expressed as a two-level scan:
  an outer scan over retained records, an inner scan over `lag` iterations,
  so sample buffers are written without scatter ops.

Sample layout parity: the returned psi_samples flatten to
(num_records * chains) in record-major order, matching the reference's
interleaved samples matrix (miso.c:884: all chains recorded per retained
iteration, consecutively).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from miso_jax.sampler import model
from miso_jax.sampler.model import EventMasks


class EventBatch(NamedTuple):
    """A device-ready batch of E events padded to (C classes, I isoforms).

    weights:   (E, C, I) Gibbs/marginal class weights.  Single-end REASSIGN:
               {0,1} compatibility; paired: fragment-length probability;
               MARGINAL: compatibility / effective length (miso.c:807-815).
    log_read:  (E, C, I) per-read log score when a class-c read is assigned
               to isoform i (miso.c:777-784 isoscores; miso_paired.c:403-414
               isoscores[fragLen, iso]).  0 where incompatible.
    counts:    (E, C) reads per class.
    log_iso_w: (E, I) log effective length (single-end) or assscores
               (paired); -inf on padded/zero-length isoforms.
    hyper:     (E, I) Dirichlet prior parameters.
    num_iso:   (E,) real isoform count per event.
    """

    weights: jnp.ndarray
    log_read: jnp.ndarray
    counts: jnp.ndarray
    log_iso_w: jnp.ndarray
    hyper: jnp.ndarray
    num_iso: jnp.ndarray
    read_w: jnp.ndarray         # (E, R, I) per-read class weights (linear)
    read_logscore: jnp.ndarray  # (E, R, I) per-read log score by isoform

    @property
    def num_events(self) -> int:
        return self.weights.shape[0]

    @property
    def max_classes(self) -> int:
        return self.weights.shape[1]

    @property
    def max_iso(self) -> int:
        return self.weights.shape[2]


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    """Static sampler configuration (reference defaults:
    misopy/settings/miso_settings.txt burn_in=500 lag=10 num_iters=5000
    num_chains=6)."""

    iters: int = 5000
    burn_in: int = 500
    lag: int = 10
    chains: int = 6
    algorithm: str = "reassign"  # 'reassign' | 'marginal'
    # Gibbs implementation for 'reassign': 'perread' (inverse-CDF draw
    # per read over a dense reads x isoforms tile, for moderate read
    # depth) or 'multinomial' (per-class chained binomials; O(classes)
    # memory, for very high-coverage events).
    gibbs: str = "perread"
    dtype: str = "float32"

    @property
    def num_records(self) -> int:
        return (self.iters - self.burn_in) // self.lag

    @property
    def num_samples(self) -> int:
        return self.num_records * self.chains


class SamplerResult(NamedTuple):
    psi_samples: jnp.ndarray   # (E, R, K, I): record-major, chains interleaved
    loglik: jnp.ndarray        # (E, R, K)
    accepted: jnp.ndarray      # (E,) total accepted proposals (incl. burn-in)
    rejected: jnp.ndarray      # (E,)
    final_n: jnp.ndarray       # (E, K, I) final per-isoform assignment counts
    final_psi: jnp.ndarray     # (E, K, I)

    def flat_samples(self):
        """(E, R*K, I) in the reference's interleaved sample order."""
        E, R, K, I = self.psi_samples.shape
        return self.psi_samples.reshape(E, R * K, I)

    def flat_loglik(self):
        E, R, K = self.loglik.shape
        return self.loglik.reshape(E, R * K)


def select_backend(backend: str, platform: str,
                   algorithm: str = "reassign",
                   gibbs: str = "perread") -> str:
    """The sampler a batch runs on: 'pallas' (the fused REASSIGN kernel,
    sampler/pallas_kernel.py, Triton route) or 'xla' (run_batch).
    'auto' takes the kernel on a GPU and the scan elsewhere.  The kernel
    implements only REASSIGN with per-read Gibbs, so every other
    configuration (MARGINAL/CLASSES, the multinomial Gibbs of very deep
    events) runs the scan whatever was asked."""
    fits = algorithm == "reassign" and gibbs == "perread"
    if backend == "auto":
        backend = "pallas" if platform == "gpu" else "xla"
    if backend not in ("pallas", "xla"):
        raise ValueError("unknown sampler backend %r" % backend)
    return backend if fits else "xla"


def _pow2_pad_events(batch: EventBatch, start_psi, n: int):
    """Pad a batch's event axis up to the next power of two (zero
    events: num_iso=0, masked everywhere).  Continuation rounds and
    partial chunks otherwise present a NEW batch shape each time (the
    remaining-event count shrinks arbitrarily), and each new shape is a
    fresh compile; with bucketing the shapes per (iters, burn_in)
    schedule are log2(E) at most.  There is no floor: a small shape
    compiles in seconds, and masked lanes are real work on the device."""
    target = 1 << max(int(np.ceil(np.log2(max(n, 1)))), 0)
    if target == n:
        return batch, start_psi
    arrs = []
    for a in batch:
        a = np.asarray(a)
        pad = np.zeros((target - n,) + a.shape[1:], a.dtype)
        arrs.append(np.concatenate([a, pad], axis=0))
    if start_psi is not None:
        sp = np.asarray(start_psi)
        pad = np.zeros((target - n,) + sp.shape[1:], sp.dtype)
        start_psi = np.concatenate([sp, pad], axis=0)
    return EventBatch(*arrs), start_psi


@functools.partial(jax.jit, static_argnames=("two_iso",))
def _quantized_rows(psi_samples, loglik, idx, two_iso=False):
    """Posterior fetch payload for SELECTED batch rows at .miso output
    precision: uint16 psi ticks + per-event-offset uint16 score
    centipoints (the fixed-stop path's scheme, pipeline.StreamRunner).
    `idx` is pow2-padded so the gather program compiles once per
    (batch shape, index bucket) -- each converged event's samples leave
    the device exactly once, making convergent-mode transfer O(E)
    instead of O(rounds x E).  two_iso fetches only psi column 0
    (psi_2 = 1 - psi_1 reconstructs on the host).  Takes the RAW
    (E, R, K, I) samples and flattens inside the jit: one dispatch per
    round instead of one per eager reshape."""
    E, R, K, I = psi_samples.shape
    flat_psi = psi_samples.reshape(E, R * K, I)
    flat_ll = loglik.reshape(E, R * K)
    sel_psi = jnp.take(flat_psi, idx, axis=0)
    if two_iso:
        sel_psi = sel_psi[:, :, 0]
    quant = jnp.round(sel_psi * 1e4).astype(jnp.uint16)
    cents = jnp.round(jnp.take(flat_ll, idx, axis=0) * 100.0)
    cmin = jnp.min(cents, axis=1)
    cmax = jnp.max(cents, axis=1)
    resid = jnp.clip(cents - cmin[:, None], 0, 65535).astype(jnp.uint16)
    return quant, resid, cmin, cmax


@functools.partial(jax.jit, static_argnames=("n",))
def _round_keys(key, n: int):
    """All adaptive-round PRNG keys in ONE device dispatch instead of an
    eager fold_in per round."""
    return jnp.stack([jax.random.fold_in(key, i) for i in range(n)])


def run_batch_convergent(
    key: jnp.ndarray,
    events: EventBatch,
    cfg: SamplerConfig,
    max_iters: int = 500000,
    rhat_threshold: float = 1.1,
    mesh=None,
    start_psi=None,
    backend: str = "xla",
    extend_factor: float = 2.0,
):
    """Convergent-mean stopping with adaptive extension.

    The reference checks Gelman-Rubin R-hat <= 1.1 after each block and,
    if unconverged, continues the chain with
    noIter' = 3*noIter - 2*burnIn, burnIn' = noIter
    (pysplicing/src/miso.c:903-928).  Here the whole batch runs a block,
    then ONLY the unconverged events re-run as a continuation batch
    (GIVEN start from their final psi) -- masked continuation instead of
    per-event while-loops.  Continuation batches are padded to
    power-of-two event counts so the set of compile shapes is bounded.

    `extend_factor` g generalizes the growth rule to
    noIter' = noIter + g*(noIter - burnIn) -- each continuation adds g
    retained windows.  g=2 is EXACTLY the reference rule
    (noIter' = 3*noIter - 2*burnIn).  A handful of straggler events
    otherwise re-run 14k/41k-iteration rounds; a smaller opt-in factor
    (e.g. 1.0) extends them in cheaper increments with the SAME R-hat
    acceptance test each round (g=1 is
    the cheapest: constant-size continuation blocks).

    backend='pallas' keeps every round (including GIVEN-start
    continuations) on the fused REASSIGN kernel; continuation schedules
    still compile once per (iters, burn_in) pair.

    Returns (results, iters_used): per-event SamplerResult-like dicts
    with per-event "iters"/"burn_in" recording the final schedule.
    """
    from miso_jax.stats.rhat import batch_rhat

    E = events.num_events
    results: list = [None] * E
    iters_used = np.zeros(E, dtype=np.int64)
    remaining = np.arange(E)
    cur_cfg = cfg
    # round 0 honors a caller-provided start (e.g. the NNLS linear
    # start, MISO_START_LINEAR); continuation rounds overwrite it with
    # each event's final chain state
    start_psi = None if start_psi is None else np.asarray(start_psi,
                                                          np.float32)
    if extend_factor < 1.0:
        # burnIn' = noIter discards the whole previous run (reference
        # semantics), so the retained window scales by g each round --
        # g < 1 would shrink it toward zero records
        raise ValueError("extend_factor must be >= 1 (got %r)"
                         % extend_factor)
    # all round keys in one dispatch (rounds are bounded by the growth
    # schedule hitting max_iters).  The retained window w scales by g
    # per round and each round adds g*w >= g*w0 iterations, so the
    # ARITHMETIC bound (max_iters - iters)/(g*w0) holds for every
    # g >= 1 -- at g=1 growth IS arithmetic (a geometric estimate
    # under-provisioned keys and tripped the round assert)
    w0 = max(cfg.iters - cfg.burn_in, 1)
    n_rounds = int(np.ceil(max(max_iters - cfg.iters, 0)
                           / (extend_factor * w0))) + 8
    n_rounds = min(max(n_rounds, 24), 256)
    rkeys = jax.device_get(_round_keys(key, n_rounds))  # host-side:
    # indexing a device array per round would itself be an eager dispatch
    round_i = 0
    while len(remaining):
        sub = EventBatch(*(np.asarray(a)[remaining] for a in events))
        sp = None if start_psi is None else start_psi[remaining]
        sub, sp = _pow2_pad_events(sub, sp, len(remaining))
        # never replay a round key: if a pathological schedule outruns
        # the estimate, mint a fresh block (distinct fold_in domain)
        if round_i >= len(rkeys):
            more = jax.device_get(_round_keys(
                jax.random.fold_in(key, 1_000_000 + len(rkeys)),
                len(rkeys)))
            rkeys = np.concatenate([np.asarray(rkeys), more])
        rkey = rkeys[round_i]
        # numpy start_psi rides the jit call (no separate eager put)
        if mesh is not None:
            from miso_jax.parallel.mesh import run_batch_sharded
            res = run_batch_sharded(rkey, sub, cur_cfg, mesh=mesh,
                                    backend=backend, start_psi=sp)
        elif backend == "pallas":
            from miso_jax.sampler.pallas_kernel import run_batch_pallas
            res = run_batch_pallas(rkey, sub, cur_cfg, start_psi=sp)
        else:
            res = run_batch(rkey, sub, cur_cfg, start_psi=sp)
        nr = len(remaining)
        # ONE transfer for the R-hat matrix and every small per-event
        # output (a per-array np.asarray would be a transfer each)
        rh, acc, rej, fn, fpsi = jax.device_get(
            (batch_rhat(res.psi_samples), res.accepted, res.rejected,
             res.final_n, res.final_psi))
        rh = rh[:nr]  # (Esub, I)
        iso_mask = (np.arange(events.weights.shape[2])[None, :]
                    < np.asarray(sub.num_iso)[:nr, None])
        conv = np.all(np.where(iso_mask, rh <= rhat_threshold, True),
                      axis=1)
        next_iters = int(round(
            cur_cfg.iters
            + extend_factor * (cur_cfg.iters - cur_cfg.burn_in)))
        if next_iters > max_iters:
            conv = np.ones_like(conv)  # maxIterations cap (miso.c:908)
        # fetch ONLY the converged rows' posteriors, quantized to the
        # .miso output precision, via a pow2-bucketed device gather:
        # each event's samples cross the device->host link exactly once
        # (when it converges) instead of every adaptive round, so the
        # transfer is O(E) and not O(rounds x E).  Pow2 index padding
        # bounds the compile shapes exactly like _pow2_pad_events does
        # for the batch.
        conv_rows = np.flatnonzero(conv)
        if conv_rows.size:
            pad_n = 1 << max(int(np.ceil(np.log2(conv_rows.size))), 0)
            idx = np.zeros(pad_n, np.int64)
            idx[:conv_rows.size] = conv_rows
            two_iso = events.weights.shape[2] == 2
            # idx passed as numpy: its transfer rides the jit call
            # instead of a separate device round-trip
            quant, resid, cmin, cmax = jax.device_get(_quantized_rows(
                res.psi_samples, res.loglik, idx, two_iso=two_iso))
            nsel = conv_rows.size
            q = np.asarray(quant)[:nsel]
            if two_iso:
                c0 = q.astype(np.float64) / 1e4
                flat = np.stack([c0, 1.0 - c0], axis=-1)
            else:
                flat = q.astype(np.float32) / 1e4
            cmin_h = np.asarray(cmin).astype(np.float64)[:nsel]
            cmax_h = np.asarray(cmax).astype(np.float64)[:nsel]
            ll = (np.asarray(resid).astype(np.float64)[:nsel]
                  + cmin_h[:, None]) / 100.0
            with np.errstate(invalid="ignore"):
                wide = np.flatnonzero((cmax_h - cmin_h) > 65535)
            for w in wide:  # rare: full-precision row fetch
                ll[w] = np.asarray(res.flat_loglik()[int(conv_rows[w])])
            for k, j in enumerate(conv_rows):
                e = remaining[j]
                results[e] = {
                    "samples": flat[k], "loglik": ll[k],
                    "accepted": acc[j], "rejected": rej[j],
                    "final_n": fn[j], "final_psi": fpsi[j],
                    "iters": cur_cfg.iters, "burn_in": cur_cfg.burn_in,
                }
        for j, e in enumerate(remaining):
            iters_used[e] = cur_cfg.iters
        new_remaining = remaining[~conv]
        if len(new_remaining) == 0:
            break
        fp = np.zeros((E,) + np.asarray(res.final_psi).shape[1:],
                      dtype=np.float32)
        fp[remaining] = np.asarray(res.final_psi)[:nr]
        start_psi = fp
        remaining = new_remaining
        cur_cfg = dataclasses.replace(
            cur_cfg, iters=next_iters, burn_in=cur_cfg.iters)
        round_i += 1
    return results, iters_used


class _ChainState(NamedTuple):
    key: jnp.ndarray
    alpha: jnp.ndarray       # (I-1,)
    psi: jnp.ndarray         # (I,)
    n: jnp.ndarray           # (I,) per-isoform assignment counts
    read_prob: jnp.ndarray   # () sum of per-read log scores
    cjs: jnp.ndarray         # () current joint score (post-acceptance)
    m: jnp.ndarray           # () iteration counter
    accepted: jnp.ndarray    # () int32


def _joint_score(psi, st_n, read_prob, ev, masks, algorithm):
    """splicing_score_joint (miso.c:243-307) for the current assignment."""
    psi_prob = model.ldirichlet(psi, ev.hyper, masks)
    if algorithm == "reassign":
        ass_prob = model.score_assignments(psi, st_n, ev.log_iso_w, masks)
        return read_prob + ass_prob + psi_prob
    else:  # marginal: read term depends on psi directly; no assignment term
        return model.score_marginal(psi, ev.weights, ev.counts) + psi_prob


def _gibbs(kg, psi, ev, masks, gibbs: str):
    if gibbs == "perread":
        return model.gibbs_reassign_perread(
            kg, psi, ev.read_w, ev.read_logscore, masks)
    draws = model.gibbs_reassign(kg, psi, ev.weights, ev.counts, masks)
    return jnp.sum(draws, axis=0), jnp.sum(draws * ev.log_read)


def _make_step(ev, masks: EventMasks, algorithm: str, gibbs: str):
    """One MH(+Gibbs) iteration for a single (event, chain).
    Ref: the hot loop pysplicing/src/miso.c:845-900."""

    def step(st: _ChainState, _):
        key, ke, ku, kg = jax.random.split(st.key, 4)
        eps = jax.random.normal(ke, st.alpha.shape, st.alpha.dtype)
        alpha_new, psi_new = model.propose(st.alpha, eps, masks)

        cjs = _joint_score(st.psi, st.n, st.read_prob, ev, masks, algorithm)
        pjs = _joint_score(psi_new, st.n, st.read_prob, ev, masks, algorithm)
        # proposal correction terms (miso.c:531-545); skipped on iteration 0
        pto_c = model.proposal_logpdf(st.psi, alpha_new, masks)
        cto_p = model.proposal_logpdf(psi_new, st.alpha, masks)
        full = (st.m > 0).astype(cjs.dtype)
        logr = (pjs - cjs) + full * (pto_c - cto_p)

        u = jax.random.uniform(ku, (), cjs.dtype)
        accept = (logr >= 0) | (jnp.log(u) < logr)
        psi = jnp.where(accept, psi_new, st.psi)
        alpha = jnp.where(accept, alpha_new, st.alpha)
        cjs_after = jnp.where(accept, pjs, cjs)

        if algorithm == "reassign":
            n, read_prob = _gibbs(kg, psi, ev, masks, gibbs)
        else:
            n = st.n
            read_prob = st.read_prob

        return _ChainState(
            key=key, alpha=alpha, psi=psi, n=n, read_prob=read_prob,
            cjs=cjs_after, m=st.m + 1,
            accepted=st.accepted + accept.astype(jnp.int32),
        ), None

    return step


def _init_state(key, ev, masks: EventMasks, algorithm: str, gibbs: str,
                dtype, start_psi=None):
    """Chain init: AUTO start (miso.c:348-371) followed by one proposal
    (miso.c:834, which overwrites both alpha and psi), then the initial
    Gibbs assignment (miso.c:840-843).  With `start_psi`, the GIVEN start
    (miso.c:405-409): alpha = logit(start_psi)."""
    I = ev.log_iso_w.shape[0]
    kf = (masks.k - 1).astype(dtype)
    if start_psi is not None:
        last = jnp.sum(start_psi * masks.last_onehot)
        alpha0 = jnp.where(
            masks.amask,
            jnp.log(jnp.maximum(start_psi[:-1], 1e-30))
            - jnp.log(jnp.maximum(last, 1e-30)),
            0.0).astype(dtype)
    else:
        # AUTO: alpha = 1/(k-1) for k != 2, else 0 (miso.c:356-367)
        alpha0 = jnp.where(
            masks.amask,
            jnp.where(masks.k == 2, 0.0, 1.0 / jnp.maximum(kf, 1.0)),
            0.0,
        ).astype(dtype)
    key, kp, kg = jax.random.split(key, 3)
    eps = jax.random.normal(kp, (I - 1,), dtype)
    alpha, psi = model.propose(alpha0, eps, masks)
    if algorithm == "reassign":
        n, read_prob = _gibbs(kg, psi, ev, masks, gibbs)
    else:
        n = jnp.zeros((I,), dtype)
        read_prob = jnp.zeros((), dtype)
    return _ChainState(
        key=key, alpha=alpha, psi=psi, n=n, read_prob=read_prob,
        cjs=jnp.zeros((), dtype), m=jnp.zeros((), jnp.int32),
        accepted=jnp.zeros((), jnp.int32),
    )


def _run_chain(key, ev, num_iso, cfg: SamplerConfig, start_psi=None):
    """Full sampler for one (event, chain). Returns records + final state."""
    dtype = jnp.dtype(cfg.dtype)
    masks = model.make_masks(num_iso, ev.log_iso_w.shape[0])
    step = _make_step(ev, masks, cfg.algorithm, cfg.gibbs)
    st = _init_state(key, ev, masks, cfg.algorithm, cfg.gibbs, dtype,
                     start_psi=start_psi)

    if cfg.burn_in > 0:
        st, _ = jax.lax.scan(step, st, None, length=cfg.burn_in)

    def record_block(st, _):
        st, _ = jax.lax.scan(step, st, None, length=cfg.lag)
        return st, (st.psi, st.cjs)

    st, (psis, logliks) = jax.lax.scan(
        record_block, st, None, length=cfg.num_records)

    remainder = cfg.iters - cfg.burn_in - cfg.num_records * cfg.lag
    if remainder > 0:
        st, _ = jax.lax.scan(step, st, None, length=remainder)

    return psis, logliks, st


@functools.partial(jax.jit, static_argnames=("cfg",))
def run_batch(key: jnp.ndarray, events: EventBatch,
              cfg: SamplerConfig,
              start_psi: Optional[jnp.ndarray] = None) -> SamplerResult:
    """Run the sampler over a padded batch of events.

    vmap layout: chains innermost, events outermost, so per-event tensors
    are broadcast across chains without replication.  Optional
    `start_psi` (E, K, I) switches to the GIVEN start (used by the
    convergent-mean continuation).
    """
    E, K = events.num_events, cfg.chains
    keys = jax.random.split(key, E * K).reshape(E, K, 2)

    def one_event(ks, sp, *fields):
        ev = EventBatch(*fields)
        if sp is None:
            return jax.vmap(
                lambda k: _run_chain(k, ev, ev.num_iso, cfg))(ks)
        return jax.vmap(
            lambda k, s: _run_chain(k, ev, ev.num_iso, cfg, start_psi=s)
        )(ks, sp)

    if start_psi is None:
        psis, logliks, st = jax.vmap(
            lambda ks, *f: one_event(ks, None, *f))(keys, *events)
    else:
        psis, logliks, st = jax.vmap(one_event)(keys, start_psi, *events)

    # psis: (E, K, R, I) from vmap(chains) of (R, I) -> transpose to (E,R,K,I)
    psi_samples = jnp.swapaxes(psis, 1, 2)
    loglik = jnp.swapaxes(logliks, 1, 2)
    accepted = jnp.sum(st.accepted, axis=1)
    total = cfg.iters * K
    return SamplerResult(
        psi_samples=psi_samples,
        loglik=loglik,
        accepted=accepted,
        rejected=total - accepted,
        final_n=st.n,
        final_psi=st.psi,
    )
