"""Fused Pallas kernel (Triton route): the complete MISO REASSIGN sampler
in one launch.

The XLA sampler (mcmc.py) runs each MCMC iteration as one trip of a
while loop that launches several small kernels; at 5000 iterations the
per-step launches and loop bookkeeping, not arithmetic, bound it.  This
kernel runs the ENTIRE chain -- proposal, joint scores, MH accept,
per-read Gibbs reassignment, burn-in/lag recording -- inside one
`pallas_call` with the chain state in registers.

Layout: one program per block of L (event, chain) lanes (lane index =
event*K + chain, L a power of two); the iteration loop runs inside the
program.  Per-event inputs are laid out event-minor ((I, R, E) read
tiles, (.., E) scalars), so the K lanes of an event load the same
addresses: each event's read tile is fetched once and shared by its
chains through the cache -- there is no K-fold replication in device
memory.  Each iteration streams the read axis in chunks of RC rows, so
the register footprint is independent of R.

Random numbers come from a counter-based generator written into the
kernel (`hash32`, an integer avalanche hash of uint32 mul/xor/shift):
every draw is a pure function of (seed, global lane, iteration, word),
so results do not depend on the block size, the read chunking, or on
how a mesh splits the event axis (`lane_offset`).  Word 0 of an
iteration is the MH-accept uniform, words 1..2H the Box-Muller pairs,
then one word per pair of reads: read r takes the low (r even) or high
(r odd) 16 bits of word r // 2.

Gibbs reassignment is inverse-CDF with a count-difference reduction:
read r draws isoform i iff cums[i-1] < u_r <= cums[i], so per-isoform
counts are differences of the counts of `cums[i] >= u`.  Padded reads
(total weight 0) satisfy every compare (0 >= 0) and are removed by the
static pad count.  The 16-bit read uniforms have their low bit pinned
(u > 0 strictly), so a valid read never lands on a leading zero-weight
isoform; the boundary quantization (2^-15) is far below Monte-Carlo
noise.  The read-score term cancels in the MH ratio and is reduced only
on the iteration feeding each recorded score.

Semantics match sampler/mcmc.py (same reference citations:
pysplicing/src/miso.c:638-986); equivalence is statistical (different
RNG streams), checked against the grid-exact posterior oracle.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu
from jax.scipy.special import gammaln

from miso_jax.sampler.mcmc import EventBatch, SamplerConfig, SamplerResult

NEG_BIG = -1e30
TWO_PI = 2.0 * np.pi

# counter-based generator constants (hash32 is Wellons' lowbias32)
_H1, _H2 = 0x7FEB352D, 0x846CA68B
GOLDEN = 0x9E3779B9   # iteration stride of the per-lane key
WORD = 0x85EBCA6B     # word stride within an iteration
LANE_SALT = 0x2545F491


def hash32(x):
    """uint32 -> uint32 avalanche hash (a bijection)."""
    x = x ^ (x >> 16)
    x = x * np.uint32(_H1)
    x = x ^ (x >> 15)
    x = x * np.uint32(_H2)
    return x ^ (x >> 16)


def _u23(w):
    """Uniform [0, 1) from the top 23 bits of a word."""
    return (w >> 9).astype(jnp.int32).astype(jnp.float32) * (2.0 ** -23)


def _u16(bits):
    """Uniform (0, 1) from 16 bits, low bit pinned (u > 0 strictly)."""
    return (bits | 1).astype(jnp.int32).astype(jnp.float32) * (2.0 ** -16)


def _safe_log(x):
    return jnp.log(jnp.maximum(x, 1e-38))


def _sampler_kernel(keys_ref, read_w_ref, read_ls_ref, ev_iso_ref,
                    ev_scal_ref, *refs, cfg: SamplerConfig, E: int, K: int,
                    I: int, R: int, L: int, NL: int, RC: int,
                    has_start: bool):
    if has_start:
        start_ref, refs = refs[0], refs[1:]
    psi_out, ll_out, acc_out, fn_out, fpsi_out = refs
    f32, u32 = jnp.float32, jnp.uint32
    lane0 = pl.program_id(0) * L
    lane = lane0 + jnp.arange(L, dtype=jnp.int32)           # (L,)
    ev = jnp.minimum(lane // K, E - 1)                      # (L,)
    seed = keys_ref[0]
    g = lane.astype(u32) + keys_ref[1]                      # global lane
    lane_key = hash32(hash32(g ^ np.uint32(LANE_SALT)) ^ hash32(seed))

    # ---- per-event constants, gathered per lane
    kf = ev_scal_ref[ev]
    noise_scale = ev_scal_ref[E + ev]
    dir_const = ev_scal_ref[2 * E + ev]
    log_iso_w = [ev_iso_ref[i * E + ev] for i in range(I)]
    hyper = [ev_iso_ref[(I + i) * E + ev] for i in range(I)]
    iso_mask = [jnp.where(kf > i, 1.0, 0.0) for i in range(I)]
    amask = [jnp.where(kf - 1.0 > i, 1.0, 0.0) for i in range(I)]
    last = [jnp.where(kf - 1.0 == i, 1.0, 0.0) for i in range(I)]
    km1 = sum(amask[1:], amask[0])
    kk = km1 + 1.0
    # ALL score math runs in alpha space: with e = exp(alpha) (head
    # isoforms) and denom = 1 + sum(e), psi_i = e_i / denom (last
    # isoform: 1 / denom), log psi_i = alpha_aug_i - log(denom) -- one
    # exp per isoform and two logs per iteration
    eiw = [jnp.exp(log_iso_w[i]) * iso_mask[i] for i in range(I)]
    a_liw = [jnp.where(iso_mask[i] > 0, log_iso_w[i], 0.0)
             for i in range(I)]
    h1 = [jnp.where(iso_mask[i] > 0, hyper[i] - 1.0, 0.0)
          for i in range(I)]
    H1 = sum(h1[1:], h1[0])

    def stats(alpha):
        e = [jnp.exp(alpha[i]) * amask[i] for i in range(I)]
        denom = 1.0 + sum(e[1:], e[0])
        ld = _safe_log(denom)
        e_aug = [e[i] + last[i] for i in range(I)]
        psi = [e_aug[i] / denom for i in range(I)]
        logS = _safe_log(sum((e_aug[i] * eiw[i] for i in range(1, I)),
                             e_aug[0] * eiw[0]))
        return psi, ld, logS

    # ---- the read tiles: (I, R, E) flat, event-minor; chunk c holds
    # reads [c*RC, (c+1)*RC) as an even-row and an odd-row (RC/2, L) tile
    RC2 = RC // 2
    nch = -(-R // RC)
    q = jnp.arange(RC2, dtype=jnp.int32)[:, None]          # (RC2, 1)
    ev_row = ev[None, :]                                    # (1, L)
    ragged = nch * RC != R

    def load_tile(ref, i, r):
        off = i * (R * E) + r * E + ev_row                  # (RC2, L)
        if ragged:
            ok = jnp.broadcast_to(r < R, off.shape)
            off = jnp.where(ok, off, 0)
            return plgpu.load(ref.at[off], mask=ok, other=0).astype(f32)
        return ref[off].astype(f32)

    def rows(c, half):
        return 2 * (c * RC2 + q) + half                     # (RC2, 1)

    def count_valid(c, acc):
        for half in (0, 1):
            r = rows(c, half)
            tot = load_tile(read_w_ref, 0, r)
            for i in range(1, I):
                tot = tot + load_tile(read_w_ref, i, r)
            acc = acc + jnp.where(tot > 0, 1.0, 0.0)
        return acc

    n_valid = jnp.sum(lax.fori_loop(0, nch, count_valid,
                                    jnp.zeros((RC2, L), f32)), axis=0)
    n_pad = float(nch * RC) - n_valid

    H = (I + 1) // 2
    read_word0 = 1 + 2 * H

    def normals(it_key):
        """I standard normals: Box-Muller pair h feeds isoforms 2h
        (cos) and 2h+1 (sin) from words 1+2h, 2+2h."""
        z = []
        for h in range(H):
            u1 = jnp.maximum(_u23(hash32(it_key + np.uint32(
                ((1 + 2 * h) * WORD) & 0xFFFFFFFF))), 2.0 ** -24)
            u2 = _u23(hash32(it_key + np.uint32(
                ((2 + 2 * h) * WORD) & 0xFFFFFFFF)))
            rad = jnp.sqrt(-2.0 * jnp.log(u1))
            ang = TWO_PI * u2
            z.append(rad * jnp.cos(ang))
            if 2 * h + 1 < I:
                z.append(rad * jnp.sin(ang))
        return z

    def gibbs(psi, it_key, rp_old, compute_rp):
        """psi -> (n per isoform, read score).  read score cancels in
        the MH ratio and feeds only RECORDED log-likelihoods, so only
        compute_rp steps reduce it."""
        base = (it_key + np.uint32((read_word0 * WORD) & 0xFFFFFFFF)
                )[None, :]
        psi_r = [p[None, :] for p in psi]

        def chunk(c, carry):
            cnt, rp = carry
            pair = (c * RC2 + q).astype(u32)
            words = hash32(base + pair * np.uint32(WORD))   # (RC2, L)
            for half in (0, 1):
                r = rows(c, half)
                bits = (words & np.uint32(0xFFFF)) if half == 0 \
                    else (words >> 16)
                cums = []
                acc = None
                for i in range(I):
                    t = load_tile(read_w_ref, i, r) * psi_r[i]
                    acc = t if acc is None else acc + t
                    cums.append(acc)
                u = _u16(bits) * acc
                ge = [jnp.where(cums[i] >= u, 1.0, 0.0)
                      for i in range(I - 1)]
                cnt = [cnt[i] + ge[i] for i in range(I - 1)]
                if compute_rp:
                    ge = ge + [jnp.where(acc > 0, 1.0, 0.0)]
                    prev = None
                    for i in range(I):
                        oh = ge[i] if prev is None else ge[i] - prev
                        rp = rp + oh * load_tile(read_ls_ref, i, r)
                        prev = ge[i]
            return cnt, rp

        zero = jnp.zeros((RC2, L), f32)
        cnt, rp = lax.fori_loop(0, nch, chunk,
                                ([zero] * (I - 1), zero))
        cnt = [jnp.sum(c, axis=0) for c in cnt]
        # padded rows count into every cums >= u (0 >= 0): they leave
        # bin 0 and the last bin ends at the TRUE valid total
        n, prev = [], n_pad
        for i in range(I - 1):
            n.append(cnt[i] - prev)
            prev = cnt[i]
        n.append(n_valid - (prev - n_pad))
        rp = jnp.sum(rp, axis=0) if compute_rp else rp_old
        return n, rp

    def it_key_of(m):
        return hash32(lane_key + (m + 1).astype(u32) * np.uint32(GOLDEN))

    def joint_abs(alpha, ld, logS, n, rp):
        """Absolute joint score splicing_score_joint (miso.c:243-307)
        of the current state, for RECORDED log-likelihoods only."""
        t = sum((n[i] + h1[i]) * alpha[i] * amask[i] + n[i] * a_liw[i]
                for i in range(I))
        return rp + t - n_valid * logS - H1 * ld + dir_const

    # ---- init (miso.c:348-371 AUTO start + :834 propose + :840 gibbs);
    # has_start: the GIVEN start (miso.c:405-409), alpha = logit ratio
    key0 = hash32(lane_key)
    if has_start:
        sp = [start_ref[pl.ds(i * NL + lane0, L)] for i in range(I)]
        sp_last = sum((sp[i] * last[i] for i in range(1, I)),
                      sp[0] * last[0])
        alpha0 = [jnp.where(amask[i] > 0,
                            _safe_log(jnp.maximum(sp[i], 1e-30))
                            - _safe_log(jnp.maximum(sp_last, 1e-30)), 0.0)
                  for i in range(I)]
    else:
        a0 = jnp.where(km1 == 1.0, 0.0, 1.0 / jnp.maximum(km1, 1.0))
        alpha0 = [a0 * amask[i] for i in range(I)]
    z = normals(key0)
    alpha = [alpha0[i] + noise_scale * z[i] * amask[i] for i in range(I)]
    psi, ld, logS = stats(alpha)
    n, rp = gibbs(psi, key0, jnp.zeros((L,), f32), True)
    state = (alpha, psi, ld, logS, n, rp, jnp.zeros((L,), f32))

    def step(m, st, compute_rp=False, want_score=False):
        """One MH+Gibbs iteration (the hot loop miso.c:845-900).  The MH
        log-ratio is assembled in alpha space: the proposal quadratic
        (miso.c:97-122) is symmetric and cancels, the read-score term is
        assignment-only and cancels, and the rest is linear in
        d = alpha_new - alpha."""
        alpha, psi, ld, logS, n, rp, acc = st
        it_key = it_key_of(m)
        full = jnp.minimum(m, 1).astype(f32)   # 0 on iteration 0
        z = normals(it_key)
        d = [noise_scale * z[i] * amask[i] for i in range(I)]
        alpha_new = [alpha[i] + d[i] for i in range(I)]
        psi_new, ld_new, logS_new = stats(alpha_new)
        logr = (sum((n[i] + h1[i]) * d[i] for i in range(I))
                - n_valid * (logS_new - logS) - H1 * (ld_new - ld)
                + full * (sum(d[1:], d[0]) + kk * (ld - ld_new)))
        u = jnp.maximum(_u23(hash32(it_key)), 2.0 ** -24)
        accept = (logr >= 0) | (jnp.log(u) < logr)
        alpha = [jnp.where(accept, alpha_new[i], alpha[i])
                 for i in range(I)]
        psi = [jnp.where(accept, psi_new[i], psi[i]) for i in range(I)]
        ld = jnp.where(accept, ld_new, ld)
        logS = jnp.where(accept, logS_new, logS)
        acc = acc + jnp.where(accept, 1.0, 0.0)
        score = joint_abs(alpha, ld, logS, n, rp) if want_score else None
        n, rp = gibbs(psi, it_key, rp, compute_rp)
        return (alpha, psi, ld, logS, n, rp, acc), score

    def plain(m, st):
        return step(m, st)[0]

    # static record schedule (matches mcmc.py): burn_in steps, then a
    # record after every `lag` steps; the step FEEDING each recorded
    # score reduces the read-score term
    lag, pre, nrec = cfg.lag, cfg.burn_in, cfg.num_records
    if pre > 0:
        state = lax.fori_loop(0, pre - 1, plain, state)
        state = step(jnp.int32(pre - 1), state, compute_rp=(lag == 1))[0]

    def record(rec, st):
        m0 = pre + rec * lag
        if lag >= 2:
            st = lax.fori_loop(0, lag - 2,
                               lambda j, s: plain(m0 + j, s), st)
            st = step(m0 + lag - 2, st, compute_rp=True)[0]
        st, score = step(m0 + lag - 1, st, compute_rp=(lag == 1),
                         want_score=True)
        for i in range(I):
            psi_out[pl.ds((rec * I + i) * NL + lane0, L)] = st[1][i]
        ll_out[pl.ds(rec * NL + lane0, L)] = score
        return st

    state = lax.fori_loop(0, nrec, record, state)
    tail = pre + nrec * lag
    if tail < cfg.iters:
        state = lax.fori_loop(tail, cfg.iters, plain, state)

    _, psi, _, _, n, _, acc = state
    acc_out[pl.ds(lane0, L)] = acc
    for i in range(I):
        fn_out[pl.ds(i * NL + lane0, L)] = n[i]
        fpsi_out[pl.ds(i * NL + lane0, L)] = psi[i]


def _next_pow2(x: int) -> int:
    return 1 << max(int(x) - 1, 0).bit_length()


def block_shape(E: int, K: int, R: int, max_lanes: int = 32,
                max_chunk: int = 32):
    """(L lanes per program, RC reads per chunk, programs).  Triton
    blocks are powers of two: L covers E*K lanes (the last program's
    surplus lanes recompute the last event and are never read), RC
    covers R in ceil(R / RC) chunks of two (RC/2, L) row tiles."""
    L = min(max_lanes, max(_next_pow2(E * K), 16))
    RC = min(max_chunk, max(_next_pow2(R), 2))
    return L, RC, -(-(E * K) // L)


@functools.partial(jax.jit, static_argnames=(
    "cfg", "interpret", "max_lanes", "max_chunk", "num_warps"))
def run_batch_pallas(key, events: EventBatch, cfg: SamplerConfig,
                     interpret: bool = False, start_psi=None,
                     lane_offset=0, max_lanes: int = 32,
                     max_chunk: int = 32,
                     num_warps: int = 4) -> SamplerResult:
    """Drop-in alternative to mcmc.run_batch (REASSIGN + per-read Gibbs).

    Optional `start_psi` (E, K, I) selects the GIVEN chain start
    (miso.c:405-409), used by convergent-mode continuation rounds and
    the NNLS linear start.  `lane_offset` is the global index of this
    batch's first (event, chain) lane: a shard of a larger batch passes
    its offset so that each lane draws the same random stream as in the
    unsharded run.  interpret=True runs the kernel in the Pallas
    interpreter (CPU tests)."""
    assert cfg.algorithm == "reassign"
    E, _, I = events.weights.shape
    R = events.read_w.shape[1]
    K = cfg.chains
    L, RC, NB = block_shape(E, K, R, max_lanes, max_chunk)
    NL = NB * L
    RREC = cfg.num_records
    f32 = jnp.float32

    num_iso = events.num_iso.astype(jnp.int32)
    kf = num_iso.astype(f32)
    iso_mask = jnp.arange(I)[None, :] < num_iso[:, None]
    sigma = 0.2 / (kf * kf)
    noise_scale = jnp.where(num_iso == 2, sigma, jnp.sqrt(sigma))
    h = jnp.where(iso_mask, events.hyper.astype(f32), 1.0)
    dir_const = (gammaln(jnp.sum(jnp.where(iso_mask, h, 0.0), axis=1))
                 - jnp.sum(jnp.where(iso_mask, gammaln(h), 0.0), axis=1))
    ev_scal = jnp.concatenate([kf, noise_scale, dir_const])     # (3E,)
    liw = jnp.maximum(events.log_iso_w.astype(f32), NEG_BIG)
    ev_iso = jnp.concatenate([liw.T, h.T]).reshape(-1)          # (2I*E,)
    # (E, R, I) -> (I, R, E): event-minor, so an event's K lanes load
    # the same addresses
    read_w = jnp.transpose(events.read_w, (2, 1, 0)).reshape(-1)
    read_ls = jnp.transpose(events.read_logscore, (2, 1, 0)).reshape(-1)
    seed = jax.random.bits(key, (), jnp.uint32)
    keys = jnp.stack([seed, jnp.asarray(lane_offset).astype(jnp.uint32)])

    inputs = [keys, read_w, read_ls, ev_iso, ev_scal]
    has_start = start_psi is not None
    if has_start:
        sp = jnp.asarray(start_psi, f32).reshape(E * K, I).T    # (I, E*K)
        sp = jnp.pad(sp, ((0, 0), (0, NL - E * K)))
        inputs.append(sp.reshape(-1))

    kernel = functools.partial(
        _sampler_kernel, cfg=cfg, E=E, K=K, I=I, R=R, L=L, NL=NL, RC=RC,
        has_start=has_start)
    nrec = max(RREC, 1)
    psi_s, loglik, acc, final_n, final_psi = pl.pallas_call(
        kernel,
        grid=(NB,),
        out_shape=[
            jax.ShapeDtypeStruct((nrec * I * NL,), f32),
            jax.ShapeDtypeStruct((nrec * NL,), f32),
            jax.ShapeDtypeStruct((NL,), f32),
            jax.ShapeDtypeStruct((I * NL,), f32),
            jax.ShapeDtypeStruct((I * NL,), f32),
        ],
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=num_warps,
                                             num_stages=1),
        interpret=interpret,
        name="miso_reassign_sampler",
    )(*inputs)

    EK = E * K
    psi_samples = jnp.transpose(
        psi_s.reshape(nrec, I, NL)[:RREC, :, :EK].reshape(RREC, I, E, K),
        (2, 0, 3, 1))
    loglik_out = jnp.transpose(
        loglik.reshape(nrec, NL)[:RREC, :EK].reshape(RREC, E, K),
        (1, 0, 2))
    accepted = jnp.sum(acc[:EK].reshape(E, K), axis=1).astype(jnp.int32)
    final_n_out = jnp.transpose(
        final_n.reshape(I, NL)[:, :EK].reshape(I, E, K), (1, 2, 0))
    final_psi_out = jnp.transpose(
        final_psi.reshape(I, NL)[:, :EK].reshape(I, E, K), (1, 2, 0))
    total = cfg.iters * K
    return SamplerResult(
        psi_samples=psi_samples, loglik=loglik_out,
        accepted=accepted, rejected=total - accepted,
        final_n=final_n_out, final_psi=final_psi_out,
    )
