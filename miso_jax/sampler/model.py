"""Probabilistic model math for the MISO sampler, in masked batched JAX.

Semantics-parity functions (cited into the reference C engine):

- logistic-normal drift proposal:  pysplicing/src/miso.c:184-241,449-491
- multivariate logistic-normal score: pysplicing/src/miso.c:97-122
- Dirichlet log-pdf:               pysplicing/src/miso.c:165-182
- isoform (assignment) score:      pysplicing/src/miso.c:124-163 and
                                   miso_paired.c:88-131
- joint score:                     pysplicing/src/miso.c:243-307

All functions operate on one event (one chain); batching over
(events x chains) is done with jax.vmap in mcmc.py.  Every event is padded
to a common number of isoforms I; masking conventions:

- ``iso_mask``: (I,) bool, True for real isoforms (k = num real isoforms).
- ``amask``:    (I-1,) bool, True for the first k-1 logit dimensions.
- ``last_onehot``: (I,) one-hot at index k-1 (the "remainder" isoform of the
  logit parametrization).
- psi of padded isoforms is exactly 0 and excluded from every sum.

Replicated reference quirks (deliberate):
- proposal sigma = 0.2/k**2 regardless of user sigma (miso.c:328 SIGMA macro;
  the Python-level `sigma_proposal` is ignored by the C engine).
- the proposal noise scale is sigma (NOT sqrt(sigma)) when k == 2
  (miso.c:188: ``sqrtsigma = len == 1 ? sigma : sqrt(sigma)``).

Known deliberate divergence: for paired-end reads the reference adds the
*linear* fragment probability to the per-read log score
(miso_paired.c:403-411 adds ``fragmentProb[j]`` where the model calls for
``log fragmentProb[j]``).  Because the read-score term depends only on the
assignment -- not on psi -- it cancels in the Metropolis-Hastings ratio and
only shifts the recorded log-likelihoods; we use the correct log-probability.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax.scipy.special import gammaln

NEG_INF = -jnp.inf


class EventMasks(NamedTuple):
    """Static per-event mask set derived from the real isoform count k."""

    iso_mask: jnp.ndarray      # (I,) bool
    amask: jnp.ndarray         # (I-1,) bool
    last_onehot: jnp.ndarray   # (I,) float
    k: jnp.ndarray             # () int32
    sigma: jnp.ndarray         # () float32: 0.2 / k**2
    noise_scale: jnp.ndarray   # () float32: sigma if k==2 else sqrt(sigma)


def make_masks(num_iso: jnp.ndarray, I: int) -> EventMasks:
    """Build masks for an event with `num_iso` real isoforms padded to I."""
    k = num_iso.astype(jnp.int32)
    ar = jnp.arange(I)
    iso_mask = ar < k
    amask = jnp.arange(I - 1) < (k - 1)
    last_onehot = (ar == (k - 1)).astype(jnp.float32)
    kf = k.astype(jnp.float32)
    sigma = 0.2 / (kf * kf)
    noise_scale = jnp.where(k == 2, sigma, jnp.sqrt(sigma))
    return EventMasks(iso_mask, amask, last_onehot, k, sigma, noise_scale)


def logistic_inv(alpha: jnp.ndarray, masks: EventMasks) -> jnp.ndarray:
    """alpha (I-1,) -> psi (I,), masked inverse-logit.

    psi_i = exp(a_i) / (1 + sum_j exp(a_j)) for i < k-1, remainder at k-1.
    Ref: pysplicing/src/miso.c:219-241 + :462-468.
    """
    exp_a = jnp.where(masks.amask, jnp.exp(alpha), 0.0)
    denom = 1.0 + jnp.sum(exp_a)
    head = exp_a / denom
    psi = jnp.concatenate([head, jnp.zeros((1,), head.dtype)])
    return psi + masks.last_onehot * (1.0 - jnp.sum(head))


def propose(alpha, eps, masks: EventMasks):
    """Drift proposal: alphaNew = alpha + noise_scale * eps (masked dims).

    Returns (alphaNew, psiNew). Ref: pysplicing/src/miso.c:449-471.
    """
    alpha_new = alpha + masks.noise_scale * jnp.where(masks.amask, eps, 0.0)
    return alpha_new, logistic_inv(alpha_new, masks)


def proposal_logpdf(psi, mu_alpha, masks: EventMasks):
    """log q(psi | mu_alpha): multivariate logistic-normal with diagonal
    sigma, evaluated on the log scale.  Ref: pysplicing/src/miso.c:97-122.
    """
    sigma = masks.sigma
    lenf = (masks.k - 1).astype(psi.dtype)
    ltheta = jnp.sum(psi * masks.last_onehot)
    theta = psi[:-1]
    safe_log_theta = jnp.where(masks.amask, jnp.log(theta), 0.0)
    log_prod = jnp.sum(safe_log_theta)
    tmp = jnp.where(masks.amask, safe_log_theta - jnp.log(ltheta) - mu_alpha, 0.0)
    exp_part = -0.5 * jnp.sum(tmp * tmp) / sigma
    covar_const = -0.5 * lenf * jnp.log(2.0 * jnp.pi * sigma)
    return covar_const - log_prod - jnp.log(ltheta) + exp_part


def ldirichlet(psi, hyper, masks: EventMasks):
    """Dirichlet log-pdf with masked components.
    Ref: pysplicing/src/miso.c:165-182."""
    h = jnp.where(masks.iso_mask, hyper, 1.0)
    logx = jnp.where(masks.iso_mask, jnp.log(psi), 0.0)
    score = jnp.sum(jnp.where(masks.iso_mask, (h - 1.0) * logx, 0.0))
    asum = jnp.sum(jnp.where(masks.iso_mask, h, 0.0))
    lg = jnp.sum(jnp.where(masks.iso_mask, gammaln(h), 0.0))
    return score + gammaln(asum) - lg


def score_assignments(psi, n_per_iso, log_iso_w, masks: EventMasks):
    """Assignment score: sum_j n_j * lognorm_j where
    lognorm = log psi + log_iso_w - logsumexp(...).

    Single-end: log_iso_w = log(effective isoform length)
    (pysplicing/src/miso.c:124-163); paired-end: log_iso_w = assscores
    (miso_paired.c:88-131).
    """
    lp = jnp.where(masks.iso_mask, jnp.log(psi) + log_iso_w, NEG_INF)
    mx = jnp.max(lp)
    lse = jnp.log(jnp.sum(jnp.exp(lp - mx))) + mx
    lognorm = lp - lse
    return jnp.sum(jnp.where(n_per_iso > 0, n_per_iso * lognorm, 0.0))


def score_marginal(psi, weights, counts):
    """MARGINAL / CLASSES read score: sum_c counts_c * log(sum_j W_cj psi_j),
    with zero-probability classes skipped (contributing 0).

    Ref: pysplicing/src/miso.c:272-293 (both branches share this form:
    MARGINAL uses the per-read match/effLen matrix with counts=1 collapsed
    to classes; CLASSES uses the row-normalized assignment matrix with the
    read-class count vector).

    The contraction is written elementwise, NOT as `weights @ psi`: a
    default-precision f32 matmul may run in reduced precision on an
    accelerator (TF32 on a GPU), and ~2^-10 relative noise in s --
    amplified by `counts` in log space -- perturbs the MH ratio by
    whole units.  The (C, I) contraction is tiny; the elementwise form
    is exact and just as fast.
    """
    s = jnp.sum(weights * psi[None, :], axis=1)  # (C,)
    return jnp.sum(jnp.where(s > 0, counts * jnp.log(s), 0.0))


NEG_BIG = -1e30  # finite stand-in for -inf in per-read tiles (f32-safe)


def gibbs_reassign_perread(key, psi, read_w, read_logscore,
                           masks: EventMasks):
    """Per-read categorical Gibbs reassignment via inverse-CDF.

    The dense form of the reference's per-read sampling loop
    (pysplicing/src/miso.c:30-91, the CUMSUM trick at :11-22): read r
    draws isoform j with probability psi_j * W_(c_r)j / sum_j.  The
    per-read weight rows are expanded once per batch (static per
    event), so the device step is one uniform draw + a cumulative-sum
    compare per read -- no gathers, no rejection-sampling control flow
    (chained binomials serialize), no transcendentals (cheaper than
    Gumbel-argmax).

    read_w:        (R, I) class weights W[class(r), i], 0 where
                   incompatible or padding.
    read_logscore: (R, I) per-read log score by assigned isoform.
    Returns (n_per_iso (I,), read_prob ()).
    """
    # NOTE: the tile computes in f32 even though read_w is stored bf16 --
    # bf16-compute was measured to bias posterior means by ~0.02 (8-bit-
    # mantissa uniforms quantize the category boundaries); storage-only
    # bf16 keeps HBM reads halved without the bias.
    rw = psi[None, :] * read_w.astype(psi.dtype)        # (R, I)
    cum = jnp.cumsum(rw, axis=1)
    total = cum[:, -1:]
    valid = total[:, 0] > 0
    u = jax.random.uniform(key, (rw.shape[0], 1), rw.dtype) * total
    # choice = index of first cum >= u; onehot via adjacent compare
    ge = cum >= u                                       # (R, I) monotone
    onehot = jnp.logical_and(
        ge, jnp.logical_not(
            jnp.pad(ge[:, :-1], ((0, 0), (1, 0)), constant_values=False)))
    # u == 0 exactly (p ~ 2^-24 per draw in f32) would land on a leading
    # zero-weight isoform; such draws are dropped instead
    onehot = jnp.logical_and(onehot, rw > 0)
    onehot = jnp.where(valid[:, None], onehot, False).astype(psi.dtype)
    n = jnp.sum(onehot, axis=0)
    read_prob = jnp.sum(onehot * read_logscore.astype(psi.dtype))
    return n, read_prob


def gibbs_reassign(key, psi, weights, counts, masks: EventMasks):
    """Per-class multinomial reassignment -- the O(classes) form of the
    per-read Gibbs step (pysplicing/src/miso.c:30-91).

    Reads in a compatibility class are exchangeable: each independently
    draws isoform j with probability psi_j * W_cj / sum, so the per-class
    assignment counts are multinomial.  Returns draws (C, I).
    """
    p = psi[None, :] * weights  # (C, I)
    tot = jnp.sum(p, axis=1, keepdims=True)
    valid = tot[:, 0] > 0
    uniform = masks.iso_mask.astype(p.dtype)
    uniform = uniform / jnp.sum(uniform)
    probs = jnp.where(valid[:, None], p / jnp.where(tot > 0, tot, 1.0), uniform)
    draws = jax.random.multinomial(key, counts, probs)
    return jnp.where(valid[:, None], draws, 0.0)
