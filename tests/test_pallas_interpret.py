"""CPU tests of the fused REASSIGN kernel (sampler/pallas_kernel.py) in
the Pallas interpreter.

The kernel's random numbers come from a counter-based generator, so the
interpreter runs the same random path as the card.  An independent
numpy replica of one (event, chain) lane -- generator included -- must
reproduce the kernel's records, scores, acceptance counts and final
state: the MH/Gibbs recurrence, the burn-in/lag record schedule, the
padded-read count telescoping and the output lane layout.
"""
import numpy as np
import pytest
from scipy.special import gammaln

import jax
import jax.numpy as jnp

import miso_jax.sampler.pallas_kernel as pk
from miso_jax.sampler.mcmc import EventBatch, SamplerConfig

M32 = np.uint32


def _h(x):
    """lowbias32 on uint32 arrays (wrapping arithmetic)."""
    x = np.asarray(x, np.uint32)
    with np.errstate(over="ignore"):
        x = x ^ (x >> M32(16))
        x = x * M32(0x7FEB352D)
        x = x ^ (x >> M32(15))
        x = x * M32(0x846CA68B)
        return x ^ (x >> M32(16))


def _add(a, b):
    """uint32 wrapping a + b."""
    return ((np.asarray(a, np.uint64) + np.uint64(b))
            & np.uint64(0xFFFFFFFF)).astype(np.uint32)


def _word(key, j):
    return _h(_add(key, (j * pk.WORD) & 0xFFFFFFFF))


def _u23(w):
    return float(int(w) >> 9) * 2.0 ** -23


class _Stream:
    """The kernel's generator for one global lane."""

    def __init__(self, seed, lane, I):
        self.I = I
        self.H = (I + 1) // 2
        self.lane_key = _h(_h(M32(lane) ^ M32(pk.LANE_SALT)) ^ _h(seed))

    def key(self, m):
        """Iteration key; m = -1 is the initial state."""
        if m < 0:
            return _h(self.lane_key)
        return _h(_add(self.lane_key, ((m + 1) * pk.GOLDEN) & 0xFFFFFFFF))

    def normals(self, key):
        z = []
        for h in range(self.H):
            u1 = max(_u23(_word(key, 1 + 2 * h)), 2.0 ** -24)
            u2 = _u23(_word(key, 2 + 2 * h))
            rad = np.sqrt(-2.0 * np.log(u1))
            z += [rad * np.cos(2 * np.pi * u2), rad * np.sin(2 * np.pi * u2)]
        return np.array(z[:self.I])

    def accept_u(self, key):
        return max(_u23(_word(key, 0)), 2.0 ** -24)

    def read_u(self, key, R):
        base = 1 + 2 * self.H
        out = np.empty(R)
        for r in range(R):
            w = int(_word(key, base + r // 2))
            bits = (w & 0xFFFF) if r % 2 == 0 else (w >> 16)
            out[r] = (bits | 1) * 2.0 ** -16
        return out


def _sim_lane(read_w, rls, log_iso_w, hyper, num_iso, cfg, stream,
              start_psi=None):
    """Numpy replica of one (event, chain) lane of the kernel."""
    R, I = read_w.shape
    iso_mask = (np.arange(I) < num_iso).astype(float)
    amask = (np.arange(I) < num_iso - 1).astype(float)
    last = (np.arange(I) == num_iso - 1).astype(float)
    km1 = amask.sum()
    sigma = 0.2 / (num_iso * num_iso)
    noise = sigma if num_iso == 2 else np.sqrt(sigma)
    h = np.where(iso_mask > 0, hyper, 1.0)
    dir_const = gammaln(h[iso_mask > 0].sum()) - gammaln(h[iso_mask > 0]).sum()
    liw = np.maximum(log_iso_w, -1e30)
    eiw = np.exp(liw) * iso_mask
    a_liw = np.where(iso_mask > 0, liw, 0.0)
    h1 = np.where(iso_mask > 0, h - 1.0, 0.0)
    H1 = h1.sum()
    valid = read_w.sum(axis=1) > 0
    n_valid = valid.sum()

    def stats(alpha):
        e = np.exp(alpha) * amask
        denom = 1.0 + e.sum()
        e_aug = e + last
        return (e_aug / denom, np.log(denom),
                np.log(max((e_aug * eiw).sum(), 1e-38)))

    def gibbs(psi, key):
        cums = np.cumsum(read_w * psi[None, :], axis=1)
        u = stream.read_u(key, R) * cums[:, -1]
        ge = cums >= u[:, None]
        ge[:, -1] = True
        choice = np.argmax(ge, axis=1)
        n = np.bincount(choice[valid], minlength=I).astype(float)
        rp = rls[np.arange(R), choice][valid].sum()
        return n, rp

    if start_psi is not None:
        sp_last = (start_psi * last).sum()
        alpha0 = np.where(amask > 0, np.log(np.maximum(start_psi, 1e-30))
                          - np.log(max(sp_last, 1e-30)), 0.0)
    else:
        alpha0 = amask * (0.0 if km1 == 1.0 else 1.0 / max(km1, 1.0))
    key = stream.key(-1)
    alpha = alpha0 + noise * stream.normals(key) * amask
    psi, ld, logS = stats(alpha)
    n, rp = gibbs(psi, key)
    acc = 0
    rec_psi, rec_ll = [], []
    for m in range(cfg.iters):
        key = stream.key(m)
        d = noise * stream.normals(key) * amask
        psi_new, ld_new, logS_new = stats(alpha + d)
        logr = (((n + h1) * d).sum() - n_valid * (logS_new - logS)
                - H1 * (ld_new - ld)
                + (m > 0) * (d.sum() + (km1 + 1.0) * (ld - ld_new)))
        if logr >= 0 or np.log(stream.accept_u(key)) < logr:
            alpha, psi, ld, logS = alpha + d, psi_new, ld_new, logS_new
            acc += 1
        if m + 1 > cfg.burn_in and (m + 1 - cfg.burn_in) % cfg.lag == 0:
            t = ((n + h1) * alpha * amask + n * a_liw).sum()
            rec_psi.append(psi.copy())
            rec_ll.append(rp + t - n_valid * logS - H1 * ld + dir_const)
        n, rp = gibbs(psi, key)
    return np.array(rec_psi), np.array(rec_ll), acc, n, psi


def _reads_batch(E, R, I, seed):
    rng = np.random.default_rng(seed)
    read_w = (rng.random((E, R, I)) < 0.7).astype(np.float32)
    read_w[:, -3:, :] = 0.0          # padded reads
    read_w[:, 0, :] = 1.0
    rls = np.where(read_w > 0, np.log(0.01 + rng.random((E, R, I))), 0.0
                   ).astype(np.float32)
    lens = np.array([200.0, 120.0, 80.0, 150.0, 90.0, 60.0, 170.0, 110.0])
    return EventBatch(
        weights=np.zeros((E, 4, I), np.float32),
        log_read=np.zeros((E, 4, I), np.float32),
        counts=np.zeros((E, 4), np.float32),
        log_iso_w=np.log(np.tile(lens[:I], (E, 1))).astype(np.float32),
        hyper=np.ones((E, I), np.float32),
        num_iso=np.full((E,), I, np.int32),
        read_w=read_w,
        read_logscore=rls,
    )


def _check_against_replica(batch, cfg, key, start=None, lane_offset=0):
    out = pk.run_batch_pallas(key, batch, cfg, interpret=True,
                              start_psi=start, lane_offset=lane_offset)
    seed = np.asarray(jax.random.bits(key, (), jnp.uint32))
    E, R, I = batch.read_w.shape
    K = cfg.chains
    psi_s = np.asarray(out.psi_samples)    # (E, RREC, K, I)
    ll = np.asarray(out.loglik)            # (E, RREC, K)
    final_n = np.asarray(out.final_n)      # (E, K, I)
    final_psi = np.asarray(out.final_psi)
    for e in range(E):
        acc = 0
        for k in range(K):
            sim_psi, sim_ll, sim_acc, sim_n, sim_fpsi = _sim_lane(
                batch.read_w[e].astype(np.float64),
                batch.read_logscore[e].astype(np.float64),
                batch.log_iso_w[e].astype(np.float64),
                batch.hyper[e].astype(np.float64),
                int(batch.num_iso[e]), cfg,
                _Stream(seed, lane_offset + e * K + k, I),
                start_psi=None if start is None
                else start[e, k].astype(np.float64))
            np.testing.assert_allclose(psi_s[e, :, k, :], sim_psi,
                                       rtol=0, atol=2e-4)
            np.testing.assert_allclose(ll[e, :, k], sim_ll, rtol=0,
                                       atol=2e-3)
            np.testing.assert_array_equal(final_n[e, k], sim_n)
            np.testing.assert_allclose(final_psi[e, k], sim_fpsi, atol=2e-4)
            acc += sim_acc
        assert int(np.asarray(out.accepted)[e]) == acc


@pytest.mark.parametrize("num_iso", [2, 3])
def test_kernel_matches_numpy_sim_interpret(num_iso):
    batch = _reads_batch(2, 16, num_iso, seed=0)
    cfg = SamplerConfig(iters=24, burn_in=6, lag=3, chains=2)
    _check_against_replica(batch, cfg, jax.random.PRNGKey(0))


def test_kernel_given_start_interpret():
    """GIVEN-start (miso.c:405-409): each (event, chain) lane starts from
    its own psi and must match the replica seeded the same way; lag=1
    after a burn-in checks the score of the first record, and a lane
    offset checks the global lane keying."""
    batch = _reads_batch(2, 16, 2, seed=5)
    cfg = SamplerConfig(iters=12, burn_in=4, lag=1, chains=2)
    p0 = np.array([[0.9, 0.3], [0.6, 0.15]], np.float32)
    start = np.stack([p0, 1.0 - p0], axis=-1)     # (E, K, I)
    _check_against_replica(batch, cfg, jax.random.PRNGKey(7), start=start,
                           lane_offset=5)


@pytest.mark.parametrize("num_iso", [2, 3, 4, 5, 6, 7, 8])
def test_block_padding_and_chunking(num_iso):
    """E*K not a multiple of the lane block, R not a multiple of the read
    chunk, and padded isoforms (num_iso < I for one event): every lane
    must equal the same lane of a one-block run, because each draw is
    keyed by the global lane and not by the block layout."""
    E, R, I, K = 5, 21, num_iso, 3
    batch = _reads_batch(E, R, I, seed=num_iso)
    num_iso_v = np.full((E,), I, np.int32)
    num_iso_v[1] = 2                                 # padded isoforms
    read_w = batch.read_w.copy()
    read_w[1, :, 2:] = 0.0
    batch = batch._replace(num_iso=num_iso_v, read_w=read_w)
    cfg = SamplerConfig(iters=10, burn_in=2, lag=2, chains=K)
    key = jax.random.PRNGKey(3)
    assert pk.block_shape(E, K, R, max_lanes=16, max_chunk=4) == (16, 4, 1)
    assert pk.block_shape(E, K, R, max_lanes=64, max_chunk=32) == (16, 32, 1)
    blocked = pk.run_batch_pallas(key, batch, cfg, interpret=True,
                                  max_lanes=16, max_chunk=4)
    whole = pk.run_batch_pallas(key, batch, cfg, interpret=True,
                                max_lanes=64, max_chunk=32)
    for name in blocked._fields:
        a, b = (np.asarray(getattr(r, name)) for r in (blocked, whole))
        if name == "loglik":  # read-score sums reassociate per chunk size
            np.testing.assert_allclose(a, b, rtol=1e-6)
        else:
            np.testing.assert_array_equal(a, b)
    psi = np.asarray(blocked.psi_samples)
    assert psi.shape == (E, cfg.num_records, K, I)
    np.testing.assert_allclose(psi.sum(axis=-1), 1.0, atol=1e-5)
    assert np.all(psi[1, :, :, 2:] == 0.0)           # padded isoforms
    valid = (batch.read_w.sum(axis=2) > 0).sum(axis=1)
    np.testing.assert_array_equal(np.asarray(blocked.final_n).sum(axis=-1),
                                  np.repeat(valid[:, None], K, axis=1))


def test_block_shape_rule():
    """Powers of two, floored at 16 lanes, capped, covering every lane."""
    assert pk.block_shape(2048, 6, 224) == (32, 32, 384)
    assert pk.block_shape(1, 6, 20) == (16, 32, 1)
    assert pk.block_shape(3, 6, 7, max_lanes=16, max_chunk=4) == (16, 4, 2)
    for E in (1, 5, 100, 333):
        L, RC, NB = pk.block_shape(E, 6, 100, max_lanes=32)
        assert L & (L - 1) == 0 and RC & (RC - 1) == 0
        assert NB * L >= E * 6 > (NB - 1) * L


def test_generator_uniform_and_independent():
    """hash32 words: the kernel's hash equals the replica's, lane keys
    are distinct, 16- and 23-bit uniforms pass a chi-square test, and
    words of neighbouring lanes and iterations are uncorrelated."""
    seed = np.uint32(12345)
    lanes = np.arange(4096, dtype=np.uint32)
    lane_key = _h(_h(lanes ^ M32(pk.LANE_SALT)) ^ _h(seed))
    kernel_key = pk.hash32(pk.hash32(jnp.asarray(lanes)
                                     ^ np.uint32(pk.LANE_SALT))
                           ^ pk.hash32(jnp.asarray(seed)))
    np.testing.assert_array_equal(np.asarray(kernel_key), lane_key)
    assert len(np.unique(lane_key)) == lanes.size
    keys = np.stack([_h(_add(lane_key, ((m + 1) * pk.GOLDEN) & 0xFFFFFFFF))
                     for m in range(64)])        # (iterations, lanes)
    words = _h(_add(keys, (7 * pk.WORD) & 0xFFFFFFFF)).astype(np.int64)
    for u in (((words & 0xFFFF) | 1) / 2.0 ** 16, (words >> 9) / 2.0 ** 23):
        counts = np.histogram(u, bins=64, range=(0, 1))[0]
        expect = u.size / 64
        chi2 = ((counts - expect) ** 2 / expect).sum()
        assert chi2 < 120, chi2          # 63 dof: p ~ 1e-5
        assert abs(u.mean() - 0.5) < 0.01
        for a, b in ((u[:, :-1], u[:, 1:]), (u[:-1], u[1:])):
            assert abs(np.corrcoef(a.ravel(), b.ravel())[0, 1]) < 0.02
