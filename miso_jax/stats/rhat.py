"""Gelman-Rubin potential-scale-reduction diagnostics.

The reference's convergent-mean stop rule (pysplicing/src/miso.c:556-636)
implements R-hat over the chain-interleaved sample matrix with the rule
"stop when all per-isoform R-hat <= 1.1", paired with the adaptive
extension noIter' = 3*noIter - 2*burnIn (miso.c:920-928).

NOTE (deliberate divergence): the reference's W term squares the
*running sum of squared deviations* instead of the variance
(miso.c:612-617), which makes W enormous and R-hat ~ sqrt((S-1)/S) <= 1
-- i.e. the reference check effectively always passes on the first block.
The production Python layer never uses it (MISO_STOP_FIXEDNO,
misopy/miso_sampler.py:211).  We implement the textbook statistic the code
cites (Gelman et al., BDA 2nd ed. p.296) with the same stopping threshold
and extension rule.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def rhat(samples) -> jnp.ndarray:
    """samples: (R records, K chains, I isoforms) -> (I,) R-hat.

    B = between-chain variance of chain means (times R),
    W = mean within-chain variance, R-hat = sqrt(((R-1)/R + B/(R*W)))."""
    x = jnp.asarray(samples)
    R = x.shape[0]
    chain_means = jnp.mean(x, axis=0)          # (K, I)
    chain_vars = jnp.var(x, axis=0, ddof=1)    # (K, I)
    grand = jnp.mean(chain_means, axis=0)      # (I,)
    B = R * jnp.var(chain_means, axis=0, ddof=1)
    W = jnp.mean(chain_vars, axis=0)
    var_plus = (R - 1) / R * W + B / R
    return jnp.sqrt(var_plus / jnp.where(W > 0, W, 1.0))


def converged(samples, threshold: float = 1.1) -> bool:
    """All-isoform convergence test (miso.c:626-628)."""
    return bool(np.all(np.asarray(rhat(samples)) <= threshold))


@jax.jit
def batch_rhat(psi_samples) -> jnp.ndarray:
    """(E, R, K, I) -> (E, I) R-hat per event, on device.

    Jitted: ONE device dispatch per convergence check instead of one
    per eager op."""
    x = jnp.asarray(psi_samples)
    R = x.shape[1]
    chain_means = jnp.mean(x, axis=1)
    chain_vars = jnp.var(x, axis=1, ddof=1)
    B = R * jnp.var(chain_means, axis=1, ddof=1)
    W = jnp.mean(chain_vars, axis=1)
    var_plus = (R - 1) / R * W + B / R
    return jnp.sqrt(var_plus / jnp.where(W > 0, W, 1.0))


def extended_iterations(no_iter: int, burn_in: int) -> int:
    """Adaptive extension rule (miso.c:922): noIter' = 3*noIter - 2*burnIn."""
    return 3 * no_iter - 2 * burn_in
