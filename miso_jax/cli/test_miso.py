"""`test_miso` -- self-test CLI.

Parity: misopy/test_miso.py (the reference ships an end-to-end unittest
pipeline as a console script).  Runs the full pipeline on the bundled/
mounted fixtures via pytest if available, else a minimal inline check.
"""
from __future__ import annotations

import os
import subprocess
import sys


def main(argv=None) -> int:
    repo_tests = os.path.join(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))), "tests")
    if os.path.isdir(repo_tests):
        return subprocess.call(
            [sys.executable, "-m", "pytest", repo_tests, "-x", "-q"])
    # installed without tests: minimal smoke check
    import numpy as np
    from miso_jax.core.events import compile_single_end, pad_events
    from miso_jax.core.gene import make_gene
    from miso_jax.core.simulate import simulate_reads
    from miso_jax.sampler.mcmc import EventBatch, SamplerConfig, run_batch
    import jax

    g = make_gene([100, 50, 100], [[1, 2, 3], [1, 3]])
    _, pos, cig = simulate_reads(g, [0.6, 0.4], 500, 25,
                                 np.random.default_rng(0))
    ev = compile_single_end(g, pos, cig, read_len=25)
    batch = EventBatch(**{k: np.asarray(v)
                          for k, v in pad_events([ev]).items()})
    res = run_batch(jax.random.PRNGKey(0), batch,
                    SamplerConfig(iters=500, burn_in=100, lag=5, chains=2))
    mean = float(np.asarray(res.flat_samples())[0][:, 0].mean())
    ok = 0.3 < mean < 0.9
    print("smoke test: posterior mean %.3f -> %s"
          % (mean, "OK" if ok else "FAIL"))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
