"""Test configuration: hermetic CPU-only JAX with an 8-device virtual mesh.

Mirrors the reference's hermetic test strategy (misopy/test_miso.py runs the
whole pipeline on checked-in fixtures) while adding the multi-device test
path the reference lacks (SURVEY.md section 4).

Tests marked `gpu` need an NVIDIA GPU and skip elsewhere.  They run on
the card only when MISO_TEST_GPU=1 (set by chip_smoke.py); otherwise the
suite is forced onto the CPU before JAX initializes.
"""
import os

GPU_OPT_IN = os.environ.get("MISO_TEST_GPU") == "1"

if not GPU_OPT_IN:
    os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

if not GPU_OPT_IN:
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)

import pytest  # noqa: E402


@pytest.fixture(autouse=True)
def _gpu_only(request):
    """Skip `gpu`-marked tests unless JAX's default device is a GPU
    (decided per test, never at import or collection time)."""
    if request.node.get_closest_marker("gpu") is None:
        return
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (run `python chip_smoke.py` on "
                    "a GPU machine)")
    from miso_jax.pipeline import enable_compilation_cache
    enable_compilation_cache()


@pytest.fixture(scope="session")
def rng_seed():
    return 20260817
