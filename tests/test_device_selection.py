"""Choices made from the platform and the shapes: sampler backend, event
mesh, batch padding, compile-cache location, native library path."""
import os

import numpy as np
import pytest

import jax

from miso_jax import native
from miso_jax import pipeline
from miso_jax.sampler.mcmc import EventBatch, _pow2_pad_events, select_backend


@pytest.mark.parametrize("backend,platform,algorithm,gibbs,want", [
    ("auto", "gpu", "reassign", "perread", "pallas"),
    ("auto", "cpu", "reassign", "perread", "xla"),
    ("auto", "gpu", "marginal", "perread", "xla"),
    ("auto", "gpu", "classes", "perread", "xla"),
    ("auto", "gpu", "reassign", "multinomial", "xla"),
    ("pallas", "cpu", "reassign", "perread", "pallas"),
    ("pallas", "gpu", "marginal", "perread", "xla"),
    ("xla", "gpu", "reassign", "perread", "xla"),
])
def test_select_backend(backend, platform, algorithm, gibbs, want):
    assert select_backend(backend, platform, algorithm, gibbs) == want


def test_select_backend_rejects_unknown():
    with pytest.raises(ValueError):
        select_backend("mosaic", "gpu")


def test_resolve_mesh_single_device_is_unsharded(monkeypatch):
    """One device of any kind runs unsharded; several get a 1-D mesh."""
    devs = jax.local_devices()
    monkeypatch.setattr(jax, "local_devices", lambda: devs[:1])
    assert pipeline.resolve_mesh("auto") is None
    monkeypatch.setattr(jax, "local_devices", lambda: devs[:4])
    assert pipeline.resolve_mesh("auto").devices.size == 4
    assert pipeline.resolve_mesh(None) is None


@pytest.mark.parametrize("n,want", [(1, 1), (3, 4), (5, 8), (64, 64),
                                    (100, 128)])
def test_pow2_pad_events_has_no_floor(n, want):
    batch = EventBatch(*(np.ones((n, 2), np.float32) for _ in range(8)))
    sp = np.ones((n, 3, 2), np.float32)
    out, sp_out = _pow2_pad_events(batch, sp, n)
    assert out.weights.shape[0] == want and sp_out.shape[0] == want
    assert np.all(out.num_iso[n:] == 0)


def test_compilation_cache_dir_follows_env(monkeypatch, tmp_path):
    """JAX_COMPILATION_CACHE_DIR set: JAX reads it and nothing is set in
    code; unset: the fixed git-ignored directory in the checkout."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert pipeline.compilation_cache_dir() is None
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    pipeline.enable_compilation_cache()
    assert calls == []
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
    want = os.path.join(pipeline.CHECKOUT_DIR, ".jax_cache")
    assert pipeline.compilation_cache_dir() == want
    pipeline.enable_compilation_cache()
    assert ("jax_compilation_cache_dir", want) in calls


def test_native_library_keyed_by_sources(monkeypatch, tmp_path):
    """The native library is built into the git-ignored _build dir under
    a name that changes with the source text."""
    path = native._so_path()
    assert os.path.dirname(path) == native._BUILD_DIR
    copies = []
    for src in native._SRCS:
        dst = tmp_path / os.path.basename(src)
        dst.write_bytes(open(src, "rb").read())
        copies.append(str(dst))
    monkeypatch.setattr(native, "_SRCS", copies)
    assert native._so_path() == path
    with open(copies[0], "a") as f:
        f.write("\n// edited\n")
    assert native._so_path() != path
