"""Event-data parallelism over a device mesh.

The reference's entire distribution story is share-nothing process fan-out
over gene batches (misopy/miso.py:155-188 batch files; cluster_utils.py:160
qsub).  Here the padded event catalog is sharded across a 1-D
``Mesh(('ev',))`` spanning all devices (and hosts, via
jax.distributed); each device advances its shard's (events x chains)
MCMC lockstep, and catalog-level reductions (acceptance stats, posterior
summaries) ride XLA collectives instead of the filesystem.  The event
axis carries no collectives, so the mesh is 1-D whatever the
interconnect.
"""
from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from miso_jax.sampler.mcmc import (EventBatch, SamplerConfig, SamplerResult,
                                   run_batch, select_backend)

EVENT_AXIS = "ev"


def make_event_mesh(devices=None) -> Mesh:
    """1-D mesh over all (or given) devices, events sharded along it."""
    if devices is None:
        devices = jax.devices()
    return Mesh(np.array(devices), (EVENT_AXIS,))


def pad_to_devices(arr: np.ndarray, n: int) -> np.ndarray:
    """Pad axis 0 to a multiple of n (zero events are masked out by
    counts=0 and contribute nothing)."""
    e = arr.shape[0]
    rem = (-e) % n
    if rem == 0:
        return arr
    pad = np.zeros((rem,) + arr.shape[1:], arr.dtype)
    return np.concatenate([arr, pad], axis=0)


def shard_batch(batch: EventBatch, mesh: Mesh) -> EventBatch:
    """Place a host EventBatch onto the mesh, sharded over events, with
    ONE device_put of the whole pytree (not one transfer per field)."""
    n = mesh.devices.size
    sharding = NamedSharding(mesh, P(EVENT_AXIS))

    def prep(a):
        # device arrays whose event axis already divides the mesh skip
        # the host round-trip (np.asarray would fetch them back): the
        # pipeline's device-expanded per-read tensors take this path
        if isinstance(a, jax.Array) and a.shape[0] % n == 0:
            return a
        return pad_to_devices(np.asarray(a), n)

    return jax.device_put(EventBatch(*(prep(a) for a in batch)), sharding)


def run_batch_sharded(
    key: jnp.ndarray,
    batch: EventBatch,
    cfg: SamplerConfig,
    mesh: Optional[Mesh] = None,
    backend: str = "auto",
    start_psi=None,
    interpret: bool = False,
) -> SamplerResult:
    """Run the sampler over a sharded catalog.

    The per-event computation partitions cleanly along the event axis;
    XLA keeps every tensor sharded and the result arrives sharded, so
    posterior reduction can also stay on-device.

    backend='pallas' (the 'auto' choice on GPUs, see
    mcmc.select_backend) launches the fused REASSIGN kernel per shard
    under shard_map -- the event axis has no cross-device traffic, so
    each device runs the same single-device kernel on its slice.  Each
    shard passes its global lane offset, so every (event, chain) draws
    the same random stream as in an unsharded run.

    `start_psi` (E, K, I) selects the GIVEN chain start (miso.c:405-409);
    both the fused kernel and the XLA sampler support it.
    """
    if mesh is None:
        mesh = make_event_mesh()
    backend = select_backend(backend, mesh.devices.flat[0].platform,
                             cfg.algorithm, cfg.gibbs)
    sharded = shard_batch(batch, mesh)
    n = mesh.devices.size
    sp = None
    if start_psi is not None:
        sp = jax.device_put(
            pad_to_devices(np.asarray(start_psi, np.float32), n),
            NamedSharding(mesh, P(EVENT_AXIS)))
    if backend != "pallas":
        return run_batch(key, sharded, cfg, start_psi=sp)
    if sp is None:
        return _sharded_fn(mesh, cfg, False, interpret)(key, sharded)
    return _sharded_fn(mesh, cfg, True, interpret)(key, sharded, sp)


_SHARDED_FN_CACHE: dict = {}


def _sharded_fn(mesh: Mesh, cfg: SamplerConfig, has_sp: bool,
                interpret: bool):
    """jit(shard_map(kernel)) cached per (mesh, cfg, signature): a fresh
    shard_map closure per call would retrace the whole sampler every
    batch.  interpret=True runs the kernel in the Pallas interpreter
    inside shard_map, the CPU execution path of this branch
    (tests/test_shard_map_pallas.py)."""
    from miso_jax.sampler.pallas_kernel import run_batch_pallas

    ckey = (mesh, cfg, has_sp, interpret)
    f = _SHARDED_FN_CACHE.get(ckey)
    if f is not None:
        return f
    ev_spec = EventBatch(*([P(EVENT_AXIS)] * len(EventBatch._fields)))
    out_spec = SamplerResult(*([P(EVENT_AXIS)] * len(SamplerResult._fields)))

    def per_shard(k, b, s=None):
        # the shard's first global (event, chain) lane
        offset = jax.lax.axis_index(EVENT_AXIS) * (b.num_iso.shape[0]
                                                   * cfg.chains)
        return run_batch_pallas(k, b, cfg, interpret=interpret,
                                start_psi=s, lane_offset=offset)

    in_specs = (P(), ev_spec) + ((P(EVENT_AXIS),) if has_sp else ())
    f = jax.jit(jax.shard_map(per_shard, mesh=mesh, in_specs=in_specs,
                              out_specs=out_spec, check_vma=False))
    _SHARDED_FN_CACHE[ckey] = f
    return f


def posterior_summary(result: SamplerResult):
    """On-device posterior mean / variance per event (sharded-friendly).

    Replaces the reference's read-back-the-text-files merge
    (misopy/samples_utils.py:263-329) with a device reduction.
    """
    flat = result.psi_samples.reshape(
        result.psi_samples.shape[0], -1, result.psi_samples.shape[-1])
    mean = jnp.mean(flat, axis=1)
    var = jnp.var(flat, axis=1)
    return mean, var
