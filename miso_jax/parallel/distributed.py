"""Multi-host execution: the replacement for the reference's
qsub/SGE cluster layer (misopy/cluster_utils.py:63-300).

The reference scales out by generating bash scripts and polling job IDs;
here every host runs the SAME `miso --run` command with host coordinates,
`jax.distributed.initialize` forms the runtime, and the event catalog
shards over the global device mesh (parallel/mesh.py).  Result merge is
collective (on-device reductions) instead of filesystem re-reads; each
host writes only its shard's `.miso` files, so outputs remain
reference-layout compatible.
"""
from __future__ import annotations

import os
from typing import Optional


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> bool:
    """Initialize the multi-host JAX runtime.  Arguments fall back to the
    MISO_COORDINATOR_ADDRESS / MISO_NUM_HOSTS / MISO_HOST_ID.
    Returns True if a multi-process runtime was formed."""
    import jax

    coordinator_address = coordinator_address or os.environ.get(
        "MISO_COORDINATOR_ADDRESS")
    if num_processes is None:
        env = os.environ.get("MISO_NUM_HOSTS")
        num_processes = int(env) if env else None
    if process_id is None:
        env = os.environ.get("MISO_HOST_ID")
        process_id = int(env) if env else None
    if coordinator_address is None and num_processes is None:
        # single host: nothing to form
        return False
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id)
    return jax.process_count() > 1


def host_shard(items, process_id: Optional[int] = None,
               process_count: Optional[int] = None):
    """Static round-robin shard of a work list for this host.  Each host
    ingests only its own genes' reads (host-side IO parallelism), then
    device-side batches run locally; catalog statistics reduce over the
    global mesh."""
    import jax

    pid = jax.process_index() if process_id is None else process_id
    n = jax.process_count() if process_count is None else process_count
    return [x for i, x in enumerate(items) if i % n == pid]
