"""Multi-host (multi-process) runtime support.

The reference is strictly single-node (SURVEY.md §2.3); BASELINE.md's scaling
points ask for N >= 2 hosts with genome-sharded state. This module carries
the process-level plumbing that turns the explicit shard_map SPMD step
(parallel/mesh.py) into a multi-host program:

  * ``init_from_env`` joins the JAX distributed runtime from environment
    variables, after which ``jax.devices()`` is the GLOBAL device list and a
    Mesh built over it spans all hosts. The coordinator address, process
    count and process id are always given explicitly.
  * every process runs the same host program (same config, same seed, same
    batch order — the standard SPMD single-program contract); arrays the
    step consumes are created with process-local data only for the shards
    the process can address (``shard_put`` / ``replicate``).
  * ``fetch`` is the one way host code reads a global array: addressable
    arrays convert directly, cross-host ones are all-gathered (the strategy
    mask is genome/100-sized, so this stays small).
  * file outputs (masks npz, metrics, checkpoints) happen on the primary
    process only — ``is_primary`` gates them in the drivers.

This is a leaf module: no imports from the rest of the package (models/
parallel both import it).
"""
from __future__ import annotations

import logging
import os

import numpy as np

logger = logging.getLogger("bossruns")

_initialized = False

ENV_COORD = "BOSS_COORDINATOR"
ENV_NPROC = "BOSS_NUM_PROCESSES"
ENV_PID = "BOSS_PROCESS_ID"


def init_from_env() -> bool:
    """Join the distributed runtime if BOSS_COORDINATOR/… are set.

    BOSS_COORDINATOR=host:port BOSS_NUM_PROCESSES=N BOSS_PROCESS_ID=i
    launches one engine process per host; unset means single-process (the
    common case) and this is a no-op. Returns True when multi-process.
    Must run before the first jax.devices() / first computation.
    """
    global _initialized
    coord = os.environ.get(ENV_COORD)
    if not coord:
        return False
    if _initialized:
        return True
    import jax

    nproc = int(os.environ[ENV_NPROC])
    pid = int(os.environ[ENV_PID])
    jax.distributed.initialize(
        coordinator_address=coord, num_processes=nproc, process_id=pid
    )
    _initialized = True
    logger.info(
        f"distributed runtime up: process {pid}/{nproc}, "
        f"{jax.local_device_count()} local / {jax.device_count()} global devices"
    )
    return True


def process_index() -> int:
    import jax

    return jax.process_index()


def is_primary() -> bool:
    """True on the process that owns shared-filesystem writes (masks npz,
    metrics, checkpoints, read dumps). Avoids importing jax when the process
    is plainly single (env unset, jax not loaded) — e.g. the readfish-side
    host tools."""
    if ENV_COORD in os.environ:
        return int(os.environ.get(ENV_PID, "0")) == 0
    import sys

    if "jax" in sys.modules:
        import jax

        return jax.process_index() == 0
    return True


def fetch(x) -> np.ndarray:
    """Global jax array -> host numpy, regardless of process topology.

    Fully-addressable (single-process) and fully-replicated arrays convert
    directly; genome-sharded arrays in a multi-process run are tiled
    all-gathers (every process receives the full array — callers gate file
    writes on is_primary, not on who holds the data).
    """
    if getattr(x, "is_fully_addressable", True) or getattr(
        x, "is_fully_replicated", False
    ):
        return np.asarray(x)
    from jax.experimental import multihost_utils

    return np.asarray(multihost_utils.process_allgather(x, tiled=True))


def shard_put(x: np.ndarray, sharding):
    """Host array -> global array with `sharding`, materialising only the
    addressable shards on each process (device_put of host data onto a
    cross-process sharding is not generally supported; the callback form is).
    """
    import jax

    x = np.asarray(x)
    return jax.make_array_from_callback(x.shape, sharding, lambda idx: x[idx])


def replicate(tree, mesh):
    """Replicate a pytree of host arrays onto every device of `mesh`.

    All processes must pass identical values (they compute them from the
    same inputs — the SPMD contract); each process materialises its local
    copies only.
    """
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    rep = NamedSharding(mesh, P())

    def put(x):
        return shard_put(np.asarray(x), rep)

    return jax.tree_util.tree_map(put, tree)
