"""Device mesh + sharding helpers.

The framework's scaling model (SURVEY.md section 2.4): everything
shards over *data* — sample directions, pixels, materials — with
replicated parameters (they're a handful of scalars plus small
tables), plus one TP-style row-sharded matvec for the anisotropic
power iteration. Collectives are XLA-inserted from shardings (psum of
gradient/integral partials) or written as ``shard_map`` collectives
(the power iteration's all_gather); XLA hands them to NCCL on GPUs.
One 1-D axis is the right mesh for cards joined all to all (NVLink):
every pair of devices talks at the same rate, so the mesh follows the
algorithm alone.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "data"


def make_mesh(n_devices: int | None = None, axis_name: str = DATA_AXIS) -> Mesh:
    """1-D mesh over the first n devices (default: all)."""
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (axis_name,))


def data_sharding(mesh: Mesh, axis_name: str = DATA_AXIS) -> NamedSharding:
    """Shard the leading (batch) dimension across the mesh."""
    return NamedSharding(mesh, P(axis_name))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> None:
    """Multi-process bring-up: call once per process before any jax
    use. Thin wrapper over ``jax.distributed.initialize``; pass the
    coordinator address (``host:port``), the process count and this
    process's id explicitly where no cluster manager provides them.
    Afterwards :func:`make_mesh` spans every process's devices."""
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)
