"""Device-mesh helpers for multi-chip campaigns.

The reference has no distributed backend at all (single process, SIMD
lanes only — SURVEY.md §2). The scaling axis is frame-level data
parallelism: frames are embarrassingly parallel, so the batch axis shards
over every available GPU and only the tiny BER counters are reduced (one
``psum`` per step, carried by NCCL). Every GPU reaches every other at the
same rate, so the mesh is 1-D. Multi-host campaigns use
``jax.distributed.initialize`` + the same mesh.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec

BATCH_AXIS = "frames"


def frame_mesh(devices=None, axis: str = BATCH_AXIS) -> Mesh:
    """1-D mesh over all (or the given) devices, batch axis only."""
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), (axis,))


def batch_sharding(mesh: Mesh, axis: str = BATCH_AXIS) -> NamedSharding:
    """Shard the leading (frame) dimension, replicate the rest."""
    return NamedSharding(mesh, PartitionSpec(axis))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, PartitionSpec())
