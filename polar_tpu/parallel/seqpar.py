"""Intra-frame (sequence-parallel) sharded polar transform.

The stretch scaling axis from SURVEY.md §5/§7: for very large N the
codeword's **element axis** shards over the mesh. Butterfly stage h
exchanges elements j ↔ j+h (``polar_encoder.hh:23-26``):

* stages with ``h < shard_size`` never cross shard boundaries (blocks of
  2h align inside a power-of-two shard) — they run locally as the
  ordinary vectorized butterfly;
* stages with ``h >= shard_size`` pair each shard with the shard
  ``h/S`` positions away — one ``ppermute`` per stage pulls the partner
  shard (NVLink between GPUs), and a role mask (lower half of each 2h-block
  multiplies, upper half passes through) applies the update.

This is the ring-attention analog for this workload: log2(D) neighbor
exchanges instead of any gather. The SC **decoder** is deliberately NOT
sharded intra-frame: below the shard-size level the pruned tree is
decoded sequentially node-by-node, so element sharding would serialize
devices; frames (the batch axis) remain the decoder's scaling dimension
(SURVEY.md §2 parallelism inventory).

All functions here are meant to run inside ``jax.shard_map`` with the
element axis mapped to a mesh axis; :func:`make_sharded_encoder` wraps
that up.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..code.construction import PolarCode
from ..ops.transform import polar_transform

SEQ_AXIS = "seq"


def element_mesh(devices=None, axis: str = SEQ_AXIS) -> Mesh:
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), (axis,))


def _sharded_transform_local(x, axis: str, n_shards: int):
    """Per-shard body: x is (..., S) — this device's contiguous slice of a
    (..., N = n_shards * S) array. Must run under shard_map."""
    # stages h = 1 .. S/2: fully local
    x = polar_transform(x)
    # stages h = S, 2S, ... N/2: one ppermute per stage
    d = jax.lax.axis_index(axis)
    h_shards = 1
    while h_shards < n_shards:
        # receive the shard h_shards positions ahead (source d + h, wraps
        # harmlessly: wrapped receivers are "upper"-role and masked out)
        perm = [(i, (i - h_shards) % n_shards) for i in range(n_shards)]
        partner = jax.lax.ppermute(x, axis, perm)
        is_lower = (d // h_shards) % 2 == 0
        x = jnp.where(is_lower, x * partner, x)
        h_shards *= 2
    return x


def make_sharded_transform(mesh: Mesh, axis: str = SEQ_AXIS):
    """Build transform(x): (..., N) sharded on the last axis over `axis`.

    Output sharding equals input sharding; only log2(n_shards) neighbor
    ppermutes of one shard each cross the interconnect.
    """
    n_shards = mesh.shape[axis]

    def transform(x):
        fn = jax.shard_map(
            lambda v: _sharded_transform_local(v, axis, n_shards),
            mesh=mesh,
            in_specs=P(*([None] * (x.ndim - 1) + [axis])),
            out_specs=P(*([None] * (x.ndim - 1) + [axis])),
        )
        return fn(x)

    return transform


def make_sharded_encoder(code: PolarCode, mesh: Mesh, axis: str = SEQ_AXIS,
                         systematic: bool = True):
    """Element-sharded encoder for huge N: message (..., K) replicated in,
    codeword (..., N) sharded out.

    The scatter and re-freeze are elementwise in the sharded domain; the
    two transforms are :func:`make_sharded_transform`. Mirrors
    ``polar_encoder.hh:30-59``.
    """
    n_shards = mesh.shape[axis]
    if code.N % n_shards:
        raise ValueError(f"N={code.N} not divisible by {n_shards} shards")
    transform = make_sharded_transform(mesh, axis)
    frozen = np.asarray(code.frozen, dtype=bool)
    info_positions = np.flatnonzero(~frozen)
    # scatter map: u[j] = message[scatter_idx[j]] for info slots
    scatter_idx = np.zeros(code.N, dtype=np.int32)
    scatter_idx[info_positions] = np.arange(code.K, dtype=np.int32)

    def encode(message):
        lead = message.shape[:-1]
        u = jnp.where(
            jnp.asarray(frozen),
            jnp.asarray(1, message.dtype),
            message[..., jnp.asarray(scatter_idx)],
        )
        u = jnp.broadcast_to(u, (*lead, code.N))
        x = transform(u)
        if systematic:
            x = jnp.where(jnp.asarray(frozen), jnp.asarray(1, x.dtype), x)
            x = transform(x)
        return x

    return encode
