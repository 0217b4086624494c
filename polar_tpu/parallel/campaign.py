"""Sharded Monte-Carlo BER campaign: frames over the mesh, psum counters.

This is the distributed-communication layer the reference lacks
(SURVEY.md §5 "Distributed communication backend"): the Monte-Carlo step
body runs per-shard under ``jax.shard_map`` with an independent PRNG key
per device, and the five diagnostic counters are reduced with ``psum``
over the frame axis — the only cross-device traffic, a few dozen bytes per
step. Scaling efficiency is therefore ~linear by construction; the
decode itself never communicates (frames are independent, exactly like
the reference's SIMD lanes).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..ber import make_step_body
from ..code.construction import PolarCode
from .mesh import BATCH_AXIS, frame_mesh


def make_sharded_step(
    code: PolarCode,
    mesh: Mesh | None = None,
    *,
    axis: str = BATCH_AXIS,
    systematic: bool = True,
    dtype=jnp.int8,
    decoder=None,
):
    """Build the multi-chip Monte-Carlo step.

    Returns ``(step, mesh)`` where ``step(keys, snr_db, per_device_batch)``
    takes one PRNG key per device (shape ``(n_devices, 2)`` uint32,
    sharded over ``axis``) and returns globally-psum-reduced counters
    (replicated scalars). ``per_device_batch`` frames are processed on
    every device, so the global batch is ``n_devices * per_device_batch``.
    Each shard runs :func:`polar_tpu.ber.make_step_body` with its own key.
    """
    if mesh is None:
        mesh = frame_mesh(axis=axis)
    body = make_step_body(code, systematic=systematic, dtype=dtype,
                          decoder=decoder)

    def shard_fn(keys, snr_db, per_device_batch: int):
        out = body(keys[0], snr_db, per_device_batch)
        return {k: jax.lax.psum(v, axis) for k, v in out.items()}

    def step(keys, snr_db, per_device_batch: int):
        sharded = jax.shard_map(
            lambda k, s: shard_fn(k, s, per_device_batch),
            mesh=mesh,
            in_specs=(P(axis), P()),
            out_specs=P(),
        )
        return sharded(keys, jnp.float32(snr_db))

    return jax.jit(step, static_argnums=(2,)), mesh


def device_keys(key, mesh: Mesh, axis: str = BATCH_AXIS):
    """Split a key into one per device, laid out along the mesh axis."""
    n = mesh.shape[axis]
    keys = jax.random.split(key, n)
    sharding = jax.NamedSharding(mesh, P(axis))
    return jax.device_put(jax.random.key_data(keys), sharding)


def global_llr_batch(code, mesh: Mesh | None = None, *, axis: str = BATCH_AXIS,
                     per_device_batch: int = 4096, seed: int = 42):
    """Random full-range int8 LLRs ``(n_devices * per_device_batch, N)``,
    sharded on the frame axis, built from **process-local** data: every
    host draws only the rows its addressable devices own (its own PRNG
    stream, ``seed + process_index``) — no host ever materializes the
    global batch, so this works identically on single-process meshes and
    multi-process pods (``jax.make_array_from_process_local_data``)."""
    import numpy as np

    if mesh is None:
        mesh = frame_mesh(axis=axis)
    sharding = jax.NamedSharding(mesh, P(axis))
    b_global = mesh.devices.size * per_device_batch
    n_local_dev = sum(d.process_index == jax.process_index()
                      for d in mesh.devices.flat)
    rng = np.random.default_rng(seed + jax.process_index())
    local = rng.integers(-128, 128,
                         (n_local_dev * per_device_batch, code.N)).astype(np.int8)
    return jax.make_array_from_process_local_data(
        sharding, local, (b_global, code.N))


def measure_sharded_decode_fps(code, mesh: Mesh | None = None, *,
                               axis: str = BATCH_AXIS,
                               per_device_batch: int = 4096,
                               decoder=None, dtype=jnp.int8, seed: int = 42,
                               **kw):
    """Frame-DP decode throughput over a (possibly multi-process) mesh,
    in **frames/s per device** — the cross-hardware comparable number.

    The decoder is elementwise along the frame axis, so jitting it with
    the frame-sharded global batch runs one SPMD program with zero
    decode-time communication (the checksum reduction in the meter's
    runner is the only collective). The chained-slope meter's adaptive
    control flow is lead-host-synchronized (see
    :func:`polar_tpu.utils.benchmark.measure_decode_fps`), so every host
    returns the same figure."""
    from ..decode.auto import make_auto_decoder
    from ..utils.benchmark import measure_decode_fps

    if mesh is None:
        mesh = frame_mesh(axis=axis)
    if decoder is None:
        # the decoder make_auto_decoder picks for this platform
        decoder, _ = make_auto_decoder(code, output_dtype=dtype)
    llrs = global_llr_batch(code, mesh, axis=axis,
                            per_device_batch=per_device_batch, seed=seed)
    return measure_decode_fps(decoder, llrs, n_devices=mesh.devices.size, **kw)


def run_sharded_point(
    code: PolarCode,
    snr_db: float,
    *,
    key,
    step=None,
    mesh: Mesh | None = None,
    per_device_batch: int = 4096,
    max_global_frames: int = 1 << 20,
    target_bit_errors: int = 1000,
    systematic: bool = True,
    dtype=jnp.int8,
):
    """Multi-chip analog of :func:`polar_tpu.ber.run_point`: loops sharded
    steps until the error target or frame budget is met; returns the
    counter totals plus the global frame count."""
    if step is None:
        step, mesh = make_sharded_step(code, mesh, systematic=systematic,
                                       dtype=dtype)
    assert mesh is not None
    n_dev = mesh.devices.size
    totals: dict = {}
    frames = 0
    while (frames < max_global_frames
           and totals.get("uncorrected_errors", 0) < target_bit_errors):
        key, sub = jax.random.split(key)
        out = jax.device_get(step(device_keys(sub, mesh), snr_db,
                                  per_device_batch))
        frames += per_device_batch * n_dev
        for k, v in out.items():
            totals[k] = totals.get(k, 0) + int(v)
    totals["frames"] = frames
    return totals
