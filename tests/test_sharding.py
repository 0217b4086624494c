"""Multi-device sharding tests on the virtual 8-device CPU mesh.

The analog of the reference's QEMU cross-arch testing (its
``Makefile:6-19``): validate the multi-GPU campaign path without real
multi-GPU hardware.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import polar_tpu as pt
from polar_tpu.parallel.campaign import (
    device_keys,
    make_sharded_step,
    run_sharded_point,
)
from polar_tpu.parallel.mesh import frame_mesh

CODE = pt.make_code(6, rate=0.5)


def test_mesh_has_8_devices():
    mesh = frame_mesh()
    assert mesh.devices.size == 8


def test_sharded_step_counters_match_expectation():
    step, mesh = make_sharded_step(CODE)
    keys = device_keys(jax.random.PRNGKey(0), mesh)
    out = step(keys, 20.0, 64)
    # clean channel: zero errors across all 8 shards
    assert int(out["uncorrected_errors"]) == 0
    out = step(keys, -3.0, 64)
    assert int(out["uncorrected_errors"]) > 0


def test_sharded_equals_sum_of_independent_shards():
    """psum totals == the sum of running the same per-shard keys alone."""
    step, mesh = make_sharded_step(CODE)
    key = jax.random.PRNGKey(7)
    keys = device_keys(key, mesh)
    out = jax.device_get(step(keys, 0.0, 32))

    body = pt.make_step(CODE)
    key_arr = jax.random.split(key, mesh.devices.size)
    total = 0
    for k in key_arr:
        total += int(body(k, 0.0, 32)["uncorrected_errors"])
    assert int(out["uncorrected_errors"]) == total


def test_run_sharded_point():
    totals = run_sharded_point(
        CODE, 0.0, key=jax.random.PRNGKey(1), per_device_batch=64,
        max_global_frames=2048, target_bit_errors=50,
    )
    assert totals["frames"] % (64 * 8) == 0
    assert totals["uncorrected_errors"] >= 0


def test_sharded_point_reproducible():
    a = run_sharded_point(CODE, 1.0, key=jax.random.PRNGKey(3),
                          per_device_batch=32, max_global_frames=512)
    b = run_sharded_point(CODE, 1.0, key=jax.random.PRNGKey(3),
                          per_device_batch=32, max_global_frames=512)
    assert a == b


def test_measure_sharded_decode_fps_single_process():
    """The frame-DP throughput meter on the 8-device mesh: per-host LLR
    construction (process-local path degenerates to the whole batch in
    single-process), SPMD decode, positive per-device figure."""
    from polar_tpu.parallel.campaign import (
        global_llr_batch, measure_sharded_decode_fps)

    mesh = frame_mesh()
    llrs = global_llr_batch(CODE, mesh, per_device_batch=16)
    assert llrs.shape == (8 * 16, CODE.N) and llrs.dtype == jnp.int8
    fps = measure_sharded_decode_fps(
        CODE, mesh, per_device_batch=16, iters=16, repeats=2, max_iters=64)
    assert fps > 0
