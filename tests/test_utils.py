"""Utility tests: throughput measurement harness, profiling helpers."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import polar_tpu as pt
from polar_tpu.utils.benchmark import measure_decode_fps
from polar_tpu.utils.profiling import annotate, trace


def test_measure_decode_fps_cpu():
    code = pt.make_code(6, rate=0.5)
    dec = pt.make_fastssc_decoder(code, output_dtype=jnp.int8)
    rng = np.random.default_rng(0)
    llrs = jnp.asarray(rng.integers(-128, 128, (512, code.N)).astype(np.int8))
    fps = measure_decode_fps(dec, llrs, iters=16, repeats=1)
    assert fps > 0


def test_measure_decode_fps_unresolvable_raises():
    """A no-op-cheap decode on a tiny batch must grow iters and, if the
    slope never resolves, raise instead of returning garbage."""
    code = pt.make_code(2, rate=0.5)
    dec = pt.make_fastssc_decoder(code, output_dtype=jnp.int8)
    llrs = jnp.ones((4, code.N), jnp.int8)
    try:
        fps = measure_decode_fps(dec, llrs, iters=4, repeats=1, max_iters=8)
        assert fps > 0  # resolving is fine too — just never negative/zero
    except RuntimeError as e:
        assert "not resolvable" in str(e)


def test_measure_decode_fps_on_frame_mesh():
    """The meter works on a frame-DP sharded decoder (global batch over
    the 8-device CPU mesh) and normalizes to per-device frames/s."""
    from polar_tpu.parallel.mesh import batch_sharding, frame_mesh

    code = pt.make_code(6, rate=0.5)
    mesh = frame_mesh(jax.devices()[:8])
    base = pt.make_fastssc_decoder(code, output_dtype=jnp.int8)

    def dec(llrs):
        return base(jax.lax.with_sharding_constraint(
            llrs, batch_sharding(mesh)))

    rng = np.random.default_rng(1)
    llrs = jax.device_put(
        jnp.asarray(rng.integers(-128, 128, (1024, code.N)).astype(np.int8)),
        batch_sharding(mesh),
    )
    per_dev = measure_decode_fps(dec, llrs, iters=8, repeats=2, n_devices=8)
    assert per_dev > 0


def test_trace_contextmanager(tmp_path):
    with trace(str(tmp_path / "t")) as d:
        with annotate("unit-test-block"):
            jnp.arange(8).sum().block_until_ready()
    assert (tmp_path / "t").exists()


def test_measure_step_rate_cpu():
    """End-to-end step meter: chained key-split fori_loop over the full
    Monte-Carlo chain resolves to a positive frames/s figure."""
    from polar_tpu.ber import make_step_body
    from polar_tpu.utils.benchmark import measure_step_rate

    code = pt.make_code(6, rate=0.5)
    body = make_step_body(code, systematic=True)
    rate = measure_step_rate(body, jax.random.PRNGKey(0), 2.0, 256,
                             iters=16, repeats=2, max_iters=64)
    assert rate > 0


def test_op_scopes_maps_fusions_to_named_scopes():
    """Scopes come from each instruction's op_name metadata; a trace's
    kernel names spell the instruction's dots as underscores."""
    from polar_tpu.utils.profiling import op_scopes

    hlo = "\n".join([
        '  %loop_slice_fusion.4 = s8[8,64]{1,0} fusion(%p), kind=kLoop, '
        'metadata={op_name="jit(step)/encode/mul" source_file="x.py"}',
        '  ROOT %input_reduce_fusion = s32[] fusion(%q), kind=kInput, '
        'metadata={op_name="jit(step)/counters/reduce_sum"}',
        '  %copy.1 = s8[8]{0} copy(%r)',
    ])
    got = op_scopes(hlo, ("channel", "encode", "decode", "counters"))
    assert got["loop_slice_fusion.4"] == "encode"
    assert got["loop_slice_fusion_4"] == "encode"
    assert got["input_reduce_fusion"] == "counters"
    assert "copy.1" not in got


def test_busy_and_scopes_union_and_idle():
    from polar_tpu.utils.profiling import busy_and_scopes

    events = [("a", None, 0, 10), ("b", "x.1", 5, 10), ("c", None, 30, 10)]
    res = busy_and_scopes(events, {"a": "encode", "x.1": "decode"})
    assert res["window_ns"] == 40 and res["busy_ns"] == 25
    assert abs(res["idle_share"] - 15 / 40) < 1e-12
    assert res["by_scope_ns"] == {"encode": 10, "decode": 10, "other": 10}
    with pytest.raises(ValueError):
        busy_and_scopes([], {})


def test_step_scopes_reach_compiled_text():
    """The step's named scopes survive into the compiled module's
    metadata, so a trace can be split into layers."""
    from polar_tpu.ber import make_step_body
    from polar_tpu.utils.profiling import op_scopes

    code = pt.make_code(5, rate=0.5)
    step = jax.jit(make_step_body(code), static_argnums=(2,))
    hlo = step.lower(jax.random.PRNGKey(0), 1.0, 64).compile().as_text()
    found = set(op_scopes(hlo, ("channel", "encode", "decode",
                                "counters")).values())
    assert {"encode", "decode", "counters"} <= found
