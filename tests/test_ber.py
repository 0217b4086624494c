"""BER harness tests: counters, waterfall behavior, reproducibility."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import polar_tpu as pt


CODE = pt.make_code(6, rate=0.5)  # small code keeps CPU compiles fast


def test_step_counters_clean_channel():
    step = pt.make_step(CODE, systematic=True)
    out = step(jax.random.PRNGKey(0), 20.0, 128)
    assert int(out["uncorrected_errors"]) == 0
    assert int(out["frame_errors"]) == 0
    assert int(out["ambiguity_erasures"]) == 0


def test_step_counters_noisy_channel():
    step = pt.make_step(CODE, systematic=True)
    out = step(jax.random.PRNGKey(0), -3.0, 256)
    assert int(out["awgn_errors"]) > 0
    assert int(out["uncorrected_errors"]) > 0


def test_run_point_reproducible():
    a = pt.run_point(CODE, 1.0, key=jax.random.PRNGKey(3), batch=256,
                     max_frames=512)
    b = pt.run_point(CODE, 1.0, key=jax.random.PRNGKey(3), batch=256,
                     max_frames=512)
    assert a.bit_errors == b.bit_errors
    assert a.ber == b.ber


def test_ber_decreases_with_snr():
    step = pt.make_step(CODE, systematic=True)
    bers = []
    for snr in (-4.0, 0.0, 6.0):
        p = pt.run_point(CODE, snr, key=jax.random.PRNGKey(1), step=step,
                         batch=512, max_frames=1024)
        bers.append(p.ber)
    assert bers[0] > bers[1] > bers[2] or (bers[1] > bers[2] == 0.0)
    assert bers[2] == 0.0


def test_campaign_early_stop_and_table():
    res = pt.run_campaign(
        CODE, batch=256, max_frames_per_point=512, target_bit_errors=100,
        snr_range=(3.0, 12.0), snr_step=1.0, stop_after_clean=2,
        measure_throughput=False,
    )
    assert res.qef_snr_db < 12.0
    assert len(res.points) >= 2
    assert res.points[-1].bit_errors == 0
    table = res.table()
    assert len(table.splitlines()) == len(res.points)


def test_nonsystematic_step():
    step = pt.make_step(CODE, systematic=False)
    out = step(jax.random.PRNGKey(5), 20.0, 64)
    assert int(out["uncorrected_errors"]) == 0


def test_multi_step_equals_unrolled_single_steps():
    """make_multi_step's on-device chain must produce exactly the totals
    of the equivalent host-side split/step sequence."""
    from polar_tpu.ber import make_multi_step

    multi = make_multi_step(CODE, systematic=True)
    single = pt.make_step(CODE, systematic=True)
    key = jax.random.PRNGKey(77)
    got = {k: int(v) for k, v in
           jax.device_get(multi(key, 1.0, 128, 3)).items()}
    ref = {}
    k = key
    for _ in range(3):
        k, sub = jax.random.split(k)
        out = jax.device_get(single(sub, 1.0, 128))
        for name, v in out.items():
            ref[name] = ref.get(name, 0) + int(v)
    assert got == ref


def test_campaign_steps_per_call():
    res = pt.run_campaign(
        CODE, batch=128, max_frames_per_point=512, target_bit_errors=100,
        snr_range=(4.0, 12.0), snr_step=2.0, stop_after_clean=2,
        measure_throughput=False, steps_per_call=2,
    )
    assert res.points and res.points[-1].bit_errors == 0
    assert all(p.frames % 256 == 0 for p in res.points)


def test_step_uses_pinned_decoder():
    """A decoder passed to make_step is the one the step runs: a decoder
    that always answers the all-(+1) message counts exactly the -1 bits
    of the drawn messages as errors."""
    seen = []

    def all_plus(llrs):
        seen.append(llrs.shape)
        return jnp.ones((llrs.shape[0], CODE.K), jnp.int8)

    step = pt.make_step(CODE, systematic=True, decoder=all_plus)
    out = jax.device_get(step(jax.random.PRNGKey(4), 20.0, 64))
    assert seen == [(64, CODE.N)]
    assert 0 < int(out["uncorrected_errors"]) < 64 * CODE.K
    assert int(out["ambiguity_erasures"]) == 0


def test_step_counters_equal_plain_chain():
    """The step's five counters equal the same chain written out with the
    public pieces (threefry bits → encode → AWGN → XLA decode)."""
    key = jax.random.PRNGKey(11)
    snr, batch = 0.5, 128
    got = {k: int(v) for k, v in
           jax.device_get(pt.make_step(CODE)(key, snr, batch)).items()}
    kmsg, knoise = jax.random.split(key)
    bits = jax.random.bernoulli(kmsg, 0.5, (batch, CODE.K))
    msg = jnp.where(bits, jnp.int8(-1), jnp.int8(1))
    cw = pt.encode_systematic(CODE, msg)
    llr = pt.awgn_llrs(knoise, cw, snr)
    dec = pt.make_fastssc_decoder(CODE, output="systematic",
                                  output_dtype=jnp.int8)(llr)
    m, d, c, l = (np.asarray(a).astype(np.int32) for a in (msg, dec, cw, llr))
    errs = (d * m) <= 0
    want = {
        "uncorrected_errors": int(errs.sum()),
        "frame_errors": int(errs.any(axis=1).sum()),
        "ambiguity_erasures": int((d == 0).sum()),
        "awgn_errors": int(((l * c) < 0).sum()),
        "quantization_erasures": int((l == 0).sum()),
    }
    assert got == want


@pytest.mark.parametrize("systematic", [True, False])
def test_qfloat_step_equals_int8_step(systematic):
    """compute="qfloat-f32" carries int8 semantics in float: the step's
    counters are identical to the int8 step's on the same key."""
    key = jax.random.PRNGKey(21)
    a = jax.device_get(pt.make_step(CODE, systematic=systematic)(
        key, 1.0, 128))
    b = jax.device_get(pt.make_step(CODE, systematic=systematic,
                                    compute="qfloat-f32")(key, 1.0, 128))
    assert {k: int(v) for k, v in a.items()} == \
        {k: int(v) for k, v in b.items()}


def test_default_decoder_cpu_is_xla_output_shape():
    from polar_tpu.ber import default_decoder

    for systematic in (True, False):
        dec = default_decoder(CODE, systematic=systematic)
        llr = jnp.zeros((8, CODE.N), jnp.int8)
        assert jax.jit(dec)(llr).shape == (8, CODE.K)


def test_campaign_without_throughput_gauge_cpu():
    """Without the decode-only gauge every point reports 0 Mb/s."""
    res = pt.run_campaign(
        CODE, batch=128, max_frames_per_point=256, target_bit_errors=50,
        snr_range=(6.0, 12.0), snr_step=3.0, stop_after_clean=2,
        measure_throughput=False,
    )
    assert res.points and res.points[-1].bit_errors == 0
    assert all(p.info_bits_per_sec == 0.0 for p in res.points)


def test_multi_step_overflow_guard_uses_channel_bit_domain():
    """The int32 guard must bound the N-domain diagnostics (awgn/quant
    count all channel bits), not just the K info bits."""
    import pytest

    multi = pt.ber.make_multi_step(CODE, systematic=True)
    steps = (1 << 31) // (128 * CODE.N) + 1
    with pytest.raises(AssertionError):
        multi(jax.random.PRNGKey(0), 1.0, 128, steps)
