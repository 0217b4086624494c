"""Decoder tests: noiseless round-trips, SC ≡ Fast-SSC equivalence, and
bit-exact int8 parity against the reference decoder."""

import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import polar_tpu as pt
import oracle

# oracle-backed parity needs the read-only reference checkout; without it
# the frozen golden vectors (test_golden_vectors.py) carry the contract.
# Only the tests that call the oracle skip; the property tests always run.
needs_reference = pytest.mark.skipif(
    not oracle.have_reference(), reason="reference checkout not mounted"
)


def rand_pm1(rng, shape, dtype=np.int8):
    return (1 - 2 * rng.integers(0, 2, shape)).astype(dtype)


@pytest.mark.parametrize("m", [2, 4, 6, 8])
@pytest.mark.parametrize("decoder", ["sc", "fastssc"])
def test_noiseless_roundtrip_int8(m, decoder):
    rng = np.random.default_rng(m)
    code = pt.make_code(m, rate=0.5)
    make = pt.make_sc_decoder if decoder == "sc" else pt.make_fastssc_decoder
    dec = jax.jit(make(code))
    msg = rand_pm1(rng, (8, code.K))
    cw = pt.encode_systematic(code, jnp.asarray(msg))
    llr = (cw.astype(jnp.int32) * 96).astype(jnp.int8)
    u = dec(llr)
    got = np.asarray(pt.extract_systematic(code, u))
    np.testing.assert_array_equal(got, msg)


@pytest.mark.parametrize("m", [3, 5, 7, 9])
def test_sc_equals_fastssc_float(m):
    """Fast-SSC pruning is decision-equivalent to full min-sum SC
    (Sarkis et al. 2013) — exact in float where no ties occur."""
    rng = np.random.default_rng(m + 100)
    code = pt.make_code(m, rate=0.5)
    llr = jnp.asarray(rng.normal(size=(64, code.N)).astype(np.float32) * 3)
    u_sc = np.asarray(jax.jit(pt.make_sc_decoder(code))(llr))
    u_fast = np.asarray(jax.jit(pt.make_fastssc_decoder(code))(llr))
    # tie-freedom witness: a zero output would make the sign comparison
    # vacuous/flaky — fail loudly instead if a seed ever produces one
    assert np.all(u_sc != 0) and np.all(u_fast != 0)
    np.testing.assert_array_equal(np.sign(u_sc), np.sign(u_fast))


@needs_reference
@pytest.mark.parametrize("m", [3, 5, 8, 10])
def test_decode_float_parity_vs_reference(m):
    """Float-path parity: FloatArith min-sum decode vs the reference's
    ``typedef float code_type`` ablation (``testbench.cc:49-53``,
    ``polar_helper.hh:63-111`` via SIMD<float,WF>) — bit-exact on random
    normal LLRs (all ops are exact or identically-ordered roundings)."""
    rng = np.random.default_rng(m + 31)
    code = pt.make_code(m, rate=0.5)
    w = oracle.widthf()
    dec = jax.jit(pt.make_fastssc_decoder(code, compute="float32"))
    for _ in range(2):
        llr = (rng.normal(size=(w, code.N)) * 8).astype(np.float32)
        ref = oracle.decode_float(m, code.frozen, llr)
        ours = np.asarray(dec(jnp.asarray(llr)))
        np.testing.assert_array_equal(ours, ref)


@needs_reference
@pytest.mark.parametrize("m", [2, 3, 4, 5, 6, 8, 10])
def test_decode_parity_vs_reference_random_llrs(m):
    """Bit-exact int8 parity with the reference SIMD decoder on random
    full-range LLRs (including the -128/-127 saturation edges)."""
    rng = np.random.default_rng(m + 7)
    code = pt.make_code(m, rate=0.5)
    w = oracle.width()
    dec = jax.jit(pt.make_fastssc_decoder(code))
    for _ in range(3):
        llr = rng.integers(-128, 128, (w, code.N)).astype(np.int8)
        ref = oracle.decode(m, code.frozen, llr)
        ours = np.asarray(dec(jnp.asarray(llr)))
        np.testing.assert_array_equal(ours, ref)


@needs_reference
@pytest.mark.parametrize("rate", [0.25, 0.75])
def test_decode_parity_other_rates(rate):
    m = 7
    rng = np.random.default_rng(int(rate * 100))
    code = pt.make_code(m, K=int(rate * (1 << m)))
    w = oracle.width()
    dec = jax.jit(pt.make_fastssc_decoder(code))
    llr = rng.integers(-128, 128, (w, code.N)).astype(np.int8)
    ref = oracle.decode(m, code.frozen, llr)
    np.testing.assert_array_equal(np.asarray(dec(jnp.asarray(llr))), ref)


@needs_reference
def test_decode_parity_noisy_chain(monkeypatch):
    """End-to-end: encode, add real AWGN, quantize, decode — our decoder and
    the reference must agree bit-exactly on the identical noisy input."""
    m, snr_db = 6, 0.0
    rng = np.random.default_rng(42)
    code = pt.make_code(m, rate=0.5)
    w = oracle.width()
    msg = rand_pm1(rng, (w, code.K))
    cw = np.asarray(pt.encode_systematic(code, jnp.asarray(msg)))
    sigma = pt.noise_sigma(snr_db)
    y = cw + sigma * rng.normal(size=cw.shape)
    llr = np.clip(np.rint(2.0 / sigma**2 * y), -128, 127).astype(np.int8)
    ref = oracle.decode(m, code.frozen, llr)
    ours = np.asarray(jax.jit(pt.make_fastssc_decoder(code))(jnp.asarray(llr)))
    np.testing.assert_array_equal(ours, ref)


def test_decoder_batch_polymorphism():
    code = pt.make_code(5, rate=0.5)
    rng = np.random.default_rng(9)
    dec = pt.make_fastssc_decoder(code)
    llr3 = jnp.asarray(rng.integers(-100, 100, (2, 3, code.N)).astype(np.int8))
    out = dec(llr3)
    assert out.shape == (2, 3, code.K)
    flat = dec(llr3.reshape(6, code.N))
    np.testing.assert_array_equal(np.asarray(out).reshape(6, code.K), np.asarray(flat))


def test_float32_decoder_corrects_errors():
    rng = np.random.default_rng(11)
    code = pt.make_code(8, rate=0.5)
    msg = rand_pm1(rng, (32, code.K), np.float32)
    cw = pt.encode_systematic(code, jnp.asarray(msg))
    sigma = pt.noise_sigma(3.0)
    y = np.asarray(cw) + sigma * rng.normal(size=cw.shape).astype(np.float32)
    llr = jnp.asarray(2.0 / sigma**2 * y, dtype=jnp.float32)
    u = jax.jit(pt.make_fastssc_decoder(code))(llr)
    got = np.sign(np.asarray(pt.extract_systematic(code, u)))
    assert (got != msg).mean() < 0.01


def test_systematic_encode_via_decoder_ablation():
    """The testbench's alternate systematic path (testbench.cc:134-141):
    scatter the message into codeword positions (0 at frozen), decode that
    as unit-magnitude LLRs, re-encode — must equal encode_systematic."""
    rng = np.random.default_rng(77)
    code = pt.make_code(7, rate=0.5)
    msg = rand_pm1(rng, (16, code.K))
    scattered = jnp.zeros((16, code.N), jnp.int8)
    scattered = scattered.at[..., code.info_indices].set(jnp.asarray(msg))
    u = jax.jit(pt.make_fastssc_decoder(code))(scattered)
    via_decoder = np.asarray(pt.encode(code, u))
    direct = np.asarray(pt.encode_systematic(code, jnp.asarray(msg)))
    np.testing.assert_array_equal(via_decoder, direct)


def test_threshold_code_campaign_roundtrip():
    code = pt.make_code_threshold(6, 0.5, 0.5)
    assert 0 < code.K < code.N
    rng = np.random.default_rng(3)
    msg = rand_pm1(rng, (8, code.K))
    cw = pt.encode_systematic(code, jnp.asarray(msg))
    llr = (cw.astype(jnp.int32) * 96).astype(jnp.int8)
    u = jax.jit(pt.make_fastssc_decoder(code))(llr)
    np.testing.assert_array_equal(
        np.asarray(pt.extract_systematic(code, u)), msg
    )
