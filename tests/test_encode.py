"""Encoder tests: transform properties and bit-exact parity vs reference."""

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


def rand_pm1(rng, shape):
    return (1 - 2 * rng.integers(0, 2, shape)).astype(np.int8)


def test_transform_involution():
    rng = np.random.default_rng(0)
    x = rand_pm1(rng, (7, 64))
    y = np.asarray(pt.polar_transform(pt.polar_transform(jnp.asarray(x))))
    np.testing.assert_array_equal(y, x)


def test_transform_is_xor_butterfly():
    """±1-domain transform == GF(2) transform under the BPSK bit map."""
    rng = np.random.default_rng(1)
    bits = rng.integers(0, 2, (5, 32)).astype(np.uint8)
    x = (1 - 2 * bits).astype(np.int8)
    y = np.asarray(pt.polar_transform(jnp.asarray(x)))
    # direct GF(2) reference: u G where G = F^{\otimes m} (butterfly XOR)
    g = bits.copy()
    h = 1
    n = 32
    while h < n:
        for i in range(0, n, 2 * h):
            for j in range(i, i + h):
                g[:, j] ^= g[:, j + h]
        h *= 2
    np.testing.assert_array_equal((1 - y) // 2, g)


@needs_reference
@pytest.mark.parametrize("m", [2, 4, 6, 8, 10])
@pytest.mark.parametrize("systematic", [False, True])
def test_encode_parity_vs_reference(m, systematic):
    rng = np.random.default_rng(m)
    code = pt.make_code(m, rate=0.5)
    w = oracle.width()
    msg = rand_pm1(rng, (w, code.K))
    ref = oracle.encode(m, code.frozen, msg, systematic=systematic)
    f = pt.encode_systematic if systematic else pt.encode
    ours = np.asarray(f(code, jnp.asarray(msg)))
    np.testing.assert_array_equal(ours, ref)


def test_systematic_property():
    """Info bits appear verbatim at non-frozen codeword positions
    (the assert at ``testbench.cc:143-146``)."""
    rng = np.random.default_rng(3)
    code = pt.make_code(9, rate=0.5)
    msg = rand_pm1(rng, (33, code.K))
    cw = np.asarray(pt.encode_systematic(code, jnp.asarray(msg)))
    np.testing.assert_array_equal(cw[:, code.info_indices], msg)


def test_extract_systematic_roundtrip():
    rng = np.random.default_rng(4)
    code = pt.make_code(7, rate=0.5)
    msg = rand_pm1(rng, (9, code.K))
    cw_sys = pt.encode_systematic(code, jnp.asarray(msg))
    # decoding a noiseless systematic codeword in the u-domain:
    # u = transform(codeword) restricted to info slots
    u = pt.polar_transform(cw_sys)
    got = np.asarray(pt.extract_systematic(code, u[..., code.info_indices]))
    np.testing.assert_array_equal(got, msg)


def test_encode_jit_and_batch_shapes():
    code = pt.make_code(6, rate=0.5)
    rng = np.random.default_rng(5)
    f = jax.jit(lambda m: pt.encode(code, m))
    for batch in [(1,), (4,), (2, 3)]:
        msg = jnp.asarray(rand_pm1(rng, (*batch, code.K)))
        out = f(msg) if batch == (4,) else pt.encode(code, msg)
        assert out.shape == (*batch, code.N)


def test_float_encode():
    code = pt.make_code(5, rate=0.5)
    rng = np.random.default_rng(6)
    msg = rand_pm1(rng, (3, code.K)).astype(np.float32)
    cw = np.asarray(pt.encode_systematic(code, jnp.asarray(msg)))
    assert cw.dtype == np.float32
    np.testing.assert_array_equal(cw[:, code.info_indices], msg)


def test_transform_stage_split_commutes():
    """The butterfly stages are commuting Kronecker factors: top∘bottom
    == bottom∘top == full, for any split point — the property the hybrid
    stage-split encoders rely on (block-local bottom stages + top stages)."""
    from polar_tpu.ops.transform import polar_transform, polar_transform_stages

    rng = np.random.default_rng(3)
    x = jnp.asarray((1 - 2 * rng.integers(0, 2, (5, 256))).astype(np.int8))
    full = polar_transform(x)
    for split in (2, 16, 64, 256):
        bt = polar_transform_stages(
            polar_transform_stages(x, 1, split), split, 256)
        tb = polar_transform_stages(
            polar_transform_stages(x, split, 256), 1, split)
        assert np.array_equal(np.asarray(bt), np.asarray(full))
        assert np.array_equal(np.asarray(tb), np.asarray(full))


def test_transform_axis0_matches_transpose():
    """Element-major transform (axis=0, code axis leading) must equal the
    frame-major transform of the transpose — incl. stage splits (the
    lane-major large-N front path's XLA middle)."""
    from polar_tpu.ops.transform import polar_transform, polar_transform_stages

    rng = np.random.default_rng(9)
    x = jnp.asarray((1 - 2 * rng.integers(0, 2, (7, 128))).astype(np.int8))
    got = polar_transform(x.T, axis=0)
    assert np.array_equal(np.asarray(got).T, np.asarray(polar_transform(x)))
    for lo, hi in ((1, 8), (8, 128), (2, 64)):
        got = polar_transform_stages(x.T, lo, hi, axis=0)
        want = polar_transform_stages(x, lo, hi)
        assert np.array_equal(np.asarray(got).T, np.asarray(want))
