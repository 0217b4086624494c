"""Element-sharded decoder: bit-exact vs the local decoder on the
8-device CPU mesh (SURVEY §5 stretch goal, decode side)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import polar_tpu as pt
from polar_tpu.parallel.seqpar import element_mesh
from polar_tpu.parallel.seqpar_decode import make_seqpar_decoder


def _llrs(code, batch, seed):
    rng = np.random.default_rng(seed)
    return jnp.asarray(rng.integers(-128, 128, (batch, code.N)).astype(np.int8))


@pytest.mark.parametrize("m,rate", [(12, 0.5), (12, 0.25), (12, 0.75),
                                    (13, 0.5)])
def test_seqpar_decode_bitexact_vs_local(m, rate):
    """m >= 12 over 8 shards: the top 3 tree levels' f/g/comb run as
    cross-shard ppermute ops; result must equal the local decoder bit for
    bit on random full-range int8 LLRs."""
    code = pt.make_code(m, rate=rate)
    mesh = element_mesh(jax.devices()[:8])
    llr = _llrs(code, 16, m * 100 + int(rate * 100))
    local = jax.jit(pt.make_fastssc_decoder(code, output_dtype=jnp.int8))
    sharded = jax.jit(make_seqpar_decoder(code, mesh, output="u"))
    np.testing.assert_array_equal(
        np.asarray(sharded(llr)).astype(np.int8), np.asarray(local(llr)))


def test_seqpar_decode_u_full_frozen_slots():
    code = pt.make_code(12, rate=0.5)
    mesh = element_mesh(jax.devices()[:8])
    llr = _llrs(code, 8, 5)
    u_full = np.asarray(jax.jit(make_seqpar_decoder(code, mesh))(llr))
    assert u_full.shape == (8, code.N)
    frozen = np.asarray(code.frozen, bool)
    assert np.all(u_full[:, frozen] == 1)


@pytest.mark.parametrize("n_dev", [2, 4])
def test_seqpar_decode_small_meshes(n_dev):
    code = pt.make_code(8, rate=0.5)
    mesh = element_mesh(jax.devices()[:n_dev])
    llr = _llrs(code, 32, n_dev)
    local = jax.jit(pt.make_fastssc_decoder(code, output_dtype=jnp.int8))
    sharded = jax.jit(make_seqpar_decoder(code, mesh, output="u"))
    np.testing.assert_array_equal(
        np.asarray(sharded(llr)).astype(np.int8), np.asarray(local(llr)))


def test_seqpar_decode_qfloat_compute():
    """qfloat-f32 compute (int8 semantics in float) through the sharded
    path stays bit-exact with int8."""
    code = pt.make_code(12, rate=0.5)
    mesh = element_mesh(jax.devices()[:8])
    llr = _llrs(code, 8, 9)
    a = jax.jit(make_seqpar_decoder(code, mesh, output="u"))(llr)
    b = jax.jit(make_seqpar_decoder(code, mesh, output="u",
                                    compute="qfloat-f32"))(llr)
    np.testing.assert_array_equal(
        np.asarray(a).astype(np.int8), np.asarray(b).astype(np.int8))


def test_seqpar_decode_sharded_special_nodes():
    """Crafted mask putting REP and SPC nodes ABOVE the shard level
    (plus rate0_right / rate1_comb fusions at sharded levels): the left
    level-11 subtree is a rep pattern (only its last leaf free), the
    right one an spc pattern (only its first leaf frozen). Bit-exact vs
    the local decoder."""
    m = 12
    n = 1 << m
    mask = np.zeros(n, np.uint8)
    mask[: n // 2] = 1          # left half: all frozen ...
    mask[n // 2 - 1] = 0        # ... except its last leaf -> rep
    mask[n // 2] = 1            # right half: first leaf frozen -> spc
    code = pt.PolarCode(m, mask)
    mesh = element_mesh(jax.devices()[:8])
    llr = _llrs(code, 16, 33)
    local = jax.jit(pt.make_fastssc_decoder(code, output_dtype=jnp.int8))
    sharded = jax.jit(make_seqpar_decoder(code, mesh, output="u"))
    np.testing.assert_array_equal(
        np.asarray(sharded(llr)).astype(np.int8), np.asarray(local(llr)))


def test_seqpar_decode_batch_split_mode():
    """Work-efficient subtree mode (frame batch split over the mesh per
    subtree) must produce identical results to the redundant mode."""
    code = pt.make_code(12, rate=0.5)
    mesh = element_mesh(jax.devices()[:8])
    llr = _llrs(code, 16, 21)  # 16 frames over 8 devices: 2 per device
    a = jax.jit(make_seqpar_decoder(code, mesh, output="u"))(llr)
    b = jax.jit(make_seqpar_decoder(code, mesh, output="u",
                                    batch_split=True))(llr)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_seqpar_decode_validates():
    code = pt.make_code(4, rate=0.5)
    mesh = element_mesh(jax.devices()[:8])
    with pytest.raises(ValueError):
        make_seqpar_decoder(code, mesh)  # shard size 2 < 4
