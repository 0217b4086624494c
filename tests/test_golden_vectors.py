"""Oracle-INDEPENDENT parity suite: frozen golden vectors.

The vectors in ``tests/vectors/golden.npz`` were produced by the reference
implementation (via ``scripts/freeze_vectors.py`` with the reference
checkout mounted) and asserted equal to the framework at freeze time. This module
re-checks the framework against them with **no reference and no C++
compiler required**, making the bit-exactness contract portable
(VERDICT r1 missing-item #4). Regenerate with the script after any
intentional semantic change.

Covers: fixed-K + threshold construction masks, Fast-SSC byte programs,
systematic + non-systematic encoding, int8 decode (incl. -128/-127/127
saturation-edge LLR batches), and float-path decode.
"""

import math
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import polar_tpu as pt

VEC = Path(__file__).resolve().parent / "vectors" / "golden.npz"
pytestmark = pytest.mark.skipif(not VEC.exists(), reason="golden.npz missing")


@pytest.fixture(scope="module")
def vectors():
    with np.load(VEC) as z:
        return dict(z.items())


def _configs(vectors):
    for key in vectors:
        if key.startswith("mask_"):
            _, m, rk = key.split("_")
            yield int(m), int(rk)


def _code(vectors, m, rk):
    return pt.PolarCode(m, vectors[f"mask_{m}_{rk}"])


def test_construction_masks(vectors):
    """make_code reproduces every frozen mask (testbench recipe)."""
    for m, rk in _configs(vectors):
        k = int(rk / 100 * (1 << m))
        code = pt.make_code(m, K=k)
        np.testing.assert_array_equal(
            np.asarray(code.frozen), vectors[f"mask_{m}_{rk}"],
            err_msg=f"mask m={m} rate={rk}%")


def test_threshold_masks(vectors):
    for key, mask in vectors.items():
        if not key.startswith("maskth_"):
            continue
        _, m, pe, th = key.split("_")
        got = pt.frozen_mask_threshold(int(m), float(pe), float(th))
        np.testing.assert_array_equal(got, mask, err_msg=key)


def test_programs(vectors):
    """Byte-program parity (the compiler's reference wire format)."""
    for m, rk in _configs(vectors):
        prog = pt.compile_program(_code(vectors, m, rk))
        np.testing.assert_array_equal(
            np.asarray(prog), vectors[f"prog_{m}_{rk}"],
            err_msg=f"program m={m} rate={rk}%")


def test_encode_parity(vectors):
    for m, rk in _configs(vectors):
        code = _code(vectors, m, rk)
        msg = jnp.asarray(vectors[f"enc_msg_{m}_{rk}"])
        sys = np.asarray(pt.encode_systematic(code, msg))
        non = np.asarray(pt.encode(code, msg))
        np.testing.assert_array_equal(sys, vectors[f"enc_sys_{m}_{rk}"])
        np.testing.assert_array_equal(non, vectors[f"enc_nonsys_{m}_{rk}"])


def test_decode_parity_int8(vectors):
    """Bit-exact int8 decode on the frozen batches, including the
    saturation-edge LLR patterns."""
    for m, rk in _configs(vectors):
        code = _code(vectors, m, rk)
        dec = jax.jit(pt.make_fastssc_decoder(code))
        i = 0
        while f"llr_{m}_{rk}_{i}" in vectors:
            got = np.asarray(dec(jnp.asarray(vectors[f"llr_{m}_{rk}_{i}"])))
            np.testing.assert_array_equal(
                got, vectors[f"dec_{m}_{rk}_{i}"],
                err_msg=f"decode m={m} rate={rk}% batch={i}")
            i += 1
        assert i >= 1


def test_decode_parity_float(vectors):
    for m, rk in _configs(vectors):
        key = f"fllr_{m}_{rk}"
        if key not in vectors:
            continue
        code = _code(vectors, m, rk)
        dec = jax.jit(pt.make_fastssc_decoder(code, compute="float32"))
        got = np.asarray(dec(jnp.asarray(vectors[key])))
        np.testing.assert_array_equal(got, vectors[f"fdec_{m}_{rk}"])
