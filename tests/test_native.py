"""Native C extension parity tests.

A module fixture compiles ``csrc/polar_native.c`` into ``build/`` (the
checkout's ignored build directory) and loads it before the tests run.
"""

import math

import numpy as np
import pytest

import polar_tpu as pt
from polar_tpu.code import native



@pytest.fixture(scope="module", autouse=True)
def built_native():
    return native.build_native()


@pytest.mark.parametrize("m", [1, 4, 8, 12, 16])
def test_native_fixed_k_matches_numpy(m):
    k = (1 << m) // 2
    a = native.frozen_mask_fixed_k(m, k, math.exp(-1))
    b = pt.frozen_mask_fixed_k(m, k, math.exp(-1))
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("m", [3, 8, 12])
@pytest.mark.parametrize("pe,th", [(0.5, 0.5), (0.3, 1e-7)])
def test_native_threshold_matches_numpy(m, pe, th):
    a = native.frozen_mask_threshold(m, pe, th)
    b = pt.frozen_mask_threshold(m, pe, th)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("m", [2, 6, 10, 14])
def test_native_program_matches_numpy(m):
    for rate in (0.25, 0.5, 0.75):
        mask = native.frozen_mask_fixed_k(m, int(rate * (1 << m)), math.exp(-1))
        a = native.compile_program(mask, m)
        b = pt.compile_program(pt.PolarCode(m, mask))
        np.testing.assert_array_equal(a, b)


def test_native_logpe_matches_numpy():
    for m in (4, 10, 15):
        a = native.bhattacharyya_logpe(m, 0.37)
        b = pt.bhattacharyya_logpe(m, 0.37)
        np.testing.assert_allclose(a, b, rtol=1e-11, atol=1e-12)


@pytest.mark.parametrize("pe", [1e-9, 0.01, 0.2, 0.5, 0.80, 1 - 1e-9])
@pytest.mark.parametrize("m", [1, 6, 12, 18])
def test_native_dual_matches_numpy_where_it_matters(m, pe):
    """The C evolution uses the numpy implementation's exact formulas and
    branch point; residual diffs are last-ulp differences between numpy's
    SIMD exp/log1p and glibc's (measured ~1e-16 per op, amplified only in
    the zone where that domain is NOT the ranking key). Assert agreement
    in each domain's authoritative zone:

    * lp everywhere (relative — it is the primary sort key);
    * lq wherever ``lq < -1e-6`` (where it serves as the pe→1 tie-break;
      nearer 0 both implementations lose lq to cancellation, and there
      pe is small so lp decides the ranking alone).
    """
    from polar_tpu.code.construction import bhattacharyya_dual

    lp_c, lq_c = native.bhattacharyya_dual(m, pe)
    lp_np, lq_np = bhattacharyya_dual(m, pe)
    # lp: relative everywhere (last-ulp diffs compound multiplicatively in
    # the deep-underflow magnitudes, ~1e-12 at level 18); lq: absolute
    # 1e-12 bounds the cancellation-zone error, relative elsewhere.
    np.testing.assert_allclose(lp_c, lp_np, rtol=3e-12, atol=1e-12)
    np.testing.assert_allclose(lq_c, lq_np, rtol=1e-7, atol=1e-12)


@pytest.mark.parametrize("pe", [1e-6, 0.1, 0.5, 0.9, 1 - 1e-6])
def test_native_fixed_k_matches_in_tails(pe):
    """Mask parity at extreme design points where the rankings are decided
    by the saturating domain's tie-breaks."""
    m, n = 14, 1 << 14
    for k in (n // 8, n // 2, 7 * n // 8):
        a = native.frozen_mask_fixed_k(m, k, pe)
        b = pt.frozen_mask_fixed_k(m, k, pe)
        np.testing.assert_array_equal(a, b)


def test_native_large_n():
    """Construction + compile at N=2^20 complete quickly and agree on K."""
    m = 20
    mask = native.frozen_mask_fixed_k(m, 1 << 19)
    assert int((mask == 0).sum()) == 1 << 19
    prog = native.compile_program(mask, m)
    assert prog[0] == m and prog[-1] == 255


def test_native_errors():
    with pytest.raises(ValueError):
        native.frozen_mask_fixed_k(40, 10)
    assert native.have_native()
    with pytest.raises(ValueError):
        native._native.compile_program(b"\x01\x02", 4)
