"""Code-construction tests: golden parity vs the reference freezers."""

import math

import numpy as np
import pytest

import polar_tpu as pt
import oracle

# oracle-backed parity needs the read-only reference checkout; without it
# the frozen golden vectors (test_golden_vectors.py) carry the contract.
# Only the tests that call the oracle skip; the property tests always run.
needs_reference = pytest.mark.skipif(
    not oracle.have_reference(), reason="reference checkout not mounted"
)


@needs_reference
@pytest.mark.parametrize("m", [2, 3, 4, 6, 8, 10, 12])
@pytest.mark.parametrize("rate", [0.25, 0.5, 0.75])
def test_fixed_k_matches_reference(m, rate):
    n = 1 << m
    k = int(rate * n)
    pe = math.exp(-1.0)
    ours = pt.frozen_mask_fixed_k(m, k, pe)
    ref = oracle.freezek(m, k, pe)
    np.testing.assert_array_equal(ours, ref)


@needs_reference
@pytest.mark.parametrize("m", [4, 6, 8, 10])
def test_fixed_k_testbench_design_point(m):
    """The exact testbench recipe (``testbench.cc:74-89``) at rate 1/2."""
    n = 1 << m
    k = n // 2
    snr = pt.design_snr_db(0.5) + 1.59175
    pe = pt.erasure_probability_for_snr_db(snr)
    code = pt.make_code(m, k)
    ref = oracle.freezek(m, k, pe)
    np.testing.assert_array_equal(code.frozen, ref)


@needs_reference
@pytest.mark.parametrize("m", [3, 5, 8, 10])
@pytest.mark.parametrize("th", [0.5, 1e-7])
def test_threshold_matches_reference(m, th):
    pe = 0.5
    ours = pt.frozen_mask_threshold(m, pe, th)
    ref = oracle.freezeth(m, pe, th)
    np.testing.assert_array_equal(ours, ref)


def test_large_n_no_underflow():
    """log-domain evolution stays finite far beyond the reference's
    long-double underflow point (~level 14), where its linear-space probs
    collapse to exact 0 and ranking degenerates to arbitrary tie-breaks."""
    logpe = pt.bhattacharyya_logpe(18)
    assert np.all(np.isfinite(logpe))
    # the worst channel's log-prob is a huge negative number, not -inf/0
    assert logpe.min() < -1e5
    # far fewer collisions than the reference's mass underflow ties
    assert len(np.unique(logpe)) > 0.6 * len(logpe)


def test_right_child_always_more_reliable():
    """pe_right = pe^2 <= pe*(2-pe) = pe_left at every split — guarantees the
    compiler never sees a free-left/frozen-right 2-bit node."""
    logpe = pt.bhattacharyya_logpe(10)
    assert np.all(logpe[1::2] <= logpe[0::2])


def test_polar_code_properties():
    code = pt.make_code(8, rate=0.5)
    assert code.N == 256
    assert code.K == 128
    assert code.rate == 0.5
    assert len(code.info_indices) == 128
    assert np.all(code.frozen[code.info_indices] == 0)
    code2 = pt.make_code(8, rate=0.5)
    assert code == code2 and hash(code) == hash(code2)


def test_threshold_k_output():
    frozen = pt.frozen_mask_threshold(6, 0.5, 0.5)
    k = int((frozen == 0).sum())
    assert 0 < k < 64
