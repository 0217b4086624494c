"""Fast-SSC compiler tests: program parity vs the reference compiler."""

import math

import numpy as np
import pytest

import polar_tpu as pt
from polar_tpu.code.compiler import build_tree, emit_program
import oracle

# oracle-backed parity needs the read-only reference checkout; without it
# the frozen golden vectors (test_golden_vectors.py) carry the contract.
# Only the tests that call the oracle skip; the property tests always run.
needs_reference = pytest.mark.skipif(
    not oracle.have_reference(), reason="reference checkout not mounted"
)


def random_valid_mask(rng, m):
    """Random frozen mask that respects the reliability partial order
    (right child of every node at least as reliable as the left), like any
    mask produced by Bhattacharyya construction."""
    n = 1 << m
    k = int(rng.integers(1, n))
    logpe = pt.bhattacharyya_logpe(m, float(rng.uniform(0.05, 0.95)))
    order = np.argsort(logpe, kind="stable")
    frozen = np.ones(n, dtype=np.uint8)
    frozen[order[:k]] = 0
    return frozen


@needs_reference
@pytest.mark.parametrize("m", [1, 2, 3, 4, 6, 8, 10, 12])
def test_program_parity_constructed(m):
    n = 1 << m
    for rate in (0.25, 0.5, 0.75):
        frozen = pt.frozen_mask_fixed_k(m, int(rate * n), math.exp(-1.0))
        ours = emit_program(build_tree(frozen, m), m)
        ref = oracle.progcompile(m, frozen)
        np.testing.assert_array_equal(ours, ref)


@needs_reference
@pytest.mark.parametrize("seed", range(8))
def test_program_parity_random_masks(seed):
    rng = np.random.default_rng(seed)
    m = int(rng.integers(2, 10))
    frozen = random_valid_mask(rng, m)
    ours = emit_program(build_tree(frozen, m), m)
    ref = oracle.progcompile(m, frozen)
    np.testing.assert_array_equal(ours, ref)


def test_tree_mesg_bits_equals_k():
    for m in (4, 8, 10):
        code = pt.make_code(m, rate=0.5)
        tree = pt.compile_code(code)
        assert tree.mesg_bits == code.K


def test_program_length_testbench_config():
    """The reference reports 2457 program bytes for Polar(16384, 8192)
    (BASELINE.md); our compiler must agree on the same frozen set."""
    code = pt.make_code(14, rate=0.5)
    prog = pt.compile_program(code)
    assert prog[0] == 14 and prog[-1] == 255
    assert len(prog) == 2457


@needs_reference
def test_edge_all_kinds_present():
    code = pt.make_code(10, rate=0.5)
    prog = pt.compile_program(code)
    kinds = set(int(x) for x in prog[1:-1])
    # A realistic rate-1/2 code exercises every opcode except bare rate0 (3):
    # under the reliability partial order an all-frozen right child implies an
    # all-frozen parent, which always folds into the rate0_right fusion.
    assert {0, 1, 2, 4, 5, 6, 7, 8, 9} <= kinds
    # a degenerate all-frozen code is a single rate0 node
    all_frozen = np.ones(16, dtype=np.uint8)
    prog0 = emit_program(build_tree(all_frozen, 4), 4)
    np.testing.assert_array_equal(prog0, [4, 3, 255])
    np.testing.assert_array_equal(oracle.progcompile(4, all_frozen), prog0)
