"""Cost-model tests."""

import pytest

import polar_tpu as pt
from polar_tpu.utils.cost import decode_cost


def test_decode_cost_profile():
    c = decode_cost(pt.make_code(10, rate=0.5))
    assert c.n == 1024
    assert c.node_count > 50
    assert c.elem_ops_per_frame > 10000
    # f and g dominate (SURVEY-consistent)
    assert c.by_kind["f"][0] > c.by_kind["transform"][0]
    assert "f" in c.summary()


@pytest.mark.parametrize("m,nodes", [(10, 127), (14, 1228)])
def test_decode_cost_node_counts(m, nodes):
    """The pruned-tree node counts of the two bring-up codes."""
    assert decode_cost(pt.make_code(m, rate=0.5)).node_count == nodes


def test_decode_cost_grows_with_n():
    small = decode_cost(pt.make_code(8, rate=0.5))
    big = decode_cost(pt.make_code(12, rate=0.5))
    assert big.elem_ops_per_frame > 4 * small.elem_ops_per_frame
    assert big.node_count > small.node_count
