"""Static cost model for a code's Fast-SSC decode.

Computes, per frame, the element-operation profile of the pruned tree:
how many nodes it has and which node kinds dominate.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..code.compiler import Node, compile_code
from ..code.construction import PolarCode

# approximate element-op multipliers per kind. "f_cached" is an f whose
# input slot was produced by a parent f: a decoder that hands the
# parent's min magnitudes down skips both abs ops; same for spc_cached
# (skips abs + guard).
_MULT = {
    "f": 7, "f_cached": 5, "g": 4, "comb": 1, "qadd": 3, "copy": 1,
    "sign": 2, "rate0": 1, "rate1": 2, "rep": 3, "spc": 8,
    "spc_cached": 6, "transform": 2,
}

@dataclass
class DecodeCost:
    n: int
    node_count: int
    elem_ops_per_frame: int   # weighted element-ops
    by_kind: dict             # kind -> (elem_ops, sites)

    def summary(self) -> str:
        rows = sorted(self.by_kind.items(), key=lambda kv: -kv[1][0])
        lines = [f"Polar N={self.n}: {self.node_count} nodes, "
                 f"{self.elem_ops_per_frame:,} elem-ops/frame"]
        for kind, (ops, sites) in rows:
            pct = 100.0 * ops / max(1, self.elem_ops_per_frame)
            lines.append(f"  {kind:10s} {ops:10,d} ({pct:4.1f}%) over {sites} sites")
        return "\n".join(lines)


def decode_cost(code: PolarCode, tree: Node | None = None) -> DecodeCost:
    """Element-op profile of the pruned decode tree."""
    if tree is None:
        tree = compile_code(code)
    by_kind: dict = {}
    nodes = 0

    def add(kind, elems):
        ops, sites = by_kind.get(kind, (0, 0))
        by_kind[kind] = (ops + elems * _MULT[kind], sites + 1)

    def walk(n: Node, from_f: bool = False):
        nonlocal nodes
        nodes += 1
        length = 1 << n.level
        half = length // 2
        k = n.kind
        if k == "rate0":
            add("rate0", length)
        elif k == "rate1":
            add("rate1", length)
            add("transform", length * n.level // 2)
        elif k == "rep":
            add("rep", length)
        elif k == "spc":
            add("spc_cached" if from_f else "spc", length)
            add("transform", length * n.level // 2)
        elif k == "rate0_right":
            add("qadd", half)
            walk(n.right)
            add("copy", half)
        elif k == "rate1_comb":
            add("f_cached" if from_f else "f", half)
            walk(n.left, from_f=True)
            add("g", half)
            add("sign", half)
            add("transform", half * (n.level - 1) // 2)
            add("comb", half)
        elif k == "branch":
            add("f_cached" if from_f else "f", half)
            walk(n.left, from_f=True)
            add("g", half)
            walk(n.right)
            add("comb", half)

    walk(tree)
    total = sum(ops for ops, _ in by_kind.values())
    return DecodeCost(n=code.N, node_count=nodes,
                      elem_ops_per_frame=total, by_kind=by_kind)
