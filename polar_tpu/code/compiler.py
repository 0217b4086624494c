"""Fast-SSC node compiler: frozen-bit pattern → decoder node plan.

The reference compiles the frozen mask into a byte-code program interpreted
at run time (``polar_compiler.hh:21-58``). Here the same classification
runs in Python at **trace time** and specializes the jitted decoder
computation — the analog of the reference dispatching
``template<int level>`` kernel instantiations, with XLA doing the
instantiation.

This module is the single source of truth for node classification. It
produces:

* a :class:`Node` tree the decoder builders recurse over, and
* the reference-format byte program (``[level, opcodes..., 255]``) for
  golden parity tests and introspection.

Node kinds and opcodes match ``polar_compiler.hh:11-13``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .construction import PolarCode

# Opcode values of the reference byte-code (``polar_compiler.hh:11-13``).
OP_LEFT = 0
OP_RIGHT = 1
OP_COMB = 2
OP_RATE0 = 3
OP_RATE1 = 4
OP_REP = 5
OP_SPC = 6
OP_RATE0_RIGHT = 7
OP_RATE0_COMB = 8
OP_RATE1_COMB = 9
OP_END = 255


@dataclass(frozen=True)
class Node:
    """One node of the pruned SC decoding tree.

    ``kind`` is one of: ``rate0``, ``rate1``, ``rep``, ``spc`` (leaves of
    the pruned tree), ``rate0_right`` (all-frozen left half skipped),
    ``rate1_comb`` (all-info right half fused), ``branch`` (general).
    ``level``: node spans ``2**level`` codeword positions.
    ``mesg_bits``: information bits emitted in this subtree.
    """

    kind: str
    level: int
    mesg_bits: int
    left: "Node | None" = None
    right: "Node | None" = None


def build_tree(frozen: np.ndarray, level: int) -> Node:
    """Classify the code tree exactly as ``polar_compiler.hh:21-49``."""
    if level < 1:
        raise ValueError("node level must be >= 1")
    n = 1 << level
    half = n >> 1
    frozen = np.asarray(frozen, dtype=np.uint8)
    lcnt = int(frozen[:half].sum())
    rcnt = int(frozen[half:].sum())
    if lcnt == half and rcnt == half:
        return Node("rate0", level, 0)
    if lcnt == 0 and rcnt == 0:
        return Node("rate1", level, n)
    if lcnt == half and rcnt == half - 1 and not frozen[n - 1]:
        return Node("rep", level, 1)
    if lcnt == 1 and rcnt == 0 and frozen[0]:
        return Node("spc", level, n - 1)
    if lcnt == half:
        right = build_tree(frozen[half:], level - 1)
        return Node("rate0_right", level, right.mesg_bits, right=right)
    if rcnt == 0:
        left = build_tree(frozen[:half], level - 1)
        return Node("rate1_comb", level, left.mesg_bits + half, left=left)
    left = build_tree(frozen[:half], level - 1)
    right = build_tree(frozen[half:], level - 1)
    return Node("branch", level, left.mesg_bits + right.mesg_bits, left=left, right=right)


def emit_program(tree: Node, level: int) -> np.ndarray:
    """Serialize a node tree to the reference byte-code format.

    Format (``polar_compiler.hh:51-58``): ``[level, opcodes..., 255]``.
    Used for golden tests against the reference compiler and for debugging;
    the XLA decoder does not interpret it.
    """
    out = [level]

    def walk(node: Node) -> None:
        if node.kind == "rate0":
            out.append(OP_RATE0)
        elif node.kind == "rate1":
            out.append(OP_RATE1)
        elif node.kind == "rep":
            out.append(OP_REP)
        elif node.kind == "spc":
            out.append(OP_SPC)
        elif node.kind == "rate0_right":
            out.append(OP_RATE0_RIGHT)
            walk(node.right)
            out.append(OP_RATE0_COMB)
        elif node.kind == "rate1_comb":
            out.append(OP_LEFT)
            walk(node.left)
            out.append(OP_RATE1_COMB)
        elif node.kind == "branch":
            out.append(OP_LEFT)
            walk(node.left)
            out.append(OP_RIGHT)
            walk(node.right)
            out.append(OP_COMB)
        else:  # pragma: no cover
            raise AssertionError(node.kind)

    walk(tree)
    out.append(OP_END)
    return np.asarray(out, dtype=np.uint8)


def compile_code(code: PolarCode) -> Node:
    return build_tree(code.frozen, code.level)


def compile_program(code: PolarCode) -> np.ndarray:
    return emit_program(compile_code(code), code.level)
