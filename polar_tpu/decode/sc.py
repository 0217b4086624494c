"""Naive successive-cancellation decoder (correctness anchor).

Textbook SC: recurse the full code tree with min-sum f, g, and per-leaf
sign decisions — no special-node pruning. The recursion runs in Python at
trace time over static shapes, emitting one fixed XLA computation per
(N, frozen-set); the batch dimension carries the frames.

This is the semantic anchor the Fast-SSC decoder is validated against
(the reference has no such decoder — its only SC algorithm is the pruned
interpreter in ``polar_decoder.hh``; equivalence of the
pruned and unpruned trees is the Fast-SSC correctness argument of Sarkis
et al. 2013, which our tests verify numerically).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..code.construction import PolarCode
from ..ops import arith


def _f(inp):
    half = inp.shape[-1] // 2
    return arith.prod(inp[..., :half], inp[..., half:])


def _g(hard_left, inp):
    half = inp.shape[-1] // 2
    return arith.madd(hard_left, inp[..., :half], inp[..., half:])


def _decode_node(soft, frozen: np.ndarray, mesg: list) -> jnp.ndarray:
    """Returns the node's hard codeword estimate; appends message blocks."""
    n = soft.shape[-1]
    if n == 1:
        if frozen[0]:
            return jnp.ones_like(soft)
        hard = arith.signum(soft)
        mesg.append(hard)
        return hard
    half = n // 2
    hard_l = _decode_node(_f(soft), frozen[:half], mesg)
    hard_r = _decode_node(_g(hard_l, soft), frozen[half:], mesg)
    return jnp.concatenate([arith.qmul(hard_l, hard_r), hard_r], axis=-1)


def make_sc_decoder(code: PolarCode, *, output: str = "u"):
    """Build a jittable decoder: LLRs (..., N) → u-domain info bits (..., K).

    ``output`` mirrors :func:`polar_tpu.decode.fastssc.make_fastssc_decoder`:
    ``"u"``, ``"systematic"``, ``"codeword"``, or ``"both"``.
    """
    if output not in ("u", "systematic", "codeword", "both"):
        raise ValueError(f"unknown output mode {output!r}")
    frozen = np.asarray(code.frozen, dtype=np.uint8)

    def decode(llrs):
        from ..encode import encode as reencode

        mesg: list = []
        _decode_node(llrs, frozen, mesg)
        u = jnp.concatenate(mesg, axis=-1)
        if output == "u":
            return u
        cw = reencode(code, u)
        if output == "systematic":
            return cw[..., code.info_indices]
        if output == "codeword":
            return cw
        return u, cw

    return decode
