"""Fast-SSC decoder: trace-time specialized, batched, XLA path.

The reference interprets a byte-code program over shape-specialized
template kernels (``polar_decoder.hh:131-464``). Here the same pruned-tree
recursion runs in Python at **trace time** over the
:class:`~polar_tpu.code.compiler.Node` tree, emitting one fully-unrolled
XLA computation per (N, frozen-set) — the analog of
``template<int level>`` instantiation. All shapes are static; the frame
batch is the leading dimension (the analog of the SIMD lane axis, but
thousands wide instead of 32).

Node semantics are op-for-op those of ``polar_decoder.hh``:

* f / "left"       (28-35):  prod of the two input halves
* g / "right"      (36-43):  madd with the left hard partial sums
* rate0_right      (44-51):  g with implicit +1 hard → saturating add
* comb             (52-59):  hard[i] *= hard_right[i]
* rate0            (68-75):  all +1, no message
* rate1            (85-93):  elementwise sign, message = transform(hard)
* rate1_comb       (76-84):  fused g + sign + comb + transform
* rep              (94-106): saturating fold-in-half adder tree, sign bcast
* spc             (107-127): Wagner decode — decide, parity, weakest |LLR|
                             flip, message = transform(hard)[1:]

Beyond the reference's structure: **compute modes** —
``compute="qfloat"`` carries the exact int8 saturation semantics in
bfloat16 (see :class:`~polar_tpu.ops.arith.QuantFloatArith`): identical
bits in a float dtype.

(A root-hard shortcut — returning the decoder's internal root hard as the
re-encoded codeword — is deliberately NOT used for the systematic path:
it deviates from the reference whenever zero-LLR ties or SPC even-tie
flips occur, because the testbench's re-encode forces frozen slots to +1
(``testbench.cc:177-183``) while the internal hard need not satisfy them.
The systematic output therefore re-encodes the u estimate, fused into the
same program.)

Saturation order matches the reference exactly, so int8(-semantics)
decodes are bit-exact against the reference decoder (oracle parity
tests).
"""

from __future__ import annotations

import jax.numpy as jnp

from ..code.compiler import Node, compile_code
from ..code.construction import PolarCode
from ..ops.arith import FloatArith, Int8Arith, QuantFloatArith, arith_for
from ..ops.transform import polar_transform


class _TreeDecoder:
    """Trace-time recursion over the pruned tree; the code-element axis is
    the last one (frame-major ``(..., N)``)."""

    def __init__(self, ph):
        self.ph = ph
        self.mesg: list = []

    # -- layout helpers: halves/concat along the code-element axis ------
    def _halves(self, x):
        half = x.shape[-1] // 2
        return x[..., :half], x[..., half:]

    def _cat(self, parts):
        return jnp.concatenate(parts, axis=-1)

    def _transform(self, x):
        return polar_transform(x, axis=-1)

    # -- f/g over the two halves of a node's soft input -----------------
    def _f(self, inp):
        lo, hi = self._halves(inp)
        return self.ph.prod(lo, hi)

    def _g(self, hard_left, inp):
        lo, hi = self._halves(inp)
        return self.ph.madd(hard_left, lo, hi)

    def _g_rate0(self, inp):
        # g with an all-(+1) left half: plain saturating add without the
        # -127 clamp, mirroring rate0_right (polar_decoder.hh:44-51).
        lo, hi = self._halves(inp)
        return self.ph.qadd(lo, hi)

    # -- leaf nodes of the pruned tree ----------------------------------
    def _rep(self, soft):
        x = soft
        while x.shape[-1] > 1:
            lo, hi = self._halves(x)
            x = self.ph.qadd(lo, hi)
        bit = self.ph.signum(x)
        self.mesg.append(bit)
        return jnp.broadcast_to(bit, soft.shape)

    def _spc_hard(self, soft):
        ph = self.ph
        hard = ph.decide(soft)
        parity = jnp.prod(hard, axis=-1, keepdims=True).astype(hard.dtype)
        sabs = ph.qabs(soft)
        weak = jnp.min(sabs, axis=-1, keepdims=True)
        return ph.flip(hard, parity, weak, sabs)

    # -- the recursion ---------------------------------------------------
    def decode(self, node: Node, soft):
        """Returns this node's hard codeword estimate. Message blocks are
        appended in emission order (in-order traversal, the msg-cursor
        semantics of polar_decoder.hh)."""
        kind = node.kind
        ph = self.ph
        if kind == "rate0":
            return jnp.ones_like(soft)
        if kind == "rate1":
            hard = ph.signum(soft)
            self.mesg.append(self._transform(hard))
            return hard
        if kind == "rep":
            return self._rep(soft)
        if kind == "spc":
            hard = self._spc_hard(soft)
            self.mesg.append(self._transform(hard)[..., 1:])
            return hard
        if kind == "rate0_right":
            hard_r = self.decode(node.right, self._g_rate0(soft))
            return self._cat([hard_r, hard_r])
        if kind == "rate1_comb":
            hard_l = self.decode(node.left, self._f(soft))
            hard_r = ph.signum(self._g(hard_l, soft))
            self.mesg.append(self._transform(hard_r))
            return self._cat([ph.qmul(hard_l, hard_r), hard_r])
        if kind == "branch":
            hard_l = self.decode(node.left, self._f(soft))
            hard_r = self.decode(node.right, self._g(hard_l, soft))
            return self._cat([ph.qmul(hard_l, hard_r), hard_r])
        raise AssertionError(kind)  # pragma: no cover


def _resolve_arith(compute, dtype):
    if compute is None:
        return arith_for(dtype), None
    if isinstance(compute, str):
        if compute == "int8":
            return Int8Arith(), jnp.int8
        if compute == "qfloat" or compute == "qfloat-bf16":
            return QuantFloatArith(jnp.bfloat16), jnp.bfloat16
        if compute == "qfloat-f32":
            return QuantFloatArith(jnp.float32), jnp.float32
        if compute == "float" or compute == "float32":
            return FloatArith(jnp.float32), jnp.float32
        if compute == "bfloat16":
            return FloatArith(jnp.bfloat16), jnp.bfloat16
        raise ValueError(f"unknown compute mode {compute!r}")
    return compute, getattr(compute, "dtype", None)


def make_fastssc_decoder(
    code: PolarCode,
    tree: Node | None = None,
    *,
    output: str = "u",
    compute=None,
    output_dtype=None,
):
    """Build a jittable Fast-SSC decoder specialized for ``code``.

    ``output``:
      * ``"u"`` — (..., K) u-domain info bits (the reference decoder's
        output, ``polar_decoder.hh:131``).
      * ``"systematic"`` — (..., K) systematic message: the re-encoded
        codeword estimate gathered at info positions, exactly the
        testbench's extraction (``testbench.cc:177-183``), fused into the
        decode program.
      * ``"codeword"`` — (..., N) re-encoded codeword estimate.
      * ``"both"`` — tuple ``(u, codeword)``.

    ``compute``: None (infer from input dtype: int8 → saturating int8,
    float → plain min-sum), or one of ``"int8"``, ``"qfloat"`` /
    ``"qfloat-bf16"``, ``"qfloat-f32"`` (int8 semantics in float — exact),
    ``"float32"``, ``"bfloat16"``, or an arith object.

    ``output_dtype``: cast hard outputs (±1/0) to this dtype (defaults to
    the working dtype; int8 recommended with qfloat compute).

    The returned function is pure and shape-polymorphic in leading batch
    dimensions; it retraces only per distinct (N, frozen-set) — the
    analog of the reference's one-time program compile
    (``testbench.cc:95-97``).
    """
    if tree is None:
        tree = compile_code(code)
    if output not in ("u", "systematic", "codeword", "both"):
        raise ValueError(f"unknown output mode {output!r}")
    info = code.info_indices

    def decode(llrs):
        from ..encode import encode as reencode

        ph, work_dtype = _resolve_arith(compute, llrs.dtype)
        x = llrs if work_dtype is None else llrs.astype(work_dtype)
        dec = _TreeDecoder(ph)
        dec.decode(tree, x)
        u = jnp.concatenate(dec.mesg, axis=-1)
        out_dtype = output_dtype or u.dtype

        def cast(a):
            return a.astype(out_dtype) if a.dtype != out_dtype else a

        if output == "u":
            return cast(u)
        cw = reencode(code, u)
        if output == "systematic":
            return cast(cw[..., info])
        if output == "codeword":
            return cast(cw)
        return cast(u), cast(cw)

    return decode
