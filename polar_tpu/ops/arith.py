"""Dtype-polymorphic decoder arithmetic (the batched `PolarHelper`).

This module defines the small op vocabulary the polar encoder/decoder is
written in, for three numeric modes:

* :class:`Int8Arith` — saturating int8 fixed point, bit-exact with the
  reference's SIMD int8 semantics (``polar_helper.hh:
  113-173``, the AVX2 ``vsign``-based path), including the ``-127``
  clamps guarding the asymmetric int8 range.
* :class:`FloatArith` — plain floating point, matching the generic SIMD
  float semantics (``polar_helper.hh:63-111``).
* :class:`QuantFloatArith` — **int8 semantics computed in float**: LLRs
  are small integers (|x| <= 128; intermediates pre-clamp <= 256), all
  exactly representable even in bfloat16 (8 significand bits). Saturation
  becomes a clamp, so the whole decode runs on the native float
  path at full rate while remaining bit-for-bit identical to
  :class:`Int8Arith`. This is an answer to the reference's
  int8 SIMD: same numerics, hardware-preferred dtype.

All ops are elementwise over arbitrarily-shaped jnp arrays; the frame
batch dimension rides along (the analog of the SIMD lane dimension).

Semantics cheat sheet (int8 / qfloat):
  qadd(a, b)      = sat8(a + b)                 saturating add
  qabs(a)         = |max(a, -127)|              abs that cannot overflow
  prod(a, b)      = sign(a)*sign(b)*min(qabs(a), qabs(b))   min-sum "f"
  madd(a, b, c)   = sat8(sign(a)*max(b, -127) + c)          "g" update
  qmul(a, b)      = a * b  (hard values in {-1,0,1} only)
  signum(a)       = -1/0/+1
  decide(a)       = -1 if a < 0 else +1
  flip(a,b,c,d)   = qmul(a, b) where c == d else a
  quant(x)        = clamp(rint(x), -128, 127)
"""

from __future__ import annotations

import jax.numpy as jnp

I8_MIN = -128
I8_MAX = 127


class _ArithBase:
    """Shared elementwise ops; subclasses define the saturating pieces."""

    dtype = None  # working dtype

    def one(self):
        return jnp.asarray(1, dtype=self.dtype)

    def zero(self):
        return jnp.asarray(0, dtype=self.dtype)

    def signum(self, a):
        """-1 / 0 / +1 (``polar_helper.hh:125-128``)."""
        return jnp.sign(a)

    def qmin(self, a, b):
        return jnp.minimum(a, b)

    def qmul(self, a, b):
        """Hard-decision multiply; only applied to values in {-1, 0, +1},
        where the reference's ``vsign`` (``polar_helper.hh:145-152``)
        equals plain multiplication."""
        return a * b

    def flip(self, a, b, c, d):
        """qmul(a, b) where c == d, else a (``polar_helper.hh:169-172``,
        the SPC weakest-bit flip)."""
        return jnp.where(c == d, self.qmul(a, b), a)


class Int8Arith(_ArithBase):
    """Saturating int8, bit-exact with ``PolarHelper<SIMD<int8_t,W>>``."""

    dtype = jnp.int8

    @staticmethod
    def _sat8(x16):
        return jnp.clip(x16, I8_MIN, I8_MAX).astype(jnp.int8)

    def signum(self, a):
        # sign == clip(x, -1, 1) on integers; cheaper than a generic sign
        return jnp.clip(a, jnp.asarray(-1, a.dtype), jnp.asarray(1, a.dtype))

    def decide(self, a):
        """+1 for a >= 0 else -1 (``polar_helper.hh:129-132``)."""
        return jnp.where(a < 0, jnp.asarray(-1, a.dtype), jnp.asarray(1, a.dtype))

    def qabs(self, a):
        """|max(a, -127)| — guards -128 (``polar_helper.hh:133-136``)."""
        return jnp.abs(jnp.maximum(a, jnp.asarray(-127, a.dtype)))

    def qadd(self, a, b):
        return self._sat8(a.astype(jnp.int16) + b.astype(jnp.int16))

    def prod(self, a, b):
        """Min-sum "f" (``polar_helper.hh:153-160``).

        ``sign(x) == clip(x, -1, 1)`` on integers — cheaper lowering."""
        s = self.signum(a).astype(jnp.int16) * self.signum(b)
        return (s * jnp.minimum(self.qabs(a), self.qabs(b))).astype(a.dtype)

    def madd(self, a, b, c):
        """"g": sat8(sign(a)*max(b,-127) + c) (``polar_helper.hh:161-168``).

        ``a`` is a hard decision in {-1, 0, +1} by the decoder contract
        (``polar_decoder.hh:36-43`` — partial sums), so ``sign(a) == a``."""
        p = a.astype(jnp.int16) * jnp.maximum(
            b, jnp.asarray(-127, b.dtype)
        ).astype(jnp.int16)
        return self._sat8(p + c.astype(jnp.int16))

    def quant(self, x):
        """clamp(rint(x), -128, 127) (``polar_helper.hh:194-198``)."""
        return jnp.clip(jnp.rint(x), I8_MIN, I8_MAX).astype(jnp.int8)


class FloatArith(_ArithBase):
    """Unsaturated float path (``polar_helper.hh:63-111``)."""

    def __init__(self, dtype=jnp.float32):
        self.dtype = jnp.dtype(dtype)

    def decide(self, a):
        """copysign(1, a) (``polar_helper.hh:79-82``)."""
        return jnp.copysign(jnp.asarray(1, a.dtype), a)

    def qabs(self, a):
        return jnp.abs(a)

    def qadd(self, a, b):
        return a + b

    def prod(self, a, b):
        return jnp.sign(a) * jnp.sign(b) * jnp.minimum(jnp.abs(a), jnp.abs(b))

    def madd(self, a, b, c):
        return a * b + c

    def quant(self, x):
        return x.astype(self.dtype)


class QuantFloatArith(_ArithBase):
    """Int8 saturation semantics carried in a float dtype.

    Inputs/outputs are integer-valued floats in [-128, 127]. Every op
    below produces intermediates bounded by |x| <= 256 pre-clamp, exactly
    representable in bfloat16 (and trivially in float32), so results are
    bit-identical to :class:`Int8Arith` while running on the native
    float datapath.
    """

    def __init__(self, dtype=jnp.bfloat16):
        self.dtype = jnp.dtype(dtype)

    def signum(self, a):
        # values are integer-valued floats: sign == clip(x, -1, 1)
        return jnp.clip(a, jnp.asarray(-1, a.dtype), jnp.asarray(1, a.dtype))

    def decide(self, a):
        return jnp.where(a < 0, jnp.asarray(-1, a.dtype), jnp.asarray(1, a.dtype))

    def qabs(self, a):
        return jnp.abs(jnp.maximum(a, jnp.asarray(-127, a.dtype)))

    def qadd(self, a, b):
        return jnp.clip(a + b, jnp.asarray(I8_MIN, a.dtype),
                        jnp.asarray(I8_MAX, a.dtype))

    def prod(self, a, b):
        # sign == clip(x, -1, 1) on integer-valued floats
        s = self.signum(a) * self.signum(b)
        return s * jnp.minimum(self.qabs(a), self.qabs(b))

    def madd(self, a, b, c):
        # `a` is a hard decision in {-1, 0, +1} (decoder contract), so
        # sign(a) == a
        p = a * jnp.maximum(b, jnp.asarray(-127, b.dtype))
        return jnp.clip(p + c, jnp.asarray(I8_MIN, a.dtype),
                        jnp.asarray(I8_MAX, a.dtype))

    def quant(self, x):
        return jnp.clip(jnp.rint(x), I8_MIN, I8_MAX).astype(self.dtype)


def arith_for(dtype) -> _ArithBase:
    """Default arithmetic for a working dtype: int8 → saturating int8,
    floats → plain float min-sum."""
    dtype = jnp.dtype(dtype)
    if jnp.issubdtype(dtype, jnp.integer):
        return Int8Arith()
    return FloatArith(dtype)


_INT8 = Int8Arith()


# ---------------------------------------------------------------------------
# Functional facade (dispatches on input dtype), used by code that doesn't
# care about the compute mode: int dtypes → Int8Arith, floats → FloatArith.
# ---------------------------------------------------------------------------

def _dispatch(x) -> _ArithBase:
    if jnp.issubdtype(jnp.asarray(x).dtype, jnp.integer):
        return _INT8
    return FloatArith(jnp.asarray(x).dtype)


def one(dtype):
    return jnp.asarray(1, dtype=dtype)


def zero(dtype):
    return jnp.asarray(0, dtype=dtype)


def signum(a):
    return jnp.sign(a)


def decide(a):
    return _dispatch(a).decide(a)


def qabs(a):
    return _dispatch(a).qabs(a)


def qmin(a, b):
    return jnp.minimum(a, b)


def qadd(a, b):
    return _dispatch(a).qadd(a, b)


def qmul(a, b):
    return a * b


def prod(a, b):
    return _dispatch(a).prod(a, b)


def madd(a, b, c):
    return _dispatch(a).madd(a, b, c)


def flip(a, b, c, d):
    return _dispatch(a).flip(a, b, c, d)


def quant(x, dtype=jnp.int8):
    """LLR quantizer: round-to-nearest-even then clamp for int dtypes
    (``polar_helper.hh:194-198``), identity cast for floats."""
    if jnp.issubdtype(jnp.dtype(dtype), jnp.integer):
        return jnp.clip(jnp.rint(x), I8_MIN, I8_MAX).astype(dtype)
    return x.astype(dtype)
