"""Batched polar transform (the XOR butterfly in the ±1 hard-symbol domain).

The polar transform F^{⊗m} applied over GF(2) is expressed here on BPSK
hard symbols (bit 0 ↔ +1, bit 1 ↔ -1), where XOR becomes multiplication.
This reproduces the structure of the reference butterfly
(``polar_encoder.hh:17-26``): stage h pairs element j with
element j+h and replaces the lower element by the product.

Notes: each stage is one fused elementwise multiply over a
``(..., N/(2h), 2, h)`` view — static shapes, no gathers, XLA fuses the
log2(N) stages into a handful of vector ops. The leading batch dimensions
(frames) ride along untouched, so a single call transforms an arbitrarily
large frame batch.
"""

from __future__ import annotations

import jax.numpy as jnp


def polar_transform(x, axis: int = -1):
    """Apply the N×N polar transform along ``axis`` (last or first).

    ``x``: (..., N) (``axis=-1``) or (N, ...) (``axis=0``) hard symbols
    in {-1, 0, +1} (any int or float dtype). The transform is an
    involution over GF(2): applying it twice yields the input (for ±1
    inputs), a property the systematic encoder exploits. ``axis=0`` is
    the element-major (lane-major) layout the Pallas kernels use —
    the code axis leads, frames ride on the trailing axes.
    """
    n = x.shape[axis]
    if n & (n - 1):
        raise ValueError(f"N must be a power of two, got {n}")
    return polar_transform_stages(x, 1, n, axis=axis)


def polar_transform_stages(x, h_lo: int, h_hi: int, axis: int = -1):
    """Apply only the butterfly stages with ``h_lo <= h < h_hi``.

    The full transform is the composition of log2(N) stages, one per
    index bit; stage h is the Kronecker factor acting on bit log2(h), so
    **stages commute** — the transform splits as (top stages) ∘ (bottom
    stages) in either order. This is what lets a hybrid encoder run the
    bottom stages block-locally in a Pallas kernel (stage h < B only
    pairs elements inside the same B-aligned block) and the few top
    stages as XLA elementwise ops (tested:
    ``tests/test_encode.py::test_transform_stage_split_commutes``).

    ``axis=-1``: code on the last axis, frames leading. ``axis=0``:
    element-major — code on the first axis, frames trailing (top stages
    then touch contiguous row blocks, so they are layout-friendly on
    ``(N, B)`` arrays with no transpose).
    """
    if axis == 0:
        n = x.shape[0]
        tail = x.shape[1:]
        h = h_lo
        while h < h_hi:
            v = x.reshape(n // (2 * h), 2, h, *tail)
            lo = v[:, 0] * v[:, 1]
            x = jnp.concatenate([lo[:, None], v[:, 1:2]], axis=1)
            x = x.reshape(n, *tail)
            h *= 2
        return x
    if axis != -1:
        raise ValueError("axis must be 0 or -1")
    n = x.shape[-1]
    lead = x.shape[:-1]
    h = h_lo
    while h < h_hi:
        v = x.reshape(*lead, n // (2 * h), 2, h)
        lo = v[..., 0, :] * v[..., 1, :]
        x = jnp.concatenate([lo[..., None, :], v[..., 1:2, :]], axis=-2)
        x = x.reshape(*lead, n)
        h *= 2
    return x
