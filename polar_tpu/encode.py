"""Batched polar encoders (non-systematic and systematic).

Batched restatement of ``polar_encoder.hh``:

* non-systematic (lines 9-28): scatter message symbols into the non-frozen
  leaf slots (+1 into frozen slots) and apply the polar transform;
* systematic (lines 30-59, Arıkan 2011): transform, re-freeze, transform
  again — the transform is a GF(2) involution, so information bits appear
  verbatim at the non-frozen codeword positions.

All functions operate on ``(..., K)`` message batches of ±1 hard symbols
and return ``(..., N)`` codewords; they are pure, jittable, and specialize
on the :class:`~polar_tpu.code.construction.PolarCode` at trace time (the
frozen mask is baked into the computation as a constant — no dynamic
control flow).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from .code.construction import PolarCode
from .ops.transform import polar_transform


def _scatter_message(code: PolarCode, message, fill=1):
    """Place message symbols at info leaf slots; ``fill`` (+1) elsewhere."""
    if message.shape[-1] != code.K:
        raise ValueError(f"message last dim {message.shape[-1]} != K={code.K}")
    lead = message.shape[:-1]
    u = jnp.full((*lead, code.N), fill, dtype=message.dtype)
    info = np.flatnonzero(code.frozen == 0)
    return u.at[..., info].set(message)


def encode(code: PolarCode, message):
    """Non-systematic encode: codeword = transform(scatter(message))."""
    return polar_transform(_scatter_message(code, message))


def encode_systematic(code: PolarCode, message):
    """Systematic encode: info bits appear verbatim in the codeword.

    ``transform(refreeze(transform(scatter(message))))`` — the structure of
    ``polar_encoder.hh:38-57`` with both butterflies vectorized.
    """
    x = polar_transform(_scatter_message(code, message))
    frozen = jnp.asarray(code.frozen, dtype=jnp.bool_)
    x = jnp.where(frozen, jnp.asarray(1, x.dtype), x)
    return polar_transform(x)


def extract_systematic(code: PolarCode, u_message):
    """Recover the systematic message from decoded u-domain info bits.

    The decoder emits u-domain information bits; re-encoding and gathering
    the non-frozen codeword positions yields the systematic message
    (``testbench.cc:177-183``).
    """
    codeword = encode(code, u_message)
    info = np.flatnonzero(code.frozen == 0)
    return codeword[..., info]
