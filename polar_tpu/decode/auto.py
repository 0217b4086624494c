"""Decoder selection by platform.

Every supported platform gets the XLA Fast-SSC decoder
(:func:`make_fastssc_decoder`):

* ``"gpu"`` — the production path on an NVIDIA GPU. A hand-written CUDA
  decode kernel was measured against it on an H100 and lost inside the
  end-to-end Monte-Carlo step at both measured codes, so it was removed
  (``PERF.md``, "Bring-up: decode kernel vs XLA");
* ``"cpu"`` — tests and debugging;
* any other platform is an error: there is no silent default.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..code.construction import PolarCode
from .fastssc import make_fastssc_decoder

PLATFORMS = ("gpu", "cpu")


def make_auto_decoder(code: PolarCode, *, output: str = "u",
                      output_dtype=jnp.int8, backend: str | None = None):
    """Decoder for ``code`` on ``backend`` (default: the current platform).

    Returns ``(decode_fn, description)``. Inputs are int8 LLRs; any batch
    size works. For real-valued float LLRs use :func:`make_fastssc_decoder`
    (the float min-sum path).
    """
    if backend is None:
        backend = jax.default_backend()
    if backend not in PLATFORMS:
        raise ValueError(f"no decoder is chosen for platform {backend!r}; "
                         f"supported platforms are {PLATFORMS}")
    return (make_fastssc_decoder(code, output=output,
                                 output_dtype=output_dtype), "xla")
