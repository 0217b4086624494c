"""On-device AWGN channel, BPSK demodulation, and LLR quantization.

Batched restatement of the testbench channel model
(``testbench.cc:110-165``): unit-power BPSK symbols, AWGN
with ``sigma = sqrt(1 / (2 * 10^(SNR/10)))``, LLR ``= 2/sigma^2 * y``,
quantized to saturating int8 (or kept in float). Noise is generated on
device from a JAX PRNG key, so every SNR point is a pure function of its
key — restartable and shardable by construction.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp

from .ops import arith


def noise_sigma(snr_db: float, signal_sigma: float = 1.0) -> float:
    """AWGN standard deviation for an Es/N0 in dB (``testbench.cc:114``)."""
    return math.sqrt(signal_sigma**2 / (2.0 * 10.0 ** (snr_db / 10.0)))


def ebn0_db(snr_db: float, code_rate: float, mod_bits: int = 1) -> float:
    """Eb/N0 in dB from Es/N0 (``testbench.cc:203-206``)."""
    sigma = noise_sigma(snr_db)
    spectral_efficiency = code_rate * mod_bits
    return 10.0 * math.log10(1.0 / (spectral_efficiency * 2.0 * sigma * sigma))


def awgn_llrs(key, codeword, snr_db: float, dtype=jnp.int8):
    """Transmit ±1 symbols over AWGN and return quantized channel LLRs.

    ``codeword``: (..., N) hard symbols in {-1, +1} (any dtype).
    Returns (..., N) LLRs in ``dtype`` — saturating int8 by default,
    matching ``PolarHelper<int8_t>::quant(2/sigma^2 * y)``
    (``testbench.cc:160-165``). ``snr_db`` may be a traced scalar, so one
    jitted Monte-Carlo step serves every SNR point without recompiling.
    """
    sigma2 = 0.5 * 10.0 ** (-jnp.float32(snr_db) / 10.0)  # sigma^2, testbench.cc:114
    y = codeword.astype(jnp.float32) + jnp.sqrt(sigma2) * jax.random.normal(
        key, codeword.shape, dtype=jnp.float32
    )
    llr_scale = 2.0 / sigma2  # DIST=2 for BPSK, testbench.cc:162-163
    return arith.quant(llr_scale * y, dtype)
