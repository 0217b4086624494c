"""polar_tpu — a polar-coding framework in JAX/XLA.

A from-scratch JAX/XLA re-design of the capabilities of
``xdsopl/polar`` (successive-cancellation decoding of polar codes in
saturating int8 fixed point): code construction, Fast-SSC compilation,
systematic/non-systematic encoding, batched SC / Fast-SSC decoding, AWGN
Monte-Carlo BER campaigns, and multi-GPU scaling via ``shard_map``.

Quick start::

    import jax, polar_tpu as pt

    code = pt.make_code(10, rate=0.5)            # Polar(1024, 512)
    dec = jax.jit(pt.make_fastssc_decoder(code))
    result = pt.run_campaign(code, batch=4096)   # BER waterfall
"""

from .channel import awgn_llrs, ebn0_db, noise_sigma
from .code.compiler import Node, compile_code, compile_program
from .code.construction import (
    PolarCode,
    bhattacharyya_dual,
    bhattacharyya_logpe,
    design_snr_db,
    erasure_probability_for_snr_db,
    frozen_mask_fixed_k,
    frozen_mask_threshold,
    make_code,
    make_code_threshold,
)
from .decode.auto import make_auto_decoder
from .decode.fastssc import make_fastssc_decoder
from .decode.sc import make_sc_decoder
from .encode import encode, encode_systematic, extract_systematic
from .ops.transform import polar_transform
from .ber import CampaignResult, SnrPoint, make_step, run_campaign, run_point
from .campaign_io import load_result, plot_waterfall, save_result

__version__ = "0.1.0"

__all__ = [
    "PolarCode",
    "make_code",
    "make_code_threshold",
    "frozen_mask_fixed_k",
    "frozen_mask_threshold",
    "bhattacharyya_logpe",
    "bhattacharyya_dual",
    "design_snr_db",
    "erasure_probability_for_snr_db",
    "Node",
    "compile_code",
    "compile_program",
    "polar_transform",
    "encode",
    "encode_systematic",
    "extract_systematic",
    "make_sc_decoder",
    "make_fastssc_decoder",
    "make_auto_decoder",
    "awgn_llrs",
    "noise_sigma",
    "ebn0_db",
    "make_step",
    "run_point",
    "run_campaign",
    "SnrPoint",
    "CampaignResult",
    "save_result",
    "load_result",
    "plot_waterfall",
]
