"""Test configuration: run everything on a virtual 8-device CPU mesh.

Tests force the CPU backend (fast, deterministic) with 8 virtual devices
so multi-device sharding paths are exercised without hardware — the
analog of the reference's QEMU cross-testing
(``Makefile:6-19`` of the reference). What needs a GPU is checked on the
card by ``chip_smoke.py``.
"""

import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)

import jax  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_platforms", "cpu")

# Two-lane suite: tests measured >= ~9 s on a CPU host are marked
# ``slow`` so ``pytest -m "not slow"`` is a < 5-minute smoke lane; CI /
# pre-merge runs everything. Names are function bases (parametrizations
# of a slow function are all slow).
_SLOW = {
    # oracle/golden parity (whole-decode sweeps)
    "test_decode_parity_int8", "test_encode_parity",
    "test_randomized_parity",
    # element-sharded decode (8-device mesh)
    "test_seqpar_decode_bitexact_vs_local",
    "test_seqpar_decode_batch_split_mode",
    "test_seqpar_decode_qfloat_compute",
    "test_seqpar_decode_u_full_frozen_slots",
    # distributed / meters / misc heavy
    "test_measure_decode_fps_on_frame_mesh",
    "test_two_process_checkpoint_resume_broadcast",
    "test_two_process_campaign_agrees",
    "test_decoder_batch_polymorphism", "test_noiseless_roundtrip_int8",
    "test_sc_equals_fastssc_float", "test_qfloat_bitexact_with_int8",
    "test_readme_quickstart",
    "test_step_systematic_matches_old_reencode_path",
    "test_seqpar_decode_small_meshes",
    "test_decode_parity_vs_reference_random_llrs",
    "test_sharded_encoder_matches_local",
    "test_transform_axis0_matches_transpose",
    "test_campaign_with_qfloat_compute",
    "test_multihost_cli_main",
    "test_systematic_output_matches_reencode_gather",
    "test_sharded_equals_sum_of_independent_shards",
    "test_sharded_point_reproducible",
    "test_codeword_output_is_reencoded_u",
}


def pytest_collection_modifyitems(config, items):
    for item in items:
        if item.name.split("[")[0] in _SLOW:
            item.add_marker(pytest.mark.slow)
