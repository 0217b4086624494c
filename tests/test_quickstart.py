"""The README quickstart must keep working verbatim (doc-rot guard)."""

import numpy as np
import jax
import jax.numpy as jnp

import polar_tpu as pt


def test_readme_quickstart():
    code = pt.make_code(10, rate=0.5)              # Polar(1024, 512)
    rng = np.random.default_rng(0)
    msg = jnp.asarray(
        (1 - 2 * rng.integers(0, 2, (32, code.K))).astype(np.int8)
    )
    cw = pt.encode_systematic(code, msg)
    llr = pt.awgn_llrs(jax.random.PRNGKey(0), cw, snr_db=6.0)
    dec = jax.jit(pt.make_fastssc_decoder(code, output="systematic"))
    m_hat = dec(llr)
    assert m_hat.shape == (32, code.K)
    # at 6 dB the code is far above threshold: perfect recovery expected
    np.testing.assert_array_equal(np.asarray(m_hat), np.asarray(msg))


def test_readme_campaign_line():
    code = pt.make_code(5, rate=0.5)
    result = pt.run_campaign(
        code, batch=128, max_frames_per_point=256, target_bit_errors=50,
        snr_range=(6.0, 12.0), snr_step=2.0, stop_after_clean=1,
        measure_throughput=False,
    )
    assert result.points
