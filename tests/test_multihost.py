"""Multi-host campaign runner smoke tests (single process, 8 CPU devices)."""

import polar_tpu as pt
from polar_tpu.parallel.multihost import (
    initialize_multihost,
    is_lead_host,
    run_multihost_campaign,
)


def test_initialize_noop_without_coordinator(monkeypatch):
    monkeypatch.delenv("JAX_COORDINATOR_ADDRESS", raising=False)
    assert initialize_multihost() is False
    assert is_lead_host()


def test_initialize_needs_explicit_process_layout(monkeypatch):
    """A coordinator without num_processes/process_id is an error: the
    launcher never autodetects a cluster."""
    import pytest

    monkeypatch.delenv("JAX_COORDINATOR_ADDRESS", raising=False)
    with pytest.raises(ValueError):
        initialize_multihost("localhost:1234")


def test_run_multihost_campaign_small():
    code = pt.make_code(6, rate=0.5)
    points = run_multihost_campaign(
        code, per_device_batch=32, max_global_frames=512,
        target_bit_errors=50, snr_range=(4.0, 10.0), snr_step=1.0,
        stop_after_clean=2, verbose=False,
    )
    assert len(points) >= 2
    assert points[-1]["bit_errors"] == 0
    assert points[0]["frames"] % (32 * 8) == 0


def test_multihost_cli_main(tmp_path):
    """End-to-end CLI run, single process, 8 virtual devices."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parent.parent
    out = tmp_path / "pod.json"
    env = os.environ.copy()
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    r = subprocess.run(
        [sys.executable, "-m", "polar_tpu.parallel.multihost",
         "--m", "5", "--per-device-batch", "16", "--out", str(out),
         "--max-global-frames", "256", "--target-errors", "50",
         "--snr-min", "4", "--snr-max", "8", "--snr-step", "2"],
        capture_output=True, text=True, env=env, cwd=repo, timeout=500,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    data = json.loads(out.read_text())
    assert data["code_n"] == 32
    assert len(data["points"]) >= 1
