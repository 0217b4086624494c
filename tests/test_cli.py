"""CLI smoke tests (subprocess, CPU-forced, tiny workloads)."""

import json
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def _env():
    env = os.environ.copy()
    env["JAX_PLATFORMS"] = "cpu"
    return env


def test_waterfall_cli(tmp_path):
    out = tmp_path / "wf.json"
    plot = tmp_path / "wf.png"
    r = subprocess.run(
        [
            sys.executable, str(REPO / "scripts" / "waterfall.py"),
            "--m", "5", "--rate", "0.5", "--cpu", "--batch", "128",
            "--max-frames", "256", "--target-errors", "50",
            "--snr-min", "4", "--snr-max", "10", "--snr-step", "2",
            "--no-throughput", "--out", str(out), "--plot", str(plot),
        ],
        capture_output=True, text=True, env=_env(), cwd=REPO, timeout=300,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    assert "Polar(32, 16)" in r.stderr
    assert "QEF at:" in r.stderr
    data = json.loads(out.read_text())
    assert data["code_n"] == 32
    assert len(data["points"]) >= 1
    assert plot.stat().st_size > 1000


def test_waterfall_cli_threshold_mode(tmp_path):
    """--threshold drives the testbench's alternate construction branch
    (testbench.cc:78-81): K is an output, not an input."""
    from polar_tpu.code.construction import make_code_threshold

    expect = make_code_threshold(5, 0.5, 0.5)
    out = tmp_path / "wf.json"
    r = subprocess.run(
        [
            sys.executable, str(REPO / "scripts" / "waterfall.py"),
            "--m", "5", "--threshold", "0.5", "--cpu", "--batch", "128",
            "--max-frames", "256", "--target-errors", "50",
            "--snr-min", "4", "--snr-max", "10", "--snr-step", "2",
            "--no-throughput", "--out", str(out),
        ],
        capture_output=True, text=True, env=_env(), cwd=REPO, timeout=300,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    assert f"Polar(32, {expect.K})" in r.stderr
    data = json.loads(out.read_text())
    assert data["code_k"] == expect.K


def test_bench_refuses_cpu():
    """bench.py measures only on a GPU: on a CPU-only machine it exits
    non-zero and prints no metric."""
    r = subprocess.run([sys.executable, "bench.py"], capture_output=True,
                       text=True, env=_env(), cwd=REPO, timeout=300)
    assert r.returncode != 0
    assert "frames/s" not in r.stdout


def test_chip_smoke_refuses_cpu():
    """chip_smoke.py exits non-zero and prints no result without a GPU."""
    r = subprocess.run([sys.executable, "chip_smoke.py"], capture_output=True,
                       text=True, env=_env(), cwd=REPO, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_chip_smoke_alone_fails(tmp_path):
    """Copied alone into an empty directory, chip_smoke.py fails too."""
    import shutil

    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = _env()
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, "chip_smoke.py"], capture_output=True,
                       text=True, env=env, cwd=tmp_path, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_bench_help_importable():
    """bench.py must at least import and expose main() (a run needs a GPU)."""
    r = subprocess.run(
        [sys.executable, "-c",
         "import bench; assert callable(bench.main); print('ok')"],
        capture_output=True, text=True, env=_env(), cwd=REPO, timeout=120,
    )
    assert r.returncode == 0 and "ok" in r.stdout
