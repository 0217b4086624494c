"""Multi-host campaign entry: jax.distributed + the sharded Monte-Carlo step.

The reference is strictly single-process (SURVEY.md §2); this is the
framework's multi-host campaign runner. Every process calls
:func:`initialize_multihost` with an explicit coordinator, builds the
global frame mesh over all GPUs of all processes, and runs the identical
SPMD program — BER counters are ``psum``-reduced (NCCL), so every host
observes the same totals and the sweep logic stays deterministic.
Single-process (possibly multi-GPU) runs work unchanged:
``initialize_multihost`` is a no-op when no coordinator is given. One
process drives every GPU it sees; never start two processes on one card.

Launch one command per host:

    python -m polar_tpu.parallel.multihost --m 15 --rate 0.5 \\
        --coordinator host0:1234 --num-processes 2 --process-id 0 \\
        --out results/n32768.json
"""

from __future__ import annotations

import argparse
import math
import os
import sys

import jax


def initialize_multihost(coordinator: str | None = None,
                         num_processes: int | None = None,
                         process_id: int | None = None) -> bool:
    """Initialize jax.distributed when a coordinator is given.

    Returns True when running multi-process. Without a coordinator
    address (argument or ``JAX_COORDINATOR_ADDRESS``) it leaves JAX in
    single-process mode. Nothing is autodetected: a multi-process run
    passes ``coordinator`` (``host:port``), ``num_processes`` and
    ``process_id`` explicitly.
    """
    coordinator = coordinator or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if coordinator is None:
        return False
    if num_processes is None or process_id is None:
        raise ValueError("a multi-process run needs num_processes and "
                         "process_id beside the coordinator address")
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
    )
    return True


def is_lead_host() -> bool:
    return jax.process_index() == 0


def run_multihost_campaign(code, *, seed=0, systematic=True, dtype=None,
                           per_device_batch=2048, max_global_frames=1 << 20,
                           target_bit_errors=1000, snr_range=None,
                           snr_step=0.1, stop_after_clean=4, verbose=True,
                           checkpoint_path=None):
    """SNR sweep over the full global device set.

    Identical control flow on every host (the sweep loop consumes only the
    psum-reduced, replicated counter totals, so all hosts take the same
    branches); only the lead host prints/writes.

    With ``checkpoint_path``, the lead host rewrites the result JSON after
    every SNR point; on restart the lead host reloads completed points and
    **broadcasts** them to all hosts (``multihost_utils``), so every host
    skips the same points and collective call sequences stay aligned even
    when non-lead hosts lack the checkpoint file.
    """
    import jax.numpy as jnp

    from ..ber import ebn0_db
    from ..code.construction import design_snr_db
    from .campaign import device_keys, make_sharded_step
    from .mesh import frame_mesh

    if dtype is None:
        dtype = jnp.int8
    design = design_snr_db(1.0 - code.rate)
    if snr_range is None:
        snr_range = (math.floor(design - 3), math.ceil(design + 5))
    mesh = frame_mesh()
    step, _ = make_sharded_step(code, mesh, systematic=systematic, dtype=dtype)
    n_dev = mesh.devices.size
    key = jax.random.PRNGKey(seed)

    done = _load_checkpoint_all_hosts(checkpoint_path, code, seed)

    points = []
    clean = 0
    snr = snr_range[0]
    while snr <= snr_range[1] + 1e-9 and clean < stop_after_clean:
        key, sub = jax.random.split(key)
        snr_r = round(snr, 6)
        if snr_r in done:
            frames, totals = done[snr_r]
        else:
            totals = {}
            frames = 0
            point_key = sub
            while (frames < max_global_frames
                   and totals.get("uncorrected_errors", 0) < target_bit_errors):
                point_key, batch_key = jax.random.split(point_key)
                out = jax.device_get(
                    step(device_keys(batch_key, mesh), snr_r,
                         per_device_batch)
                )
                frames += per_device_batch * n_dev
                for k, v in out.items():
                    totals[k] = totals.get(k, 0) + int(v)
        ber = totals["uncorrected_errors"] / (frames * code.K)
        points.append({
            "snr_db": snr_r,
            "ebn0_db": ebn0_db(snr, code.rate),
            "frames": frames,
            "bit_errors": totals["uncorrected_errors"],
            "frame_errors": totals["frame_errors"],
            "ber": ber,
            "fer": totals["frame_errors"] / frames,
        })
        clean = clean + 1 if totals["uncorrected_errors"] == 0 else 0
        if verbose and is_lead_host():
            print(f"{snr:.1f} {ber:g} - {ebn0_db(snr, code.rate):g}",
                  flush=True)
        if checkpoint_path is not None and is_lead_host():
            _save_checkpoint(checkpoint_path, code, seed, points)
        snr += snr_step
    return points


def _save_checkpoint(path, code, seed, points) -> None:
    """Atomic JSON checkpoint (lead host only)."""
    import json

    tmp = str(path) + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"code_n": code.N, "code_k": code.K, "seed": seed,
                   "points": points}, f, indent=1)
    os.replace(tmp, str(path))


def _load_checkpoint_all_hosts(path, code, seed):
    """{snr: (frames, counter totals)} of completed points, identical on
    every host.

    Only the lead host reads the file; the completed-point data rides a
    ``broadcast_one_to_all`` (count first, then a fixed-shape row array) so
    hosts without the file still skip the same points — otherwise the
    collective call sequence would diverge and the pod would hang.
    """
    if path is None:
        return {}
    import json

    import numpy as np
    from jax.experimental import multihost_utils

    rows = np.zeros((0, 4), dtype=np.float64)
    if is_lead_host() and os.path.exists(str(path)):
        try:
            with open(str(path)) as f:
                prev = json.load(f)
            if (prev.get("code_n"), prev.get("code_k")) == (code.N, code.K) \
                    and prev.get("seed") in (None, seed):
                rows = np.asarray(
                    [[p["snr_db"], p["frames"], p["bit_errors"],
                      p["frame_errors"]] for p in prev.get("points", [])],
                    dtype=np.float64,
                ).reshape(-1, 4)
        except (OSError, ValueError, KeyError):
            rows = np.zeros((0, 4), dtype=np.float64)
    if jax.process_count() > 1:
        count = int(multihost_utils.broadcast_one_to_all(
            np.int32(rows.shape[0])))
        if count == 0:
            return {}
        if not is_lead_host():
            rows = np.zeros((count, 4), dtype=np.float64)
        rows = np.asarray(multihost_utils.broadcast_one_to_all(rows))
    return {
        round(float(r[0]), 6): (
            int(r[1]),
            {"uncorrected_errors": int(r[2]), "frame_errors": int(r[3])},
        )
        for r in rows
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--m", type=int, default=15)
    ap.add_argument("--rate", type=float, default=0.5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--per-device-batch", type=int, default=2048)
    ap.add_argument("--max-global-frames", type=int, default=1 << 20)
    ap.add_argument("--target-errors", type=int, default=1000)
    ap.add_argument("--snr-min", type=float, default=None)
    ap.add_argument("--snr-max", type=float, default=None)
    ap.add_argument("--snr-step", type=float, default=0.1)
    ap.add_argument("--out", type=str, default=None)
    ap.add_argument("--checkpoint", type=str, default=None,
                    help="JSON checkpoint path (lead host writes after "
                         "every SNR point; completed points are skipped "
                         "on restart)")
    ap.add_argument("--coordinator", type=str, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--num-processes", type=int, default=None)
    args = ap.parse_args()

    import polar_tpu as pt
    from ..utils.cache import enable_compilation_cache

    enable_compilation_cache()
    multi = initialize_multihost(args.coordinator, args.num_processes,
                                 args.process_id)
    if is_lead_host():
        print(f"devices: {len(jax.devices())} "
              f"({jax.process_count()} processes, multihost={multi})",
              file=sys.stderr)
    code = pt.make_code(args.m, rate=args.rate)
    snr_range = None
    if args.snr_min is not None and args.snr_max is not None:
        snr_range = (args.snr_min, args.snr_max)
    points = run_multihost_campaign(
        code, seed=args.seed, per_device_batch=args.per_device_batch,
        max_global_frames=args.max_global_frames,
        target_bit_errors=args.target_errors,
        snr_range=snr_range, snr_step=args.snr_step,
        checkpoint_path=args.checkpoint,
    )
    if args.out and is_lead_host():
        import json

        with open(args.out, "w") as f:
            json.dump({"code_n": code.N, "code_k": code.K, "points": points}, f,
                      indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
