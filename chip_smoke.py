#!/usr/bin/env python
"""Smoke run of polar-tpu on NVIDIA GPUs, through the public entry points.

    python chip_smoke.py            # one card: decode, step, campaign
    python chip_smoke.py --multi    # only the frame-parallel phase, over
                                    # every visible GPU

One card, at the reference testbench's job Polar(16384, 8192) systematic
int8 (m=14, batch 4096) and at Polar(1024, 512) (m=10, batch 32768):

1. the decoder ``make_auto_decoder`` picks, for ``u`` and ``systematic``
   output: a bit-exact check against the XLA decoder run on the CPU on the
   same random full-range int8 batch, and frames/s; the frozen golden
   vectors of both codes; the ``compute="float32"`` decoder on
   integer-valued LLRs, bit-exact against the CPU as well;
2. the Monte-Carlo step (``make_step``): counters, ``memory_analysis()``
   at m=14, frames/s, and one profiler trace of the m=14 step split into
   its layers (channel, encode, decode, counters);
3. a short ``run_campaign`` on Polar(16384, 8192) at three SNR points of
   its waterfall, whose BER must agree with ``results/n16384_sys_int8.json``
   within 3 sigma.

Every program of a phase is lowered first and then compiled side by side
in threads (a cold compile of the unrolled m=14 tree takes minutes), and
each compile time is printed. The campaign's step is the same program as
phase 2's, so it comes from the compile cache. Rates come from
back-to-back calls of one compiled program (slope between 2 and 10
calls). Any failed check raises, so the exit code is non-zero. Without a
GPU it exits non-zero before any phase. The last line of standard output
is one JSON object: ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parent
SCOPES = ("channel", "encode", "decode", "counters")


def log(msg: str) -> None:
    print(msg, flush=True)


def compile_all(jobs: dict) -> dict:
    """Compile every ``jax.stages.Lowered`` of ``jobs`` ({label: lowered})
    in parallel threads (XLA releases the GIL while it compiles); returns
    {label: compiled} and prints each compile time and the wall time."""

    def one(label):
        t0 = time.perf_counter()
        exe = jobs[label].compile()
        return exe, time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=min(len(jobs), 8)) as pool:
        done = dict(zip(jobs, pool.map(one, jobs)))
    for label, (_, secs) in done.items():
        log(f"compile {label}: {secs:.2f} s")
    log(f"compile {len(jobs)} programs side by side: "
        f"{time.perf_counter() - t0:.2f} s wall")
    return {label: exe for label, (exe, _) in done.items()}


def calls_per_second(call, lo: int = 2, hi: int = 10,
                     repeats: int = 3) -> float:
    """Calls/s of ``call(i)`` dispatched back to back: the slope between
    ``lo`` and ``hi`` queued calls, best of ``repeats``, each ending in
    ``block_until_ready`` on every output."""
    import jax

    def run(n):
        t0 = time.perf_counter()
        jax.block_until_ready([call(i) for i in range(n)])
        return time.perf_counter() - t0

    run(lo)
    slope = min((run(hi) - run(lo)) / (hi - lo) for _ in range(repeats))
    if slope <= 0:
        raise RuntimeError(f"unresolvable rate (slope {slope:.3g} s)")
    return 1.0 / slope


def on_cpu(shape, dtype):
    """An abstract argument placed on the CPU device (the reference)."""
    import jax

    return jax.ShapeDtypeStruct(shape, dtype, sharding=jax.sharding.
                                SingleDeviceSharding(jax.devices("cpu")[0]))


def check_equal(label: str, got, want) -> None:
    import numpy as np

    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape or not np.array_equal(got, want):
        bad = int(np.sum(got != want)) if got.shape == want.shape else -1
        raise AssertionError(f"{label}: GPU output differs from the "
                             f"reference ({bad} elements, shapes "
                             f"{got.shape} vs {want.shape})")
    log(f"check {label}: bit-exact ({got.shape[0]} frames)")


def lower_single(pt, codes, rng):
    """Lower every program of the one-card phases; returns (jobs, inputs)
    with ``inputs[m] = (code, int8 LLR batch)``."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    t0 = time.perf_counter()
    jobs, inputs = {}, {}
    key = jax.random.PRNGKey(0)
    for m, batch in codes:
        code = pt.make_code(m, rate=0.5)
        llr = rng.integers(-128, 128, (batch, code.N), dtype=np.int8)
        inputs[m] = (code, llr)
        arg = jax.ShapeDtypeStruct(llr.shape, jnp.int8)
        for output in ("u", "systematic"):
            dec, desc = pt.make_auto_decoder(code, output=output)
            jobs[f"decode m={m} {output} [{desc}] batch={batch}"] = (
                jax.jit(dec).lower(arg))
        jobs[f"step m={m} batch={batch}"] = (
            pt.make_step(code).lower(key, 0.0, batch))
        # one CPU program serves both outputs: u and the re-encoded codeword
        jobs[f"cpu reference m={m} batch={batch}"] = jax.jit(
            pt.make_fastssc_decoder(code, output="both",
                                    output_dtype=jnp.int8)).lower(
            on_cpu(llr.shape, jnp.int8))
    code = pt.make_code(10, rate=0.5)
    shape = (1021, code.N)
    jobs["decode m=10 u float32"] = jax.jit(pt.make_fastssc_decoder(
        code, compute="float32")).lower(
        jax.ShapeDtypeStruct(shape, jnp.float32))
    jobs["cpu reference m=10 u float32"] = jax.jit(pt.make_fastssc_decoder(
        code, compute="float32")).lower(on_cpu(shape, jnp.float32))
    log(f"lower {len(jobs)} programs: {time.perf_counter() - t0:.2f} s")
    return jobs, inputs


def phase_decode(exe, inputs) -> dict:
    """Bit-exactness against the CPU and frames/s; returns
    {m: (compiled u decoder, batch, code)} for the golden phase."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    kept = {}
    cpu = jax.devices("cpu")[0]
    for m, (code, llr) in inputs.items():
        batch = llr.shape[0]
        u_ref, cw_ref = jax.tree.map(np.asarray, exe[
            f"cpu reference m={m} batch={batch}"](jax.device_put(llr, cpu)))
        want = {"u": u_ref, "systematic": cw_ref[:, code.info_indices]}
        llrs = jnp.asarray(llr)
        for label, dec in exe.items():
            if not label.startswith(f"decode m={m} ") or "float32" in label:
                continue
            output = label.split()[2]
            check_equal(f"decode m={m} {output} vs CPU XLA", dec(llrs),
                        want[output])
            fps = batch * calls_per_second(lambda i: dec(llrs))
            log(f"{label}: {fps:.1f} frames/s")
            if output == "u":
                kept[m] = (dec, batch, code)
    return kept


def phase_golden(kept: dict):
    """The kept decoders against the frozen reference decodes (u output)
    of their own codes, Polar(1024, 512) and Polar(16384, 8192), each
    golden batch padded to the compiled batch. No new program is compiled
    here (the other golden codes are checked on the CPU by the tests)."""
    import jax.numpy as jnp
    import numpy as np

    with np.load(REPO / "tests" / "vectors" / "golden.npz") as z:
        vec = dict(z.items())
    n, ms = 0, []
    for m, (dec, batch, code) in sorted(kept.items()):
        rk = [k.split("_")[2] for k in vec if k.startswith(f"mask_{m}_")
              and np.array_equal(vec[k], code.frozen)]
        if len(rk) != 1:
            raise AssertionError(f"no golden vectors for the m={m} code")
        i = 0
        while f"llr_{m}_{rk[0]}_{i}" in vec:
            llr = vec[f"llr_{m}_{rk[0]}_{i}"]
            rows = llr.shape[0]
            llr = np.pad(llr, ((0, batch - rows), (0, 0)))
            got = np.asarray(dec(jnp.asarray(llr)))[:rows]
            if not np.array_equal(got, vec[f"dec_{m}_{rk[0]}_{i}"]):
                raise AssertionError(f"golden decode m={m} batch={i} "
                                     "differs")
            i += 1
        n += i
        ms.append(str(m))
    log(f"check golden vectors: {n} batches bit-exact (m={','.join(ms)})")


def phase_float32(exe, rng):
    """compute="float32" on integer-valued LLRs: every sum is exact, so
    the GPU must equal the CPU bit for bit."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    llr = rng.integers(-128, 128, (1021, 1024)).astype(np.float32)
    want = exe["cpu reference m=10 u float32"](
        jax.device_put(llr, jax.devices("cpu")[0]))
    check_equal("decode m=10 u float32 vs CPU XLA",
                exe["decode m=10 u float32"](jnp.asarray(llr)), want)


def phase_step(exe, codes):
    import jax

    from polar_tpu.utils.profiling import layer_breakdown, trace

    key = jax.random.PRNGKey(0)
    keys = jax.random.split(key, 10)
    for m, batch in codes:
        step = exe[f"step m={m} batch={batch}"]
        out = step(key, 0.0)
        log(f"step m={m} counters at 0 dB: "
            f"{ {k: int(v) for k, v in out.items()} }")
        rate = batch * calls_per_second(lambda i: step(keys[i], 0.0))
        log(f"step m={m} batch={batch}: {rate:.1f} frames/s")
        if m != 14:
            continue
        log(f"memory_analysis step m={m} batch={batch}: "
            f"{step.memory_analysis()}")
        tdir = REPO / "chiprun_out" / f"smoke_trace_m{m}"
        with trace(str(tdir)):
            jax.block_until_ready([step(keys[i], 0.0) for i in range(3)])
        pb = sorted(tdir.glob("plugins/profile/*/*.xplane.pb"))[-1]
        res = layer_breakdown(str(pb), step.as_text(), SCOPES)
        busy = res["busy_ns"]
        shares = ", ".join(f"{k} {v / busy:.1%}" for k, v in
                           sorted(res["by_scope_ns"].items()))
        log(f"trace step m={m}, 3 queued steps: device busy "
            f"{busy / 3e6:.3f} ms per step, idle share "
            f"{res['idle_share']:.1%}, {res['kernels']} kernels; "
            f"share of busy time: {shares}")


def phase_campaign(pt, min_frame_errors: int = 100):
    """Three waterfall points of Polar(16384, 8192) against the record.

    Bit errors arrive in bursts, one burst per failed frame, so the
    binomial count behind a BER estimate is the number of failed frames:
    sigma(BER) = BER / sqrt(frame errors). Each compared point needs
    ``min_frame_errors`` failed frames on both sides, so the points are
    those where the record has them (-1.8 to -1.4 dB)."""
    record = json.loads((REPO / "results" / "n16384_sys_int8.json")
                        .read_text())
    ref = {round(p["snr_db"], 6): p for p in record["points"]}
    code = pt.make_code(14, rate=0.5)
    t0 = time.perf_counter()
    res = pt.run_campaign(code, batch=4096, snr_range=(-1.8, -1.4),
                          snr_step=0.2, max_frames_per_point=16384,
                          target_bit_errors=20000, stop_after_clean=4,
                          measure_throughput=False, verbose=False)
    log(f"campaign Polar(16384,8192): {len(res.points)} points in "
        f"{time.perf_counter() - t0:.2f} s (step from the compile cache)")
    if len(res.points) != 3:
        raise AssertionError(f"campaign ran {len(res.points)} points, not 3")
    for p in res.points:
        r = ref[round(p.snr_db, 6)]
        ferr = round(p.fer * p.frames)
        rerr = round(r["fer"] * r["frames"])
        sigma = math.hypot(p.ber / math.sqrt(max(ferr, 1)),
                           r["ber"] / math.sqrt(max(rerr, 1)))
        dev = abs(p.ber - r["ber"]) / sigma
        log(f"campaign {p.snr_db:.1f} dB: BER {p.ber:.6g} ({p.bit_errors} "
            f"bit errors, {ferr} frame errors in {p.frames} frames) vs "
            f"record {r['ber']:.6g} ({r['bit_errors']} bit errors, {rerr} "
            f"frame errors in {r['frames']} frames): {dev:.2f} sigma")
        if min(ferr, rerr) < min_frame_errors:
            raise AssertionError(f"{p.snr_db} dB: fewer than "
                                 f"{min_frame_errors} frame errors")
        if dev > 3.0:
            raise AssertionError(f"{p.snr_db} dB: BER off the record by "
                                 f"{dev:.2f} sigma")


def phase_multi(pt, rng, sizes=((10, 32768), (14, 4096)), enc_m=14,
                dec_m=10):
    """Frame-parallel campaign step and decode meter on every visible GPU,
    and the element-sharded encoder/decoder, each against its local twin.

    The meter's program is compiled with the rest, so its own compile
    comes from the compile cache."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from polar_tpu.parallel.campaign import (device_keys, global_llr_batch,
                                             make_sharded_step,
                                             measure_sharded_decode_fps)
    from polar_tpu.parallel.mesh import frame_mesh
    from polar_tpu.parallel.seqpar import element_mesh, make_sharded_encoder
    from polar_tpu.parallel.seqpar_decode import make_seqpar_decoder
    from polar_tpu.utils.benchmark import chained_decode_runner

    devices = jax.devices()
    mesh = frame_mesh(devices)
    where = f"{len(devices)} {devices[0].platform} devices"
    t0 = time.perf_counter()
    jobs, steps = {}, {}
    for m, per_dev in sizes:
        code = pt.make_code(m, rate=0.5)
        step, _ = make_sharded_step(code, mesh)
        keys = device_keys(jax.random.PRNGKey(7 + m), mesh)
        snr = -1.4 if m == 14 else 1.0
        steps[m] = (keys, snr)
        jobs[f"sharded step m={m} batch={per_dev} per device"] = (
            step.lower(keys, snr, per_dev))
        jobs[f"step m={m} batch={per_dev} (per-key reference)"] = (
            pt.make_step(code).lower(jax.random.PRNGKey(0), snr, per_dev))
        llrs = global_llr_batch(code, mesh, per_device_batch=per_dev)
        dec, _ = pt.make_auto_decoder(code, output_dtype=jnp.int8)
        jobs[f"sharded decode meter m={m} batch={per_dev} per device"] = (
            chained_decode_runner(dec, code.N - code.K).lower(llrs, 1))
    emesh = element_mesh(devices)
    code = pt.make_code(enc_m, rate=0.5)
    msg = jnp.asarray((1 - 2 * rng.integers(0, 2, (64, code.K))).astype(
        np.int8))
    jobs[f"element-sharded encoder m={enc_m}"] = jax.jit(
        make_sharded_encoder(code, emesh)).lower(msg)
    dcode = pt.make_code(dec_m, rate=0.5)
    llr = rng.integers(-128, 128, (64, dcode.N)).astype(np.int8)
    jobs[f"element-sharded decoder m={dec_m}"] = jax.jit(make_seqpar_decoder(
        dcode, emesh, output="u")).lower(jnp.asarray(llr))
    jobs[f"cpu reference m={dec_m} batch=64"] = jax.jit(
        pt.make_fastssc_decoder(dcode, output_dtype=jnp.int8)).lower(
        on_cpu(llr.shape, jnp.int8))
    log(f"lower {len(jobs)} programs: {time.perf_counter() - t0:.2f} s")
    exe = compile_all(jobs)

    for m, per_dev in sizes:
        keys, snr = steps[m]
        got = {k: int(v) for k, v in jax.device_get(exe[
            f"sharded step m={m} batch={per_dev} per device"](
            keys, snr)).items()}
        body = exe[f"step m={m} batch={per_dev} (per-key reference)"]
        want: dict = {}
        for row in np.asarray(jax.device_get(keys)):
            for k, v in jax.device_get(body(jnp.asarray(row), snr)).items():
                want[k] = want.get(k, 0) + int(v)
        if got != want or got["uncorrected_errors"] == 0:
            raise AssertionError(f"sharded step m={m}: {got} != {want}")
        log(f"check sharded step m={m} over {where}: psum counters "
            f"equal the per-key sums {got}")

    check_equal(f"element-sharded encoder m={enc_m}",
                exe[f"element-sharded encoder m={enc_m}"](msg),
                pt.encode_systematic(code, msg))
    u = exe[f"element-sharded decoder m={dec_m}"](jnp.asarray(llr))
    check_equal(f"element-sharded decoder m={dec_m} (ppermute) vs CPU XLA",
                np.asarray(u).astype(np.int8),
                exe[f"cpu reference m={dec_m} batch=64"](
                    jax.device_put(llr, jax.devices("cpu")[0])))

    for m, per_dev in sizes:
        t0 = time.perf_counter()
        fps = measure_sharded_decode_fps(pt.make_code(m, rate=0.5), mesh,
                                         per_device_batch=per_dev)
        log(f"sharded decode m={m} batch={per_dev} per device: {fps:.1f} "
            f"frames/s per device ({where}; meter took "
            f"{time.perf_counter() - t0:.2f} s)")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--multi", action="store_true",
                    help="run only the multi-GPU phase (all visible GPUs)")
    ap.add_argument("--codes", type=int, nargs="+", choices=(10, 14),
                    default=(10, 14),
                    help="with --multi: the codes to run, by m (default: "
                         "10 14)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: no GPU found (JAX platform {dev.platform!r}); "
              "this script runs only on an NVIDIA GPU", file=sys.stderr)
        return 2

    import numpy as np

    import polar_tpu as pt
    from polar_tpu.utils.cache import enable_compilation_cache

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    for line in smi.stdout.strip().splitlines():
        log(line.strip())
    log(f"jax {jax.__version__}, devices: {len(jax.devices())} x "
        f"{dev.device_kind}")
    log(f"compile cache: {enable_compilation_cache()}")
    rng = np.random.default_rng(args.seed)
    codes = ((10, 32768), (14, 4096))
    t0 = time.perf_counter()
    if args.multi:
        phase_multi(pt, rng, sizes=tuple(c for c in codes
                                         if c[0] in args.codes))
    else:
        jobs, inputs = lower_single(pt, codes, rng)
        exe = compile_all(jobs)
        kept = phase_decode(exe, inputs)
        phase_golden(kept)
        phase_float32(exe, rng)
        phase_step(exe, codes)
        phase_campaign(pt)
    log(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
