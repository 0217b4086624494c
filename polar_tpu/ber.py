"""Monte-Carlo BER/FER campaign harness.

The equivalent of the reference test bench's measurement loop
(``testbench.cc:105-221``): for each SNR point, run batches
of random frames through encode → AWGN → quantize → decode → compare, and
accumulate the same four diagnostic counters:

* ``awgn_errors``            — channel-induced sign flips (post-quantizer)
* ``quantization_erasures``  — LLRs quantized to exactly 0
* ``uncorrected_errors``     — decoded info bits disagreeing with the message
* ``ambiguity_erasures``     — decoded info bits equal to 0

One jitted step processes a whole frame batch (thousands of frames — the
analog of the reference's 32 SIMD lanes); the SNR sweep loop and
early-stop logic stay in Python. Every batch is a pure function of a PRNG
key, so campaigns are restartable and shard cleanly across devices (see
``polar_tpu.parallel.campaign``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np

from .channel import awgn_llrs, ebn0_db
from .code.construction import PolarCode, design_snr_db
from .decode.fastssc import make_fastssc_decoder
from .encode import encode, encode_systematic


@dataclass
class SnrPoint:
    snr_db: float
    ebn0_db: float
    frames: int
    bit_errors: int
    ber: float
    fer: float
    awgn_errors: int
    quantization_erasures: int
    ambiguity_erasures: int
    info_bits_per_sec: float  # decode-only throughput, Mbit/s * 1e6


@dataclass
class CampaignResult:
    code_n: int
    code_k: int
    systematic: bool
    points: list = field(default_factory=list)
    qef_snr_db: float = math.inf  # lowest SNR of the error-free tail
    peak_mbps: float = 0.0        # peak decode throughput, info Mbit/s
    seed: int | None = None       # PRNG seed (checkpoint-resume guard)

    def table(self) -> str:
        """4-column table matching ``testbench.cc:218`` (SNR BER Mbit/s Eb/N0)."""
        return "\n".join(
            f"{p.snr_db:.1f} {p.ber:g} {p.info_bits_per_sec / 1e6:.1f} {p.ebn0_db:g}"
            for p in self.points
        )


def default_decoder(code: PolarCode, *, systematic: bool = True,
                    dtype=jnp.int8, compute=None):
    """The step's decoder: int8 LLRs with no compute override take
    :func:`~polar_tpu.decode.auto.make_auto_decoder`'s choice for the
    current platform; other dtypes and compute modes the XLA decoder."""
    output = "systematic" if systematic else "u"
    if compute is None and jnp.dtype(dtype) == jnp.int8:
        from .decode.auto import make_auto_decoder

        return make_auto_decoder(code, output=output, output_dtype=dtype)[0]
    return make_fastssc_decoder(code, output=output, compute=compute,
                                output_dtype=dtype)


def make_step_body(code: PolarCode, *, systematic: bool = True, dtype=jnp.int8,
                   decoder=None, compute=None):
    """The unjitted Monte-Carlo step body: (key, snr_db, batch) → counters.

    Exposed separately so the sharded campaign can wrap it in ``shard_map``
    (one body per device shard, counters ``psum``-reduced); single-device
    callers use :func:`make_step` which simply jits it.

    One path on every platform: threefry draws the message bits and the
    noise, the XLA encoder builds the codeword, AWGN + quantize give the
    LLRs, the decoder runs, and XLA reduces the five counters. In
    systematic mode the decoder emits the systematic message directly
    (re-encode + info gather fused into the decode) — bit-exact with the
    reference's extraction (``testbench.cc:177-183``).

    ``decoder``: pin a decode function; by default
    :func:`default_decoder`.
    """
    enc = encode_systematic if systematic else encode
    if decoder is None:
        decoder = default_decoder(code, systematic=systematic, dtype=dtype,
                                  compute=compute)

    def step(key, snr_db, batch: int):
        kmsg, knoise = jax.random.split(key)
        with jax.named_scope("channel"):
            bits = jax.random.bernoulli(kmsg, 0.5, (batch, code.K))
            message = jnp.where(bits, jnp.asarray(-1, dtype),
                                jnp.asarray(1, dtype))
        with jax.named_scope("encode"):
            codeword = enc(code, message)
        with jax.named_scope("channel"):
            llrs = awgn_llrs(knoise, codeword, snr_db, dtype)
        with jax.named_scope("decode"):
            decoded = decoder(llrs)
        # counters in the bool domain — no (B, N)/(B, K) int32
        # intermediates. Exact equivalences for message/codeword in
        # {-1,+1} and decoded/llrs int8:
        #   decoded*message <= 0  ⟺  decoded==0 ∨ sign(decoded)≠sign(message)
        #   llrs*codeword   <  0  ⟺  llrs≠0 ∧ sign(llrs)≠sign(codeword)
        with jax.named_scope("counters"):
            zero_d = decoded == 0
            errs = zero_d | ((decoded < 0) != (message < 0))
            frame_err = jnp.any(errs, axis=-1)
            return {
                "uncorrected_errors": jnp.sum(errs, dtype=jnp.int32),
                "frame_errors": jnp.sum(frame_err, dtype=jnp.int32),
                "ambiguity_erasures": jnp.sum(zero_d, dtype=jnp.int32),
                "awgn_errors": jnp.sum(
                    (llrs != 0) & ((llrs < 0) != (codeword < 0)),
                    dtype=jnp.int32,
                ),
                "quantization_erasures": jnp.sum(llrs == 0, dtype=jnp.int32),
            }

    return step


def make_step(code: PolarCode, *, systematic: bool = True, dtype=jnp.int8,
              decoder=None, compute=None):
    """Build the jitted Monte-Carlo step: ``step(key, snr_db, batch)``.

    Counters come back as int32 device scalars and are accumulated into
    Python ints host-side, so campaign totals never overflow. The whole
    chain (message gen, encode, channel, decode, scoring) runs in one XLA
    program on device; ``snr_db`` is traced, so one compilation serves the
    entire waterfall sweep.
    """
    body = make_step_body(code, systematic=systematic, dtype=dtype,
                          decoder=decoder, compute=compute)
    return jax.jit(body, static_argnums=(2,))


def make_multi_step(code: PolarCode, *, systematic: bool = True,
                    dtype=jnp.int8, decoder=None, compute=None):
    """Build ``multi(key, snr_db, batch, steps)`` — ``steps`` Monte-Carlo
    steps chained on device (keys split inside a ``fori_loop``), counters
    accumulated and pulled ONCE. Amortizes the per-call dispatch +
    host-transfer latency (the campaign's analog of the benchmark's
    chained runner). Counter totals stay in int32: keep
    ``steps * batch * N < 2^31`` (asserted — the awgn/quantization
    diagnostics count over all N channel bits per frame, not just the K
    info bits, so N is the binding domain).
    """
    body = make_step_body(code, systematic=systematic, dtype=dtype,
                          decoder=decoder, compute=compute)

    def multi(key, snr_db, batch: int, steps: int):
        assert steps * batch * code.N < (1 << 31), \
            "int32 counter overflow risk: lower steps_per_call"

        def loop_body(_, carry):
            k, acc = carry
            k, sub = jax.random.split(k)
            out = body(sub, snr_db, batch)
            return k, {name: acc[name] + out[name] for name in acc}

        zeros = {name: jnp.int32(0) for name in (
            "uncorrected_errors", "frame_errors", "ambiguity_erasures",
            "awgn_errors", "quantization_erasures")}
        _, acc = jax.lax.fori_loop(0, steps, loop_body, (key, zeros))
        return acc

    return jax.jit(multi, static_argnums=(2, 3))


def run_point(
    code: PolarCode,
    snr_db: float,
    *,
    key,
    step=None,
    systematic: bool = True,
    dtype=jnp.int8,
    batch: int = 4096,
    max_frames: int = 1 << 16,
    target_bit_errors: int = 1000,
    decode_fn=None,
    measure_throughput: bool = False,
    steps_per_call: int = 1,
) -> SnrPoint:
    """Measure one SNR point, stopping once enough errors are seen
    (``testbench.cc:125``: errors >= 1000 or the frame budget is hit).

    ``steps_per_call`` > 1 chains that many Monte-Carlo steps on device
    per host round trip (``step`` must then be a
    :func:`make_multi_step` callable); the early-stop check runs at the
    coarser granularity.
    """
    if step is None:
        if steps_per_call > 1:
            step = make_multi_step(code, systematic=systematic, dtype=dtype)
        else:
            step = make_step(code, systematic=systematic, dtype=dtype)
    totals = {}
    frames = 0
    while frames < max_frames and totals.get("uncorrected_errors", 0) < target_bit_errors:
        key, sub = jax.random.split(key)
        if steps_per_call > 1:
            out = jax.device_get(step(sub, snr_db, batch, steps_per_call))
            frames += batch * steps_per_call
        else:
            out = jax.device_get(step(sub, snr_db, batch))
            frames += batch
        for k, v in out.items():
            totals[k] = totals.get(k, 0) + int(v)

    mbps = 0.0
    if measure_throughput and decode_fn is not None:
        mbps = measure_decode_throughput(code, decode_fn, snr_db, key, batch, dtype)

    bits = frames * code.K
    return SnrPoint(
        snr_db=snr_db,
        ebn0_db=ebn0_db(snr_db, code.rate),
        frames=frames,
        bit_errors=totals["uncorrected_errors"],
        ber=totals["uncorrected_errors"] / bits,
        fer=totals["frame_errors"] / frames,
        awgn_errors=totals["awgn_errors"],
        quantization_erasures=totals["quantization_erasures"],
        ambiguity_erasures=totals["ambiguity_erasures"],
        info_bits_per_sec=mbps,
    )


def measure_decode_throughput(code, decode_fn, snr_db, key, batch, dtype,
                              iters: int = 32, repeats: int = 3) -> float:
    """Decode-only throughput in info bits/s (compile excluded), the analog
    of the timed region at ``testbench.cc:170-174``. Uses the chained
    slope method (:mod:`polar_tpu.utils.benchmark`): decodes chained on
    device, completion forced by a host pull, dispatch constants cancelled.
    Keep ``repeats`` >= 2 so the cross-repeat slope-consistency check can
    reject a noisy slope."""
    from .utils.benchmark import measure_decode_fps

    k1, k2 = jax.random.split(key)
    bits = jax.random.bernoulli(k1, 0.5, (batch, code.K))
    message = jnp.where(bits, jnp.asarray(-1, dtype), jnp.asarray(1, dtype))
    llrs = awgn_llrs(k2, encode(code, message), snr_db, dtype)
    return measure_decode_fps(decode_fn, llrs, iters=iters,
                              repeats=repeats) * code.K


def run_campaign(
    code: PolarCode,
    *,
    seed: int = 0,
    systematic: bool = True,
    dtype=jnp.int8,
    batch: int = 4096,
    max_frames_per_point: int = 1 << 16,
    target_bit_errors: int = 1000,
    snr_range: tuple | None = None,
    snr_step: float = 0.1,
    stop_after_clean: int = 4,
    measure_throughput: bool = True,
    verbose: bool = False,
    compute=None,
    checkpoint_path=None,
    decoder=None,
    steps_per_call: int = 1,
) -> CampaignResult:
    """Full waterfall sweep with the reference's early-stop rule: finish
    after ``stop_after_clean`` consecutive error-free points
    (``testbench.cc:110,198-201``).

    With ``checkpoint_path``, the result JSON is rewritten after every SNR
    point and previously-completed points are reloaded on restart — each
    point is a pure function of its PRNG key, so a resumed campaign is
    identical to an uninterrupted one (SURVEY.md §5 checkpoint/resume).

    The decoder is built once and shared by the Monte-Carlo step and the
    decode-only throughput gauge.
    """
    design = design_snr_db(1.0 - code.rate)
    if snr_range is None:
        snr_range = (math.floor(design - 3), math.ceil(design + 5))
    if decoder is None:
        decoder = default_decoder(code, systematic=systematic, dtype=dtype,
                                  compute=compute)
    if steps_per_call > 1:
        step = make_multi_step(code, systematic=systematic, dtype=dtype,
                               compute=compute, decoder=decoder)
    else:
        step = make_step(code, systematic=systematic, dtype=dtype,
                         compute=compute, decoder=decoder)
    key = jax.random.PRNGKey(seed)
    result = CampaignResult(code_n=code.N, code_k=code.K,
                            systematic=systematic, seed=seed)
    done: dict = {}
    if checkpoint_path is not None:
        from .campaign_io import load_result, save_result

        prev = load_result(checkpoint_path)
        if (prev is not None
                and (prev.code_n, prev.code_k) == (code.N, code.K)
                and prev.systematic == systematic
                and prev.seed in (None, seed)):
            done = {round(p.snr_db, 6): p for p in prev.points}
    clean = 0
    snr = snr_range[0]
    mbps = None  # decode-only gauge, measured ONCE per campaign (below)
    while snr <= snr_range[1] + 1e-9 and clean < stop_after_clean:
        key, sub = jax.random.split(key)
        snr_r = round(snr, 6)
        if snr_r in done:
            point = done[snr_r]
        else:
            point = run_point(
                code, snr_r, key=sub, step=step, systematic=systematic,
                dtype=dtype, batch=batch, max_frames=max_frames_per_point,
                target_bit_errors=target_bit_errors,
                measure_throughput=False, steps_per_call=steps_per_call,
            )
            if measure_throughput:
                # Fast-SSC decode is data-independent (static shapes, no
                # data-dependent control flow), so the per-point Mb/s of
                # the reference's table (testbench.cc:218) is one number
                # here: measure it once, honestly (multi-repeat slope
                # consistency — see measure_decode_throughput), and stamp
                # it on every computed point.
                if mbps is None:
                    mbps = measure_decode_throughput(
                        code, decoder, snr_r, sub, batch, dtype)
                point.info_bits_per_sec = mbps
        result.points.append(point)
        result.peak_mbps = max(result.peak_mbps, point.info_bits_per_sec / 1e6)
        if point.bit_errors == 0:
            result.qef_snr_db = min(result.qef_snr_db, point.snr_db)
            clean += 1
        else:
            clean = 0
            result.qef_snr_db = math.inf
        if verbose:
            print(
                f"{point.snr_db:.1f} {point.ber:g} "
                f"{point.info_bits_per_sec / 1e6:.1f} {point.ebn0_db:g}",
                flush=True,
            )
        if checkpoint_path is not None:
            save_result(result, checkpoint_path)
        snr += snr_step
    return result
