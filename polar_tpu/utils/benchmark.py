"""On-device throughput measurement.

JAX dispatches asynchronously, so a timing must end in a host pull. The
meters here chain the work inside one jitted program and take a slope:

* ``iters`` decodes are chained **inside one jitted program** via
  ``lax.fori_loop``, each iteration's input perturbed by the previous
  iteration's output (a true data dependency — nothing can be elided or
  hoisted); the iteration count is a traced argument, so one compile
  serves every count the meter tries;
* completion is forced by pulling a scalar checksum to the host;
* the reported time is the **slope** between a 1-iteration and an
  n-iteration run, cancelling dispatch/transfer constants.

This is the analog of the reference's timed decode region
(``testbench.cc:170-174``).
"""

from __future__ import annotations

import time

import jax
import jax.numpy as jnp


def chained_decode_runner(decode_fn, n_out_pad):
    """Build the jitted ``runner(x, iters)`` of :func:`measure_decode_fps`:
    a ``fori_loop`` of ``iters`` (traced) data-dependent decodes → an int32
    checksum."""

    def runner(x, iters):
        def body(_, carry):
            out = decode_fn(carry)
            # fold the (B, K) output back into the (B, N) input: pad the
            # message with zeros and add (int8 wraparound / float add both
            # fine — only the data dependency matters).
            delta = jnp.pad(out, ((0, 0), (0, n_out_pad))).astype(carry.dtype)
            return carry + delta

        y = jax.lax.fori_loop(0, iters, body, x)
        return jnp.sum(y.astype(jnp.int32))

    return jax.jit(runner)


def measure_decode_fps(decode_fn, llrs, *, iters: int = 16, warmup: bool = True,
                       repeats: int = 3, max_iters: int = 4096,
                       n_devices: int = 1,
                       max_rel_spread: float = 0.25) -> float:
    """Frames/s of ``decode_fn`` on the batch ``llrs`` ((B, N) → (B, K)).

    If the n-iteration run isn't clearly slower than the 1-iteration run
    (dispatch/transfer noise swamping a tiny workload), or the slope is
    inconsistent across repeats (timer noise), the iteration count is
    grown geometrically until the measurement is resolvable.

    Acceptance requires BOTH (checked across ALL ``repeats``, not a lucky
    pair): the chained work dominates the per-call constant
    (``best_slope * (iters-1) > 3 * median(t1)``), and with ``repeats>1``
    the slope spread ``(max-min)/min <= max_rel_spread``.

    ``n_devices``: for decoders running over a multi-device mesh (e.g. a
    ``shard_map`` frame-DP decode where ``B`` is the global batch), pass
    ``mesh.devices.size`` to get **frames/s per device** — the
    cross-hardware comparable number. Default 1 returns global frames/s.

    Multi-process safe: with ``jax.process_count() > 1`` every process
    must execute the same device programs in the same order (the runner
    contains cross-process collectives), so the accept/grow decision and
    the reported slope are the LEAD host's, broadcast to all — otherwise
    divergent local timings would desynchronize the adaptive loop and
    deadlock the cluster. All hosts therefore return the same number.
    """
    b, n = llrs.shape
    k = jax.eval_shape(decode_fn, llrs).shape[-1]  # no eager dispatch
    runner = chained_decode_runner(decode_fn, n - k)

    def timed(it):
        t0 = time.perf_counter()
        int(runner(llrs, it))  # host pull forces completion
        return time.perf_counter() - t0

    slope = _slope_seconds_per_iter(timed, iters, warmup=warmup,
                                    repeats=repeats, max_iters=max_iters,
                                    max_rel_spread=max_rel_spread)
    return b / slope / n_devices


def _slope_seconds_per_iter(timed, iters, *, warmup=True, repeats=3,
                            max_iters=4096, max_rel_spread=0.25) -> float:
    """The adaptive chained-slope core shared by the meters: ``timed(it)``
    runs an it-iteration chained program and returns wall seconds; the
    accepted per-iteration slope must dominate the per-call constant AND
    be consistent across repeats, else the iteration count grows
    geometrically. Lead-host-synchronized under multi-process (see
    :func:`measure_decode_fps`)."""
    multiproc = jax.process_count() > 1
    if warmup:
        timed(1)
        timed(iters)
    while True:
        slopes, t1s = [], []
        for _ in range(repeats):
            t1 = timed(1)
            tn = timed(iters)
            t1s.append(t1)
            slopes.append((tn - t1) / (iters - 1))
        best = min(slopes)
        t1s.sort()
        t1_med = t1s[len(t1s) // 2]
        # chained work must dominate the per-call constant, consistently
        dominates = best > 0 and best * (iters - 1) > 3 * abs(t1_med)
        consistent = (len(slopes) < 2
                      or (max(slopes) - best) <= max_rel_spread * best)
        accepted = dominates and consistent
        if multiproc:
            import numpy as np
            from jax.experimental import multihost_utils

            best, accepted = multihost_utils.broadcast_one_to_all(
                np.asarray([best, 1.0 if accepted else 0.0], np.float64))
            best, accepted = float(best), bool(accepted)
        if accepted:
            return best
        if iters >= max_iters:
            if best <= 0:
                raise RuntimeError(
                    f"throughput not resolvable: slope {best:.3g}s/iter at "
                    f"{iters} iters (workload too small vs dispatch noise)"
                )
            return best
        iters = min(iters * 4, max_iters)


def measure_step_rate(step_body, key, snr_db, batch: int, *, iters: int = 16,
                      warmup: bool = True, repeats: int = 3,
                      max_iters: int = 4096,
                      max_rel_spread: float = 0.25) -> float:
    """Frames/s of the FULL Monte-Carlo step (message gen + encode +
    AWGN + decode + counters) — the end-to-end campaign rate, vs
    :func:`measure_decode_fps`'s decode-only rate; the gap between the
    two is the chain overhead a fused step would recover.

    ``step_body`` is the unjitted body from
    :func:`polar_tpu.ber.make_step_body`. Iterations are chained through
    the PRNG key split sequence (a true data dependency) inside one
    jitted ``fori_loop``, counters are accumulated and pulled to the
    host, and the same hardened slope acceptance applies.
    """

    def runner(k0, it):
        def body(_, carry):
            k, acc = carry
            k, sub = jax.random.split(k)
            out = step_body(sub, snr_db, batch)
            return k, acc + out["uncorrected_errors"]

        _, acc = jax.lax.fori_loop(0, it, body, (k0, jnp.int32(0)))
        return acc

    runner = jax.jit(runner)

    def timed(it):
        t0 = time.perf_counter()
        int(runner(key, it))  # host pull forces completion
        return time.perf_counter() - t0

    slope = _slope_seconds_per_iter(timed, iters, warmup=warmup,
                                    repeats=repeats, max_iters=max_iters,
                                    max_rel_spread=max_rel_spread)
    return batch / slope
