"""North-star benchmark: decoded frames/s on one GPU, Polar(1024,512) int8.

Prints ONE JSON line:
    {"metric": ..., "value": ..., "unit": "frames/s", "vs_baseline": ...,
     "decoder": ..., "platform": ..., "device_kind": ..., "device_count": ...}

The decoder is the one ``make_auto_decoder`` picks for the platform (named
in the output); there is no fallback. Without a GPU it exits non-zero and
prints no metric.

``vs_baseline`` divides by the unmodified AVX2 reference decoder's rate,
measured once on an earlier CPU host through the test oracle's ``bench``
command (reference decode loop timed like ``testbench.cc:170-174``):
Polar(1024, 512), random full-range int8 LLRs, best of repeated runs,
2,983,104 frames/s (g++ -O2 -march=native, 32 SIMD lanes). It is a CPU
number from that host, not a measurement of this run.

Measurement: decodes chained inside one jitted program with true data
dependencies, completion forced by a host scalar pull, time taken as the
slope between 1-iteration and n-iteration runs
(``polar_tpu/utils/benchmark.py``).
"""

import json
import sys

import numpy as np

AVX2_REFERENCE_FPS_N1024 = 2_983_104.0


def main() -> int:
    import jax
    import jax.numpy as jnp

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench: no GPU found (JAX platform {dev.platform!r})",
              file=sys.stderr)
        return 2

    import polar_tpu as pt
    from polar_tpu.utils.benchmark import measure_decode_fps
    from polar_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    code = pt.make_code(10, rate=0.5)
    batch = 32768
    rng = np.random.default_rng(42)
    llrs = jnp.asarray(rng.integers(-128, 128, (batch, code.N)).astype(np.int8))
    decoder, desc = pt.make_auto_decoder(code)
    fps = measure_decode_fps(decoder, llrs, iters=64)
    print(json.dumps({
        "metric": "decoded frames/s, Polar(1024,512) int8 Fast-SSC",
        "value": round(fps, 1),
        "unit": "frames/s",
        "vs_baseline": round(fps / AVX2_REFERENCE_FPS_N1024, 3),
        "decoder": desc,
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
