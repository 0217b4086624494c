#!/usr/bin/env python
"""Reproduce the reference's published ber_log.png curve set.

"Comparing various systematic and non-systematic rate-1/2 code lengths"
(`README.md:22-24`): one BER waterfall per (N, mode)
pair. Each campaign checkpoints to results/, so the sweep is resumable;
the combined plot is rewritten after every completed campaign.

  python scripts/curve_set.py                       # default M set
  python scripts/curve_set.py --ms 6 10 14 --plot results/ber_log.png
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--ms", type=int, nargs="+", default=[6, 8, 10, 12, 14])
    ap.add_argument("--rate", type=float, default=0.5)
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--max-frames", type=int, default=1 << 14)
    ap.add_argument("--target-errors", type=int, default=1000)
    ap.add_argument("--snr-step", type=float, default=0.2)
    ap.add_argument("--outdir", type=str, default="results")
    ap.add_argument("--plot", type=str, default="results/ber_log.png")
    ap.add_argument("--steps-per-call", type=int, default=1)
    ap.add_argument("--tag-suffix", type=str, default="",
                    help="append to checkpoint names (fresh files for a "
                         "deeper re-run without clobbering published ones)")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()

    import jax

    from polar_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    import polar_tpu as pt
    from polar_tpu.campaign_io import plot_waterfall

    outdir = Path(args.outdir)
    outdir.mkdir(exist_ok=True)
    results = []
    for m in args.ms:
        for systematic in (True, False):
            tag = (f"n{1 << m}_{'sys' if systematic else 'nonsys'}_int8"
                   f"{args.tag_suffix}")
            ckpt = outdir / f"{tag}.json"
            print(f"=== {tag} ===", file=sys.stderr, flush=True)
            code = pt.make_code(m, rate=args.rate)
            batch = min(args.batch, max(512, (1 << 22) // code.N))
            res = pt.run_campaign(
                code,
                systematic=systematic,
                batch=batch,
                max_frames_per_point=args.max_frames,
                target_bit_errors=args.target_errors,
                snr_step=args.snr_step,
                measure_throughput=False,
                verbose=True,
                checkpoint_path=ckpt,
                steps_per_call=args.steps_per_call,
            )
            results.append(res)
            plot_waterfall(
                results, args.plot,
                title="polar-tpu BER waterfalls, rate-1/2",
            )
    print(f"curve set complete: {len(results)} campaigns, plot at {args.plot}",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
