"""Freeze oracle-independent golden vectors into tests/vectors/golden.npz.

Run where ``/root/reference`` is mounted (it drives the reference oracle);
the frozen vectors then let the parity suite (tests/test_golden_vectors.py)
run green in environments WITHOUT the reference — the portable analog of
the testbench's self-checking role (``testbench.cc:143-146``).

Contents per (m, rate) config:
  mask_<m>_<rk>            frozen mask from the testbench construction recipe
  prog_<m>_<rk>            Fast-SSC byte program for that mask
  enc_msg/enc_sys/enc_nonsys_<m>_<rk>   (W, K) messages and their codewords
  llr/dec_<m>_<rk>_<i>     int8 LLR batches (incl. -128/-127/127 saturation
                           edges) and the reference's decoded messages
  fllr/fdec_<m>_<rk>       float32 LLR batch and reference float decode

Usage: python scripts/freeze_vectors.py  (writes tests/vectors/golden.npz)
"""

import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tests"))

import oracle  # noqa: E402

import polar_tpu as pt  # noqa: E402

OUT = REPO / "tests" / "vectors" / "golden.npz"


def edge_llrs(rng, w, n, i):
    """Saturation-edge LLR batches: the int8 corner cases that gate the
    -127 guards and tie rules."""
    if i == 0:
        return rng.integers(-128, 128, (w, n)).astype(np.int8)
    if i == 1:
        return np.full((w, n), -128, np.int8)
    if i == 2:
        x = rng.choice(np.array([-128, -127, 0, 126, 127], np.int8), (w, n))
        return x.astype(np.int8)
    # alternating extremes with a random sprinkle
    x = np.where(np.arange(n) % 2 == 0, -128, 127)[None, :].repeat(w, 0)
    mask = rng.random((w, n)) < 0.1
    x = np.where(mask, rng.integers(-128, 128, (w, n)), x)
    return x.astype(np.int8)


def main():
    rng = np.random.default_rng(20260817)
    w = oracle.width()
    wf = oracle.widthf()
    data = {"width": np.int64(w), "widthf": np.int64(wf)}
    configs = [(m, r) for m in range(2, 11)
               for r in ((0.5,) if m < 6 else (0.25, 0.5, 0.75))]
    configs += [(11, 0.5), (12, 0.5)]  # large-m spot checks (2 batches each)
    configs += [(13, 0.5), (14, 0.5)]  # frontier spot checks (1 batch each)
    for m, rate in configs:
        n = 1 << m
        k = int(rate * n)
        rk = str(int(rate * 100))
        code = pt.make_code(m, K=k)
        # construction parity is asserted at freeze time, then the mask is
        # the stored ground truth
        np.testing.assert_array_equal(
            code.frozen, oracle.freezek(m, k, _testbench_pe(rate)))
        data[f"mask_{m}_{rk}"] = np.asarray(code.frozen, np.uint8)
        data[f"prog_{m}_{rk}"] = oracle.progcompile(m, code.frozen)
        msg = (1 - 2 * rng.integers(0, 2, (w, k))).astype(np.int8)
        data[f"enc_msg_{m}_{rk}"] = msg
        data[f"enc_sys_{m}_{rk}"] = oracle.encode(m, code.frozen, msg, True)
        data[f"enc_nonsys_{m}_{rk}"] = oracle.encode(m, code.frozen, msg, False)
        if rate != 0.5:
            n_batches = 1
        else:
            n_batches = 4 if m < 11 else (2 if m < 13 else 1)
        for i in range(n_batches):
            llr = edge_llrs(rng, w, n, i)
            data[f"llr_{m}_{rk}_{i}"] = llr
            data[f"dec_{m}_{rk}_{i}"] = oracle.decode(m, code.frozen, llr)
        if rate == 0.5 and 3 <= m <= 8:
            fllr = (rng.normal(size=(wf, n)) * 8).astype(np.float32)
            data[f"fllr_{m}_{rk}"] = fllr
            data[f"fdec_{m}_{rk}"] = oracle.decode_float(m, code.frozen, fllr)
    # threshold-mode construction samples
    for m, pe, th in [(4, 0.5, 0.5), (8, 0.5, 0.5), (10, 0.3, 1e-7)]:
        data[f"maskth_{m}_{pe}_{th}"] = oracle.freezeth(m, pe, th)
    OUT.parent.mkdir(exist_ok=True)
    np.savez_compressed(OUT, **data)
    size = OUT.stat().st_size
    print(f"wrote {OUT} ({size/1024:.0f} KiB, {len(data)} arrays)")


def _testbench_pe(rate):
    """The testbench's design recipe (testbench.cc:74-89)."""
    import math
    snr = pt.design_snr_db(1.0 - rate) + 1.59175
    return math.exp(-(10.0 ** (snr / 10.0)))


if __name__ == "__main__":
    main()
