"""Polar code construction (bit freezing) via Bhattacharyya evolution.

Reproduces both construction modes of the reference
(``polar_freezer.hh``):

* threshold mode (``PolarFreezer``, lines 11-32): freeze leaf i iff its
  erasure probability exceeds a threshold; K is an output.
* fixed-K mode (``PolarCodeConst0``, lines 34-62): keep the K most
  reliable leaves as information bits; K is an input.

The probability recursion is the erasure-channel evolution: descending a
level, the left child sees ``pe*(2-pe)`` and the right child ``pe**2``
(``polar_freezer.hh:16-18``).

Accuracy note: the reference evolves probabilities in linear
``long double`` space, which underflows to 0 around level 14+ for typical
design points (and saturates to exactly 1 near pe→1 for high-rate
codes), producing arbitrary tie-breaks in ``std::nth_element``. We
evolve **both log(pe) and log(1-pe) in float64**
(:func:`bhattacharyya_dual`): each domain is exact where the other
saturates, so rankings stay total and deterministic in both tails.
Selection tie-breaks are stable by leaf index. Construction runs
vectorized in numpy on the host — per-code, amortized over every
encode/decode that follows.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np


def bhattacharyya_dual(level: int, erasure_probability: float = math.exp(-1.0)):
    """(log pe, log(1-pe)) of every bit channel after ``level`` splits.

    The erasure recursion (``polar_freezer.hh:16-18``) is evolved in BOTH
    log domains simultaneously:

    * left child:  pe' = pe(2-pe)  ⇔  (1-pe') = (1-pe)^2
      → lp' = lp + log(2-pe)  (stable via log1p for tiny pe);
        lq' = 2·lq            (EXACT — no precision loss near pe→1)
    * right child: pe' = pe^2      ⇔  (1-pe') = (1-pe)(1+pe)
      → lp' = 2·lp            (exact near pe→0);
        lq' = lq + log1p(pe)

    Each domain is exact precisely where the other saturates, so channel
    ordering stays resolvable in both tails — unlike the reference's
    linear long double (underflows to 0 near pe→0 around level 14) or a
    single log-pe domain (collapses to 0 near pe→1 for high-rate
    constructions). Returns two float64 arrays in natural leaf order.
    """
    if not (0.0 < erasure_probability < 1.0):
        raise ValueError("erasure_probability must be in (0, 1)")
    lp = np.array([math.log(erasure_probability)], dtype=np.float64)
    lq = np.array([math.log1p(-erasure_probability)], dtype=np.float64)
    for _ in range(level):
        pe = np.exp(lp)
        # lp_left = log(pe(2-pe)) = log1p(-(1-pe)^2) = log1p(-exp(2 lq)).
        # For pe < 1/2 the direct form lp + log(2) + log1p(-pe/2) is the
        # well-conditioned one; for pe >= 1/2 the identity via lq is —
        # adding log(2-pe) to lp there cancels catastrophically as pe→1
        # (it can even produce positive "log-probabilities").
        # lanes with pe < 0.5 are discarded by the np.where below and may
        # evaluate to -inf (exp(2lq) == 1) or NaN by design — silence both.
        with np.errstate(divide="ignore", invalid="ignore"):
            via_lq = np.log1p(-np.exp(2.0 * lq))
        left_lp = np.where(
            pe < 0.5, lp + math.log(2.0) + np.log1p(-0.5 * pe), via_lq
        )
        left_lq = 2.0 * lq
        right_lp = 2.0 * lp
        right_lq = lq + np.log1p(pe)
        # Node j owns a contiguous leaf block; its left child owns the first
        # half, the right child the second (``polar_freezer.hh:16-18``), so
        # breadth-first the children of consecutive nodes are [l0,r0,l1,r1,...].
        lp = np.stack([left_lp, right_lp], axis=1).reshape(-1)
        lq = np.stack([left_lq, right_lq], axis=1).reshape(-1)
    return lp, lq


def bhattacharyya_logpe(level: int, erasure_probability: float = math.exp(-1.0)) -> np.ndarray:
    """Log erasure probability of every bit channel after ``level`` splits.

    Returns a float64 array of shape (2**level,), entry i = ``log pe`` of
    leaf i in natural (decoder) order. See :func:`bhattacharyya_dual`.
    """
    return bhattacharyya_dual(level, erasure_probability)[0]


def frozen_mask_fixed_k(
    level: int, K: int, erasure_probability: float = math.exp(-1.0)
) -> np.ndarray:
    """Fixed-K construction: freeze all but the K most reliable leaves.

    Mirrors ``PolarCodeConst0::operator()`` (``polar_freezer.hh:49-61``)
    with deterministic stable tie-breaking (ascending log-pe, then index).
    Returns a uint8 mask of shape (2**level,), 1 = frozen.
    """
    n = 1 << level
    if not (0 <= K <= n):
        raise ValueError(f"K={K} out of range for N={n}")
    lp, lq = bhattacharyya_dual(level, erasure_probability)
    # primary: pe ascending (lp); where lp saturates at 0 (pe → 1),
    # resolve by 1-pe descending (lq descending) — the domain that stays
    # exact there; final tie-break: leaf index (deterministic).
    order = np.lexsort((np.arange(n), -lq, lp))
    frozen = np.ones(n, dtype=np.uint8)
    frozen[order[:K]] = 0
    return frozen


def frozen_mask_threshold(
    level: int,
    erasure_probability: float = 0.5,
    freezing_threshold: float = 0.5,
) -> np.ndarray:
    """Threshold construction: freeze leaf i iff pe_i > threshold.

    Mirrors ``PolarFreezer::operator()`` (``polar_freezer.hh:23-31``).
    Returns a uint8 mask, 1 = frozen; K is ``(mask == 0).sum()``.
    """
    logpe = bhattacharyya_logpe(level, erasure_probability)
    return (logpe > math.log(freezing_threshold)).astype(np.uint8)


def design_snr_db(erasure_probability: float) -> float:
    """Design Es/N0 in dB for an erasure probability (``testbench.cc:76``)."""
    return 10.0 * math.log10(-math.log(erasure_probability))


def erasure_probability_for_snr_db(snr_db: float) -> float:
    """Inverse of :func:`design_snr_db` (``testbench.cc:87``)."""
    return math.exp(-(10.0 ** (snr_db / 10.0)))


@dataclass(frozen=True)
class PolarCode:
    """A constructed polar code: the static spec every kernel specializes on.

    The analog of the reference's (template M, frozen array) pair. Hashable
    by content so jitted encoders/decoders can be cached per code.
    """

    level: int
    frozen: np.ndarray = field(repr=False)  # uint8 (N,), 1 = frozen

    def __post_init__(self):
        f = np.ascontiguousarray(np.asarray(self.frozen, dtype=np.uint8))
        if f.shape != (1 << self.level,):
            raise ValueError(f"frozen mask shape {f.shape} != ({1 << self.level},)")
        f.setflags(write=False)
        object.__setattr__(self, "frozen", f)

    @property
    def N(self) -> int:
        return 1 << self.level

    @property
    def K(self) -> int:
        return int((self.frozen == 0).sum())

    @property
    def rate(self) -> float:
        return self.K / self.N

    @property
    def info_indices(self) -> np.ndarray:
        """Leaf indices carrying information bits, ascending (= message order)."""
        return np.flatnonzero(self.frozen == 0)

    def __hash__(self):
        return hash((self.level, self.frozen.tobytes()))

    def __eq__(self, other):
        return (
            isinstance(other, PolarCode)
            and self.level == other.level
            and bool(np.array_equal(self.frozen, other.frozen))
        )

    def __repr__(self):
        return f"PolarCode(N={self.N}, K={self.K})"


def make_code_threshold(
    level: int,
    erasure_probability: float = 0.5,
    freezing_threshold: float = 0.5,
) -> PolarCode:
    """Threshold-mode construction (the testbench's alternate branch,
    ``testbench.cc:78-81``): K is an output, not an input."""
    return PolarCode(
        level,
        frozen_mask_threshold(level, erasure_probability, freezing_threshold),
    )


def make_code(
    level: int,
    K: int | None = None,
    *,
    rate: float | None = None,
    design_snr_offset_db: float = 1.59175,
    erasure_probability: float | None = None,
) -> PolarCode:
    """Construct a code the way the reference testbench does.

    With ``K`` (or ``rate``): fixed-K construction at a design point derived
    from the rate — ``testbench.cc:74-89``: the base design SNR is
    ``10*log10(-ln(1-rate))``, improved by ``design_snr_offset_db``
    (+1.59175 dB), then converted back to an erasure probability.
    An explicit ``erasure_probability`` overrides that recipe.
    """
    n = 1 << level
    if K is None:
        if rate is None:
            rate = 0.5
        K = int(round(rate * n))
    if not (0 < K < n):
        raise ValueError(f"K={K} must be in (0, {n}) for N={n}")
    if erasure_probability is None:
        base_pe = 1.0 - K / n
        snr = design_snr_db(base_pe) + design_snr_offset_db
        erasure_probability = erasure_probability_for_snr_db(snr)
    return PolarCode(level, frozen_mask_fixed_k(level, K, erasure_probability))
