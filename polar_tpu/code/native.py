"""Native (C) construction/compilation with transparent numpy fallback.

The device path never touches this module — construction and program
compilation are host-side, per-code, amortized work (the reference runs
them once per code too: ``testbench.cc:82-97``). The C extension
(``csrc/polar_native.c``) makes them fast for very large N (2^20+) and is
the framework's native-runtime component; when it isn't built, the numpy
implementations in :mod:`polar_tpu.code.construction` /
:mod:`polar_tpu.code.compiler` take over. Programs are byte-identical;
construction uses the same formulas and branch points in both
implementations and agrees to transcendental-library rounding (last-ulp
exp/log1p differences between numpy's SIMD kernels and glibc) — frozen
masks are verified equal at every tested design point including extreme
tails (tests/test_native.py).

Build with ``make native`` or :func:`build_native`, which compiles it into
``build/`` of the checkout; a built, current library there is loaded at
import.
"""

from __future__ import annotations

import importlib.util
import math
import os
import shutil
import subprocess
import sysconfig
from pathlib import Path

import numpy as np

_REPO = Path(__file__).resolve().parents[2]
_SRC = _REPO / "csrc" / "polar_native.c"
_native = None


def _library(build_dir: Path) -> Path:
    return build_dir / ("_polar_native" + sysconfig.get_config_var("EXT_SUFFIX"))


def _load(lib: Path) -> None:
    global _native
    spec = importlib.util.spec_from_file_location("_polar_native", lib)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    _native = module


def have_native() -> bool:
    return _native is not None


def build_native(build_dir: Path | None = None) -> Path:
    """Compile ``csrc/polar_native.c`` into ``build_dir`` (default
    ``build/`` of the checkout) unless a current build is there, load it as
    the native backend, and return the library's path."""
    build_dir = Path(build_dir or _REPO / "build")
    build_dir.mkdir(parents=True, exist_ok=True)
    lib = _library(build_dir)
    if not lib.exists() or lib.stat().st_mtime < _SRC.stat().st_mtime:
        cc = shutil.which("cc") or shutil.which("gcc")
        if cc is None:
            raise RuntimeError("no C compiler to build the native extension")
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        subprocess.run([cc, "-O3", "-std=c11", "-shared", "-fPIC",
                        "-I", sysconfig.get_paths()["include"], str(_SRC),
                        "-o", str(tmp), "-lm"],
                       check=True, capture_output=True, text=True)
        os.replace(tmp, lib)
    _load(lib)
    return lib


_built = _library(_REPO / "build")
if _built.exists() and _built.stat().st_mtime >= _SRC.stat().st_mtime:
    _load(_built)


def bhattacharyya_logpe(level: int, erasure_probability: float = math.exp(-1.0)):
    if _native is None:
        from .construction import bhattacharyya_logpe as np_impl

        return np_impl(level, erasure_probability)
    raw = _native.bhatt_logpe(level, float(erasure_probability))
    return np.frombuffer(raw, dtype=np.float64)


def bhattacharyya_dual(level: int, erasure_probability: float = math.exp(-1.0)):
    """(log pe, log(1-pe)) arrays — native twin of
    :func:`polar_tpu.code.construction.bhattacharyya_dual`. The C evolution
    uses the identical update formulas and branch point; results agree with
    numpy to transcendental-library rounding in each domain's authoritative
    zone (see tests/test_native.py)."""
    if _native is None:
        from .construction import bhattacharyya_dual as np_impl

        return np_impl(level, erasure_probability)
    raw = _native.bhatt_dual(level, float(erasure_probability))
    both = np.frombuffer(raw, dtype=np.float64)
    n = 1 << level
    return both[:n], both[n:]


def frozen_mask_fixed_k(level: int, K: int, erasure_probability: float = math.exp(-1.0)):
    if _native is None:
        from .construction import frozen_mask_fixed_k as np_impl

        return np_impl(level, K, erasure_probability)
    raw = _native.frozen_fixed_k(level, int(K), float(erasure_probability))
    return np.frombuffer(raw, dtype=np.uint8).copy()


def frozen_mask_threshold(level: int, erasure_probability: float = 0.5,
                          freezing_threshold: float = 0.5):
    if _native is None:
        from .construction import frozen_mask_threshold as np_impl

        return np_impl(level, erasure_probability, freezing_threshold)
    raw = _native.frozen_threshold(level, float(erasure_probability),
                                   float(freezing_threshold))
    return np.frombuffer(raw, dtype=np.uint8).copy()


def compile_program(frozen: np.ndarray, level: int) -> np.ndarray:
    if _native is None:
        from .compiler import build_tree, emit_program

        return emit_program(build_tree(frozen, level), level)
    raw = _native.compile_program(
        np.ascontiguousarray(frozen, dtype=np.uint8).tobytes(), int(level)
    )
    return np.frombuffer(raw, dtype=np.uint8).copy()
