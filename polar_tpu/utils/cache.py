"""Persistent XLA compilation cache.

The unrolled XLA decode tree takes long to compile at large N; the JAX
persistent compilation cache makes repeat runs of the same program cheap.
Call :func:`enable_compilation_cache` before building decoders — the CLI
entry points, ``bench.py`` and ``chip_smoke.py`` do.

Where the cache lives: ``JAX_COMPILATION_CACHE_DIR`` when it is set (JAX
reads that variable itself, so no other path is set in code); otherwise
the fixed directory ``.jax_cache`` at the root of the checkout (listed in
``.gitignore``). The path is part of what makes a later run hit, so it
never depends on the process, the time or a temporary directory.
"""

from __future__ import annotations

import os
from pathlib import Path

import jax

DEFAULT_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def cache_dir() -> Path:
    """The directory the persistent cache uses."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    return Path(env) if env else DEFAULT_DIR


def enable_compilation_cache(min_compile_secs: float = 1.0) -> Path:
    """Enable the JAX persistent compilation cache; returns its directory."""
    path = cache_dir()
    path.mkdir(parents=True, exist_ok=True)
    if "JAX_COMPILATION_CACHE_DIR" not in os.environ:
        jax.config.update("jax_compilation_cache_dir", str(path))
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      min_compile_secs)
    return path
