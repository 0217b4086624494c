"""Where the persistent compilation cache lives (``utils/cache.py``)."""

import os
import subprocess
import sys
from pathlib import Path

import jax
import pytest

from polar_tpu.utils import cache

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture
def keep_cache_config():
    """Restore the process-wide cache options a test changes."""
    saved = (jax.config.jax_compilation_cache_dir,
             jax.config.jax_persistent_cache_min_compile_time_secs)
    yield
    jax.config.update("jax_compilation_cache_dir", saved[0])
    jax.config.update("jax_persistent_cache_min_compile_time_secs", saved[1])


def test_env_dir_is_used_and_no_path_is_set(monkeypatch, tmp_path,
                                            keep_cache_config):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "c"))
    before = jax.config.jax_compilation_cache_dir
    assert cache.enable_compilation_cache() == tmp_path / "c"
    assert (tmp_path / "c").is_dir()
    assert jax.config.jax_compilation_cache_dir == before


def test_default_dir_is_fixed_in_the_checkout(monkeypatch, keep_cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    want = REPO / ".jax_cache"
    assert cache.cache_dir() == want == cache.cache_dir()
    assert cache.enable_compilation_cache() == want
    assert jax.config.jax_compilation_cache_dir == str(want)
    assert ".jax_cache/" in (REPO / ".gitignore").read_text().split()


def test_compiles_land_in_the_env_dir(tmp_path):
    """JAX reads the variable itself: a compile after
    ``enable_compilation_cache`` writes its entry there."""
    code = ("from polar_tpu.utils.cache import enable_compilation_cache\n"
            "enable_compilation_cache(0.0)\n"
            "import jax, jax.numpy as jnp\n"
            "jax.jit(lambda x: x * 2 + 1)(jnp.arange(4)).block_until_ready()\n")
    env = dict(os.environ, JAX_COMPILATION_CACHE_DIR=str(tmp_path),
               JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO))
    subprocess.run([sys.executable, "-c", code], env=env, check=True,
                   timeout=120)
    assert any(p.name.startswith("jit_") for p in tmp_path.iterdir())
