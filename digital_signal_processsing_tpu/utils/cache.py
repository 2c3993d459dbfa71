"""Persistent compilation cache at one fixed place.

A cold process compiles every program it runs; a persistent cache lets the
next process load them instead. The cache key includes the directory, so
the directory must not move between runs:

- if ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it natively and this
  module sets nothing else;
- otherwise the cache lives in ``<checkout>/.jax_cache`` (listed in
  ``.gitignore``) — never a temporary, per-process or per-run name.

Entry points (``chip_smoke.py``, ``bench.py``, the CLI and the
``serve.stream_*`` functions) call :func:`enable_persistent_cache` before
their first compile.
"""

from __future__ import annotations

import os
from pathlib import Path

import jax

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def cache_dir() -> Path:
    """Where the persistent cache lives for this process."""
    env = os.environ.get(ENV_VAR)
    return Path(env) if env else DEFAULT_DIR


def enable_persistent_cache(*, min_compile_secs: float = 1.0) -> Path:
    """Turn JAX's persistent compilation cache on; returns its directory.

    Call before the first compile of the process. With the environment
    variable set, JAX already uses that directory and nothing is changed.
    """
    path = cache_dir()
    if os.environ.get(ENV_VAR):
        return path
    path.mkdir(parents=True, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", str(path))
    jax.config.update(
        "jax_persistent_cache_min_compile_time_secs", float(min_compile_secs)
    )
    return path


__all__ = ["enable_persistent_cache", "cache_dir", "DEFAULT_DIR", "ENV_VAR"]
