"""Where the persistent XLA compile cache lives, for every entry point.

``JAX_COMPILATION_CACHE_DIR``, when set, is the cache (JAX reads it itself)
and nothing here overrides it. Otherwise the cache is ``.jax_cache`` in the
checkout: a fixed path, so a later run finds what an earlier one compiled.
"""

from __future__ import annotations

import os
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parent.parent
DEFAULT_DIR = CHECKOUT / ".jax_cache"


def cache_dir() -> Path:
    """The compile-cache directory :func:`enable_compile_cache` uses."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    return Path(env) if env else DEFAULT_DIR


def enable_compile_cache() -> Path:
    """Turn on JAX's persistent compile cache at :func:`cache_dir`; call it
    before the first compilation. Returns the directory."""
    import jax

    path = cache_dir()
    if "JAX_COMPILATION_CACHE_DIR" not in os.environ:
        jax.config.update("jax_compilation_cache_dir", str(path))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path
