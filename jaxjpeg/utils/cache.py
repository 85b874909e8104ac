"""Where JAX keeps its persistent compilation cache.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this
module sets nothing.  Otherwise the cache goes to the fixed path
``<repo>/.jax_cache``: the path is part of the cache key, so a directory
that moves never hits.
"""

from __future__ import annotations

import os
import pathlib

ENV = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = pathlib.Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Turn the persistent compilation cache on; returns its directory."""
    env = os.environ.get(ENV)
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_DIR))
    return str(DEFAULT_DIR)
