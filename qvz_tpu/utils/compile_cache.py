"""JAX's persistent compilation cache, at a path that stays put.

A run finds compiled programs only where earlier runs wrote them, so the
path must not move between runs: a deployment that sets
JAX_COMPILATION_CACHE_DIR keeps its own (JAX reads the variable itself);
otherwise the cache lives in the checkout's `build/jax_cache`, which
`.gitignore` lists.
"""

from __future__ import annotations

import os
import pathlib

DEFAULT_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / \
    "jax_cache"


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory and
    return that directory."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_DIR))
    return str(DEFAULT_DIR)
