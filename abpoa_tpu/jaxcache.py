"""JAX's persistent compilation cache, in one place.

Every entry point (CLI, chip_smoke.py, bench.py, benchmarks/scaling.py,
tools/fuzz_ref.py, the test suite) calls ``enable_compile_cache`` before its
first compile.
"""
from __future__ import annotations

import os
import pathlib

CHECKOUT = pathlib.Path(__file__).resolve().parent.parent


def enable_compile_cache() -> str:
    """Returns the cache directory in use. When JAX_COMPILATION_CACHE_DIR is
    set, JAX reads it itself and this sets nothing; otherwise the cache goes
    to ``<checkout>/.jax_cache`` (listed in .gitignore)."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax
    path = str(CHECKOUT / ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
