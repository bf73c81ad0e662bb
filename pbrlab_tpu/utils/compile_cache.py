"""Where the persistent XLA compile cache lives, for every entry point.

The cache key includes the directory, so the directory must not move from
run to run: `JAX_COMPILATION_CACHE_DIR` when the environment sets it
(JAX reads it itself), otherwise a fixed `.jax_cache` in the checkout.
"""
from __future__ import annotations

import os

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(CHECKOUT, ".jax_cache")


def configure_compile_cache() -> str:
    """Point JAX's persistent compile cache at its directory; returns it.
    Sets nothing when JAX_COMPILATION_CACHE_DIR is set."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
