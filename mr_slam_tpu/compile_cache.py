"""Placement of JAX's persistent compilation cache.

A cold session compiles every stage of the pipeline before its first
frame; the persistent cache keeps those executables for the next
process. The cache directory is part of what a later process looks up,
so it lives at one fixed path, never a temporary or per-run one.
"""
from __future__ import annotations

import os

import jax

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"
)


def configure() -> str:
    """Enable the persistent compilation cache and return its directory.

    When `JAX_COMPILATION_CACHE_DIR` is set, JAX reads it at import and
    this sets nothing of its own. Otherwise the cache goes to the fixed
    `<repo>/.jax_cache` (`DEFAULT_DIR`). Call once at program start,
    before the first compilation."""
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
