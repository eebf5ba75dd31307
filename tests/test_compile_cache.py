"""Placement of the persistent compilation cache (`compile_cache`)."""
import os

import jax

from mr_slam_tpu import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_env_var_wins_and_nothing_is_set(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.configure() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_default_is_the_fixed_in_repo_path(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        path = compile_cache.configure()
        assert path == os.path.join(REPO, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
        # same path from a second call (the path is part of the key)
        assert compile_cache.configure() == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()
