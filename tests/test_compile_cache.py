"""Where the persistent XLA compilation cache goes."""

import os

import jax

from tpu_llm.runtime import compile_cache


def test_env_dir_is_left_to_jax(monkeypatch, tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, JAX reads it itself: the
    module sets no directory of its own."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_default_dir_is_fixed_inside_the_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    first = compile_cache.enable_compile_cache()
    assert first == compile_cache.enable_compile_cache()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert first == os.path.join(repo, ".cache", "xla")
    assert jax.config.jax_compilation_cache_dir == first
    assert os.path.isdir(first)


def test_default_dir_is_gitignored():
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    rel = os.path.relpath(compile_cache.DEFAULT_DIR, repo)
    ignored = open(os.path.join(repo, ".gitignore")).read().split()
    assert rel.split(os.sep)[0] + "/" in ignored
