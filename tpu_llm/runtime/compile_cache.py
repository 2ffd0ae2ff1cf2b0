"""Persistent XLA compilation cache.

A jit framework pays its start-up cost in XLA compilation; JAX's
persistent compilation cache removes it from every run after the first.
Safe to enable unconditionally: entries key on the full HLO and compile
options, so a stale hit is impossible.

Where the cache lives:
- ``JAX_COMPILATION_CACHE_DIR``, when set: JAX reads it itself and this
  module sets no other directory;
- otherwise one fixed directory inside the checkout, ``.cache/xla``
  (listed in ``.gitignore``). It is never a temporary name, a process id
  or a time: the path is part of what makes a later run hit.
"""

from __future__ import annotations

import os

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(REPO_ROOT, ".cache", "xla")


def enable_compile_cache() -> str:
    """Enable JAX's on-disk compilation cache (idempotent). Returns the
    directory in use."""
    import jax

    cache_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not cache_dir:
        cache_dir = DEFAULT_DIR
        os.makedirs(cache_dir, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    # cache everything that took meaningful compile time, however small
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return cache_dir
