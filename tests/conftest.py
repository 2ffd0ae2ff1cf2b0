"""Test config: force the JAX CPU backend with 8 virtual devices so
sharding tests run the same pjit programs a multi-device mesh would
(SURVEY.md §4: xla_force_host_platform_device_count). GPU kernels are
tested here in Pallas interpret mode; tests that need a card carry the
``gpu`` marker and skip without one.

A run that selects the card-only tests (``python -m pytest -m gpu
tests/``) leaves JAX on its default platform, so on a machine with a GPU
those tests run on it.
"""

import os

import pytest


def selects_gpu_tests(markexpr: str) -> bool:
    """True for a ``-m`` expression that asks for the ``gpu`` tests
    (``gpu``, ``gpu and not slow``), not for one that excludes them."""
    words = markexpr.replace("(", " ").replace(")", " ").split()
    return any(w == "gpu" and (i == 0 or words[i - 1] != "not")
               for i, w in enumerate(words))


def pytest_configure(config):
    # runs before any test module is collected, so before JAX picks a
    # backend
    if not selects_gpu_tests(config.getoption("markexpr") or ""):
        os.environ["JAX_PLATFORMS"] = "cpu"
        flags = os.environ.get("XLA_FLAGS", "")
        if "xla_force_host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags + " --xla_force_host_platform_device_count=8"
            ).strip()
        import jax

        jax.config.update("jax_platforms", "cpu")

    # Persistent XLA compilation cache: the heavy shard_map compiles hit
    # disk on every run after the first. Entries key on the full HLO +
    # options, so stale hits are impossible.
    from tpu_llm.runtime.compile_cache import enable_compile_cache

    enable_compile_cache()


@pytest.fixture
def gpu():
    """Skip unless JAX sees a GPU (decided when the test runs)."""
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU; run on the card with "
                    "`python -m pytest -m gpu tests/`")
