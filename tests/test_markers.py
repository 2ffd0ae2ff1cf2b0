"""The test configuration pins the CPU unless the run asks for the
card-only tests (``-m gpu``); see tests/conftest.py."""

import pytest

from tests.conftest import selects_gpu_tests


@pytest.mark.parametrize("expr,want", [
    ("", False),
    ("not slow", False),
    ("not gpu", False),
    ("not gpu and not slow", False),
    ("gpu", True),
    ("gpu and not slow", True),
    ("(gpu)", True),
    ("slow or gpu", True),
])
def test_selects_gpu_tests(expr, want):
    assert selects_gpu_tests(expr) is want


def test_tier1_run_is_on_the_cpu():
    """A run that does not select ``gpu`` sees 8 virtual CPU devices."""
    import jax

    assert jax.default_backend() == "cpu"
    assert jax.device_count() == 8
