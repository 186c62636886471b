"""Test harness: an 8-device virtual CPU mesh unless a platform is named.

Multi-device hardware is not needed for the suite: sharding tests run on
``xla_force_host_platform_device_count=8`` CPU devices (SURVEY.md section
4).  Tests marked ``gpu`` need an NVIDIA card and skip elsewhere; they run on
the card with ``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/`` (which
``chip_smoke.py`` does).
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(42)


@pytest.fixture
def gpu():
    """The first GPU device; skips the test where JAX has none."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU: run JAX_PLATFORMS=cuda "
                    "python -m pytest -m gpu tests/")
    return jax.devices()[0]
