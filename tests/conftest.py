import os

# The suite runs on the CPU backend with 8 virtual devices, so the
# multi-device sharding tests run anywhere (standard JAX pattern; see
# SURVEY.md §4 item 3). An explicit JAX_PLATFORMS is honoured: the
# `gpu`-marked tests run on the card with JAX_PLATFORMS=cuda
# (`python -m pytest -m gpu tests/`, or chip_smoke.py's test phase).
os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(42)


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is an NVIDIA GPU (decided when the
    test runs, never at import: xdist workers must collect the same
    tests)."""
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (run with JAX_PLATFORMS=cuda)")
