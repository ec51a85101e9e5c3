"""Tests run on the CPU with 8 virtual devices, so multi-device sharding
is exercised without accelerator hardware, unless JAX_PLATFORMS names a
platform: `JAX_PLATFORMS=cuda python -m pytest -m gpu` runs the
card-only tests on a GPU machine (see README).

Card-only tests carry the `gpu` marker and take the `gpu_device`
fixture, which skips them where JAX finds no GPU.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()
if "JAX_PLATFORMS" not in os.environ:
    os.environ["JAX_PLATFORMS"] = "cpu"

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def rs():
    return np.random.RandomState(1234)


@pytest.fixture(scope="session")
def gpu_device():
    """The first GPU device; skips the test where JAX has none."""
    import jax

    devs = [d for d in jax.devices() if d.platform == "gpu"]
    if not devs:
        pytest.skip("needs an NVIDIA GPU (run `pytest -m gpu` on the card)")
    return devs[0]
