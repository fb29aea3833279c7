"""Test config: by default the suite runs on a virtual 8-device CPU mesh.

The CPU backend doubles as the "WARP software rasterizer" analogue
(BASELINE.json configs[0]), Pallas kernels run in the interpreter there,
and the 8 virtual devices let the sharding tests check multi-device layouts.

``--gpu`` leaves JAX on its default device instead, for the tests marked
``gpu`` (chip_smoke.py runs them in its own process on the card). Whether a
card is present is decided inside the ``gpu_device`` fixture, never at
import or collection, so every pytest-xdist worker collects the same tests.
"""

import os

import jax
import numpy as np
import pytest


def pytest_addoption(parser):
    parser.addoption(
        "--gpu", action="store_true",
        help="keep JAX's default (GPU) device for the tests marked gpu",
    )


def pytest_configure(config):
    if config.getoption("--gpu"):
        return
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
    ).strip()
    jax.config.update("jax_platforms", "cpu")


@pytest.fixture
def gpu_device():
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU (default device is {dev.platform}); run via chip_smoke.py")
    return dev


@pytest.fixture
def rng():
    return np.random.default_rng(0)
