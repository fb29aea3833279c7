"""Tests that need the card (marker ``gpu``): they skip on the CPU and run
in chip_smoke.py's process on the GPU (``pytest -m gpu --gpu``)."""

import numpy as np
import pytest

from arctic_tpu.core.config import RenderConfig
from arctic_tpu.ops import raster, raster_tiles, route
from tests.test_raster import make_setup

pytestmark = pytest.mark.gpu


def test_route_compiles_on_gpu(gpu_device):
    kw = route.pallas_route()
    assert kw["backend"] == "triton" and "interpret" not in kw


@pytest.mark.parametrize("tile", [(64, 64), (32, 32)])
def test_compiled_kernel_matches_bruteforce(gpu_device, tile):
    rng = np.random.default_rng(11)
    W, H = 320, 192
    tris = rng.uniform(-1.2, 1.2, (300, 3, 3)).astype(np.float32)
    tris[..., 2] = rng.uniform(0.05, 0.95, (300, 3))
    setup, _ = make_setup(tris, W, H, cull="none")
    config = RenderConfig(width=W, height=H, tile_h=tile[0], tile_w=tile[1])
    zt, it = raster_tiles.rasterize_tiled(setup, H, W, config)
    zb, ib = raster.rasterize_bruteforce(setup, H, W)
    np.testing.assert_array_equal(np.asarray(it), np.asarray(ib))
    np.testing.assert_array_equal(np.asarray(zt), np.asarray(zb))
