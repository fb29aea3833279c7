"""The tiled raster kernel (Pallas, Triton route; the interpreter on CPU)
against the brute-force rasterizer, the G-buffer resolve against per-pixel
interpolation, and the one place that picks a kernel's route."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from arctic_tpu.core.config import RenderConfig
from arctic_tpu.ops import raster, raster_tiles, route
from tests.test_raster import make_setup


def _tris(rng, n, lo=-1.2, hi=1.2):
    tris = rng.uniform(lo, hi, (n, 3, 3)).astype(np.float32)
    tris[..., 2] = rng.uniform(0.05, 0.95, (n, 3))
    return tris


@pytest.mark.parametrize(
    "case", ["ibuf", "depth_only", "tile_row0", "empty_tiles", "long_segments"]
)
def test_kernel_matches_bruteforce(case):
    rng = np.random.default_rng(3)
    W, H, th, tw = 96, 64, 16, 32
    tiles_x = W // tw
    if case == "empty_tiles":  # everything in one corner tile
        tris = _tris(rng, 12, -0.95, -0.75)
    elif case == "long_segments":  # hundreds of triangles per tile
        tris = _tris(rng, 400, -0.5, 0.5)
    else:
        tris = _tris(rng, 40)
    setup, _ = make_setup(tris, W, H, cull="none")
    row0, rows = (1, 2) if case == "tile_row0" else (0, H // th)
    depth_only = case == "depth_only"
    config = RenderConfig(width=W, height=H)
    zt, it, pairs = raster_tiles.bin_and_rasterize(
        setup, config, tiles_x, rows, th, tw, jnp.int32(row0),
        depth_only=depth_only,
    )
    assert int(pairs.total_pairs) <= config.pair_capacity(setup.capacity)
    z = np.asarray(raster_tiles._untile(zt, rows, tiles_x, th, tw))
    zb, ib = raster.rasterize_bruteforce(setup, rows * th, W, y_offset=row0 * th)
    np.testing.assert_array_equal(z, np.asarray(zb))
    if depth_only:
        assert it is None
    else:
        i = np.asarray(raster_tiles._untile(it, rows, tiles_x, th, tw))
        np.testing.assert_array_equal(i, np.asarray(ib))
    covered = (np.asarray(ib) >= 0).mean()
    if case == "empty_tiles":
        assert 0 < covered < 0.2
        seg_len = np.diff(np.asarray(pairs.tile_start))
        assert (seg_len == 0).sum() >= len(seg_len) - 2
    else:
        assert covered > 0.2
    if case == "long_segments":
        assert np.diff(np.asarray(pairs.tile_start)).max() > 100


def test_gbuffer_resolve_matches_bruteforce_interpolation():
    """resolve_gbuffer's perspective-correct world position and uv equal
    the brute-force visibility buffer's interpolation (raster.
    pixel_barycentrics + interpolate) at every covered pixel."""
    import dataclasses

    from arctic_tpu.core.scene import default_scene_params
    from arctic_tpu.io.build import build_buffers
    from arctic_tpu.io.procedural import cornell_like_scene
    from arctic_tpu.models import pipeline

    W, H = 128, 64
    meshes, objects, materials, env = cornell_like_scene()
    bufs = build_buffers(meshes, objects, materials, env, tri_bucket=256)
    geom = bufs.geometry
    p = default_scene_params(aspect=W / H)
    cam = dataclasses.replace(
        p.camera, eye=jnp.asarray([0.0, 4.0, 3.0]), rotation=jnp.asarray([-25.0, -90.0])
    )
    wc = pipeline.world_corners(geom)
    tri_valid = jnp.arange(geom.capacity) < geom.num_tris
    clipped = raster.near_clip_corners(pipeline.corners_clip(wc, cam.proj_view()), tri_valid)
    setup = raster.setup_screen_triangles(clipped, W, H, cull="back")
    config = RenderConfig(width=W, height=H)
    rows = pipeline.build_shade_rows(setup, geom, p.sun.proj_view(), wc=wc)
    ibuf_rows, gbuf, _ = raster_tiles.raster_gbuffer(setup, rows, H, W, config)

    # Brute-force visibility + per-pixel interpolation over original vertices.
    _, ib = raster.rasterize_bruteforce(setup, H, W)
    bary, covered = raster.pixel_barycentrics(setup, ib, H, W)
    world = pipeline.vertex_world_positions(geom)
    attrs = jnp.concatenate([world, geom.uvs], axis=1)
    want = np.asarray(raster.interpolate(setup, ib, geom.indices, attrs, bary))

    tiles_y = config.tiles_y
    got = np.stack(
        [
            np.asarray(raster_tiles._untile(
                gbuf[j].reshape(-1, config.tile_h * config.tile_w // 128, 128),
                tiles_y, config.tiles_x, config.tile_h, config.tile_w,
            ))[:H, :W]
            for j in (0, 1, 2, 12, 13)
        ],
        axis=-1,
    )
    ibuf = np.asarray(raster_tiles._untile(
        ibuf_rows.reshape(-1, config.tile_h * config.tile_w // 128, 128),
        tiles_y, config.tiles_x, config.tile_h, config.tile_w,
    ))[:H, :W]
    np.testing.assert_array_equal(ibuf, np.asarray(ib))
    cov = np.asarray(covered)
    assert cov.mean() > 0.3
    np.testing.assert_allclose(got[cov], want[cov], rtol=1e-4, atol=1e-4)
    assert not got[~cov].any()


@pytest.mark.parametrize("platform", ["gpu", "cpu", "rocm"])
def test_pallas_route_chooser(monkeypatch, platform):
    from jax.experimental.pallas import triton as plt

    monkeypatch.setattr(route, "_platform", lambda: platform)
    if platform == "rocm":
        with pytest.raises(RuntimeError, match="no Pallas kernel route"):
            route.pallas_route()
        return
    kw = route.pallas_route(num_warps=8)
    assert kw["backend"] == "triton"
    if platform == "gpu":
        assert "interpret" not in kw
        assert isinstance(kw["compiler_params"], plt.CompilerParams)
        assert kw["compiler_params"].num_warps == 8
    else:
        assert kw["interpret"] is True


def test_raster_kernel_lowers_for_cuda(monkeypatch):
    """The GPU route lowers to a Triton custom call (checked by lowering for
    CUDA here; compiling it needs the card)."""
    monkeypatch.setattr(route, "_platform", lambda: "gpu")
    rng = np.random.default_rng(0)
    setup, _ = make_setup(_tris(rng, 20), 128, 64, cull="none")
    config = RenderConfig(width=128, height=64)

    def f(setup):
        return raster_tiles.rasterize_tiled(setup, 64, 128, config)

    text = jax.jit(f).trace(setup).lower(lowering_platforms=("cuda",)).as_text()
    assert text.count("__gpu$xla.gpu.triton") == 1


@pytest.mark.parametrize("tile_px,warps", [(128, 1), (512, 4), (1024, 8), (4096, 8)])
def test_raster_warps(tile_px, warps):
    assert raster_tiles.raster_warps(tile_px) == warps
