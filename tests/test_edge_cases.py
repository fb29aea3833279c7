"""Robustness edge cases: degenerate geometry, empty scenes, odd resolutions,
fill-rule boundary pixels."""

import dataclasses

import numpy as np
import jax.numpy as jnp

from arctic_tpu.core.config import RenderConfig
from arctic_tpu.core.scene import default_scene_params, default_settings
from arctic_tpu.io.build import MaterialImages, MeshData, build_buffers, fallback_diffuse, fallback_normal
from arctic_tpu.io.procedural import gradient_environment
from arctic_tpu.models import pipeline
from arctic_tpu.ops import raster, raster_tiles
from tests.test_raster import make_setup


def _mini_scene(positions, indices):
    mesh = MeshData(
        positions=np.asarray(positions, np.float32),
        normals=np.tile([0, 0, 1.0], (len(positions), 1)).astype(np.float32),
        uvs=np.zeros((len(positions), 2), np.float32),
        indices=np.asarray(indices, np.int32),
        material=0,
    )
    mats = [MaterialImages(fallback_diffuse(), fallback_normal(), fallback_diffuse())]
    return build_buffers([mesh], [(np.eye(4, dtype=np.float32), 0)], mats,
                         gradient_environment(32, 64), tri_bucket=64)


def test_degenerate_and_single_triangle():
    # One real triangle + one zero-area (repeated vertex) triangle.
    bufs = _mini_scene(
        [[-1, -1, -3], [1, -1, -3], [0, 1, -3], [0, 0, -5]],
        [[0, 1, 2], [3, 3, 3]],
    )
    config = RenderConfig(width=64, height=64, shadow_size=64, force_bruteforce=True)
    p = default_scene_params(aspect=1.0)
    p = dataclasses.replace(
        p, camera=dataclasses.replace(p.camera, eye=jnp.zeros(3), rotation=jnp.asarray([0.0, -90.0]))
    )
    img = np.asarray(pipeline.render_frame(bufs, p, default_settings(), config))
    assert np.isfinite(img.astype(np.float32)).all()
    assert img.std() > 0


def test_empty_scene_renders_sky_only():
    bufs = _mini_scene([[0, 0, -3]] * 3, np.zeros((0, 3), np.int32).reshape(0, 3))
    config = RenderConfig(width=48, height=32, shadow_size=32, force_bruteforce=True)
    p = default_scene_params(aspect=1.5)
    img = np.asarray(pipeline.render_frame(bufs, p, default_settings(), config))
    assert img.shape == (32, 48, 3)
    # Whole frame is environment.
    assert np.isfinite(img.astype(np.float32)).all()


def test_odd_resolution_tiled_crop():
    """Width/height not multiples of the tile size must crop correctly."""
    W, H = 100, 70
    config = RenderConfig(width=W, height=H)
    rngv = np.random.default_rng(3)
    tris = rngv.uniform(-1, 1, (20, 3, 3)).astype(np.float32)
    tris[..., 2] = 0.5
    setup, _ = make_setup(tris, W, H, cull="none")
    zb, ib = raster.rasterize_bruteforce(setup, H, W)
    zt, it = raster_tiles.rasterize_tiled(setup, H, W, config)
    assert it.shape == (H, W)
    np.testing.assert_array_equal(np.asarray(ib), np.asarray(it))


def test_fill_rule_no_double_coverage_on_exact_edges():
    """A quad whose shared diagonal passes exactly through pixel centers:
    top-left rule must assign each center to exactly one triangle."""
    W = H = 8
    # NDC so that the diagonal hits pixel centers: diagonal from corner to
    # corner of the viewport square.
    q = np.array(
        [[-1, -1, 0.5], [1, -1, 0.5], [1, 1, 0.5], [-1, 1, 0.5]], np.float32
    )
    t0 = np.array([[q[0], q[1], q[2]]])
    t1 = np.array([[q[0], q[2], q[3]]])
    s0, _ = make_setup(t0, W, H, cull="none")
    s1, _ = make_setup(t1, W, H, cull="none")
    _, i0 = raster.rasterize_bruteforce(s0, H, W)
    _, i1 = raster.rasterize_bruteforce(s1, H, W)
    c0 = np.asarray(i0) >= 0
    c1 = np.asarray(i1) >= 0
    assert not (c0 & c1).any(), "diagonal pixels covered twice"
    assert (c0 | c1).all(), "hole in fullscreen quad"


def test_pair_buffer_overflow_is_reported():
    """An overflowing tile-pair buffer must be visible in render stats and
    make check_stats raise (silent fragment drops would ship
    benchmark numbers for broken frames)."""
    import pytest

    from arctic_tpu.utils.errors import RenderError

    # 60 full-screen quads -> every triangle covers every tile: pairs far
    # exceed the deliberately tiny capacity.
    n = 60
    positions, indices = [], []
    for i in range(n):
        z = -3.0 - 0.01 * i
        base = 4 * i
        positions += [[-9, -9, z], [9, -9, z], [9, 9, z], [-9, 9, z]]
        indices += [[base, base + 1, base + 2], [base, base + 2, base + 3]]
    bufs = _mini_scene(positions, indices)

    config = RenderConfig(
        width=128, height=128, shadow_size=64, pairs_per_tri=1, pair_reserve=0,
        # 16 camera tiles: the 64x64 default leaves this scene's 120 tris at
        # 480 pairs — under the 1024 cap floor, so nothing would overflow.
        tile_h=32, tile_w=32,
    )
    p = default_scene_params(aspect=1.0)
    p = dataclasses.replace(
        p, camera=dataclasses.replace(p.camera, eye=jnp.zeros(3), rotation=jnp.asarray([0.0, -90.0]))
    )
    _, stats = pipeline.render_frame_stats(bufs, p, default_settings(), config)
    assert int(stats["cam_pairs"]) > int(stats["cam_pair_cap"])
    with pytest.raises(RenderError, match="overflowed"):
        pipeline.check_stats(stats)


def test_no_overflow_reported_on_healthy_scene():
    bufs = _mini_scene(
        [[-1, -1, -3], [1, -1, -3], [0, 1, -3]], [[0, 1, 2]]
    )
    config = RenderConfig(width=64, height=64, shadow_size=64)
    p = default_scene_params(aspect=1.0)
    p = dataclasses.replace(
        p, camera=dataclasses.replace(p.camera, eye=jnp.zeros(3), rotation=jnp.asarray([0.0, -90.0]))
    )
    _, stats = pipeline.render_frame_stats(bufs, p, default_settings(), config)
    pipeline.check_stats(stats)  # must not raise
    assert int(stats["cam_pairs"]) <= int(stats["cam_pair_cap"])
