"""The fused (G-buffer) shading path must match the brute-force pipeline.

The fused path (ops/raster_tiles.raster_gbuffer + pipeline.shade_gbuffer)
resolves all shading inputs per pixel from the tiled rasterizer's slot ids;
the only differences vs the deferred path are f32 reassociation
(light-space positions interpolated per-corner instead of a per-pixel
matmul, tri-major attribute combination). Allowed: <=1 u8 LSB.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest

from arctic_tpu.core.config import RenderConfig
from arctic_tpu.core.scene import PointLights, default_scene_params, default_settings
from arctic_tpu.io.build import build_buffers
from arctic_tpu.io.procedural import cornell_like_scene, helmet_like_scene
from arctic_tpu.models import pipeline

W, H, SHADOW = 160, 120, 200


def _params(aspect, eye, rot, lights=()):
    p = default_scene_params(aspect=aspect)
    return dataclasses.replace(
        p,
        camera=dataclasses.replace(
            p.camera, eye=jnp.asarray(eye), rotation=jnp.asarray(rot)
        ),
        point_lights=PointLights.from_list(list(lights)),
    )


@pytest.mark.parametrize(
    "scene_fn,eye,rot,lights",
    [
        (
            cornell_like_scene,
            [0.0, 4.0, 3.0],
            [-25.0, -90.0],
            [((0.0, 1.0, 0.0), (10.0, 0.0, 0.0)), ((3.0, 2.0, -6.0), (0.0, 6.0, 12.0))],
        ),
        (helmet_like_scene, [0.0, 2.2, 0.5], [-8.0, -90.0], []),
    ],
)
def test_fused_matches_bruteforce(scene_fn, eye, rot, lights):
    meshes, objects, materials, env = scene_fn()
    bufs = build_buffers(meshes, objects, materials, env, tri_bucket=256)
    p = _params(W / H, eye, rot, lights)
    s = default_settings()

    img_bf = np.asarray(
        pipeline.render_frame(
            bufs, p, s, RenderConfig(width=W, height=H, shadow_size=SHADOW, force_bruteforce=True)
        )
    )
    img_fused, stats = pipeline.render_frame_stats(
        bufs, p, s, RenderConfig(width=W, height=H, shadow_size=SHADOW, fused_shade=True)
    )
    pipeline.check_stats(stats)
    img_fused = np.asarray(img_fused)
    diff = np.abs(img_fused.astype(int) - img_bf.astype(int))
    assert diff.max() <= 1, f"fused path differs by {diff.max()} > 1 LSB"
    assert (diff > 0).mean() < 0.01


def test_sun_cache_matches_uncached():
    """render_frame_stats(sun_cache=...) must reproduce the uncached frame
    (the cache holds exactly what the in-frame build computes), and a moved
    sun with a REBUILT cache must change the image (no stale plumbing)."""
    meshes, objects, materials, env = cornell_like_scene()
    bufs = build_buffers(meshes, objects, materials, env, tri_bucket=256)
    p = _params(W / H, [0.0, 4.0, 3.0], [-25.0, -90.0],
                [((0.0, 1.0, 0.0), (10.0, 0.0, 0.0))])
    s = default_settings()
    config = RenderConfig(width=W, height=H, shadow_size=SHADOW, fused_shade=True)

    img_u, _ = pipeline.render_frame_stats(bufs, p, s, config)
    cache, cstats = pipeline.build_sun_cache(bufs, p, config)
    assert int(cstats["shadow_pairs"]) <= int(cstats["shadow_pair_cap"])
    img_c, stats = pipeline.render_frame_stats(bufs, p, s, config, cache)
    pipeline.check_stats(stats)
    diff = np.abs(np.asarray(img_c).astype(int) - np.asarray(img_u).astype(int))
    assert diff.max() <= 1, f"cached sun changed the frame by {diff.max()} LSB"

    p2 = dataclasses.replace(
        p, sun=dataclasses.replace(p.sun, rotation=jnp.asarray([-35.0, 80.0]))
    )
    cache2, _ = pipeline.build_sun_cache(bufs, p2, config)
    img_c2, _ = pipeline.render_frame_stats(bufs, p2, s, config, cache2)
    assert np.abs(
        np.asarray(img_c2).astype(int) - np.asarray(img_c).astype(int)
    ).max() > 4, "moving the sun with a rebuilt cache must change the frame"


def test_sun_cache_default_config_skips_pyramid():
    """The sun cache holds the shadow map and nothing else: its one field is
    the (S, S) map the uncached frame renders (uncull'd), and rendering from
    it matches the uncached frame."""
    from arctic_tpu.core.scene import SunCache

    meshes, objects, materials, env = cornell_like_scene()
    bufs = build_buffers(meshes, objects, materials, env, tri_bucket=256)
    p = _params(W / H, [0.0, 4.0, 3.0], [-25.0, -90.0])
    s = default_settings()
    config = RenderConfig(width=W, height=H, shadow_size=SHADOW)

    cache, _ = pipeline.build_sun_cache(bufs, p, config)
    assert [f.name for f in dataclasses.fields(SunCache)] == ["shadow_map"]
    assert cache.shadow_map.shape == (SHADOW, SHADOW)
    smap, _, _ = pipeline.shadow_pass(bufs.geometry, p.sun.proj_view(), config)
    np.testing.assert_array_equal(np.asarray(cache.shadow_map), np.asarray(smap))
    img_u, _ = pipeline.render_frame_stats(bufs, p, s, config)
    img_c, stats = pipeline.render_frame_stats(bufs, p, s, config, cache)
    pipeline.check_stats(stats)
    diff = np.abs(np.asarray(img_c).astype(int) - np.asarray(img_u).astype(int))
    assert diff.max() <= 1, f"cached sun changed the frame by {diff.max()} LSB"


def test_ibl_specular_paths_agree():
    """Opt-in IBL specular (config.ibl_specular): fused channel-first and
    deferred implementations agree <=1 LSB, and the term visibly changes the
    image (it is not a no-op). Reference: the dead sample_environment helper
    forward.hlsl:195-206 (no uv.y negation, unlike the skybox)."""
    meshes, objects, materials, env = helmet_like_scene()
    bufs = build_buffers(meshes, objects, materials, env, tri_bucket=256)
    p = _params(W / H, [0.0, 2.2, 0.5], [-8.0, -90.0])
    s = default_settings()

    base = dict(width=W, height=H, shadow_size=SHADOW)
    img_off = np.asarray(
        pipeline.render_frame(bufs, p, s, RenderConfig(**base, fused_shade=True))
    )
    img_fused = np.asarray(
        pipeline.render_frame(
            bufs, p, s, RenderConfig(**base, fused_shade=True, ibl_specular=True)
        )
    )
    img_bf = np.asarray(
        pipeline.render_frame(
            bufs, p, s,
            RenderConfig(**base, force_bruteforce=True, ibl_specular=True),
        )
    )
    diff = np.abs(img_fused.astype(int) - img_bf.astype(int))
    assert diff.max() <= 1, f"IBL fused vs deferred differs by {diff.max()}"
    assert np.abs(img_fused.astype(int) - img_off.astype(int)).max() > 2, (
        "ibl_specular=True did not change the image"
    )


def test_fused_vs_golden_oracle():
    """Full fused pipeline >= 40 dB vs the float64 oracle (BASELINE metric)."""
    from arctic_tpu.models import golden

    meshes, objects, materials, env = cornell_like_scene()
    bufs = build_buffers(meshes, objects, materials, env, tri_bucket=256)
    cam = dict(eye=[0.0, 4.0, 3.0], rotation=[-25.0, -90.0], aspect=W / H,
               fov_y=45.0, z_near=0.1, z_far=1000.0)
    sun = dict(position=[-10.0, 32.0, -2.48], rotation=[-70.0, 12.0], color=[8.0, 8.0, 8.0])
    lights = [((0.0, 1.0, 0.0), (10.0, 0.0, 0.0))]
    p = _params(W / H, cam["eye"], cam["rotation"], lights)
    s = dataclasses.replace(default_settings(), tm_method=jnp.int32(2))

    img = np.asarray(
        pipeline.render_frame(
            bufs, p, s, RenderConfig(width=W, height=H, shadow_size=SHADOW, fused_shade=True)
        )
    )
    tris, mats = golden.golden_scene(meshes, objects, materials)
    img_gold = golden.render(
        tris, mats, np.asarray(env, np.float64), cam, sun, lights,
        ambient=0.1, settings=dict(tm_method=2, gamma=2.2, exposure=1.0),
        width=W, height=H, shadow_size=SHADOW,
    )
    mse = np.mean((img.astype(np.float64) - img_gold.astype(np.float64)) ** 2)
    db = 10 * np.log10(255.0**2 / mse)
    assert db >= 40.0, f"fused pipeline PSNR {db:.2f} dB < 40 dB"
