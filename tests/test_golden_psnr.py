"""PSNR of the pipeline vs the independent numpy golden renderer.

BASELINE.json's quality metric is "PSNR >= 40 dB vs the DX12 reference
frames"; the DX12 frames don't exist in this environment, so the golden
renderer (models/golden.py — written straight from the HLSL/D3D semantics in
float64) stands in as the oracle. 40 dB at 8 bits means the implementations
agree to ~2.5/255 RMS.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest

from arctic_tpu.core.config import RenderConfig
from arctic_tpu.core.scene import (
    PointLights,
    default_scene_params,
    default_settings,
)
from arctic_tpu.io.build import build_buffers
from arctic_tpu.io.procedural import cornell_like_scene
from arctic_tpu.models import golden, pipeline

W, H, SHADOW = 160, 120, 200


def psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return 10 * np.log10(255.0**2 / mse) if mse > 0 else np.inf


@pytest.fixture(scope="module")
def scene():
    return cornell_like_scene()


def test_psnr_helmet_config(rng):
    """BASELINE configs[1] analogue: hero object, shadowed sun, exposure
    tonemap — exercises dense normal-mapped metallic shading vs the oracle."""
    from arctic_tpu.io.procedural import helmet_like_scene

    meshes, objects, materials, env = helmet_like_scene()
    bufs = build_buffers(meshes, objects, materials, env, tri_bucket=1024)
    config = RenderConfig(width=W, height=H, shadow_size=SHADOW, force_bruteforce=True)
    cam = dict(eye=[0.0, 2.2, 0.5], rotation=[-8.0, -90.0], aspect=W / H,
               fov_y=45.0, z_near=0.1, z_far=1000.0)
    sun = dict(position=[-10.0, 32.0, -2.48], rotation=[-70.0, 12.0], color=[8.0, 8.0, 8.0])
    setd = dict(tm_method=1, gamma=2.2, exposure=1.0)

    p = default_scene_params(aspect=W / H)
    p = dataclasses.replace(
        p,
        camera=dataclasses.replace(
            p.camera, eye=jnp.asarray(cam["eye"]), rotation=jnp.asarray(cam["rotation"])
        ),
        point_lights=PointLights.from_list([]),
    )
    s = dataclasses.replace(default_settings(), tm_method=jnp.int32(1))
    img_jax = np.asarray(pipeline.render_frame(bufs, p, s, config))

    tris, mats = golden.golden_scene(meshes, objects, materials)
    img_gold = golden.render(
        tris, mats, env.astype(np.float64), cam, sun, [],
        ambient=0.1, settings=setd, width=W, height=H, shadow_size=SHADOW,
    )
    db = psnr(img_jax, img_gold)
    assert db >= 40.0, f"helmet config PSNR {db:.2f} dB < 40 dB"


def test_psnr_fused_tiled_vs_golden(scene):
    """The PRODUCTION path (tiled raster kernel, interpreted on CPU, +
    G-buffer resolve + channel-first shading) vs the f64 oracle.

    The parametrized tests below run force_bruteforce; without this test a
    pixel-math regression in the fused path would only surface in the
    on-GPU conformance checks, not in the CPU suite."""
    meshes, objects, materials, env = scene
    bufs = build_buffers(meshes, objects, materials, env, tri_bucket=256)
    config = RenderConfig(width=128, height=96, shadow_size=192)

    cam = dict(eye=[0.0, 4.0, 3.0], rotation=[-25.0, -90.0], aspect=128 / 96,
               fov_y=45.0, z_near=0.1, z_far=1000.0)
    sun = dict(position=[-10.0, 32.0, -2.48], rotation=[-70.0, 12.0], color=[8.0, 8.0, 8.0])
    lights = [((0.0, 1.0, 0.0), (10.0, 0.0, 0.0)), ((3.0, 2.0, -6.0), (0.0, 6.0, 12.0))]
    setd = dict(tm_method=2, gamma=2.2, exposure=1.0)

    p = default_scene_params(aspect=128 / 96)
    p = dataclasses.replace(
        p,
        camera=dataclasses.replace(
            p.camera, eye=jnp.asarray(cam["eye"]), rotation=jnp.asarray(cam["rotation"])
        ),
        point_lights=PointLights.from_list(lights),
    )
    s = dataclasses.replace(default_settings(), tm_method=jnp.int32(2))
    img_jax = np.asarray(pipeline.render_frame(bufs, p, s, config))

    tris, mats = golden.golden_scene(meshes, objects, materials)
    img_gold = golden.render(
        tris, mats, env.astype(np.float64), cam, sun, lights,
        ambient=0.1, settings=setd, width=128, height=96, shadow_size=192,
    )
    db = psnr(img_jax, img_gold)
    assert db >= 40.0, f"fused tiled path PSNR {db:.2f} dB < 40 dB"


@pytest.mark.parametrize("tm_method", [0, 1, 2])
def test_psnr_vs_golden(scene, tm_method):
    meshes, objects, materials, env = scene
    bufs = build_buffers(meshes, objects, materials, env, tri_bucket=256)
    config = RenderConfig(width=W, height=H, shadow_size=SHADOW, force_bruteforce=True)

    cam = dict(
        eye=[0.0, 4.0, 3.0], rotation=[-25.0, -90.0], aspect=W / H,
        fov_y=45.0, z_near=0.1, z_far=1000.0,
    )
    sun = dict(position=[-10.0, 32.0, -2.48], rotation=[-70.0, 12.0], color=[8.0, 8.0, 8.0])
    lights = [((0.0, 1.0, 0.0), (10.0, 0.0, 0.0)), ((3.0, 2.0, -6.0), (0.0, 6.0, 12.0))]
    setd = dict(tm_method=tm_method, gamma=2.2, exposure=1.4)

    p = default_scene_params(aspect=W / H)
    p = dataclasses.replace(
        p,
        camera=dataclasses.replace(
            p.camera, eye=jnp.asarray(cam["eye"]), rotation=jnp.asarray(cam["rotation"])
        ),
        point_lights=PointLights.from_list(lights),
    )
    s = dataclasses.replace(
        default_settings(),
        tm_method=jnp.int32(tm_method),
        exposure=jnp.float32(setd["exposure"]),
    )
    img_jax = np.asarray(pipeline.render_frame(bufs, p, s, config))

    tris, mats = golden.golden_scene(meshes, objects, materials)
    img_gold = golden.render(
        tris, mats, env.astype(np.float64), cam, sun, lights,
        ambient=0.1, settings=setd, width=W, height=H, shadow_size=SHADOW,
    )

    db = psnr(img_jax, img_gold)
    # Raster edge pixels may disagree (f32 vs f64 edge functions); exclude
    # nothing — PSNR absorbs isolated pixel flips.
    assert db >= 40.0, f"PSNR {db:.2f} dB < 40 dB (tm={tm_method})"
