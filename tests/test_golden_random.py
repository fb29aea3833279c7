"""Randomized-scene golden conformance: random primitives, lights and
settings vs the float64 oracle. Catches interaction bugs the curated scenes
miss (odd orientations, grazing triangles, off-axis cameras)."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest

from arctic_tpu.core.config import RenderConfig
from arctic_tpu.core.scene import PointLights, default_scene_params, default_settings
from arctic_tpu.io.build import MaterialImages, build_buffers
from arctic_tpu.io.procedural import (
    box_mesh,
    checker_texture,
    bumpy_normal_texture,
    gradient_environment,
    mr_texture,
    solid_texture,
    transform,
    uv_sphere,
)
from arctic_tpu.models import golden, pipeline

W, H, SHADOW = 128, 96, 160


def psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return 10 * np.log10(255.0**2 / mse) if mse > 0 else np.inf


def random_scene(seed):
    rng = np.random.default_rng(seed)
    materials = [
        MaterialImages(
            checker_texture(32, int(rng.integers(2, 8)),
                            tuple(rng.integers(40, 255, 3)), tuple(rng.integers(20, 120, 3))),
            bumpy_normal_texture(32, int(rng.integers(2, 8)), float(rng.uniform(0, 0.5))),
            mr_texture(float(rng.uniform(0, 1)), float(rng.uniform(0.1, 1))),
        )
        for _ in range(3)
    ]
    meshes, objects = [], []
    for i in range(6):
        if rng.uniform() < 0.5:
            meshes.append(box_mesh(*rng.uniform(0.5, 2.5, 3), material=int(rng.integers(0, 3))))
        else:
            meshes.append(uv_sphere(rng.uniform(0.4, 1.2), 8, 12, material=int(rng.integers(0, 3))))
        objects.append(
            (
                transform(
                    translate=(rng.uniform(-4, 4), rng.uniform(0, 3), rng.uniform(-9, -3)),
                    yaw_deg=float(rng.uniform(0, 360)),
                ),
                i,
            )
        )
    env = gradient_environment(32, 64, sun_dir=rng.uniform(0.2, 1, 3))
    lights = [
        (tuple(rng.uniform(-4, 4, 3) + [0, 2, -5]), tuple(rng.uniform(0, 20, 3)))
        for _ in range(int(rng.integers(0, 4)))
    ]
    cam = dict(
        eye=[float(v) for v in rng.uniform(-1, 1, 3) + [0, 2.5, 1]],
        rotation=[float(rng.uniform(-35, -5)), float(rng.uniform(-120, -60))],
        aspect=W / H, fov_y=45.0, z_near=0.1, z_far=1000.0,
    )
    return meshes, objects, materials, env, lights, cam


@pytest.mark.parametrize("seed", [11, 23, 47])
def test_random_scene_matches_golden(seed):
    meshes, objects, materials, env, lights, cam = random_scene(seed)
    bufs = build_buffers(meshes, objects, materials, env, tri_bucket=512)
    config = RenderConfig(width=W, height=H, shadow_size=SHADOW, force_bruteforce=True)
    tm = seed % 3
    sun = dict(position=[-10.0, 32.0, -2.48], rotation=[-70.0, 12.0], color=[8.0, 8.0, 8.0])

    p = default_scene_params(aspect=W / H)
    p = dataclasses.replace(
        p,
        camera=dataclasses.replace(
            p.camera, eye=jnp.asarray(cam["eye"]), rotation=jnp.asarray(cam["rotation"])
        ),
        point_lights=PointLights.from_list(lights),
    )
    s = dataclasses.replace(default_settings(), tm_method=jnp.int32(tm))
    img_jax = np.asarray(pipeline.render_frame(bufs, p, s, config))

    tris, mats = golden.golden_scene(meshes, objects, materials)
    img_gold = golden.render(
        tris, mats, env.astype(np.float64), cam, sun, lights,
        ambient=0.1, settings=dict(tm_method=tm, gamma=2.2, exposure=1.0),
        width=W, height=H, shadow_size=SHADOW,
    )
    db = psnr(img_jax, img_gold)
    assert db >= 40.0, f"seed {seed}: PSNR {db:.2f} dB < 40"
