"""End-to-end GLB asset test: loader -> build -> pipeline -> f64 oracle.

Without it the loader would only be exercised on a 2-triangle synthetic
glTF; real Khronos assets use interleaved/normalized
accessors, multi-primitive meshes, nested node TRS, shared meshes, embedded
textures. tests/glb_fixture.py builds a GLB using all of those WITH ground
truth, so this file checks (a) the loader's numeric output exactly and
(b) the rendered frame against the independent float64 oracle.
Semantics spec: /root/reference/src/app.cpp:173-385.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp

from arctic_tpu.core.config import RenderConfig
from arctic_tpu.core.scene import PointLights, default_scene_params, default_settings
from arctic_tpu.io.build import build_buffers
from arctic_tpu.io.gltf import load_gltf
from arctic_tpu.io.procedural import gradient_environment
from arctic_tpu.models import golden, pipeline
from tests.glb_fixture import build_fixture_glb


def _load(tmp_path):
    glb, truth = build_fixture_glb()
    p = tmp_path / "fixture.glb"
    p.write_bytes(glb)
    meshes, objects, materials = load_gltf(str(p))
    return meshes, objects, materials, truth


def test_loader_exact_against_ground_truth(tmp_path):
    meshes, objects, materials, truth = _load(tmp_path)
    assert len(meshes) == 3, "3 primitives across 2 meshes"
    assert len(objects) == 5, "mesh A shared by 2 nodes (2 prims each) + mesh B"

    for got, want in zip(meshes, truth["prims"]):
        np.testing.assert_array_equal(got.positions, want["positions"])
        np.testing.assert_array_equal(got.normals, want["normals"])
        np.testing.assert_allclose(got.uvs, want["uvs_flipped"], atol=1e-4)
        np.testing.assert_array_equal(got.indices, want["indices"])
        assert got.material == want["material"]

    # Normalized u16 texcoords decode as v / 65535 exactly.
    u16 = truth["prims"][0]["uv_raw_u16"].astype(np.float32) / 65535.0
    got_uv = meshes[0].uvs.copy()
    got_uv[:, 1] = 1.0 - got_uv[:, 1]
    np.testing.assert_array_equal(got_uv, u16)

    # TANGENT accessor honored (bitangent = cross(n, t) * w).
    t4 = truth["prims"][1]["tangent4"]
    np.testing.assert_array_equal(meshes[1].tangents, t4[:, :3])
    expected_b = np.cross(truth["prims"][1]["normals"], t4[:, :3]) * t4[:, 3:4]
    np.testing.assert_array_equal(meshes[1].bitangents, expected_b)

    # Node flattening: world TRS per instance (order-independent check).
    want_set = [(w, f) for w, f in truth["objects"]]
    assert len(objects) == len(want_set)
    used = set()
    for got_trs, got_flat in objects:
        hit = None
        for j, (w_trs, w_flat) in enumerate(want_set):
            if j in used or w_flat != got_flat:
                continue
            if np.allclose(got_trs, w_trs, atol=1e-6):
                hit = j
                break
        assert hit is not None, f"no ground-truth match for object (prim {got_flat})\n{got_trs}"
        used.add(hit)

    # Embedded PNG (bufferView) and data-URI textures decode exactly.
    np.testing.assert_array_equal(materials[0].diffuse, truth["tex0"])
    np.testing.assert_array_equal(materials[1].diffuse, truth["tex1"])


def test_glb_end_to_end_psnr(tmp_path):
    """Loaded GLB through the full (fused, tiled) pipeline vs the oracle."""
    meshes, objects, materials, _ = _load(tmp_path)
    env = gradient_environment(32, 64)
    bufs = build_buffers(meshes, objects, materials, env, tri_bucket=64)

    W, H, SHADOW = 160, 120, 200
    cam = dict(eye=[0.0, 2.5, 6.0], rotation=[-12.0, -90.0], aspect=W / H,
               fov_y=45.0, z_near=0.1, z_far=1000.0)
    sun = dict(position=[-10.0, 32.0, -2.48], rotation=[-70.0, 12.0], color=[8.0, 8.0, 8.0])
    lights = [((2.0, 3.0, 2.0), (12.0, 10.0, 6.0))]
    p = default_scene_params(aspect=W / H)
    p = dataclasses.replace(
        p,
        camera=dataclasses.replace(
            p.camera, eye=jnp.asarray(cam["eye"]), rotation=jnp.asarray(cam["rotation"])
        ),
        point_lights=PointLights.from_list(lights),
    )
    s = default_settings()
    config = RenderConfig(width=W, height=H, shadow_size=SHADOW)
    img, stats = pipeline.render_frame_stats(bufs, p, s, config)
    pipeline.check_stats(stats)
    img = np.asarray(img)
    assert img.std() > 5.0, "scene not visible"

    tris, mats = golden.golden_scene(meshes, objects, materials)
    img_gold = golden.render(
        tris, mats, np.asarray(env, np.float64), cam, sun, lights,
        ambient=0.1, settings=dict(tm_method=0, gamma=2.2, exposure=1.0),
        width=W, height=H, shadow_size=SHADOW,
    )
    mse = np.mean((img.astype(np.float64) - img_gold.astype(np.float64)) ** 2)
    db = 10 * np.log10(255.0**2 / mse)
    assert db >= 40.0, f"GLB end-to-end PSNR {db:.2f} dB < 40 dB"
