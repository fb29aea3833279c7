"""Equivalence tests between sampling variants used in different paths."""

import numpy as np
import jax.numpy as jnp

from arctic_tpu.core.scene import TextureAtlas
from arctic_tpu.io.build import pack_atlas, pack_atlas_quads
from arctic_tpu.ops import sampling, sky


def _atlas(rng, shapes):
    imgs = [rng.uniform(0, 1, s).astype(np.float32) for s in shapes]
    data, locs = pack_atlas(imgs)
    return (
        TextureAtlas(
            data=jnp.asarray(data),
            quads=jnp.asarray(pack_atlas_quads(data)),
            regions=jnp.asarray(locs.reshape(1, len(shapes), 4)),
        ),
        imgs,
        locs,
    )


def test_multi_matches_single(rng):
    atlas, imgs, locs = _atlas(rng, [(8, 16, 4), (4, 4, 4), (32, 8, 4)])
    uv = rng.uniform(-1.0, 2.0, (40, 2)).astype(np.float32)
    regions = jnp.broadcast_to(jnp.asarray(locs), (40, 3, 4))
    multi = np.asarray(sampling.sample_atlas_multi(atlas, regions, jnp.asarray(uv)))
    for i in range(3):
        single = np.asarray(
            sampling.sample_atlas(atlas, jnp.asarray(locs[i]), jnp.asarray(uv))
        )
        np.testing.assert_array_equal(multi[:, i], single)


def test_env_atlas_matches_raw_sampling(rng):
    env = rng.uniform(0, 30, (16, 32, 3)).astype(np.float32)
    rgba = np.concatenate([env, np.ones((16, 32, 1), np.float32)], -1)
    data, locs = pack_atlas([rgba])
    env_atlas = TextureAtlas(
        data=jnp.asarray(data),
        quads=jnp.asarray(pack_atlas_quads(data)),
        regions=jnp.asarray(locs.reshape(1, 1, 4)),
    )

    class EnvLike:
        atlas = env_atlas
        data = jnp.asarray(env)

    dirs = rng.normal(size=(100, 3)).astype(np.float32)
    via_atlas = np.asarray(sky.sample_environment(EnvLike(), jnp.asarray(dirs)))
    via_raw = np.asarray(sky.sample_environment(jnp.asarray(env), jnp.asarray(dirs)))
    np.testing.assert_allclose(via_atlas, via_raw, rtol=1e-6, atol=1e-6)


def _tile_oracle(img8, u, v):
    """Reference bilinear of the u16-quantized 8-channel image with WRAP,
    f32 op order matching _tile_tap_resolve_kernel exactly."""
    h, w = img8.shape[:2]
    q = np.floor(np.clip(img8.astype(np.float32) * 65535.0 + 0.5, 0, 65535))
    q = q.astype(np.float32) * np.float32(1.0 / 65535.0)
    t_x = (u * w - 0.5).astype(np.float32)
    t_y = (v * h - 0.5).astype(np.float32)
    ix0 = np.floor(t_x).astype(np.int64)
    iy0 = np.floor(t_y).astype(np.int64)
    fx = (t_x - ix0)[..., None].astype(np.float32)
    fy = (t_y - iy0)[..., None].astype(np.float32)

    def tex(iy, ix):
        return q[iy % h, ix % w]

    c00 = tex(iy0, ix0)
    c10 = tex(iy0, ix0 + 1)
    c01 = tex(iy0 + 1, ix0)
    c11 = tex(iy0 + 1, ix0 + 1)
    top = c00 + (c10 - c00) * fx
    bot = c01 + (c11 - c01) * fx
    return top + (bot - top) * fy


def test_tile_atlas_sampler_matches_oracle(rng):
    """build_tile_atlas + tile_index + tile_tap_resolve reproduce bilinear
    WRAP sampling of the u16-quantized source exactly (reference-scale
    texture path)."""
    from arctic_tpu.io.build import build_tile_atlas

    imgs = [
        rng.uniform(0, 1, (33, 17, 8)).astype(np.float32),
        rng.uniform(0, 1, (20, 40, 8)).astype(np.float32),
    ]
    tiles, meta = build_tile_atlas(imgs)
    # Fake env rows appended (the kernel always resolves an env quad).
    env_rows = np.zeros((4, 128), np.float32).view(np.int32)
    table = jnp.asarray(np.concatenate([tiles, env_rows]))

    n = 4096
    u = rng.uniform(-1.5, 2.5, n).astype(np.float32)  # exercises WRAP
    v = rng.uniform(-1.5, 2.5, n).astype(np.float32)
    mat = rng.integers(0, 2, n)

    base = jnp.asarray(meta[mat, 0].astype(np.float32))
    ntx = jnp.asarray(meta[mat, 1].astype(np.float32))
    th = jnp.asarray(meta[mat, 2].astype(np.float32))
    tw = jnp.asarray(meta[mat, 3].astype(np.float32))
    row, ty, tx, fx, fy = sampling.tile_index(base, ntx, th, tw, u, v)
    rows = table[row]
    zero = jnp.zeros(n, jnp.int32)
    zf = jnp.zeros(n, jnp.float32)
    out16 = sampling.tile_tap_resolve(rows, ty, tx, zero, fx, fy, zf, zf)
    got = np.asarray(out16[:8]).reshape(8, -1).T  # (n, 8)

    want = np.stack(
        [_tile_oracle(imgs[m], u[i], v[i]) for i, m in enumerate(mat)]
    )
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-7)


def test_tile_pipeline_matches_quad_path(monkeypatch):
    """Forcing the tile atlas on a small scene must reproduce the quad-path
    frame to within texel-quantization noise (u16-linear vs bf16 texels)."""
    import dataclasses

    from arctic_tpu.core.config import RenderConfig
    from arctic_tpu.core.scene import PointLights, default_scene_params, default_settings
    from arctic_tpu.io import build
    from arctic_tpu.io.build import build_buffers
    from arctic_tpu.io.procedural import cornell_like_scene
    from arctic_tpu.models import pipeline

    meshes, objects, materials, env = cornell_like_scene()
    config = RenderConfig(width=128, height=96, shadow_size=128)
    p = default_scene_params(aspect=128 / 96)
    p = dataclasses.replace(
        p,
        camera=dataclasses.replace(
            p.camera, eye=jnp.asarray([0.0, 4.0, 3.0]),
            rotation=jnp.asarray([-25.0, -90.0]),
        ),
        point_lights=PointLights.from_list([((0.0, 1.0, 0.0), (10.0, 0.0, 0.0))]),
    )
    s = default_settings()

    bufs_quad = build_buffers(meshes, objects, materials, env, tri_bucket=256)
    img_quad = np.asarray(pipeline.render_frame(bufs_quad, p, s, config))

    monkeypatch.setattr(build, "TILE_ATLAS_THRESHOLD_TEXELS", 0)
    bufs_tile = build_buffers(meshes, objects, materials, env, tri_bucket=256)
    assert bufs_tile.atlas.tiles is not None
    img_tile = np.asarray(pipeline.render_frame(bufs_tile, p, s, config))

    diff = np.abs(img_tile.astype(int) - img_quad.astype(int))
    mse = np.mean(diff.astype(np.float64) ** 2)
    db = 10 * np.log10(255.0**2 / max(mse, 1e-12))
    assert db >= 45.0, f"tile path diverges from quad path: {db:.1f} dB"
    assert diff.max() <= 8, f"tile path max diff {diff.max()} LSB"
