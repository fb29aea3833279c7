"""pipeline.build_shade_rows (the per-slot shading table) vs a numpy
construction of its lane map (raster_tiles.SHADE_LANES), and the G-buffer
resolve that consumes it."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from arctic_tpu.core.scene import default_scene_params
from arctic_tpu.io.build import build_buffers
from arctic_tpu.io.procedural import cornell_like_scene
from arctic_tpu.models import pipeline
from arctic_tpu.ops import raster, raster_tiles

W, H = 96, 64


def _setup(tri_bucket=256):
    meshes, objects, materials, env = cornell_like_scene()
    bufs = build_buffers(meshes, objects, materials, env, tri_bucket=tri_bucket)
    params = default_scene_params(aspect=W / H)
    params = dataclasses.replace(
        params,
        camera=dataclasses.replace(
            params.camera,
            eye=jnp.asarray([0.0, 3.0, 1.0]),
            rotation=jnp.asarray([-15.0, -90.0]),
        ),
    )
    geom = bufs.geometry
    sun_pv = params.sun.proj_view()
    wc = pipeline.world_corners(geom)
    sun_clip = pipeline.corners_clip(wc, sun_pv)
    tri_valid = jnp.arange(geom.capacity) < geom.num_tris
    clipped = raster.near_clip_corners(
        pipeline.corners_clip(wc, params.camera.proj_view()), tri_valid
    )
    setup = raster.setup_screen_triangles(clipped, W, H, cull="back")
    lsp = tuple(c[:3] for c in sun_clip)
    return bufs, params, geom, setup, sun_pv, wc, lsp


def _numpy_rows(geom, setup, wc, lsp):
    """The lane map built slot by slot in float64."""
    t = geom.capacity
    p = setup.capacity
    f = lambda a: np.asarray(a, np.float64)  # noqa: E731
    sa = f(geom.tri_static_attrs)  # (33, T)
    mr = f(geom.tri_matrow)  # (23, T)
    out = np.zeros((p, raster_tiles.SHADE_LANES))
    for c in range(3):
        s = f(setup.inv_area2) / f(setup.w[c])
        for k in range(3):
            out[:, 3 * c + k] = f(setup.edges[c][k]) * s
    tri = np.arange(p) % t
    att = []  # att[k]: (P, 17) attrs of original corner k
    for k in range(3):
        cols = [f(wc[k][i]) for i in range(3)] + [sa[11 * k + j] for j in range(11)]
        cols += [f(lsp[k][i]) for i in range(3)]
        att.append(np.stack(cols, axis=1)[tri])
    for c, base in enumerate(raster_tiles.CORNER_BASE):
        cb = [f(setup.cb[c][k])[:, None] for k in range(3)]
        out[:, base : base + 17] = cb[0] * att[0] + cb[1] * att[1] + cb[2] * att[2]
    out[:, raster_tiles.MAT_BASE : raster_tiles.MAT_BASE + 23] = mr.T[tri]
    return out


@pytest.mark.parametrize("tri_bucket", [384, 512])
def test_pack_shade_rows_matches_stacked_build(tri_bucket):
    bufs, params, geom, setup, sun_pv, wc, lsp = _setup(tri_bucket)
    got = np.asarray(pipeline.build_shade_rows(setup, geom, sun_pv, wc=wc, lsp=lsp))
    want = _numpy_rows(geom, setup, wc, lsp)
    assert got.shape == (setup.capacity, raster_tiles.SHADE_LANES)
    valid = np.asarray(setup.valid)
    assert valid.sum() > 50  # the aimed camera must actually see the scene
    mb = raster_tiles.MAT_BASE
    # Material lanes are pure copies of static data -> exact everywhere.
    np.testing.assert_array_equal(got[:, mb : mb + 23], want[:, mb : mb + 23])
    np.testing.assert_array_equal(got[:, mb + 23 :], 0.0)
    # Bary planes and blended corner attributes: f32 rounding on valid slots
    # (invalid slots are never rasterized, so no consumer reads them).
    np.testing.assert_allclose(
        got[valid, :mb], want[valid, :mb], rtol=1e-5, atol=1e-5
    )


def test_pack_shade_rows_frame_unchanged():
    """resolve_gbuffer == per-pixel interpolation from the same table in
    numpy: gathers the winning slot row, evaluates the perspective
    barycentrics at the pixel center, zero where uncovered."""
    from arctic_tpu.core.config import RenderConfig

    bufs, params, geom, setup, sun_pv, wc, lsp = _setup()
    config = RenderConfig(width=W, height=H, tile_h=32, tile_w=32)
    rows = pipeline.build_shade_rows(setup, geom, sun_pv, wc=wc, lsp=lsp)
    ibuf_rows, gbuf, _ = raster_tiles.raster_gbuffer(setup, rows, H, W, config)
    ibuf_rows = np.asarray(ibuf_rows)
    gbuf = np.asarray(gbuf)
    rows = np.asarray(rows, np.float64)
    assert gbuf.shape == (raster_tiles.GBUF_LANES,) + ibuf_rows.shape
    assert (ibuf_rows >= 0).mean() > 0.3

    px, py = (np.asarray(a) for a in raster_tiles.pixel_block_centers(
        ibuf_rows.shape[0], config.tiles_x, 32, 32))
    cov = ibuf_rows >= 0
    r = rows[np.maximum(ibuf_rows, 0)]
    bw = [r[..., 3 * c] * px + r[..., 3 * c + 1] * py + r[..., 3 * c + 2] for c in range(3)]
    den = bw[0] + bw[1] + bw[2]
    b = [x / den for x in bw]
    c0, c1, c2 = raster_tiles.CORNER_BASE
    mb = raster_tiles.MAT_BASE
    for j in range(17):
        want = b[0] * r[..., c0 + j] + b[1] * r[..., c1 + j] + b[2] * r[..., c2 + j]
        np.testing.assert_allclose(gbuf[j][cov], want[cov], rtol=2e-4, atol=2e-4)
    np.testing.assert_array_equal(gbuf[24:47][:, cov], np.moveaxis(r[..., mb : mb + 23], -1, 0)[:, cov])
    assert not gbuf[:, ~cov].any(), "uncovered pixels must be zero"
    assert not gbuf[17:24].any() and not gbuf[47:].any()
