"""Multi-device rendering: screen-tile-row sharding over a jax.sharding.Mesh.

The reference is strictly single-GPU (SURVEY.md §2 end, §5.8); this module
spreads one frame over the GPUs of a host:

- geometry/scene params are replicated (small); triangle setup and the
  shade-row table are recomputed per device (per-triangle work is a small
  share of the frame and replicating it avoids sharding the pair sort);
- each device bins and rasterizes only its horizontal slab of screen tiles
  through the SAME path as single-device (raster_gbuffer: tiled raster
  kernel + G-buffer resolve, then channel-first shade_gbuffer) — the
  binning sort shrinks per device because row-window rejection happens
  before pair expansion;
- the shadow map is rendered slab-parallel too (depth-only raster), then
  ``all_gather``-ed over the mesh because PCF sampling needs the whole map
  on every device;
- shading/tonemap stay slab-local and channel-first; each device untiles
  only its final u8 slab, and the frame comes out row-sharded.

SPMD via shard_map: XLA inserts one collective for the shadow map and the
scalar max-reductions of the raster health stats; everything else is
embarrassingly parallel. The stats come out replicated (max over devices)
so pipeline.check_stats keeps overflow loud in the ``--devices`` CLI path.
shard_map runs with check_vma=False: the Pallas kernels' outputs carry no
varying-axis types, and the frame test against single-device rendering is
the correctness check.
"""

from __future__ import annotations

import functools
from typing import Sequence

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from arctic_tpu.core.config import RenderConfig
from arctic_tpu.core.scene import SceneBuffers, SceneParams, Settings
from arctic_tpu.models import pipeline
from arctic_tpu.ops import raster, tonemap

Array = jnp.ndarray

AXIS = "tiles"


def make_mesh(num_devices: int | None = None, devices: Sequence | None = None) -> Mesh:
    devs = list(devices or jax.devices())
    if num_devices is not None:
        devs = devs[:num_devices]
    return Mesh(devs, (AXIS,))


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def render_frame_sharded_stats(
    buffers: SceneBuffers,
    params: SceneParams,
    settings: Settings,
    config: RenderConfig,
    mesh: Mesh,
):
    """Full frame over every device in ``mesh``; returns ((H, W, 3) u8
    row-sharded across the mesh axis, stats dict of replicated scalars).

    Runs the same shade-row build, kernels and channel-first shading as
    pipeline.render_frame_stats, restricted to each device's tile rows.
    """
    ndev = mesh.shape[AXIS]
    th, tw = config.tile_h, config.tile_w
    h, w, s = config.height, config.width, config.shadow_size
    st = config.shadow_tile
    sth = config.shadow_tile_h or st

    cam_tile_rows = _round_up(-(-h // th), ndev)
    cam_rows_dev = cam_tile_rows // ndev
    sh_tile_rows = _round_up(-(-s // sth), ndev)
    sh_rows_dev = sh_tile_rows // ndev
    sh_tiles_x = -(-s // st)

    def device_frame(buffers, params, settings):
        from arctic_tpu.ops import raster_tiles

        d = jax.lax.axis_index(AXIS)
        geom = buffers.geometry
        tri_valid = jnp.arange(geom.capacity) < geom.num_tris
        sun_pv = params.sun.proj_view()
        cam_pv = params.camera.proj_view()

        if config.force_bruteforce:
            # Kernel-free debug path: deferred shade over a brute-force slab
            # raster.
            world = pipeline.vertex_world_positions(geom)
            sh_clip = pipeline.to_clip(world, sun_pv)
            sh_clipped = raster.near_clip_triangles(sh_clip, geom.indices, tri_valid)
            sh_setup = raster.setup_screen_triangles(sh_clipped, s, s, cull="front")
            sh_z, _ = raster.rasterize_bruteforce(
                sh_setup, sh_rows_dev * sth, s,
                y_offset=(d * sh_rows_dev * sth).astype(jnp.float32),
            )
            shadow_map = jax.lax.all_gather(sh_z, AXIS, axis=0, tiled=True)[:s, :s]

            clip = pipeline.to_clip(world, cam_pv)
            clipped = raster.near_clip_triangles(clip, geom.indices, tri_valid)
            setup = raster.setup_screen_triangles(clipped, w, h, cull="back")
            y0 = (d * cam_rows_dev * th).astype(jnp.float32)
            _, ibuf = raster.rasterize_bruteforce(
                setup, cam_rows_dev * th, w, y_offset=y0
            )
            hdr = pipeline.shade(
                buffers, params, setup, ibuf, world, shadow_map, sun_pv, config,
                y0=y0,
            )
            if config.hdr_half_round:
                hdr = hdr.astype(jnp.float16).astype(jnp.float32)
            ldr = tonemap.tonemap(
                hdr, settings.tm_method, settings.gamma, settings.exposure
            )
            img = tonemap.to_unorm8(ldr)
            zero = jnp.int32(0)
            return img, zero, zero, zero

        wc = pipeline.world_corners(geom)
        sun_clip = pipeline.corners_clip(wc, sun_pv)

        # Shadow slab (depth-only raster, front-face cull), then the one
        # map-sized collective.
        sh_clipped = raster.near_clip_corners(sun_clip, tri_valid)
        sh_setup = raster.setup_screen_triangles(sh_clipped, s, s, cull="front")
        # Sun-frustum culling composes with slab sharding: the rect is
        # computed from replicated inputs (identical on every device) and
        # bin_triangles subtracts each device's tile_row0, so the gathered
        # map matches the single-device culled map texel-for-texel.
        sh_rect = None
        if config.sun_frustum_cull:
            sh_rect = pipeline.sun_cull_rect(wc, tri_valid, cam_pv, sun_pv, config)
        sh_zt, _, sh_pairs = raster_tiles.bin_and_rasterize(
            sh_setup, config, sh_tiles_x, sh_rows_dev, sth, st,
            tile_row0=d * sh_rows_dev, kind="shadow", depth_only=True,
            rect=sh_rect,
        )
        sh_slab = raster_tiles._untile(sh_zt, sh_rows_dev, sh_tiles_x, sth, st)
        sh_slab = sh_slab[:, :s]
        shadow_map = jax.lax.all_gather(sh_slab, AXIS, axis=0, tiled=True)[:s, :s]

        # Camera slab through the tiled raster + G-buffer resolve.
        clipped = raster.near_clip_corners(
            pipeline.corners_clip(wc, cam_pv), tri_valid
        )
        setup = raster.setup_screen_triangles(clipped, w, h, cull="back")
        shade_rows = pipeline.build_shade_rows(
            setup, geom, sun_pv, wc=wc, lsp=tuple(c[:3] for c in sun_clip)
        )
        ibuf_rows, gbuf, cam_pairs = raster_tiles.raster_gbuffer(
            setup, shade_rows, h, w, config,
            tile_row0=d * cam_rows_dev, tile_rows=cam_rows_dev,
        )
        hdr, tex_fb_rows = pipeline.shade_gbuffer(
            buffers, params, gbuf, ibuf_rows >= 0, shadow_map, config,
            tiles_x=config.tiles_x, tile_row0=d * cam_rows_dev,
        )
        if config.hdr_half_round:
            hdr = hdr.astype(jnp.float16).astype(jnp.float32)
        ldr = tonemap.tonemap(
            hdr, settings.tm_method, settings.gamma, settings.exposure,
            channel_axis=0,
        )
        img = raster_tiles.untile_packed_u8(
            tonemap.to_unorm8(ldr), cam_rows_dev, config.tiles_x, th, tw
        )[:, :w]
        # Replicated overflow stats (max over devices keeps check_stats
        # semantics: ANY device overflowing is a dropped-fragment frame).
        cam_pairs = jax.lax.pmax(cam_pairs, AXIS)
        sh_pairs = jax.lax.pmax(sh_pairs.total_pairs, AXIS)
        tex_fb_rows = jax.lax.pmax(tex_fb_rows, AXIS)
        return img, cam_pairs, sh_pairs, tex_fb_rows

    fn = jax.shard_map(
        device_frame,
        mesh=mesh,
        in_specs=(P(), P(), P()),
        out_specs=(P(AXIS), P(), P(), P()),
        check_vma=False,
    )
    img, cam_pairs, sh_pairs, tex_fb_rows = fn(buffers, params, settings)
    geom_cap = buffers.geometry.capacity
    # Brute-force capacity path reports 0/1 (can't overflow), like _rasterize.
    bf = config.force_bruteforce
    stats = {
        "cam_pairs": cam_pairs,
        "cam_pair_cap": jnp.int32(1 if bf else config.pair_capacity(2 * geom_cap)),
        "shadow_pairs": sh_pairs,
        "shadow_pair_cap": jnp.int32(
            1 if bf else config.pair_capacity(2 * geom_cap, "shadow")
        ),
        "tex_fb_rows": tex_fb_rows,
        "tex_fb_cap": jnp.int32(
            config.tex_group_caps[-1]
            if (not bf and config.tex_group_caps is not None)
            else 1
        ),
    }
    return img[: config.height], stats


def render_frame_sharded(
    buffers: SceneBuffers,
    params: SceneParams,
    settings: Settings,
    config: RenderConfig,
    mesh: Mesh,
) -> Array:
    """Full frame over every device in ``mesh``; returns (H, W, 3) u8,
    row-sharded across the mesh axis."""
    img, _ = render_frame_sharded_stats(buffers, params, settings, config, mesh)
    return img


def make_sharded_renderer(config: RenderConfig, mesh: Mesh):
    return jax.jit(
        functools.partial(render_frame_sharded, config=config, mesh=mesh)
    )


def make_sharded_renderer_stats(config: RenderConfig, mesh: Mesh):
    return jax.jit(
        functools.partial(render_frame_sharded_stats, config=config, mesh=mesh)
    )
