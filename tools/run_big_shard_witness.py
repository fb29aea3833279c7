"""Bench-shaped multi-device witness at FULL slab geometry.

Renders 960x540 with a 2000^2 shadow map — the largest CPU-compilable
config with 1080p-class tile geometry (9 camera tile rows NOT divisible by
the 8 devices, so slabs round up with partial/empty windows; sun-frustum
cull on) — on an 8-device virtual CPU mesh AND single-device.

Asserted guarantees:
  1. the all-gathered SHADOW MAP is bit-exact vs single-device (0.0 diff —
     in-rect tiles get identical pair lists and the kernel math is
     identical per tile, so slab composition is exact);
  2. the frame matches to >= 55 dB with <= 0.05% of pixels above 2 LSB.
     Frame equality cannot be exact across DIFFERENT XLA programs: the
     sharded and single programs fuse/FMA the triangle-setup and
     interpolation chains differently, and a pixel where two triangles'
     interpolated depths (or a PCF tap compare) agree within ~1 ulp can
     flip discretely. Measured at this shape: exactly 1 px of 518k
     (0.0002%) differs, by 46 LSB — a depth-tie winner flip (the debug
     session pinned the shadow map exact and the pixel's 25-tap PCF
     insensitive to +-1e-7 wiggles, leaving the visibility winner as the
     flipping decision). The small dryrun shapes (128x96, 192x136) hold
     <= 1 LSB and keep the strict check (__graft_entry__.py).

Many minutes of CPU compile and interpreted kernels; run on demand.

Usage: python tools/run_big_shard_witness.py
"""

import os
import sys

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
).strip()

import jax

jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import time

import numpy as np

import __graft_entry__ as ge
from arctic_tpu.models import pipeline
from arctic_tpu.parallel import sharding


def main():
    n_devices = 8
    assert len(jax.devices()) >= n_devices
    w, h, s = 960, 540, 2000
    config, buffers, params, settings = ge._small_scene(w, h, s)
    n_cam_rows = -(-h // config.tile_h)
    n_sh_rows = -(-s // config.shadow_tile)
    print(
        f"config: {w}x{h} shadow={s}, cam tile rows {n_cam_rows}, shadow "
        f"tile rows {n_sh_rows}, {n_devices} devices "
        f"(divisible: cam={n_cam_rows % n_devices == 0}, "
        f"shadow={n_sh_rows % n_devices == 0}), "
        f"cull={config.sun_frustum_cull}"
    )
    mesh = sharding.make_mesh(n_devices)
    t0 = time.time()
    render = sharding.make_sharded_renderer_stats(config, mesh)
    img, rstats = render(buffers, params, settings)
    img = np.asarray(img)
    print(f"sharded frame done ({time.time() - t0:.0f} s)")
    pipeline.check_stats(rstats)
    assert img.shape == (h, w, 3) and img.max() > 0

    t0 = time.time()
    img_single = np.asarray(pipeline.render_frame(buffers, params, settings, config))
    print(f"single-device frame done ({time.time() - t0:.0f} s)")
    diff = np.abs(img.astype(int) - img_single.astype(int))
    frac_any = (diff > 0).mean()
    frac_big = (diff.max(axis=-1) > 2).mean()
    mse = np.mean(diff.astype(np.float64) ** 2)
    db = 10 * np.log10(255.0**2 / mse) if mse > 0 else np.inf
    assert db >= 55.0, f"{db:.1f} dB < 55"
    assert frac_big <= 0.0005, f"{frac_big:.4%} px differ by > 2 LSB"
    print(
        f"frame: {db:.1f} dB, {frac_any:.4%} px differ at all, "
        f"{frac_big:.4%} px > 2 LSB (max {diff.max()} — see module docstring "
        f"for the knife-edge mechanism)"
    )

    # The strong bit-level guarantee: the slab-composed shadow map must be
    # EXACT (catches any real tile_row0 / cull-rect / all-gather bug).
    import dataclasses

    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from arctic_tpu.ops import raster, raster_tiles

    geom = buffers.geometry
    st = config.shadow_tile
    sth = config.shadow_tile_h or st
    sh_tile_rows = sharding._round_up(-(-s // sth), n_devices)
    sh_rows_dev = sh_tile_rows // n_devices
    sh_tiles_x = -(-s // st)

    def single_map():
        sun_pv = params.sun.proj_view()
        cam_pv = params.camera.proj_view()
        wc = pipeline.world_corners(geom)
        tri_valid = jnp.arange(geom.capacity) < geom.num_tris
        rect = pipeline.sun_cull_rect(wc, tri_valid, cam_pv, sun_pv, config)
        zb, _, _ = pipeline.shadow_pass(
            geom, sun_pv, config,
            sun_clip=pipeline.corners_clip(wc, sun_pv), cull_rect=rect,
        )
        return zb

    def dev_map(buffers, params):
        d = jax.lax.axis_index(sharding.AXIS)
        g = buffers.geometry
        tri_valid = jnp.arange(g.capacity) < g.num_tris
        sun_pv = params.sun.proj_view()
        cam_pv = params.camera.proj_view()
        wc = pipeline.world_corners(g)
        sh_clipped = raster.near_clip_corners(
            pipeline.corners_clip(wc, sun_pv), tri_valid
        )
        sh_setup = raster.setup_screen_triangles(sh_clipped, s, s, cull="front")
        sh_rect = pipeline.sun_cull_rect(wc, tri_valid, cam_pv, sun_pv, config)
        sh_zt, _, _ = raster_tiles.bin_and_rasterize(
            sh_setup, config, sh_tiles_x, sh_rows_dev, sth, st,
            tile_row0=d * sh_rows_dev, kind="shadow", depth_only=True,
            rect=sh_rect,
        )
        slab = raster_tiles._untile(sh_zt, sh_rows_dev, sh_tiles_x, sth, st)
        return jax.lax.all_gather(
            slab[:, :s], sharding.AXIS, axis=0, tiled=True
        )[:s, :s]

    sm_single = np.asarray(jax.jit(single_map)())
    sm_multi = np.asarray(
        jax.jit(
            jax.shard_map(
                dev_map, mesh=mesh, in_specs=(P(), P()),
                out_specs=P(sharding.AXIS, None), check_vma=False,
            )
        )(buffers, params)
    )[:s]
    dmap = np.abs(sm_multi - sm_single)
    assert dmap.max() == 0.0, f"shadow map differs by {dmap.max()}"
    print(
        f"WITNESS OK: 8-device {w}x{h}/{s}: shadow map BIT-EXACT, frame "
        f"{db:.1f} dB / max {diff.max()} LSB on {frac_any:.4%} px"
    )


if __name__ == "__main__":
    main()
