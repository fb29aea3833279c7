"""Tiled rasterizer: one Pallas program per screen tile.

Consumes the per-tile work lists from ops/binning.py. Each program loads its
tile's segment of the sorted (tile, triangle) pair list, walks it in draw
order, and keeps the tile's depth and winning slot id in registers; the
tile is written once at the end. This is the software-rasterizer shape of
GPU renderers without a fixed-function unit: binned tiles, one block per
tile, triangle planes read from an L2-resident table.

Depth semantics match the brute-force rasterizer exactly (LESS with a
strict ``<`` so draw order breaks ties, the same plane arithmetic), which
is what the equivalence tests and the chip check assert.

Pixel layout: each tile's pixels are flattened row-major into an
(S = tile_h * tile_w / 128, 128) block; ``_untile`` restores (H, W). The
shading chain keeps this tile-major "pixel-block" layout end to end and
untiles only the final u8 frame.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from arctic_tpu.core.config import RenderConfig
from arctic_tpu.ops import binning
from arctic_tpu.ops.raster import TriSetup
from arctic_tpu.ops.route import pallas_route

Array = jnp.ndarray

# Shade-row table lanes (pipeline.build_shade_rows): perspective-bary planes
# [0:9), three 17-float corner attribute blocks at [9:26), [26:43), [43:60),
# the 23-float material row at [60:83), zero pad to 88.
SHADE_LANES = 88
CORNER_BASE = (9, 26, 43)
MAT_BASE = 60
N_ATTR = 17
N_MAT = 23

# G-buffer lanes (resolve_gbuffer -> pipeline.shade_gbuffer): interpolated
# attrs [0:17), material row [24:47), zero elsewhere.
GBUF_LANES = 64


def raster_planes(setup: TriSetup) -> Array:
    """(P, 16) f32 per-slot raster rows: A,B,C of the three edges, the z
    plane, zero pad. The kernel reads lanes [0:12) of a row per triangle."""
    comps = [c for e in setup.edges for c in e] + list(setup.zplane)
    z = jnp.zeros_like(comps[0])
    return jnp.stack(comps + [z] * 4, axis=1)


def _raster_kernel(
    seg_start_ref,
    seg_len_ref,
    row0_ref,
    rows_ref,
    *refs,
    tiles_x: int,
    tile_h: int,
    tile_w: int,
    depth_only: bool,
):
    if depth_only:
        (z_ref,) = refs
        slot_ref = i_ref = None
    else:
        slot_ref, z_ref, i_ref = refs
    t = pl.program_id(0)
    start = seg_start_ref[t]
    n = seg_len_ref[t]
    sub = tile_h * tile_w // 128
    lane = jax.lax.broadcasted_iota(jnp.int32, (sub, 128), 1)
    srow = jax.lax.broadcasted_iota(jnp.int32, (sub, 128), 0)
    p = srow * 128 + lane  # row-major pixel index within the tile
    tx = t % tiles_x
    ty = row0_ref[0] + t // tiles_x  # global tile row (sharded slabs)
    px = (tx * tile_w + p % tile_w).astype(jnp.float32) + 0.5
    py = (ty * tile_h + p // tile_w).astype(jnp.float32) + 0.5

    def body(k, carry):
        zbuf, ibuf = carry

        def r(j):
            return rows_ref[k, j]

        # Same expressions, in the same order, as rasterize_bruteforce.
        e0 = r(0) * px + r(1) * py + r(2)
        e1 = r(3) * px + r(4) * py + r(5)
        e2 = r(6) * px + r(7) * py + r(8)
        z = r(9) * px + r(10) * py + r(11)
        # z <= 1 is implied by z < zbuf (zbuf only decreases from 1.0).
        ok = (e0 >= 0.0) & (e1 >= 0.0) & (e2 >= 0.0) & (z >= 0.0) & (z < zbuf)
        zbuf = jnp.where(ok, z, zbuf)
        if ibuf is not None:
            ibuf = jnp.where(ok, slot_ref[k], ibuf)
        return zbuf, ibuf

    zbuf0 = jnp.ones((sub, 128), jnp.float32)
    ibuf0 = None if depth_only else jnp.full((sub, 128), -1, jnp.int32)
    zbuf, ibuf = jax.lax.fori_loop(start, start + n, body, (zbuf0, ibuf0))
    z_ref[...] = zbuf
    if not depth_only:
        i_ref[...] = ibuf


def raster_warps(tile_px: int) -> int:
    """Warps per raster program: 8 (fastest for 32x32 tiles on an H100,
    PERF.md), fewer only when the tile has under 4 pixels per thread."""
    return max(1, min(8, tile_px // 128))


def _untile(buf: Array, tiles_y: int, tiles_x: int, tile_h: int, tile_w: int) -> Array:
    """(num_tiles, S, 128) row-major tile pixels -> (Hp, Wp)."""
    return (
        buf.reshape(tiles_y, tiles_x, tile_h, tile_w)
        .transpose(0, 2, 1, 3)
        .reshape(tiles_y * tile_h, tiles_x * tile_w)
    )


def untile_packed_u8(
    buf: Array, tiles_y: int, tiles_x: int, tile_h: int, tile_w: int
) -> Array:
    """(3, R, 128) channel-leading u8 pixel blocks -> (Hp, Wp, 3) u8.

    RGB packs into one i32 plane so the tile unshuffle moves one plane."""
    r = buf[0].astype(jnp.int32)
    g = buf[1].astype(jnp.int32)
    b = buf[2].astype(jnp.int32)
    packed = r | (g << 8) | (b << 16)  # (R, 128)
    frame = _untile(
        packed.reshape(tiles_y * tiles_x, tile_h * tile_w // 128, 128),
        tiles_y, tiles_x, tile_h, tile_w,
    )  # (Hp, Wp) i32
    return jnp.stack(
        [frame & 0xFF, (frame >> 8) & 0xFF, (frame >> 16) & 0xFF], axis=-1
    ).astype(jnp.uint8)


def pixel_block_centers(r_rows: int, tiles_x: int, tile_h: int, tile_w: int, tile_row0=0):
    """Pixel centers (px, py), each (R, 128) f32, of the pixel-block layout:
    row r lane l is pixel 128 * (r % sub) + l of tile r // sub.

    tile_w divides 128, so the in-tile pixel index factors into per-row and
    per-lane terms (p % tw == lane % tw, p // tw == (r % sub) * (128 // tw)
    + lane // tw)."""
    assert 128 % tile_w == 0, "tile_w must divide a lane row"
    sub = tile_h * tile_w // 128
    r_idx = jnp.arange(r_rows, dtype=jnp.int32)[:, None]
    lane = jnp.arange(128, dtype=jnp.int32)[None, :]
    t_idx = r_idx // sub
    px = ((t_idx % tiles_x) * tile_w + lane % tile_w).astype(jnp.float32) + 0.5
    py = (
        (tile_row0 + t_idx // tiles_x) * tile_h
        + (r_idx % sub) * (128 // tile_w)
        + lane // tile_w
    ).astype(jnp.float32) + 0.5
    return px, py


def resolve_gbuffer(
    shade_rows: Array,
    ibuf_rows: Array,
    tiles_x: int,
    tile_h: int,
    tile_w: int,
    tile_row0=0,
) -> Array:
    """Per-pixel G-buffer from the winning slot ids, in plain XLA.

    shade_rows: (P, SHADE_LANES) from pipeline.build_shade_rows. ibuf_rows:
    (R, 128) i32 slot ids in the pixel-block layout (-1 = uncovered).
    Each covered pixel gathers its slot's row, evaluates the perspective
    barycentrics at its center and interpolates the corner attributes.
    Returns (GBUF_LANES, R, 128) f32, channel-leading, zero where uncovered.
    """
    r_rows = ibuf_rows.shape[0]
    covered = ibuf_rows >= 0
    row = shade_rows[jnp.maximum(ibuf_rows, 0)]  # (R, 128, SHADE_LANES)
    px, py = pixel_block_centers(r_rows, tiles_x, tile_h, tile_w, tile_row0)

    def lane(j):
        return row[..., j]

    bw = [lane(3 * c) * px + lane(3 * c + 1) * py + lane(3 * c + 2) for c in range(3)]
    den = bw[0] + bw[1] + bw[2]
    den = jnp.where(den == 0.0, 1.0, den)
    b = [x / den for x in bw]
    c0, c1, c2 = CORNER_BASE
    attr = [
        b[0] * lane(c0 + j) + b[1] * lane(c1 + j) + b[2] * lane(c2 + j)
        for j in range(N_ATTR)
    ]
    mat = [lane(MAT_BASE + j) for j in range(N_MAT)]
    zero = jnp.zeros_like(px)
    planes = attr + [zero] * (24 - N_ATTR) + mat + [zero] * (GBUF_LANES - 24 - N_MAT)
    gbuf = jnp.stack(planes, axis=0)
    return jnp.where(covered[None], gbuf, 0.0)


def raster_gbuffer(
    setup: TriSetup,
    shade_rows: Array,
    height: int,
    width: int,
    config: RenderConfig,
    tile_row0=0,
    tile_rows: int | None = None,
):
    """Camera-pass visibility + shading-input resolve.

    Returns (ibuf_rows (R, 128) i32, gbuf (GBUF_LANES, R, 128) f32,
    total_pairs) with R = num_tiles * tile_px / 128 (the pixel-block layout;
    see resolve_gbuffer). Everything stays tile-major; callers untile only
    the final u8 frame.
    """
    th, tw = config.tile_h, config.tile_w
    tiles_x = -(-width // tw)
    if tile_rows is None:
        tile_rows = -(-height // th)
    _, it, pairs = bin_and_rasterize(
        setup, config, tiles_x, tile_rows, th, tw, tile_row0, kind="cam"
    )
    ibuf_rows = it.reshape(-1, 128)
    gbuf = resolve_gbuffer(shade_rows, ibuf_rows, tiles_x, th, tw, tile_row0)
    return ibuf_rows, gbuf, pairs.total_pairs


def bin_and_rasterize(
    setup: TriSetup,
    config: RenderConfig,
    tiles_x: int,
    tile_rows: int,
    th: int,
    tw: int,
    tile_row0,
    kind: str = "cam",
    depth_only: bool = False,
    rect=None,
):
    """Bin + tile-raster tile rows [tile_row0, tile_row0 + tile_rows).

    Returns tile-major (zt (T, S, 128) f32, it (T, S, 128) i32 or None,
    pairs). With depth_only no slot ids are produced (the shadow pass
    discards them). ``tile_row0`` may be traced (a device's slab offset).
    """
    assert (th * tw) % 128 == 0, "tile pixel count must fill whole lanes"
    num_tiles = tiles_x * tile_rows
    sub = th * tw // 128
    pair_cap = config.pair_capacity(setup.capacity, kind)
    pairs = binning.bin_triangles(
        setup, tiles_x, tile_rows, tw, th, pair_cap, tile_row0=tile_row0,
        rect=rect,
    )
    if config.debug_overflow:
        jax.debug.print(
            "raster: {}/{} tile-triangle pairs (overflow drops fragments)",
            pairs.total_pairs,
            pair_cap,
        )
    seg_start = pairs.tile_start[:-1]
    seg_len = jnp.diff(pairs.tile_start)
    rows = raster_planes(setup)[pairs.sorted_slot]  # (pair_cap, 16) pair order
    row0 = jnp.asarray(tile_row0, jnp.int32).reshape(1)

    block = pl.BlockSpec((None, sub, 128), lambda t: (t, 0, 0))
    z_shape = jax.ShapeDtypeStruct((num_tiles, sub, 128), jnp.float32)
    i_shape = jax.ShapeDtypeStruct((num_tiles, sub, 128), jnp.int32)
    kernel = functools.partial(
        _raster_kernel, tiles_x=tiles_x, tile_h=th, tile_w=tw,
        depth_only=depth_only,
    )
    args = [seg_start, seg_len, row0, rows]
    if not depth_only:
        args.append(pairs.sorted_slot)
    out = pl.pallas_call(
        kernel,
        grid=(num_tiles,),
        out_specs=[block] if depth_only else [block, block],
        out_shape=[z_shape] if depth_only else [z_shape, i_shape],
        name=f"raster_{kind}",
        **pallas_route(num_warps=raster_warps(th * tw)),
    )(*args)
    zt = out[0]
    it = None if depth_only else out[1]
    return zt, it, pairs


def rasterize_tiled(
    setup: TriSetup,
    height: int,
    width: int,
    config: RenderConfig,
    tile_h: int | None = None,
    tile_w: int | None = None,
    tile_row0=None,
    tile_rows: int | None = None,
    crop: bool = True,
    with_pairs: bool = False,
    kind: str = "cam",
    depth_only: bool = False,
    rect=None,
) -> Tuple[Array, ...]:
    """Binned tiled rasterization; drop-in replacement for the brute force.

    height/width define the *viewport* (NDC mapping and bbox clamp). A
    sharded caller can rasterize only tile rows [tile_row0, tile_row0 +
    tile_rows) of the frame: tile_row0 may be traced (shard offset),
    tile_rows must be static. With crop=False the padded tile-aligned
    buffers are returned (for slice reassembly).
    """
    th = tile_h or config.tile_h
    tw = tile_w or config.tile_w
    tiles_x = -(-width // tw)
    if tile_rows is None:
        tile_rows = -(-height // th)
    if tile_row0 is None:
        tile_row0 = 0
    zt, it, pairs = bin_and_rasterize(
        setup, config, tiles_x, tile_rows, th, tw, tile_row0, kind, depth_only,
        rect=rect,
    )
    zbuf = _untile(zt, tile_rows, tiles_x, th, tw)
    ibuf = None if it is None else _untile(it, tile_rows, tiles_x, th, tw)
    if crop:
        zbuf = zbuf[:height, :width]
        ibuf = None if ibuf is None else ibuf[:height, :width]
    if with_pairs:
        # Overflowing pairs are floated to the sentinel tile and dropped;
        # callers compare total_pairs against pair_cap to make the failure
        # loud (a broken frame must not ship a benchmark number).
        return zbuf, ibuf, pairs.total_pairs
    return zbuf, ibuf
