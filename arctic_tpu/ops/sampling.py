"""Texture sampling with D3D linear-wrap sampler semantics.

The reference uses one static MIN_MAG_MIP_LINEAR / WRAP sampler everywhere
(forward_pass.cpp:38-51, skybox_pass.cpp:34-41) and creates textures with a
single mip level, so sampling is plain bilinear filtering:

    t = uv * size - 0.5;  texel pair floor(t), floor(t)+1;  fractional lerp

with WRAP addressing applied per *texel* (each of the 4 taps wraps
independently). All material textures live in one 2D atlas; wrap arithmetic
happens in region-local texel space so each texture tiles within itself.

These are pure gathers + elementwise lerps; XLA fuses the weight math into
the surrounding shader. sRGB decode happens at atlas build time
(renderer.cpp:486 creates diffuse SRVs as R8G8B8A8_UNORM_SRGB, i.e. the
hardware decodes *before* filtering — pre-decoding texels is equivalent).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

Array = jnp.ndarray


def _bilinear_gather(data_flat: Array, row_stride: int, iy0, ix0, iy1, ix1, fy, fx, channels: int):
    """4-tap bilinear from a flattened (H*W, C) texture, indices pre-wrapped."""
    def tap(iy, ix):
        return data_flat[iy * row_stride + ix]

    c00 = tap(iy0, ix0)
    c10 = tap(iy0, ix1)
    c01 = tap(iy1, ix0)
    c11 = tap(iy1, ix1)
    fx = fx[..., None]
    fy = fy[..., None]
    top = c00 + (c10 - c00) * fx
    bot = c01 + (c11 - c01) * fx
    return top + (bot - top) * fy


def sample_bilinear_wrap(tex: Array, uv: Array) -> Array:
    """Sample a whole (H, W, C) texture at uv with linear filter + wrap."""
    h, w, c = tex.shape
    t_x = uv[..., 0] * w - 0.5
    t_y = uv[..., 1] * h - 0.5
    ix0 = jnp.floor(t_x).astype(jnp.int32)
    iy0 = jnp.floor(t_y).astype(jnp.int32)
    fx = t_x - ix0
    fy = t_y - iy0
    out = _bilinear_gather(
        tex.reshape(h * w, c).astype(jnp.float32),
        w,
        iy0 % h,
        ix0 % w,
        (iy0 + 1) % h,
        (ix0 + 1) % w,
        fy,
        fx,
        c,
    )
    return out


def sample_atlas(atlas, region: Array, uv: Array) -> Array:
    """Sample an atlas sub-texture bilinearly with per-texture WRAP.

    ``atlas`` is a TextureAtlas: images are packed with a 1-texel *wrapped*
    border (pack_atlas) and the quad table holds four parity-shifted copies
    of every 2x2 texel block, so one bilinear footprint = ONE 16-channel row
    gather — the difference between XLA's fast embedding-lookup path and 4
    scalar gathers per tap. region rows are (y, x, h, w) with (y, x) the
    padded block origin and (h, w) the logical size; wrap addressing is
    exact for arbitrary uv (first texel index mod the logical size; the
    border supplies the +1 neighbour).
    """
    ry = region[..., 0].astype(jnp.int32)
    rx = region[..., 1].astype(jnp.int32)
    rh = region[..., 2].astype(jnp.int32)
    rw = region[..., 3].astype(jnp.int32)
    t_x = uv[..., 0] * rw - 0.5
    t_y = uv[..., 1] * rh - 0.5
    ix0 = jnp.floor(t_x).astype(jnp.int32)
    iy0 = jnp.floor(t_y).astype(jnp.int32)
    fx = (t_x - ix0)[..., None]
    fy = (t_y - iy0)[..., None]
    ys = ry + iy0 % rh + 1  # +1: skip the top/left border row
    xs = rx + ix0 % rw + 1
    bh, bw = atlas.block_grid
    copy = (ys % 2) * 2 + xs % 2
    q = (copy * bh + ys // 2) * bw + xs // 2
    win = atlas.quads[q].astype(jnp.float32)  # (..., 16)
    c00 = win[..., 0:4]
    c10 = win[..., 4:8]
    c01 = win[..., 8:12]
    c11 = win[..., 12:16]
    top = c00 + (c10 - c00) * fx
    bot = c01 + (c11 - c01) * fx
    return top + (bot - top) * fy


def sample_atlas_multi(atlas, regions: Array, uv: Array) -> Array:
    """Sample N sub-textures at the same uv in ONE batched quad gather.

    regions: (..., N, 4); returns (..., N, 4) RGBA — used for the material's
    diffuse/normal/metal-roughness trio (one gather op instead of three).
    """
    ry = regions[..., 0].astype(jnp.int32)
    rx = regions[..., 1].astype(jnp.int32)
    rh = regions[..., 2].astype(jnp.int32)
    rw = regions[..., 3].astype(jnp.int32)
    t_x = uv[..., 0, None] * rw - 0.5
    t_y = uv[..., 1, None] * rh - 0.5
    ix0 = jnp.floor(t_x).astype(jnp.int32)
    iy0 = jnp.floor(t_y).astype(jnp.int32)
    fx = (t_x - ix0)[..., None]
    fy = (t_y - iy0)[..., None]
    ys = ry + iy0 % rh + 1
    xs = rx + ix0 % rw + 1
    bh, bw = atlas.block_grid
    copy = (ys % 2) * 2 + xs % 2
    q = (copy * bh + ys // 2) * bw + xs // 2  # (..., N)
    win = atlas.quads[q].astype(jnp.float32)  # (..., N, 16)
    top = win[..., 0:4] + (win[..., 4:8] - win[..., 0:4]) * fx
    bot = win[..., 8:12] + (win[..., 12:16] - win[..., 8:12]) * fx
    return top + (bot - top) * fy


def sample_quads_flat(quads, block_grid, ry, rx, rh, rw, u, v) -> Array:
    """Bilinear tap from a quad-packed atlas, FLAT channel output.

    quads rows are [c00(C), c10(C), c01(C), c11(C)]; region fields and u/v
    are same-shaped arrays (or scalars). Returns (..., C) lerped channels
    with no rank-raising reshapes — the fused channel-first shading path
    slices individual channels out, keeping every hot array's minor dim the
    pixel dim.
    """
    c = quads.shape[-1] // 4
    ry = jnp.asarray(ry).astype(jnp.int32)
    rx = jnp.asarray(rx).astype(jnp.int32)
    rh = jnp.asarray(rh).astype(jnp.int32)
    rw = jnp.asarray(rw).astype(jnp.int32)
    t_x = u * rw - 0.5
    t_y = v * rh - 0.5
    ix0 = jnp.floor(t_x).astype(jnp.int32)
    iy0 = jnp.floor(t_y).astype(jnp.int32)
    fx = (t_x - ix0)[..., None]
    fy = (t_y - iy0)[..., None]
    ys = ry + iy0 % rh + 1
    xs = rx + ix0 % rw + 1
    bh, bw = block_grid
    copy = (ys % 2) * 2 + xs % 2
    q = (copy * bh + ys // 2) * bw + xs // 2
    win = quads[q]  # (..., 4C) in the table's dtype (bf16 for materials)
    # Barrier before the f32 convert: XLA otherwise converts the full
    # gathered rows first and relayouts them channel-first in f32 (2x the
    # bytes of doing both on the bf16 data).
    win = jax.lax.optimization_barrier(win).astype(jnp.float32)
    top = win[..., :c] + (win[..., c : 2 * c] - win[..., :c]) * fx
    bot = win[..., 2 * c : 3 * c] + (win[..., 3 * c :] - win[..., 2 * c : 3 * c]) * fx
    return top + (bot - top) * fy


def sample_quads_packed(
    quads_packed, block_grid, ry, rx, rh, rw, u, v, channels: int = 4
) -> Array:
    """sample_quads_flat against a dense 8-quads-per-128-lane-row table.

    Packing 8 quads per 128-lane row keeps the table dense; the quad index q
    selects row q//8 and lane group q%8.
    """
    c = channels
    ry = jnp.asarray(ry).astype(jnp.int32)
    rx = jnp.asarray(rx).astype(jnp.int32)
    rh = jnp.asarray(rh).astype(jnp.int32)
    rw = jnp.asarray(rw).astype(jnp.int32)
    t_x = u * rw - 0.5
    t_y = v * rh - 0.5
    ix0 = jnp.floor(t_x).astype(jnp.int32)
    iy0 = jnp.floor(t_y).astype(jnp.int32)
    fx = (t_x - ix0)[..., None]
    fy = (t_y - iy0)[..., None]
    ys = ry + iy0 % rh + 1
    xs = rx + ix0 % rw + 1
    bh, bw = block_grid
    copy = (ys % 2) * 2 + xs % 2
    q = (copy * bh + ys // 2) * bw + xs // 2
    row = quads_packed[q // 8]  # (..., 128) in the table's dtype
    k = q % 8
    w16 = 4 * c
    win = row[..., 0:w16]
    for kk in range(1, 8):
        win = jnp.where(
            (k == kk)[..., None], row[..., w16 * kk : w16 * (kk + 1)], win
        )
    # Keep the table dtype (bf16) through the extraction/relayout — the
    # layout copy then moves half the bytes; texels convert exactly to f32
    # for the lerp.
    win = jax.lax.optimization_barrier(win).astype(jnp.float32)
    top = win[..., :c] + (win[..., c : 2 * c] - win[..., :c]) * fx
    bot = win[..., 2 * c : 3 * c] + (win[..., 3 * c :] - win[..., 2 * c : 3 * c]) * fx
    return top + (bot - top) * fy


def sample_atlas_combined(atlas, region: Array, uv: Array) -> Array:
    """Sample the combined-slot atlas: ONE row gather yields every texture
    slot's bilinear footprint at once.

    region: (..., 4) the material's combined-atlas rect; returns
    (..., len(atlas.combined_slots), 4) RGBA, same order as combined_slots.
    """
    n = len(atlas.combined_slots)
    ry = region[..., 0].astype(jnp.int32)
    rx = region[..., 1].astype(jnp.int32)
    rh = region[..., 2].astype(jnp.int32)
    rw = region[..., 3].astype(jnp.int32)
    t_x = uv[..., 0] * rw - 0.5
    t_y = uv[..., 1] * rh - 0.5
    ix0 = jnp.floor(t_x).astype(jnp.int32)
    iy0 = jnp.floor(t_y).astype(jnp.int32)
    fx = (t_x - ix0)[..., None, None]
    fy = (t_y - iy0)[..., None, None]
    ys = ry + iy0 % rh + 1
    xs = rx + ix0 % rw + 1
    bh, bw = atlas.combined_block_grid
    copy = (ys % 2) * 2 + xs % 2
    q = (copy * bh + ys // 2) * bw + xs // 2
    win = atlas.combined_quads[q].astype(jnp.float32)  # (..., 16 * n)
    win = win.reshape(win.shape[:-1] + (4, n, 4))  # (..., texel, slot, rgba)
    c00, c10, c01, c11 = (win[..., i, :, :] for i in range(4))
    top = c00 + (c10 - c00) * fx
    bot = c01 + (c11 - c01) * fx
    return top + (bot - top) * fy


def srgb_to_linear(c: Array) -> Array:
    """IEC sRGB EOTF, the decode D3D applies to _SRGB formats."""
    c = jnp.asarray(c, jnp.float32)
    return jnp.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)


def linear_to_srgb(c: Array) -> Array:
    c = jnp.asarray(c, jnp.float32)
    return jnp.where(c <= 0.0031308, c * 12.92, 1.055 * c ** (1.0 / 2.4) - 0.055)


def tap_resolve(rows, tqk, eqk, tfx, tfy, efx, efy, c4: int):
    """Quad select + bilinear lerp for the merged texture+environment gather.

    rows: (..., 128) gathered merged rows (bf16 or f32); the other inputs are
    (...) per-pixel planes: tqk the texture quad's slot in its row, eqk the
    environment quad's, and the two lerp weight pairs. Returns (16, ...) f32
    channel planes: [0, c4/4) the lerped texture channels, [c4/4, c4/4+4)
    the lerped environment RGBA, zero above. Arithmetic matches
    sample_quads_flat/_packed exactly (the bf16->f32 convert commutes with
    the selects; the lerp order is identical)."""
    per = 128 // c4
    c = c4 // 4
    x = rows.astype(jnp.float32)
    twin = x[..., 0:c4]
    for kk in range(1, per):
        twin = jnp.where((tqk == kk)[..., None], x[..., c4 * kk : c4 * (kk + 1)], twin)
    tex = lerp_quad(twin, tfx, tfy)  # (..., c)
    ewin = x[..., 0:16]
    for kk in range(1, 8):
        ewin = jnp.where((eqk == kk)[..., None], x[..., 16 * kk : 16 * kk + 16], ewin)
    env = lerp_quad(ewin, efx, efy)  # (..., 4)
    planes = [tex[..., i] for i in range(c)] + [env[..., i] for i in range(4)]
    zero = jnp.zeros_like(tfx)
    return jnp.stack(planes + [zero] * (16 - len(planes)), axis=0)


def pack_tex_rows(combined_quads: Array) -> Array:
    """(Nq, C4) combined-slot quad table -> (ceil(Nq/per), 128) gather rows,
    per = 128 // C4 quads per row (zero-padded lanes when C4 ∤ 128).

    Shared by pipeline.shade_gbuffer's merged texture+environment gather and
    io.build.build_buffers, which precomputes the merged table once per scene
    (rebuilding it per frame cost a 516 MB-traffic concatenate)."""
    c4 = combined_quads.shape[-1]
    per = 128 // c4
    nq_pad = -(-combined_quads.shape[0] // per) * per
    rows = jnp.pad(
        combined_quads, ((0, nq_pad - combined_quads.shape[0]), (0, 0))
    ).reshape(nq_pad // per, per * c4)
    if per * c4 < 128:
        rows = jnp.pad(rows, ((0, 0), (0, 128 - per * c4)))
    return rows


# Tile-atlas geometry (reference-scale textures, io.build.build_tile_atlas):
# 4x8-texel tiles on a (3, 7)-stride grid — every bilinear 2x2 window fits
# the tile at (ys // 3, xs // 7) because ys % 3 <= 2 and xs % 7 <= 6.
TILE_H, TILE_W = 4, 8
TILE_SY, TILE_SX = 3, 7


def tile_index(base, ntx, th, tw, u, v):
    """-> (row, ty, tx, fx, fy): gather row + in-tile window origin for the
    u16-packed tile atlas. Same ``t = uv * size - 0.5`` prologue and
    per-texel WRAP as quad_index; (base, ntx) address the material's tile
    block in the shared table."""
    base = jnp.asarray(base).astype(jnp.int32)
    ntx = jnp.asarray(ntx).astype(jnp.int32)
    th = jnp.asarray(th).astype(jnp.int32)
    tw = jnp.asarray(tw).astype(jnp.int32)
    t_x = u * tw - 0.5
    t_y = v * th - 0.5
    ix0 = jnp.floor(t_x).astype(jnp.int32)
    iy0 = jnp.floor(t_y).astype(jnp.int32)
    fx = t_x - ix0
    fy = t_y - iy0
    ys = iy0 % th + 1  # +1: the wrapped border row
    xs = ix0 % tw + 1
    row = base + (ys // TILE_SY) * ntx + xs // TILE_SX
    return row, ys % TILE_SY, xs % TILE_SX, fx, fy


def tile_tap_resolve(rows, ty, tx, eqk, tfx, tfy, efx, efy):
    """Texture+environment resolve for the tile atlas.

    A gathered (..., 128) i32 row is either a texture tile — lane
    ch2*32 + y*8 + x holds u16 channels (2*ch2 | 2*ch2+1 << 16) of tile texel
    (y, x) — or an environment row (8 bilinear quads of 16 f32 bit-viewed as
    i32). (ty, tx) is the bilinear window's origin in the tile; texels
    dequantize as q * (1/65535) and env lanes bitcast back to f32. Returns
    (16, ...) f32 planes: [0:8) texture channels (diffuse RGB, normal XYZ,
    mr G, mr B), [8:12) env RGBA, zero above."""
    dq = jnp.float32(1.0 / 65535.0)

    def texel(y, x, c2):  # (...) i32 lane c2*32 + y*8 + x of each row
        lane = c2 * 32 + y * 8 + x
        return jnp.take_along_axis(rows, lane[..., None], axis=-1)[..., 0]

    outs = []
    for c2 in range(4):
        c00 = texel(ty, tx, c2)
        c10 = texel(ty, tx + 1, c2)
        c01 = texel(ty + 1, tx, c2)
        c11 = texel(ty + 1, tx + 1, c2)
        for half in range(2):  # channels 2*c2 (low u16) and 2*c2+1 (high)
            def ch(v):
                q = (v & 0xFFFF) if half == 0 else jax.lax.shift_right_logical(v, 16)
                return q.astype(jnp.float32) * dq

            top = ch(c00) + (ch(c10) - ch(c00)) * tfx
            bot = ch(c01) + (ch(c11) - ch(c01)) * tfx
            outs.append(top + (bot - top) * tfy)

    ewin = rows[..., 0:16]
    for kk in range(1, 8):
        ewin = jnp.where((eqk == kk)[..., None], rows[..., 16 * kk : 16 * kk + 16], ewin)
    env = lerp_quad(jax.lax.bitcast_convert_type(ewin, jnp.float32), efx, efy)
    zero = jnp.zeros_like(tfx)
    return jnp.stack(outs + [env[..., i] for i in range(4)] + [zero] * 4, axis=0)


def tile_row_groups(covered, gid_pix, n_groups: int):
    """Per-128-px-row material-group claims for the grouped tile gather.

    covered / gid_pix: (R, 128) — gid_pix is each covered pixel's material
    group (junk on uncovered lanes). Returns (g_lo, g_hi, many): the lowest
    and highest group touched by the row's covered pixels (rows with no
    covered pixels claim group 0: g_lo == g_hi == 0 — their gathers are env
    rows, which every group's slice carries) and whether MORE than two
    distinct groups are touched. Rows touching exactly two groups claim
    BOTH (dual-claim: 2 fast-tier gathers + a per-pixel select beat one
    slow-tier fallback gather ~2.7x — tools/plan_tex_groups on dumped row
    masks); ``many`` rows take the full-table fallback. Shared by the
    render path and pipeline.measure_tex_group_rows so autotuned caps match
    exactly."""
    big = jnp.int32(n_groups)
    gmin = jnp.min(jnp.where(covered, gid_pix, big), axis=1)
    gmax = jnp.max(jnp.where(covered, gid_pix, -1), axis=1)
    has_cov = gmax >= 0
    g_lo = jnp.where(has_cov, gmin, 0)
    g_hi = jnp.where(has_cov, gmax, 0)
    mid = covered & (gid_pix != g_lo[:, None]) & (gid_pix != g_hi[:, None])
    many = jnp.any(mid, axis=1)
    return g_lo, g_hi, many


def tile_tap_resolve_grouped(
    tiles, groups, caps, trow, covered, eqd, gid_pix, g_lo, g_hi, many, aux,
    group_tables=None,
):
    """Compacted per-group tile/env gathers + tap resolve + row reassembly.

    tiles: the full interleaved (N, 128) i32 table (io.build.group_tile_atlas
    layout); groups: TextureAtlas.tile_groups; caps: len(groups)+1 static
    row capacities, each a multiple of 32, last = fallback; trow: (R, 128)
    absolute tile rows of covered pixels; eqd: (R, 128) env-quad row offset
    (eq // 8) for uncovered pixels; gid_pix / g_lo / g_hi / many: per-pixel
    groups and the row claims from tile_row_groups; aux: the 7 per-pixel
    (R, 128) planes tile_tap_resolve consumes (ty, tx, eq%8, tfx, tfy, efx,
    efy). Returns (out16 (16, R, 128) f32, fb_rows scalar).

    Routing (tools/plan_tex_groups, io.texplan): a row claims
    every group its covered pixels touch (at most two — the dual-claim;
    uncovered pixels ride along reading the claiming group's env copy).
    Claimed rows are compacted per group (stable argsort) and gather from
    the group's materialized table. Rows touching >2 groups, or spilling
    ANY of their claimed groups' caps, take a compacted full-table
    fallback. The route is opt-in; the plain full-table gather is the
    default.
    Reassembly is a row permutation per claim plus a per-pixel select
    between a row's two claimed streams — every pixel sees bit-identical
    gather rows and aux values to the plain path, so the frame is
    BIT-IDENTICAL (tests/test_tex_groups.py). fb_rows > caps[-1] means
    fallback overflow: those rows carry another row's values — the caller
    must treat it like pair-buffer overflow (pipeline.check_stats raises).
    """
    g_n = len(groups)
    assert len(caps) == g_n + 1 and all(c % 32 == 0 and c > 0 for c in caps)
    assert trow.ndim == 2 and trow.shape[1] == 128
    r = trow.shape[0]
    pad = -r % 32
    rp = r + pad
    caps = tuple(min(c, rp) for c in caps)  # a cap never needs > all rows
    if pad:
        trow = jnp.pad(trow, ((0, pad), (0, 0)))
        covered = jnp.pad(covered, ((0, pad), (0, 0)))
        eqd = jnp.pad(eqd, ((0, pad), (0, 0)))
        gid_pix = jnp.pad(gid_pix, ((0, pad), (0, 0)))
        g_lo = jnp.pad(g_lo, (0, pad))
        g_hi = jnp.pad(g_hi, (0, pad))
        many = jnp.pad(many, (0, pad))
        aux = [jnp.pad(a, ((0, pad), (0, 0))) for a in aux]

    ranks, kepts = [], []
    for g in range(g_n):
        member = (~many) & ((g_lo == g) | (g_hi == g))
        rank = jnp.cumsum(member.astype(jnp.int32)) - 1
        kepts.append(member & (rank < caps[g]))
        ranks.append(rank)
    # A dual row that spills EITHER claimed cap demotes whole to fallback
    # (its kept slot in the other group goes unread — junk, never consumed).
    ok_lo = jnp.zeros((rp,), bool)
    ok_hi = jnp.zeros((rp,), bool)
    for g in range(g_n):
        ok_lo = ok_lo | ((g_lo == g) & kepts[g])
        ok_hi = ok_hi | ((g_hi == g) & kepts[g])
    fb = many | ~(ok_lo & ok_hi)
    fb_rows = jnp.sum(fb.astype(jnp.int32))
    fb_rank = jnp.cumsum(fb.astype(jnp.int32)) - 1

    outs = []
    for g in range(g_n):
        lo, env_base, hi = groups[g][:3]
        # A materialized table, not tiles[lo:hi]: XLA fuses the slice into
        # the gather, whose operand is then the full table.
        src = group_tables[g] if group_tables is not None else tiles[lo:hi]
        order = jnp.argsort(jnp.where(kepts[g], 0, 1), stable=True)[: caps[g]]
        # Per-part idx: covered pixels their tile row, uncovered this
        # group's env copy (slice-local). Non-member pixels of a dual row
        # (the OTHER group's pixels) clip to junk inside the slice — their
        # values are discarded by the reassembly select.
        idx_g = jnp.where(covered, trow - lo, (env_base - lo) + eqd)
        cidx = jnp.clip(idx_g, 0, hi - lo - 1)[order]
        caux = [a[order] for a in aux]
        outs.append(tile_tap_resolve(src[cidx], *caux))
    fb_order = jnp.argsort(jnp.where(fb, 0, 1), stable=True)[: caps[g_n]]
    idx_fb = jnp.where(covered, trow, groups[0][1] + eqd)
    cidx = jnp.clip(idx_fb, 0, tiles.shape[0] - 1)[fb_order]
    caux = [a[fb_order] for a in aux]
    outs.append(tile_tap_resolve(tiles[cidx], *caux))

    stream = jnp.concatenate(outs, axis=1)  # (16, sum(caps), 128)
    offs = [0]
    for c in caps:
        offs.append(offs[-1] + c)
    srow_lo = jnp.zeros((rp,), jnp.int32)
    srow_hi = jnp.zeros((rp,), jnp.int32)
    for g in range(g_n):
        at = offs[g] + jnp.clip(ranks[g], 0, caps[g] - 1)
        srow_lo = jnp.where((~fb) & (g_lo == g), at, srow_lo)
        srow_hi = jnp.where((~fb) & (g_hi == g), at, srow_hi)
    fb_at = offs[g_n] + jnp.clip(fb_rank, 0, caps[g_n] - 1)
    srow_lo = jnp.where(fb, fb_at, srow_lo)
    srow_hi = jnp.where(fb, fb_at, srow_hi)
    # Per-pixel pick: a covered pixel of the row's high group reads the hi
    # stream; everything else (low-group, uncovered/env) the lo stream.
    # Uniform and fallback rows have srow_hi == srow_lo, so the pick is a
    # no-op there.
    pick_hi = covered & (gid_pix == g_hi[:, None])
    planes = [
        jnp.where(pick_hi, stream[ch][srow_hi], stream[ch][srow_lo])
        for ch in range(16)
    ]
    out16 = jnp.stack(planes, axis=0)[:, :r, :]
    return out16, fb_rows


def quad_index(block_grid, ry, rx, rh, rw, u, v):
    """Shared index math of the quad samplers -> (q, fx, fy).

    Identical arithmetic to sample_quads_flat/_packed's prologue (bit-exact
    taps when a caller gathers the same quad row itself, e.g. the merged
    texture+environment gather in pipeline.shade_gbuffer).
    """
    ry = jnp.asarray(ry).astype(jnp.int32)
    rx = jnp.asarray(rx).astype(jnp.int32)
    rh = jnp.asarray(rh).astype(jnp.int32)
    rw = jnp.asarray(rw).astype(jnp.int32)
    t_x = u * rw - 0.5
    t_y = v * rh - 0.5
    ix0 = jnp.floor(t_x).astype(jnp.int32)
    iy0 = jnp.floor(t_y).astype(jnp.int32)
    fx = t_x - ix0
    fy = t_y - iy0
    ys = ry + iy0 % rh + 1
    xs = rx + ix0 % rw + 1
    bh, bw = block_grid
    copy = (ys % 2) * 2 + xs % 2
    q = (copy * bh + ys // 2) * bw + xs // 2
    return q, fx, fy


def lerp_quad(win: Array, fx, fy) -> Array:
    """Bilinear lerp of a gathered f32 [c00|c10|c01|c11] quad window."""
    c = win.shape[-1] // 4
    fx = fx[..., None]
    fy = fy[..., None]
    top = win[..., :c] + (win[..., c : 2 * c] - win[..., :c]) * fx
    bot = win[..., 2 * c : 3 * c] + (win[..., 3 * c :] - win[..., 2 * c : 3 * c]) * fx
    return top + (bot - top) * fy
