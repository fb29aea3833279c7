"""The frame pipeline: Arctic's 4-pass frame graph as one jitted function.

Reference frame (renderer.cpp:274-415): shadow-map pass -> barrier -> forward
PBR pass -> skybox pass -> barriers -> compute post-process -> copy to
backbuffer.  Here the passes are pure functions over arrays; XLA's dataflow
ordering replaces all 9 resource barriers and the fences (SURVEY.md §2 end),
and "descriptor heaps" are just pytree fields.

Differences by design (not behavior):
- rasterization writes a visibility buffer; shading is deferred so PBR math
  runs once per pixel (the reference shades during raster; with depth-test
  LESS and opaque geometry the final pixel values are identical, modulo
  overdraw the reference pays and we don't)
- the skybox is composited analytically where the visibility buffer is empty
  (see ops/sky.py) — pixel-equivalent to the cube draw at z == far
- the HDR target's R16G16B16A16_FLOAT storage is emulated by an f16
  round-trip before post-processing (config.hdr_half_round)
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp

from arctic_tpu.core import maths
from arctic_tpu.core.config import RenderConfig
from arctic_tpu.core.scene import (
    MAX_POINT_LIGHTS,
    Geometry,
    SceneBuffers,
    SceneParams,
    Settings,
)
from arctic_tpu.ops import pbr, raster, shadow, sky, tonemap
from arctic_tpu.ops.sampling import (
    sample_atlas_combined,
    sample_atlas_multi,
    sample_quads_flat,
)

Array = jnp.ndarray

def vertex_world_positions(geom: Geometry) -> Array:
    """Apply per-object TRS to vertices (depth.hlsl:9 / forward.hlsl:52)."""
    trs = geom.object_trs[geom.vertex_object]  # (V, 4, 4)
    ph = jnp.concatenate(
        [geom.positions, jnp.ones((geom.positions.shape[0], 1), jnp.float32)], axis=1
    )
    return jnp.einsum(
        "vij,vj->vi", trs, ph, precision=jax.lax.Precision.HIGHEST
    )[:, :3]


def to_clip(world: Array, proj_view: Array) -> Array:
    wh = jnp.concatenate([world, jnp.ones((world.shape[0], 1), jnp.float32)], axis=1)
    return jnp.matmul(wh, proj_view.T, precision=jax.lax.Precision.HIGHEST)


def world_corners(geom: Geometry):
    """Tri-major world-space corner positions as dense components.

    Returns ``wc[c] = (x, y, z)`` of (T,) arrays. The per-vertex formulation
    (vertex_world_positions + clip_verts[indices]) pays 3T latency-bound row
    gathers per raster pass; the tri-major corners and per-triangle TRS are
    precomputed at scene build as dense component planes ((9, T) / (16, T)),
    so this is a pure fusable elementwise chain — no small-minor arrays
    (XLA tile-pads a (T, 4, 4) buffer 32x and a (T, 3, 3) ~14x)."""
    trs = geom.tri_trs  # (16, T) rows i * 4 + j
    if trs is None:  # hand-built Geometry without build_buffers
        m = geom.object_trs[geom.tri_obj]  # (T, 4, 4) — cold path
        trs = [m[:, i, j] for i in range(4) for j in range(4)]
    cp = geom.tri_corner_pos  # (9, T) rows c * 3 + i
    if cp is None:  # hand-built Geometry: gather corners from vertices (cold)
        corners = geom.positions[geom.indices]  # (T, 3, 3)
        cp = [corners[:, c, i] for c in range(3) for i in range(3)]
    out = []
    for c in range(3):
        px, py, pz = cp[3 * c], cp[3 * c + 1], cp[3 * c + 2]
        out.append(
            tuple(
                trs[4 * i] * px + trs[4 * i + 1] * py + trs[4 * i + 2] * pz
                + trs[4 * i + 3]
                for i in range(3)
            )
        )
    return tuple(out)


def corners_clip(wc, proj_view: Array):
    """World corner components -> clip components ``out[c] = (x, y, z, w)``."""
    pv = proj_view
    out = []
    for c in range(3):
        x, y, z = wc[c]
        out.append(
            tuple(
                pv[i, 0] * x + pv[i, 1] * y + pv[i, 2] * z + pv[i, 3]
                for i in range(4)
            )
        )
    return tuple(out)


def _rasterize(
    setup: raster.TriSetup,
    height: int,
    width: int,
    config: RenderConfig,
    tile: int | None = None,
    tile_h: int | None = None,
    kind: str = "cam",
    rect=None,
):
    """Returns (zbuf, ibuf, pairs_used, pair_cap). The brute-force path has
    no pair buffer, so it can never overflow (reported as 0/1)."""
    if config.force_bruteforce:
        zbuf, ibuf = raster.rasterize_bruteforce(setup, height, width)
        return zbuf, ibuf, jnp.int32(0), 1
    from arctic_tpu.ops import raster_tiles

    zbuf, ibuf, pairs = raster_tiles.rasterize_tiled(
        setup, height, width, config, tile_h=tile_h or tile, tile_w=tile,
        with_pairs=True, kind=kind, depth_only=(kind == "shadow"), rect=rect,
    )
    return zbuf, ibuf, pairs, config.pair_capacity(setup.capacity, kind)


def shadow_pass(
    geom: Geometry, sun_pv: Array, config: RenderConfig, sun_clip=None,
    cull_rect=None,
) -> Array:
    """Depth-only pass from the sun's view (shadow_map_pass.cpp:113-169).

    Front-face culling for acne control (shadow_map_pass.cpp:97); the map is
    cleared to 1.0 and keeps z of the nearest *back* faces. ``sun_clip``
    (tri-major corner clip components, see corners_clip) may be passed in to
    share the transform with the shade-row build.

    ``cull_rect`` — inclusive shadow-TILE rect from cull.shadow_cull_rect —
    skips binning/rasterizing tiles no shaded pixel's PCF window can read
    (texels there keep the 1.0 clear). In-rect tiles get identical pair
    lists, so sampled texels — and the frame — are bit-identical.
    """
    if sun_clip is None:
        sun_clip = corners_clip(world_corners(geom), sun_pv)
    tri_valid = jnp.arange(geom.capacity) < geom.num_tris
    clipped = raster.near_clip_corners(sun_clip, tri_valid)
    s = config.shadow_size
    setup = raster.setup_screen_triangles(clipped, s, s, cull="front")
    zbuf, _, pairs, cap = _rasterize(
        setup, s, s, config, tile=config.shadow_tile,
        tile_h=config.shadow_tile_h, kind="shadow", rect=cull_rect,
    )
    return zbuf, pairs, cap


def scene_aabb(wc, tri_valid):
    """World AABB ((3,) lo, (3,) hi) of the valid triangles' corners."""
    los, his = [], []
    for i in range(3):
        planes = [wc[c][i] for c in range(3)]
        los.append(
            jnp.min(
                jnp.stack([jnp.min(jnp.where(tri_valid, p, jnp.inf)) for p in planes])
            )
        )
        his.append(
            jnp.max(
                jnp.stack([jnp.max(jnp.where(tri_valid, p, -jnp.inf)) for p in planes])
            )
        )
    return jnp.stack(los), jnp.stack(his)


def sun_cull_rect(wc, tri_valid, cam_pv, sun_pv, config: RenderConfig):
    """Conservative shadow-tile rect for shadow_pass (ops/cull.py)."""
    from arctic_tpu.ops import cull

    lo, hi = scene_aabb(wc, tri_valid)
    sth = config.shadow_tile_h or config.shadow_tile
    return cull.shadow_cull_rect(
        cam_pv, sun_pv, lo, hi, config.shadow_size, sth, config.shadow_tile
    )


def main_pass(
    world: Array, geom: Geometry, cam_pv: Array, config: RenderConfig
):
    """Forward-pass visibility: back-face cull, depth LESS (forward_pass.cpp)."""
    clip = to_clip(world, cam_pv)
    tri_valid = jnp.arange(geom.capacity) < geom.num_tris
    clipped = raster.near_clip_triangles(clip, geom.indices, tri_valid)
    setup = raster.setup_screen_triangles(clipped, config.width, config.height, cull="back")
    zbuf, ibuf, pairs, cap = _rasterize(setup, config.height, config.width, config)
    return setup, zbuf, ibuf, pairs, cap


def build_shade_table(
    setup: raster.TriSetup, geom: Geometry, atlas, world: Array
) -> Array:
    """Per-slot packed shading rows (P, 128) f32.

    Deferred shading needs ~15 scattered values per pixel (corner attributes,
    barycentric planes, material regions); gathering them per-pixel costs
    ~50 scalar gathers — the profiled 4-second hot spot. Instead everything
    is combined per *slot* once (P << pixels) into one 128-lane row so the
    per-pixel cost is a single row gather (XLA's fast embedding-lookup path).

    Lanes: [0:9] perspective-bary planes (edge_c * inv_area / w_c — their
    pixel evaluation IS the unnormalized perspective weight of corner c),
    [9:51] three 14-float corner attribute blocks (world pos, object-space
    n/t/b, uv) pre-combined through the near-clip corner barycentrics,
    [51:63] the material's three atlas regions as exact f32 values,
    [63:67] / [67:71] the material's constant metal-roughness / normal
    values (used when the static atlas flags elide those texture gathers).
    """
    p = setup.capacity
    nrm = maths.normalize(geom.normals)
    tan = maths.normalize(geom.tangents)
    btn = maths.normalize(geom.bitangents)
    attrs = jnp.concatenate([world, nrm, tan, btn, geom.uvs], axis=1)  # (V, 14)
    vidx = geom.indices[setup.orig_tri]  # (P, 3)
    av = [attrs[vidx[:, i]] for i in range(3)]  # 3 x (P, 14)
    cb = setup.cb  # 3 x 3 x (P,): [corner][orig_vertex]
    corner_attr = [
        cb[c][0][:, None] * av[0] + cb[c][1][:, None] * av[1] + cb[c][2][:, None] * av[2]
        for c in range(3)
    ]
    ebw = [
        jnp.stack(list(setup.edges[c]), axis=-1)
        * (setup.inv_area2 / setup.w[c])[:, None]
        for c in range(3)
    ]
    mat = geom.tri_material[setup.orig_tri]  # (P,)
    regions = atlas.regions[mat]  # (P, 3, 4)
    parts = ebw + corner_attr + [regions.reshape(p, 12).astype(jnp.float32)]
    parts.append(atlas.mr_consts[mat])
    parts.append(atlas.nm_consts[mat])
    parts.append(jnp.zeros((p, 128 - 71), jnp.float32))
    return jnp.concatenate(parts, axis=1)


def build_shade_rows(
    setup: raster.TriSetup,
    geom: Geometry,
    sun_pv: Array,
    wc=None,
    lsp=None,
) -> Array:
    """Per-slot shading rows (P, SHADE_LANES) f32 for resolve_gbuffer.

    No per-frame vertex gathers: clip slots are [primary tris; secondary
    tris] (raster.near_clip_triangles), i.e. orig_tri == [0..T, 0..T], so
    tri-major data concatenates straight into slot order, and the corner
    world / light-space positions come from the precomputed tri-major
    corners and per-triangle TRS planes.

    Lane layout (raster_tiles.SHADE_LANES):
      [0:9)    perspective-bary planes (A, B, C per corner, * inv_area2 / w_c;
               their pixel evaluation IS the unnormalized perspective weight)
      [9:26)   corner-0 attrs: world pos 3, n 3, t 3, b 3, uv 2, light-space 3,
               blended through the near-clip corner barycentrics
      [26:43)  corner-1 attrs, [43:60) corner-2 attrs
      [60:83)  material row: atlas regions 12, mr_consts 4, nm_consts 3,
               combined-atlas region 4
      [83:88)  zero
    Light-space positions store xyz only: the sun is orthographic
    (scene.cpp:61-70) so clip w == 1 and no perspective divide is needed.
    """
    from arctic_tpu.ops.raster_tiles import SHADE_LANES

    t_cap = geom.capacity
    p = setup.capacity
    assert p == 2 * t_cap, "clip slots must be [primary; secondary] tri-major"
    if wc is None:
        wc = world_corners(geom)
    if lsp is None:
        lsp = tuple(c[:3] for c in corners_clip(wc, sun_pv))

    def dup(a):  # tri-major (T,) -> slot-major (P,)
        return jnp.concatenate([a, a])

    # att[k] = the 17 components of original corner k, slot-major.
    sa = geom.tri_static_attrs  # (33, T) rows k * 11 + j
    att = [
        [dup(x) for x in (*wc[k], *(sa[11 * k + j] for j in range(11)), *lsp[k])]
        for k in range(3)
    ]
    cb = setup.cb  # 3 x 3 x (P,)
    comps = []
    for c in range(3):
        a, b, cc = setup.edges[c]
        s = setup.inv_area2 / setup.w[c]
        comps += [a * s, b * s, cc * s]
    for c in range(3):
        comps += [
            cb[c][0] * att[0][j] + cb[c][1] * att[1][j] + cb[c][2] * att[2][j]
            for j in range(17)
        ]
    mr = geom.tri_matrow  # (23, T)
    comps += [dup(mr[j]) for j in range(23)]
    z = jnp.zeros((p,), jnp.float32)
    comps += [z] * (SHADE_LANES - len(comps))
    return jnp.stack(comps, axis=1)


def shade(
    buffers: SceneBuffers,
    params: SceneParams,
    setup: raster.TriSetup,
    ibuf: Array,
    world: Array,
    shadow_map: Array,
    sun_pv: Array,
    config: RenderConfig,
    y0=0.0,
) -> Array:
    """Deferred evaluation of forward.hlsl's pixel shader (ps_main, :208-235).

    ``ibuf`` may be a horizontal slice of the frame starting at pixel row
    ``y0`` (traced ok) for sharded rendering.
    """
    geom = buffers.geometry
    if buffers.atlas.tiles is not None:
        from arctic_tpu.utils.errors import RenderError

        raise RenderError(
            "deferred/brute-force shading has no tile-atlas sampler (the "
            "per-slot quad tables are skipped at reference texture scale — "
            "they would be GBs); render with the fused path instead"
        )
    h, w = ibuf.shape
    table = build_shade_table(setup, geom, buffers.atlas, world)

    slot = jnp.maximum(ibuf, 0)
    covered = ibuf >= 0
    row = table[slot]  # (H, W, 128) — the one gather per pixel
    px, py = raster._pixel_centers(h, w, y0)

    # Perspective-correct barycentrics over the clipped corners.
    bw = [
        row[..., 3 * c] * px + row[..., 3 * c + 1] * py + row[..., 3 * c + 2]
        for c in range(3)
    ]
    den = bw[0] + bw[1] + bw[2]
    den = jnp.where(den == 0, 1.0, den)
    b = [x / den for x in bw]
    a = (
        b[0][..., None] * row[..., 9:23]
        + b[1][..., None] * row[..., 23:37]
        + b[2][..., None] * row[..., 37:51]
    )
    wp, n_v, t_v, b_v, uv = a[..., :3], a[..., 3:6], a[..., 6:9], a[..., 9:12], a[..., 12:14]
    regions = row[..., 51:63].reshape(h, w, 3, 4)

    # Sample only the non-constant texture slots (static per scene): a
    # constant texture's bilinear sample IS the constant, which rides along
    # in the slot row — each elided slot saves a per-pixel gather.
    atlas = buffers.atlas
    slots = [0] + ([1] if not atlas.nm_constant else []) + (
        [2] if not atlas.mr_constant else []
    )
    regs = jnp.stack([regions[..., i, :] for i in slots], axis=-2)
    tex = sample_atlas_multi(atlas, regs, uv)  # one batched gather
    base_color = tex[..., 0, :3]  # sRGB-decoded at atlas build
    k = 1
    if atlas.nm_constant:
        nm = row[..., 67:70]
    else:
        nm = tex[..., k, :3]
        k += 1
    mr = row[..., 63:67] if atlas.mr_constant else tex[..., k, :]

    # get_normal (forward.hlsl:104-112): green flip, [0,1]->[-1,1], TBN.
    nm = nm.at[..., 1].set(1.0 - nm[..., 1])
    nm = nm * 2.0 - 1.0
    n = maths.normalize(
        t_v * nm[..., 0:1] + b_v * nm[..., 1:2] + n_v * nm[..., 2:3]
    )
    metalness = mr[..., 2]  # blue channel (forward.hlsl:114-118)
    roughness = mr[..., 1]  # green channel (forward.hlsl:120-124)

    # Shadow term once per pixel, reused for sun and point lights
    # (forward.hlsl:221-230 — the point-light quirk).
    wph = jnp.concatenate([wp, jnp.ones((h, w, 1), jnp.float32)], axis=-1)
    lsp = jnp.einsum("ij,hwj->hwi", sun_pv, wph, precision=jax.lax.Precision.HIGHEST)
    shadow_f = shadow.pcf_shadow(shadow_map, lsp)
    lit = (1.0 - shadow_f)[..., None]

    eye = params.camera.eye
    wo = maths.normalize(eye[None, None, :] - wp)
    sun_dir = params.sun.direction()
    lo = lit * pbr.outgoing_radiance(
        n,
        wo,
        -sun_dir[None, None, :],
        params.sun.color[None, None, :],
        base_color,
        metalness,
        roughness,
    )

    def light_body(i, acc):
        lpos = params.point_lights.position[i]
        lcol = params.point_lights.color[i]
        ldir = lpos[None, None, :] - wp
        dist = jnp.maximum(jnp.linalg.norm(ldir, axis=-1), 1e-12)
        wi = ldir / dist[..., None]
        radiance = lcol[None, None, :] / (dist * dist)[..., None]
        if config.spotlights:
            # Opt-in cone falloff (see core/config.py): -wi is the
            # light-to-fragment direction; point rows clamp to 1.0.
            sd = params.point_lights.spot_dir[i]
            outer, inv_rng = params.point_lights.spot_cos[i]
            cos_t = -jnp.sum(wi * sd[None, None, :], axis=-1)
            radiance = radiance * jnp.clip(
                (cos_t - outer) * inv_rng, 0.0, 1.0
            )[..., None]
        return acc + lit * pbr.outgoing_radiance(
            n, wo, wi, radiance, base_color, metalness, roughness
        )

    # Dynamic trip count like ps_main's `i < point_lights.len` loop
    # (forward.hlsl:224): inactive light slots cost nothing.
    if config.static_point_lights is None:
        count = jnp.minimum(params.point_lights.count, MAX_POINT_LIGHTS)
        lo = jax.lax.fori_loop(0, count, light_body, lo)
    else:
        for i in range(min(config.static_point_lights, MAX_POINT_LIGHTS)):
            lo = light_body(i, lo)
    color = lo + params.ambient * base_color  # forward.hlsl:233

    if config.ibl_specular:
        # Opt-in IBL specular (see core/config.py): F(n.wo) * env(reflect).
        ndotwo = jnp.sum(n * wo, axis=-1, keepdims=True)
        refl = 2.0 * ndotwo * n - wo
        env_c = sky.sample_environment_ibl(buffers.environment, refl)
        f0 = 0.04 + (base_color - 0.04) * metalness[..., None]
        f = pbr.fresnel_schlick(jnp.maximum(ndotwo, 0.0), f0)
        color = color + f * env_c

    # Skybox where no geometry wrote depth (skybox pass semantics).
    dirs = sky.camera_ray_directions(params.camera, config.height, w, row0=y0, rows=h)
    background = sky.sample_environment(buffers.environment, dirs)
    return jnp.where(covered[..., None], color, background)


def shade_gbuffer(
    buffers: SceneBuffers,
    params: SceneParams,
    gbuf: Array,
    covered: Array,
    shadow_map: Array,
    config: RenderConfig,
    tiles_x: int,
    tile_row0=0,
):
    """forward.hlsl ps_main over the G-buffer, channel-leading.

    gbuf: (GBUF_LANES, R, 128) from ops.raster_tiles.raster_gbuffer —
    already perspective-interpolated, so this is pure per-pixel math + the
    texture / PCF taps. R = num_tiles * tile_px / 128: the pixel-block
    layout, where row r lane l is pixel 128 * r + l of the row-major tile
    pixel stream. Lane map: [0:3 wp, 3:6 n, 6:9 t, 9:12 b, 12:14 uv,
    14:17 light-space xyz, 24:36 atlas regions, 36:40 mr const, 40:43 nm
    const, 43:47 combined-atlas region]. Returns (HDR (3, R, 128),
    tex_fb_rows) — the grouped-tile fallback row count (0 when that opt-in
    route is off).

    Every array keeps the pixel dims minor (vectors (3, R, 128), scalars
    (1, R, 128) or (R, 128)), so the whole chain is elementwise over the
    same layout and fuses.
    """
    from arctic_tpu.ops.raster_tiles import pixel_block_centers

    atlas = buffers.atlas
    wp = gbuf[0:3]  # (3, R, 128)
    n_v = gbuf[3:6]
    t_v = gbuf[6:9]
    b_v = gbuf[9:12]
    u_uv = gbuf[12]  # (R, 128)
    v_uv = gbuf[13]

    def reg_lane(lane, fallback):
        # Uncovered pixels carry zero rows whose degenerate regions (h == w
        # == 0) would make junk gather indices; point them at one row.
        return jnp.where(covered, gbuf[lane], fallback)

    def ch3(flat, base):  # (..., C) flat tap -> (3, R, 128)
        return jnp.stack([flat[..., base + i] for i in range(3)], axis=0)

    # Per-pixel sky rays (for the merged tap below and/or the background
    # composite). Covered pixels don't read the sky — give them one
    # constant direction so their (discarded) taps hit a single row.
    r_rows, _ = covered.shape
    px, py = pixel_block_centers(
        r_rows, tiles_x, config.tile_h, config.tile_w, tile_row0
    )
    dx, dy, dz = sky.camera_ray_dirs_cf(
        params.camera, px, py, config.width, config.height
    )
    dx = jnp.where(covered, 1.0, dx)
    dy = jnp.where(covered, 0.0, dy)
    dz = jnp.where(covered, 0.0, dz)

    # Sun shadow term: the sun is orthographic, so the interpolated
    # light-space xyz needs no divide.
    shadow_f = shadow.pcf_shadow_proj(shadow_map, gbuf[14], gbuf[15], gbuf[16])

    env_atlas = getattr(buffers.environment, "atlas", None)
    background = None
    tex_fb_rows = jnp.int32(0)  # grouped-tile fallback rows (stats)
    merged_env = (
        atlas.combined_slots is not None
        and env_atlas is not None
        and env_atlas.quads_packed is not None
        and atlas.combined_quads.dtype == env_atlas.quads_packed.dtype
    )
    if atlas.tiles is not None:
        # Reference-scale texture path: ONE gather from the u16 tile table
        # (see io.build.build_tile_atlas) serves a covered pixel's 8
        # material channels, an uncovered pixel its env quad — the merged
        # texture+environment structure at ~24 B/texel instead of the quad
        # scheme's ~96.
        from arctic_tpu.ops.sampling import quad_index, tile_index, tile_tap_resolve

        u_sky, v_sky = sky.env_uv_cf(dx, dy, dz)
        trow, t_ty, t_tx, tfx, tfy = tile_index(
            reg_lane(43, 0.0), reg_lane(44, 1.0), reg_lane(45, 1.0),
            reg_lane(46, 1.0), u_uv, v_uv,
        )
        ereg = env_atlas.regions[0, 0]
        eq, efx, efy = quad_index(
            env_atlas.block_grid, ereg[0], ereg[1], ereg[2], ereg[3],
            u_sky, v_sky,
        )
        groups = atlas.tile_groups
        grouped = (
            groups is not None
            and len(groups) > 1
            and config.tex_group_caps is not None
        )
        if grouped:
            # Opt-in per-material-group compacted row gathers
            # (config.tex_group_caps — see ops.sampling.tile_tap_resolve_grouped):
            # bit-identical values.
            from arctic_tpu.ops.sampling import (
                tile_row_groups,
                tile_tap_resolve_grouped,
            )

            caps = config.tex_group_caps
            assert len(caps) == len(groups) + 1, (caps, len(groups))
            gid_pix = jnp.zeros(trow.shape, jnp.int32)
            for g in groups[1:]:
                gid_pix = gid_pix + (trow >= g[0]).astype(jnp.int32)
            g_lo, g_hi, many = tile_row_groups(covered, gid_pix, len(groups))
            out16, tex_fb_rows = tile_tap_resolve_grouped(
                atlas.tiles, groups, caps, trow, covered, eq // 8,
                gid_pix, g_lo, g_hi, many,
                [t_ty, t_tx, eq % 8, tfx, tfy, efx, efy],
                group_tables=atlas.tile_group_tables,
            )
        else:
            idx = jnp.where(covered, trow, atlas.tiles_ntex + eq // 8)
            out16 = tile_tap_resolve(
                atlas.tiles[idx], t_ty, t_tx, eq % 8, tfx, tfy, efx, efy
            )  # (16, R, 128)
        base_color = out16[0:3]
        nm = out16[3:6]
        mr_g = out16[6]
        mr_b = out16[7]
        background = out16[8:11]
    elif merged_env:
        # ONE gather serves texture AND sky: a covered pixel needs its
        # material quad, an uncovered one its environment quad — never
        # both, so the two gathers collapse into one against a concatenated
        # [packed tex quads; packed env quads] table.
        from arctic_tpu.ops.sampling import quad_index, tap_resolve

        u_sky, v_sky = sky.env_uv_cf(dx, dy, dz)
        tq, tfx, tfy = quad_index(
            atlas.combined_block_grid,
            reg_lane(43, 0.0), reg_lane(44, 0.0), reg_lane(45, 1.0),
            reg_lane(46, 1.0), u_uv, v_uv,
        )
        ereg = env_atlas.regions[0, 0]
        eq, efx, efy = quad_index(
            env_atlas.block_grid, ereg[0], ereg[1], ereg[2], ereg[3],
            u_sky, v_sky,
        )
        cq = atlas.combined_quads  # (Nq, C4)
        c4 = cq.shape[-1]
        per = 128 // c4  # tex quads per 128-lane row
        if atlas.combined_env_rows is not None:  # precomputed at scene build
            merged = atlas.combined_env_rows
            ntex = merged.shape[0] - env_atlas.quads_packed.shape[0]
        else:  # hand-built buffers: same construction, in-frame
            from arctic_tpu.ops.sampling import pack_tex_rows

            tex_rows = pack_tex_rows(cq)
            ntex = tex_rows.shape[0]
            merged = jnp.concatenate([tex_rows, env_atlas.quads_packed], axis=0)
        idx = jnp.where(covered, tq // per, ntex + eq // 8)
        out16 = tap_resolve(
            merged[idx], tq % per, eq % 8, tfx, tfy, efx, efy, c4=c4
        )  # (16, R, 128)
        nch = c4 // 4
        background = out16[nch : nch + 3]
        slot_base = {s: 4 * i for i, s in enumerate(atlas.combined_slots)}

        def ch3p(base):
            return out16[base : base + 3]

        base_color = ch3p(slot_base[0])
        nm = ch3p(slot_base[1]) if 1 in slot_base else None
        mr_g = out16[slot_base[2] + 1] if 2 in slot_base else None
        mr_b = out16[slot_base[2] + 2] if 2 in slot_base else None
    elif atlas.combined_slots is not None:
        # All of this material's texture slots in ONE row gather.
        tex = sample_quads_flat(
            atlas.combined_quads, atlas.combined_block_grid,
            reg_lane(43, 0.0), reg_lane(44, 0.0), reg_lane(45, 1.0), reg_lane(46, 1.0),
            u_uv, v_uv,
        )  # (R, 128, 4 * n_slots)
        slot_base = {s: 4 * i for i, s in enumerate(atlas.combined_slots)}
        base_color = ch3(tex, slot_base[0])
        nm = ch3(tex, slot_base[1]) if 1 in slot_base else None
        mr_g = tex[..., slot_base[2] + 1] if 2 in slot_base else None
        mr_b = tex[..., slot_base[2] + 2] if 2 in slot_base else None
    else:
        # Per-slot taps from the plain atlas (fallback when material texture
        # sizes are incompatible with combining).
        def tap(slot):
            return sample_quads_flat(
                atlas.quads, atlas.block_grid,
                reg_lane(24 + 4 * slot, 0.0), reg_lane(25 + 4 * slot, 0.0),
                reg_lane(26 + 4 * slot, 1.0), reg_lane(27 + 4 * slot, 1.0),
                u_uv, v_uv,
            )

        base_color = ch3(tap(0), 0)
        nm = None if atlas.nm_constant else ch3(tap(1), 0)
        if atlas.mr_constant:
            mr_g = mr_b = None
        else:
            t2 = tap(2)
            mr_g, mr_b = t2[..., 1], t2[..., 2]

    if nm is None:
        nm = gbuf[40:43]
    if mr_g is None:
        metalness = gbuf[38:39]  # mr const blue (1, R, 128)
        roughness = gbuf[37:38]  # mr const green
    else:
        metalness = mr_b[None]
        roughness = mr_g[None]

    # get_normal (forward.hlsl:104-112): green flip, [0,1]->[-1,1], TBN.
    nm = jnp.concatenate([nm[0:1], 1.0 - nm[1:2], nm[2:3]], axis=0)
    nm = nm * 2.0 - 1.0
    n = t_v * nm[0:1] + b_v * nm[1:2] + n_v * nm[2:3]
    n = n / jnp.sqrt(jnp.sum(n * n, axis=0, keepdims=True))

    lit = (1.0 - shadow_f)[None]  # (1, R, 128)

    eye = params.camera.eye
    wo = eye[:, None, None] - wp
    wo = wo / jnp.sqrt(jnp.sum(wo * wo, axis=0, keepdims=True))
    sun_dir = params.sun.direction()
    lo = lit * pbr.outgoing_radiance_cf(
        n, wo, -sun_dir[:, None, None], params.sun.color[:, None, None],
        base_color, metalness, roughness,
    )

    def light_body(i, acc):
        lpos = params.point_lights.position[i]
        lcol = params.point_lights.color[i]
        ldir = lpos[:, None, None] - wp
        dist = jnp.maximum(
            jnp.sqrt(jnp.sum(ldir * ldir, axis=0, keepdims=True)), 1e-12
        )
        wi = ldir / dist
        radiance = lcol[:, None, None] / (dist * dist)
        if config.spotlights:
            # Opt-in cone falloff, channel-first twin of shade()'s form.
            sd = params.point_lights.spot_dir[i]
            outer, inv_rng = params.point_lights.spot_cos[i]
            cos_t = -jnp.sum(wi * sd[:, None, None], axis=0, keepdims=True)
            radiance = radiance * jnp.clip((cos_t - outer) * inv_rng, 0.0, 1.0)
        return acc + lit * pbr.outgoing_radiance_cf(
            n, wo, wi, radiance, base_color, metalness, roughness
        )

    if config.static_point_lights is None:
        count = jnp.minimum(params.point_lights.count, MAX_POINT_LIGHTS)
        lo = jax.lax.fori_loop(0, count, light_body, lo)
    else:
        # Unrolled: one fused multi-light BRDF pass (config.static_point_lights).
        for i in range(min(config.static_point_lights, MAX_POINT_LIGHTS)):
            lo = light_body(i, lo)
    color = lo + params.ambient * base_color

    if config.ibl_specular:
        # Opt-in IBL specular, channel-first (see core/config.py and the
        # deferred-path twin in shade()): F(n.wo, F0) * env(reflect(-wo, n)).
        ndotwo = jnp.sum(n * wo, axis=0, keepdims=True)  # (1, R, 128)
        rx = 2.0 * ndotwo[0] * n[0] - wo[0]
        ry = 2.0 * ndotwo[0] * n[1] - wo[1]
        rz = 2.0 * ndotwo[0] * n[2] - wo[2]
        er, eg, eb = sky.sample_environment_ibl_cf(
            buffers.environment, rx, ry, rz
        )
        env_c = jnp.stack([er, eg, eb], axis=0)  # (3, R, 128)
        f0 = 0.04 + (base_color - 0.04) * metalness
        f = pbr.fresnel_schlick(jnp.maximum(ndotwo, 0.0), f0)
        color = color + f * env_c

    # Skybox where no geometry wrote depth (already sampled by the merged
    # tap above when available; separate gather otherwise).
    if background is None:
        background = jnp.stack(
            sky.sample_environment_cf(buffers.environment, dx, dy, dz), axis=0
        )
    out = jnp.where(covered[None], color, background)
    return out, tex_fb_rows


def build_sun_cache(
    buffers: SceneBuffers, params: SceneParams, config: RenderConfig
):
    """Render the sun's shadow map — the part of the frame that depends only
    on (geometry, sun). Returns (SunCache, stats).

    Pass the cache to render_frame_stats to skip the shadow pass while the
    sun and geometry are unchanged; re-run this when either is edited (the
    viewer's sun-dirty flag, the CLI's --cache-sun orbit path). The cached
    map renders the full frustum (no camera-dependent cull), so it stays
    valid as the camera moves; sampled texels equal the culled in-frame
    map's, and the rendered pixels are unchanged.
    """
    from arctic_tpu.core.scene import SunCache

    geom = buffers.geometry
    sun_pv = params.sun.proj_view()
    shadow_map, sh_pairs, sh_cap = shadow_pass(geom, sun_pv, config)
    stats = {"shadow_pairs": sh_pairs, "shadow_pair_cap": jnp.int32(sh_cap)}
    return SunCache(shadow_map=shadow_map), stats


def make_sun_cache_builder(config: RenderConfig):
    return jax.jit(functools.partial(build_sun_cache, config=config))


def render_frame_stats(
    buffers: SceneBuffers,
    params: SceneParams,
    settings: Settings,
    config: RenderConfig,
    sun_cache=None,
):
    """render_frame + raster health scalars.

    stats: {"cam_pairs", "cam_pair_cap", "shadow_pairs", "shadow_pair_cap",
    "tex_fb_rows", "tex_fb_cap"} — pairs > cap means the binning buffer
    overflowed and fragments were DROPPED (the frame is visually
    incomplete). check_stats() makes that loud; bench.py and the CLI call it
    every run.

    ``sun_cache`` (a build_sun_cache result) skips the shadow pass; valid
    while sun + geometry are unchanged.
    """
    geom = buffers.geometry
    sun_pv = params.sun.proj_view()
    cam_pv = params.camera.proj_view()
    fused = config.fused_shade and not config.force_bruteforce

    # Tri-major world + sun-clip corners, computed once and shared by the
    # shadow raster, the camera raster, and the shade-row build.
    wc = world_corners(geom) if fused else None
    sun_clip = corners_clip(wc, sun_pv) if fused else None

    # named_scope = the frame graph's pass labels in HLO/profiler traces
    # (the Tracy zone analogue, SURVEY.md §5.1).
    with jax.named_scope("shadow_pass"):
        if sun_cache is None:
            cull_rect = None
            if config.sun_frustum_cull and fused:
                tri_valid0 = jnp.arange(geom.capacity) < geom.num_tris
                cull_rect = sun_cull_rect(wc, tri_valid0, cam_pv, sun_pv, config)
            shadow_map, sh_pairs, sh_cap = shadow_pass(
                geom, sun_pv, config, sun_clip=sun_clip, cull_rect=cull_rect,
            )
        else:
            shadow_map = sun_cache.shadow_map
            sh_pairs, sh_cap = jnp.int32(0), 1  # can't overflow (cached)

    if fused:
        # Fused path: tiled raster -> per-pixel G-buffer resolve ->
        # tile-major shading; only the final u8 frame is untiled.
        from arctic_tpu.ops import raster_tiles

        with jax.named_scope("forward_visibility"):
            tri_valid = jnp.arange(geom.capacity) < geom.num_tris
            clipped = raster.near_clip_corners(corners_clip(wc, cam_pv), tri_valid)
            setup = raster.setup_screen_triangles(
                clipped, config.width, config.height, cull="back"
            )
            shade_rows = build_shade_rows(
                setup, geom, sun_pv, wc=wc,
                lsp=tuple(c[:3] for c in sun_clip),
            )
            ibuf_rows, gbuf, cam_pairs = raster_tiles.raster_gbuffer(
                setup, shade_rows, config.height, config.width, config
            )
        cam_cap = config.pair_capacity(setup.capacity)
        with jax.named_scope("forward_shade_skybox"):
            hdr, tex_fb_rows = shade_gbuffer(
                buffers, params, gbuf, ibuf_rows >= 0, shadow_map, config,
                tiles_x=config.tiles_x,
            )
    else:
        world = vertex_world_positions(geom)
        with jax.named_scope("forward_visibility"):
            setup, _zbuf, ibuf, cam_pairs, cam_cap = main_pass(
                world, geom, cam_pv, config
            )
        with jax.named_scope("forward_shade_skybox"):
            hdr = shade(buffers, params, setup, ibuf, world, shadow_map, sun_pv, config)
        tex_fb_rows = jnp.int32(0)

    with jax.named_scope("post_process"):
        if config.hdr_half_round:
            # R16G16B16A16_FLOAT storage rounding (renderer.cpp:128-144).
            hdr = hdr.astype(jnp.float16).astype(jnp.float32)

        ldr = tonemap.tonemap(
            hdr, settings.tm_method, settings.gamma, settings.exposure,
            channel_axis=0 if fused else -1,
        )
        img = tonemap.to_unorm8(ldr)

    if fused:
        from arctic_tpu.ops.raster_tiles import untile_packed_u8

        img = untile_packed_u8(
            img, config.tiles_y, config.tiles_x, config.tile_h, config.tile_w
        )[: config.height, : config.width]

    stats = {
        "cam_pairs": cam_pairs,
        "cam_pair_cap": jnp.int32(cam_cap),
        "shadow_pairs": sh_pairs,
        "shadow_pair_cap": jnp.int32(sh_cap),
        "tex_fb_rows": tex_fb_rows,
        "tex_fb_cap": jnp.int32(tex_fb_capacity(buffers, config)),
    }
    return img, stats


def tex_fb_capacity(buffers: SceneBuffers, config: RenderConfig) -> int:
    """The compiled grouped-tile fallback row capacity (1 = grouping
    inactive — tex_fb_rows is then always 0, like the pcf/pair reports)."""
    groups = buffers.atlas.tile_groups
    if (
        config.tex_group_caps is None
        or groups is None
        or len(groups) <= 1
        or not config.fused_shade
        or config.force_bruteforce
    ):
        return 1
    return int(config.tex_group_caps[-1])


def check_stats(stats) -> None:
    """Raise if a rendered frame dropped fragments (host-side, post-render)."""
    from arctic_tpu.utils.errors import RenderError

    for pass_name in ("cam", "shadow"):
        pairs = int(stats[f"{pass_name}_pairs"])
        cap = int(stats[f"{pass_name}_pair_cap"])
        if pairs > cap:
            raise RenderError(
                f"{pass_name} pass overflowed the tile-pair buffer "
                f"({pairs} pairs > capacity {cap}): fragments were dropped and "
                f"the frame is incomplete. Raise RenderConfig.pairs_per_tri / "
                f"pair_reserve."
            )
    if "tex_fb_rows" in stats:
        rows = int(stats["tex_fb_rows"])
        cap = int(stats["tex_fb_cap"])
        if rows > cap:
            raise RenderError(
                f"grouped-tile fallback rows overflowed ({rows} rows > "
                f"capacity {cap}): overflowing rows got another row's texture "
                f"values. Raise RenderConfig.tex_group_caps[-1] (or re-run "
                f"pipeline.autotune_tex_group_caps with a bigger margin)."
            )


def measure_pair_counts(
    buffers: SceneBuffers, params, config: RenderConfig
) -> Tuple[int, int]:
    """Actual (camera, shadow) tile-pair counts for one frame — no sort, no
    raster, so the throwaway compile is cheap (unlike rendering a probe frame
    at the worst-case capacity).

    ``params`` may be a single SceneParams or a list (e.g. a benchmark's
    fly-through viewpoints); a list returns the element-wise max so the tuned
    caps cover the whole path with one compile."""
    from arctic_tpu.ops import binning

    @jax.jit
    def counts(buffers, params):
        geom = buffers.geometry
        world = vertex_world_positions(geom)
        tri_valid = jnp.arange(geom.capacity) < geom.num_tris

        cam_clip = to_clip(world, params.camera.proj_view())
        cam_setup = raster.setup_screen_triangles(
            raster.near_clip_triangles(cam_clip, geom.indices, tri_valid),
            config.width, config.height, cull="back",
        )
        cam = binning.count_pairs(
            cam_setup, config.tiles_x, config.tiles_y, config.tile_w, config.tile_h
        )

        s = config.shadow_size
        sh_clip = to_clip(world, params.sun.proj_view())
        sh_setup = raster.setup_screen_triangles(
            raster.near_clip_triangles(sh_clip, geom.indices, tri_valid),
            s, s, cull="front",
        )
        sth = config.shadow_tile_h or config.shadow_tile
        stx = -(-s // config.shadow_tile)
        sty = -(-s // sth)
        rect = None
        if config.sun_frustum_cull and config.fused_shade:
            # Match render_frame_stats' culled shadow binning so the tuned
            # cap reflects the pairs actually generated.
            wc = world_corners(geom)
            rect = sun_cull_rect(
                wc, tri_valid, params.camera.proj_view(),
                params.sun.proj_view(), config,
            )
        sh = binning.count_pairs(
            sh_setup, stx, sty, config.shadow_tile, sth, rect=rect
        )
        return cam, sh

    params_list = params if isinstance(params, (list, tuple)) else [params]
    cam = sh = 0
    for p in params_list:
        c, s_ = counts(buffers, p)
        cam, sh = max(cam, int(c)), max(sh, int(s_))
    return cam, sh


def autotune_pair_caps(
    buffers: SceneBuffers,
    params,
    config: RenderConfig,
    margin: float = 2.0,
    bucket: int = 65536,
) -> RenderConfig:
    """Size the pair buffers to the scene: measure one frame's (or, given a
    params list, a camera path's) real pair counts and return a config with
    ~margin x headroom, bucketed so nearby viewpoints share a compilation.

    Binning sort/align/gather costs scale with the buffer CAPACITY (the
    default formula is ~5x oversized on the bench scene), so this is a large
    frame-time win for one extra tiny compile. Overflow stays loud: if a
    later frame exceeds the tuned cap, check_stats raises and the caller can
    re-tune with a bigger margin.
    """
    import dataclasses

    cam, sh = measure_pair_counts(buffers, params, config)

    def cap(n: int) -> int:
        need = int(n * margin) + 8192
        return max(bucket, -(-need // bucket) * bucket)

    return dataclasses.replace(
        config, pair_cap_cam=cap(cam), pair_cap_shadow=cap(sh)
    )


def measure_tex_group_rows(buffers: SceneBuffers, params, config: RenderConfig):
    """Per-frame grouped-tile row needs: (G+1,) ints — uniform 128-px rows
    claimed per material group plus fallback (mixed) rows — maxed over a
    params list. Classification matches the render path exactly (same
    pixel-block rows through ops.sampling.tile_row_groups), so caps sized
    from this cover the real frames."""
    import numpy as np

    from arctic_tpu.ops import raster_tiles
    from arctic_tpu.ops.sampling import tile_row_groups

    groups = buffers.atlas.tile_groups
    g_n = len(groups)
    group_of = jnp.asarray(buffers.atlas.tile_group_of, jnp.int32)

    @jax.jit
    def counts(buffers, params):
        geom = buffers.geometry
        t_cap = geom.capacity
        wc = world_corners(geom)
        cam_pv = params.camera.proj_view()
        tri_valid = jnp.arange(t_cap) < geom.num_tris
        clipped = raster.near_clip_corners(corners_clip(wc, cam_pv), tri_valid)
        setup = raster.setup_screen_triangles(
            clipped, config.width, config.height, cull="back"
        )
        _, ibuf = raster_tiles.rasterize_tiled(
            setup, config.height, config.width, config, crop=False
        )
        th, tw = config.tile_h, config.tile_w
        rows = (
            ibuf.reshape(config.tiles_y, th, config.tiles_x, tw)
            .transpose(0, 2, 1, 3)
            .reshape(-1, 128)
        )  # the render path's pixel-block rows (see _untile)
        covered = rows >= 0
        tri = jnp.where(covered, rows, 0) % t_cap  # clip slots are [tri; tri]
        gid = group_of[geom.tri_material[tri]]
        g_lo, g_hi, many = tile_row_groups(covered, gid, g_n)
        out = [
            jnp.sum(
                ((~many) & ((g_lo == g) | (g_hi == g))).astype(jnp.int32)
            )
            for g in range(g_n)
        ]
        out.append(jnp.sum(many.astype(jnp.int32)))
        return jnp.stack(out)

    params_list = params if isinstance(params, (list, tuple)) else [params]
    need = np.zeros(g_n + 1, np.int64)
    for p in params_list:
        need = np.maximum(need, np.asarray(counts(buffers, p)))
    return need


def measure_tex_row_masks(buffers: SceneBuffers, params, config: RenderConfig):
    """Per-128-px-row material bitmasks over a params list — (F, R) int64
    host array (supports up to 64 materials; two i32 words on device since
    x64 stays off). Input data for io.texplan.plan_material_groups."""
    import numpy as np

    from arctic_tpu.ops import raster_tiles

    @jax.jit
    def rowmasks(buffers, params):
        geom = buffers.geometry
        t_cap = geom.capacity
        wc = world_corners(geom)
        cam_pv = params.camera.proj_view()
        tri_valid = jnp.arange(t_cap) < geom.num_tris
        clipped = raster.near_clip_corners(corners_clip(wc, cam_pv), tri_valid)
        setup = raster.setup_screen_triangles(
            clipped, config.width, config.height, cull="back"
        )
        _, ibuf = raster_tiles.rasterize_tiled(
            setup, config.height, config.width, config, crop=False
        )
        th, tw = config.tile_h, config.tile_w
        rows = (
            ibuf.reshape(config.tiles_y, th, config.tiles_x, tw)
            .transpose(0, 2, 1, 3)
            .reshape(-1, 128)
        )
        covered = rows >= 0
        mat = geom.tri_material[jnp.where(covered, rows, 0) % t_cap]
        lo = jnp.where(covered & (mat < 32), jnp.int32(1) << mat, 0)
        hi = jnp.where(
            covered & (mat >= 32), jnp.int32(1) << (mat - 32), 0
        )
        import jax as _jax

        return (
            _jax.lax.reduce_or(lo, axes=(1,)),
            _jax.lax.reduce_or(hi, axes=(1,)),
        )

    params_list = params if isinstance(params, (list, tuple)) else [params]
    out = []
    for p in params_list:
        lo, hi = rowmasks(buffers, p)
        out.append(
            (np.asarray(hi).astype(np.int64) << 32)
            | (np.asarray(lo).astype(np.int64) & 0xFFFFFFFF)
        )
    return np.stack(out)


def plan_tex_groups(buffers: SceneBuffers, params, config: RenderConfig):
    """Measure row masks over a camera path and anneal a material grouping
    (io.texplan). Returns a groups list for build_buffers(tex_groups=...),
    or None when the scene has no multi-group tile atlas (or > 64
    materials). The caller rebuilds buffers with the plan and then sizes
    caps with autotune_tex_group_caps."""
    atlas = buffers.atlas
    groups = atlas.tile_groups
    if groups is None or len(groups) <= 1:
        return None
    n_mats = len(atlas.tile_group_of)
    if n_mats > 64:
        return None
    from arctic_tpu.io.build import TEX_GROUP_BUDGET_BYTES
    from arctic_tpu.io.texplan import plan_material_groups

    env_rows = groups[0][2] - groups[0][1]
    budget_rows = TEX_GROUP_BUDGET_BYTES // 512
    masks = measure_tex_row_masks(buffers, params, config)
    plan, _cost = plan_material_groups(
        masks, list(atlas.tile_mat_rows), env_rows, budget_rows
    )
    return plan


def autotune_tex_group_caps(
    buffers: SceneBuffers, params, config: RenderConfig, margin: float = 1.1
) -> RenderConfig:
    """Size the grouped-tile row caps (config.tex_group_caps) to a scene /
    camera path: measure real per-group uniform-row and fallback-row counts
    and cap at ~margin x, rounded to the kernel's 32-row blocks. The gather
    work scales with sum(caps), so the margin is deliberately modest; a
    frame past the tuned fallback cap raises loudly via check_stats (like
    pair-cap overflow) and the caller can re-tune. No-op for scenes whose
    tile atlas fits one group (or has no tile atlas at all)."""
    import dataclasses

    groups = buffers.atlas.tile_groups
    if groups is None or len(groups) <= 1:
        return config
    need = measure_tex_group_rows(buffers, params, config)
    caps = tuple(max(32, -(-int(n * margin + 32) // 32) * 32) for n in need)
    return dataclasses.replace(config, tex_group_caps=caps)


def render_frame(
    buffers: SceneBuffers,
    params: SceneParams,
    settings: Settings,
    config: RenderConfig,
    sun_cache=None,
) -> Array:
    """Full frame -> (H, W, 3) uint8. The analogue of
    Renderer::render_frame (renderer.cpp:274-415), one XLA program."""
    img, _ = render_frame_stats(buffers, params, settings, config, sun_cache)
    return img


def make_renderer(config: RenderConfig):
    """Jit-compiled frame function; scene params/settings stay dynamic."""
    return jax.jit(functools.partial(render_frame, config=config))


def make_renderer_stats(config: RenderConfig):
    """Like make_renderer but returning (image, raster health stats)."""
    return jax.jit(functools.partial(render_frame_stats, config=config))


def make_cached_renderer_stats(config: RenderConfig):
    """Frame function taking a SunCache (see build_sun_cache): the per-frame
    program contains NO shadow raster — the camera-motion path
    of an interactive session with a stationary sun."""

    def f(buffers, params, settings, sun_cache):
        return render_frame_stats(buffers, params, settings, config, sun_cache)

    return jax.jit(f)
