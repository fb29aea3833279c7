"""Host-side scene assembly: meshes + materials + env -> device SceneBuffers.

This replaces the reference's load path (App::load_scene, app.cpp:173-385 +
Renderer::create_mesh/create_material/create_hdri, renderer.cpp:417-583).
Where the reference does one blocking staging-buffer upload per resource
(SURVEY.md §3.1), we assemble SoA numpy arrays on the host and device_put the
whole pytree once.

A C++ fast path for the CPU-heavy pieces (tangent generation, RGBE decode)
lives in native/arctic_native.cpp; the numpy
implementations here are the reference semantics and the fallback.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Sequence

import jax.numpy as jnp
import numpy as np

from arctic_tpu.core.scene import (
    Environment,
    Geometry,
    SceneBuffers,
    TextureAtlas,
)


@dataclass
class MaterialImages:
    """The three textures of a material (scene.hpp:62-69), as u8 RGBA.

    ``diffuse`` is sRGB-encoded (decoded at pack time like the _SRGB SRV,
    renderer.cpp:486); normal and metal-roughness are linear.
    """

    diffuse: np.ndarray
    normal: np.ndarray
    metal_roughness: np.ndarray


@dataclass
class MeshData:
    """One mesh in object space (app.cpp:299-356 extraction equivalent)."""

    positions: np.ndarray  # (N, 3) f32
    normals: np.ndarray  # (N, 3) f32
    uvs: np.ndarray  # (N, 2) f32, v already flipped (FlipUVs)
    indices: np.ndarray  # (M, 3) i32
    material: int
    tangents: np.ndarray | None = None
    bitangents: np.ndarray | None = None


def fallback_diffuse() -> np.ndarray:
    """assets/white.png equivalent (app.cpp:214)."""
    return np.full((1, 1, 4), 255, np.uint8)


def fallback_normal() -> np.ndarray:
    """assets/normal.png equivalent (app.cpp:229): flat +Z tangent normal."""
    t = np.zeros((1, 1, 4), np.uint8)
    t[..., 0], t[..., 1], t[..., 2], t[..., 3] = 128, 128, 255, 255
    return t


def compute_tangents(
    positions: np.ndarray, normals: np.ndarray, uvs: np.ndarray, indices: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Per-vertex tangent frame from UV derivatives (aiProcess_CalcTangentSpace
    analogue, app.cpp:180): accumulate per-face tangents, then Gram-Schmidt
    against the vertex normal."""
    try:
        from arctic_tpu.io import native

        if native.available():
            return native.compute_tangents(positions, normals, uvs, indices)
    except Exception:
        pass
    i0, i1, i2 = indices[:, 0], indices[:, 1], indices[:, 2]
    e1 = positions[i1] - positions[i0]
    e2 = positions[i2] - positions[i0]
    d1 = uvs[i1] - uvs[i0]
    d2 = uvs[i2] - uvs[i0]
    det = d1[:, 0] * d2[:, 1] - d1[:, 1] * d2[:, 0]
    r = np.where(np.abs(det) < 1e-12, 0.0, 1.0 / np.where(det == 0, 1.0, det))
    t_face = (e1 * d2[:, 1:2] - e2 * d1[:, 1:2]) * r[:, None]
    b_face = (e2 * d1[:, 0:1] - e1 * d2[:, 0:1]) * r[:, None]

    tan = np.zeros_like(positions)
    btn = np.zeros_like(positions)
    for tri_idx in (i0, i1, i2):
        np.add.at(tan, tri_idx, t_face)
        np.add.at(btn, tri_idx, b_face)

    n = normals
    tan = tan - n * np.sum(n * tan, axis=1, keepdims=True)
    ln = np.linalg.norm(tan, axis=1, keepdims=True)
    # Degenerate UVs: fall back to any vector orthogonal to n.
    alt = np.cross(n, np.where(np.abs(n[:, 0:1]) < 0.9, [[1.0, 0, 0]], [[0, 1.0, 0]]))
    tan = np.where(ln > 1e-8, tan / np.maximum(ln, 1e-20), alt / np.linalg.norm(alt, axis=1, keepdims=True))
    lb = np.linalg.norm(btn, axis=1, keepdims=True)
    handed = np.where(np.sum(np.cross(n, tan) * btn, axis=1, keepdims=True) < 0, -1.0, 1.0)
    btn = np.cross(n, tan) * handed
    return tan.astype(np.float32), btn.astype(np.float32)


def srgb_to_linear_np(c: np.ndarray) -> np.ndarray:
    c = c.astype(np.float32)
    return np.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)


def pack_atlas(
    images: Sequence[np.ndarray], dtype=jnp.bfloat16
) -> tuple[np.ndarray, np.ndarray]:
    """Shelf-pack images into one (AH, AW, 4) array; returns (atlas, locs).

    locs rows are (y, x, h, w): (y, x) is the origin of the *padded* block
    and (h, w) the logical image size. Every image is stored with a 1-texel
    wrapped border on all sides so a bilinear footprint is a contiguous
    (2, 2) window (see ops/sampling.sample_atlas).
    Images must already be float linear RGBA.
    """
    padded = [np.pad(im, ((1, 1), (1, 1), (0, 0)), mode="wrap") for im in images]
    order = sorted(range(len(padded)), key=lambda i: -padded[i].shape[0])
    max_w = max(im.shape[1] for im in padded)
    atlas_w = 1
    area = sum(im.shape[0] * im.shape[1] for im in padded)
    while atlas_w < max_w or atlas_w * atlas_w < area:
        atlas_w *= 2
    shelves: list[list[int]] = []  # [y, height, x_cursor]
    locs = np.zeros((len(images), 4), np.int32)
    y_cursor = 0
    for idx in order:
        ph, pw = padded[idx].shape[:2]
        placed = False
        for shelf in shelves:
            if shelf[2] + pw <= atlas_w and ph <= shelf[1]:
                locs[idx] = (shelf[0], shelf[2], ph - 2, pw - 2)
                shelf[2] += pw
                placed = True
                break
        if not placed:
            shelves.append([y_cursor, ph, pw])
            locs[idx] = (y_cursor, 0, ph - 2, pw - 2)
            y_cursor += ph
    atlas_h = max((y_cursor + 1) // 2 * 2, 2)
    channels = images[0].shape[-1]
    atlas = np.zeros((atlas_h, atlas_w, channels), np.float32)
    for idx, im in enumerate(padded):
        y, x = locs[idx][:2]
        atlas[y : y + im.shape[0], x : x + im.shape[1]] = im
    return atlas, locs


def pack_atlas_quads(atlas: np.ndarray) -> np.ndarray:
    """Four parity-shifted 2x2-texel-quad copies of the atlas.

    quads[(y0%2)*2 + x0%2] at block (y0//2, x0//2) holds the four texels
    (y0..y0+1, x0..x0+1) as 16 contiguous channels, so any bilinear footprint
    is ONE row gather (see ops/sampling.sample_atlas). Returned flattened as
    (4*BH*BW, 16); block grid dims derive from the atlas shape.
    """
    ah, aw, c = atlas.shape
    assert ah % 2 == 0 and aw % 2 == 0
    p = np.pad(atlas, ((0, 3), (0, 3), (0, 0)))
    bh, bw = ah // 2 + 1, aw // 2 + 1
    copies = []
    for sy in range(2):
        for sx in range(2):
            sub = p[sy : sy + bh * 2, sx : sx + bw * 2]
            q = (
                sub.reshape(bh, 2, bw, 2, c)
                .transpose(0, 2, 1, 3, 4)
                .reshape(bh, bw, 4 * c)
            )
            copies.append(q)
    return np.stack(copies).reshape(4 * bh * bw, 4 * c)


def _round_up(x: int, m: int) -> int:
    return max((x + m - 1) // m * m, m)


# Above this many combined texels the bf16 quad tables (~96 B/texel with the
# 4 parity copies) waste device memory; switch to the u16 tile atlas
# (~24 B/texel, ops/sampling.py TILE_* geometry).
TILE_ATLAS_THRESHOLD_TEXELS = 1_000_000


def build_tile_atlas(images: Sequence[np.ndarray]):
    """Per-material 8-channel images -> (tiles (N, 128) i32, meta (M, 4) i32).

    images: one (h, w, 8) f32 array per material, channels [diffuse RGB
    linear, normal XYZ, mr G, mr B]. Each image gets a 1-texel wrapped
    border, is quantized to u16 (round-to-nearest; <= 7.7e-6 per channel),
    and is cut into 4x8-texel
    tiles on a (3, 7) grid so any bilinear 2x2 window lives in ONE tile.
    Tile row lanes: ch2 * 32 + y * 8 + x holds channels 2*ch2 | 2*ch2+1<<16.
    meta rows are (row base, tiles per row, h, w).
    """
    from arctic_tpu.ops.sampling import TILE_H, TILE_SX, TILE_SY, TILE_W

    metas = np.zeros((len(images), 4), np.int32)
    parts = []
    base = 0
    for mi, img in enumerate(images):
        h, w = img.shape[:2]
        q = np.floor(np.clip(img.astype(np.float32) * 65535.0 + 0.5, 0, 65535))
        q = q.astype(np.uint32)
        p = np.pad(q, ((1, 1), (1, 1), (0, 0)), mode="wrap")
        nty, ntx = h // TILE_SY + 1, w // TILE_SX + 1
        hp = TILE_SY * (nty - 1) + TILE_H
        wp = TILE_SX * (ntx - 1) + TILE_W
        p = np.pad(p, ((0, hp - p.shape[0]), (0, wp - p.shape[1]), (0, 0)))
        sv = np.lib.stride_tricks.as_strided(
            p,
            shape=(nty, ntx, TILE_H, TILE_W, 8),
            strides=(
                p.strides[0] * TILE_SY, p.strides[1] * TILE_SX,
                p.strides[0], p.strides[1], p.strides[2],
            ),
        )
        t = np.ascontiguousarray(sv).reshape(nty * ntx, TILE_H, TILE_W, 8)
        packed = t[..., 0::2] | (t[..., 1::2] << 16)  # (N, 4, 8, 4) u32
        rows = packed.transpose(0, 3, 1, 2).reshape(-1, 128)
        parts.append(rows.view(np.int32))
        metas[mi] = (base, ntx, h, w)
        base += nty * ntx
    return np.concatenate(parts), metas


# Per-group slice budget for the opt-in grouped tile route: the atlas is
# partitioned into material groups whose [tiles + env copy] slices stay
# under this size (see group_tile_atlas / sampling.tile_tap_resolve_grouped).
TEX_GROUP_BUDGET_BYTES = 104 * 1024 * 1024


def group_tile_atlas(
    tiles_np: np.ndarray,
    metas: np.ndarray,
    env_rows: np.ndarray,
    budget_bytes: int = TEX_GROUP_BUDGET_BYTES,
    explicit_groups=None,
):
    """Partition the tile atlas into material groups, each with its own env
    copy, so every group's slice sits under the fast-gather tier.

    Returns (table (N', 128) i32, metas', groups, group_of, mat_rows): the
    interleaved layout [g0 tiles | env | g1 tiles | env | ...], per-material
    metas with bases rebased into it, ``groups`` rows (mstart, env_base,
    end) (see core.scene.TextureAtlas.tile_groups), the material -> group
    map, and tile rows per material.
    A group's slice [mstart:end] is self-contained: a covered pixel's tile
    row and an uncovered pixel's env row both live inside it, so a compacted
    per-group gather needs only that slice.

    ``explicit_groups`` (list of material-id lists, e.g. from
    io.texplan.plan_material_groups' co-occurrence anneal) overrides the
    default contiguous-by-id greedy packing; the table lays materials out
    in that order. Materials/groups that alone exceed the budget still get
    a slice — correctness holds, the slice just gathers at the slow tier.
    """
    m = len(metas)
    total = tiles_np.shape[0]
    counts = [
        (int(metas[i + 1][0]) if i + 1 < m else total) - int(metas[i][0])
        for i in range(m)
    ]
    e = int(env_rows.shape[0])
    budget_rows = budget_bytes // (tiles_np.shape[1] * 4)
    if explicit_groups is not None:
        groups_mats = [list(g) for g in explicit_groups if len(g)]
        flat = sorted(mi for g in groups_mats for mi in g)
        assert flat == list(range(m)), "explicit_groups must partition materials"
    else:
        groups_mats = []
        cur: list[int] = []
        cur_rows = 0
        for i in range(m):
            if cur and cur_rows + counts[i] + e > budget_rows:
                groups_mats.append(cur)
                cur, cur_rows = [], 0
            cur.append(i)
            cur_rows += counts[i]
        if cur:
            groups_mats.append(cur)

    parts = []
    groups = []
    group_of = [0] * m
    new_metas = metas.copy()
    base = 0
    for gi, mats in enumerate(groups_mats):
        mstart = base
        for i in mats:
            orig = int(metas[i][0])
            parts.append(tiles_np[orig : orig + counts[i]])
            new_metas[i][0] = base
            group_of[i] = gi
            base += counts[i]
        parts.append(env_rows)
        env_base = base
        base = env_base + e
        groups.append((mstart, env_base, base))
    assert base < (1 << 24), "tile row bases must stay f32-exact"
    return (
        np.concatenate(parts),
        new_metas,
        tuple(groups),
        tuple(group_of),
        tuple(counts),
    )


def _pack_rows_128(rows: np.ndarray) -> np.ndarray:
    """(Q, L) -> (ceil(Q*L/128), 128) dense row packing (128 % L == 0)."""
    q, l = rows.shape
    per = 128 // l
    qp = _round_up(q, per)
    return np.pad(rows, ((0, qp - q), (0, 0))).reshape(qp // per, 128)


def build_buffers(
    meshes: Sequence[MeshData],
    objects: Sequence[tuple[np.ndarray, int]],  # (trs 4x4, mesh index)
    materials: Sequence[MaterialImages],
    environment: np.ndarray,  # (H, W, 3) f32 linear radiance
    atlas_dtype=jnp.bfloat16,
    tri_bucket: int = 1024,
    tile_threshold_texels: int | None = None,
    tex_group_budget: int | None = None,
    tex_groups=None,
) -> SceneBuffers:
    """Flatten a scene into device buffers (one host->device transfer each)."""
    pos_l, nrm_l, tan_l, btn_l, uv_l, vobj_l = [], [], [], [], [], []
    idx_l, mat_l = [], []
    vbase = 0
    trs_list = []
    for obj_id, (trs, mesh_idx) in enumerate(objects):
        m = meshes[mesh_idx]
        tan, btn = m.tangents, m.bitangents
        if tan is None or btn is None:
            tan, btn = compute_tangents(m.positions, m.normals, m.uvs, m.indices)
        nv = len(m.positions)
        pos_l.append(np.asarray(m.positions, np.float32))
        nrm_l.append(np.asarray(m.normals, np.float32))
        tan_l.append(np.asarray(tan, np.float32))
        btn_l.append(np.asarray(btn, np.float32))
        uv_l.append(np.asarray(m.uvs, np.float32))
        vobj_l.append(np.full(nv, obj_id, np.int32))
        idx_l.append(np.asarray(m.indices, np.int32) + vbase)
        mat_l.append(np.full(len(m.indices), m.material, np.int32))
        trs_list.append(np.asarray(trs, np.float32))
        vbase += nv

    positions = np.concatenate(pos_l)
    indices = np.concatenate(idx_l)
    tri_mat = np.concatenate(mat_l)
    num_tris = len(indices)
    cap = _round_up(num_tris, tri_bucket)
    indices = np.pad(indices, ((0, cap - num_tris), (0, 0)))
    tri_mat = np.pad(tri_mat, (0, cap - num_tris))

    # Tri-major static shading attributes (fused path, zero per-frame vertex
    # gathers): per-corner normalized n/t/b + uv, object-space corner
    # positions, the triangle's object id. Normalization matches
    # maths.normalize (f32, no eps) bit-for-bit by computing in f32.
    normals = np.concatenate(nrm_l)
    tangents = np.concatenate(tan_l)
    bitangents = np.concatenate(btn_l)
    uvs = np.concatenate(uv_l)
    vobj = np.concatenate(vobj_l)

    def _norm_f32(v):
        v = v.astype(np.float32)
        n = np.sqrt(np.sum(v * v, axis=-1, keepdims=True, dtype=np.float32))
        with np.errstate(divide="ignore", invalid="ignore"):
            return (v / n).astype(np.float32)

    vattr_static = np.concatenate(
        [_norm_f32(normals), _norm_f32(tangents), _norm_f32(bitangents),
         uvs.astype(np.float32)], axis=1,
    )  # (V, 11)
    vattr_static = np.nan_to_num(vattr_static)  # zero-length n/t/b of pad verts
    tri_corner_pos = positions[indices].astype(np.float32)  # (cap, 3, 3)
    tri_static_attrs = vattr_static[indices]  # (cap, 3, 11)
    tri_obj = vobj[indices[:, 0]].astype(np.int32)  # (cap,)

    geometry = Geometry(
        positions=jnp.asarray(positions),
        normals=jnp.asarray(normals),
        tangents=jnp.asarray(tangents),
        bitangents=jnp.asarray(bitangents),
        uvs=jnp.asarray(uvs),
        vertex_object=jnp.asarray(vobj),
        indices=jnp.asarray(indices),
        tri_material=jnp.asarray(tri_mat),
        object_trs=jnp.asarray(np.stack(trs_list)),
        num_tris=jnp.int32(num_tris),
        # Component planes (K, T): see core/scene.py Geometry docs.
        tri_corner_pos=jnp.asarray(
            tri_corner_pos.reshape(-1, 9).T.copy()
        ),
        tri_obj=jnp.asarray(tri_obj),
        tri_trs=jnp.asarray(
            np.stack(trs_list)[tri_obj].astype(np.float32).reshape(-1, 16).T.copy()
        ),
        tri_static_attrs=jnp.asarray(
            tri_static_attrs.reshape(-1, 33).T.copy()
        ),
        tri_matrow=None,  # filled below once the atlas regions exist
    )

    # Atlas: 3 slots per material; diffuse sRGB-decoded, rest linear.
    images = []
    nm_consts = np.zeros((len(materials), 4), np.float32)
    mr_consts = np.zeros((len(materials), 4), np.float32)
    nm_constant = True
    mr_constant = True

    def _const(img):
        f = img.astype(np.float32) / 255.0
        return f[0, 0] if (img == img.reshape(-1, img.shape[-1])[0]).all() else None

    for mi, mat in enumerate(materials):
        d = mat.diffuse.astype(np.float32) / 255.0
        d[..., :3] = srgb_to_linear_np(d[..., :3])
        images.append(d)
        images.append(mat.normal.astype(np.float32) / 255.0)
        images.append(mat.metal_roughness.astype(np.float32) / 255.0)
        c = _const(mat.normal)
        if c is None:
            nm_constant = False
        else:
            nm_consts[mi] = c
        c = _const(mat.metal_roughness)
        if c is None:
            mr_constant = False
        else:
            mr_consts[mi] = c
    # Reference-scale texture sets: the quad tables' ~96 B/texel (4 parity
    # copies x 48 bf16 channels) is untenable past ~1M texels (e.g. Khronos
    # Sponza's ~25 materials x 3 x 1K^2); switch to the u16 tile atlas
    # (~24 B/texel, one gather row per pixel, ops/sampling.tile_index).
    per_mat_hw = []
    tile_ok = True
    for mi in range(len(materials)):
        group = [images[3 * mi + s] for s in range(3)]
        konst = [(im == im.reshape(-1, im.shape[-1])[0]).all() for im in group]
        dims = {im.shape[:2] for im, k in zip(group, konst) if not k}
        if len(dims) > 1:
            tile_ok = False
            break
        per_mat_hw.append(dims.pop() if dims else (1, 1))
    total_texels = sum(h * w for h, w in per_mat_hw) if tile_ok else 0
    threshold = (
        TILE_ATLAS_THRESHOLD_TEXELS
        if tile_threshold_texels is None
        else tile_threshold_texels
    )
    use_tiles = tile_ok and total_texels > threshold

    if use_tiles:
        images8 = []
        for mi, (h, w) in enumerate(per_mat_hw):
            group = [
                im if im.shape[:2] == (h, w)
                else np.broadcast_to(im[0:1, 0:1], (h, w, 4))
                for im in (images[3 * mi], images[3 * mi + 1], images[3 * mi + 2])
            ]
            images8.append(
                np.concatenate(
                    [group[0][..., :3], group[1][..., :3], group[2][..., 1:3]],
                    axis=-1,
                )
            )
        tiles_np, tile_meta = build_tile_atlas(images8)
        # The per-slot quad atlas would be ~GBs here and only serves the
        # deferred/debug path — skip it (shade() raises a clear error).
        atlas_np = np.zeros((2, 2, 4), np.float32)
        regions = np.zeros((len(materials), 3, 4), np.int32)
    else:
        tiles_np = tile_meta = None
        atlas_np, locs = pack_atlas(images)
        regions = locs.reshape(len(materials), 3, 4)

    # Combined-slot atlas: interleave each material's non-elided textures
    # into one multi-channel image so a pixel's material taps are ONE row
    # gather. Valid when, per material, the non-constant slots share dims
    # (a constant texture resampled to any size is bit-identical).
    slots = [0] + ([] if nm_constant else [1]) + ([] if mr_constant else [2])
    combined = None
    if use_tiles:
        combined = False
    elif len(slots) > 1:
        combined_imgs = []
        total_texels = 0
        for mi in range(len(materials)):
            group = [images[3 * mi + s] for s in slots]
            konst = [(im == im.reshape(-1, im.shape[-1])[0]).all() for im in group]
            dims = {im.shape[:2] for im, k in zip(group, konst) if not k}
            if len(dims) > 1:
                combined = False  # incompatible sizes: keep separate taps
                break
            hw = dims.pop() if dims else max(im.shape[:2] for im in group)
            group = [
                im if im.shape[:2] == hw else np.broadcast_to(im[0:1, 0:1], hw + (4,))
                for im in group
            ]
            combined_imgs.append(np.concatenate(group, axis=-1))
            total_texels += hw[0] * hw[1]
        if combined is None and total_texels <= 32 * 1024 * 1024:
            combined = True
    if combined:
        c_np, c_locs = pack_atlas(combined_imgs)
        combined_kw = dict(
            combined_quads=jnp.asarray(pack_atlas_quads(c_np), atlas_dtype),
            combined_regions=jnp.asarray(c_locs),
            combined_shape=c_np.shape[:2],
            combined_slots=tuple(slots),
        )
    else:
        combined_kw = {}

    atlas = TextureAtlas(
        data=jnp.asarray(atlas_np, atlas_dtype),
        quads=jnp.asarray(pack_atlas_quads(atlas_np), atlas_dtype),
        regions=jnp.asarray(regions),
        nm_consts=jnp.asarray(nm_consts),
        mr_consts=jnp.asarray(mr_consts),
        nm_constant=nm_constant,
        mr_constant=mr_constant,
        **combined_kw,
    )

    # Environment packing (hoisted above the material-row build: the tile
    # path interleaves env copies into the tile table, which rebases the
    # per-material tile addresses the matrow carries).
    env_np = np.asarray(environment, np.float32)
    env_rgba = np.concatenate(
        [env_np, np.ones((*env_np.shape[:2], 1), np.float32)], axis=-1
    )
    env_data, env_locs = pack_atlas([env_rgba])
    env_quads = pack_atlas_quads(env_data)

    tile_groups = tile_group_of = tile_mat_rows = None
    if use_tiles:
        env_rows_np = _pack_rows_128(env_quads.astype(np.float32)).view(np.int32)
        tiles_np, tile_meta, tile_groups, tile_group_of, tile_mat_rows = group_tile_atlas(
            tiles_np, tile_meta, env_rows_np,
            TEX_GROUP_BUDGET_BYTES if tex_group_budget is None else tex_group_budget,
            explicit_groups=tex_groups,
        )

    # Per-triangle material row for the fused shade table:
    # [atlas regions (3 slots x (y,x,h,w)) | mr_consts | nm_consts[:3] |
    #  combined-atlas region (zeros when the combined path is off)].
    if use_tiles:
        # Tile path: the 4 "combined region" matrow lanes carry the
        # material's tile-block address (base, ntx, h, w) instead.
        c_reg = tile_meta.astype(np.float32)
    elif combined_kw:
        c_reg = np.asarray(combined_kw["combined_regions"], np.float32)
    else:
        c_reg = np.zeros((len(materials), 4), np.float32)
    matrow_by_mat = np.concatenate(
        [regions.reshape(len(materials), 12).astype(np.float32),
         mr_consts, nm_consts[:, :3], c_reg], axis=1,
    )  # (M, 23)
    import dataclasses as _dc

    matrow_tri = matrow_by_mat[tri_mat].T  # (23, cap)
    geometry = _dc.replace(geometry, tri_matrow=jnp.asarray(matrow_tri.copy()))

    env_atlas = TextureAtlas(
        data=jnp.asarray(env_data, jnp.float32),
        quads=jnp.asarray(env_quads, jnp.float32),
        # bf16 like the material atlas: the sky tap is a discard-most gather
        # (covered pixels read one hygiene row) and background radiance
        # through ACES+u8 is insensitive at bf16's 0.4%; halves the fetch
        # and the channel-first relayout bytes.
        quads_packed=jnp.asarray(_pack_rows_128(env_quads), jnp.bfloat16),
        regions=jnp.asarray(env_locs.reshape(1, 1, 4)),
    )
    env = Environment(data=jnp.asarray(env_np), atlas=env_atlas)
    if use_tiles:
        # The tile table already interleaves env copies per material group
        # (group_tile_atlas above: f32 quads bit-viewed as i32 rows; the
        # resolve kernel bitcasts them back) so the texture+sky tap stays
        # ONE gather per pixel. tiles_ntex keeps the ungrouped semantics:
        # the env base every consumer may use when it ignores grouping
        # (any group's env copy holds identical rows).
        atlas = _dc.replace(
            atlas,
            tiles=jnp.asarray(tiles_np),
            tiles_ntex=int(tile_groups[0][1]),
            tile_groups=tile_groups,
            tile_group_of=tile_group_of,
            tile_mat_rows=tile_mat_rows,
            # Real per-group device tables (not slices): see
            # core.scene.TextureAtlas.tile_group_tables. Only for the
            # OPT-IN grouped route (explicit tex_groups), so default builds
            # skip the ~2x atlas memory.
            tile_group_tables=(
                tuple(
                    jnp.asarray(tiles_np[lo:hi])
                    for lo, _eb, hi in tile_groups
                )
                if (len(tile_groups) > 1 and tex_groups is not None)
                else None
            ),
        )
    if combined:
        from arctic_tpu.ops.sampling import pack_tex_rows

        atlas = _dc.replace(
            atlas,
            combined_env_rows=jnp.concatenate(
                [pack_tex_rows(atlas.combined_quads), env_atlas.quads_packed],
                axis=0,
            ),
        )
    return SceneBuffers(geometry=geometry, atlas=atlas, environment=env)
