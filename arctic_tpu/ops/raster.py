"""Triangle setup + rasterization as dataflow.

The reference leans on D3D12's hardware rasterizer (vertex shader in
shaders/depth.hlsl + shaders/forward.hlsl:50-66, fixed-function raster).
JAX cannot reach a GPU's fixed-function rasterizer, so rasterization is
reformulated in software:

    clip-space verts -> near-plane clip (static 2T slots)
                     -> screen-space triangle setup (edge + depth planes)
                     -> depth test as a masked min-reduce over triangles
                     -> visibility buffer (z, slot id) per pixel

Edge functions are *linear* in pixel coordinates, so a block of pixels is
tested against a triangle with three multiply-adds per edge — the
brute-force rasterizer here (tests / small frames, the reference the tiled
kernel is checked against) and the tiled Pallas kernel (ops/raster_tiles.py)
evaluate the same expressions in the same order.

D3D conventions reproduced:
- viewport transform with y flip, pixel centers at +0.5 (D3D11.3 spec §3.3)
- FrontCounterClockwise=TRUE culling (forward_pass.cpp:144): with y-down
  screen coords the *visually* counter-clockwise front faces have negative
  signed area.
- top-left fill rule, depth func LESS, 0..1 depth range.
- depth-only variant culls FRONT faces (shadow_map_pass.cpp:97).

Watertightness: shared edges use a canonical endpoint ordering so the two
adjacent triangles evaluate bit-identical (negated) edge functions — a pixel
on the shared edge lands in exactly one triangle.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import jax
import jax.numpy as jnp

from arctic_tpu.core.scene import _pytree_dataclass

Array = jnp.ndarray

# Vertex snap grid (1/16 pixel) keeps edge coefficients exactly representable.
SNAP = 16.0
# Exclusion bias for non-top-left edges (approximate top-left rule in f32).
EDGE_EPS = 1.0 / 4096.0
# Edge "C" coefficient for dead slots: fails every inside test.
DEAD_C = -1.0e30


# --------------------------------------------------------------------------
# Near-plane clipping
# --------------------------------------------------------------------------

# For each 3-bit inside code (bit i = vertex i has clip z >= 0), a cyclic
# rotation bringing the pattern to (in, out, out) or (in, in, out).
_CLIP_ROT = jnp.array([0, 0, 1, 0, 2, 2, 1, 0], jnp.int32)
_CLIP_NOUT = jnp.array([0, 1, 1, 2, 1, 2, 2, 1], jnp.int32)


@_pytree_dataclass
class ClippedTris:
    """Output of near-plane clipping: 2 static slots per input triangle.

    COMPONENT LAYOUT: every per-slot quantity is a plain dense (P,) array
    (nested tuples index [corner] / [corner][orig_vertex]): every consumer
    reads dense planes and fuses.

    ``cb[c][k]`` gives the barycentric weight of clipped-triangle corner
    ``c`` over original-triangle vertex ``k`` — clip space is linear in
    world space, so these weights interpolate any vertex attribute exactly.
    """

    cx: tuple  # 3 x (P,) clip-space x per corner
    cy: tuple
    cz: tuple
    cw: tuple
    cb: tuple  # 3 x 3 x (P,) corner_bary[corner][orig_vertex]
    valid: Array  # (P,) bool

    @property
    def capacity(self) -> int:
        return self.valid.shape[0]

    @property
    def orig_tri(self) -> Array:
        # Slots are always [primary tris; secondary tris].
        t = self.capacity // 2
        ar = jnp.arange(t, dtype=jnp.int32)
        return jnp.concatenate([ar, ar])


def near_clip_triangles(clip_verts: Array, indices: Array, tri_valid: Array) -> ClippedTris:
    """Clip triangles against the near plane (clip z = 0, D3D ZO convention).

    The reference gets this from fixed-function clipping; here each input
    triangle owns 2 output slots (a clipped triangle fans into at most 2).
    """
    v = clip_verts[indices]  # (T, 3, 4)
    corners = tuple(
        tuple(v[:, c, i] for i in range(4)) for c in range(3)
    )
    return near_clip_corners(corners, tri_valid)


def near_clip_corners(corners, tri_valid: Array) -> ClippedTris:
    """near_clip_triangles on tri-major corner components.

    ``corners[c] = (x, y, z, w)`` of (T,) arrays. The hot path computes
    these directly from precomputed tri-major world corners
    (pipeline.world_corners) — the per-vertex formulation costs 3T row
    gathers per pass."""
    tcount = tri_valid.shape[0]
    inside = [corners[c][2] >= 0.0 for c in range(3)]
    code = (
        inside[0].astype(jnp.int32)
        + 2 * inside[1].astype(jnp.int32)
        + 4 * inside[2].astype(jnp.int32)
    )
    rot = _CLIP_ROT[code]  # (T,)
    nout = jnp.where(tri_valid, _CLIP_NOUT[code], 0)

    # Rotate vertices so inside ones come first (cyclic: winding preserved).
    # Branch-free 3-way selects instead of take_along_axis gathers.
    def pick(cidx):
        i = (cidx + rot) % 3
        m0 = i == 0
        m1 = i == 1
        vert = tuple(
            jnp.where(m0, corners[0][j], jnp.where(m1, corners[1][j], corners[2][j]))
            for j in range(4)
        )
        bary = tuple((i == k).astype(jnp.float32) for k in range(3))
        return vert, bary

    (a, ba), (b, bb), (c, bc) = pick(0), pick(1), pick(2)
    za, zb, zc = a[2], b[2], c[2]

    def lerp(p, q, t):
        # componentwise over 3- or 4-tuples
        return tuple(pp + t * (qq - pp) for pp, qq in zip(p, q))

    safe = lambda n, d: n / jnp.where(jnp.abs(d) < 1e-30, 1e-30, d)

    # Case one-in (a in; b, c out): triangle (a, ab, ac).
    t_ab = safe(za, za - zb)
    t_ac = safe(za, za - zc)
    one_tri = (a, lerp(a, b, t_ab), lerp(a, c, t_ac))
    one_bary = (ba, lerp(ba, bb, t_ab), lerp(ba, bc, t_ac))

    # Case two-in (a, b in; c out): fan (a, b, bc) + (a, bc, ac).
    t_bc = safe(zb, zb - zc)
    t_ca = safe(za, za - zc)
    p_bc, bb_bc = lerp(b, c, t_bc), lerp(bb, bc, t_bc)
    p_ac, bb_ac = lerp(a, c, t_ca), lerp(ba, bc, t_ca)
    two0 = ((a, b, p_bc), (ba, bb, bb_bc))
    two1 = ((a, p_bc, p_ac), (ba, bb_bc, bb_ac))

    is_all_in = code == 7
    is_one_in = (code == 1) | (code == 2) | (code == 4)
    orig = ((a, b, c), (ba, bb, bc))

    def sel(orig_v, one_v, two_v):
        return jnp.where(is_all_in, orig_v, jnp.where(is_one_in, one_v, two_v))

    # Slot layout: [all primary outputs; all secondary outputs] — a concat,
    # not an interleave (interleaving is a transpose XLA pays for at every
    # consumer). Secondary clip halves therefore sort after all primaries in
    # draw order; only exactly-coplanar clipped geometry could notice.
    def cat(p0, p1):
        return jnp.concatenate([p0, p1])

    coords = []
    for j in range(4):  # x, y, z, w
        coords.append(
            tuple(
                cat(sel(orig[0][cc][j], one_tri[cc][j], two0[0][cc][j]), two1[0][cc][j])
                for cc in range(3)
            )
        )
    cb_out = tuple(
        tuple(
            cat(sel(orig[1][cc][k], one_bary[cc][k], two0[1][cc][k]), two1[1][cc][k])
            for k in range(3)
        )
        for cc in range(3)
    )
    return ClippedTris(
        cx=coords[0],
        cy=coords[1],
        cz=coords[2],
        cw=coords[3],
        cb=cb_out,
        valid=jnp.concatenate([nout >= 1, nout >= 2]),
    )


# --------------------------------------------------------------------------
# Screen-space setup
# --------------------------------------------------------------------------


@_pytree_dataclass
class TriSetup:
    """Per-slot screen-space triangle data consumed by raster + shading.

    COMPONENT LAYOUT: dense (P,) arrays in nested tuples (see ClippedTris) —
    the *_arr() helpers materialize the legacy stacked views for cold paths
    (brute-force rasterizer, deferred shading, tests)."""

    sx: tuple  # 3 x (P,) snapped screen x per corner
    sy: tuple  # 3 x (P,) snapped screen y (y down)
    w: tuple  # 3 x (P,) clip w per corner
    zplane: tuple  # (Az, Bz, Cz) of (P,): z(p) = Az x + Bz y + Cz
    edges: tuple  # 3 x (A, B, C) of (P,) oriented edge coeffs; C includes
    #               the fill-rule bias; e_i >= 0 for all i <=> pixel covered
    inv_area2: Array  # (P,) 1 / |signed area * 2| for barycentrics
    cb: tuple  # 3 x 3 x (P,) weights over original triangle vertices
    valid: Array  # (P,) bool
    bbox: tuple  # (x0, y0, x1, y1) of (P,) f32, clamped to viewport

    @property
    def capacity(self) -> int:
        return self.valid.shape[0]

    @property
    def orig_tri(self) -> Array:
        t = self.capacity // 2
        ar = jnp.arange(t, dtype=jnp.int32)
        return jnp.concatenate([ar, ar])

    # Legacy stacked views (cold paths only — these materialize tile-padded
    # small-minor arrays).
    def edges_arr(self) -> Array:  # (P, 3, 3)
        return jnp.stack(
            [jnp.stack(list(e), axis=-1) for e in self.edges], axis=1
        )

    def w_arr(self) -> Array:  # (P, 3)
        return jnp.stack(list(self.w), axis=-1)

    def corner_bary_arr(self) -> Array:  # (P, 3, 3)
        return jnp.stack(
            [jnp.stack(list(row), axis=-1) for row in self.cb], axis=1
        )


def _canonical_edge(ax, ay, bx, by):
    """Edge coefficients with canonical endpoint order for watertightness.

    Returns (A, B, C, flip) with e(p) = A px + B py + C computed from the
    lexicographically smaller endpoint first; ``flip`` is -1 if (a, b) was
    swapped. Two triangles sharing the edge get bit-identical |coefficients|.
    """
    swap = (ay > by) | ((ay == by) & (ax > bx))
    x0 = jnp.where(swap, bx, ax)
    y0 = jnp.where(swap, by, ay)
    x1 = jnp.where(swap, ax, bx)
    y1 = jnp.where(swap, ay, by)
    dx = x1 - x0
    dy = y1 - y0
    # e(p) = cross(b - a, p - a) = dx (py - y0) - dy (px - x0)
    A = -dy
    B = dx
    C = dy * x0 - dx * y0
    flip = jnp.where(swap, -1.0, 1.0)
    return A, B, C, flip


def setup_screen_triangles(
    tris: ClippedTris,
    width: int,
    height: int,
    cull: str = "back",
) -> TriSetup:
    """Project clipped triangles to the viewport and build raster planes.

    cull: "back" keeps visually-CCW front faces (forward pass semantics,
    forward_pass.cpp:144 FrontCounterClockwise + default BACK cull); "front"
    keeps the opposite set (shadow pass, shadow_map_pass.cpp:97); "none"
    keeps both.
    """
    w = tris.cw  # 3 x (P,)
    # D3D viewport transform (y flip), snapped to the 1/16 px grid.
    sx = tuple(
        jnp.round((tris.cx[c] / w[c] + 1.0) * (0.5 * width) * SNAP) / SNAP
        for c in range(3)
    )
    sy = tuple(
        jnp.round((1.0 - tris.cy[c] / w[c]) * (0.5 * height) * SNAP) / SNAP
        for c in range(3)
    )
    z = tuple(tris.cz[c] / w[c] for c in range(3))

    x0, x1, x2 = sx
    y0, y1, y2 = sy
    area2 = (x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0)

    # Front faces (visually CCW, y-down coords) have area2 < 0.
    if cull == "back":
        keep = area2 < 0
    elif cull == "front":
        keep = area2 > 0
    elif cull == "none":
        keep = area2 != 0
    else:  # pragma: no cover
        raise ValueError(f"bad cull mode {cull!r}")
    s = jnp.where(area2 < 0, -1.0, 1.0)  # orient edges inside-positive

    # Edge i is opposite vertex i: from vertex i+1 to vertex i+2.
    corners = [(x0, y0), (x1, y1), (x2, y2)]
    edges = []
    for i in range(3):
        ax, ay = corners[(i + 1) % 3]
        bx, by = corners[(i + 2) % 3]
        A, B, C, flip = _canonical_edge(ax, ay, bx, by)
        o = s * flip
        edges.append((o * A, o * B, o * C))

    inv_area2 = 1.0 / jnp.where(area2 == 0, 1.0, jnp.abs(area2))

    # Depth plane from the oriented edges: z(p) = sum_i e_i(p) z_i / |area2|.
    Az = sum(edges[i][0] * z[i] for i in range(3)) * inv_area2
    Bz = sum(edges[i][1] * z[i] for i in range(3)) * inv_area2
    Cz = sum(edges[i][2] * z[i] for i in range(3)) * inv_area2

    valid = tris.valid & keep & jnp.isfinite(area2)

    # Fill rule: include the boundary only on top (A==0, B>0) and left (A>0)
    # edges; bias everything else out by a sub-quantum epsilon. Dead slots:
    # make every inside test fail without branching.
    biased = []
    for A, B, C in edges:
        top_left = ((A == 0) & (B > 0)) | (A > 0)
        Cb = C + jnp.where(top_left, 0.0, -EDGE_EPS)
        biased.append((A, B, jnp.where(valid, Cb, DEAD_C)))

    bx0 = jnp.clip(jnp.minimum(jnp.minimum(x0, x1), x2), 0.0, float(width))
    bx1 = jnp.clip(jnp.maximum(jnp.maximum(x0, x1), x2), 0.0, float(width))
    by0 = jnp.clip(jnp.minimum(jnp.minimum(y0, y1), y2), 0.0, float(height))
    by1 = jnp.clip(jnp.maximum(jnp.maximum(y0, y1), y2), 0.0, float(height))
    valid = valid & (bx1 > bx0) & (by1 > by0)

    return TriSetup(
        sx=sx,
        sy=sy,
        w=w,
        zplane=(Az, Bz, Cz),
        edges=tuple(biased),
        inv_area2=inv_area2,
        cb=tris.cb,
        valid=valid,
        bbox=(bx0, by0, bx1, by1),
    )


# --------------------------------------------------------------------------
# Brute-force rasterizer (correctness baseline / tiny frames / CPU "WARP")
# --------------------------------------------------------------------------


def _pixel_centers(height: int, width: int, y_offset=0.0) -> Tuple[Array, Array]:
    """Pixel-center grids; ``y_offset`` (traced ok) shifts rows for sharded
    rendering where a device owns a horizontal slice of the frame."""
    ys = jnp.arange(height, dtype=jnp.float32) + 0.5 + y_offset
    xs = jnp.arange(width, dtype=jnp.float32) + 0.5
    return jnp.meshgrid(xs, ys, indexing="xy")  # each (H, W)


def rasterize_bruteforce(
    setup: TriSetup, height: int, width: int, chunk: int = 256, y_offset=0.0
) -> Tuple[Array, Array]:
    """Depth-test every triangle against every pixel, in chunks.

    Semantics of the hardware path (depth LESS, draw order breaks ties):
    earlier slots win ties because argmin returns the first minimum and the
    cross-chunk carry uses strict <.
    Returns (zbuf f32 (H, W) init 1.0, ibuf i32 (H, W) init -1).
    """
    cap = setup.capacity
    pad = (-cap) % chunk
    comps = [c for e in setup.edges for c in e] + list(setup.zplane)
    planes = jnp.pad(jnp.stack(comps, axis=1), ((0, pad), (0, 0)))  # (P', 12)
    if pad:
        # Dead padding slots: every edge test fails.
        planes = planes.at[cap:, 2].set(DEAD_C)
    n_chunks = (cap + pad) // chunk

    px, py = _pixel_centers(height, width, y_offset)
    px = px.reshape(-1, 1)
    py = py.reshape(-1, 1)

    def body(carry, inputs):
        zbuf, ibuf = carry
        pl, base = inputs  # (chunk, 12)

        def plane(j):  # edge/depth plane j evaluated at every pixel (HW, chunk)
            return pl[:, 3 * j] * px + pl[:, 3 * j + 1] * py + pl[:, 3 * j + 2]

        # Elementwise in the tiled kernel's exact expression order, so both
        # rasterizers round identically.
        inside = (plane(0) >= 0.0) & (plane(1) >= 0.0) & (plane(2) >= 0.0)
        zv = plane(3)
        zv = jnp.where(inside & (zv >= 0.0) & (zv <= 1.0), zv, jnp.inf)
        k = jnp.argmin(zv, axis=1)
        zmin = jnp.take_along_axis(zv, k[:, None], axis=1)[:, 0]
        upd = zmin < zbuf
        zbuf = jnp.where(upd, zmin, zbuf)
        ibuf = jnp.where(upd, base + k.astype(jnp.int32), ibuf)
        return (zbuf, ibuf), None

    zbuf0 = jnp.ones((height * width,), jnp.float32)
    ibuf0 = jnp.full((height * width,), -1, jnp.int32)
    bases = jnp.arange(n_chunks, dtype=jnp.int32) * chunk
    planes_c = planes.reshape(n_chunks, chunk, 12)
    (zbuf, ibuf), _ = jax.lax.scan(body, (zbuf0, ibuf0), (planes_c, bases))
    return zbuf.reshape(height, width), ibuf.reshape(height, width)


# --------------------------------------------------------------------------
# Attribute interpolation from a visibility buffer
# --------------------------------------------------------------------------


def pixel_barycentrics(
    setup: TriSetup, ibuf: Array, height: int, width: int, y_offset=0.0
) -> Tuple[Array, Array]:
    """Perspective-correct barycentrics over *original* triangle vertices.

    Returns (bary (H, W, 3), covered (H, W)). For covered pixels,
    ``attr = sum_i bary[..., i] * attr[orig_vertex_i]`` reproduces the D3D
    perspective-correct interpolation (including across near-plane clips,
    via the stored corner weights).
    """
    slot = jnp.maximum(ibuf, 0)
    covered = ibuf >= 0
    e = setup.edges_arr()[slot]  # (H, W, 3, 3)
    w = setup.w_arr()[slot]  # (H, W, 3)
    inv_a = setup.inv_area2[slot]  # (H, W)
    cb = setup.corner_bary_arr()[slot]  # (H, W, 3, 3)

    px, py = _pixel_centers(height, width, y_offset)
    ev = e[..., 0] * px[..., None] + e[..., 1] * py[..., None] + e[..., 2]
    b_screen = ev * inv_a[..., None]  # (H, W, 3) affine barycentrics
    bw = b_screen / w  # perspective weights over clipped corners
    b_orig = jnp.einsum("hwc,hwci->hwi", bw, cb, precision=jax.lax.Precision.HIGHEST)
    denom = jnp.sum(b_orig, axis=-1, keepdims=True)
    b_orig = b_orig / jnp.where(denom == 0, 1.0, denom)
    return b_orig, covered


def interpolate(
    setup: TriSetup,
    ibuf: Array,
    indices: Array,
    attrs: Array,
    bary: Array,
) -> Array:
    """Interpolate per-vertex ``attrs`` (V, C) at covered pixels -> (H, W, C)."""
    slot = jnp.maximum(ibuf, 0)
    tri = setup.orig_tri[slot]  # (H, W)
    vidx = indices[tri]  # (H, W, 3)
    av = attrs[vidx]  # (H, W, 3, C)
    return jnp.einsum("hwi,hwic->hwc", bary, av, precision=jax.lax.Precision.HIGHEST)
