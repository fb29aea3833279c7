"""Sun-frustum shadow culling: conservative light-space bounds of
(camera frustum) ∩ (scene AABB).

Every pixel the forward pass shades lies on visible geometry, so its
world position is inside the camera frustum (that is what visibility
means) AND inside the scene's AABB (it is a point on a triangle). The
sun-shadow term samples the shadow map only at such points' light-space
projections plus the bounded PCF window (forward.hlsl:84-93 offsets of
0.0001 UV x +-2 plus one bilinear texel), so shadow-map texels outside
the light-space bounds of frustum ∩ AABB are never read: the shadow
pass can skip tiles outside that rect and the rendered frame stays
BIT-IDENTICAL (in-rect tiles receive exactly the same pair lists in the
same order; the reference renders the full map every frame,
shadow_map_pass.cpp — this is a pure work reduction, applied per frame).

The bound must CONTAIN the intersection; it need not be tight. The
vertex set of the intersection of two convex bodies is
  {verts of A inside B} ∪ {verts of B inside A}
  ∪ {edges of A clipped to B} ∪ {edges of B clipped to A},
all cheap static-shaped segment/half-space math (<= 64 candidate
points). Inside tests use a small epsilon slack — LOOSE masks only grow
the rect, never break containment.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

Array = jnp.ndarray

_HIGH = None  # set lazily: jax.lax.Precision.HIGHEST for the mat4 solves


def _prec():
    global _HIGH
    if _HIGH is None:
        import jax

        _HIGH = jax.lax.Precision.HIGHEST
    return _HIGH


# Cube corners in "unit index" order: bit 0 -> x, bit 1 -> y, bit 2 -> z.
# (numpy, not jnp: this module is lazily imported inside jitted frames, and
# module-level device constants created under a trace leak tracers.)
_CORNER_BITS = np.asarray(
    [[(i >> a) & 1 for a in range(3)] for i in range(8)], np.float32
)
# The 12 cube edges as corner-index pairs (differ in exactly one bit).
_CUBE_EDGES = tuple(
    (i, i | (1 << a)) for i in range(8) for a in range(3) if not (i >> a) & 1
)


def aabb_corners(lo: Array, hi: Array) -> Array:
    """(3,) lo / hi -> (8, 3) corner points."""
    return lo + _CORNER_BITS * (hi - lo)


def _inv4(m: Array) -> Array:
    """Closed-form 4x4 inverse (cofactors of 2x2 subdeterminants).

    jnp.linalg.solve/inv lower to an LU custom call; this is ~60 scalar
    fusable ops. f32 error is absorbed by the caller's texel margin.
    """
    a = [[m[i, j] for j in range(4)] for i in range(4)]
    # 2x2 subdeterminants of rows (0,1) and rows (2,3).
    def d2(r0, r1, c0, c1):
        return a[r0][c0] * a[r1][c1] - a[r0][c1] * a[r1][c0]

    s0, s1, s2 = d2(0, 1, 0, 1), d2(0, 1, 0, 2), d2(0, 1, 0, 3)
    s3, s4, s5 = d2(0, 1, 1, 2), d2(0, 1, 1, 3), d2(0, 1, 2, 3)
    c0, c1, c2 = d2(2, 3, 0, 1), d2(2, 3, 0, 2), d2(2, 3, 0, 3)
    c3, c4, c5 = d2(2, 3, 1, 2), d2(2, 3, 1, 3), d2(2, 3, 2, 3)
    det = s0 * c5 - s1 * c4 + s2 * c3 + s3 * c2 - s4 * c1 + s5 * c0
    inv_det = 1.0 / det
    b = [
        [
            a[1][1] * c5 - a[1][2] * c4 + a[1][3] * c3,
            -a[0][1] * c5 + a[0][2] * c4 - a[0][3] * c3,
            a[3][1] * s5 - a[3][2] * s4 + a[3][3] * s3,
            -a[2][1] * s5 + a[2][2] * s4 - a[2][3] * s3,
        ],
        [
            -a[1][0] * c5 + a[1][2] * c2 - a[1][3] * c1,
            a[0][0] * c5 - a[0][2] * c2 + a[0][3] * c1,
            -a[3][0] * s5 + a[3][2] * s2 - a[3][3] * s1,
            a[2][0] * s5 - a[2][2] * s2 + a[2][3] * s1,
        ],
        [
            a[1][0] * c4 - a[1][1] * c2 + a[1][3] * c0,
            -a[0][0] * c4 + a[0][1] * c2 - a[0][3] * c0,
            a[3][0] * s4 - a[3][1] * s2 + a[3][3] * s0,
            -a[2][0] * s4 + a[2][1] * s2 - a[2][3] * s0,
        ],
        [
            -a[1][0] * c3 + a[1][1] * c1 - a[1][2] * c0,
            a[0][0] * c3 - a[0][1] * c1 + a[0][2] * c0,
            -a[3][0] * s3 + a[3][1] * s1 - a[3][2] * s0,
            a[2][0] * s3 - a[2][1] * s1 + a[2][2] * s0,
        ],
    ]
    return jnp.stack([jnp.stack(r) for r in b]) * inv_det


def frustum_corners_world(cam_pv: Array) -> Array:
    """(8, 3) world-space corners of the camera frustum: inv(cam_pv)
    applied to the 8 clip-space corners (x, y = +-1, z in {0, 1} — RH_ZO
    like maths.perspective_rh_zo)."""
    ndc = aabb_corners(
        jnp.asarray([-1.0, -1.0, 0.0]), jnp.asarray([1.0, 1.0, 1.0])
    )  # (8, 3)
    clip = jnp.concatenate([ndc, jnp.ones((8, 1), jnp.float32)], axis=1)
    # precision=HIGHEST everywhere in this module: an f32 contraction may
    # otherwise run at reduced precision (TF32 on the GPU), and the
    # near/far-conditioned inverse has entries spanning ~5 orders of
    # magnitude — reduced-precision corners land far off.
    h = jnp.einsum(
        "nk,mk->nm", clip, _inv4(cam_pv.astype(jnp.float32)), precision=_prec()
    )  # (8, 4)
    return h[:, :3] / h[:, 3:4]


def frustum_planes(cam_pv: Array) -> Array:
    """(6, 4) half-space functionals: f_i(p) = planes[i] . [p, 1] >= 0
    <=> p inside the frustum (clip conditions -w<=x<=w, -w<=y<=w,
    0<=z<=w)."""
    m = cam_pv.astype(jnp.float32)
    return jnp.stack(
        [m[3] - m[0], m[3] + m[0], m[3] - m[1], m[3] + m[1], m[2], m[3] - m[2]]
    )


def _clip_segments(pa: Array, pb: Array, planes: Array, eps: Array):
    """Clip segments pa->pb ((E, 3) each) against intersection of
    half-spaces ((K, 4)). Returns (points (2E, 3), valid (2E,))."""
    ha = jnp.concatenate([pa, jnp.ones_like(pa[:, :1])], axis=1)  # (E, 4)
    hb = jnp.concatenate([pb, jnp.ones_like(pb[:, :1])], axis=1)
    fa = jnp.einsum("nk,mk->nm", ha, planes, precision=_prec())  # (E, K)
    fb = jnp.einsum("nk,mk->nm", hb, planes, precision=_prec())
    d = fb - fa
    # f(t) = fa + t d >= -eps  ->  bound on t per plane.
    t_at = (-eps - fa) / jnp.where(d == 0, 1.0, d)
    lo = jnp.where(d > 0, t_at, 0.0)  # entering planes raise t0
    hi = jnp.where(d < 0, t_at, 1.0)  # exiting planes lower t1
    # Parallel-and-outside: d == 0 with fa < -eps kills the segment.
    dead = jnp.any((d == 0) & (fa < -eps), axis=1)
    # Validity on the UNCLIPPED interval: clipping first would collapse an
    # interval entirely outside [0, 1] (e.g. [5, 7]) onto the endpoint and
    # wrongly admit it.
    t0u = jnp.max(lo, axis=1)
    t1u = jnp.min(hi, axis=1)
    ok = (t0u <= t1u) & (t0u <= 1.0) & (t1u >= 0.0) & ~dead
    t0 = jnp.clip(t0u, 0.0, 1.0)
    t1 = jnp.clip(t1u, 0.0, 1.0)
    p0 = pa + t0[:, None] * (pb - pa)
    p1 = pa + t1[:, None] * (pb - pa)
    return jnp.concatenate([p0, p1]), jnp.concatenate([ok, ok])


def intersection_points(cam_pv: Array, aabb_lo: Array, aabb_hi: Array):
    """Candidate vertices of frustum ∩ AABB: ((N, 3) points, (N,) valid).

    The valid points' hull CONTAINS the true intersection (inside tests
    use epsilon slack, which can only admit extra points)."""
    fr = frustum_corners_world(cam_pv)  # (8, 3)
    bx = aabb_corners(aabb_lo, aabb_hi)  # (8, 3)
    planes = frustum_planes(cam_pv)  # (6, 4)
    scale = jnp.maximum(jnp.max(jnp.abs(fr)), jnp.max(jnp.abs(bx)))
    eps = 1e-4 * (1.0 + scale)

    # Frustum corners inside the (slightly grown) AABB.
    in_box = jnp.all((fr >= aabb_lo - eps) & (fr <= aabb_hi + eps), axis=1)
    # AABB corners inside the frustum. Functional scale ~ w, not world
    # units; slack via the homogeneous coordinate is fine (loose is safe).
    hb = jnp.concatenate([bx, jnp.ones((8, 1), jnp.float32)], axis=1)
    fvals = jnp.einsum("nk,mk->nm", hb, planes, precision=_prec())  # (8, 6)
    in_fr = jnp.all(fvals >= -eps * (1.0 + jnp.abs(hb[:, 3:4])), axis=1)

    # AABB as 6 half-spaces for clipping frustum edges.
    eye = jnp.eye(3, dtype=jnp.float32)
    box_planes = jnp.concatenate(
        [
            jnp.concatenate([eye, -aabb_lo[:, None]], axis=1),  # p - lo >= 0
            jnp.concatenate([-eye, aabb_hi[:, None]], axis=1),  # hi - p >= 0
        ]
    )  # (6, 4)

    ea = jnp.asarray([a for a, _ in _CUBE_EDGES])
    eb = jnp.asarray([b for _, b in _CUBE_EDGES])
    fe_pts, fe_ok = _clip_segments(fr[ea], fr[eb], box_planes, eps)
    be_pts, be_ok = _clip_segments(bx[ea], bx[eb], planes, eps)

    pts = jnp.concatenate([fr, bx, fe_pts, be_pts])  # (8+8+24+24, 3)
    ok = jnp.concatenate([in_box, in_fr, fe_ok, be_ok])
    return pts, ok


def shadow_cull_rect(
    cam_pv: Array,
    sun_pv: Array,
    aabb_lo: Array,
    aabb_hi: Array,
    shadow_size: int,
    tile_h: int,
    tile_w: int,
    margin_texels: float | None = None,
):
    """Conservative shadow-map TILE rect (tx0, ty0, tx1, ty1) that covers
    every texel the PCF window of any shaded pixel can read.

    Inclusive tile coords; an empty intersection yields tx0 > tx1 (all
    tiles culled — nothing on screen samples the map). margin_texels
    defaults to the PCF reach (0.0002 UV x size) + bilinear + slack for
    the f32 corner math.
    """
    if margin_texels is None:
        margin_texels = 0.0002 * shadow_size + 8.0
    pts, ok = intersection_points(cam_pv, aabb_lo, aabb_hi)
    h = jnp.concatenate([pts, jnp.ones((pts.shape[0], 1), jnp.float32)], axis=1)
    lc = jnp.einsum("ij,nj->ni", sun_pv.astype(jnp.float32), h, precision=_prec())
    # Sun is orthographic: w == 1. Raster/PCF pixel transform
    # (raster.setup_screen_triangles / shadow.py:795): px = (x*0.5+0.5)*S,
    # py = (1 - (y*0.5+0.5))*S.
    s = jnp.float32(shadow_size)
    px = (lc[:, 0] * 0.5 + 0.5) * s
    py = (1.0 - (lc[:, 1] * 0.5 + 0.5)) * s
    big = jnp.float32(4 * shadow_size + 4096)
    px_lo = jnp.min(jnp.where(ok, px, big)) - margin_texels
    px_hi = jnp.max(jnp.where(ok, px, -big)) + margin_texels
    py_lo = jnp.min(jnp.where(ok, py, big)) - margin_texels
    py_hi = jnp.max(jnp.where(ok, py, -big)) + margin_texels
    tiles_x = -(-shadow_size // tile_w)
    tiles_y = -(-shadow_size // tile_h)
    tx0 = jnp.clip(jnp.floor(px_lo / tile_w).astype(jnp.int32), 0, tiles_x - 1)
    tx1 = jnp.clip(jnp.floor(px_hi / tile_w).astype(jnp.int32), -1, tiles_x - 1)
    ty0 = jnp.clip(jnp.floor(py_lo / tile_h).astype(jnp.int32), 0, tiles_y - 1)
    ty1 = jnp.clip(jnp.floor(py_hi / tile_h).astype(jnp.int32), -1, tiles_y - 1)
    # WRAP addressing (forward.hlsl sampler, PARITY quirk): a PCF window
    # whose footprint crosses a map edge reads texels wrapped from the
    # OPPOSITE edge (shadow.py pads 2 texels, mode="wrap"). A consumed
    # window crosses the bottom edge only when its pixel projects to
    # py >= s - 1.5 (start_y >= s - 1, padded rows >= s + 2 = orig rows
    # 0..1) — our margined bound crossing s - 2 is strictly looser. Keep
    # the opposite edge's tile row/col in that case (extension only GROWS
    # the kept set; exactness needs every consumed texel kept).
    ty0 = jnp.where(py_hi >= s - 2.0, jnp.int32(0), ty0)
    ty1 = jnp.where(py_lo <= 2.0, jnp.int32(tiles_y - 1), ty1)
    tx0 = jnp.where(px_hi >= s - 2.0, jnp.int32(0), tx0)
    tx1 = jnp.where(px_lo <= 2.0, jnp.int32(tiles_x - 1), tx1)
    any_ok = jnp.any(ok)
    tx1 = jnp.where(any_ok & (px_hi >= px_lo), tx1, -1)
    ty1 = jnp.where(any_ok & (py_hi >= py_lo), ty1, -1)
    return tx0, ty0, tx1, ty1
