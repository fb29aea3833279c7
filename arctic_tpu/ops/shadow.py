"""Shadow-map PCF — exact reproduction of calculate_shadow (forward.hlsl:68-96).

Quirks preserved deliberately (they are visible in the reference's output):
- bias is 0 (forward.hlsl:81: the commented-out slope bias is NOT used)
- PCF taps at fixed +-2 * 0.0001 *UV* offsets regardless of map size
  (forward.hlsl:88), i.e. 0.4 texels apart on the 4000^2 map
- each tap is a *bilinear* fetch of the depth map through the linear-wrap
  sampler (SampleLevel with s_sampler, forward.hlsl:89) — depth values are
  filtered before comparison
- points outside the light frustum (z > 1 or uv outside [0,1]) return 0 (lit)
- taps near the border can wrap to the opposite edge (WRAP addressing)

Formulation: the 25 taps span +-0.8 texels + 1 texel bilinear support, so
all taps read from one 4x4 texel window per pixel — the window is gathered
once (four 4-texel runs) and every bilinear tap is evaluated arithmetically,
equivalent to 25 independent SampleLevel calls.
"""

from __future__ import annotations

import jax.numpy as jnp

Array = jnp.ndarray

PCF_UV_STEP = 0.0001  # forward.hlsl:88


def pcf_shadow(shadow_map: Array, light_space_pos: Array) -> Array:
    """Fraction of occluded PCF taps in [0, 1] per pixel.

    shadow_map: (S, S) f32 depth from the sun pass (cleared to 1.0).
    light_space_pos: (..., 4) clip-space position under the sun's proj_view.
    """
    w = light_space_pos[..., 3]
    proj = light_space_pos[..., :3] / w[..., None]
    return pcf_shadow_proj(shadow_map, proj[..., 0], proj[..., 1], proj[..., 2])


def pcf_shadow_proj(shadow_map: Array, x: Array, y: Array, z: Array) -> Array:
    """pcf_shadow on already-divided NDC components (channel-first callers
    pass the three planes directly; the sun is orthographic so the fused
    path's interpolated xyz needs no divide)."""
    s = shadow_map.shape[0]
    assert shadow_map.shape == (s, s)
    u = x * 0.5 + 0.5
    v = 1.0 - (y * 0.5 + 0.5)
    outside = (z > 1.0) | (u < 0.0) | (v < 0.0) | (u > 1.0) | (v > 1.0)

    # Texel-space center tap (D3D: t = uv * size - 0.5).
    tx = u * s - 0.5
    ty = v * s - 0.5
    step = PCF_UV_STEP * s  # texels between adjacent taps

    # 4x4 window that contains all 25 bilinear taps (valid while step <= 0.5).
    # The map is padded by 2 wrapped texels per side so the window is
    # contiguous with exact WRAP semantics.
    wx = jnp.floor(tx).astype(jnp.int32) - 1
    wy = jnp.floor(ty).astype(jnp.int32) - 1
    start_y = jnp.clip(wy + 2, 0, s)  # padded-coords window origin
    start_x = jnp.clip(wx + 2, 0, s)

    # Runs table: for each (row class, x phase) a dense (yq, xq, 4) array of
    # 4-texel runs, so each window row is ONE 16-byte row gather.
    padded = jnp.pad(shadow_map, 2, mode="wrap")
    sp = s + 4
    yq = (sp + 3 + 3) // 4
    xq = (sp + 3 + 3) // 4
    padded2 = jnp.pad(padded, ((0, yq * 4 - sp), (0, xq * 4 + 3 - sp)))
    classes = []
    for kcl in range(4):
        for sx in range(4):
            classes.append(padded2[kcl::4, sx : sx + 4 * xq].reshape(yq, xq, 4))
    runs = jnp.stack(classes).reshape(16 * yq * xq, 4)
    sx_c = start_x % 4
    qx = start_x // 4
    yrow = start_y[..., None] + jnp.arange(4)  # (..., 4) window rows
    idx = (((yrow % 4) * 4 + sx_c[..., None]) * yq + yrow // 4) * xq + qx[..., None]
    window = runs[idx].reshape(start_y.shape + (16,))  # (..., 16) flat
    rows = [
        tuple(window[..., 4 * r + c] for c in range(4)) for r in range(4)
    ]

    lx = tx - wx.astype(jnp.float32)  # local coords in the window, in [1, 2)
    ly = ty - wy.astype(jnp.float32)

    # Window rows/cols are selected with exact 3-way selects (tap texel
    # indices can only be 0..2 while |offset| <= 0.8 texels + bilinear),
    # keeping the lerp arithmetic bit-identical to SampleLevel and avoiding
    # data-dependent gathers entirely. Rows are tuples of 4 texel planes.
    def sel3(i, a, b, c):
        return tuple(
            jnp.where(i == 0, pa, jnp.where(i == 1, pb, pc))
            for pa, pb, pc in zip(a, b, c)
        )

    def col(row4, i, off):
        return jnp.where(
            i == 0, row4[0 + off], jnp.where(i == 1, row4[1 + off], row4[2 + off])
        )

    shadow = jnp.zeros_like(tx)
    for j in range(-2, 3):  # y offset
        sy = ly + j * step
        iy = jnp.floor(sy).astype(jnp.int32)
        fy = sy - iy
        row0 = sel3(iy, rows[0], rows[1], rows[2])
        row1 = sel3(iy, rows[1], rows[2], rows[3])
        for i in range(-2, 3):  # x offset
            sx = lx + i * step
            ix = jnp.floor(sx).astype(jnp.int32)
            fx = sx - ix
            c00 = col(row0, ix, 0)
            c10 = col(row0, ix, 1)
            c01 = col(row1, ix, 0)
            c11 = col(row1, ix, 1)
            top = c00 + (c10 - c00) * fx
            bot = c01 + (c11 - c01) * fx
            closest = top + (bot - top) * fy
            shadow = shadow + jnp.where(z > closest, 1.0, 0.0)
    shadow = shadow / 25.0
    shadow = jnp.where(outside, 0.0, shadow)
    return shadow
