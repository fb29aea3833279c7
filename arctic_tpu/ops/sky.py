"""Equirectangular environment sampling — shaders/skybox.hlsl as dataflow.

The reference draws a 36-vertex cube with depth pinned to the far plane
(pos.xyww, skybox.hlsl:68) after the forward pass with LESS_EQUAL so only
background pixels survive (skybox_pass.cpp:87-89).  The cube's interpolated
object-space position *is* the world-space view direction, so we skip
the cube entirely: compute each pixel's camera ray analytically and sample the
environment where the visibility buffer is empty — pixel-exact equivalent.

sample_environment matches skybox.hlsl:74-85 including the quirky
``uv.y = -uv.y`` (sign differs from the dead helper in forward.hlsl:195-206)
which relies on WRAP addressing to land in range.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from arctic_tpu.core import maths
from arctic_tpu.ops.sampling import sample_bilinear_wrap

Array = jnp.ndarray

INV_ATAN = (0.1591, 0.3183)  # skybox.hlsl:45, kept verbatim


def sample_environment(env, direction: Array) -> Array:
    """skybox.hlsl:74-85: equirect lookup along (..., 3) directions.

    ``env`` is either a raw (H, W, 3) array (simple path) or a
    core.scene.Environment whose quad-packed atlas makes the bilinear tap a
    single gather."""
    d = maths.normalize(direction)
    u = jnp.arctan2(d[..., 2], d[..., 0]) * INV_ATAN[0] + 0.5
    v = jnp.arcsin(jnp.clip(d[..., 1], -1.0, 1.0)) * INV_ATAN[1] + 0.5
    v = -v  # skybox.hlsl:83
    uv = jnp.stack([u, v], axis=-1)
    atlas = getattr(env, "atlas", None)
    if atlas is not None:
        reg = atlas.regions[0, 0]
        if atlas.quads_packed is not None:
            # Same (bf16) table as the fused path so both pipelines produce
            # identical sky pixels.
            from arctic_tpu.ops.sampling import sample_quads_packed

            return sample_quads_packed(
                atlas.quads_packed, atlas.block_grid,
                reg[0], reg[1], reg[2], reg[3], uv[..., 0], uv[..., 1],
            )[..., :3]
        from arctic_tpu.ops.sampling import sample_atlas

        return sample_atlas(atlas, reg, uv)[..., :3]
    data = getattr(env, "data", env)
    return sample_bilinear_wrap(data, uv)


def sample_environment_cf(env, dx: Array, dy: Array, dz: Array):
    """Channel-first sample_environment: ray components as same-shaped
    arrays, returns (r, g, b) channel arrays. Keeps the pixel dim minor for
    the fused tile-major path (no (..., 3) small-minor intermediates)."""
    norm = jnp.sqrt(dx * dx + dy * dy + dz * dz)
    nx, ny, nz = dx / norm, dy / norm, dz / norm
    u = jnp.arctan2(nz, nx) * INV_ATAN[0] + 0.5
    v = jnp.arcsin(jnp.clip(ny, -1.0, 1.0)) * INV_ATAN[1] + 0.5
    v = -v  # skybox.hlsl:83
    atlas = getattr(env, "atlas", None)
    if atlas is not None:
        reg = atlas.regions[0, 0]
        if atlas.quads_packed is not None:
            from arctic_tpu.ops.sampling import sample_quads_packed

            out = sample_quads_packed(
                atlas.quads_packed, atlas.block_grid,
                reg[0], reg[1], reg[2], reg[3], u, v,
            )
        else:
            from arctic_tpu.ops.sampling import sample_quads_flat

            out = sample_quads_flat(
                atlas.quads, atlas.block_grid, reg[0], reg[1], reg[2], reg[3], u, v
            )
        return out[..., 0], out[..., 1], out[..., 2]
    data = getattr(env, "data", env)
    out = sample_bilinear_wrap(data, jnp.stack([u, v], axis=-1))
    return out[..., 0], out[..., 1], out[..., 2]


def camera_ray_dirs_cf(camera, px: Array, py: Array, width: int, height: int):
    """Channel-first camera_ray_directions_at: returns (dx, dy, dz) arrays."""
    x_ndc = px / width * 2.0 - 1.0
    y_ndc = 1.0 - py / height * 2.0
    t = jnp.tan(jnp.radians(camera.fov_y) * 0.5)
    dvx = x_ndc * camera.aspect * t
    dvy = y_ndc * t
    view = maths.camera_view_matrix(camera.eye, camera.rotation)
    rot = view[:3, :3]  # rows: right, up, -forward; world dir_i = sum_j rot[j,i] dv_j
    return tuple(rot[0, i] * dvx + rot[1, i] * dvy - rot[2, i] for i in range(3))


def camera_ray_directions_at(camera, px: Array, py: Array, width: int, height: int) -> Array:
    """World-space view rays at arbitrary pixel-center coordinate arrays.

    px/py are pixel-CENTER coords (x + 0.5); shapes broadcast, result is
    (..., 3). Used by the tile-major fused path where pixels aren't a dense
    (H, W) grid.
    """
    x_ndc = px / width * 2.0 - 1.0
    y_ndc = 1.0 - py / height * 2.0
    t = jnp.tan(jnp.radians(camera.fov_y) * 0.5)
    x_ndc, y_ndc = jnp.broadcast_arrays(x_ndc, y_ndc)
    dir_view = jnp.stack(
        [x_ndc * camera.aspect * t, y_ndc * t, -jnp.ones_like(x_ndc)], axis=-1
    )
    view = maths.camera_view_matrix(camera.eye, camera.rotation)
    rot = view[:3, :3]  # rows: right, up, -forward
    return jnp.einsum("ji,...j->...i", rot, dir_view, precision=jax.lax.Precision.HIGHEST)


def camera_ray_directions(camera, height: int, width: int, row0=0.0, rows=None) -> Array:
    """World-space view ray per pixel center, (rows, W, 3).

    Equivalent to rasterizing the reference's skybox cube: a cube vertex v
    satisfies clip = proj_view_no_translation @ v, so the direction that
    projects onto a pixel is R^T @ [x_ndc * aspect * tan(fov/2),
    y_ndc * tan(fov/2), -1] with R the camera rotation.

    ``height`` is the full viewport height; ``row0``/``rows`` select a
    horizontal slice for sharded rendering (row0 may be traced).
    """
    if rows is None:
        rows = height
    xs = (jnp.arange(width, dtype=jnp.float32) + 0.5) / width * 2.0 - 1.0
    ys = 1.0 - (row0 + jnp.arange(rows, dtype=jnp.float32) + 0.5) / height * 2.0
    x_ndc, y_ndc = jnp.meshgrid(xs, ys, indexing="xy")
    t = jnp.tan(jnp.radians(camera.fov_y) * 0.5)
    dir_view = jnp.stack(
        [x_ndc * camera.aspect * t, y_ndc * t, -jnp.ones_like(x_ndc)], axis=-1
    )
    view = maths.camera_view_matrix(camera.eye, camera.rotation)
    rot = view[:3, :3]  # rows: right, up, -forward
    return jnp.einsum("ji,hwj->hwi", rot, dir_view, precision=jax.lax.Precision.HIGHEST)


def env_uv_cf(dx: Array, dy: Array, dz: Array):
    """Equirect (u, v) of channel-first ray components (skybox.hlsl:74-85,
    incl. the uv.y negation) — the index half of sample_environment_cf, for
    callers that perform the quad gather themselves (merged taps)."""
    norm = jnp.sqrt(dx * dx + dy * dy + dz * dz)
    nx, ny, nz = dx / norm, dy / norm, dz / norm
    u = jnp.arctan2(nz, nx) * INV_ATAN[0] + 0.5
    v = jnp.arcsin(jnp.clip(ny, -1.0, 1.0)) * INV_ATAN[1] + 0.5
    return u, -v  # skybox.hlsl:83


def sample_environment_ibl(env, direction: Array) -> Array:
    """Equirect sample per forward.hlsl:195-206 — the reference's DEAD IBL
    helper: identical to the skybox lookup but WITHOUT the uv.y negation.
    Used only by the opt-in IBL-specular term (config.ibl_specular)."""
    d = maths.normalize(direction)
    u = jnp.arctan2(d[..., 2], d[..., 0]) * INV_ATAN[0] + 0.5
    v = jnp.arcsin(jnp.clip(d[..., 1], -1.0, 1.0)) * INV_ATAN[1] + 0.5
    atlas = getattr(env, "atlas", None)
    if atlas is not None and atlas.quads_packed is not None:
        from arctic_tpu.ops.sampling import sample_quads_packed

        reg = atlas.regions[0, 0]
        return sample_quads_packed(
            atlas.quads_packed, atlas.block_grid,
            reg[0], reg[1], reg[2], reg[3], u, v,
        )[..., :3]
    data = getattr(env, "data", env)
    return sample_bilinear_wrap(data, jnp.stack([u, v], axis=-1))[..., :3]


def sample_environment_ibl_cf(env, dx: Array, dy: Array, dz: Array):
    """Channel-first sample_environment_ibl: returns (r, g, b) planes."""
    norm = jnp.sqrt(dx * dx + dy * dy + dz * dz)
    nx, ny, nz = dx / norm, dy / norm, dz / norm
    u = jnp.arctan2(nz, nx) * INV_ATAN[0] + 0.5
    v = jnp.arcsin(jnp.clip(ny, -1.0, 1.0)) * INV_ATAN[1] + 0.5
    atlas = getattr(env, "atlas", None)
    if atlas is not None and atlas.quads_packed is not None:
        from arctic_tpu.ops.sampling import sample_quads_packed

        reg = atlas.regions[0, 0]
        out = sample_quads_packed(
            atlas.quads_packed, atlas.block_grid,
            reg[0], reg[1], reg[2], reg[3], u, v,
        )
        return out[..., 0], out[..., 1], out[..., 2]
    data = getattr(env, "data", env)
    out = sample_bilinear_wrap(data, jnp.stack([u, v], axis=-1))
    return out[..., 0], out[..., 1], out[..., 2]
