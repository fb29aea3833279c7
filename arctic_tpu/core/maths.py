"""Camera / light matrix math matching the reference's GLM conventions.

The reference (src/renderer/scene.cpp) uses GLM with
``GLM_FORCE_DEPTH_ZERO_TO_ONE`` (CMakeLists.txt:150), i.e. right-handed view
space and clip-space depth in [0, 1] (D3D convention).  All functions here are
pure jnp, safe to call inside ``jax.jit`` with traced scalars, and produce
matrices that act on *column* vectors: ``clip = P @ V @ M @ [x y z 1]^T``.

Reference symbols reproduced:
- ``dir_from_rot``                      scene.cpp:9-19
- ``Camera::proj_view_matrix``          scene.cpp:41-54
- ``Camera::proj_view_matrix_no_translation`` scene.cpp:26-39
- ``DirectionalLight::proj_view_matrix`` scene.cpp:61-70 (orthoRH -16..16, 0.1..50)
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

Array = jnp.ndarray


def mat4_mul(a: Array, b: Array) -> Array:
    """4x4 (or batched) matrix product in full f32.

    Without a precision an f32 matmul may run in TF32 on the GPU;
    transform matrices need full f32 (the reference computes these on the
    CPU in f32).
    """
    return jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST)

WORLD_UP = (0.0, 1.0, 0.0)  # Camera::up(), scene.hpp:30-33


def normalize(v: Array, eps: float = 0.0) -> Array:
    """Unit-length vector along the last axis (GLM normalize: no eps guard)."""
    n = jnp.linalg.norm(v, axis=-1, keepdims=True)
    if eps:
        n = jnp.maximum(n, eps)
    return v / n


def dir_from_rot(rotation_deg: Array) -> Array:
    """Spherical (pitch, yaw) Euler degrees -> unit direction.

    Matches scene.cpp:9-19: ``(cos(x)cos(y), sin(x), cos(x)sin(y))`` with
    x = rotation[0] (pitch), y = rotation[1] (yaw), both in degrees.
    """
    rotation_deg = jnp.asarray(rotation_deg, jnp.float32)
    x = jnp.radians(rotation_deg[..., 0])
    y = jnp.radians(rotation_deg[..., 1])
    return jnp.stack(
        [jnp.cos(x) * jnp.cos(y), jnp.sin(x), jnp.cos(x) * jnp.sin(y)], axis=-1
    )


def look_at_rh(eye: Array, center: Array, up: Array) -> Array:
    """glm::lookAtRH — right-handed view matrix (camera looks down -Z)."""
    eye = jnp.asarray(eye, jnp.float32)
    f = normalize(jnp.asarray(center, jnp.float32) - eye)
    s = normalize(jnp.cross(f, jnp.asarray(up, jnp.float32)))
    u = jnp.cross(s, f)
    rot = jnp.stack([s, u, -f], axis=0)  # (3,3) rows: right, up, -forward
    hi = jax.lax.Precision.HIGHEST
    trans = jnp.stack([
        -jnp.dot(s, eye, precision=hi),
        -jnp.dot(u, eye, precision=hi),
        jnp.dot(f, eye, precision=hi),
    ])
    m = jnp.zeros((4, 4), jnp.float32)
    m = m.at[:3, :3].set(rot)
    m = m.at[:3, 3].set(trans)
    return m.at[3, 3].set(1.0)


def perspective_rh_zo(fov_y_rad: Array, aspect: Array, z_near: Array, z_far: Array) -> Array:
    """glm::perspectiveRH_ZO — RH perspective, clip z in [0, 1]."""
    t = jnp.tan(jnp.asarray(fov_y_rad, jnp.float32) * 0.5)
    m = jnp.zeros((4, 4), jnp.float32)
    m = m.at[0, 0].set(1.0 / (aspect * t))
    m = m.at[1, 1].set(1.0 / t)
    m = m.at[2, 2].set(z_far / (z_near - z_far))
    m = m.at[2, 3].set(-(z_far * z_near) / (z_far - z_near))
    return m.at[3, 2].set(-1.0)


def ortho_rh_zo(left, right, bottom, top, z_near, z_far) -> Array:
    """glm::orthoRH_ZO — RH orthographic, clip z in [0, 1]."""
    m = jnp.zeros((4, 4), jnp.float32)
    m = m.at[0, 0].set(2.0 / (right - left))
    m = m.at[1, 1].set(2.0 / (top - bottom))
    m = m.at[2, 2].set(-1.0 / (z_far - z_near))
    m = m.at[0, 3].set(-(right + left) / (right - left))
    m = m.at[1, 3].set(-(top + bottom) / (top - bottom))
    m = m.at[2, 3].set(-z_near / (z_far - z_near))
    return m.at[3, 3].set(1.0)


def view_rotation_only(view: Array) -> Array:
    """mat4(mat3(view)) — drop the translation column (scene.cpp:31)."""
    m = jnp.zeros((4, 4), jnp.float32).at[:3, :3].set(view[:3, :3])
    return m.at[3, 3].set(1.0)


def camera_view_matrix(eye: Array, rotation_deg: Array) -> Array:
    fwd = dir_from_rot(rotation_deg)
    return look_at_rh(eye, jnp.asarray(eye, jnp.float32) + fwd, jnp.array(WORLD_UP))


def camera_proj_view(
    eye: Array, rotation_deg: Array, aspect, fov_y_deg, z_near, z_far
) -> Array:
    """Camera::proj_view_matrix (scene.cpp:41-54)."""
    view = camera_view_matrix(eye, rotation_deg)
    proj = perspective_rh_zo(jnp.radians(jnp.float32(fov_y_deg)), aspect, z_near, z_far)
    return mat4_mul(proj, view)


def camera_proj_view_no_translation(
    eye: Array, rotation_deg: Array, aspect, fov_y_deg, z_near, z_far
) -> Array:
    """Camera::proj_view_matrix_no_translation (scene.cpp:26-39), for the skybox."""
    view = view_rotation_only(camera_view_matrix(eye, rotation_deg))
    proj = perspective_rh_zo(jnp.radians(jnp.float32(fov_y_deg)), aspect, z_near, z_far)
    return mat4_mul(proj, view)


# DirectionalLight::proj_view_matrix ortho bounds (scene.cpp:68).
SUN_ORTHO = (-16.0, 16.0, -16.0, 16.0, 0.1, 50.0)


def sun_proj_view(position: Array, rotation_deg: Array) -> Array:
    """DirectionalLight::proj_view_matrix (scene.cpp:61-70)."""
    fwd = dir_from_rot(rotation_deg)
    view = look_at_rh(position, jnp.asarray(position, jnp.float32) + fwd, jnp.array(WORLD_UP))
    return mat4_mul(ortho_rh_zo(*SUN_ORTHO), view)


def trs_compose(translation: Array, rotation_quat_wxyz: Array, scale: Array) -> Array:
    """Column-major TRS = T * R * S from glTF node transform components."""
    w, x, y, z = (rotation_quat_wxyz[i] for i in range(4))
    r = jnp.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ],
        jnp.float32,
    )
    m = jnp.zeros((4, 4), jnp.float32)
    m = m.at[:3, :3].set(r * jnp.asarray(scale, jnp.float32)[None, :])
    m = m.at[:3, 3].set(jnp.asarray(translation, jnp.float32))
    return m.at[3, 3].set(1.0)
