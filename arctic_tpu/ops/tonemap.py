"""Tonemapping + gamma — exact jnp translation of shaders/post_process.hlsl.

The reference runs this as a 16x16-thread compute pass over the HDR target
(post_process_pass.cpp:76-95); here it is plain elementwise jnp that XLA
fuses into the end of the frame program — there is nothing to hand-schedule.

- tm_reinhard      post_process.hlsl:39-42   c / (c + 1)
- tm_exposure      post_process.hlsl:44-47   1 - exp(-c * e)
- tm_aces          post_process.hlsl:15-32,50-57 (Hill/self_shadow fit),
                   constants copied digit-for-digit including the truncated
                   0.837 / 1.07 entries
- correct_gamma    post_process.hlsl:34-37   pow(abs(c), 1/gamma)
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

Array = jnp.ndarray

# post_process.hlsl:15-19 — HLSL float3x3(...) is row-major initialized, and
# mul(M, v) treats v as a column vector, so these apply as out = M @ c.
ACES_INPUT_MAT = jnp.array(
    [
        [0.59719, 0.35458, 0.04823],
        [0.07600, 0.90834, 0.01566],
        [0.02840, 0.13383, 0.837],
    ],
    jnp.float32,
)

# post_process.hlsl:21-25
# f32 contractions without a precision may run in TF32 on the GPU.
_HI = jax.lax.Precision.HIGHEST

ACES_OUTPUT_MAT = jnp.array(
    [
        [1.60475, -0.53108, -0.07367],
        [-0.10208, 1.10813, -0.00605],
        [-0.00327, -0.07276, 1.07],
    ],
    jnp.float32,
)


def tm_reinhard(color: Array, _settings=None) -> Array:
    return color / (color + 1.0)


def tm_exposure(color: Array, exposure: Array) -> Array:
    return 1.0 - jnp.exp(-color * exposure)


def _rrt_and_odt_fit(color: Array) -> Array:
    a = color * (color + 0.0245786) - 0.000090537
    b = color * (0.983729 * color + 0.4329510) + 0.238081
    return a / b


def tm_aces(color: Array, channel_axis: int = -1) -> Array:
    if channel_axis == -1:
        c = jnp.einsum("ij,...j->...i", ACES_INPUT_MAT, color, precision=_HI)
        c = _rrt_and_odt_fit(c)
        c = jnp.einsum("ij,...j->...i", ACES_OUTPUT_MAT, c, precision=_HI)
    elif channel_axis == 0:  # channel-leading (3, ...): pixel dims minor
        c = jnp.einsum("ij,j...->i...", ACES_INPUT_MAT, color, precision=_HI)
        c = _rrt_and_odt_fit(c)
        c = jnp.einsum("ij,j...->i...", ACES_OUTPUT_MAT, c, precision=_HI)
    else:  # channel-first (..., 3, S): pixel dim stays minor
        c = jnp.einsum("ij,...js->...is", ACES_INPUT_MAT, color, precision=_HI)
        c = _rrt_and_odt_fit(c)
        c = jnp.einsum("ij,...js->...is", ACES_OUTPUT_MAT, c, precision=_HI)
    return jnp.clip(c, 0.0, 1.0)  # saturate


def correct_gamma(color: Array, gamma: Array) -> Array:
    return jnp.abs(color) ** (1.0 / gamma)


def tonemap(
    color: Array, tm_method: Array, gamma: Array, exposure: Array,
    channel_axis: int = -1,
) -> Array:
    """Full post-process chain (post_process.hlsl:74-92).

    tm_method is a traced int32 so one compiled frame program serves all
    three operators (the reference keeps one PSO with a CB switch). All
    three maps are computed and selected per pixel instead of lax.switch:
    a conditional is a fusion barrier (the chosen branch round-trips the
    HDR buffer through device memory), while the select fuses into the
    shade/post tail; the extra operators are a handful of elementwise ops
    on data already in registers. The selected
    values are the branches' exact outputs — bit-identical per method.
    """
    m = jnp.clip(tm_method, 0, 2)
    mapped = jnp.where(
        m == 0,
        tm_reinhard(color),
        jnp.where(m == 1, tm_exposure(color, exposure), tm_aces(color, channel_axis)),
    )
    return correct_gamma(mapped, gamma)


def to_unorm8(color: Array) -> Array:
    """Store to R8G8B8A8_UNORM: clamp then round-to-nearest (D3D conversion)."""
    return jnp.round(jnp.clip(color, 0.0, 1.0) * 255.0).astype(jnp.uint8)
