"""Cook-Torrance GGX BRDF — exact jnp translation of shaders/forward.hlsl.

Every function mirrors its HLSL namesake line-for-line in math (not code):
- fresnel_schlick            forward.hlsl:126-129
- distribution_ggx           forward.hlsl:131-143 (alpha = roughness^2)
- geometry_schlick_ggx       forward.hlsl:145-154 (k = (r+1)^2 / 8)
- geometry_smith             forward.hlsl:156-163
- brdf_cook_torrance         forward.hlsl:165-175 (denom + 1e-4)
- outgoing_radiance          forward.hlsl:177-193 (kD = (1-F)(1-metalness))

All inputs broadcast over leading pixel dims; vectors are (..., 3).
"""

from __future__ import annotations

import jax.numpy as jnp

Array = jnp.ndarray

PI = 3.14159265  # forward.hlsl:1 — note: the shader's 9-digit PI, kept verbatim


def _dot(a: Array, b: Array) -> Array:
    return jnp.sum(a * b, axis=-1)


def fresnel_schlick(cos_theta: Array, f0: Array) -> Array:
    return f0 + (1.0 - f0) * jnp.clip(1.0 - cos_theta, 0.0, 1.0) ** 5.0


def distribution_ggx(n: Array, h: Array, roughness: Array) -> Array:
    a = roughness * roughness
    a2 = a * a
    n_dot_h = jnp.maximum(_dot(n, h), 0.0)
    denom = n_dot_h * n_dot_h * (a2 - 1.0) + 1.0
    return a2 / (PI * denom * denom)


def geometry_schlick_ggx(n_dot_wo: Array, roughness: Array) -> Array:
    r = roughness + 1.0
    k = (r * r) / 8.0
    return n_dot_wo / (n_dot_wo * (1.0 - k) + k)


def geometry_smith(n: Array, wo: Array, wi: Array, roughness: Array) -> Array:
    n_dot_wo = jnp.maximum(_dot(n, wo), 0.0)
    n_dot_wi = jnp.maximum(_dot(n, wi), 0.0)
    return geometry_schlick_ggx(n_dot_wo, roughness) * geometry_schlick_ggx(
        n_dot_wi, roughness
    )


def brdf_cook_torrance(
    n: Array, h: Array, wo: Array, wi: Array, roughness: Array, fresnel: Array
) -> Array:
    ndf = distribution_ggx(n, h, roughness)
    geo = geometry_smith(n, wo, wi, roughness)
    num = (ndf * geo)[..., None] * fresnel
    denom = 4.0 * jnp.maximum(_dot(n, wo), 0.0) * jnp.maximum(_dot(n, wi), 0.0) + 1e-4
    return num / denom[..., None]


def outgoing_radiance(
    n: Array,
    wo: Array,
    wi: Array,
    ingoing_radiance: Array,
    base_color: Array,
    metalness: Array,
    roughness: Array,
) -> Array:
    """calculate_outgoing_radiance (forward.hlsl:177-193)."""
    h = wo + wi
    h = h / jnp.linalg.norm(h, axis=-1, keepdims=True)
    f0 = jnp.full_like(base_color, 0.04)
    f0 = f0 + (base_color - f0) * metalness[..., None]  # lerp(0.04, albedo, metal)
    fresnel = fresnel_schlick(jnp.maximum(_dot(h, wo), 0.0)[..., None], f0)
    specular = brdf_cook_torrance(n, h, wo, wi, roughness, fresnel)
    k_d = (1.0 - fresnel) * (1.0 - metalness)[..., None]
    n_dot_wi = jnp.maximum(_dot(n, wi), 0.0)
    return (k_d * base_color / PI + specular) * ingoing_radiance * n_dot_wi[..., None]


# ---------------------------------------------------------------------------
# Channel-first variants (vectors (3, T, S), scalars (1, T, S) or broadcast)
# ---------------------------------------------------------------------------
# Same math as above, with the channel axis LEADING so the pixel axes stay
# minor and per-channel planes are contiguous slices; channel-leading
# shapes match the G-buffer's (lanes, R, 128) layout, so the shading chain
# needs no relayout. Used by the fused tile-major shading path
# (pipeline.shade_gbuffer).


def _dot_cf(a: Array, b: Array) -> Array:
    return jnp.sum(a * b, axis=0, keepdims=True)  # (1, ...)


def distribution_ggx_cf(n: Array, h: Array, roughness: Array) -> Array:
    a = roughness * roughness
    a2 = a * a
    n_dot_h = jnp.maximum(_dot_cf(n, h), 0.0)
    denom = n_dot_h * n_dot_h * (a2 - 1.0) + 1.0
    return a2 / (PI * denom * denom)


def geometry_smith_cf(n: Array, wo: Array, wi: Array, roughness: Array) -> Array:
    n_dot_wo = jnp.maximum(_dot_cf(n, wo), 0.0)
    n_dot_wi = jnp.maximum(_dot_cf(n, wi), 0.0)
    return geometry_schlick_ggx(n_dot_wo, roughness) * geometry_schlick_ggx(
        n_dot_wi, roughness
    )


def outgoing_radiance_cf(
    n: Array,
    wo: Array,
    wi: Array,
    ingoing_radiance: Array,
    base_color: Array,
    metalness: Array,
    roughness: Array,
) -> Array:
    """calculate_outgoing_radiance, channel-first: vectors (3, T, S),
    metalness/roughness (1, T, S); returns (3, T, S)."""
    h = wo + wi
    h = h / jnp.sqrt(jnp.sum(h * h, axis=0, keepdims=True))
    f0 = jnp.full_like(base_color, 0.04)
    f0 = f0 + (base_color - f0) * metalness
    fresnel = fresnel_schlick(jnp.maximum(_dot_cf(h, wo), 0.0), f0)
    ndf = distribution_ggx_cf(n, h, roughness)
    geo = geometry_smith_cf(n, wo, wi, roughness)
    num = ndf * geo * fresnel
    denom = (
        4.0 * jnp.maximum(_dot_cf(n, wo), 0.0) * jnp.maximum(_dot_cf(n, wi), 0.0)
        + 1e-4
    )
    specular = num / denom
    k_d = (1.0 - fresnel) * (1.0 - metalness)
    n_dot_wi = jnp.maximum(_dot_cf(n, wi), 0.0)
    return (k_d * base_color / PI + specular) * ingoing_radiance * n_dot_wi
