"""Ray-traced reference mode — the reference's roadmap "Raytracing" item.

Replaces the rasterizer with BVH ray casts (ops/rt.py) while keeping the
material/lighting model of the forward pass: primary rays give visibility
(true barycentrics, no perspective correction needed), one any-hit ray per
pixel toward the sun gives a hard shadow term that — like the raster path's
PCF term (forward.hlsl:222-230) — also scales the point lights.  Misses fall
through to the skybox; the tonemap chain is shared.

This is an offline/verification mode: traversal is lockstep XLA, a few
frames per second at moderate resolutions, not the 60 fps raster path.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from arctic_tpu.core import maths
from arctic_tpu.core.config import RenderConfig
from arctic_tpu.core.scene import MAX_POINT_LIGHTS, SceneBuffers, SceneParams, Settings
from arctic_tpu.models import pipeline
from arctic_tpu.ops import pbr, rt, sky, tonemap
from arctic_tpu.ops.sampling import sample_atlas_multi

Array = jnp.ndarray


def build_scene_bvh(buffers: SceneBuffers) -> rt.BVH:
    """Host-side BVH over the world-space triangles (static TRS baked in;
    rebuild after moving objects)."""
    geom = buffers.geometry
    world = np.asarray(pipeline.vertex_world_positions(geom))
    n = int(geom.num_tris)
    tris = world[np.asarray(geom.indices[:n])]
    return rt.build_bvh(tris)


def render_frame_rt(
    buffers: SceneBuffers,
    bvh: rt.BVH,
    params: SceneParams,
    settings: Settings,
    config: RenderConfig,
) -> Array:
    """Full ray-traced frame -> (H, W, 3) uint8."""
    geom = buffers.geometry
    if buffers.atlas.tiles is not None:
        from arctic_tpu.utils.errors import RenderError

        raise RenderError(
            "ray-traced mode has no tile-atlas sampler yet (reference-scale "
            "texture sets skip the per-slot quad tables); use the raster path"
        )
    h, w = config.height, config.width
    eye = params.camera.eye

    dirs = sky.camera_ray_directions(params.camera, h, w).reshape(-1, 3)
    origins = jnp.broadcast_to(eye, dirs.shape)
    hits = rt.trace(bvh, origins, dirs)
    covered = (hits.tri >= 0).reshape(h, w)
    tri = jnp.maximum(hits.tri, 0).reshape(h, w)
    b = jnp.stack([1.0 - hits.u - hits.v, hits.u, hits.v], axis=1).reshape(h, w, 3)

    world = pipeline.vertex_world_positions(geom)
    nrm = maths.normalize(geom.normals)
    tan = maths.normalize(geom.tangents)
    btn = maths.normalize(geom.bitangents)
    attrs = jnp.concatenate([world, nrm, tan, btn, geom.uvs], axis=1)  # (V, 14)
    av = attrs[geom.indices[tri]]  # (H, W, 3, 14)
    a = jnp.einsum("hwc,hwck->hwk", b, av, precision=jax.lax.Precision.HIGHEST)
    wp, n_v, t_v, b_v, uv = a[..., :3], a[..., 3:6], a[..., 6:9], a[..., 9:12], a[..., 12:14]

    regions = buffers.atlas.regions[geom.tri_material[tri]]  # (H, W, 3, 4)
    tex = sample_atlas_multi(buffers.atlas, regions, uv)  # one batched gather
    base_color = tex[..., 0, :3]
    nm = tex[..., 1, :3]
    mr = tex[..., 2, :]

    nm = nm.at[..., 1].set(1.0 - nm[..., 1])
    nm = nm * 2.0 - 1.0
    n = maths.normalize(t_v * nm[..., 0:1] + b_v * nm[..., 1:2] + n_v * nm[..., 2:3])
    metalness = mr[..., 2]
    roughness = mr[..., 1]

    # Hard shadow: one any-hit ray toward the sun per covered pixel.
    sun_dir = params.sun.direction()
    wi_sun = -sun_dir
    shadow_org = (wp + n * 1e-3).reshape(-1, 3)
    shadow_dirs = jnp.broadcast_to(wi_sun, shadow_org.shape)
    occ = rt.trace(bvh, shadow_org, shadow_dirs, any_hit=True)
    lit = jnp.where((occ.tri >= 0).reshape(h, w) & covered, 0.0, 1.0)[..., None]

    wo = maths.normalize(eye[None, None, :] - wp)
    lo = lit * pbr.outgoing_radiance(
        n, wo, wi_sun[None, None, :], params.sun.color[None, None, :],
        base_color, metalness, roughness,
    )

    def light_body(i, acc):
        lpos = params.point_lights.position[i]
        lcol = params.point_lights.color[i]
        ldir = lpos[None, None, :] - wp
        dist = jnp.maximum(jnp.linalg.norm(ldir, axis=-1), 1e-12)
        wi = ldir / dist[..., None]
        radiance = lcol[None, None, :] / (dist * dist)[..., None]
        if config.spotlights:
            # Opt-in cone falloff — same packing as the raster paths.
            sd = params.point_lights.spot_dir[i]
            outer, inv_rng = params.point_lights.spot_cos[i]
            cos_t = -jnp.sum(wi * sd[None, None, :], axis=-1)
            radiance = radiance * jnp.clip(
                (cos_t - outer) * inv_rng, 0.0, 1.0
            )[..., None]
        if config.rt_light_shadows:
            # Beyond reference (opt-in): occlusion toward the light,
            # bounded at its distance so geometry behind it cannot block.
            locc = rt.trace(
                bvh, shadow_org, wi.reshape(-1, 3),
                t_max=(dist.reshape(-1) - 2e-3), any_hit=True,
            )
            lvis = jnp.where((locc.tri >= 0).reshape(h, w), 0.0, 1.0)[..., None]
        else:
            lvis = 1.0
        return acc + lvis * lit * pbr.outgoing_radiance(
            n, wo, wi, radiance, base_color, metalness, roughness
        )

    count = jnp.minimum(params.point_lights.count, MAX_POINT_LIGHTS)
    lo = jax.lax.fori_loop(0, count, light_body, lo)
    color = lo + params.ambient * base_color

    background = sky.sample_environment(
        buffers.environment, dirs.reshape(h, w, 3)
    )
    hdr = jnp.where(covered[..., None], color, background)
    if config.hdr_half_round:
        hdr = hdr.astype(jnp.float16).astype(jnp.float32)
    ldr = tonemap.tonemap(hdr, settings.tm_method, settings.gamma, settings.exposure)
    return tonemap.to_unorm8(ldr)


def make_rt_renderer(config: RenderConfig, bvh: rt.BVH):
    @jax.jit
    def render(buffers, params, settings):
        return render_frame_rt(buffers, bvh, params, settings, config)

    return render
