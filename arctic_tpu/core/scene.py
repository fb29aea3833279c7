"""Scene / settings data model as JAX pytrees.

Replacement for the reference's POD structs (src/renderer/scene.hpp:
20-110).  Where the reference keeps per-resource GPU handles (Mesh/Material own
ID3D12Resource + descriptor offsets, scene.hpp:49-69), here *all* geometry is
flattened into device-resident SoA arrays at load time and materials become rows
of an atlas lookup table — the pytree field names play the role the descriptor
heap played.

Dynamic per-frame state (camera, sun, point lights, settings) is a pytree of
traced scalars/arrays, so moving the camera or editing a light never triggers
recompilation — the analogue of the reference re-uploading root constants per
draw (forward_pass.cpp:210-225) and the lights CBV (renderer.cpp:585-603).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np

from arctic_tpu.core import maths

# Renderer::MAX_NUM_POINT_LIGHTS (renderer.hpp:22).
MAX_POINT_LIGHTS = 16

# Tonemap method ids (post_process.hlsl:1-3).
TM_REINHARD = 0
TM_EXPOSURE = 1
TM_ACES = 2


def _pytree_dataclass(cls):
    cls = dataclass(cls)
    fields = dataclasses.fields(cls)
    data = [f.name for f in fields if not f.metadata.get("static")]
    meta = [f.name for f in fields if f.metadata.get("static")]
    return jax.tree_util.register_dataclass(cls, data_fields=data, meta_fields=meta)


def static_field(**kw):
    return field(metadata={"static": True}, **kw)


@_pytree_dataclass
class Camera:
    """Camera (scene.hpp:20-38). Rotation is (pitch, yaw) Euler degrees."""

    eye: jnp.ndarray  # (3,) f32
    rotation: jnp.ndarray  # (2,) f32 degrees
    aspect: jnp.ndarray  # f32 scalar
    fov_y: jnp.ndarray  # f32 scalar, degrees
    z_near: jnp.ndarray  # f32 scalar
    z_far: jnp.ndarray  # f32 scalar

    def forward(self) -> jnp.ndarray:
        return maths.dir_from_rot(self.rotation)

    def proj_view(self) -> jnp.ndarray:
        return maths.camera_proj_view(
            self.eye, self.rotation, self.aspect, self.fov_y, self.z_near, self.z_far
        )

    def proj_view_no_translation(self) -> jnp.ndarray:
        return maths.camera_proj_view_no_translation(
            self.eye, self.rotation, self.aspect, self.fov_y, self.z_near, self.z_far
        )


@_pytree_dataclass
class DirectionalLight:
    """DirectionalLight (scene.hpp:77-86)."""

    position: jnp.ndarray  # (3,) f32
    rotation: jnp.ndarray  # (2,) f32 degrees
    color: jnp.ndarray  # (3,) f32 (HDR)

    def direction(self) -> jnp.ndarray:
        return maths.dir_from_rot(self.rotation)

    def proj_view(self) -> jnp.ndarray:
        return maths.sun_proj_view(self.position, self.rotation)


@_pytree_dataclass
class PointLights:
    """Fixed-capacity SoA point light bank (scene.hpp:88-94, max 16).

    ``count`` is a traced int32 so adding/removing lights (app.cpp:495-523)
    does not recompile; inactive rows are masked in the shader.

    Spotlights (reference README.md roadmap item, unticked there — our
    definition): rows may optionally carry a cone.  ``spot_dir`` is the
    normalized axis and ``spot_cos`` packs (outer_cos, 1/(inner_cos -
    outer_cos)); the shading factor is clamp((cos θ - outer) * inv_range,
    0, 1) — a smooth inner→outer falloff.  Point rows store (-2, 1) so the
    factor clamps to exactly 1.0.  Both fields are None unless built with
    cones (and config.spotlights gates the extra math statically), so the
    parity path's pytree and XLA program are unchanged.
    """

    position: jnp.ndarray  # (16, 3) f32
    color: jnp.ndarray  # (16, 3) f32
    count: jnp.ndarray  # i32 scalar
    spot_dir: jnp.ndarray | None = None  # (16, 3) f32 normalized axis
    spot_cos: jnp.ndarray | None = None  # (16, 2) f32 (outer_cos, inv_range)

    @staticmethod
    def from_list(lights: list[tuple], spots: bool = False) -> "PointLights":
        """lights: (pos, col) point rows or (pos, col, (axis, inner_deg,
        outer_deg)) spotlight rows.  ``spots`` forces cone fields even for
        all-point banks (needed when the renderer was built with
        config.spotlights=True)."""
        n = min(len(lights), MAX_POINT_LIGHTS)
        pos = np.zeros((MAX_POINT_LIGHTS, 3), np.float32)
        col = np.zeros((MAX_POINT_LIGHTS, 3), np.float32)
        sdir = np.zeros((MAX_POINT_LIGHTS, 3), np.float32)
        sdir[:, 1] = -1.0
        scos = np.tile(np.asarray([-2.0, 1.0], np.float32), (MAX_POINT_LIGHTS, 1))
        any_spot = spots
        for i in range(n):
            pos[i], col[i] = lights[i][0], lights[i][1]
            if len(lights[i]) > 2 and lights[i][2] is not None:
                axis, inner_deg, outer_deg = lights[i][2]
                axis = np.asarray(axis, np.float32)
                sdir[i] = axis / max(np.linalg.norm(axis), 1e-12)
                inner_c = np.cos(np.radians(inner_deg))
                outer_c = np.cos(np.radians(outer_deg))
                scos[i] = (outer_c, 1.0 / max(inner_c - outer_c, 1e-4))
                any_spot = True
        return PointLights(
            jnp.asarray(pos), jnp.asarray(col), jnp.int32(n),
            spot_dir=jnp.asarray(sdir) if any_spot else None,
            spot_cos=jnp.asarray(scos) if any_spot else None,
        )


@_pytree_dataclass
class SceneParams:
    """Per-frame dynamic scene state (Scene aggregate, scene.hpp:96-103)."""

    camera: Camera
    ambient: jnp.ndarray  # f32 scalar
    sun: DirectionalLight
    point_lights: PointLights


@_pytree_dataclass
class Settings:
    """Post-process settings (scene.hpp:105-110)."""

    tm_method: jnp.ndarray  # i32 scalar: 0 reinhard / 1 exposure / 2 aces
    gamma: jnp.ndarray  # f32 scalar
    exposure: jnp.ndarray  # f32 scalar


@_pytree_dataclass
class SunCache:
    """The shadow map, which depends only on (geometry, sun) — cacheable
    across frames while the camera flies (pipeline.build_sun_cache).

    The reference re-renders its 4000^2 shadow map every frame on its
    hardware rasterizer; here a deployment may keep it cached and
    invalidate it on sun/geometry edits — the standard cached-shadow-map
    scheme production engines use for stationary lights. Rendering with a
    cache is the math of rendering without one (the cached map holds
    exactly the texels the in-frame pass would sample)."""

    shadow_map: jnp.ndarray  # (S, S) f32 depth


@_pytree_dataclass
class Geometry:
    """All scene geometry flattened to SoA arrays, padded to static shapes.

    Replaces Mesh/Object/Vertex (scene.hpp:40-75): vertex attributes follow the
    reference's 14-float Vertex layout; triangles carry the material id of the
    mesh they came from.  Arrays are padded to a bucket size; ``num_tris``
    masks the tail.

    Vertices are expanded per *object instance* at load time (two objects
    sharing a mesh get separate vertex ranges) so ``vertex_object`` gives each
    vertex exactly one TRS.

    Shading-normal quirk preserved from the reference: the forward VS builds
    the TBN from *object-space* normal/tangent/bitangent without applying the
    model matrix (forward.hlsl:54-61) — only positions are transformed.  We
    keep n/t/b untransformed to match.
    """

    positions: jnp.ndarray  # (V, 3) f32, object space
    normals: jnp.ndarray  # (V, 3) f32 (object space, see quirk above)
    tangents: jnp.ndarray  # (V, 3) f32
    bitangents: jnp.ndarray  # (V, 3) f32
    uvs: jnp.ndarray  # (V, 2) f32 (already FlipUVs'd: v = 1 - v_gltf)
    vertex_object: jnp.ndarray  # (V,) i32 object id per vertex
    indices: jnp.ndarray  # (T, 3) i32
    tri_material: jnp.ndarray  # (T,) i32 material id per triangle
    object_trs: jnp.ndarray  # (O, 4, 4) f32 world TRS per object
    num_tris: jnp.ndarray  # i32 scalar, valid triangle count (<= T)

    # Tri-major static shading data, precomputed at build time so the fused
    # shading path needs no per-frame vertex gathers. None on hand-built
    # Geometry; io.build fills them. Component-plane layouts ((K, T) with
    # the triangle dim MINOR): these are read whole every frame, and every
    # consumer then works on dense (T,) planes.
    tri_corner_pos: jnp.ndarray = None  # (9, T) f32 object-space corners, row c*3+i
    tri_obj: jnp.ndarray = None  # (T,) i32 object id per triangle
    tri_trs: jnp.ndarray = None  # (16, T) f32 world TRS per triangle, row i*4+j
    #   (= object_trs[tri_obj] gathered once at build; saves a 64B-row
    #    gather per triangle per frame)
    tri_static_attrs: jnp.ndarray = None  # (33, T) f32 [n, t, b, uv] row c*11+k
    tri_matrow: jnp.ndarray = None  # (23, T) f32 [regions 12, mr_c 4, nm_c 3, combined region 4]

    @property
    def capacity(self) -> int:
        return self.indices.shape[0]


@_pytree_dataclass
class TextureAtlas:
    """All material textures packed into one 2D atlas.

    Each material contributes three images (diffuse/normal/metal-roughness —
    scene.hpp:62-69, loaded in app.cpp:194-296 with white/flat-normal
    fallbacks).  ``regions`` holds one (y, x, h, w) rect per (material, slot):
    slot 0 diffuse (sRGB-decoded to linear at pack time, renderer.cpp:486),
    slot 1 normal map, slot 2 metalness-roughness, all stored linear.
    Wrap addressing is computed in texel space relative to the region, so
    bilinear taps wrap within their own texture like D3D WRAP mode.
    """

    data: jnp.ndarray  # (AH, AW, 4) texel data (bf16 or f32), linear
    quads: jnp.ndarray  # (4*BH*BW, 16) parity-shifted 2x2 quad copies
    regions: jnp.ndarray  # (M, 3, 4) i32: per material x slot -> (y, x, h, w)
    # Dense 8-quads-per-row packing of ``quads`` ((ceil(Q/8), 128), same
    # dtype); consumers gather row q//8 and select 16 lanes by q%8
    # (ops.sampling.sample_quads_packed).
    quads_packed: jnp.ndarray = None
    # Per-material constant-texture values (normal / metal-roughness slots);
    # meaningful where the static flags below are True.
    nm_consts: jnp.ndarray = None  # (M, 4) f32
    mr_consts: jnp.ndarray = None  # (M, 4) f32
    # Static jit-specialization flags: when every material's normal (resp.
    # metal-roughness) texture is constant, its per-pixel sample IS the
    # constant (bilinear of equal texels is exact), so the gather can be
    # elided — one per-pixel gather less per constant slot.
    nm_constant: bool = static_field(default=False)
    mr_constant: bool = static_field(default=False)

    # Combined-slot atlas: when, per material, all non-elided texture slots
    # share dimensions (constants can be materialized at any size exactly),
    # their texels interleave into one wider quad row so ALL of a pixel's
    # material taps are ONE row gather. combined_slots is the static tuple of
    # slot indices packed (e.g. (0, 1)); None disables the path.
    combined_quads: jnp.ndarray = None  # (4*BH*BW, 16*len(slots))
    combined_regions: jnp.ndarray = None  # (M, 4) i32 (y, x, h, w)
    # Precomputed [pack_tex_rows(combined_quads); env quads_packed] gather
    # table for the merged texture+environment tap (built once per scene in
    # build_buffers; rebuilding per frame cost a 516 MB concatenate).
    combined_env_rows: jnp.ndarray = None  # (ntex + n_env, 128)
    combined_shape: tuple = static_field(default=None)  # (AH, AW) of the atlas
    combined_slots: tuple = static_field(default=None)

    # Reference-scale texture path (io.build.build_tile_atlas): u16-linear
    # 4x8-texel tiles at grid stride (3, 7), 8 channels [diffuse RGB, normal
    # XYZ, mr G, mr B] packed 2-per-i32-lane — ONE (128,) i32 row per tile,
    # ~24 B/texel vs the quad scheme's ~96 (the 4 parity copies amortize to
    # (4/3)(8/7) = 1.52x). The table merges env quads (f32 bit-viewed i32)
    # at rows >= tiles_ntex so the texture+sky tap stays one gather.
    # Per-material (row base, tiles per row, h, w) rides tri_matrow.
    tiles: jnp.ndarray = None  # (N, 128) i32 merged [tex tiles; env rows]
    tiles_ntex: int = static_field(default=0)
    # Material-group partition of ``tiles`` (io.build.group_tile_atlas):
    # the table is laid out as [group-0 tiles | env copy | group-1 tiles |
    # env copy | ...] with each group's slice under
    # io.build.TEX_GROUP_BUDGET_BYTES (the grouped route is opt-in; the
    # plain full-table gather is the default). Rows are
    # (mstart, env_base, end): absolute row bounds of the slice and its
    # env-copy base. A single entry == the ungrouped layout (tiles_ntex ==
    # that entry's env_base). Consumed by
    # ops.sampling.tile_tap_resolve_grouped when config.tex_group_caps is
    # set; the plain full-table gather ignores it. tile_group_of maps
    # material id -> group (groups may be non-contiguous in material id —
    # io.texplan plans them from rendered row co-occurrence).
    tile_groups: tuple = static_field(default=None)
    tile_group_of: tuple = static_field(default=None)
    tile_mat_rows: tuple = static_field(default=None)  # tile rows per material
    # Materialized per-group tables (copies of tiles[mstart:end]): the
    # grouped gather reads true small operands (XLA fuses an in-graph slice
    # into the gather, whose operand is then the full table). ~2x device
    # memory for the atlas; built only for the opt-in grouped route.
    tile_group_tables: tuple = None

    @property
    def block_grid(self):
        ah, aw = self.data.shape[:2]
        return ah // 2 + 1, aw // 2 + 1

    @property
    def combined_block_grid(self):
        ah, aw = self.combined_shape
        return ah // 2 + 1, aw // 2 + 1


@_pytree_dataclass
class Environment:
    """Equirectangular HDR environment map (renderer.cpp:111-126).

    ``atlas`` is a single-region quad-packed copy for one-gather bilinear
    sampling (f32 — HDR radiance keeps full precision); ``data`` remains for
    simple/CPU paths."""

    data: jnp.ndarray  # (H, W, 3) f32, linear radiance
    atlas: TextureAtlas | None = None


@_pytree_dataclass
class SceneBuffers:
    """Everything static the frame function needs on device."""

    geometry: Geometry
    atlas: TextureAtlas
    environment: Environment


def default_scene_params(aspect: float = 1280.0 / 720.0) -> SceneParams:
    """The reference's startup scene state (app.hpp:42-63)."""
    camera = Camera(
        eye=jnp.array([0.0, 5.0, 0.0], jnp.float32),
        rotation=jnp.array([0.0, 0.0], jnp.float32),
        aspect=jnp.float32(aspect),
        fov_y=jnp.float32(45.0),
        z_near=jnp.float32(0.1),
        z_far=jnp.float32(1000.0),
    )
    sun = DirectionalLight(
        position=jnp.array([-10.0, 32.0, -2.48], jnp.float32),
        rotation=jnp.array([-70.0, 12.0], jnp.float32),
        color=jnp.array([8.0, 8.0, 8.0], jnp.float32),
    )
    lights = PointLights.from_list([((0.0, 1.0, 0.0), (10.0, 0.0, 0.0))])
    return SceneParams(
        camera=camera, ambient=jnp.float32(0.1), sun=sun, point_lights=lights
    )


def default_settings() -> Settings:
    """Settings defaults (scene.hpp:105-110)."""
    return Settings(
        tm_method=jnp.int32(TM_REINHARD),
        gamma=jnp.float32(2.2),
        exposure=jnp.float32(1.0),
    )


def with_object_trs(geom: Geometry, obj_id: int, trs) -> Geometry:
    """Geometry with object ``obj_id``'s world TRS replaced — the scene-editor
    mutation the reference never had (its Objects are frozen at import,
    app.cpp:358-382; "scene editor" is an unticked README.md:17 roadmap item).

    Updates both the per-object matrix and the tri-major gathered copy
    (``tri_trs == object_trs[tri_obj]``, io/build.py) so every consumer —
    world-corner raster setup, shade rows, the per-vertex path — sees the
    edit. Attributes stay untouched: n/t/b are object-space by the
    reference's TBN quirk (forward.hlsl:54-61), so a transform edit is
    exactly a two-array update. Shapes are unchanged — no recompile.
    """
    object_trs = geom.object_trs.at[obj_id].set(
        jnp.asarray(trs, jnp.float32)
    )
    new = dataclasses.replace(geom, object_trs=object_trs)
    if geom.tri_trs is not None:
        # Same construction as io/build.py (tail rows follow tri_obj's
        # zero padding, matching the build-time gather exactly).
        tri_trs = object_trs[geom.tri_obj].reshape(geom.capacity, 16).T
        new = dataclasses.replace(new, tri_trs=tri_trs)
    return new
