"""Static render configuration — jit specialization parameters.

Collects every compile-time constant of the reference into one hashable
dataclass (SURVEY.md §5.6): window size (app.hpp:20-21), shadow-map size
(shadow_map_pass.hpp:23), max point lights (renderer.hpp:22), plus the
tiled rasterizer's tile shapes, which have no reference analogue (the
reference's 16x16 compute groups, post_process_pass.hpp:39-40, are the
closest thing).
Changing any field implies recompilation — the analogue of rebuilding PSOs.
"""

from __future__ import annotations

from dataclasses import dataclass, replace


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


@dataclass(frozen=True)
class RenderConfig:
    # Output resolution (reference default window 1280x720, app.hpp:20-21).
    width: int = 1280
    height: int = 720

    # Shadow map (ShadowMapPass::SIZE = 4000, shadow_map_pass.hpp:23).
    shadow_size: int = 4000

    # Tile shape for the shadow pass (results are tile-size invariant).
    # shadow_tile is the WIDTH; shadow_tile_h overrides the height (None =
    # square). 32 measured faster than 64 on an H100 (PERF.md).
    shadow_tile: int = 32
    shadow_tile_h: int | None = None

    # Screen tile shape for the binned rasterizer: one raster program per
    # tile, its pixels flattened row-major into a (tile_h*tile_w/128, 128)
    # block, so tile_h*tile_w must be a power-of-two multiple of 128 and
    # tile_w must divide 128. Results are tile-size invariant. 32x32
    # measured faster than 64x64 on an H100 (PERF.md).
    tile_h: int = 32
    tile_w: int = 32

    # Capacity of the (tile, triangle) pair buffer as a multiple of the
    # triangle capacity, plus a flat reserve for large-footprint triangles.
    # Every binning op scales with this *capacity* (not actual pairs), so it
    # is deliberately tight; raise it for scenes with huge screen triangles.
    pairs_per_tri: int = 2
    pair_reserve: int = 65536

    # Tight per-pass pair capacities (None = the pairs_per_tri formula).
    # Binning's sort/gather costs scale with CAPACITY, not with the pairs
    # actually generated — pipeline.autotune_pair_caps() measures a frame
    # and returns a config with ~2x-headroom caps.
    # Recompile-per-scene is the PSO-build analogue; overflow stays loud
    # (pipeline.check_stats raises if pairs ever exceed the cap).
    pair_cap_cam: int | None = None
    pair_cap_shadow: int | None = None

    # Static point-light count (None = dynamic fori_loop with the traced
    # params.point_lights.count, matching ps_main's `i < len` loop).  When
    # set, the shading loop unrolls to exactly this many lights so XLA fuses
    # the whole multi-light BRDF into one elementwise pass (a fori_loop body
    # is a fusion barrier: the accumulator round-trips device memory per
    # light).
    # Changing the light count then recompiles — the PSO-build analogue;
    # the interactive viewer keeps the dynamic loop.
    static_point_lights: int | None = None

    # Reference-scale texture sets (the u16 tile atlas): OPT-IN
    # per-material-group compacted 128-px-row gathers (requires a scene
    # built with build_buffers(tex_groups=...)). Tuple of len(groups) + 1
    # static row capacities (last = fallback); None (default) = the plain
    # full-table gather. Values are BIT-IDENTICAL either way (pure row
    # routing); fallback overflow is loud via stats (tex_fb_rows vs
    # tex_fb_cap, like the pair buffers); autotune_tex_group_caps sizes
    # the caps to a scene/fly-path. Nothing enables it by default.
    tex_group_caps: tuple | None = None

    # Emulate the R16G16B16A16_FLOAT HDR color target (renderer.cpp:128-144):
    # round shaded HDR values to f16 before the post-process pass.
    hdr_half_round: bool = True

    # Use the brute-force (all triangles vs all pixels) rasterizer instead of
    # the binned pipeline. Only sane for tiny frames/tests.
    force_bruteforce: bool = False

    # Sun-frustum shadow culling (ops/cull.py): skip shadow-map tiles
    # outside the light-space bounds of (camera frustum ∩ scene AABB) —
    # no shaded pixel's PCF window can read them, so the frame is
    # BIT-IDENTICAL (tests/test_cull.py pins it). Applies to the per-frame
    # fused path only; sun caches always render the full map (they must
    # stay valid as the camera moves). The reference renders the full
    # 4000² map every frame (shadow_map_pass.cpp) — this is a pure
    # work reduction.
    sun_frustum_cull: bool = True

    # Fused shading: the tiled rasterizer's slot ids feed a per-pixel
    # G-buffer resolve and channel-first shading (raster_tiles.raster_gbuffer
    # + pipeline.shade_gbuffer) instead of the deferred per-pixel shade
    # table. Requires the tiled rasterizer; ignored under force_bruteforce.
    fused_shade: bool = True

    # Opt-in image-based specular lighting — the reference's unticked IBL
    # roadmap item (README.md:15). Its sample_environment helper exists as
    # dead code (forward.hlsl:195-206, no uv.y negation unlike the skybox);
    # we compose it minimally as color += fresnel_schlick(n.wo, F0) *
    # env(reflect(-wo, n)) (single-mip env — the reference has no
    # prefiltered mips either). Off by default: parity output has no IBL.
    ibl_specular: bool = False

    # Opt-in spotlights (reference README.md roadmap item, unticked there):
    # light rows gain a cone — radiance is scaled by clamp((cosθ -
    # outer_cos) * inv_range, 0, 1) around PointLights.spot_dir. Point rows
    # store (outer_cos, inv_range) = (-2, 1) so the factor is exactly 1.0.
    # Off by default: the parity program carries no cone math at all.
    spotlights: bool = False

    # Ray-traced mode only (beyond reference): one any-hit shadow ray per
    # point light per covered pixel, bounded at the light's distance. Off
    # by default — matches the raster path's quirk of scaling point lights
    # by the SUN shadow term only (forward.hlsl:222-230).
    rt_light_shadows: bool = False

    # Print a device-side warning when the (tile, triangle) pair buffer
    # overflows (overflowing pairs are dropped -> missing fragments).
    debug_overflow: bool = False

    # --- derived ---
    @property
    def padded_width(self) -> int:
        return _round_up(self.width, self.tile_w)

    @property
    def padded_height(self) -> int:
        return _round_up(self.height, self.tile_h)

    @property
    def tiles_x(self) -> int:
        return self.padded_width // self.tile_w

    @property
    def tiles_y(self) -> int:
        return self.padded_height // self.tile_h

    @property
    def num_tiles(self) -> int:
        return self.tiles_x * self.tiles_y

    @property
    def padded_shadow(self) -> int:
        return _round_up(self.shadow_size, max(self.tile_w, self.tile_h))

    def with_resolution(self, width: int, height: int) -> "RenderConfig":
        return replace(self, width=width, height=height)

    def pair_capacity(self, tri_capacity: int, kind: str = "cam") -> int:
        override = self.pair_cap_cam if kind == "cam" else self.pair_cap_shadow
        if override is not None:
            return _round_up(override, 1024)
        return _round_up(self.pairs_per_tri * tri_capacity + self.pair_reserve, 1024)
