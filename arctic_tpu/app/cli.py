"""CLI renderer — `arctic <scene>` (main.cpp:18-22) grown up for headless GPUs.

Examples:
    python -m arctic_tpu.app.cli render scene.gltf --out frame.png
    python -m arctic_tpu.app.cli render --procedural sponza --width 1920 \
        --height 1080 --tm aces --frames 60 --orbit
    python -m arctic_tpu.app.cli render scene.obj --camera 0,5,0,0,0
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import sys

import numpy as np

log = logging.getLogger("arctic")

TM_NAMES = {"reinhard": 0, "exposure": 1, "aces": 2}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="arctic_tpu", description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("render", help="render one frame or an orbit sequence")
    r.add_argument("scene", nargs="?", help="glTF/GLB/OBJ scene path")
    r.add_argument("--procedural", choices=["cornell", "sponza"], help="use a built-in scene")
    r.add_argument("--out", default="frame.png")
    r.add_argument("--width", type=int, default=1280)  # app.hpp:20
    r.add_argument("--height", type=int, default=720)  # app.hpp:21
    r.add_argument("--shadow-size", type=int, default=4000)  # shadow_map_pass.hpp:23
    # Settings flags default to None so --load-state can tell "explicitly
    # passed" from "defaulted": saved tm/gamma/exposure must survive a reload
    # unless the user overrides them on the command line (app.cpp:454-493's
    # Settings are fully runtime-mutable; ours round-trip through JSON).
    r.add_argument(
        "--tm", choices=list(TM_NAMES), default=None,
        help="tonemap method (default reinhard, or the --load-state value)",
    )
    r.add_argument(
        "--gamma", type=float, default=None,
        help="gamma (default 2.2, or the --load-state value)",
    )
    r.add_argument(
        "--exposure", type=float, default=None,
        help="exposure (default 1.0, or the --load-state value)",
    )
    r.add_argument(
        "--camera",
        help="x,y,z,pitch,yaw (default 0,5,0,0,0); use --camera=-14,4,0,-8,0 "
        "for values starting with a minus sign",
    )
    r.add_argument("--env", help="equirect .hdr environment path")
    r.add_argument("--frames", type=int, default=1, help="number of frames to render")
    r.add_argument("--orbit", action="store_true", help="sweep yaw over the frames")
    r.add_argument("--bruteforce", action="store_true", help="disable the binned rasterizer")
    r.add_argument("--devices", type=int, default=0, help="render across N devices (0 = single)")
    r.add_argument("--stats", action="store_true", help="print frame-time stats")
    r.add_argument("--raytrace", action="store_true", help="BVH ray-traced reference mode")
    r.add_argument(
        "--ibl", action="store_true",
        help="opt-in IBL specular term (the reference's unticked roadmap item)",
    )
    r.add_argument(
        "--spot", action="append", default=[], metavar="X,Y,Z,R,G,B,AX,AY,AZ,IN,OUT",
        help="add a spotlight: position, color, axis, inner/outer cone degrees "
        "(opt-in; reference roadmap item). Repeatable.",
    )
    r.add_argument(
        "--cache-sun", action="store_true",
        help="render the shadow map once and reuse it across frames "
        "(exact while sun + geometry are static, e.g. --orbit; the viewer "
        "does the equivalent automatically via its sun-dirty flag)",
    )
    r.add_argument("--load-state", help="load camera/lights/settings JSON")
    r.add_argument("--save-state", help="write camera/lights/settings JSON after rendering")
    r.add_argument("--debug-checks", action="store_true", help="enable NaN/Inf checking")
    r.add_argument(
        "--config",
        help="JSON file overriding RenderConfig fields (tile sizes, pair "
        "capacity, hdr rounding, ... — the jit specialization knobs)",
    )
    return p


def cmd_render(args) -> int:
    import jax
    import jax.numpy as jnp

    from arctic_tpu.core.config import RenderConfig
    from arctic_tpu.core.scene import default_scene_params, default_settings
    from arctic_tpu.io.build import build_buffers
    from arctic_tpu.io.images import load_hdr, save_png
    from arctic_tpu.models import pipeline
    from arctic_tpu.utils.profiling import FrameStats

    if args.procedural:
        from arctic_tpu.io import procedural

        if args.procedural == "cornell":
            meshes, objects, materials, env = procedural.cornell_like_scene()
        else:
            meshes, objects, materials, env = procedural.sponza_like_scene()
        if args.env:
            env = load_hdr(args.env)
    elif args.scene:
        from arctic_tpu.io.load import load_scene_file

        meshes, objects, materials, env = load_scene_file(args.scene, env_path=args.env)
    else:
        log.error("render: need a scene path or --procedural")
        return 2

    overrides = {}
    if args.config:
        import json

        with open(args.config) as f:
            overrides = json.load(f)
    config = RenderConfig(
        width=args.width,
        height=args.height,
        shadow_size=args.shadow_size,
        force_bruteforce=args.bruteforce,
        ibl_specular=args.ibl,
        **overrides,
    )
    buffers = build_buffers(meshes, objects, materials, env)
    log.info(
        "scene: %d tris, %d objects, device=%s",
        int(buffers.geometry.num_tris),
        buffers.geometry.object_trs.shape[0],
        jax.devices()[0].device_kind,
    )

    if args.debug_checks:
        from arctic_tpu.utils.errors import enable_debug_checks

        enable_debug_checks()

    params = default_scene_params(aspect=args.width / args.height)
    settings = default_settings()
    if args.load_state:
        from arctic_tpu.utils.serialize import load_state

        params, settings = load_state(args.load_state)
        params = dataclasses.replace(
            params,
            camera=dataclasses.replace(
                params.camera, aspect=jnp.float32(args.width / args.height)
            ),
        )
    if args.camera:
        vals = [float(v) for v in args.camera.split(",")]
        params = dataclasses.replace(
            params,
            camera=dataclasses.replace(
                params.camera,
                eye=jnp.asarray(vals[:3], jnp.float32),
                rotation=jnp.asarray(vals[3:5], jnp.float32),
            ),
        )
    if args.spot:
        from arctic_tpu.core.scene import PointLights

        pl = params.point_lights
        rows = [
            ((pl.position[i]), (pl.color[i]))
            for i in range(int(pl.count))
        ]
        for s in args.spot:
            v = [float(x) for x in s.split(",")]
            assert len(v) == 11, "--spot wants X,Y,Z,R,G,B,AX,AY,AZ,IN,OUT"
            rows.append((v[0:3], v[3:6], (v[6:9], v[9], v[10])))
        params = dataclasses.replace(
            params, point_lights=PointLights.from_list(rows, spots=True)
        )
        config = dataclasses.replace(config, spotlights=True)
    # Explicitly-passed flags override the loaded (or default) settings.
    if args.tm is not None:
        settings = dataclasses.replace(settings, tm_method=jnp.int32(TM_NAMES[args.tm]))
    if args.gamma is not None:
        settings = dataclasses.replace(settings, gamma=jnp.float32(args.gamma))
    if args.exposure is not None:
        settings = dataclasses.replace(settings, exposure=jnp.float32(args.exposure))

    if not (args.raytrace or config.force_bruteforce):
        # Size the pair buffers to the scene (binning costs scale with
        # capacity, not pairs; one cheap count-only compile), and unroll the
        # point-light loop for the known light count (one fused BRDF pass).
        # The sharded path shares the tuned caps: per-slab pair counts are
        # bounded by the full-frame count, so they are safe (over)estimates.
        config = pipeline.autotune_pair_caps(buffers, params, config)
        config = dataclasses.replace(
            config, static_point_lights=int(params.point_lights.count)
        )
        log.info(
            "pair caps: cam=%d shadow=%d", config.pair_cap_cam, config.pair_cap_shadow
        )

    # One compiled program per path: the raster paths return (image,
    # raster health stats), and every frame's stats are checked.
    if args.raytrace:
        from arctic_tpu.models import raytrace

        bvh = raytrace.build_scene_bvh(buffers)
        rt = raytrace.make_rt_renderer(config, bvh)
        render_stats = lambda b, p, s: (rt(b, p, s), None)  # noqa: E731
    elif args.devices:
        from arctic_tpu.parallel import sharding

        mesh = sharding.make_mesh(args.devices)
        render_stats = sharding.make_sharded_renderer_stats(config, mesh)
    elif args.cache_sun and not config.force_bruteforce:
        sun_cache, cache_stats = pipeline.make_sun_cache_builder(config)(
            buffers, params
        )
        pipeline.check_stats({**cache_stats, "cam_pairs": 0, "cam_pair_cap": 1})
        cached = pipeline.make_cached_renderer_stats(config)
        render_stats = lambda b, p, s: cached(b, p, s, sun_cache)  # noqa: E731
        log.info("sun cache built (shadow map reused per frame)")
    else:
        render_stats = pipeline.make_renderer_stats(config)

    from arctic_tpu.utils.errors import render_guard

    scene_desc = args.scene or f"procedural:{args.procedural}"
    guard_desc = (
        f"scene={scene_desc} {config.width}x{config.height} "
        f"shadow={config.shadow_size} tris={int(buffers.geometry.num_tris)}"
    )

    # Compile outside the timed frames.
    with render_guard(guard_desc):
        jax.block_until_ready(render_stats(buffers, params, settings))
    stats = FrameStats()
    img = None
    import time as _time

    for i in range(args.frames):
        p = params
        if args.orbit and args.frames > 1:
            rot = np.asarray(params.camera.rotation) + np.asarray(
                [0.0, 360.0 * i / args.frames], np.float32
            )
            p = dataclasses.replace(
                params, camera=dataclasses.replace(params.camera, rotation=jnp.asarray(rot))
            )
        # Time ONLY render + device sync — PNG encode is not frame time.
        # Overflow checks (the
        # --devices path reports the max over devices: any slab
        # overflowing means the frame is incomplete) run after the timing.
        t0 = _time.perf_counter()
        with render_guard(guard_desc):
            img, rstats = render_stats(buffers, p, settings)
            img.block_until_ready()
        stats.add(_time.perf_counter() - t0)
        if rstats is not None:
            _warn_overflow({k: int(v) for k, v in rstats.items()})
        if args.frames > 1:
            out_i = args.out.replace(".png", f"_{i:04d}.png") if args.frames > 1 else args.out
            save_png(out_i, np.asarray(img))
    if args.frames == 1:
        save_png(args.out, np.asarray(img))
    log.info("wrote %s", args.out)
    if args.save_state:
        from arctic_tpu.utils.serialize import save_state

        save_state(args.save_state, params, settings)
        log.info("saved state to %s", args.save_state)
    if args.stats:
        print(stats.summary())
    return 0


def _warn_overflow(rstats: dict) -> None:
    for p_name in ("cam", "shadow"):
        if rstats[f"{p_name}_pairs"] > rstats[f"{p_name}_pair_cap"]:
            log.warning(
                "%s pass overflowed the tile-pair buffer (%d > %d): frame "
                "is missing fragments — raise pairs_per_tri/pair_reserve "
                "via --config",
                p_name,
                rstats[f"{p_name}_pairs"],
                rstats[f"{p_name}_pair_cap"],
            )


def main(argv=None) -> int:
    from arctic_tpu.utils.compile_cache import enable_compile_cache

    logging.basicConfig(level=logging.INFO, format="%(levelname)s %(name)s: %(message)s")
    args = build_parser().parse_args(argv)
    enable_compile_cache()
    if args.cmd == "render":
        return cmd_render(args)
    return 2


if __name__ == "__main__":
    sys.exit(main())
