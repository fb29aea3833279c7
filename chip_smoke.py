"""Chip check: drive the renderer's main path once on one GPU and check it.

    python chip_smoke.py          # all one-GPU phases
    python chip_smoke.py --four   # only the 4-GPU sharded frame vs one GPU

Everything runs in this one process (a second JAX process on the card would
fail for want of memory); the only child is ``nvidia-smi``. A phase that
fails raises and the script exits non-zero. The last stdout line is one
JSON object: {"ok": true, "device": {"platform", "kind", "count"}}.

Phases (one GPU):
  1. device: the default JAX device must be a GPU.
  2. raster kernel at real widths: the 1920x1080 camera pass and the
     4000^2 shadow pass of the bench scene, compiled through the Triton
     route; slot ids and depth must EQUAL brute force exactly at 1080p and
     at the largest shadow size brute force fits (2000^2).
  3. conformance (bench.conformance_checks): tiled == brute force at
     640x360; >= 40 dB vs the float64 oracle and the committed golden;
     1-device shard_map frame <= 2 LSB and >= 55 dB vs single-device.
  4. the bench frame (1080p, 4000^2 shadow, 4 point lights, ACES):
     autotuned pair caps, compile, the 20-frame fly-through (no pair
     overflow on any frame), cached sun <= 1 LSB from the re-render, final
     frame >= 40 dB vs docs/images/bench_golden.png; the same viewpoint
     once through the CLI, <= 2 LSB and >= 55 dB vs the in-process frame.
  5. the reference-scale textured frame >= 40 dB vs bench_tex1024.png.
  6. ray-traced mode through the CLI: liveness (finite, non-constant).
  7. the tests marked ``gpu``, in this process.
With --four: the sharded renderer over 4 GPUs at 1080p/4000^2 vs the
single-GPU frame on device 0: <= 2 LSB and >= 55 dB.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
W, H, SHADOW = 1920, 1080, 4000
BRUTE_SHADOW = 2000  # largest shadow size the brute-force reference fits
N_FRAMES = 20  # bench fly-through length


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


def device_summary(devices) -> dict:
    """{"platform", "kind", "count"} of JAX's devices; raises unless the
    default device is a GPU."""
    dev = devices[0]
    if dev.platform != "gpu":
        raise RuntimeError(
            f"no GPU: JAX's default device is {dev.platform!r} ({dev.device_kind})"
        )
    return {"platform": dev.platform, "kind": dev.device_kind, "count": len(devices)}


class Phase:
    """Prints a phase's name and wall time; lets every exception through."""

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        print(f"== {self.name}", flush=True)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            print(f"== {self.name}: OK ({time.perf_counter() - self.t0:.1f} s)", flush=True)
        return False


def median_ms(fn, *args, n: int = 5) -> float:
    import jax

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return 1e3 * statistics.median(ts)


def frame_diff(a, b) -> tuple[int, float]:
    """(max abs u8 difference, PSNR dB) of two frames."""
    import numpy as np

    from bench import psnr

    a = np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return int(np.abs(a.astype(int) - b.astype(int)).max()), psnr(a, b)


def require_close(a, b, what: str, max_lsb: int, min_db: float) -> None:
    lsb, db = frame_diff(a, b)
    print(f"{what}: max {lsb} LSB, {db:.2f} dB (allowed <= {max_lsb} LSB, >= {min_db} dB)")
    if lsb > max_lsb or db < min_db:
        raise RuntimeError(f"{what}: {lsb} LSB / {db:.2f} dB out of tolerance")


def bench_scene():
    """(buffers, fly-through params, settings, tuned config) of the bench."""
    import jax.numpy as jnp

    import bench
    from arctic_tpu.core.scene import default_settings
    from arctic_tpu.io.build import build_buffers

    bufs = build_buffers(*bench.asset_path_scene())
    frames = bench.fly_frames(bench.bench_params(W, H), N_FRAMES)
    settings = dataclasses.replace(default_settings(), tm_method=jnp.int32(2))
    return bufs, frames, settings, bench.bench_config(bufs, frames, W, H, SHADOW)


def phase_kernel(bufs, params, config) -> None:
    """Tiled raster (compiled kernel) vs brute force at real widths."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from arctic_tpu.models import pipeline
    from arctic_tpu.ops import binning, raster, raster_tiles

    def setup_for(size_w, size_h, pv, cull):
        geom = bufs.geometry
        wc = pipeline.world_corners(geom)
        tri_valid = jnp.arange(geom.capacity) < geom.num_tris
        clipped = raster.near_clip_corners(pipeline.corners_clip(wc, pv), tri_valid)
        return raster.setup_screen_triangles(clipped, size_w, size_h, cull=cull)

    cam_pv = params.camera.proj_view()
    sun_pv = params.sun.proj_view()
    st, sth = config.shadow_tile, config.shadow_tile_h or config.shadow_tile
    cases = [
        # (label, viewport, proj_view, cull, pair-cap kind, tile (h, w),
        #  depth_only, compare with brute force?)
        ("camera 1920x1080", (W, H), cam_pv, "back", "cam",
         (config.tile_h, config.tile_w), False, True),
        (f"shadow {SHADOW}^2 (depth only)", (SHADOW, SHADOW), sun_pv, "front",
         "shadow", (sth, st), True, False),
        (f"shadow {BRUTE_SHADOW}^2", (BRUTE_SHADOW, BRUTE_SHADOW), sun_pv,
         "front", "shadow", (sth, st), False, True),
    ]
    for label, (sw, sh), pv, cull, kind, (th, tw), depth_only, brute in cases:
        setup = jax.jit(lambda pv: setup_for(sw, sh, pv, cull))(pv)
        # The tuned shadow cap fits the 4000^2 pass; the 2000^2 comparison
        # takes the default capacity formula.
        cfg = config if kind == "cam" or sw == SHADOW else dataclasses.replace(
            config, pair_cap_shadow=None
        )

        def tiled(setup, sw=sw, sh=sh, kind=kind, th=th, tw=tw, depth_only=depth_only, cfg=cfg):
            return raster_tiles.rasterize_tiled(
                setup, sh, sw, cfg, tile_h=th, tile_w=tw, kind=kind,
                depth_only=depth_only, with_pairs=True,
            )

        compiled = jax.jit(tiled).lower(setup).compile()
        print(f"[{label}] tiled memory_analysis: {compiled.memory_analysis()}")
        zt, it, pairs = compiled(setup)
        cap = cfg.pair_capacity(setup.capacity, kind)
        if int(pairs) > cap:
            raise RuntimeError(f"[{label}] pair overflow {int(pairs)} > {cap}")
        t_tiled = median_ms(compiled, setup)
        binning_only = jax.jit(
            lambda s, th=th, tw=tw, cap=cap, sw=sw, sh=sh: binning.bin_triangles(
                s, -(-sw // tw), -(-sh // th), tw, th, cap
            )
        )
        t_bin = median_ms(binning_only, setup)
        print(
            f"[{label}] tiled (bin + raster kernel): {t_tiled:.3f} ms median of 5; "
            f"binning alone {t_bin:.3f} ms; pairs {int(pairs)} / cap {cap}"
        )
        if not brute:
            continue
        bf = jax.jit(lambda s, sw=sw, sh=sh: raster.rasterize_bruteforce(s, sh, sw))
        zb, ib = bf(setup)
        t_bf = median_ms(bf, setup)
        zt, it, zb, ib = (np.asarray(a) for a in (zt, it, zb, ib))
        n_i = int((it != ib).sum())
        n_z = int((zt != zb).sum())
        print(
            f"[{label}] brute force: {t_bf:.3f} ms median of 5; tiled vs brute "
            f"force: ibuf differs at {n_i} px, z at {n_z} px (required: 0, exact)"
        )
        if n_i or n_z:
            raise RuntimeError(f"[{label}] tiled raster != brute force")


def phase_frame(bufs, frames, settings, config, smi: str) -> None:
    import jax
    import numpy as np

    import bench
    from arctic_tpu.app import cli
    from arctic_tpu.io.images import load_ldr
    from arctic_tpu.models import pipeline
    from arctic_tpu.utils.serialize import save_state

    print(f"pair caps: cam={config.pair_cap_cam} shadow={config.pair_cap_shadow}")
    t0 = time.perf_counter()
    render = pipeline.make_renderer_stats(config).lower(
        bufs, frames[0], settings
    ).compile()
    compile_s = time.perf_counter() - t0
    render(bufs, frames[0], settings)[0].block_until_ready()  # warm
    ms = []
    for p in frames:
        t0 = time.perf_counter()
        img, stats = render(bufs, p, settings)
        img.block_until_ready()
        ms.append(1e3 * (time.perf_counter() - t0))
        pipeline.check_stats(stats)  # no pair overflow on any frame
    peak = (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")
    print(
        f"bench frame [{smi}]: compile {compile_s:.1f} s, median frame "
        f"{statistics.median(ms):.3f} ms over {len(ms)} fly-through frames "
        f"(min {min(ms):.3f}, max {max(ms):.3f}), peak_bytes_in_use {peak}"
    )
    final = np.asarray(img)
    bench.check_golden(final, "bench_golden.png", "bench final frame")

    cache, cstats = pipeline.make_sun_cache_builder(config)(bufs, frames[0])
    pipeline.check_stats({**cstats, "cam_pairs": 0, "cam_pair_cap": 1})
    img_c, stats_c = pipeline.make_cached_renderer_stats(config)(
        bufs, frames[-1], settings, cache
    )
    pipeline.check_stats(stats_c)
    require_close(img_c, final, "cached sun vs re-render", 1, 0.0)

    with tempfile.TemporaryDirectory(prefix="arctic_smoke_") as td:
        glb, hdr = bench.export_bench_asset(td)
        state = os.path.join(td, "bench_view.json")
        save_state(state, frames[0], settings)
        out = os.path.join(td, "cli.png")
        rc = cli.main([
            "render", glb, "--env", hdr, "--width", str(W),
            "--height", str(H), "--shadow-size", str(SHADOW),
            "--load-state", state, "--out", out,
        ])
        if rc != 0:
            raise RuntimeError(f"CLI render exited {rc}")
        cli_img = load_ldr(out)[..., :3]
    first = np.asarray(render(bufs, frames[0], settings)[0])
    require_close(cli_img, first, "CLI frame vs in-process frame", 2, 55.0)


def textured_final_frame(frames, settings):
    """The reference-scale textured scene's final fly-through frame."""
    import numpy as np

    import bench
    from arctic_tpu.io.build import build_buffers
    from arctic_tpu.models import pipeline

    tbufs = build_buffers(*bench.textured_scene(1024))
    config = bench.bench_config(tbufs, frames, W, H, SHADOW)
    img, stats = pipeline.make_renderer_stats(config)(tbufs, frames[-1], settings)
    pipeline.check_stats(stats)
    return np.asarray(img)


def phase_textured(frames, settings) -> None:
    import bench

    img = textured_final_frame(frames, settings)
    bench.check_golden(img, "bench_tex1024.png", "textured bench final frame")


def phase_raytrace() -> None:
    import numpy as np

    from arctic_tpu.app import cli
    from arctic_tpu.io.images import load_ldr

    with tempfile.TemporaryDirectory(prefix="arctic_smoke_") as td:
        out = os.path.join(td, "rt.png")
        rc = cli.main([
            "render", "--procedural", "cornell", "--raytrace", "--width", "320",
            "--height", "240", "--shadow-size", "256", "--camera=0,3,1,-15,-90",
            "--out", out,
        ])
        if rc != 0:
            raise RuntimeError(f"ray-traced CLI render exited {rc}")
        img = load_ldr(out)[..., :3]
    if img.shape != (240, 320, 3) or np.ptp(img) == 0:
        raise RuntimeError(f"ray-traced frame is blank or misshaped: {img.shape}")
    print(f"ray-traced frame: {img.shape}, values {img.min()}..{img.max()}")


class _Outcomes:
    """pytest plugin counting passed and skipped tests."""

    def __init__(self):
        self.passed = self.skipped = 0

    def pytest_runtest_logreport(self, report):
        if report.when == "call" and report.passed:
            self.passed += 1
        if report.skipped:
            self.skipped += 1


def phase_gpu_tests() -> None:
    import pytest

    outcomes = _Outcomes()
    rc = pytest.main(
        [os.path.join(REPO, "tests"), "-q", "-m", "gpu", "--gpu",
         "-p", "no:cacheprovider"],
        plugins=[outcomes],
    )
    print(f"gpu-marked tests: {outcomes.passed} passed, {outcomes.skipped} skipped")
    if rc != 0 or outcomes.skipped or not outcomes.passed:
        raise RuntimeError(f"gpu-marked tests failed (pytest exit {rc})")


def phase_four(smi: str) -> None:
    import jax

    from arctic_tpu.models import pipeline
    from arctic_tpu.parallel import sharding

    if len(jax.devices()) < 4:
        raise RuntimeError(f"--four needs 4 GPUs, JAX sees {len(jax.devices())}")
    bufs, frames, settings, config = bench_scene()
    render1 = pipeline.make_renderer_stats(config)
    single, st1 = render1(bufs, frames[0], settings)
    pipeline.check_stats(st1)
    mesh = sharding.make_mesh(4)
    render4 = sharding.make_sharded_renderer_stats(config, mesh)
    t0 = time.perf_counter()
    multi, st4 = render4(bufs, frames[0], settings)
    multi.block_until_ready()
    print(f"sharded compile + first frame: {time.perf_counter() - t0:.1f} s")
    pipeline.check_stats(st4)
    # Both timed on the same frame (fly-through frame 0), same statistic.
    t1 = median_ms(render1, bufs, frames[0], settings)
    t4 = median_ms(render4, bufs, frames[0], settings)
    print(
        f"frame 0 [{smi}]: 1 GPU {t1:.3f} ms, sharded on 4 GPUs {t4:.3f} ms "
        f"(medians of 5)"
    )
    require_close(multi, single, "4-GPU sharded vs 1-GPU frame", 2, 55.0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true", help="only the 4-GPU phase")
    args = ap.parse_args(argv)

    import jax

    with Phase("1 device"):
        summary = device_summary(jax.devices())
        smi = nvidia_smi()
        print(f"device_kind {summary['kind']}, {summary['count']} device(s)")
        print(f"nvidia-smi: {smi}")
    sys.path.insert(0, REPO)
    from arctic_tpu.utils.compile_cache import enable_compile_cache

    print(
        f"jax {jax.__version__}, XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}, "
        f"compile cache {enable_compile_cache()}"
    )

    if args.four:
        with Phase("8 four GPUs"):
            phase_four(smi)
    else:
        import bench

        bufs, frames, settings, config = bench_scene()
        with Phase("2 raster kernel at real widths"):
            phase_kernel(bufs, frames[0], config)
        with Phase("3 conformance"):
            print(json.dumps(bench.conformance_checks()))
        with Phase("4 bench frame"):
            phase_frame(bufs, frames, settings, config, smi)
        with Phase("5 textured frame"):
            phase_textured(frames, settings)
        with Phase("6 ray-traced mode"):
            phase_raytrace()
        with Phase("7 gpu-marked tests"):
            phase_gpu_tests()

    print(smi)
    summary["count"] = len(jax.devices())
    print(json.dumps({"ok": True, "device": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
