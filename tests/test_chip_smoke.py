"""chip_smoke.py on the CPU: its device check refuses a CPU device, and its
main path (bench scene through the GLB asset path, kernel-vs-brute-force
check, fly-through frame, cached sun, CLI, ray-traced mode) runs at a tiny
size with Pillow blocked."""

import sys

import jax
import numpy as np
import pytest

import bench
import chip_smoke


def test_device_check_refuses_cpu():
    assert jax.devices()[0].platform == "cpu"
    with pytest.raises(RuntimeError, match="no GPU"):
        chip_smoke.device_summary(jax.devices())
    with pytest.raises(SystemExit, match="no GPU"):
        bench.require_gpu()


def test_main_path_tiny_without_pillow(monkeypatch):
    from arctic_tpu.io import procedural

    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError):
        import PIL  # noqa: F401
    monkeypatch.setattr(chip_smoke, "W", 128)
    monkeypatch.setattr(chip_smoke, "H", 64)
    monkeypatch.setattr(chip_smoke, "SHADOW", 128)
    monkeypatch.setattr(chip_smoke, "BRUTE_SHADOW", 64)
    monkeypatch.setattr(chip_smoke, "N_FRAMES", 2)
    monkeypatch.setattr(procedural, "sponza_like_scene", procedural.cornell_like_scene)
    goldens = []

    def fake_golden(img, name, what, **kw):
        assert img.dtype == np.uint8 and img.shape == (64, 128, 3)
        goldens.append(name)
        return 99.0

    monkeypatch.setattr(bench, "check_golden", fake_golden)
    bufs, frames, settings, config = chip_smoke.bench_scene()
    chip_smoke.phase_kernel(bufs, frames[0], config)
    chip_smoke.phase_frame(bufs, frames, settings, config, "cpu")
    chip_smoke.phase_raytrace()
    assert goldens == ["bench_golden.png"]
