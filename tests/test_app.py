"""App layer: CLI render smoke test + fly-camera parity math."""

import numpy as np
import jax.numpy as jnp
import pytest

from arctic_tpu.app.camera import FlyCamera
from arctic_tpu.app.cli import main
from arctic_tpu.core.scene import default_scene_params
from arctic_tpu.utils.profiling import FrameStats


def test_cli_renders_procedural_scene(tmp_path):
    out = tmp_path / "frame.png"
    rc = main(
        [
            "render",
            "--procedural",
            "cornell",
            "--width",
            "96",
            "--height",
            "64",
            "--shadow-size",
            "96",
            "--bruteforce",
            "--tm",
            "aces",
            "--camera",
            "0,4,3,-25,-90",
            "--out",
            str(out),
            "--stats",
        ]
    )
    assert rc == 0
    from PIL import Image

    with Image.open(out) as im:
        assert im.size == (96, 64)
        img = np.asarray(im)
    assert img.std() > 10  # actual content


def test_cli_load_state_restores_settings(tmp_path):
    """--save-state then --load-state must round-trip the SETTINGS half too
    (loaded tm/gamma/exposure must not be silently discarded),
    while explicitly-passed flags still override the loaded values."""
    import json

    out = tmp_path / "frame.png"
    state = tmp_path / "state.json"
    base = [
        "render", "--procedural", "cornell", "--width", "64", "--height", "48",
        "--shadow-size", "64", "--bruteforce", "--out", str(out),
    ]
    # Save with non-default settings + camera.
    rc = main(
        base
        + ["--tm", "aces", "--gamma", "1.8", "--exposure", "2.5",
           "--camera", "0,4,3,-25,-90", "--save-state", str(state)]
    )
    assert rc == 0

    def check_settings(d, tm, gamma, exposure):
        # Settings round-trip through f32, so compare with float tolerance.
        assert d["tm_method"] == tm
        assert d["gamma"] == pytest.approx(gamma, rel=1e-6)
        assert d["exposure"] == pytest.approx(exposure, rel=1e-6)

    saved = json.loads(state.read_text())
    check_settings(saved["settings"], 2, 1.8, 2.5)

    # Reload with NO settings flags: the saved settings must survive into the
    # re-saved state (the render consumed them, not the argparse defaults).
    state2 = tmp_path / "state2.json"
    rc = main(base + ["--load-state", str(state), "--save-state", str(state2)])
    assert rc == 0
    saved2 = json.loads(state2.read_text())
    check_settings(saved2["settings"], 2, 1.8, 2.5)
    assert saved2["camera"]["eye"] == [0.0, 4.0, 3.0]  # camera restored too

    # An explicit flag overrides just that field of the loaded settings.
    state3 = tmp_path / "state3.json"
    rc = main(
        base + ["--load-state", str(state), "--gamma", "2.4",
                "--save-state", str(state3)]
    )
    assert rc == 0
    saved3 = json.loads(state3.read_text())
    check_settings(saved3["settings"], 2, 2.4, 2.5)


def test_cli_cache_sun_orbit(tmp_path):
    """--cache-sun renders the shadow chain once and reuses it per frame."""
    out = tmp_path / "f.png"
    rc = main(
        [
            "render", "--procedural", "cornell", "--width", "64", "--height",
            "64", "--shadow-size", "64", "--frames", "2", "--orbit",
            "--cache-sun", "--camera", "0,4,3,-25,-90", "--out", str(out),
        ]
    )
    assert rc == 0
    from PIL import Image

    with Image.open(tmp_path / "f_0000.png") as im:
        assert np.asarray(im).std() > 5


def test_fly_camera_matches_reference_math():
    cam = default_scene_params().camera
    fc = FlyCamera()
    # One second forward at default yaw 0 -> forward is +X (dir_from_rot).
    moved = fc.move(cam, dt=1.0, forward_input=1.0)
    np.testing.assert_allclose(np.asarray(moved.eye), [10.0, 5.0, 0.0], atol=1e-5)
    # Right = cross(forward, up) = (0,0, ... ) for fwd=+X, up=+Y: right=-Z?
    moved = fc.move(cam, dt=0.5, right_input=1.0)
    fwd = np.array([1.0, 0, 0])
    right = np.cross(fwd, [0, 1, 0])
    np.testing.assert_allclose(np.asarray(moved.eye), np.array([0, 5, 0]) + 5 * right, atol=1e-5)
    # Mouse look: +dx yaw, -dy pitch at 0.5 deg/px (app.cpp:143-147).
    looked = fc.look(cam, dx_px=10, dy_px=4)
    np.testing.assert_allclose(np.asarray(looked.rotation), [-2.0, 5.0], atol=1e-6)


def test_frame_stats():
    s = FrameStats(capacity=4)
    for _ in range(6):
        s.tick()
    assert len(s.history) == 4
    assert "fps" in s.summary()
    s.add(0.25)
    assert abs(s.history[-1] - 0.25) < 1e-9


def test_cli_stats_excludes_png_encode(tmp_path, monkeypatch, capsys):
    """--stats must time render + device sync only, not the per-frame PNG
    encode. A slow save_png must not move the measured
    minimum frame time (the first frame legitimately includes jit compile,
    so assert on min, which comes from a post-compile frame)."""
    import time

    from arctic_tpu.io import images

    real_save = images.save_png
    delay = 0.75

    def slow_save(path, img):
        time.sleep(delay)
        return real_save(path, img)

    monkeypatch.setattr(images, "save_png", slow_save)
    out = tmp_path / "f.png"
    rc = main(
        [
            "render", "--procedural", "cornell", "--width", "64", "--height",
            "48", "--shadow-size", "64", "--bruteforce", "--frames", "3",
            "--orbit", "--camera", "0,4,3,-25,-90", "--out", str(out),
            "--stats",
        ]
    )
    assert rc == 0
    summary = capsys.readouterr().out.strip().splitlines()[-1]
    import re

    m = re.search(r"min=([0-9.]+)ms", summary)
    assert m, summary
    assert float(m.group(1)) < delay * 1e3, (
        f"--stats min frame time {m.group(1)} ms includes the {delay*1e3:.0f} ms "
        f"PNG encode: {summary}"
    )
