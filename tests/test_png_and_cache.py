"""The numpy/zlib PNG codec, the bilinear upsample that builds procedural
textures, and the persistent compile cache location."""

import io
import os

import numpy as np
import pytest

from arctic_tpu.io import images


@pytest.mark.parametrize("shape", [(7, 5), (9, 13, 2), (31, 17, 3), (16, 16, 4)])
def test_png_round_trip(shape, tmp_path):
    rng = np.random.default_rng(len(shape) * 10 + shape[0])
    img = rng.integers(0, 256, shape).astype(np.uint8)
    path = str(tmp_path / "x.png")
    images.save_png(path, img)
    rgba = images.load_ldr(path)
    assert rgba.shape == shape[:2] + (4,)
    c = 1 if img.ndim == 2 else img.shape[2]
    planes = img[..., None] if img.ndim == 2 else img
    gray = c in (1, 2)
    np.testing.assert_array_equal(rgba[..., :3], np.repeat(planes[..., :1], 3, -1) if gray else planes[..., :3])
    alpha = planes[..., -1] if c in (2, 4) else np.full(shape[:2], 255, np.uint8)
    np.testing.assert_array_equal(rgba[..., 3], alpha)


@pytest.mark.parametrize("mode", ["P", "I;16", "1", "RGB"])
def test_png_decodes_other_encoders(mode):
    """Images written by another encoder (Pillow, with its own filter
    choices, palettes, 16-bit and 1-bit samples) decode to what it reads."""
    pil = pytest.importorskip("PIL.Image")
    rng = np.random.default_rng(5)
    base = rng.integers(0, 256, (23, 41, 3)).astype(np.uint8)
    im = pil.fromarray(base)
    if mode == "P":
        im = im.quantize(17)
    elif mode == "I;16":
        im = pil.fromarray(base[..., 0].astype(np.uint16) * 257)
    elif mode == "1":
        im = im.convert("1")
    buf = io.BytesIO()
    im.save(buf, "PNG")
    got = images.decode_png(buf.getvalue())
    want = np.asarray(pil.open(io.BytesIO(buf.getvalue())).convert("RGBA"))
    if mode == "I;16":  # Pillow's RGBA of 16-bit gray clips; compare high bytes
        want = np.stack([base[..., 0]] * 3 + [np.full(base.shape[:2], 255, np.uint8)], -1)
    np.testing.assert_array_equal(got, want)


def test_bilinear_upsample():
    from arctic_tpu.io.procedural import bilinear_upsample

    g = np.arange(16, dtype=np.float32).reshape(4, 4)
    up = bilinear_upsample(g, 8)
    assert up.shape == (8, 8)
    # Texel-center aligned: outputs 1, 2 of 8 sit at src 0.25, 0.75.
    np.testing.assert_allclose(up[0, :4], [0.0, 0.25, 0.75, 1.25])
    np.testing.assert_allclose(up[:, 0], 4 * up[0, :], rtol=1e-6)
    assert up.min() == 0.0 and up.max() == 15.0


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_dir(monkeypatch, tmp_path, env_set):
    import jax

    from arctic_tpu.utils import compile_cache

    updates = {}
    monkeypatch.setattr(jax.config, "update", lambda k, v: updates.__setitem__(k, v))
    if env_set:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        assert compile_cache.enable_compile_cache() == str(tmp_path)
        assert updates == {}  # JAX reads the variable itself
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        want = os.path.join(compile_cache.REPO_ROOT, ".jax_cache")
        assert compile_cache.enable_compile_cache() == want
        assert updates == {"jax_compilation_cache_dir": want}
        assert os.path.isdir(os.path.join(compile_cache.REPO_ROOT, "arctic_tpu"))
