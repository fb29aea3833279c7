"""Image IO: PNG natively (numpy + zlib), Radiance HDR (RGBE) natively.

Replaces stb_image in the reference (stb_image_impl.cpp; stbi_load for LDR
textures app.cpp:247-280, stbi_loadf for the HDRI renderer.cpp:111-126).
The RGBE codec is implemented here (and in native/arctic_native.cpp as the
fast path). JPEG textures are decoded by Pillow, imported only when a JPEG
is actually read.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # color type -> samples/pixel


def _png_chunk(tag: bytes, body: bytes) -> bytes:
    crc = zlib.crc32(tag + body) & 0xFFFFFFFF
    return struct.pack(">I", len(body)) + tag + body + struct.pack(">I", crc)


def encode_png(img: np.ndarray) -> bytes:
    """(H, W) or (H, W, C) u8, C in 1..4 (gray, gray+alpha, RGB, RGBA) ->
    PNG bytes. Every scanline uses the Sub filter."""
    a = np.asarray(img)
    if a.dtype != np.uint8:
        raise ValueError(f"encode_png wants uint8 pixels, got {a.dtype}")
    if a.ndim == 2:
        a = a[..., None]
    h, w, c = a.shape
    color_type = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    rows = np.ascontiguousarray(a).reshape(h, w * c)
    sub = rows.copy()
    sub[:, c:] = rows[:, c:] - rows[:, :-c]  # u8 arithmetic wraps mod 256
    raw = np.concatenate([np.ones((h, 1), np.uint8), sub], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    return (
        _PNG_SIG
        + _png_chunk(b"IHDR", ihdr)
        + _png_chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
        + _png_chunk(b"IEND", b"")
    )


def _png_unfilter(data: np.ndarray, bpp: int) -> np.ndarray:
    """Undo PNG scanline filters. data: (H, 1 + N*bpp) u8 rows, each led by
    its filter byte; returns (H, N*bpp) u8.

    Every filter predicts a byte from its left (a), upper (b) and
    upper-left (c) neighbours, so all cells on one anti-diagonal of the
    (row, cell) grid are independent: the loop walks H + N - 1 diagonals,
    vectorized along each."""
    h = data.shape[0]
    n = (data.shape[1] - 1) // bpp
    ftype = data[:, 0].astype(np.int16)
    cur = data[:, 1:].reshape(h, n, bpp).astype(np.int16)
    out = np.zeros((h + 1, n + 1, bpp), np.int16)  # zero row/col = outside
    for d in range(h + n - 1):
        y = np.arange(max(0, d - n + 1), min(h, d + 1))
        x = d - y
        a = out[y + 1, x]
        b = out[y, x + 1]
        c = out[y, x]
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        ft = ftype[y][:, None]
        pred = np.select(
            [ft == 1, ft == 2, ft == 3, ft == 4], [a, b, (a + b) >> 1, paeth], 0
        )
        out[y + 1, x + 1] = (cur[y, x] + pred) & 0xFF
    return out[1:, 1:].reshape(h, n * bpp).astype(np.uint8)


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W, 4) u8 RGBA, the stbi_load(..., 4) convention.

    Non-interlaced images of every color type; 16-bit samples keep their
    high byte, 1/2/4-bit gray and palette samples are expanded."""
    if data[:8] != _PNG_SIG:
        raise ValueError("not a PNG file")
    pos = 8
    idat = []
    plte = trns = ihdr = None
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        tag = data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"PLTE":
            plte = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif tag == b"tRNS":
            trns = body
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if ihdr is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, color_type, _, _, interlace = ihdr
    if interlace:
        raise ValueError("interlaced PNG is not supported")
    if color_type not in _PNG_CHANNELS or depth not in (1, 2, 4, 8, 16):
        raise ValueError(f"unsupported PNG color type {color_type} / depth {depth}")
    ch = _PNG_CHANNELS[color_type]
    bits = ch * depth
    row_bytes = (w * bits + 7) // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    rows = _png_unfilter(raw[: h * (row_bytes + 1)].reshape(h, row_bytes + 1), max(1, bits // 8))
    if depth == 16:
        samples = rows.reshape(h, w, ch, 2)[..., 0]
    elif depth == 8:
        samples = rows.reshape(h, w, ch)
    else:  # 1/2/4-bit, single channel (gray or palette index)
        bitsplit = np.unpackbits(rows, axis=1).reshape(h, -1, depth)
        weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
        samples = (bitsplit * weights).sum(axis=-1).astype(np.uint8)[:, :w, None]
        if color_type == 0:  # scale gray to 0..255
            samples = (samples.astype(np.uint32) * 255 // ((1 << depth) - 1)).astype(np.uint8)

    out = np.full((h, w, 4), 255, np.uint8)
    if color_type == 3:
        if plte is None:
            raise ValueError("palette PNG without PLTE")
        idx = samples[..., 0]
        out[..., :3] = plte[idx]
        if trns is not None:
            alpha = np.full(256, 255, np.uint8)
            alpha[: len(trns)] = np.frombuffer(trns, np.uint8)
            out[..., 3] = alpha[idx]
        return out
    if color_type in (0, 4):
        out[..., :3] = samples[..., :1]
    else:
        out[..., :3] = samples[..., :3]
    if color_type in (4, 6):
        out[..., 3] = samples[..., -1]
    elif trns is not None:  # color-key transparency
        key = np.frombuffer(trns, ">u2")
        if depth == 16:
            key = key >> 8
        match = np.all(samples[..., : len(key)] == key.astype(np.uint8), axis=-1)
        out[..., 3] = np.where(match, 0, 255)
    return out


def decode_image(data: bytes) -> np.ndarray:
    """Encoded LDR image bytes -> (H, W, 4) u8 RGBA. PNG natively; other
    formats (JPEG) through Pillow, which is needed only for them."""
    if data[:8] == _PNG_SIG:
        return decode_png(data)
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            "decoding a non-PNG texture (e.g. JPEG) needs the 'pillow' "
            "package; PNG textures need nothing extra"
        ) from e
    import io

    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("RGBA"), np.uint8)


def load_ldr(path: str) -> np.ndarray:
    """Load an 8-bit image as (H, W, 4) u8 RGBA (stbi_load ..., 4)."""
    with open(path, "rb") as f:
        return decode_image(f.read())


def save_png(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(np.asarray(img)))


# ----------------------------- Radiance HDR --------------------------------


def _rgbe_to_float(rgbe: np.ndarray) -> np.ndarray:
    """(..., 4) u8 RGBE -> (..., 3) f32 linear (stb __hdr_convert rule)."""
    rgbe = rgbe.astype(np.int32)
    e = rgbe[..., 3]
    scale = np.where(e > 0, np.ldexp(1.0, e - (128 + 8)), 0.0).astype(np.float32)
    return rgbe[..., :3].astype(np.float32) * scale[..., None]


def _float_to_rgbe(rgb: np.ndarray) -> np.ndarray:
    rgb = np.asarray(rgb, np.float32)
    maxc = rgb.max(axis=-1)
    out = np.zeros(rgb.shape[:-1] + (4,), np.uint8)
    nz = maxc >= 1e-32
    mant, exp = np.frexp(np.where(nz, maxc, 1.0))
    scale = mant * 256.0 / np.where(nz, maxc, 1.0)
    out[..., :3] = np.clip(rgb * (scale * nz)[..., None], 0, 255).astype(np.uint8)
    out[..., 3] = np.where(nz, exp + 128, 0).astype(np.uint8)
    return out


def load_hdr(path: str) -> np.ndarray:
    """Radiance .hdr (RGBE, RLE or flat) -> (H, W, 3) f32 linear."""
    if _native() is not None:
        try:
            return _native().load_hdr(path)
        except Exception:
            pass
    with open(path, "rb") as f:
        data = f.read()
    # Header: lines until blank, then resolution line.
    pos = 0

    def line():
        nonlocal pos
        end = data.index(b"\n", pos)
        s = data[pos:end]
        pos = end + 1
        return s

    magic = line()
    if not (magic.startswith(b"#?RADIANCE") or magic.startswith(b"#?RGBE")):
        raise ValueError(f"{path}: not a Radiance HDR file")
    while True:
        ln = line()
        if ln == b"":
            break
    res = line().split()
    if res[0] != b"-Y" or res[2] != b"+X":
        raise ValueError(f"{path}: unsupported orientation {res}")
    h, w = int(res[1]), int(res[3])

    img = np.zeros((h, w, 4), np.uint8)
    buf = np.frombuffer(data, np.uint8, count=len(data) - pos, offset=pos)
    bp = 0
    for y in range(h):
        if w < 8 or w > 0x7FFF or buf[bp] != 2 or buf[bp + 1] != 2 or (buf[bp + 2] & 0x80):
            # Flat (or old-RLE, unsupported) scanline format.
            row = buf[bp : bp + w * 4].reshape(w, 4)
            img[y] = row
            bp += w * 4
            continue
        assert (int(buf[bp + 2]) << 8 | int(buf[bp + 3])) == w
        bp += 4
        for c in range(4):
            x = 0
            while x < w:
                cnt = int(buf[bp])
                if cnt > 128:  # run
                    img[y, x : x + cnt - 128, c] = buf[bp + 1]
                    x += cnt - 128
                    bp += 2
                else:  # literal
                    img[y, x : x + cnt, c] = buf[bp + 1 : bp + 1 + cnt]
                    x += cnt
                    bp += 1 + cnt
    return _rgbe_to_float(img)


def save_hdr(path: str, rgb: np.ndarray) -> None:
    """Write a flat (non-RLE) Radiance HDR file."""
    rgbe = _float_to_rgbe(rgb)
    h, w = rgbe.shape[:2]
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {h} +X {w}\n".encode())
        f.write(rgbe.tobytes())


_native_mod = None
_native_checked = False


def _native():
    """The optional C++ fast path (native/arctic_native.cpp)."""
    global _native_mod, _native_checked
    if not _native_checked:
        _native_checked = True
        try:
            from arctic_tpu.io import native as _n

            _native_mod = _n if _n.available() else None
        except Exception:
            _native_mod = None
    return _native_mod
