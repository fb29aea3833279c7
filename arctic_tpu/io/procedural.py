"""Procedural meshes, textures, environments and benchmark scenes.

The reference renders Khronos glTF sample assets (README.md:29) that are not
shipped with the repo; these generators produce deterministic stand-ins with
the same structural load — a "Sponza-class" colonnade hall with ~the same
triangle/material counts drives the benchmark, and small scenes drive tests.
"""

from __future__ import annotations

import numpy as np

from arctic_tpu.io.build import MaterialImages, MeshData


# ----------------------------- primitive meshes ---------------------------


def plane_mesh(size=1.0, material=0, uv_scale=1.0) -> MeshData:
    """Unit plane in XZ, normal +Y, centered at origin."""
    s = size / 2.0
    pos = np.array([[-s, 0, -s], [s, 0, -s], [s, 0, s], [-s, 0, s]], np.float32)
    nrm = np.tile([0, 1, 0], (4, 1)).astype(np.float32)
    uv = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32) * uv_scale
    # CCW seen from +Y (front faces up).
    idx = np.array([[0, 2, 1], [0, 3, 2]], np.int32)
    return MeshData(pos, nrm, uv, idx, material)


def box_mesh(sx=1.0, sy=1.0, sz=1.0, material=0) -> MeshData:
    """Axis-aligned box, outward CCW faces, per-face UVs."""
    hx, hy, hz = sx / 2, sy / 2, sz / 2
    faces = [
        # (normal, corner order making CCW from outside)
        ([0, 0, 1], [[-hx, -hy, hz], [hx, -hy, hz], [hx, hy, hz], [-hx, hy, hz]]),
        ([0, 0, -1], [[hx, -hy, -hz], [-hx, -hy, -hz], [-hx, hy, -hz], [hx, hy, -hz]]),
        ([1, 0, 0], [[hx, -hy, hz], [hx, -hy, -hz], [hx, hy, -hz], [hx, hy, hz]]),
        ([-1, 0, 0], [[-hx, -hy, -hz], [-hx, -hy, hz], [-hx, hy, hz], [-hx, hy, -hz]]),
        ([0, 1, 0], [[-hx, hy, hz], [hx, hy, hz], [hx, hy, -hz], [-hx, hy, -hz]]),
        ([0, -1, 0], [[-hx, -hy, -hz], [hx, -hy, -hz], [hx, -hy, hz], [-hx, -hy, hz]]),
    ]
    pos, nrm, uv, idx = [], [], [], []
    for fi, (n, corners) in enumerate(faces):
        base = fi * 4
        pos.extend(corners)
        nrm.extend([n] * 4)
        uv.extend([[0, 1], [1, 1], [1, 0], [0, 0]])
        idx.extend([[base, base + 1, base + 2], [base, base + 2, base + 3]])
    return MeshData(
        np.asarray(pos, np.float32),
        np.asarray(nrm, np.float32),
        np.asarray(uv, np.float32),
        np.asarray(idx, np.int32),
        material,
    )


def uv_sphere(radius=1.0, stacks=16, slices=24, material=0) -> MeshData:
    vs, ns, uvs = [], [], []
    for i in range(stacks + 1):
        phi = np.pi * i / stacks
        for j in range(slices + 1):
            theta = 2 * np.pi * j / slices
            n = [np.sin(phi) * np.cos(theta), np.cos(phi), np.sin(phi) * np.sin(theta)]
            vs.append([radius * c for c in n])
            ns.append(n)
            uvs.append([j / slices, i / stacks])
    idx = []
    for i in range(stacks):
        for j in range(slices):
            a = i * (slices + 1) + j
            b = a + slices + 1
            # CCW from outside.
            idx.append([a, a + 1, b])
            idx.append([a + 1, b + 1, b])
    return MeshData(
        np.asarray(vs, np.float32),
        np.asarray(ns, np.float32),
        np.asarray(uvs, np.float32),
        np.asarray(idx, np.int32),
        material,
    )


def cylinder_mesh(radius=0.5, height=2.0, slices=24, material=0) -> MeshData:
    vs, ns, uvs, idx = [], [], [], []
    for i in range(2):
        y = height * i
        for j in range(slices + 1):
            t = 2 * np.pi * j / slices
            n = [np.cos(t), 0.0, np.sin(t)]
            vs.append([radius * n[0], y, radius * n[2]])
            ns.append(n)
            uvs.append([j / slices * 4.0, 1.0 - i])
    for j in range(slices):
        a = j
        b = j + slices + 1
        idx.append([a, b, a + 1])
        idx.append([a + 1, b, b + 1])
    return MeshData(
        np.asarray(vs, np.float32),
        np.asarray(ns, np.float32),
        np.asarray(uvs, np.float32),
        np.asarray(idx, np.int32),
        material,
    )


def transform(translate=(0, 0, 0), scale=(1, 1, 1), yaw_deg=0.0) -> np.ndarray:
    c, s = np.cos(np.radians(yaw_deg)), np.sin(np.radians(yaw_deg))
    r = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = r * np.asarray(scale, np.float32)[None, :]
    m[:3, 3] = translate
    return m


# ----------------------------- textures -----------------------------------


def checker_texture(size=64, tiles=8, c0=(200, 200, 200), c1=(60, 60, 60)) -> np.ndarray:
    y, x = np.mgrid[0:size, 0:size]
    mask = ((x * tiles // size) + (y * tiles // size)) % 2
    img = np.where(mask[..., None] == 0, np.array(c0, np.uint8), np.array(c1, np.uint8))
    return np.concatenate([img, np.full((size, size, 1), 255, np.uint8)], axis=-1)


def solid_texture(rgb, size=4) -> np.ndarray:
    img = np.zeros((size, size, 4), np.uint8)
    img[..., :3] = rgb
    img[..., 3] = 255
    return img


def bumpy_normal_texture(size=64, freq=4, strength=0.35) -> np.ndarray:
    y, x = np.mgrid[0:size, 0:size] / size
    dz_dx = strength * np.cos(2 * np.pi * freq * x) * 2 * np.pi * freq / size
    dz_dy = strength * np.cos(2 * np.pi * freq * y) * 2 * np.pi * freq / size
    n = np.stack([-dz_dx, -dz_dy, np.ones_like(dz_dx)], axis=-1)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    enc = ((n * 0.5 + 0.5) * 255).astype(np.uint8)
    # Stored with the convention the shader's green flip (forward.hlsl:108)
    # undoes: flip G here so the flip reproduces n.
    enc[..., 1] = 255 - enc[..., 1]
    return np.concatenate([enc, np.full((size, size, 1), 255, np.uint8)], axis=-1)


def mr_texture(metalness: float, roughness: float, size=4) -> np.ndarray:
    img = np.zeros((size, size, 4), np.uint8)
    img[..., 1] = int(roughness * 255)  # G = roughness (forward.hlsl:123)
    img[..., 2] = int(metalness * 255)  # B = metalness (forward.hlsl:117)
    img[..., 3] = 255
    return img


def gradient_environment(height=128, width=256, sun_dir=None) -> np.ndarray:
    """Simple HDR sky: horizon gradient + bright sun disk + dark ground."""
    v = (np.arange(height) + 0.5) / height
    u = (np.arange(width) + 0.5) / width
    uu, vv = np.meshgrid(u, v)
    # Equirect direction for texel (matches skybox.hlsl inverse mapping).
    theta = (uu - 0.5) / 0.1591
    phi = -(vv - 0.5) / 0.3183  # v was negated at sample time
    y = np.sin(phi)
    sky = np.clip(y, 0, 1)[..., None] * np.array([0.35, 0.55, 1.1]) + np.array(
        [0.45, 0.42, 0.4]
    )
    ground = np.array([0.12, 0.1, 0.08]) * (1.0 + 0 * y[..., None])
    env = np.where(y[..., None] >= 0, sky, ground)
    d = np.stack([np.cos(phi) * np.cos(theta), y, np.cos(phi) * np.sin(theta)], -1)
    if sun_dir is None:
        sun_dir = np.array([0.35, 0.8, 0.2])
    sun_dir = np.asarray(sun_dir) / np.linalg.norm(sun_dir)
    cos = np.clip(np.sum(d * sun_dir, axis=-1), 0, 1)
    env = env + (cos[..., None] ** 400) * np.array([60.0, 55.0, 45.0])
    return env.astype(np.float32)


# ----------------------------- scenes -------------------------------------


def cornell_like_scene():
    """Small test scene: open room, two boxes, a sphere — a few hundred tris."""
    materials = [
        MaterialImages(checker_texture(64, 8), bumpy_normal_texture(64), mr_texture(0.0, 0.8)),
        MaterialImages(solid_texture((200, 40, 40)), bumpy_normal_texture(16, 2, 0.0), mr_texture(0.0, 0.5)),
        MaterialImages(solid_texture((220, 220, 230)), bumpy_normal_texture(16, 2, 0.0), mr_texture(1.0, 0.25)),
    ]
    meshes = [
        plane_mesh(20.0, material=0, uv_scale=4.0),
        box_mesh(2.0, 3.0, 2.0, material=1),
        uv_sphere(1.2, 12, 18, material=2),
    ]
    objects = [
        (transform((0, 0, 0)), 0),
        (transform((-2.5, 1.5, -6.0), yaw_deg=20), 1),
        (transform((2.0, 1.2, -5.0)), 2),
    ]
    env = gradient_environment(64, 128)
    return meshes, objects, materials, env


def helmet_like_scene():
    """Single detailed hero object (SciFi/FlightHelmet-class): a dense
    normal-mapped, partly-metallic sphere cluster on a small stand —
    BASELINE configs[0]/[1] stand-in."""
    materials = [
        MaterialImages(
            checker_texture(128, 6, (120, 130, 150), (60, 62, 70)),
            bumpy_normal_texture(128, 12, 0.5),
            mr_texture(0.9, 0.35),
        ),
        MaterialImages(
            solid_texture((90, 60, 40), 8),
            bumpy_normal_texture(64, 6, 0.2),
            mr_texture(0.0, 0.7),
        ),
        MaterialImages(checker_texture(64, 8), bumpy_normal_texture(16, 2, 0.0), mr_texture(0.0, 0.9)),
    ]
    meshes = [
        uv_sphere(1.0, 48, 64, material=0),  # the "helmet"
        cylinder_mesh(1.2, 0.3, 32, material=1),  # stand
        plane_mesh(12.0, material=2, uv_scale=3.0),
    ]
    objects = [
        (transform((0.0, 1.6, -4.0)), 0),
        (transform((0.0, 0.0, -4.0)), 1),
        (transform((0.0, 0.0, -4.0)), 2),
    ]
    env = gradient_environment(128, 256)
    return meshes, objects, materials, env


def bilinear_upsample(g: np.ndarray, size: int) -> np.ndarray:
    """(f, f) -> (size, size) bilinear resample, texel centers aligned
    (src = (dst + 0.5) * f / size - 0.5), edges clamped."""
    f = g.shape[0]
    t = (np.arange(size, dtype=np.float32) + 0.5) * (f / size) - 0.5
    t = np.clip(t, 0.0, f - 1)
    i0 = np.minimum(np.floor(t).astype(np.int64), f - 1)
    i1 = np.minimum(i0 + 1, f - 1)
    w = (t - i0).astype(np.float32)
    rows = g[i0] * (1.0 - w)[:, None] + g[i1] * w[:, None]  # (size, f)
    return rows[:, i0] * (1.0 - w)[None, :] + rows[:, i1] * w[None, :]


def noisy_texture(size, rng, base=(160, 150, 130), amp=60, freqs=(4, 16, 64)) -> np.ndarray:
    """Multi-octave value-noise RGBA — content for reference-scale textures
    (every texel distinct, so no constant-slot elision kicks in)."""
    acc = np.zeros((size, size), np.float32)
    for f in freqs:
        g = rng.uniform(-1.0, 1.0, (f, f)).astype(np.float32)
        acc += bilinear_upsample(g, size) / len(freqs)
    img = np.zeros((size, size, 4), np.uint8)
    for c in range(3):
        img[..., c] = np.clip(base[c] + amp * acc * (0.7 + 0.15 * c), 0, 255)
    img[..., 3] = 255
    return img


def noisy_mr_texture(size, rng, metal=0.0, rough=0.6, amp=0.25) -> np.ndarray:
    """Spatially-varying metal-roughness map (G=rough, B=metal)."""
    r = noisy_texture(size, rng, base=(0, int(rough * 255), int(metal * 255)), amp=int(amp * 255))
    out = np.zeros_like(r)
    out[..., 1] = r[..., 1]
    out[..., 2] = r[..., 2]
    out[..., 3] = 255
    return out


def textured_materials(n_materials: int, texture_size: int, rng_seed=11):
    """n reference-scale materials: diffuse/normal/MR at texture_size^2 each
    (the load renderer.cpp:475-553 creates — three full textures uploaded
    per material). All three slots spatially vary, so neither the nm/mr
    constant elision nor the white-fallback path shrinks the working set."""
    rng = np.random.default_rng(rng_seed)
    mats = []
    palette = [
        (188, 165, 130), (170, 150, 140), (190, 180, 160), (160, 60, 50),
        (90, 110, 150), (120, 140, 90), (200, 190, 120), (110, 90, 80),
    ]
    for i in range(n_materials):
        base = palette[i % len(palette)]
        mats.append(
            MaterialImages(
                diffuse=noisy_texture(texture_size, rng, base=base),
                normal=bumpy_normal_texture(
                    texture_size, freq=4 + (i % 5) * 7, strength=0.25 + 0.05 * (i % 4)
                ),
                metal_roughness=noisy_mr_texture(
                    texture_size, rng,
                    metal=(i % 4) * 0.3, rough=0.3 + (i % 5) * 0.15,
                ),
            )
        )
    return mats


def sponza_like_scene(columns=14, rng_seed=7, texture_size=None, n_materials=24):
    """Benchmark scene with Sponza-scale structure (~0.26M triangles).

    A two-story colonnade hall: floor, walls, ceiling strips, two rows of
    fluted columns, hanging drapes (boxes), scattered clutter spheres. The
    point is matching the *load*: triangle count, many materials, large and
    small screen-space triangles, heavy occlusion.

    ``texture_size`` (e.g. 1024) switches to ``n_materials`` reference-scale
    materials (three texture_size^2 maps each — the real Khronos Sponza's
    texture load) assigned round-robin across object
    instances; geometry is unchanged so benchmarks isolate the texture cost.
    """
    rng = np.random.default_rng(rng_seed)
    materials = [
        MaterialImages(checker_texture(256, 16, (188, 165, 130), (120, 100, 80)), bumpy_normal_texture(256, 24, 0.2), mr_texture(0.0, 0.7)),  # floor
        MaterialImages(checker_texture(128, 4, (170, 150, 140), (150, 130, 115)), bumpy_normal_texture(128, 8, 0.3), mr_texture(0.0, 0.9)),  # walls
        MaterialImages(solid_texture((190, 180, 160), 16), bumpy_normal_texture(128, 32, 0.4), mr_texture(0.0, 0.6)),  # columns
        MaterialImages(solid_texture((160, 30, 30), 16), bumpy_normal_texture(32, 4, 0.1), mr_texture(0.0, 0.4)),  # drapes
        MaterialImages(solid_texture((230, 210, 90), 16), bumpy_normal_texture(16, 2, 0.0), mr_texture(1.0, 0.3)),  # brass clutter
        MaterialImages(checker_texture(64, 2, (90, 90, 100), (70, 70, 80)), bumpy_normal_texture(64, 4, 0.1), mr_texture(0.2, 0.5)),  # ceiling
    ]
    hall_l, hall_w, hall_h = 36.0, 14.0, 10.0
    meshes = [
        plane_mesh(1.0, material=0, uv_scale=12.0),  # 0 floor (scaled per object)
        box_mesh(1.0, 1.0, 1.0, material=1),  # 1 wall segment
        cylinder_mesh(0.45, 5.0, 48, material=2),  # 2 column shaft (high-poly)
        uv_sphere(1.0, 32, 48, material=4),  # 3 clutter sphere
        box_mesh(1.0, 1.0, 0.08, material=3),  # 4 drape
        plane_mesh(1.0, material=5, uv_scale=8.0),  # 5 ceiling
        uv_sphere(0.5, 48, 64, material=2),  # 6 column capital (dense)
    ]
    objects = []
    objects.append((transform((0, 0, 0), scale=(hall_l, 1, hall_w)), 0))
    # ceiling (flip via scale so faces point down)
    objects.append((transform((0, hall_h, 0), scale=(hall_l, -1, hall_w)), 5))
    # side walls
    for zs in (-1, 1):
        objects.append(
            (transform((0, hall_h / 2, zs * hall_w / 2), scale=(hall_l, hall_h, 0.3)), 1)
        )
    for xs in (-1, 1):
        objects.append(
            (transform((xs * hall_l / 2, hall_h / 2, 0), scale=(0.3, hall_h, hall_w)), 1)
        )
    # column rows with capitals
    xs = np.linspace(-hall_l / 2 + 3, hall_l / 2 - 3, columns)
    for x in xs:
        for z in (-hall_w / 2 + 2.5, hall_w / 2 - 2.5):
            objects.append((transform((x, 0, z)), 2))
            objects.append((transform((x, 5.2, z)), 6))
            objects.append((transform((x, 5.0, z), scale=(0.6, 10.4, 0.6)), 2))
    # drapes between upper columns
    for x in xs[:-1]:
        for z in (-hall_w / 2 + 1.2, hall_w / 2 - 1.2):
            objects.append((transform((x + 1.2, 7.0, z), scale=(2.0, 3.5, 1.0)), 4))
    # clutter spheres
    for _ in range(24):
        x = rng.uniform(-hall_l / 2 + 2, hall_l / 2 - 2)
        z = rng.uniform(-hall_w / 2 + 2, hall_w / 2 - 2)
        r = rng.uniform(0.3, 0.9)
        objects.append((transform((x, r, z), scale=(r, r, r)), 3))
    env = gradient_environment(256, 512)

    if texture_size:
        # Reference-scale texture load: swap in n_materials heavyweight
        # materials and spread them across instances. Mesh material ids are
        # per-mesh, so clone (mesh, material) variants as objects need them.
        materials = textured_materials(n_materials, texture_size)
        variants = {}
        new_meshes = []
        new_objects = []
        for k, (trs, mesh_idx) in enumerate(objects):
            mat = k % n_materials
            key = (mesh_idx, mat)
            if key not in variants:
                m = meshes[mesh_idx]
                variants[key] = len(new_meshes)
                new_meshes.append(
                    MeshData(
                        positions=m.positions, normals=m.normals, uvs=m.uvs,
                        indices=m.indices, material=mat,
                        tangents=m.tangents, bitangents=m.bitangents,
                    )
                )
            new_objects.append((trs, variants[key]))
        meshes, objects = new_meshes, new_objects
    return meshes, objects, materials, env
