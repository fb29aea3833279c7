"""Golden reference renderer: independent numpy implementation of the
reference's pixel pipeline, used as the PSNR oracle (SURVEY.md §4).

Written directly from the D3D12/HLSL semantics (not from arctic_tpu.ops) so
the two implementations can check each other:
- per-triangle scanline rasterization in float64 with Sutherland-Hodgman
  near clipping, D3D viewport transform, top-left fill rule, LESS depth
- forward.hlsl shading (ps_main) with literal 25-tap PCF SampleLevel calls
- skybox.hlsl equirect background, post_process.hlsl tonemap chain
- R16G16B16A16_FLOAT storage rounding and UNORM8 conversion

Textures are sampled straight from each material's images (no atlas), so the
atlas/addressing machinery of the production path is cross-checked too.
Deliberately slow (Python triangle loop) — use small frames.
"""

from __future__ import annotations

import numpy as np

PI = 3.14159265


# --------------------------- matrices (independent) ------------------------


def _look_at(eye, center, up):
    eye = np.asarray(eye, np.float64)
    f = np.asarray(center, np.float64) - eye
    f /= np.linalg.norm(f)
    s = np.cross(f, np.asarray(up, np.float64))
    s /= np.linalg.norm(s)
    u = np.cross(s, f)
    m = np.eye(4)
    m[0, :3], m[1, :3], m[2, :3] = s, u, -f
    m[0, 3], m[1, 3], m[2, 3] = -s @ eye, -u @ eye, f @ eye
    return m


def _dir_from_rot(rot):
    x, y = np.radians(rot[0]), np.radians(rot[1])
    return np.array([np.cos(x) * np.cos(y), np.sin(x), np.cos(x) * np.sin(y)])


def camera_proj_view(eye, rot, aspect, fov_y, z_near, z_far):
    t = np.tan(np.radians(fov_y) / 2)
    p = np.zeros((4, 4))
    p[0, 0] = 1 / (aspect * t)
    p[1, 1] = 1 / t
    p[2, 2] = z_far / (z_near - z_far)
    p[2, 3] = -z_far * z_near / (z_far - z_near)
    p[3, 2] = -1
    eye = np.asarray(eye, np.float64)
    return p @ _look_at(eye, eye + _dir_from_rot(rot), [0, 1, 0])


def sun_proj_view(position, rot):
    l, r, b, t, n, f = -16.0, 16.0, -16.0, 16.0, 0.1, 50.0
    p = np.eye(4)
    p[0, 0] = 2 / (r - l)
    p[1, 1] = 2 / (t - b)
    p[2, 2] = -1 / (f - n)
    p[2, 3] = -n / (f - n)
    position = np.asarray(position, np.float64)
    return p @ _look_at(position, position + _dir_from_rot(rot), [0, 1, 0])


# --------------------------- rasterizer ------------------------------------


def _clip_near(poly):
    """Sutherland-Hodgman against clip z >= 0; poly is a list of dicts with
    'clip' (4,) and 'bary' (3,)."""
    out = []
    n = len(poly)
    for i in range(n):
        a, b = poly[i], poly[(i + 1) % n]
        za, zb = a["clip"][2], b["clip"][2]
        if za >= 0:
            out.append(a)
        if (za >= 0) != (zb >= 0):
            t = za / (za - zb)
            out.append(
                {
                    "clip": a["clip"] + t * (b["clip"] - a["clip"]),
                    "bary": a["bary"] + t * (b["bary"] - a["bary"]),
                }
            )
    return out


def rasterize(world_tris, pv, width, height, cull):
    """world_tris: (T, 3, 3) float64. Returns (zbuf, tri_id, bary3) where
    bary3 (H, W, 3) are barycentrics over the original triangle corners."""
    zbuf = np.ones((height, width))
    tid = np.full((height, width), -1, np.int64)
    bary = np.zeros((height, width, 3))

    for t in range(len(world_tris)):
        poly = []
        for c in range(3):
            clip = pv @ np.append(world_tris[t, c], 1.0)
            b = np.zeros(3)
            b[c] = 1.0
            poly.append({"clip": clip, "bary": b})
        poly = _clip_near(poly)
        if len(poly) < 3:
            continue
        for k in range(1, len(poly) - 1):
            corners = [poly[0], poly[k], poly[k + 1]]
            sx = np.empty(3)
            sy = np.empty(3)
            sz = np.empty(3)
            sw = np.empty(3)
            for c in range(3):
                cl = corners[c]["clip"]
                w = cl[3]
                sx[c] = np.round((cl[0] / w + 1) * width / 2 * 16) / 16
                sy[c] = np.round((1 - cl[1] / w) * height / 2 * 16) / 16
                sz[c] = cl[2] / w
                sw[c] = w
            area2 = (sx[1] - sx[0]) * (sy[2] - sy[0]) - (sx[2] - sx[0]) * (sy[1] - sy[0])
            if area2 == 0:
                continue
            if cull == "back" and area2 >= 0:
                continue
            if cull == "front" and area2 <= 0:
                continue
            x0 = max(int(np.floor(min(sx) - 0.5)), 0)
            x1 = min(int(np.ceil(max(sx) + 0.5)), width)
            y0 = max(int(np.floor(min(sy) - 0.5)), 0)
            y1 = min(int(np.ceil(max(sy) + 0.5)), height)
            if x0 >= x1 or y0 >= y1:
                continue
            px, py = np.meshgrid(
                np.arange(x0, x1) + 0.5, np.arange(y0, y1) + 0.5
            )
            s = -1.0 if area2 < 0 else 1.0
            es = []
            for i in range(3):
                ax, ay = sx[(i + 1) % 3], sy[(i + 1) % 3]
                bx, by = sx[(i + 2) % 3], sy[(i + 2) % 3]
                a_c = -s * (by - ay)
                b_c = s * (bx - ax)
                c_c = s * ((by - ay) * ax - (bx - ax) * ay)
                e = a_c * px + b_c * py + c_c
                # top-left rule: include boundary on top (A==0, B>0) / left
                # (A>0) edges.
                top_left = (a_c == 0 and b_c > 0) or a_c > 0
                es.append(e > 0 if not top_left else e >= 0)
                if i == 0:
                    e_vals = [e]
                else:
                    e_vals.append(e)
            inside = es[0] & es[1] & es[2]
            if not inside.any():
                continue
            inv = 1.0 / abs(area2)
            b0 = e_vals[0] * inv
            b1 = e_vals[1] * inv
            b2 = e_vals[2] * inv
            z = b0 * sz[0] + b1 * sz[1] + b2 * sz[2]
            ok = inside & (z >= 0) & (z <= 1) & (z < zbuf[y0:y1, x0:x1])
            if not ok.any():
                continue
            # perspective-correct barys over the clipped corners, then
            # compose to original-corner weights
            bw0, bw1, bw2 = b0 / sw[0], b1 / sw[1], b2 / sw[2]
            den = bw0 + bw1 + bw2
            u0, u1, u2 = bw0 / den, bw1 / den, bw2 / den
            borig = (
                u0[..., None] * corners[0]["bary"]
                + u1[..., None] * corners[1]["bary"]
                + u2[..., None] * corners[2]["bary"]
            )
            zb = zbuf[y0:y1, x0:x1]
            zb[ok] = z[ok]
            tb = tid[y0:y1, x0:x1]
            tb[ok] = t
            bb = bary[y0:y1, x0:x1]
            bb[ok] = borig[ok]
    return zbuf, tid, bary


# --------------------------- sampling --------------------------------------


def _bilinear_wrap(tex, u, v):
    """tex (h, w, c) float; u, v arrays; D3D linear+wrap sampling."""
    h, w = tex.shape[:2]
    tx = u * w - 0.5
    ty = v * h - 0.5
    ix = np.floor(tx).astype(np.int64)
    iy = np.floor(ty).astype(np.int64)
    fx = (tx - ix)[..., None]
    fy = (ty - iy)[..., None]
    c00 = tex[iy % h, ix % w]
    c10 = tex[iy % h, (ix + 1) % w]
    c01 = tex[(iy + 1) % h, ix % w]
    c11 = tex[(iy + 1) % h, (ix + 1) % w]
    top = c00 + (c10 - c00) * fx
    bot = c01 + (c11 - c01) * fx
    return top + (bot - top) * fy


def _srgb(c):
    return np.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)


# --------------------------- shading ---------------------------------------


def _radiance(n, wo, wi, ingoing, base, metal, rough):
    h = wo + wi
    h = h / np.maximum(np.linalg.norm(h, axis=-1, keepdims=True), 1e-20)
    f0 = 0.04 + (base - 0.04) * metal[..., None]
    hdwo = np.maximum(np.sum(h * wo, -1), 0.0)[..., None]
    fres = f0 + (1 - f0) * np.clip(1 - hdwo, 0, 1) ** 5
    a2 = rough**4
    ndh = np.maximum(np.sum(n * h, -1), 0.0)
    ndf = a2 / (PI * (ndh * ndh * (a2 - 1) + 1) ** 2)
    k = (rough + 1) ** 2 / 8
    ndwo = np.maximum(np.sum(n * wo, -1), 0.0)
    ndwi = np.maximum(np.sum(n * wi, -1), 0.0)
    geo = (ndwo / (ndwo * (1 - k) + k)) * (ndwi / (ndwi * (1 - k) + k))
    spec = (ndf * geo)[..., None] * fres / (4 * ndwo * ndwi + 1e-4)[..., None]
    kd = (1 - fres) * (1 - metal[..., None])
    return (kd * base / PI + spec) * ingoing * ndwi[..., None]


def render(
    scene_tris,  # dict of flat per-corner numpy arrays (see golden_scene)
    materials,  # list of dicts: diffuse/normal/mr as float linear (h,w,c)
    env,  # (h, w, 3) float
    camera,  # dict: eye, rotation, aspect, fov_y, z_near, z_far
    sun,  # dict: position, rotation, color
    point_lights,  # list of (pos, color)
    ambient,
    settings,  # dict: tm_method, gamma, exposure
    width,
    height,
    shadow_size=256,
):
    pv = camera_proj_view(
        camera["eye"], camera["rotation"], camera["aspect"], camera["fov_y"],
        camera["z_near"], camera["z_far"],
    )
    sun_pv = sun_proj_view(sun["position"], sun["rotation"])

    tris_world = scene_tris["world"]  # (T, 3, 3)
    shadow_z, _, _ = rasterize(tris_world, sun_pv, shadow_size, shadow_size, cull="front")
    zbuf, tid, bary = rasterize(tris_world, pv, width, height, cull="back")
    covered = tid >= 0

    t = np.maximum(tid, 0)
    b = bary  # (H, W, 3)

    def interp(attr):  # attr (T, 3, C)
        return np.einsum("hwc,hwck->hwk", b, attr[t])

    wp = interp(scene_tris["world"])
    n_v = interp(scene_tris["normal"])
    t_v = interp(scene_tris["tangent"])
    b_v = interp(scene_tris["bitangent"])
    uv = interp(scene_tris["uv"])
    mat = scene_tris["material"][t]

    base_color = np.zeros((height, width, 3))
    nm = np.zeros((height, width, 3))
    mr = np.zeros((height, width, 4))
    for mi, m in enumerate(materials):
        sel = mat == mi
        if not sel.any():
            continue
        u, v = uv[sel, 0], uv[sel, 1]
        base_color[sel] = _bilinear_wrap(m["diffuse"], u, v)[:, :3]
        nm[sel] = _bilinear_wrap(m["normal"], u, v)[:, :3]
        mr[sel] = _bilinear_wrap(m["mr"], u, v)[:, :4]

    nm[..., 1] = 1.0 - nm[..., 1]
    nm = nm * 2.0 - 1.0
    n = t_v * nm[..., 0:1] + b_v * nm[..., 1:2] + n_v * nm[..., 2:3]
    n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-20)
    metal = mr[..., 2]
    rough = mr[..., 1]

    # 25-tap PCF, literal translation of calculate_shadow.
    lsp = np.einsum("ij,hwj->hwi", sun_pv, np.concatenate([wp, np.ones((height, width, 1))], -1))
    proj = lsp[..., :3] / lsp[..., 3:4]
    su = proj[..., 0] * 0.5 + 0.5
    sv = 1.0 - (proj[..., 1] * 0.5 + 0.5)
    sz = proj[..., 2]
    outside = (sz > 1) | (su < 0) | (sv < 0) | (su > 1) | (sv > 1)
    shadow = np.zeros((height, width))
    smap = shadow_z[..., None]
    for i in range(-2, 3):
        for j in range(-2, 3):
            closest = _bilinear_wrap(smap, su + i * 1e-4, sv + j * 1e-4)[..., 0]
            shadow += (sz > closest).astype(np.float64)
    shadow = np.where(outside, 0.0, shadow / 25.0)
    lit = (1.0 - shadow)[..., None]

    eye = np.asarray(camera["eye"], np.float64)
    wo = eye - wp
    wo /= np.maximum(np.linalg.norm(wo, axis=-1, keepdims=True), 1e-20)
    sun_dir = _dir_from_rot(sun["rotation"])
    lo = lit * _radiance(n, wo, -sun_dir, np.asarray(sun["color"]), base_color, metal, rough)
    for light in point_lights:
        lpos, lcol = light[0], light[1]
        ldir = np.asarray(lpos) - wp
        dist = np.maximum(np.linalg.norm(ldir, axis=-1), 1e-12)
        wi = ldir / dist[..., None]
        rad = np.asarray(lcol) / (dist * dist)[..., None]
        if len(light) > 2 and light[2] is not None:
            # Spotlight cone (opt-in; core/scene.py packing semantics):
            # (axis, inner_deg, outer_deg) -> clamp((cosθ - outer)/(inner
            # - outer), 0, 1) on the light-to-fragment angle.
            axis, inner_deg, outer_deg = light[2]
            axis = np.asarray(axis, np.float64)
            axis /= max(np.linalg.norm(axis), 1e-12)
            inner_c = np.cos(np.radians(inner_deg))
            outer_c = np.cos(np.radians(outer_deg))
            cos_t = -np.sum(wi * axis, axis=-1)
            fac = np.clip(
                (cos_t - outer_c) / max(inner_c - outer_c, 1e-4), 0.0, 1.0
            )
            rad = rad * fac[..., None]
        lo += lit * _radiance(n, wo, wi, rad, base_color, metal, rough)
    color = lo + ambient * base_color

    # Skybox background.
    xs = (np.arange(width) + 0.5) / width * 2 - 1
    ys = 1 - (np.arange(height) + 0.5) / height * 2
    xg, yg = np.meshgrid(xs, ys)
    tf = np.tan(np.radians(camera["fov_y"]) / 2)
    dv = np.stack([xg * camera["aspect"] * tf, yg * tf, -np.ones_like(xg)], -1)
    view = _look_at(eye, eye + _dir_from_rot(camera["rotation"]), [0, 1, 0])
    dirs = np.einsum("ji,hwj->hwi", view[:3, :3], dv)
    d = dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)
    eu = np.arctan2(d[..., 2], d[..., 0]) * 0.1591 + 0.5
    ev = -(np.arcsin(np.clip(d[..., 1], -1, 1)) * 0.3183 + 0.5)
    sky = _bilinear_wrap(env, eu, ev)
    hdr = np.where(covered[..., None], color, sky)

    hdr = hdr.astype(np.float16).astype(np.float64)  # RGBA16F storage

    tm = settings["tm_method"]
    if tm == 1:
        mapped = 1 - np.exp(-hdr * settings["exposure"])
    elif tm == 2:
        inp = np.array(
            [[0.59719, 0.35458, 0.04823], [0.076, 0.90834, 0.01566], [0.0284, 0.13383, 0.837]]
        )
        outm = np.array(
            [[1.60475, -0.53108, -0.07367], [-0.10208, 1.10813, -0.00605], [-0.00327, -0.07276, 1.07]]
        )
        c = np.einsum("ij,hwj->hwi", inp, hdr)
        a = c * (c + 0.0245786) - 0.000090537
        bq = c * (0.983729 * c + 0.4329510) + 0.238081
        mapped = np.clip(np.einsum("ij,hwj->hwi", outm, a / bq), 0, 1)
    else:
        mapped = hdr / (hdr + 1)
    ldr = np.abs(mapped) ** (1.0 / settings["gamma"])
    return np.round(np.clip(ldr, 0, 1) * 255).astype(np.uint8)


def golden_scene(meshes, objects, materials_imgs):
    """Expand (meshes, objects, materials) into per-corner triangle arrays
    + float material images for render()."""
    from arctic_tpu.io.build import compute_tangents

    world_l, n_l, t_l, b_l, uv_l, m_l = [], [], [], [], [], []
    for trs, mesh_idx in objects:
        m = meshes[mesh_idx]
        tan, btn = m.tangents, m.bitangents
        if tan is None or btn is None:
            tan, btn = compute_tangents(m.positions, m.normals, m.uvs, m.indices)

        def nrm(a):
            return a / np.maximum(np.linalg.norm(a, axis=-1, keepdims=True), 1e-20)

        ph = np.concatenate([m.positions, np.ones((len(m.positions), 1))], 1)
        wp = (np.asarray(trs, np.float64) @ ph.T).T[:, :3]
        idx = m.indices
        world_l.append(wp[idx])
        n_l.append(nrm(m.normals.astype(np.float64))[idx])
        t_l.append(nrm(tan.astype(np.float64))[idx])
        b_l.append(nrm(btn.astype(np.float64))[idx])
        uv_l.append(m.uvs.astype(np.float64)[idx])
        m_l.append(np.full(len(idx), m.material, np.int64))

    tris = {
        "world": np.concatenate(world_l),
        "normal": np.concatenate(n_l),
        "tangent": np.concatenate(t_l),
        "bitangent": np.concatenate(b_l),
        "uv": np.concatenate(uv_l),
        "material": np.concatenate(m_l),
    }
    mats = []
    for mi in materials_imgs:
        d = mi.diffuse.astype(np.float64) / 255.0
        d[..., :3] = _srgb(d[..., :3])
        mats.append(
            {
                "diffuse": d,
                "normal": mi.normal.astype(np.float64) / 255.0,
                "mr": mi.metal_roughness.astype(np.float64) / 255.0,
            }
        )
    return tris, mats
