"""Minimal glTF 2.0 loader (JSON + GLB), replacing Assimp's ReadFile path.

Reproduces the reference's import semantics (App::load_scene, app.cpp:173-385):
- triangulated primitives only (glTF is already triangles; mode 4)
- FlipUVs: v -> 1 - v (aiProcess_FlipUVs, app.cpp:179)
- tangent space from the file's TANGENT accessor when present, else computed
  (aiProcess_CalcTangentSpace) in io/build.py
- per-material textures: baseColor -> diffuse slot, normalTexture -> normal,
  metallicRoughnessTexture -> metal-roughness; missing maps use the white /
  flat-normal fallbacks (app.cpp:208-245)
- node hierarchy flattened to world TRS per mesh instance via an explicit
  stack walk (app.cpp:358-382)

No external glTF library exists in this image; this is a from-scratch parser
covering the subset the sample assets use plus sparse accessors
(§3.6.2.3); no skins, animations, or Draco.
"""

from __future__ import annotations

import base64
import json
import logging
import os
import struct
from dataclasses import dataclass

import numpy as np

log = logging.getLogger("arctic.gltf")

# Extensions this loader implements. Anything an asset lists in
# `extensionsRequired` that is NOT here would be silently mis-parsed (e.g.
# KHR_draco_mesh_compression geometry would read as garbage bytes), so the
# loader fails loudly instead — the behavior Assimp gives the reference
# (ReadFile returns null and App::load_scene aborts, app.cpp:177-185).
SUPPORTED_EXTENSIONS: frozenset = frozenset()

# glTF primitive.mode names for diagnostics (§3.7.2.1).
_MODE_NAMES = {
    0: "POINTS", 1: "LINES", 2: "LINE_LOOP", 3: "LINE_STRIP",
    4: "TRIANGLES", 5: "TRIANGLE_STRIP", 6: "TRIANGLE_FAN",
}


class GltfUnsupportedError(RuntimeError):
    """A required glTF feature this loader does not implement."""

from arctic_tpu.io.build import MaterialImages, MeshData, fallback_diffuse, fallback_normal
from arctic_tpu.io.images import decode_image, load_ldr

_COMPONENT_DTYPE = {
    5120: np.int8,
    5121: np.uint8,
    5122: np.int16,
    5123: np.uint16,
    5125: np.uint32,
    5126: np.float32,
}
_TYPE_COUNT = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4, "MAT4": 16}


@dataclass
class _Gltf:
    doc: dict
    buffers: list
    base_dir: str


def _load_container(path: str) -> _Gltf:
    base_dir = os.path.dirname(os.path.abspath(path))
    with open(path, "rb") as f:
        blob = f.read()
    if blob[:4] == b"glTF":  # GLB container
        _, _, _length = struct.unpack("<4sII", blob[:12])
        off = 12
        doc = None
        bin_chunk = None
        while off < len(blob):
            clen, ctype = struct.unpack_from("<I4s", blob, off)
            data = blob[off + 8 : off + 8 + clen]
            if ctype == b"JSON":
                doc = json.loads(data)
            elif ctype == b"BIN\x00":
                bin_chunk = data
            off += 8 + clen
        gltf = _Gltf(doc=doc, buffers=[], base_dir=base_dir)
        for buf in doc.get("buffers", []):
            if "uri" not in buf:
                gltf.buffers.append(bin_chunk)
            else:
                gltf.buffers.append(_load_uri(buf["uri"], base_dir))
        return gltf
    doc = json.loads(blob)
    gltf = _Gltf(doc=doc, buffers=[], base_dir=base_dir)
    for buf in doc.get("buffers", []):
        gltf.buffers.append(_load_uri(buf["uri"], base_dir))
    return gltf


def _load_uri(uri: str, base_dir: str) -> bytes:
    if uri.startswith("data:"):
        return base64.b64decode(uri.split(",", 1)[1])
    from urllib.parse import unquote

    with open(os.path.join(base_dir, unquote(uri)), "rb") as f:
        return f.read()


def _read_view(
    gltf: _Gltf, view_idx: int, byte_offset: int, n: int, ncomp: int, dtype
) -> np.ndarray:
    """Dense (n, ncomp) read from a bufferView (honors byteStride)."""
    bv = gltf.doc["bufferViews"][view_idx]
    buf = gltf.buffers[bv["buffer"]]
    itemsize = np.dtype(dtype).itemsize
    start = bv.get("byteOffset", 0) + byte_offset
    stride = bv.get("byteStride", ncomp * itemsize)
    if stride == ncomp * itemsize:
        return np.frombuffer(buf, dtype, count=n * ncomp, offset=start).reshape(n, ncomp)
    raw = np.frombuffer(buf, np.uint8, count=(n - 1) * stride + ncomp * itemsize, offset=start)
    strided = np.lib.stride_tricks.as_strided(
        raw, shape=(n, ncomp * itemsize), strides=(stride, 1)
    )
    return strided.copy().view(dtype).reshape(n, ncomp)


def _accessor(gltf: _Gltf, idx: int) -> np.ndarray:
    acc = gltf.doc["accessors"][idx]
    n = acc["count"]
    ncomp = _TYPE_COUNT[acc["type"]]
    dtype = _COMPONENT_DTYPE[acc["componentType"]]
    if "bufferView" not in acc:
        out = np.zeros((n, ncomp), dtype)
    else:
        out = _read_view(gltf, acc["bufferView"], acc.get("byteOffset", 0), n, ncomp, dtype)
    if "sparse" in acc:
        # glTF 2.0 §3.6.2.3: base (zeros when no bufferView) with `count`
        # elements substituted at `indices` from `values`.
        sp = acc["sparse"]
        sn = sp["count"]
        sidx = _read_view(
            gltf,
            sp["indices"]["bufferView"],
            sp["indices"].get("byteOffset", 0),
            sn,
            1,
            _COMPONENT_DTYPE[sp["indices"]["componentType"]],
        ).reshape(sn).astype(np.int64)
        svals = _read_view(
            gltf, sp["values"]["bufferView"], sp["values"].get("byteOffset", 0),
            sn, ncomp, dtype,
        )
        out = out.copy()
        out[sidx] = svals
    if acc.get("normalized") and dtype in (np.uint8, np.uint16):
        out = out.astype(np.float32) / np.iinfo(dtype).max
    return out


def _image_for_texture(gltf: _Gltf, tex_index: int) -> np.ndarray:
    tex = gltf.doc["textures"][tex_index]
    img = gltf.doc["images"][tex["source"]]
    if "uri" in img:
        uri = img["uri"]
        if uri.startswith("data:"):
            return decode_image(base64.b64decode(uri.split(",", 1)[1]))
        return load_ldr(os.path.join(gltf.base_dir, uri))
    bv = gltf.doc["bufferViews"][img["bufferView"]]
    raw = gltf.buffers[bv["buffer"]][
        bv.get("byteOffset", 0) : bv.get("byteOffset", 0) + bv["byteLength"]
    ]
    return decode_image(bytes(raw))


def _node_trs(node: dict) -> np.ndarray:
    if "matrix" in node:
        return np.asarray(node["matrix"], np.float32).reshape(4, 4).T  # column-major file
    m = np.eye(4, dtype=np.float32)
    s = np.asarray(node.get("scale", [1, 1, 1]), np.float32)
    q = node.get("rotation", [0, 0, 0, 1])  # gltf xyzw
    x, y, z, w = q
    r = np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ],
        np.float32,
    )
    m[:3, :3] = r * s[None, :]
    m[:3, 3] = node.get("translation", [0, 0, 0])
    return m


def load_gltf(path: str):
    """-> (meshes, objects, materials) in io/build.py terms.

    Each glTF primitive becomes one MeshData; each node-mesh instance becomes
    one object per primitive.
    """
    gltf = _load_container(path)
    doc = gltf.doc

    # Fail-fast on assets we would otherwise mis-parse silently: a required
    # extension (Draco compression, mesh quantization, ...) changes how the
    # buffers themselves decode.
    required = [
        e for e in doc.get("extensionsRequired", []) if e not in SUPPORTED_EXTENSIONS
    ]
    if required:
        raise GltfUnsupportedError(
            f"{path}: asset requires unsupported glTF extensions "
            f"{required} (extensionsRequired); refusing to mis-parse it"
        )
    used = [e for e in doc.get("extensionsUsed", []) if e not in SUPPORTED_EXTENSIONS]
    if used:
        # Optional extensions degrade gracefully per spec — warn, don't fail.
        log.warning("%s: ignoring optional glTF extensions %s", path, used)

    materials = []
    for mat in doc.get("materials", [{}] ):
        pbr = mat.get("pbrMetallicRoughness", {})
        if "baseColorTexture" in pbr:
            diffuse = _image_for_texture(gltf, pbr["baseColorTexture"]["index"])
        else:
            # Missing diffuse -> white fallback (app.cpp:214). Note the
            # reference ignores baseColorFactor entirely (no factor support
            # in its importer path) — we match that.
            diffuse = fallback_diffuse()
        if "normalTexture" in mat:
            normal = _image_for_texture(gltf, mat["normalTexture"]["index"])
        else:
            normal = fallback_normal()
        if "metallicRoughnessTexture" in pbr:
            mr = _image_for_texture(gltf, pbr["metallicRoughnessTexture"]["index"])
        else:
            mr = fallback_diffuse()  # white: metal=1, rough=1 (app.cpp:244)
        materials.append(MaterialImages(diffuse=diffuse, normal=normal, metal_roughness=mr))
    if not materials:
        materials.append(
            MaterialImages(fallback_diffuse(), fallback_normal(), fallback_diffuse())
        )

    meshes = []  # flattened primitives
    prim_index = {}  # (mesh_idx, prim_idx) -> flat index
    for mi, mesh in enumerate(doc.get("meshes", [])):
        for pi, prim in enumerate(mesh["primitives"]):
            mode = prim.get("mode", 4)
            if mode != 4:
                # Non-triangle primitives aren't rendered (the reference only
                # draws aiProcess_Triangulate output) — but say so: dropping
                # geometry silently violates the fail-loud error philosophy
                # (utils/errors.py).
                log.warning(
                    "%s: skipping mesh %d primitive %d with mode %d (%s) — "
                    "only TRIANGLES are rendered",
                    path, mi, pi, mode, _MODE_NAMES.get(mode, "unknown"),
                )
                continue
            attrs = prim["attributes"]
            pos = _accessor(gltf, attrs["POSITION"]).astype(np.float32)
            n = len(pos)
            if "NORMAL" in attrs:
                nrm = _accessor(gltf, attrs["NORMAL"]).astype(np.float32)
            else:
                nrm = np.tile([0.0, 1.0, 0.0], (n, 1)).astype(np.float32)
            if "TEXCOORD_0" in attrs:
                uv = _accessor(gltf, attrs["TEXCOORD_0"]).astype(np.float32)[:, :2].copy()
                # FlipUVs applies to existing channels only; a missing channel
                # stays (0, 0) like the reference's mTextureCoords fallback
                # (app.cpp:330-340 + aiProcess_FlipUVs).
                uv[:, 1] = 1.0 - uv[:, 1]
            else:
                uv = np.zeros((n, 2), np.float32)
            if "indices" in prim:
                idx = _accessor(gltf, prim["indices"]).astype(np.int64).reshape(-1, 3)
            else:
                idx = np.arange(n, dtype=np.int64).reshape(-1, 3)
            tangents = bitangents = None
            if "TANGENT" in attrs:
                t4 = _accessor(gltf, attrs["TANGENT"]).astype(np.float32)
                tangents = t4[:, :3]
                bitangents = np.cross(nrm, tangents) * t4[:, 3:4]
            prim_index[(mi, pi)] = len(meshes)
            meshes.append(
                MeshData(
                    positions=pos,
                    normals=nrm,
                    uvs=uv,
                    indices=idx.astype(np.int32),
                    material=prim.get("material", 0),
                    tangents=tangents,
                    bitangents=bitangents,
                )
            )

    # Flatten the node hierarchy (stack walk like app.cpp:358-382).
    objects = []
    scene = doc.get("scenes", [{}])[doc.get("scene", 0)]
    stack = [(root, np.eye(4, dtype=np.float32)) for root in scene.get("nodes", [])]
    nodes = doc.get("nodes", [])
    while stack:
        node_idx, parent = stack.pop()
        node = nodes[node_idx]
        trs = parent @ _node_trs(node)
        for child in node.get("children", []):
            stack.append((child, trs))
        if "mesh" in node:
            for pi in range(len(doc["meshes"][node["mesh"]]["primitives"])):
                flat = prim_index.get((node["mesh"], pi))
                if flat is not None:
                    objects.append((trs, flat))
    return meshes, objects, materials
