"""Builds a GLB fixture in memory exercising what real Khronos assets use
(the loader is otherwise only tested on a 2-triangle synthetic
file): multi-primitive meshes, nested node TRS (matrix AND T/R/S nodes),
shared meshes across nodes, interleaved vertex buffers, normalized u16
texcoords, u16 + u32 indices, an embedded (bufferView) PNG texture and a
data-URI PNG texture, TANGENT present on one primitive and absent on another.

The builder returns both the GLB bytes and the ground-truth numpy data so
tests can assert the loader's output exactly (loader->oracle comparisons
alone would let loader bugs cancel out).
"""

from __future__ import annotations

import base64
import io
import json
import struct

import numpy as np


def _png_bytes(img: np.ndarray) -> bytes:
    from PIL import Image

    b = io.BytesIO()
    Image.fromarray(img).save(b, format="PNG")
    return b.getvalue()


def checker_rgba(size=16, tiles=4, c0=(220, 60, 60), c1=(240, 230, 200)) -> np.ndarray:
    y, x = np.mgrid[0:size, 0:size]
    t = ((y * tiles // size) + (x * tiles // size)) % 2
    img = np.where(t[..., None] == 0, np.array(c0, np.uint8), np.array(c1, np.uint8))
    return np.concatenate([img, np.full((size, size, 1), 255, np.uint8)], axis=-1)


def _quad(side=1.0):
    """Unit XY quad at z=0 facing +Z, CCW winding."""
    s = side / 2
    pos = np.array([[-s, -s, 0], [s, -s, 0], [s, s, 0], [-s, s, 0]], np.float32)
    nrm = np.tile([0, 0, 1.0], (4, 1)).astype(np.float32)
    uv = np.array([[0, 1], [1, 1], [1, 0], [0, 0]], np.float32)  # glTF v-down
    idx = np.array([[0, 1, 2], [0, 2, 3]], np.uint16)
    return pos, nrm, uv, idx


def build_fixture_glb():
    """Returns (glb_bytes, truth) where truth holds the expected loader
    output: list of (positions, normals, uvs(flipped), indices, material)
    per primitive and the expected world TRS per object instance."""
    buffers = bytearray()
    views = []
    accessors = []

    def add_view(data: bytes, stride=None, align=4):
        while len(buffers) % align:
            buffers.append(0)
        off = len(buffers)
        buffers.extend(data)
        v = {"buffer": 0, "byteOffset": off, "byteLength": len(data)}
        if stride is not None:
            v["byteStride"] = stride
        views.append(v)
        return len(views) - 1

    def add_accessor(view, comp_type, count, type_, offset=0, normalized=False):
        a = {
            "bufferView": view,
            "componentType": comp_type,
            "count": count,
            "type": type_,
            "byteOffset": offset,
        }
        if normalized:
            a["normalized"] = True
        accessors.append(a)
        return len(accessors) - 1

    # ---- mesh A, primitive 0: INTERLEAVED pos(f32x3) + normal(f32x3) +
    #      uv(u16x2 normalized); u16 indices; material 0 (embedded PNG).
    pos, nrm, uv, idx = _quad(2.0)
    uv_u16 = np.round(uv * 65535).astype(np.uint16)
    stride = 12 + 12 + 4
    inter = bytearray()
    for i in range(4):
        inter += struct.pack("<3f", *pos[i])
        inter += struct.pack("<3f", *nrm[i])
        inter += struct.pack("<2H", *uv_u16[i])
    v_inter = add_view(bytes(inter), stride=stride)
    a_pos0 = add_accessor(v_inter, 5126, 4, "VEC3", offset=0)
    a_nrm0 = add_accessor(v_inter, 5126, 4, "VEC3", offset=12)
    a_uv0 = add_accessor(v_inter, 5123, 4, "VEC2", offset=24, normalized=True)
    v_idx0 = add_view(idx.tobytes(), align=2)
    a_idx0 = add_accessor(v_idx0, 5123, 6, "SCALAR")

    # ---- mesh A, primitive 1: planar (separate views), u32 indices, a
    #      TANGENT accessor, material 1 (data-URI PNG), offset in +X.
    pos1 = pos + np.array([2.5, 0, 0], np.float32)
    tan1 = np.tile([1.0, 0, 0, 1.0], (4, 1)).astype(np.float32)
    a_pos1 = add_accessor(add_view(pos1.tobytes()), 5126, 4, "VEC3")
    a_nrm1 = add_accessor(add_view(nrm.tobytes()), 5126, 4, "VEC3")
    a_uv1 = add_accessor(add_view(uv.tobytes()), 5126, 4, "VEC2")
    a_tan1 = add_accessor(add_view(tan1.tobytes()), 5126, 4, "VEC4")
    a_idx1 = add_accessor(
        add_view(idx.astype(np.uint32).tobytes()), 5125, 6, "SCALAR"
    )

    # ---- mesh B: ground plane, no TEXCOORD (-> zeros), default material.
    posb = np.array(
        [[-6, 0, -6], [6, 0, -6], [6, 0, 6], [-6, 0, 6]], np.float32
    )
    nrmb = np.tile([0, 1.0, 0], (4, 1)).astype(np.float32)
    idxb = np.array([[0, 2, 1], [0, 3, 2]], np.uint16)
    a_posb = add_accessor(add_view(posb.tobytes()), 5126, 4, "VEC3")
    a_nrmb = add_accessor(add_view(nrmb.tobytes()), 5126, 4, "VEC3")
    a_idxb = add_accessor(add_view(idxb.tobytes(), align=2), 5123, 6, "SCALAR")

    # ---- textures: material 0 embedded PNG (bufferView), material 1 data URI.
    tex0 = checker_rgba(16, 4)
    png0 = _png_bytes(tex0)
    v_png0 = add_view(png0, align=4)
    tex1 = checker_rgba(8, 2, (40, 90, 200), (230, 230, 240))
    data_uri = "data:image/png;base64," + base64.b64encode(_png_bytes(tex1)).decode()

    # ---- nodes: root has a column-major matrix (translate y+1 and scale 0.5);
    # child0 (TRS rotate 90deg about Y + translate) holds mesh A; child1
    # shares mesh A with a different TRS; separate root node holds mesh B.
    root_matrix = np.array(
        [
            [0.5, 0, 0, 0],
            [0, 0.5, 0, 1.0],
            [0, 0, 0.5, 0],
            [0, 0, 0, 1],
        ],
        np.float32,
    )  # row-major truth
    q = [0.0, np.sin(np.pi / 4), 0.0, np.cos(np.pi / 4)]  # 90 deg about +Y (xyzw)
    child0 = {"mesh": 0, "rotation": q, "translation": [0, 2, 0]}
    child1 = {"mesh": 0, "translation": [0, 2, -4], "scale": [1.5, 1.5, 1.5]}

    doc = {
        "asset": {"version": "2.0"},
        "scene": 0,
        "scenes": [{"nodes": [0, 3]}],
        "nodes": [
            {"matrix": list(root_matrix.T.reshape(-1).astype(float)), "children": [1, 2]},
            child0,
            child1,
            {"mesh": 1},
        ],
        "meshes": [
            {
                "primitives": [
                    {
                        "attributes": {"POSITION": a_pos0, "NORMAL": a_nrm0, "TEXCOORD_0": a_uv0},
                        "indices": a_idx0,
                        "material": 0,
                    },
                    {
                        "attributes": {
                            "POSITION": a_pos1, "NORMAL": a_nrm1,
                            "TEXCOORD_0": a_uv1, "TANGENT": a_tan1,
                        },
                        "indices": a_idx1,
                        "material": 1,
                    },
                ]
            },
            {
                "primitives": [
                    {"attributes": {"POSITION": a_posb, "NORMAL": a_nrmb}, "indices": a_idxb}
                ]
            },
        ],
        "materials": [
            {"pbrMetallicRoughness": {"baseColorTexture": {"index": 0}}},
            {"pbrMetallicRoughness": {"baseColorTexture": {"index": 1}}},
        ],
        "textures": [{"source": 0}, {"source": 1}],
        "images": [
            {"bufferView": v_png0, "mimeType": "image/png"},
            {"uri": data_uri},
        ],
        "accessors": accessors,
        "bufferViews": views,
        "buffers": [{"byteLength": len(buffers)}],
    }

    # GLB container
    json_chunk = json.dumps(doc).encode()
    json_chunk += b" " * ((4 - len(json_chunk) % 4) % 4)
    bin_chunk = bytes(buffers)
    bin_chunk += b"\0" * ((4 - len(bin_chunk) % 4) % 4)
    total = 12 + 8 + len(json_chunk) + 8 + len(bin_chunk)
    glb = b"".join(
        [
            struct.pack("<4sII", b"glTF", 2, total),
            struct.pack("<I4s", len(json_chunk), b"JSON"),
            json_chunk,
            struct.pack("<I4s", len(bin_chunk), b"BIN\0"),
            bin_chunk,
        ]
    )

    # Ground truth for loader assertions.
    def rot_y_90():
        m = np.eye(4, dtype=np.float32)
        c, s = np.cos(np.pi / 2), np.sin(np.pi / 2)
        m[:3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
        return m

    t0 = rot_y_90()
    t0[:3, 3] = [0, 2, 0]
    t1 = np.eye(4, dtype=np.float32)
    t1[:3, :3] *= 1.5
    t1[:3, 3] = [0, 2, -4]
    truth = {
        "prims": [
            dict(positions=pos, normals=nrm, uvs_flipped=np.stack([uv[:, 0], 1 - uv[:, 1]], 1),
                 indices=idx.astype(np.int32), material=0,
                 uv_raw_u16=uv_u16),
            dict(positions=pos1, normals=nrm, uvs_flipped=np.stack([uv[:, 0], 1 - uv[:, 1]], 1),
                 indices=idx.astype(np.int32), material=1, tangent4=tan1),
            dict(positions=posb, normals=nrmb,
                 uvs_flipped=np.zeros((4, 2), np.float32),
                 indices=idxb.astype(np.int32), material=0),
        ],
        # objects: (expected world TRS, flat prim index), in loader order:
        # the stack pops node 3 (mesh B) first, then walks node 0's children.
        "objects": [
            (root_matrix @ t0, 0), (root_matrix @ t0, 1),
            (root_matrix @ t1, 0), (root_matrix @ t1, 1),
            (np.eye(4, dtype=np.float32), 2),
        ],
        "tex0": tex0,
        "tex1": tex1,
    }
    return glb, truth
