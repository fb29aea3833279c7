"""Sparse accessor decoding (glTF 2.0 §3.6.2.3).

The reference's Assimp import path handles sparse accessors transparently;
the loader's former NotImplementedError was a gap on
arbitrary real assets."""

import numpy as np

from arctic_tpu.io.gltf import _accessor, _Gltf


def _doc(buffers, views, accessors):
    return _Gltf(
        doc={"bufferViews": views, "accessors": accessors},
        buffers=buffers,
        base_dir=".",
    )


def test_sparse_overrides_dense_base():
    base = np.arange(15, dtype=np.float32).reshape(5, 3)
    sidx = np.array([1, 4], np.uint16)
    svals = np.array([[100, 101, 102], [200, 201, 202]], np.float32)
    buf = base.tobytes() + sidx.tobytes() + svals.tobytes()
    views = [
        {"buffer": 0, "byteOffset": 0, "byteLength": 60},
        {"buffer": 0, "byteOffset": 60, "byteLength": 4},
        {"buffer": 0, "byteOffset": 64, "byteLength": 24},
    ]
    acc = {
        "bufferView": 0,
        "componentType": 5126,
        "count": 5,
        "type": "VEC3",
        "sparse": {
            "count": 2,
            "indices": {"bufferView": 1, "componentType": 5123},
            "values": {"bufferView": 2},
        },
    }
    out = _accessor(_doc([buf], views, [acc]), 0)
    want = base.copy()
    want[[1, 4]] = svals
    np.testing.assert_array_equal(out, want)


def test_sparse_zero_base_normalized():
    # No bufferView: base is all zeros; normalized u16 divides post-override.
    sidx = np.array([2], np.uint32)
    svals = np.array([[65535, 32768]], np.uint16)
    buf = sidx.tobytes() + svals.tobytes()
    views = [
        {"buffer": 0, "byteOffset": 0, "byteLength": 4},
        {"buffer": 0, "byteOffset": 4, "byteLength": 4},
    ]
    acc = {
        "componentType": 5123,
        "count": 4,
        "type": "VEC2",
        "normalized": True,
        "sparse": {
            "count": 1,
            "indices": {"bufferView": 0, "componentType": 5125},
            "values": {"bufferView": 1},
        },
    }
    out = _accessor(_doc([buf], views, [acc]), 0)
    assert out.shape == (4, 2)
    assert out.dtype == np.float32
    np.testing.assert_allclose(out[2], [1.0, 32768 / 65535], rtol=1e-6)
    assert np.all(out[[0, 1, 3]] == 0)
