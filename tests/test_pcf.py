"""PCF (shadow.pcf_shadow_proj) against a direct numpy transcription of
calculate_shadow (forward.hlsl:68-96): 25 bilinear taps 0.0001 UV apart
through a linear-WRAP sampler, z > filtered depth counts as occluded,
points outside the light frustum are lit."""

import numpy as np
import pytest

from arctic_tpu.ops import shadow


def _pcf_reference(smap, x, y, z):
    s = smap.shape[0]
    smap = smap.astype(np.float64)
    u = x.astype(np.float64) * 0.5 + 0.5
    v = 1.0 - (y.astype(np.float64) * 0.5 + 0.5)
    out = np.zeros(x.shape)
    for j in range(-2, 3):
        for i in range(-2, 3):
            tx = (u + i * 1e-4) * s - 0.5
            ty = (v + j * 1e-4) * s - 0.5
            x0 = np.floor(tx).astype(np.int64)
            y0 = np.floor(ty).astype(np.int64)
            fx = tx - x0
            fy = ty - y0

            def tex(yy, xx):
                return smap[yy % s, xx % s]

            top = tex(y0, x0) * (1 - fx) + tex(y0, x0 + 1) * fx
            bot = tex(y0 + 1, x0) * (1 - fx) + tex(y0 + 1, x0 + 1) * fx
            closest = top * (1 - fy) + bot * fy
            out += z > closest
    outside = (z > 1.0) | (u < 0) | (v < 0) | (u > 1) | (v > 1)
    return np.where(outside, 0.0, out / 25.0)


@pytest.mark.parametrize("size", [16, 37, 64])
def test_pcf_runs_path_matches_numpy_reference(size):
    rng = np.random.default_rng(size)
    # A blocky occluder map so taps straddle depth edges.
    smap = rng.uniform(0.2, 0.9, (size // 4 + 1, size // 4 + 1)).astype(np.float32)
    smap = np.kron(smap, np.ones((4, 4), np.float32))[:size, :size]
    n = 4000
    x = rng.uniform(-1.0, 1.0, n).astype(np.float32)
    y = rng.uniform(-1.0, 1.0, n).astype(np.float32)
    # Border rows/cols: their taps wrap to the opposite edge.
    x[:500] = rng.uniform(-1.0, -1.0 + 2.0 / size, 500)
    x[500:1000] = rng.uniform(1.0 - 2.0 / size, 1.0, 500)
    y[1000:1500] = rng.uniform(1.0 - 2.0 / size, 1.0, 500)
    z = rng.uniform(0.1, 1.0, n).astype(np.float32)
    # Outside the light frustum: lit whatever the map says.
    x[1500:1600] = rng.uniform(1.01, 1.5, 100)
    z[1600:1700] = rng.uniform(1.01, 2.0, 100)

    got = np.asarray(shadow.pcf_shadow_proj(smap, x, y, z))
    want = _pcf_reference(smap, x, y, z)
    assert got.shape == (n,)
    np.testing.assert_array_equal(got[1500:1700], 0.0)
    # Only taps whose depth compare is within f32 rounding may differ.
    d = np.abs(got - want)
    assert d.max() <= 1.0 / 25 + 1e-6
    assert (d > 1e-6).mean() < 0.005
    assert 0.05 < (got > 0).mean() < 0.95  # the test sees both lit and shadowed
