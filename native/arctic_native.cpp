// arctic_native — C++ host-path library for arctic_tpu.
//
// The reference engine's host side is C++ throughout (Assimp import,
// stb_image decode, scene flattening — src/app.cpp:173-385). This build
// keeps its device path in XLA/Pallas but implements the CPU-heavy load-time
// work natively too: Radiance HDR decode (stbi_loadf equivalent for the
// HDRI, renderer.cpp:111-126) and tangent-space generation
// (aiProcess_CalcTangentSpace equivalent, app.cpp:180).
//
// Build: make -C native   (produces libarctic_native.so, loaded via ctypes
// from arctic_tpu/io/native.py; every entry point has a numpy fallback).

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

extern "C" {

void arctic_free(void *p) { std::free(p); }

// ---------------------------------------------------------------------------
// Radiance HDR (RGBE) decode: returns 0 on success, fills w/h and a
// malloc'd h*w*3 float buffer (caller frees with arctic_free).
// ---------------------------------------------------------------------------
int arctic_load_hdr(const char *path, int *out_w, int *out_h, float **out_data) {
    FILE *f = std::fopen(path, "rb");
    if (!f) return 1;
    std::fseek(f, 0, SEEK_END);
    long size = std::ftell(f);
    std::fseek(f, 0, SEEK_SET);
    std::vector<uint8_t> data(size);
    if (std::fread(data.data(), 1, size, f) != (size_t)size) {
        std::fclose(f);
        return 2;
    }
    std::fclose(f);

    size_t pos = 0;
    auto read_line = [&](char *buf, size_t cap) -> bool {
        size_t i = 0;
        while (pos < data.size() && data[pos] != '\n') {
            if (i + 1 < cap) buf[i++] = (char)data[pos];
            pos++;
        }
        if (pos < data.size()) pos++;  // skip \n
        buf[i] = 0;
        return true;
    };

    char line[512];
    read_line(line, sizeof line);
    if (std::strncmp(line, "#?RADIANCE", 10) != 0 && std::strncmp(line, "#?RGBE", 6) != 0)
        return 3;
    while (read_line(line, sizeof line) && line[0] != 0) {
    }
    read_line(line, sizeof line);
    int w = 0, h = 0;
    if (std::sscanf(line, "-Y %d +X %d", &h, &w) != 2) return 4;

    std::vector<uint8_t> rgbe((size_t)w * h * 4);
    for (int y = 0; y < h; ++y) {
        uint8_t *row = rgbe.data() + (size_t)y * w * 4;
        if (w < 8 || w > 0x7fff || pos + 4 > data.size() || data[pos] != 2 ||
            data[pos + 1] != 2 || (data[pos + 2] & 0x80)) {
            // flat scanline
            if (pos + (size_t)w * 4 > data.size()) return 5;
            for (int x = 0; x < w; ++x)
                for (int c = 0; c < 4; ++c) row[x * 4 + c] = data[pos + x * 4 + c];
            pos += (size_t)w * 4;
            continue;
        }
        pos += 4;
        for (int c = 0; c < 4; ++c) {
            int x = 0;
            while (x < w) {
                if (pos >= data.size()) return 6;
                int cnt = data[pos];
                if (cnt > 128) {
                    cnt -= 128;
                    uint8_t v = data[pos + 1];
                    pos += 2;
                    for (int k = 0; k < cnt && x < w; ++k) row[(x++) * 4 + c] = v;
                } else {
                    pos += 1;
                    for (int k = 0; k < cnt && x < w; ++k) row[(x++) * 4 + c] = data[pos++];
                }
            }
        }
    }

    float *out = (float *)std::malloc((size_t)w * h * 3 * sizeof(float));
    if (!out) return 7;
    for (size_t i = 0; i < (size_t)w * h; ++i) {
        int e = rgbe[i * 4 + 3];
        float scale = e > 0 ? std::ldexp(1.0f, e - (128 + 8)) : 0.0f;
        out[i * 3 + 0] = rgbe[i * 4 + 0] * scale;
        out[i * 3 + 1] = rgbe[i * 4 + 1] * scale;
        out[i * 3 + 2] = rgbe[i * 4 + 2] * scale;
    }
    *out_w = w;
    *out_h = h;
    *out_data = out;
    return 0;
}

// ---------------------------------------------------------------------------
// Tangent-space generation (same algorithm as io/build.py compute_tangents:
// accumulate per-face UV-derivative tangents, Gram-Schmidt vs the normal,
// handedness from the accumulated bitangent).
// ---------------------------------------------------------------------------
int arctic_compute_tangents(const float *pos, const float *nrm, const float *uv,
                            int n_verts, const int *indices, int n_tris,
                            float *out_tan, float *out_btn) {
    std::vector<float> acc_t((size_t)n_verts * 3, 0.0f);
    std::vector<float> acc_b((size_t)n_verts * 3, 0.0f);
    for (int t = 0; t < n_tris; ++t) {
        int i0 = indices[t * 3], i1 = indices[t * 3 + 1], i2 = indices[t * 3 + 2];
        float e1[3], e2[3];
        for (int k = 0; k < 3; ++k) {
            e1[k] = pos[i1 * 3 + k] - pos[i0 * 3 + k];
            e2[k] = pos[i2 * 3 + k] - pos[i0 * 3 + k];
        }
        float d1u = uv[i1 * 2] - uv[i0 * 2], d1v = uv[i1 * 2 + 1] - uv[i0 * 2 + 1];
        float d2u = uv[i2 * 2] - uv[i0 * 2], d2v = uv[i2 * 2 + 1] - uv[i0 * 2 + 1];
        float det = d1u * d2v - d1v * d2u;
        if (std::fabs(det) < 1e-12f) continue;
        float r = 1.0f / det;
        for (int k = 0; k < 3; ++k) {
            float tk = (e1[k] * d2v - e2[k] * d1v) * r;
            float bk = (e2[k] * d1u - e1[k] * d2u) * r;
            for (int vi : {i0, i1, i2}) {
                acc_t[(size_t)vi * 3 + k] += tk;
                acc_b[(size_t)vi * 3 + k] += bk;
            }
        }
    }
    for (int v = 0; v < n_verts; ++v) {
        const float *n = nrm + (size_t)v * 3;
        float *t = acc_t.data() + (size_t)v * 3;
        float *b = acc_b.data() + (size_t)v * 3;
        float ndt = n[0] * t[0] + n[1] * t[1] + n[2] * t[2];
        float tt[3] = {t[0] - n[0] * ndt, t[1] - n[1] * ndt, t[2] - n[2] * ndt};
        float len = std::sqrt(tt[0] * tt[0] + tt[1] * tt[1] + tt[2] * tt[2]);
        if (len > 1e-8f) {
            for (int k = 0; k < 3; ++k) tt[k] /= len;
        } else {
            // Degenerate UVs: any vector orthogonal to n.
            float axis[3] = {std::fabs(n[0]) < 0.9f ? 1.0f : 0.0f,
                             std::fabs(n[0]) < 0.9f ? 0.0f : 1.0f, 0.0f};
            tt[0] = n[1] * axis[2] - n[2] * axis[1];
            tt[1] = n[2] * axis[0] - n[0] * axis[2];
            tt[2] = n[0] * axis[1] - n[1] * axis[0];
            float l2 = std::sqrt(tt[0] * tt[0] + tt[1] * tt[1] + tt[2] * tt[2]);
            for (int k = 0; k < 3; ++k) tt[k] /= l2;
        }
        float cx = n[1] * tt[2] - n[2] * tt[1];
        float cy = n[2] * tt[0] - n[0] * tt[2];
        float cz = n[0] * tt[1] - n[1] * tt[0];
        float handed = (cx * b[0] + cy * b[1] + cz * b[2]) < 0.0f ? -1.0f : 1.0f;
        out_tan[(size_t)v * 3 + 0] = tt[0];
        out_tan[(size_t)v * 3 + 1] = tt[1];
        out_tan[(size_t)v * 3 + 2] = tt[2];
        out_btn[(size_t)v * 3 + 0] = cx * handed;
        out_btn[(size_t)v * 3 + 1] = cy * handed;
        out_btn[(size_t)v * 3 + 2] = cz * handed;
    }
    return 0;
}

}  // extern "C"
