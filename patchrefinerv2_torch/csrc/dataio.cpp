// The host library of the port's data path, bound with ctypes by
// patchrefinerv2_torch/datasets/native.py and built with g++ at first use.
//
// The readers' host hot loops: a raw 2160x3840x3 BGR blob to float32 RGB in
// [0, 1] (a product with 1/255.f), and the bilinear resize with torch's
// align_corners=True semantics on HWC float32. Each output element is a lerp
// of lerps in float32, source coordinates in float32 as torch computes them.
// The build adds no flag that changes the arithmetic (no -ffast-math, no FMA
// target): the float32 operations round as written.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cmath>
#include <vector>

extern "C" {

// Read a raw uint8 HxWx3 BGR blob from disk and emit float32 RGB in [0,1].
// Returns 0 on success, -1 on IO failure.
int load_raw_bgr_as_rgb_f32(const char* path, float* out, int h, int w) {
    const size_t n = (size_t)h * w * 3;
    std::vector<uint8_t> buf(n);
    FILE* f = fopen(path, "rb");
    if (!f) return -1;
    size_t got = fread(buf.data(), 1, n, f);
    fclose(f);
    if (got != n) return -1;
    const float inv = 1.0f / 255.0f;
    const uint8_t* src = buf.data();
    for (size_t i = 0; i < (size_t)h * w; ++i) {
        // BGR -> RGB swap
        out[i * 3 + 0] = src[i * 3 + 2] * inv;
        out[i * 3 + 1] = src[i * 3 + 1] * inv;
        out[i * 3 + 2] = src[i * 3 + 0] * inv;
    }
    return 0;
}

// Bilinear resize with torch align_corners=True semantics on HWC float32.
// Source coordinates computed in float32 exactly like torch
// (upsample_bilinear2d with align_corners).
void resize_bilinear_ac(const float* in, int ih, int iw, int c,
                        float* out, int oh, int ow) {
    const float sh = (oh > 1) ? (float)(ih - 1) / (float)(oh - 1) : 0.0f;
    const float sw = (ow > 1) ? (float)(iw - 1) / (float)(ow - 1) : 0.0f;
    std::vector<int> x0v(ow), x1v(ow);
    std::vector<float> lxv(ow);
    for (int x = 0; x < ow; ++x) {
        float sx = sw * (float)x;
        int x0 = (int)sx;
        if (x0 > iw - 1) x0 = iw - 1;
        int x1 = (x0 + 1 < iw) ? x0 + 1 : iw - 1;
        x0v[x] = x0; x1v[x] = x1; lxv[x] = sx - (float)x0;
    }
    for (int y = 0; y < oh; ++y) {
        float sy = sh * (float)y;
        int y0 = (int)sy;
        if (y0 > ih - 1) y0 = ih - 1;
        int y1 = (y0 + 1 < ih) ? y0 + 1 : ih - 1;
        float ly = sy - (float)y0;
        const float* row0 = in + (size_t)y0 * iw * c;
        const float* row1 = in + (size_t)y1 * iw * c;
        float* orow = out + (size_t)y * ow * c;
        for (int x = 0; x < ow; ++x) {
            const float lx = lxv[x];
            const float* p00 = row0 + (size_t)x0v[x] * c;
            const float* p01 = row0 + (size_t)x1v[x] * c;
            const float* p10 = row1 + (size_t)x0v[x] * c;
            const float* p11 = row1 + (size_t)x1v[x] * c;
            for (int k = 0; k < c; ++k) {
                float top = p00[k] + (p01[k] - p00[k]) * lx;
                float bot = p10[k] + (p11[k] - p10[k]) * lx;
                orow[(size_t)x * c + k] = top + (bot - top) * ly;
            }
        }
    }
}

}  // extern "C"
