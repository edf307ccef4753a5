// Batched uint8 bicubic resize for video frame preprocessing.
//
// The host hot loop for video prompts is resizing N decoded frames (64-512
// per request, llava/mm_utils.py:35-203 samples then resizes each frame).
// Python-side per-frame PIL calls pay interpreter + allocation overhead per
// frame; this kernel resizes the whole stack in one native call.
//
// Semantics: bicubic with a = -0.75, edge-clamped — exactly cv2
// INTER_CUBIC, the reference's video resize filter. Layout: HWC uint8 RGB.
//
// Built by vila_tpu_torch/utils/imageproc.py with g++ at first use into
// vila_tpu_torch/_build/; where it cannot be built, the resize raises
// (there is no PIL fallback: PIL gives other pixels).

#include <cstdint>
#include <cstring>
#include <algorithm>

namespace {

inline float cubic_w(float t) {
    // cv2 INTER_CUBIC kernel coefficient (a = -0.75)
    const float a = -0.75f;
    t = t < 0 ? -t : t;
    if (t <= 1.0f) return ((a + 2.0f) * t - (a + 3.0f)) * t * t + 1.0f;
    if (t < 2.0f) return (((t - 5.0f) * t + 8.0f) * t - 4.0f) * a;
    return 0.0f;
}

inline int clampi(int v, int lo, int hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

}  // namespace

extern "C" {

// src: (n, sh, sw, 3) uint8; dst: (n, dh, dw, 3) uint8.
void resize_batch_u8(const uint8_t* src, int n, int sh, int sw,
                     uint8_t* dst, int dh, int dw) {
    const float sy = static_cast<float>(sh) / dh;
    const float sx = static_cast<float>(sw) / dw;

    // precompute per-output-column source columns + weights
    int* xi = new int[dw * 4];
    float* xw = new float[dw * 4];
    for (int ox = 0; ox < dw; ++ox) {
        float fx = (ox + 0.5f) * sx - 0.5f;
        int x0 = static_cast<int>(fx >= 0 ? fx : fx - 1);  // floor
        float frac = fx - x0;
        for (int k = 0; k < 4; ++k) {
            xi[ox * 4 + k] = clampi(x0 - 1 + k, 0, sw - 1);
            xw[ox * 4 + k] = cubic_w(frac - (k - 1));
        }
    }

    const int64_t src_frame = static_cast<int64_t>(sh) * sw * 3;
    const int64_t dst_frame = static_cast<int64_t>(dh) * dw * 3;
    // separable two-pass: horizontal resample each SOURCE row exactly once
    // into tmp (sh, dw, 3), then vertically blend 4 tmp rows per output
    // row — ~(4*dh/sh)x less horizontal work than per-output-row passes.
    float* tmp = new float[static_cast<int64_t>(sh) * dw * 3];

    for (int f = 0; f < n; ++f) {
        const uint8_t* sp = src + f * src_frame;
        uint8_t* dp = dst + f * dst_frame;

        for (int y = 0; y < sh; ++y) {
            const uint8_t* row = sp + static_cast<int64_t>(y) * sw * 3;
            float* out = tmp + static_cast<int64_t>(y) * dw * 3;
            for (int ox = 0; ox < dw; ++ox) {
                const int* xs = xi + ox * 4;
                const float* ws = xw + ox * 4;
                for (int c = 0; c < 3; ++c) {
                    out[ox * 3 + c] =
                        ws[0] * row[xs[0] * 3 + c] +
                        ws[1] * row[xs[1] * 3 + c] +
                        ws[2] * row[xs[2] * 3 + c] +
                        ws[3] * row[xs[3] * 3 + c];
                }
            }
        }

        for (int oy = 0; oy < dh; ++oy) {
            float fy = (oy + 0.5f) * sy - 0.5f;
            int y0 = static_cast<int>(fy >= 0 ? fy : fy - 1);
            float fr = fy - y0;
            float wy[4];
            const float* rows[4];
            for (int k = 0; k < 4; ++k) {
                wy[k] = cubic_w(fr - (k - 1));
                rows[k] = tmp +
                    static_cast<int64_t>(clampi(y0 - 1 + k, 0, sh - 1)) *
                        dw * 3;
            }
            uint8_t* drow = dp + static_cast<int64_t>(oy) * dw * 3;
            for (int i = 0; i < dw * 3; ++i) {
                float v = wy[0] * rows[0][i] + wy[1] * rows[1][i] +
                          wy[2] * rows[2][i] + wy[3] * rows[3][i];
                drow[i] = static_cast<uint8_t>(
                    clampi(static_cast<int>(v + 0.5f), 0, 255));
            }
        }
    }
    delete[] tmp;
    delete[] xi;
    delete[] xw;
}

}  // extern "C"
