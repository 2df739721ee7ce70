// Native preprocessing runtime: letterbox resize + batch assembly.
//
// TPU-native replacement for the reference's per-engine C++ preprocessing
// (ref: examples/YOLOv8-CPP-Inference/inference.cpp letterbox/blobFromImage,
// examples/YOLOv8-LibTorch-CPP-Inference/main.cc letterbox) as a reusable
// shared library: the Python host pipeline calls it via ctypes to prepare
// uint8 NHWC device batches without cv2/numpy overhead on the hot path.
//
// Build: g++ -O3 -shared -fPIC -o libyolo_preprocess.so preprocess.cpp
// (the Python wrapper builds it on first use; see yolo_tpu_torch/native/__init__.py)
//
// A copy of yolo_tpu/native/preprocess.cpp with one addition: a frame that needs no
// resize is copied row by row, the same bytes the resampling loop writes, ~10x faster.

#include <cstdint>
#include <cstring>
#include <algorithm>
#include <cmath>

extern "C" {

// Bilinear-resize src (h×w×c, uint8, row-major) to (rh×rw) and paste centered
// into dst (dh×dw×c) prefilled with pad_value. Matches cv2.INTER_LINEAR
// sampling (half-pixel centers) within rounding.
void letterbox_u8(const uint8_t* src, int h, int w, int c,
                  uint8_t* dst, int dh, int dw,
                  uint8_t pad_value, float* ratio_out, float* pad_out) {
    const float r = std::min((float)dh / h, (float)dw / w);
    const int rw = (int)std::lround(w * r);
    const int rh = (int)std::lround(h * r);
    const float dx = (dw - rw) / 2.0f;
    const float dy = (dh - rh) / 2.0f;
    const int left = (int)std::lround(dx - 0.1f);
    const int top = (int)std::lround(dy - 0.1f);

    std::memset(dst, pad_value, (size_t)dh * dw * c);

    if (rw == w && rh == h) {
        // No resize (a 640x512 frame into 640x640): sx = sy = 1, so the loop below would read
        // each source pixel with weight 1 and write it unchanged. Copy the rows instead.
        for (int y = 0; y < h; ++y)
            std::memcpy(dst + ((size_t)(y + top) * dw + left) * c, src + (size_t)y * w * c, (size_t)w * c);
        if (ratio_out) { ratio_out[0] = r; ratio_out[1] = r; }
        if (pad_out) { pad_out[0] = dx; pad_out[1] = dy; }
        return;
    }

    const float sx = (float)w / rw;
    const float sy = (float)h / rh;
    for (int y = 0; y < rh; ++y) {
        const float fy = (y + 0.5f) * sy - 0.5f;
        int y0 = (int)std::floor(fy);
        float wy = fy - y0;
        int y1 = y0 + 1;
        y0 = std::min(std::max(y0, 0), h - 1);
        y1 = std::min(std::max(y1, 0), h - 1);
        uint8_t* drow = dst + ((size_t)(y + top) * dw + left) * c;
        const uint8_t* s0 = src + (size_t)y0 * w * c;
        const uint8_t* s1 = src + (size_t)y1 * w * c;
        for (int x = 0; x < rw; ++x) {
            const float fx = (x + 0.5f) * sx - 0.5f;
            int x0 = (int)std::floor(fx);
            float wx = fx - x0;
            int x1 = x0 + 1;
            x0 = std::min(std::max(x0, 0), w - 1);
            x1 = std::min(std::max(x1, 0), w - 1);
            for (int k = 0; k < c; ++k) {
                const float v =
                    (1 - wy) * ((1 - wx) * s0[x0 * c + k] + wx * s0[x1 * c + k]) +
                    wy * ((1 - wx) * s1[x0 * c + k] + wx * s1[x1 * c + k]);
                drow[x * c + k] = (uint8_t)std::lround(std::min(std::max(v, 0.0f), 255.0f));
            }
        }
    }
    if (ratio_out) { ratio_out[0] = r; ratio_out[1] = r; }
    if (pad_out) { pad_out[0] = dx; pad_out[1] = dy; }
}

// Letterbox a batch of same-sized frames into a contiguous NHWC buffer.
void batch_letterbox_u8(const uint8_t* src, int n, int h, int w, int c,
                        uint8_t* dst, int dh, int dw, uint8_t pad_value,
                        float* ratio_out, float* pad_out) {
    const size_t src_stride = (size_t)h * w * c;
    const size_t dst_stride = (size_t)dh * dw * c;
    for (int i = 0; i < n; ++i) {
        letterbox_u8(src + i * src_stride, h, w, c,
                     dst + i * dst_stride, dh, dw, pad_value,
                     i == 0 ? ratio_out : nullptr, i == 0 ? pad_out : nullptr);
    }
}

// BGR→RGB + uint8→fp32 [0,1] NHWC→NHWC normalization (when the host, not the
// device, must hand over float frames — e.g. feeding the StableHLO C++ client).
void normalize_bgr_u8_to_rgb_f32(const uint8_t* src, int n, float* dst) {
    for (int i = 0; i < n; i += 3) {
        dst[i] = src[i + 2] * (1.0f / 255.0f);
        dst[i + 1] = src[i + 1] * (1.0f / 255.0f);
        dst[i + 2] = src[i] * (1.0f / 255.0f);
    }
}

}  // extern "C"
