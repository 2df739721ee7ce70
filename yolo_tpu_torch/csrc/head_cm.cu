// One Detect level in one kernel, the channel-major entry: the counterpart of
// yolo_tpu/ops/pallas_head2.py::head_level_cm. dist (B, H*W, 4) f32 and the
// logistic of the cls logits (B, H*W, nc) in f32, taken inside the kernel.
// That TPU kernel's means (a channel-major relayout of x before the call, out
// channels as the GEMM's rows, rotated weight tables, a tile width that must
// divide W) belong to the TPU; here the level runs the body of head.cu
// (head.cuh), whose plan it shares, with the cls epilogue as the only
// difference.
#include "head.cuh"

extern "C" {

// as yt_head_level; cls is f32
int yt_head_level_cm(const void* x, float* dist, float* cls, const void* wp, const float* w0, const float* w1r,
                     const float* w1c, const float* w2r, const float* w2c, const float* b0, const float* b1r,
                     const float* b1c, const float* b2r, const float* b2c, const float* proj, int B, int H, int W,
                     int C, int c2, int c3, int nc, int reg_max, int bf16, int th, int tw, void* stream) {
  if (reg_max != kRegMax) return kNotTaken;
  HeadArgs a{x, dist, cls, w0, w1r, w1c, w2r, w2c, bf16 ? static_cast<const bf16_t*>(wp) : nullptr,
             b0, b1r, b1c, b2r, b2c, proj, B, H, W, C, c2, c3, nc, 0, 0, 0};
  return forward<true>(a, th, tw, stream);
}

}  // extern "C"
