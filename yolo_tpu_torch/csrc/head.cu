// One Detect level in one kernel, the logits entry: the counterpart of
// yolo_tpu/ops/pallas_head.py::_head_level_kernel (entry fused_head_level).
// dist (B, H*W, 4) f32 and the cls logits (B, H*W, nc) in the compute dtype.
// The body, its design and what bounds it are in head.cuh, which head_cm.cu
// shares; this file also holds the plan's entries and the measurement switches.
#include "head.cuh"

#ifdef YT_HEAD_TRACE
namespace yt {
long long* g_head_trace = nullptr;
}  // namespace yt
#endif

extern "C" {

// Every entry returns 0, a CUDA error code (positive), -1 for a level the kernel does not take
// or -2 where no tile of it fits the shared memory.

// out[8]: see plan_entry in head.cuh (the same plan serves head_cm.cu)
int yt_head_plan(int B, int H, int W, int C, int c2, int c3, int nc, int bf16, long long* out) {
  return plan_entry(Level{B, H, W, C, c2, c3, nc, bf16 != 0}, out);
}

// plans[5 i ..] and costs[i] of every candidate, see candidates_entry in head.cuh; `barrier` NaN keeps the model's
int yt_head_candidates(int B, int H, int W, int C, int c2, int c3, int nc, int bf16, double barrier, int room,
                       long long* plans, double* costs, int* count) {
  return candidates_entry(Level{B, H, W, C, c2, c3, nc, bf16 != 0}, barrier, room, plans, costs, count);
}

#ifdef YT_HEAD_TRACE
// the next launches write one block's cycle counts per stage to `trace` (kTraceStages x kTraceSlots,
// then the block's tile count; device memory), or nothing where it is null
int yt_head_set_trace(long long* trace) {
  g_head_trace = trace;
  return 0;
}
#endif

// wp (the bf16 pack) is read in bf16, w0 .. w2c (f32 HWIO) in f32; th = 0 launches the level's plan,
// th > 0 the tile given
int yt_head_level(const void* x, float* dist, void* cls, const void* wp, const float* w0, const float* w1r,
                  const float* w1c, const float* w2r, const float* w2c, const float* b0, const float* b1r,
                  const float* b1c, const float* b2r, const float* b2c, const float* proj, int B, int H, int W, int C,
                  int c2, int c3, int nc, int reg_max, int bf16, int th, int tw, void* stream) {
  if (reg_max != kRegMax) return kNotTaken;
  HeadArgs a{x, dist, cls, w0, w1r, w1c, w2r, w2c, bf16 ? static_cast<const bf16_t*>(wp) : nullptr,
             b0, b1r, b1c, b2r, b2c, proj, B, H, W, C, c2, c3, nc, 0, 0, 0};
  return forward<false>(a, th, tw, stream);
}

}  // extern "C"
