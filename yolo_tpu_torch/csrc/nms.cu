// Greedy NMS keep mask over score-sorted candidates, one block per image.
//
// Replaces yolo_tpu/ops/pallas_nms.py::_nms_kernel (entry pallas_nms_keep).
// The block loads the image's K candidates (K <= 1024) into shared memory
// once, then walks them in order: if candidate i is not suppressed, the
// threads mark every later candidate j with IoU(i, j) > threshold (strict >),
// one barrier per step. keep = not suppressed and score > 0.
//
// The IoU is the one of yolo_tpu/ops/boxes.py::box_iou, term for term in
// the same order, inter / ((area_i + area_j - inter) + 1e-7), with every
// operation rounded on its own (the _rn intrinsics stop nvcc from contracting
// a multiply and an add into one FMA), so that the keep set equals the JAX
// package's nms_fixed route bit for bit.
//
// What bounds it on the H100: neither bytes nor operations but the K
// dependent steps of the greedy walk, each a barrier of one block; the grid
// has one block per image, so a chunk of 128 frames fills 128 of the 132 SMs.
#include "common.cuh"

#include <stdint.h>

namespace {

__device__ __forceinline__ float iou(const float* bx, const float* ar, int i, int j) {
  const float* a = bx + 4 * i;
  const float* b = bx + 4 * j;
  const float w = fmaxf(__fsub_rn(fminf(a[2], b[2]), fmaxf(a[0], b[0])), 0.f);
  const float h = fmaxf(__fsub_rn(fminf(a[3], b[3]), fmaxf(a[1], b[1])), 0.f);
  const float inter = __fmul_rn(w, h);
  return __fdiv_rn(inter, __fadd_rn(__fsub_rn(__fadd_rn(ar[i], ar[j]), inter), 1e-7f));
}

__global__ void nms_keep_kernel(const float* __restrict__ boxes, const float* __restrict__ scores,
                                uint8_t* __restrict__ keep, int K, float thr) {
  extern __shared__ __align__(16) float sm[];
  float* bx = sm;          // [K][4]
  float* ar = sm + 4 * K;  // [K]
  int* sup = reinterpret_cast<int*>(ar + K);
  const int b = blockIdx.x;
  const float* gb = boxes + size_t(b) * K * 4;
  for (int j = threadIdx.x; j < K; j += blockDim.x) {
    const float x1 = gb[4 * j], y1 = gb[4 * j + 1], x2 = gb[4 * j + 2], y2 = gb[4 * j + 3];
    bx[4 * j] = x1;
    bx[4 * j + 1] = y1;
    bx[4 * j + 2] = x2;
    bx[4 * j + 3] = y2;
    ar[j] = __fmul_rn(__fsub_rn(x2, x1), __fsub_rn(y2, y1));
    sup[j] = 0;
  }
  __syncthreads();
  for (int i = 0; i < K - 1; ++i) {
    if (!sup[i]) {  // sup[i] was last written before the previous barrier
      for (int j = i + 1 + threadIdx.x; j < K; j += blockDim.x) {
        if (iou(bx, ar, i, j) > thr) sup[j] = 1;
      }
    }
    __syncthreads();
  }
  for (int j = threadIdx.x; j < K; j += blockDim.x) {
    keep[size_t(b) * K + j] = (!sup[j] && scores[size_t(b) * K + j] > 0.f) ? 1 : 0;
  }
}

}  // namespace

extern "C" {

int yt_nms_keep(const float* boxes, const float* scores, uint8_t* keep, int B, int K, float thr, void* stream) {
  if (K < 1 || K > 1024) return int(cudaErrorInvalidValue);
  const int threads = K < 256 ? ((K + 31) / 32) * 32 : 256;
  const size_t bytes = size_t(K) * (5 * sizeof(float) + sizeof(int));
  nms_keep_kernel<<<B, threads, bytes, static_cast<cudaStream_t>(stream)>>>(boxes, scores, keep, K, thr);
  YT_RETURN_LAUNCH_ERROR();
}

const char* yt_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
