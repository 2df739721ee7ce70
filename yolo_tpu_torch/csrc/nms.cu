// Greedy NMS keep mask over score-sorted candidates, for any K.
//
// Replaces yolo_tpu/ops/pallas_nms.py::_nms_kernel (entry pallas_nms_keep):
// keep = not suppressed and score > 0, where a candidate that is not
// suppressed when its turn comes, in slot order, suppresses every later one
// with IoU > threshold (strict >).
//
// The IoU is the one of yolo_tpu/ops/boxes.py::box_iou, term for term in
// the same order, inter / ((area_i + area_j - inter) + 1e-7), with every
// operation rounded on its own (the _rn intrinsics stop nvcc from contracting
// a multiply and an add into one FMA), so that the keep set equals the JAX
// package's nms_fixed route bit for bit. Where inter == 0 and thr >= 0 the
// division is skipped: its result (0, -0 or NaN) is never > thr.
//
// What bounds it on the H100: neither bytes nor operations but the greedy
// walk, a chain of dependent steps, plus the launch. The design shortens the
// chain and takes the barriers out of it:
// - the walk stops at n = 1 + the last slot with score > 0. Suppression only
//   runs forward and a slot with score <= 0 is never kept, so slots >= n are
//   written keep = 0 unread; on the main path almost every slot is padding;
// - the IoU tests do not depend on the walk: first the bit matrix
//   M[i][w], bit b = IoU(i, 32w + b) > thr for i < j < n, is filled by all
//   warps, a row per warp and one 32-bit word per step (a lane per pair, one
//   ballot), only the words w >= i / 32 that the walk reads;
// - then one warp walks an image with no block barrier: lane l owns the
//   removed words l, l + 32, ... (in shared memory). The walk takes 32 slots
//   at a time: every lane loads the 32 rows' diagonal words, resolves the 32
//   greedy steps in registers (a test and an OR each), then ORs the rows of
//   the slots it kept into its own words. A step of the chain is one ALU
//   operation; the loads are independent of it. So n slots cost n / 32 such
//   rounds, each about two load latencies and 32 dependent ALU steps.
// Where M lives: in the one-launch form (nms_fused_kernel, entry yt_nms_keep)
// a block of 32 warps takes one image, its boxes, areas, M and removed words
// in shared memory; its warps fill the mask, then warp 0 walks it. This form
// takes every K whose image fits a block, 20K + 4K * ceil(K / 32) +
// 4 * ceil(K / 32) bytes within 226 KB: K <= 1280 (1024 takes 148 KB).
// Beyond that, two launches: the mask kernel spreads each image's rows over
// `row_blocks` blocks into a scratch M in device memory (the wrapper's
// torch.empty, read back from L2), then the scan kernel walks it, a warp per
// image. plan_for picks the form by (B, K) and the card's SM count; the
// wrapper reads it through yt_nms_plan. M takes K * ceil(K / 32) words per
// image, the only limit on K.
// At the main path's and the predict facade's shapes the device's part is now
// a few microseconds, less than the wrapper's host time around the launch
// (PERF.md, row 5 of the kernel table).
#include "common.cuh"

#include <stdint.h>

namespace {

constexpr int kFusedThreads = 1024;  // threads of a block of the one-launch form
constexpr int kMaskThreads = 256;    // threads of a block of the mask kernel
constexpr int kScanWarps = 4;        // images per block of the scan kernel
constexpr unsigned kAll = 0xffffffffu;
constexpr size_t kSmemMax = 232448 - 1024;  // a block's 227 KB, less room for the static part

__host__ __device__ inline int words(int k) { return (k + 31) >> 5; }

// shared bytes of one image in the one-launch form: boxes, areas, M, removed words
__host__ __device__ inline size_t image_bytes(int K) {
  return size_t(K) * 20 + size_t(K) * words(K) * 4 + size_t(words(K)) * 4;
}

// How B images of K slots run, on a card of `sms` SMs: one launch while an image fits a
// block, else two, each image's mask rows over `row_blocks` blocks (about eight blocks per
// SM in all) into a scratch of `scratch_words` words. The one owner of this choice.
struct Plan {
  int launches, blocks, smem, row_blocks;
  long long scratch_words;
};

inline int split_row_blocks(int B, int K, int sms) { return yt::imin(words(K), yt::cdiv(8 * sms, yt::imax(B, 1))); }

inline Plan plan_for(int B, int K, int sms) {
  if (image_bytes(K) <= kSmemMax) return {1, B, int(image_bytes(K)), 0, 0};
  const int rb = split_row_blocks(B, K, sms);
  return {2, B * rb + yt::cdiv(B, kScanWarps), kScanWarps * words(K) * 4, rb, (long long)B * K * words(K)};
}

inline int sm_count(int* sms) {
  int dev = 0;
  if (const cudaError_t e = cudaGetDevice(&dev)) return int(e);
  return int(cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev));
}

__device__ __forceinline__ float area_of(float4 a) { return __fmul_rn(__fsub_rn(a.z, a.x), __fsub_rn(a.w, a.y)); }

// IoU(a, b) > thr, as box_iou computes it
__device__ __forceinline__ bool over(float4 a, float area_a, float4 b, float area_b, float thr) {
  const float w = fmaxf(__fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x)), 0.f);
  const float h = fmaxf(__fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y)), 0.f);
  const float inter = __fmul_rn(w, h);
  if (inter == 0.f && thr >= 0.f) return false;
  return __fdiv_rn(inter, __fadd_rn(__fsub_rn(__fadd_rn(area_a, area_b), inter), 1e-7f)) > thr;
}

__device__ __forceinline__ float4 box_at(const float* g, int j) {
  return make_float4(g[4 * j], g[4 * j + 1], g[4 * j + 2], g[4 * j + 3]);
}

// 1 + the last slot of an image with score > 0, over the threads of `group`
// threads (lane `t`) → each thread's part; the caller reduces
__device__ __forceinline__ int last_real(const float* s, int K, int t, int group) {
  int n = 0;
  for (int j = t; j < K; j += group)
    if (s[j] > 0.f) n = j + 1;
  return n;
}

__device__ __forceinline__ int warp_max(int v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = max(v, __shfl_xor_sync(kAll, v, o));
  return v;
}

// The greedy walk of one image by one warp over M (row stride W words, rows
// < n), the removed words in `rem` (W words; lane l owns words l, l + 32, ...),
// then keep for all K slots. Every lane of the warp calls it.
// LOADS rows' words are loaded at a time in the OR step: 8 from shared memory, 16 from L2.
template <int LOADS>
__device__ void walk(const uint32_t* M, int W, int n, int K, const float* scores, uint32_t* rem, bool* keep, int lane) {
  const int Wn = words(n);
  for (int w = lane; w < Wn; w += 32) rem[w] = 0u;
  __syncwarp();
  for (int c = 0; c < Wn; ++c) {
    const int base = c << 5, rows = min(32, n - base);
    uint32_t d[32];  // the diagonal words: row base + b, word c (bits > b only)
#pragma unroll
    for (int b = 0; b < 32; ++b) d[b] = b < rows ? M[size_t(base + b) * W + c] : 0u;
    uint32_t r = rem[c];  // word c as the rows of earlier rounds left it (written before the last __syncwarp)
#pragma unroll
    for (int b = 0; b < 32; ++b)
      if (!((r >> b) & 1u)) r |= d[b];
    const uint32_t kept = ~r & (rows == 32 ? kAll : ((1u << rows) - 1u));
    for (int w = lane; w < Wn; w += 32) {
      if (w <= c) continue;
      uint32_t acc = 0u;
      for (uint32_t m = kept; m;) {  // LOADS rows' loads in flight at a time, not one
        uint32_t v[LOADS];
#pragma unroll
        for (int u = 0; u < LOADS; ++u) {
          v[u] = m ? M[size_t(base + __ffs(m) - 1) * W + w] : 0u;
          m &= m - 1u;
        }
#pragma unroll
        for (int u = 0; u < LOADS; ++u) acc |= v[u];
      }
      rem[w] |= acc;
    }
    if (lane == (c & 31)) rem[c] = r;
    __syncwarp();
  }
  for (int j = lane; j < K; j += 32)
    keep[j] = j < n && !((rem[j >> 5] >> (j & 31)) & 1u) && scores[j] > 0.f;
}

// Row i of M by one warp, a word per step (lane b tests j = 32w + b), from the
// diagonal word to word ceil(n / 32) - 1, the boxes in shared memory (bx, ar)
// or, with bx null, in device memory (gb).
__device__ __forceinline__ void mask_row(const float4* bx, const float* ar, const float* gb, uint32_t* row, int i,
                                         int n, float thr, int lane) {
  const float4 bi = bx ? bx[i] : box_at(gb, i);
  const float ai = bx ? ar[i] : area_of(bi);
  const int Wn = words(n);
#pragma unroll 4
  for (int w = i >> 5; w < Wn; ++w) {
    const int j = (w << 5) + lane;
    bool hit = false;
    if (j > i && j < n) {
      if (bx) {
        hit = over(bi, ai, bx[j], ar[j], thr);
      } else {
        const float4 bj = box_at(gb, j);
        hit = over(bi, ai, bj, area_of(bj), thr);
      }
    }
    const uint32_t word = __ballot_sync(kAll, hit);
    if (lane == 0) row[w] = word;
  }
}

// One launch: a block per image, everything in shared memory.
__global__ void __launch_bounds__(kFusedThreads) nms_fused_kernel(const float* __restrict__ boxes,
                                                            const float* __restrict__ scores, bool* __restrict__ keep,
                                                            int K, float thr) {
  extern __shared__ __align__(16) unsigned char sm[];
  __shared__ int n_s;
  const int b = blockIdx.x, lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = kFusedThreads / 32;
  const int W = words(K);
  const float* s = scores + size_t(b) * K;
  if (threadIdx.x == 0) n_s = 0;
  __syncthreads();
  const int part = warp_max(last_real(s, K, threadIdx.x, kFusedThreads));
  if (lane == 0 && part) atomicMax(&n_s, part);
  __syncthreads();
  const int n = n_s;
  float4* bx = reinterpret_cast<float4*>(sm);
  float* ar = reinterpret_cast<float*>(bx + K);
  uint32_t* M = reinterpret_cast<uint32_t*>(ar + K);
  const float* gb = boxes + size_t(b) * K * 4;
  for (int j = threadIdx.x; j < n; j += kFusedThreads) {  // boxes and areas of slots < n
    const float4 v = box_at(gb, j);
    bx[j] = v;
    ar[j] = area_of(v);
  }
  __syncthreads();
  // M, a row per warp at a time (words left of the diagonal are never read)
  for (int i = warp; i < n; i += warps) mask_row(bx, ar, nullptr, M + size_t(i) * W, i, n, thr, lane);
  __syncthreads();
  if (warp == 0) walk<8>(M, W, n, K, s, M + size_t(K) * W, keep + size_t(b) * K, lane);
}

// Two launches, first: rows y, y + row_blocks, ... of image x's M into device memory
// (interleaved, so that the long rows at the top spread over all the row blocks).
__global__ void __launch_bounds__(kMaskThreads) nms_mask_kernel(const float* __restrict__ boxes,
                                                           const float* __restrict__ scores, uint32_t* __restrict__ mask,
                                                           int K, float thr, int row_blocks) {
  __shared__ int n_s;
  const int b = blockIdx.x, lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = kMaskThreads / 32;
  const int W = words(K);
  if (threadIdx.x == 0) n_s = 0;
  __syncthreads();
  const int part = warp_max(last_real(scores + size_t(b) * K, K, threadIdx.x, kMaskThreads));
  if (lane == 0 && part) atomicMax(&n_s, part);
  __syncthreads();
  const int n = n_s;
  const float* gb = boxes + size_t(b) * K * 4;
  uint32_t* M = mask + size_t(b) * K * W;
  for (int i = blockIdx.y + row_blocks * warp; i < n; i += row_blocks * warps)
    mask_row(nullptr, nullptr, gb, M + size_t(i) * W, i, n, thr, lane);
}

// Two launches, second: a warp walks an image's M from device memory.
__global__ void __launch_bounds__(kScanWarps * 32) nms_scan_kernel(const float* __restrict__ scores,
                                                                  const uint32_t* __restrict__ mask,
                                                                  bool* __restrict__ keep, int B, int K) {
  extern __shared__ __align__(16) unsigned char sm[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, W = words(K);
  const int b = blockIdx.x * kScanWarps + warp;
  if (b >= B) return;
  const float* s = scores + size_t(b) * K;
  const int n = warp_max(last_real(s, K, lane, 32));
  walk<16>(mask + size_t(b) * K * W, W, n, K, s, reinterpret_cast<uint32_t*>(sm) + size_t(warp) * W, keep + size_t(b) * K,
       lane);
}

template <typename Kern>
int lift_smem(Kern kern, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return int(cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes)));
}

}  // namespace

extern "C" {

// The plan of B images of K slots on the current card: out = {launches, blocks, shared
// bytes per block, row_blocks, scratch words}.
int yt_nms_plan(int B, int K, long long* out) {
  if (K < 1 || B < 0) return int(cudaErrorInvalidValue);
  int sms = 0;
  if (const int e = sm_count(&sms)) return e;
  const Plan p = plan_for(B, K, sms);
  if (size_t(p.smem) > kSmemMax || p.row_blocks > 65535) return int(cudaErrorInvalidValue);
  const long long v[5] = {p.launches, p.blocks, p.smem, p.row_blocks, p.scratch_words};
  for (int i = 0; i < 5; ++i) out[i] = v[i];
  return 0;
}

// One launch; an image's shared bytes must fit a block (K <= 1280).
int yt_nms_keep(const float* boxes, const float* scores, uint8_t* keep, int B, int K, float thr, void* stream) {
  if (K < 1 || B < 0) return int(cudaErrorInvalidValue);
  const size_t bytes = image_bytes(K);
  if (bytes > kSmemMax) return int(cudaErrorInvalidValue);
  if (B == 0) return 0;
  if (const int e = lift_smem(nms_fused_kernel, bytes)) return e;
  nms_fused_kernel<<<B, kFusedThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      boxes, scores, reinterpret_cast<bool*>(keep), K, thr);
  YT_RETURN_LAUNCH_ERROR();
}

// Two launches, for any K: `mask` holds B * K * ceil(K / 32) words.
int yt_nms_keep_split(const float* boxes, const float* scores, uint8_t* keep, uint32_t* mask, int B, int K, float thr,
                      void* stream) {
  if (K < 1 || B < 0) return int(cudaErrorInvalidValue);
  int sms = 0;
  if (const int e = sm_count(&sms)) return e;
  const int row_blocks = split_row_blocks(B, K, sms);
  const size_t bytes = size_t(kScanWarps) * words(K) * 4;
  if (bytes > kSmemMax || row_blocks > 65535) return int(cudaErrorInvalidValue);
  if (B == 0) return 0;
  if (const int e = lift_smem(nms_scan_kernel, bytes)) return e;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  nms_mask_kernel<<<dim3(B, row_blocks), kMaskThreads, 0, st>>>(boxes, scores, mask, K, thr, row_blocks);
  if (const cudaError_t e = cudaGetLastError()) return int(e);
  nms_scan_kernel<<<(B + kScanWarps - 1) / kScanWarps, kScanWarps * 32, bytes, st>>>(
      scores, mask, reinterpret_cast<bool*>(keep), B, K);
  YT_RETURN_LAUNCH_ERROR();
}

const char* yt_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
