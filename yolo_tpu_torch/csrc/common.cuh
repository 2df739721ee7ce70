// Shared helpers of the port's hand-written Hopper kernels (c2f.cu, head.cuh).
//
// Numerics follow the fused ConvBNAct path of the JAX package
// (yolo_tpu/ops/pallas_c2f.py, pallas_head.py): every product is exact and
// every sum runs in f32; a conv's f32 sum is rounded to the compute dtype, the
// bias is added in that dtype, and SiLU is x * round(logistic_f32(x)),
// rounded. With BF16 false every rounding is the identity and the kernels
// compute in plain f32.
//
// Activations are NHWC in global memory. Inside a block every intermediate
// map lives in shared memory in the compute dtype `S`, `ld` elements per
// pixel. The convs between shared maps run
// - in bf16 on the tensor cores (mma.sync m16n8k16 fed by ldmatrix, f32
//   accumulators), the maps' channels padded to a multiple of 16 with zeros
//   and `ld` = that + 8 so that the fragment loads of a warp hit 32 distinct
//   banks; the weights are streamed into shared memory in the layouts that
//   c2f.cu and head.cuh describe;
// - in f32 on the CUDA cores (tensor cores would round the inputs to tf32),
//   `ld` = channels | 1 (odd, conflict-free); weights are f32 HWIO
//   [tap][cin][cout], read warp-uniformly through L1.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

namespace yt {

__host__ __device__ constexpr int pad16(int c) { return (c + 15) & ~15; }
__host__ __device__ inline int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }
__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// elements per pixel of a shared map with c channels
__host__ __device__ constexpr int map_ld(int c, bool bf16) { return bf16 ? pad16(c) + 8 : (c | 1); }

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

// round an f32 value to the compute dtype and back
template <bool BF16>
__device__ __forceinline__ float rnd(float v) {
  if constexpr (BF16) {
    return __bfloat162float(__float2bfloat16_rn(v));
  } else {
    return v;
  }
}

// conv epilogue: round the f32 sum, add the bias in the compute dtype
template <bool BF16>
__device__ __forceinline__ float bias_add(float acc, float bias) {
  return rnd<BF16>(rnd<BF16>(acc) + bias);
}

// SiLU as the TPU kernels compute it: x * round(logistic_f32(x)), rounded
template <bool BF16>
__device__ __forceinline__ float silu(float x) {
  const float s = rnd<BF16>(1.0f / (1.0f + expf(-x)));
  return rnd<BF16>(x * s);
}

// zero a block's shared bytes (a multiple of 16) before the maps are written:
// the padded channels the tensor cores read must hold zeros, not garbage
__device__ __forceinline__ void zero_smem(unsigned char* p, size_t bytes) {
  for (size_t i = threadIdx.x * 16; i < bytes; i += blockDim.x * 16) *reinterpret_cast<uint4*>(p + i) = make_uint4(0, 0, 0, 0);
}

// OCB consecutive f32 weights (16-byte aligned when OCB % 4 == 0)
template <int OCB>
__device__ __forceinline__ void load_w(const float* __restrict__ p, float (&w)[OCB]) {
  if constexpr (OCB % 4 == 0) {
#pragma unroll
    for (int o = 0; o < OCB; o += 4) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(p + o));
      w[o] = q.x;
      w[o + 1] = q.y;
      w[o + 2] = q.z;
      w[o + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int o = 0; o < OCB; ++o) w[o] = __ldg(p + o);
  }
}

// A KSxKS stride-1 convolution between two shared-memory maps of one block,
// on the CUDA cores.
//
// `in` is a map of frame width `fw` pixels with `ld` elements per pixel; the
// conv reads input channels [0, cin) of it (offset the pointer for a channel
// slice). Output pixels are the rectangle (ry0, rx0, rh, rw) of the same frame
// (KS == 3 reads one pixel around it, which the caller keeps inside the frame).
// Weights are f32 HWIO: w[(k * cin + ci) * ldw + oc]. Work items are (pixel,
// OCB-wide group of output channels), pixel fastest, so the weight loads of a
// warp are uniform. `epi(fy, fx, oc0, acc)` consumes each item's f32 sums.
template <int KS, int OCB, typename S, class Epi>
__device__ __forceinline__ void conv_smem(const S* in, int fw, int ld, int cin, const float* __restrict__ w, int ldw,
                                          int ncout, int ry0, int rx0, int rh, int rw, Epi epi) {
  const int npx = rh * rw;
  const int items = npx * (ncout / OCB);
  for (int it = threadIdx.x; it < items; it += blockDim.x) {
    const int g = it / npx;
    const int p = it - g * npx;
    const int fy = ry0 + p / rw;
    const int fx = rx0 + p % rw;
    float acc[OCB];
#pragma unroll
    for (int o = 0; o < OCB; ++o) acc[o] = 0.f;
    const float* wg = w + g * OCB;
#pragma unroll
    for (int k = 0; k < KS * KS; ++k) {
      const S* ip = in + ((fy + k / KS - KS / 2) * fw + (fx + k % KS - KS / 2)) * ld;
      const float* wk = wg + k * cin * ldw;
      for (int ci = 0; ci < cin; ++ci) {
        const float v = to_f(ip[ci]);
        float wv[OCB];
        load_w<OCB>(wk + ci * ldw, wv);
#pragma unroll
        for (int o = 0; o < OCB; ++o) acc[o] = fmaf(v, wv[o], acc[o]);
      }
    }
    epi(fy, fx, g * OCB, acc);
  }
}

__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---- building blocks of kernels that stage both operands in shared memory
// (c2f.cu, head.cuh): 16-byte asynchronous copies global -> shared, bulk copies by the
// copy engine, and ldmatrix loads of four 8x8 bf16 matrices, one 16-byte row
// address per lane.

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* smem_dst, const void* gmem_src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(smem_dst)), "l"(gmem_src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// wait until at most `pending` (0..3) of this thread's committed groups are in flight
__device__ __forceinline__ void cp_async_wait(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
  }
}

// ---- bulk copies global -> shared by the copy engine (TMA without a tensor map): one thread
// asks for `bytes` contiguous bytes (a multiple of 16, both ends 16-byte aligned); the hardware
// reports them to an mbarrier in shared memory, which the block's threads wait on by phase parity.

__device__ __forceinline__ void mbar_init(uint64_t* bar, int arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(arrivals) : "memory");
}

// after the mbar_init calls, before any thread or the copy engine uses the barriers
__device__ __forceinline__ void mbar_init_fence() { asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory"); }

// one arrival that also announces `bytes` of copies, then the copy that will report them
__device__ __forceinline__ void bulk_copy_g2s(void* smem_dst, const void* gmem_src, uint32_t bytes, uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
                   smem_u32(smem_dst)),
               "l"(gmem_src), "r"(bytes), "r"(smem_u32(bar))
               : "memory");
}

// spin until the barrier's phase of this parity is complete (its copies have landed and are visible)
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "MBAR_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra MBAR_DONE;\n"
      "bra MBAR_WAIT;\n"
      "MBAR_DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* smem_row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(smem_row))
               : "memory");
}

// p -> (p / w, p % w) by one multiplication, exact for p * w < 2^32: the pixel indices of a
// stage are turned into rows and columns for every item and every epilogue row
struct RowCol {
  uint64_t m;
  int w;
  __device__ explicit RowCol(int w_) : m((uint64_t(1) << 32) / uint32_t(w_) + 1), w(w_) {}
  __device__ __forceinline__ void operator()(int p, int& row, int& col) const {
    row = int((uint64_t(uint32_t(p)) * m) >> 32);
    col = p - row * w;
  }
};

using bf16x2_t = __nv_bfloat162;

__device__ __forceinline__ bf16x2_t& pair_at(__nv_bfloat16* d) { return *reinterpret_cast<bf16x2_t*>(d); }

__device__ __forceinline__ uint32_t as_u32(bf16x2_t v) { return *reinterpret_cast<uint32_t*>(&v); }

// conv epilogue of two neighbouring channels' f32 sums without the activation (yt::bias_add<true>):
// the sums rounded to bf16, the bias (a bf16 value held in f32) added in bf16
__device__ __forceinline__ bf16x2_t bias2(float v0, float v1, bf16x2_t bias) {
  return __hadd2_rn(__floats2bfloat162_rn(v0, v1), bias);
}

// ConvBNAct epilogue of two neighbouring channels' f32 sums, with the roundings of
// yt::bias_add<true> and yt::silu<true>: the sum is rounded to bf16, the bias (a bf16 value
// held in f32) added in bf16, and SiLU is x * round(logistic_f32(x)), rounded. Packed bf16
// adds and multiplies round the exact result once, as the scalar f32 forms do (the _rn forms:
// the plain ones may be contracted with a following add, e.g. the residual's, into one fma
// that rounds once where the plain version rounds twice); the logistic's exponential and
// quotient are the fast intrinsics (their error is far below the rounding to bf16 that follows).
__device__ __forceinline__ bf16x2_t act2(float v0, float v1, bf16x2_t bias) {
  const bf16x2_t x = bias2(v0, v1, bias);
  const float2 xf = __bfloat1622float2(x);
  const float s0 = __fdividef(1.0f, 1.0f + __expf(-xf.x)), s1 = __fdividef(1.0f, 1.0f + __expf(-xf.y));
  return __hmul2_rn(x, __floats2bfloat162_rn(s0, s1));
}

}  // namespace yt

// every C entry returns the CUDA error of its launch (0 = cudaSuccess)
#define YT_RETURN_LAUNCH_ERROR() return static_cast<int>(cudaGetLastError())
