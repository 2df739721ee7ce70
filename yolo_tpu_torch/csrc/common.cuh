// Shared helpers of the port's hand-written Hopper kernels (c2f.cu, head.cu).
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
// - in bf16 on the tensor cores (mma.sync m16n8k16, f32 accumulators), the
//   maps' channels padded to a multiple of 16 with zeros and `ld` = that + 8
//   so that the fragment loads of a warp hit 32 distinct banks; weights are
//   bf16 [tap][cout padded to 16][cin padded to 16], read through L1;
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

// elements per pixel of a shared map with c channels
__host__ __device__ constexpr int map_ld(int c, bool bf16) { return bf16 ? pad16(c) + 8 : (c | 1); }

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename S>
__device__ __forceinline__ S from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) { return __float2bfloat16_rn(v); }

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

// The same convolution in bf16 on the tensor cores, as an implicit GEMM:
// rows = output pixels, K = taps x input channels, N = output channels. A warp
// item is 16 pixels x 8*NT output channels; per tap and 16-channel step it
// loads the A fragment from the shifted input pixels in shared memory and the
// B fragments from `w` = bf16 [tap][pad16(ncout)][pad16(cin)]. The map's
// channels [cin, pad16(cin)) must be zero. `put(fy, fx, oc, v)` consumes each
// output element's f32 sum.
template <int KS, int NT, class Put>
__device__ __forceinline__ void conv_smem_mma(const __nv_bfloat16* in, int fw, int ld, int cin,
                                              const __nv_bfloat16* __restrict__ w, int ncout, int ry0, int rx0, int rh,
                                              int rw, Put put) {
  const int kp = pad16(cin), np = pad16(ncout);
  const int npx = rh * rw;
  const int mtiles = (npx + 15) / 16, ntiles = (np + 8 * NT - 1) / (8 * NT);
  const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  for (int item = threadIdx.x >> 5; item < mtiles * ntiles; item += blockDim.x >> 5) {
    const int m = item % mtiles, nb = (item / mtiles) * 8 * NT;
    const int p0 = m * 16 + gid, p1 = p0 + 8;
    const int q0 = p0 < npx ? p0 : npx - 1, q1 = p1 < npx ? p1 : npx - 1;
    const int fy0 = ry0 + q0 / rw, fx0 = rx0 + q0 % rw;
    const int fy1 = ry0 + q1 / rw, fx1 = rx0 + q1 % rw;
    const __nv_bfloat16* r0 = in + (fy0 * fw + fx0) * ld + tig * 2;
    const __nv_bfloat16* r1 = in + (fy1 * fw + fx1) * ld + tig * 2;
    float acc[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
    for (int k = 0; k < KS * KS; ++k) {
      const int off = ((k / KS - KS / 2) * fw + (k % KS - KS / 2)) * ld;
      const __nv_bfloat16* wk = w + (size_t(k) * np + nb + gid) * kp + tig * 2;
      for (int kc = 0; kc < kp; kc += 16) {
        uint32_t a[4];
        a[0] = *reinterpret_cast<const uint32_t*>(r0 + off + kc);
        a[1] = *reinterpret_cast<const uint32_t*>(r1 + off + kc);
        a[2] = *reinterpret_cast<const uint32_t*>(r0 + off + kc + 8);
        a[3] = *reinterpret_cast<const uint32_t*>(r1 + off + kc + 8);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          if (nb + j * 8 < np) {
            const __nv_bfloat16* wj = wk + j * 8 * kp + kc;
            mma_bf16_16816(acc[j], a, __ldg(reinterpret_cast<const unsigned int*>(wj)),
                           __ldg(reinterpret_cast<const unsigned int*>(wj + 8)));
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int oc = nb + j * 8 + tig * 2;
      if (p0 < npx) {
        if (oc < ncout) put(fy0, fx0, oc, acc[j][0]);
        if (oc + 1 < ncout) put(fy0, fx0, oc + 1, acc[j][1]);
      }
      if (p1 < npx) {
        if (oc < ncout) put(fy1, fx1, oc, acc[j][2]);
        if (oc + 1 < ncout) put(fy1, fx1, oc + 1, acc[j][3]);
      }
    }
  }
}

// A conv between shared maps with a per-element epilogue: tensor cores in
// bf16 (w: bf16 [tap][pad16(ncout)][pad16(cin)]), CUDA cores in f32 (w: f32
// HWIO with row stride ldw).
template <int KS, int OCB, bool BF16, typename S, class Put>
__device__ __forceinline__ void conv(const S* in, int fw, int ld, int cin, const void* w, int ldw, int ncout, int ry0,
                                     int rx0, int rh, int rw, Put put) {
  if constexpr (BF16) {
    conv_smem_mma<KS, 2>(in, fw, ld, cin, static_cast<const __nv_bfloat16*>(w), ncout, ry0, rx0, rh, rw, put);
  } else {
    conv_smem<KS, OCB, S>(in, fw, ld, cin, static_cast<const float*>(w), ldw, ncout, ry0, rx0, rh, rw,
                          [&](int fy, int fx, int oc0, float(&acc)[OCB]) {
#pragma unroll
                            for (int o = 0; o < OCB; ++o) put(fy, fx, oc0 + o, acc[o]);
                          });
  }
}

}  // namespace yt

// every C entry returns the CUDA error of its launch (0 = cudaSuccess)
#define YT_RETURN_LAUNCH_ERROR() return static_cast<int>(cudaGetLastError())
