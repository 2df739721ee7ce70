// One whole C2f block in one kernel: cv1 1x1 -> split -> n Bottlenecks (two
// 3x3 ConvBNAct each, optional residual) -> concat -> cv2 1x1, with every
// intermediate map in shared memory. A mode with a second, half-resolution
// input computes C2f(concat(up2x_nearest(small), skip)) without the upsampled
// map or the concat ever existing.
//
// Replaces yolo_tpu/ops/pallas_c2f.py::_c2f_kernel (entries fused_c2f and
// fused_c2f_upconcat). The TPU kernel streams image rows in order and carries
// ring buffers from one grid step to the next; Hopper blocks run in no order
// and share nothing, so here each block owns one output tile of one frame and
// recomputes the halo its chain of 3x3 convs needs (2n pixels on each side):
//   cv1 (b half) over tile+2n, cv1 (a half) over the tile, bottleneck i's
//   first conv over tile+(2n-2i-1), its second conv over tile+(2n-2i-2).
// Each map is zero outside the image (the 3x3 convs' padding of 1). cv2 over
// the concat is a sum of per-segment 1x1 products, accumulated in f32 in
// shared memory as each segment (y_a, y_b, m_0 .. m_{n-1}) becomes ready, so
// no segment has to outlive its stage. In upconcat mode cv1 reads
// small[h/2, w/2] directly (the TPU kernel's host-side W-repeat is not needed).
//
// What bounds it on the H100: operations. The block moves only its input(s)
// and output through device memory (chip_smoke.py prints both bounds per
// instance). In bf16 the 3x3 convs and cv2 run on the tensor cores
// (mma.sync, common.cuh); cv1 reads global memory and runs on the CUDA cores,
// as does everything in f32 (f32 inputs must work, for exact-track checks).
// The halo recompute is the design's cost: it is largest for n=3 and for the
// 16x20 maps of layers 8 and 24, whose tiles are small next to their 2n halo.
// The tile is the one with the least recompute whose shared maps fit in
// 113 KB (two blocks per SM), else in 227 KB.
#include "common.cuh"

namespace {

using namespace yt;

struct C2fArgs {
  const void* x;      // plain: (B, H, W, c1); upconcat: skip (B, H, W, c1 - cs)
  const void* small;  // upconcat: (B, H/2, W/2, cs); plain: null
  void* out;          // (B, H, W, c2o)
  const float* w1;    // cv1 [c1][2c] (upconcat: the small channels' rows first)
  const float* b1;    // [2c]
  const void* wm;     // bottleneck i conv j (2i + j): f32 [9][c][c], or bf16 [9][pad16(c)][pad16(c)]
  const float* bm;    // bias of bottleneck i conv j at (2i + j) * c
  const void* w2;     // cv2: f32 [(2 + n) c][c2o], or per segment bf16 [2 + n][pad16(c2o)][pad16(c)]
  const float* b2;    // [c2o]
  int B, H, W, c1, cs, c, c2o, n, shortcut;
  int th, tw;  // output tile
};

__host__ __device__ inline size_t align16(size_t v) { return (v + 15) & ~size_t(15); }

// shared bytes of one block: two frame-sized maps of c channels (compute
// dtype) and the f32 cv2 accumulator over the tile
__host__ __device__ inline size_t c2f_frame_bytes(int th, int tw, int n, int c, bool bf16) {
  const int R = 2 * n;
  return align16(size_t(th + 2 * R) * (tw + 2 * R) * map_ld(c, bf16) * (bf16 ? 2 : 4));
}
__host__ __device__ inline size_t c2f_smem(int th, int tw, int n, int c, int c2o, bool bf16) {
  return 2 * c2f_frame_bytes(th, tw, n, c, bf16) + size_t(th) * tw * (c2o | 1) * 4;
}

template <typename T, bool BF16, int OCB>
__global__ void __launch_bounds__(256) c2f_kernel(C2fArgs a) {
  using S = T;
  extern __shared__ __align__(16) unsigned char smem[];
  const int R = 2 * a.n;
  const int th = a.th, tw = a.tw, H = a.H, W = a.W, c = a.c, c2o = a.c2o;
  const int FH = th + 2 * R, FW = tw + 2 * R;
  const int ld = map_ld(c, BF16), ld2 = c2o | 1;
  const size_t frame_bytes = c2f_frame_bytes(th, tw, a.n, c, BF16);
  S* buf0 = reinterpret_cast<S*>(smem);
  S* buf1 = reinterpret_cast<S*>(smem + frame_bytes);
  float* acc2 = reinterpret_cast<float*>(smem + 2 * frame_bytes);
  if constexpr (BF16) zero_smem(smem, 2 * frame_bytes);  // padded channels read as zeros
  // weights of bottleneck conv j and of cv2 segment s in this dtype's layout
  auto wm_of = [&](int j) -> const void* {
    if constexpr (BF16) return static_cast<const __nv_bfloat16*>(a.wm) + size_t(j) * 9 * pad16(c) * pad16(c);
    else return static_cast<const float*>(a.wm) + size_t(j) * 9 * c * c;
  };
  auto w2_of = [&](int seg) -> const void* {
    if constexpr (BF16) return static_cast<const __nv_bfloat16*>(a.w2) + size_t(seg) * pad16(c2o) * pad16(c);
    else return static_cast<const float*>(a.w2) + size_t(seg) * c * c2o;
  };

  const int tiles_x = (W + tw - 1) / tw;
  const int b = blockIdx.y;
  const int oy = (blockIdx.x / tiles_x) * th - R;  // image row of frame row 0
  const int ox = (blockIdx.x % tiles_x) * tw - R;
  auto inside = [&](int fy, int fx) {
    const int iy = oy + fy, ix = ox + fx;
    return iy >= 0 && iy < H && ix >= 0 && ix < W;
  };

  const T* x = static_cast<const T*>(a.x);
  const T* small = static_cast<const T*>(a.small);
  const int cs = a.cs, ck = a.c1 - a.cs, c2 = 2 * c;

  // ---- cv1 (1x1 from global memory): channels [half*c, half*c + c) over a rectangle
  auto cv1 = [&](int half, S* dst, int ry0, int rx0, int rh, int rw) {
    const int npx = rh * rw;
    const int items = npx * (c / OCB);
    for (int it = threadIdx.x; it < items; it += blockDim.x) {
      const int g = it / npx, p = it - g * npx;
      const int fy = ry0 + p / rw, fx = rx0 + p % rw;
      S* d = dst + (fy * FW + fx) * ld + g * OCB;
      if (!inside(fy, fx)) {
#pragma unroll
        for (int o = 0; o < OCB; ++o) d[o] = from_f<S>(0.f);
        continue;
      }
      const int iy = oy + fy, ix = ox + fx;
      const int oc0 = half * c + g * OCB;
      float acc[OCB];
#pragma unroll
      for (int o = 0; o < OCB; ++o) acc[o] = 0.f;
      if (cs) {
        const T* sp = small + ((size_t(b) * (H / 2) + iy / 2) * (W / 2) + ix / 2) * cs;
        for (int ci = 0; ci < cs; ++ci) {
          const float v = to_f(sp[ci]);
          float wv[OCB];
          load_w<OCB>(a.w1 + ci * c2 + oc0, wv);
#pragma unroll
          for (int o = 0; o < OCB; ++o) acc[o] = fmaf(v, wv[o], acc[o]);
        }
      }
      const T* xp = x + ((size_t(b) * H + iy) * W + ix) * ck;
      for (int ci = 0; ci < ck; ++ci) {
        const float v = to_f(xp[ci]);
        float wv[OCB];
        load_w<OCB>(a.w1 + (cs + ci) * c2 + oc0, wv);
#pragma unroll
        for (int o = 0; o < OCB; ++o) acc[o] = fmaf(v, wv[o], acc[o]);
      }
#pragma unroll
      for (int o = 0; o < OCB; ++o) d[o] = from_f<S>(silu<BF16>(bias_add<BF16>(acc[o], __ldg(a.b1 + oc0 + o))));
    }
  };

  // ---- cv2 partial product of concat segment `seg` (a map of c channels) over the tile
  auto cv2_acc = [&](const S* src, int seg, bool init) {
    conv<1, 8, BF16>(src, FW, ld, c, w2_of(seg), c2o, c2o, R, R, th, tw, [&](int fy, int fx, int oc, float v) {
      float* d = acc2 + ((fy - R) * tw + (fx - R)) * ld2 + oc;
      *d = init ? v : *d + v;
    });
  };

  if constexpr (BF16) __syncthreads();  // zeroed before the maps are written
  cv1(1, buf0, 0, 0, FH, FW);  // y_b over the whole frame: the bottleneck chain's input
  cv1(0, buf1, R, R, th, tw);  // y_a over the tile: only cv2 reads it
  __syncthreads();
  cv2_acc(buf1, 0, true);
  cv2_acc(buf0, 1, false);

  for (int i = 0; i < a.n; ++i) {
    const int h1 = R - 2 * i - 1, h2 = R - 2 * i - 2;
    const float* b_1 = a.bm + (2 * i) * c;
    const float* b_2 = a.bm + (2 * i + 1) * c;
    __syncthreads();  // buf0 complete; the last readers of buf1 are done
    conv<3, OCB, BF16>(buf0, FW, ld, c, wm_of(2 * i), c, c, R - h1, R - h1, th + 2 * h1, tw + 2 * h1,
                       [&](int fy, int fx, int oc, float v) {
                         buf1[(fy * FW + fx) * ld + oc] =
                             from_f<S>(inside(fy, fx) ? silu<BF16>(bias_add<BF16>(v, __ldg(b_1 + oc))) : 0.f);
                       });
    __syncthreads();
    // second conv in place over buf0: an output element reads only its own residual
    conv<3, OCB, BF16>(buf1, FW, ld, c, wm_of(2 * i + 1), c, c, R - h2, R - h2, th + 2 * h2, tw + 2 * h2,
                       [&](int fy, int fx, int oc, float v) {
                         S* d = buf0 + (fy * FW + fx) * ld + oc;
                         v = silu<BF16>(bias_add<BF16>(v, __ldg(b_2 + oc)));
                         if (a.shortcut) v = rnd<BF16>(v + to_f(*d));
                         *d = from_f<S>(inside(fy, fx) ? v : 0.f);
                       });
    __syncthreads();
    cv2_acc(buf0, 2 + i, false);
  }
  __syncthreads();

  // ---- cv2 epilogue: consecutive threads write consecutive channels of a pixel
  T* out = static_cast<T*>(a.out);
  for (int idx = threadIdx.x; idx < th * tw * c2o; idx += blockDim.x) {
    const int p = idx / c2o, o = idx - p * c2o;
    const int fy = R + p / tw, fx = R + p % tw;
    if (!inside(fy, fx)) continue;
    const float v = silu<BF16>(bias_add<BF16>(acc2[p * ld2 + o], __ldg(a.b2 + o)));
    out[((size_t(b) * H + oy + fy) * W + ox + fx) * c2o + o] = from_f<T>(v);
  }
}

// the tile with the least halo recompute whose shared maps fit the budget
void pick_tile(int H, int W, int n, int c, int c2o, bool bf16, int* th, int* tw, size_t* bytes) {
  static const int cand[][2] = {{32, 32}, {16, 32}, {16, 16}, {8, 32}, {8, 16}, {8, 8},
                                {4, 16}, {4, 8},   {4, 4},   {2, 8},  {2, 4},  {1, 4}};
  const int R = 2 * n;
  for (size_t budget : {size_t(113) << 10, size_t(227) << 10}) {
    double best = -1.0;
    for (const auto& t : cand) {
      const int h = t[0] < H ? t[0] : H, w = t[1] < W ? t[1] : W;
      const size_t s = c2f_smem(h, w, n, c, c2o, bf16);
      const double eff = double(h) * w / (double(h + 2 * R) * (w + 2 * R));
      if (s <= budget && eff > best) {
        best = eff;
        *th = h;
        *tw = w;
        *bytes = s;
      }
    }
    if (best > 0) return;
  }
  *th = *tw = 0;
  *bytes = 0;
}

template <typename T, bool BF16, int OCB>
int launch(const C2fArgs& a, size_t bytes, cudaStream_t stream) {
  auto kern = c2f_kernel<T, BF16, OCB>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (e != cudaSuccess) return int(e);
  const int tiles = ((a.H + a.th - 1) / a.th) * ((a.W + a.tw - 1) / a.tw);
  kern<<<dim3(tiles, a.B), 256, bytes, stream>>>(a);
  YT_RETURN_LAUNCH_ERROR();
}

}  // namespace

extern "C" {

// tile rows, tile columns and shared bytes the kernel uses for this instance
int yt_c2f_plan(int H, int W, int c, int c2o, int n, int bf16, int* th, int* tw, long long* bytes) {
  size_t s = 0;
  pick_tile(H, W, n, c, c2o, bf16 != 0, th, tw, &s);
  *bytes = static_cast<long long>(s);
  return *th > 0 ? 0 : int(cudaErrorInvalidConfiguration);
}

int yt_c2f_forward(const void* x, const void* small, void* out, const float* w1, const float* b1, const void* wm,
                   const float* bm, const void* w2, const float* b2, int B, int H, int W, int c1, int cs, int c,
                   int c2o, int n, int shortcut, int bf16, void* stream) {
  if (c % 4 || c2o % 8 || n < 1 || (cs && (H % 2 || W % 2))) return int(cudaErrorInvalidValue);
  C2fArgs a{x, small, out, w1, b1, wm, bm, w2, b2, B, H, W, c1, cs, c, c2o, n, shortcut, 0, 0};
  size_t bytes = 0;
  pick_tile(H, W, n, c, c2o, bf16 != 0, &a.th, &a.tw, &bytes);
  if (!a.th) return int(cudaErrorInvalidConfiguration);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return c % 8 ? launch<__nv_bfloat16, true, 4>(a, bytes, s) : launch<__nv_bfloat16, true, 8>(a, bytes, s);
  }
  return c % 8 ? launch<float, false, 4>(a, bytes, s) : launch<float, false, 8>(a, bytes, s);
}

}  // extern "C"
