// One Detect level, channel-major: the merged reg|cls first 3x3 ConvBNAct,
// each branch's second 3x3 ConvBNAct, the two 1x1 heads, the DFL
// softmax-projection of the bins and the sigmoid of the cls logits, in one
// kernel. x (B, H, W, C) NHWC in, dist (B, H*W, 4) f32 and cls scores
// (B, H*W, nc) f32 out; nothing else touches device memory.
//
// Replaces yolo_tpu/ops/pallas_head2.py::head_level_cm. What that kernel is
// about is the orientation of its products: out-channels are the GEMM's M,
// channels x taps the K and pixels the dense N. Its means (a channel-major
// relayout of x before the call, rows streamed through 3-slot rings across
// grid steps, rotated weight tables, a tile width that must divide W) belong
// to the TPU and are not carried over. Here:
// - a block owns one (frame, row band, W tile) and loops over the stages
//   itself. It reads its NHWC input tile plus a 2-pixel halo straight into
//   shared memory with 16-byte loads (no relayout pass before the kernel),
//   keeps the merged first conv over tile + 1 and both second convs' outputs
//   in shared memory, and masks the ragged edge, so every W >= 1 and every C
//   (P5 at 192 included) works: the tile shrinks until the maps fit;
// - in bf16 every product, the 1x1 heads included, runs on the tensor cores
//   (mma.sync m16n8k16, f32 accumulators) with the weights as the A operand
//   (rows = out channels, [tap][cout][cin] in global memory, read through L1
//   and reused over NT pixel tiles) and the shared maps as the B operand
//   (columns = pixels, K = channels contiguous per pixel, pixel stride
//   pad16 + 8 halves so that a warp's fragment loads hit 32 banks);
// - the accumulator fragment then holds the 16 bins of one box side down the
//   rows of one m-tile, so the DFL max and the two f32 sums are three
//   warp-shuffle steps each and the bins never leave registers; the cls
//   logits go through the logistic in the same epilogue;
// - in f32 (the exact-track mode; tensor cores would round to tf32) the same
//   stages run on the CUDA cores through common.cuh's conv_smem.
// Zero outside the map stands in for the second convs' padding (not
// silu(bias)), as pallas_head2.py:192-216 does with its masked ring columns.
//
// What bounds it on the H100: operations (chip_smoke.py prints both bounds
// per level); the halo recompute of the first conv and the weight fragments
// read from L1 per item are what it pays above that bound.
#include "common.cuh"

namespace {

using namespace yt;

constexpr int kRegMax = 16;
constexpr int kThreads = 256;
constexpr int kMaxTileH = 16, kMaxTileW = 40;

struct CmArgs {
  const void* x;  // (B, H, W, C)
  float* dist;    // (B, H*W, 4)
  float* cls;     // (B, H*W, nc) sigmoid scores
  // conv weights: bf16 [taps][pad16(cout)][pad16(cin)], or f32 HWIO [taps][cin][cout]
  const void* w0;   // merged first conv, cin C, cout c2 + c3 (reg channels first)
  const void* w1r;  // reg second conv, c2 -> c2
  const void* w1c;  // cls second conv, c3 -> c3
  const void* w2r;  // reg 1x1, c2 -> 4 * reg_max
  const void* w2c;  // cls 1x1, c3 -> nc
  const float *b0, *b1r, *b1c, *b2r, *b2c;
  const float* proj;  // [reg_max] DFL projection
  int B, H, W, C, c2, c3, nc;
  int th, tw;
};

__host__ __device__ inline size_t align16(size_t v) { return (v + 15) & ~size_t(15); }

struct CmSmem {
  size_t xs, t1, r2, cc, total;
};

// shared maps, all in the compute dtype: the input over tile + 2, the merged
// first conv over tile + 1, the two second convs' outputs over the tile
__host__ __device__ inline CmSmem cm_smem(int th, int tw, int C, int c2, int c3, bool bf16) {
  const int esz = bf16 ? 2 : 4;
  CmSmem s;
  s.xs = align16(size_t(th + 4) * (tw + 4) * map_ld(C, bf16) * esz);
  s.t1 = align16(size_t(th + 2) * (tw + 2) * map_ld(c2 + c3, bf16) * esz);
  s.r2 = align16(size_t(th) * tw * map_ld(c2, bf16) * esz);
  s.cc = align16(size_t(th) * tw * map_ld(c3, bf16) * esz);
  s.total = s.xs + s.t1 + s.r2 + s.cc;
  return s;
}

// D[out channel][pixel] = sum over taps and channels of W[tap][out][cin] *
// in[pixel + tap][cin], on the tensor cores. `in` is a shared map of frame
// width `fw`, `ld` halves per pixel, channels [cin, pad16(cin)) zero; the
// output pixels are the rectangle (y0, x0, rh, rw) of that frame, flattened
// row-major into the GEMM's N. A warp item is 16*MT out channels x 8*NT
// pixels: per tap and 16-channel step it loads MT weight fragments (A) and NT
// pixel fragments (B) and runs MT*NT mma. `epi(m0, n0, acc)` consumes the
// item's accumulators: acc[mt][nt][r] is out channel m0 + 16 mt + gid + 8 (r
// >> 1) at pixel n0 + 8 nt + 2 tig + (r & 1), gid = lane / 4, tig = lane % 4.
template <int KS, int MT, int NT, class Epi>
__device__ __forceinline__ void gemm_cm(const __nv_bfloat16* in, int fw, int ld, int cin,
                                        const __nv_bfloat16* __restrict__ w, int ncout, int y0, int x0, int rh, int rw,
                                        Epi epi) {
  const int kp = pad16(cin), np = pad16(ncout);
  const int npx = rh * rw;
  const int ngroups = (npx + 8 * NT - 1) / (8 * NT), mgroups = (np + 16 * MT - 1) / (16 * MT);
  const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  for (int item = threadIdx.x >> 5; item < ngroups * mgroups; item += blockDim.x >> 5) {
    const int n0 = (item % ngroups) * 8 * NT, m0 = (item / ngroups) * 16 * MT;
    const __nv_bfloat16* bp[NT];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      int p = n0 + nt * 8 + gid;
      p = p < npx ? p : npx - 1;
      bp[nt] = in + ((y0 + p / rw) * fw + x0 + p % rw) * ld + tig * 2;
    }
    float acc[MT][NT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;
#pragma unroll
    for (int k = 0; k < KS * KS; ++k) {
      const int off = ((k / KS - KS / 2) * fw + (k % KS - KS / 2)) * ld;
      const __nv_bfloat16* wk = w + (size_t(k) * np + m0 + gid) * kp + tig * 2;
      for (int kc = 0; kc < kp; kc += 16) {
        uint32_t a[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          if (m0 + mt * 16 < np) {
            const __nv_bfloat16* wm = wk + size_t(mt) * 16 * kp + kc;
            a[mt][0] = __ldg(reinterpret_cast<const unsigned int*>(wm));
            a[mt][1] = __ldg(reinterpret_cast<const unsigned int*>(wm + 8 * kp));
            a[mt][2] = __ldg(reinterpret_cast<const unsigned int*>(wm + 8));
            a[mt][3] = __ldg(reinterpret_cast<const unsigned int*>(wm + 8 * kp + 8));
          } else {
            a[mt][0] = a[mt][1] = a[mt][2] = a[mt][3] = 0u;
          }
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const uint32_t b0 = *reinterpret_cast<const uint32_t*>(bp[nt] + off + kc);
          const uint32_t b1 = *reinterpret_cast<const uint32_t*>(bp[nt] + off + kc + 8);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            if (m0 + mt * 16 < np) mma_bf16_16816(acc[mt][nt], a[mt], b0, b1);
          }
        }
      }
    }
    epi(m0, n0, acc);
  }
}

// every element of an item's accumulators as f(out channel, pixel, f32 sum)
template <int MT, int NT, class F>
__device__ __forceinline__ void frag_each(const float (&acc)[MT][NT][4], int m0, int n0, F f) {
  const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) f(m0 + mt * 16 + gid + (r >> 1) * 8, n0 + nt * 8 + tig * 2 + (r & 1), acc[mt][nt][r]);
}

// butterfly over the 8 lanes that hold one pixel's column of an m-tile
__device__ __forceinline__ float col_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 4));
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 8));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 16));
}
__device__ __forceinline__ float col_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  return v + __shfl_xor_sync(0xffffffffu, v, 16);
}

__device__ __forceinline__ float logistic(float z) { return 1.0f / (1.0f + expf(-z)); }

template <typename T, bool BF16>
__global__ void __launch_bounds__(kThreads) head_cm_kernel(CmArgs a) {
  using S = T;
  extern __shared__ __align__(16) unsigned char smem[];
  const int th = a.th, tw = a.tw, H = a.H, W = a.W, C = a.C, c2 = a.c2, c3 = a.c3, nc = a.nc;
  const int FWX = tw + 4, FHX = th + 4;  // input frame: image origin (oy - 2, ox - 2)
  const int FW1 = tw + 2, FH1 = th + 2;  // first-conv frame: image origin (oy - 1, ox - 1)
  const int c23 = c2 + c3;
  const int ldx = map_ld(C, BF16), ld1 = map_ld(c23, BF16), ldr = map_ld(c2, BF16), ldc = map_ld(c3, BF16);
  const CmSmem L = cm_smem(th, tw, C, c2, c3, BF16);
  S* xs = reinterpret_cast<S*>(smem);
  S* t1 = reinterpret_cast<S*>(smem + L.xs);
  S* r2 = reinterpret_cast<S*>(smem + L.xs + L.t1);
  S* cc = reinterpret_cast<S*>(smem + L.xs + L.t1 + L.r2);

  const int tiles_x = (W + tw - 1) / tw;
  const int b = blockIdx.y;
  const int oy = (blockIdx.x / tiles_x) * th;  // image row of the tile's first row
  const int ox = (blockIdx.x % tiles_x) * tw;
  const size_t HW = size_t(H) * W;
  const T* x = static_cast<const T*>(a.x) + size_t(b) * HW * C;

  if constexpr (BF16) {  // the padded channels the tensor cores read must be zeros
    zero_smem(smem, L.total);
    __syncthreads();
  }
  // ---- input tile + 2 (zero outside the image), straight from NHWC: a frame
  // row is one contiguous run of (tw + 4) * C elements of global memory
  if (BF16 && C % 8 == 0) {
    const int cv = C / 8;  // 16-byte chunks per pixel
    for (int idx = threadIdx.x; idx < FHX * FWX * cv; idx += blockDim.x) {
      const int p = idx / cv, q = idx - p * cv;
      const int fy = p / FWX, fx = p - fy * FWX;
      const int iy = oy - 2 + fy, ix = ox - 2 + fx;
      if (iy >= 0 && iy < H && ix >= 0 && ix < W) {
        *reinterpret_cast<uint4*>(xs + size_t(p) * ldx + q * 8) =
            __ldg(reinterpret_cast<const uint4*>(x + (size_t(iy) * W + ix) * C + q * 8));
      }
    }
  } else {
    for (int idx = threadIdx.x; idx < FHX * FWX * C; idx += blockDim.x) {
      const int p = idx / C, ci = idx - p * C;
      const int fy = p / FWX, fx = p - fy * FWX;
      const int iy = oy - 2 + fy, ix = ox - 2 + fx;
      xs[size_t(p) * ldx + ci] =
          (iy >= 0 && iy < H && ix >= 0 && ix < W) ? x[(size_t(iy) * W + ix) * C + ci] : from_f<S>(0.f);
    }
  }
  __syncthreads();

  // ---- stage 1: merged first conv (reg | cls) over tile + 1, zero outside the map
  auto put1 = [&](int ty, int tx, int oc, float v) {
    const int iy = oy - 1 + ty, ix = ox - 1 + tx;
    const bool in_map = iy >= 0 && iy < H && ix >= 0 && ix < W;
    t1[(ty * FW1 + tx) * ld1 + oc] = from_f<S>(in_map ? silu<BF16>(bias_add<BF16>(v, __ldg(a.b0 + oc))) : 0.f);
  };
  // ---- stage 2: the second convs over the tile
  auto put2r = [&](int py, int px, int oc, float v) {
    r2[(py * tw + px) * ldr + oc] = from_f<S>(silu<BF16>(bias_add<BF16>(v, __ldg(a.b1r + oc))));
  };
  auto put2c = [&](int py, int px, int oc, float v) {
    cc[(py * tw + px) * ldc + oc] = from_f<S>(silu<BF16>(bias_add<BF16>(v, __ldg(a.b1c + oc))));
  };
  // ---- stage 3 stores: a pixel of the tile that lies inside the image
  auto out_index = [&](int p, size_t* at) {
    const int py = p / tw, px = p - py * tw;
    const int iy = oy + py, ix = ox + px;
    *at = size_t(b) * HW + size_t(iy) * W + ix;
    return p < th * tw && iy < H && ix < W;
  };

  if constexpr (BF16) {
    const __nv_bfloat16* xs16 = xs;
    const int n1 = FH1 * FW1, n2 = th * tw;
    gemm_cm<3, 2, 4>(xs16, FWX, ldx, C, static_cast<const __nv_bfloat16*>(a.w0), c23, 1, 1, FH1, FW1,
                     [&](int m0, int n0, const float(&acc)[2][4][4]) {
                       frag_each<2, 4>(acc, m0, n0, [&](int oc, int p, float v) {
                         if (oc < c23 && p < n1) put1(p / FW1, p % FW1, oc, v);
                       });
                     });
    __syncthreads();
    gemm_cm<3, 2, 4>(t1, FW1, ld1, c2, static_cast<const __nv_bfloat16*>(a.w1r), c2, 1, 1, th, tw,
                     [&](int m0, int n0, const float(&acc)[2][4][4]) {
                       frag_each<2, 4>(acc, m0, n0, [&](int oc, int p, float v) {
                         if (oc < c2 && p < n2) put2r(p / tw, p % tw, oc, v);
                       });
                     });
    gemm_cm<3, 2, 4>(t1 + c2, FW1, ld1, c3, static_cast<const __nv_bfloat16*>(a.w1c), c3, 1, 1, th, tw,
                     [&](int m0, int n0, const float(&acc)[2][4][4]) {
                       frag_each<2, 4>(acc, m0, n0, [&](int oc, int p, float v) {
                         if (oc < c3 && p < n2) put2c(p / tw, p % tw, oc, v);
                       });
                     });
    __syncthreads();
    // reg 1x1 + DFL: the four m-tiles of an item are the four box sides, an
    // m-tile's 16 rows one side's bins: lane (gid, tig) holds bins gid and
    // gid + 8 of pixels 2 tig and 2 tig + 1 of each n-tile
    const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
    const float pj0 = __ldg(a.proj + gid), pj1 = __ldg(a.proj + gid + 8);
    gemm_cm<1, 4, 2>(r2, tw, ldr, c2, static_cast<const __nv_bfloat16*>(a.w2r), 4 * kRegMax, 0, 0, th, tw,
                     [&](int, int n0, const float(&acc)[4][2][4]) {
                       float res[2][2] = {};
#pragma unroll
                       for (int side = 0; side < 4; ++side) {
                         const float bs0 = __ldg(a.b2r + side * kRegMax + gid), bs1 = __ldg(a.b2r + side * kRegMax + gid + 8);
#pragma unroll
                         for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
                           for (int j = 0; j < 2; ++j) {
                             const float v0 = bias_add<BF16>(acc[side][nt][j], bs0);
                             const float v1 = bias_add<BF16>(acc[side][nt][2 + j], bs1);
                             const float m = col_max(fmaxf(v0, v1));
                             const float e0 = rnd<BF16>(expf(rnd<BF16>(v0 - m)));
                             const float e1 = rnd<BF16>(expf(rnd<BF16>(v1 - m)));
                             const float num = col_sum(e0 * pj0 + e1 * pj1);
                             const float den = col_sum(e0 + e1);
                             if (gid == side) res[nt][j] = num / den;
                           }
                         }
                       }
                       if (gid < 4) {  // lanes 0..3 of a pixel write its four sides side by side
#pragma unroll
                         for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
                           for (int j = 0; j < 2; ++j) {
                             size_t at;
                             if (out_index(n0 + nt * 8 + tig * 2 + j, &at)) a.dist[at * 4 + gid] = res[nt][j];
                           }
                         }
                       }
                     });
    // cls 1x1 + sigmoid: nc rows of zero-padded m-tiles
    gemm_cm<1, 1, 4>(cc, tw, ldc, c3, static_cast<const __nv_bfloat16*>(a.w2c), nc, 0, 0, th, tw,
                     [&](int m0, int n0, const float(&acc)[1][4][4]) {
                       frag_each<1, 4>(acc, m0, n0, [&](int k, int p, float v) {
                         size_t at;
                         if (k < nc && out_index(p, &at)) a.cls[at * nc + k] = logistic(bias_add<BF16>(v, __ldg(a.b2c + k)));
                       });
                     });
  } else {
    conv_smem<3, 8, S>(xs, FWX, ldx, C, static_cast<const float*>(a.w0), c23, c23, 1, 1, FH1, FW1,
                       [&](int fy, int fx, int oc0, float(&acc)[8]) {
#pragma unroll
                         for (int o = 0; o < 8; ++o) put1(fy - 1, fx - 1, oc0 + o, acc[o]);
                       });
    __syncthreads();
    conv_smem<3, 8, S>(t1, FW1, ld1, c2, static_cast<const float*>(a.w1r), c2, c2, 1, 1, th, tw,
                       [&](int fy, int fx, int oc0, float(&acc)[8]) {
#pragma unroll
                         for (int o = 0; o < 8; ++o) put2r(fy - 1, fx - 1, oc0 + o, acc[o]);
                       });
    conv_smem<3, 8, S>(t1 + c2, FW1, ld1, c3, static_cast<const float*>(a.w1c), c3, c3, 1, 1, th, tw,
                       [&](int fy, int fx, int oc0, float(&acc)[8]) {
#pragma unroll
                         for (int o = 0; o < 8; ++o) put2c(fy - 1, fx - 1, oc0 + o, acc[o]);
                       });
    __syncthreads();
    // reg 1x1 + DFL: one item is one pixel and one side (reg_max bins)
    conv_smem<1, kRegMax, S>(r2, tw, ldr, c2, static_cast<const float*>(a.w2r), 4 * kRegMax, 4 * kRegMax, 0, 0, th, tw,
                             [&](int py, int px, int oc0, float(&acc)[kRegMax]) {
                               size_t at;
                               if (!out_index(py * tw + px, &at)) return;
                               float m = __int_as_float(0xff800000);  // -inf
#pragma unroll
                               for (int j = 0; j < kRegMax; ++j) {
                                 acc[j] = bias_add<BF16>(acc[j], __ldg(a.b2r + oc0 + j));
                                 m = fmaxf(m, acc[j]);
                               }
                               float num = 0.f, den = 0.f;
#pragma unroll
                               for (int j = 0; j < kRegMax; ++j) {
                                 const float e = rnd<BF16>(expf(rnd<BF16>(acc[j] - m)));
                                 num += e * __ldg(a.proj + j);
                                 den += e;
                               }
                               a.dist[at * 4 + oc0 / kRegMax] = num / den;
                             });
    // cls 1x1 + sigmoid: nc single-channel items per pixel
    conv_smem<1, 1, S>(cc, tw, ldc, c3, static_cast<const float*>(a.w2c), nc, nc, 0, 0, th, tw,
                       [&](int py, int px, int k, float(&acc)[1]) {
                         size_t at;
                         if (out_index(py * tw + px, &at)) a.cls[at * nc + k] = logistic(bias_add<BF16>(acc[0], __ldg(a.b2c + k)));
                       });
  }
}

// the tile with the least first-conv work (halo and ragged edge included)
// whose shared maps fit in 113 KB (two blocks per SM), else in 227 KB
void pick_tile(int H, int W, int C, int c2, int c3, bool bf16, int* th, int* tw, size_t* bytes) {
  *th = *tw = 0;
  *bytes = 0;
  for (size_t budget : {size_t(113) << 10, size_t(227) << 10}) {
    long long best = -1;
    for (int h = H < kMaxTileH ? H : kMaxTileH; h >= 1; --h) {
      for (int w = W < kMaxTileW ? W : kMaxTileW; w >= 1; --w) {
        const size_t s = cm_smem(h, w, C, c2, c3, bf16).total;
        if (s > budget) continue;
        const long long cost = (long long)((H + h - 1) / h) * ((W + w - 1) / w) * (h + 2) * (w + 2);
        if (best < 0 || cost < best) {
          best = cost;
          *th = h;
          *tw = w;
          *bytes = s;
        }
      }
    }
    if (best >= 0) return;
  }
}

template <typename T, bool BF16>
int launch(const CmArgs& a, size_t bytes, cudaStream_t stream) {
  auto kern = head_cm_kernel<T, BF16>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (e != cudaSuccess) return int(e);
  const int tiles = ((a.H + a.th - 1) / a.th) * ((a.W + a.tw - 1) / a.tw);
  kern<<<dim3(tiles, a.B), kThreads, bytes, stream>>>(a);
  YT_RETURN_LAUNCH_ERROR();
}

}  // namespace

extern "C" {

int yt_head_cm_plan(int H, int W, int C, int c2, int c3, int bf16, int* th, int* tw, long long* bytes) {
  size_t s = 0;
  pick_tile(H, W, C, c2, c3, bf16 != 0, th, tw, &s);
  *bytes = static_cast<long long>(s);
  return *th > 0 ? 0 : int(cudaErrorInvalidConfiguration);
}

int yt_head_level_cm(const void* x, float* dist, float* cls, const void* w0, const void* w1r, const void* w1c,
                     const void* w2r, const void* w2c, const float* b0, const float* b1r, const float* b1c,
                     const float* b2r, const float* b2c, const float* proj, int B, int H, int W, int C, int c2, int c3,
                     int nc, int reg_max, int bf16, void* stream) {
  // the cls slice of the merged map starts at channel c2: its 16-padded reads
  // stay inside the pixel only when c2 is a multiple of 16
  if (reg_max != kRegMax || c2 % 8 || c3 % 8 || nc < 1 || (bf16 && c2 % 16)) return int(cudaErrorInvalidValue);
  if (B < 1 || B > 65535 || H < 1 || W < 1) return int(cudaErrorInvalidValue);
  CmArgs a{x, dist, cls, w0, w1r, w1c, w2r, w2c, b0, b1r, b1c, b2r, b2c, proj, B, H, W, C, c2, c3, nc, 0, 0};
  size_t bytes = 0;
  pick_tile(H, W, C, c2, c3, bf16 != 0, &a.th, &a.tw, &bytes);
  if (!a.th) return int(cudaErrorInvalidConfiguration);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16, true>(a, bytes, s) : launch<float, false>(a, bytes, s);
}

}  // extern "C"
