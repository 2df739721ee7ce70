// One Detect level in one kernel: the merged reg|cls first 3x3 ConvBNAct,
// each branch's second 3x3 ConvBNAct, the 1x1 convs (4*reg_max bins, nc
// logits) and the DFL softmax-projection of the bins.
//
// Replaces yolo_tpu/ops/pallas_head.py::_head_level_kernel (entry
// fused_head_level). The TPU kernel streams rows through 3-row ring buffers
// across grid steps; here each block owns an output tile of one frame: it
// stages the input tile plus a 2-pixel halo in shared memory, computes the
// merged first conv over the tile plus 1 pixel (zero outside the image: the
// second convs' padding), then both second convs, the 1x1s and the DFL over
// the tile. Only x is read and only dist (f32) and the cls logits are written.
// It covers every level, P5 (C=192) included: the tile shrinks until the
// shared maps fit. The cls 1x1 has nc outputs (1 on the main path) and is
// computed as nc single-channel items, not padded to a tile.
//
// What bounds it on the H100: operations (chip_smoke.py prints both bounds
// per level). In bf16 the three 3x3 convs run on the tensor cores (mma.sync,
// common.cuh) and the 1x1s and the DFL on the CUDA cores; in f32 everything
// runs on the CUDA cores, so that f32 inputs work too. The tile is the one with
// the least halo recompute whose shared maps fit in 113 KB (two blocks per
// SM), else 227 KB.
#include "common.cuh"

namespace {

using namespace yt;

constexpr int kRegMax = 16;

struct HeadArgs {
  const void* x;  // (B, H, W, C)
  float* dist;    // (B, H*W, 4)
  void* cls;      // (B, H*W, nc) logits, compute dtype
  // 3x3 conv weights: f32 HWIO [9][cin][cout], or bf16 [9][pad16(cout)][pad16(cin)]
  const void* w0;    // merged first conv, cin C, cout c2 + c3 (reg channels first)
  const float* b0;   // [c2 + c3]
  const void* w1r;   // reg second conv, c2 -> c2
  const float* b1r;
  const void* w1c;   // cls second conv, c3 -> c3
  const float* b1c;
  const float* w2r;  // [c2][4 * reg_max]
  const float* b2r;
  const float* w2c;  // [c3][nc]
  const float* b2c;
  const float* proj;  // [reg_max] DFL projection
  int B, H, W, C, c2, c3, nc;
  int th, tw;
};

__host__ __device__ inline size_t align16(size_t v) { return (v + 15) & ~size_t(15); }

struct HeadSmem {
  size_t xs, t1, r2, c2s, total;
};

// shared maps: input frame (tile + 2), merged first conv (same frame), the two
// second-conv outputs over the tile; all in the compute dtype
__host__ __device__ inline HeadSmem head_smem(int th, int tw, int C, int c2, int c3, bool bf16) {
  const size_t f = size_t(th + 4) * (tw + 4);
  const int esz = bf16 ? 2 : 4;
  HeadSmem s;
  s.xs = align16(f * map_ld(C, bf16) * esz);
  s.t1 = align16(f * map_ld(c2 + c3, bf16) * esz);
  s.r2 = align16(size_t(th) * tw * map_ld(c2, bf16) * esz);
  s.c2s = align16(size_t(th) * tw * map_ld(c3, bf16) * esz);
  s.total = s.xs + s.t1 + s.r2 + s.c2s;
  return s;
}

template <typename T, bool BF16>
__global__ void __launch_bounds__(256) head_kernel(HeadArgs a) {
  using S = T;
  extern __shared__ __align__(16) unsigned char smem[];
  const int th = a.th, tw = a.tw, H = a.H, W = a.W, C = a.C, c2 = a.c2, c3 = a.c3;
  const int FW = tw + 4, FH = th + 4;
  const int c23 = c2 + c3;
  const int ldx = map_ld(C, BF16), ld1 = map_ld(c23, BF16), ldr = map_ld(c2, BF16), ldc = map_ld(c3, BF16);
  const HeadSmem L = head_smem(th, tw, C, c2, c3, BF16);
  S* xs = reinterpret_cast<S*>(smem);
  S* t1 = reinterpret_cast<S*>(smem + L.xs);
  S* r2 = reinterpret_cast<S*>(smem + L.xs + L.t1);
  S* cc = reinterpret_cast<S*>(smem + L.xs + L.t1 + L.r2);

  const int tiles_x = (W + tw - 1) / tw;
  const int b = blockIdx.y;
  const int oy = (blockIdx.x / tiles_x) * th - 2;  // image row of frame row 0
  const int ox = (blockIdx.x % tiles_x) * tw - 2;
  auto inside = [&](int fy, int fx) {
    const int iy = oy + fy, ix = ox + fx;
    return iy >= 0 && iy < H && ix >= 0 && ix < W;
  };

  if constexpr (BF16) {  // padded channels read as zeros
    zero_smem(smem, L.total);
    __syncthreads();
  }
  // ---- input tile + halo (zero outside the image); channels fastest, so a
  // frame row is one contiguous run of global memory
  const T* x = static_cast<const T*>(a.x);
  for (int idx = threadIdx.x; idx < FH * FW * C; idx += blockDim.x) {
    const int p = idx / C, ci = idx - p * C;
    const int fy = p / FW, fx = p - (p / FW) * FW;
    xs[p * ldx + ci] = inside(fy, fx) ? x[((size_t(b) * H + oy + fy) * W + ox + fx) * C + ci] : from_f<S>(0.f);
  }
  __syncthreads();

  // ---- merged first conv (reg | cls) over tile + 1
  conv<3, 8, BF16>(xs, FW, ldx, C, a.w0, c23, c23, 1, 1, th + 2, tw + 2, [&](int fy, int fx, int oc, float v) {
    t1[(fy * FW + fx) * ld1 + oc] =
        from_f<S>(inside(fy, fx) ? silu<BF16>(bias_add<BF16>(v, __ldg(a.b0 + oc))) : 0.f);
  });
  __syncthreads();

  // ---- second convs over the tile
  conv<3, 8, BF16>(t1, FW, ld1, c2, a.w1r, c2, c2, 2, 2, th, tw, [&](int fy, int fx, int oc, float v) {
    r2[((fy - 2) * tw + (fx - 2)) * ldr + oc] = from_f<S>(silu<BF16>(bias_add<BF16>(v, __ldg(a.b1r + oc))));
  });
  conv<3, 8, BF16>(t1 + c2, FW, ld1, c3, a.w1c, c3, c3, 2, 2, th, tw, [&](int fy, int fx, int oc, float v) {
    cc[((fy - 2) * tw + (fx - 2)) * ldc + oc] = from_f<S>(silu<BF16>(bias_add<BF16>(v, __ldg(a.b1c + oc))));
  });
  __syncthreads();

  // ---- reg 1x1 + DFL: one item is one pixel and one side (reg_max bins)
  const size_t HW = size_t(H) * W;
  conv_smem<1, kRegMax, S>(r2, tw, ldr, c2, a.w2r, 4 * kRegMax, 4 * kRegMax, 0, 0, th, tw,
                           [&](int py, int px, int oc0, float(&acc)[kRegMax]) {
                             const int iy = oy + 2 + py, ix = ox + 2 + px;
                             if (iy >= H || ix >= W) return;
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
                             a.dist[(size_t(b) * HW + size_t(iy) * W + ix) * 4 + oc0 / kRegMax] = num / den;
                           });
  // ---- cls 1x1: nc single-channel items per pixel
  T* cls = static_cast<T*>(a.cls);
  conv_smem<1, 1, S>(cc, tw, ldc, c3, a.w2c, a.nc, a.nc, 0, 0, th, tw, [&](int py, int px, int k, float(&acc)[1]) {
    const int iy = oy + 2 + py, ix = ox + 2 + px;
    if (iy >= H || ix >= W) return;
    cls[(size_t(b) * HW + size_t(iy) * W + ix) * a.nc + k] = from_f<T>(bias_add<BF16>(acc[0], __ldg(a.b2c + k)));
  });
}

void pick_tile(int H, int W, int C, int c2, int c3, bool bf16, int* th, int* tw, size_t* bytes) {
  static const int cand[][2] = {{16, 32}, {16, 16}, {8, 32}, {8, 16}, {8, 8}, {4, 16}, {4, 8}, {4, 4}, {2, 8}, {2, 4}};
  for (size_t budget : {size_t(113) << 10, size_t(227) << 10}) {
    double best = -1.0;
    for (const auto& t : cand) {
      const int h = t[0] < H ? t[0] : H, w = t[1] < W ? t[1] : W;
      const size_t s = head_smem(h, w, C, c2, c3, bf16).total;
      const double eff = double(h) * w / (double(h + 2) * (w + 2));
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

template <typename T, bool BF16>
int launch(const HeadArgs& a, size_t bytes, cudaStream_t stream) {
  auto kern = head_kernel<T, BF16>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (e != cudaSuccess) return int(e);
  const int tiles = ((a.H + a.th - 1) / a.th) * ((a.W + a.tw - 1) / a.tw);
  kern<<<dim3(tiles, a.B), 256, bytes, stream>>>(a);
  YT_RETURN_LAUNCH_ERROR();
}

}  // namespace

extern "C" {

int yt_head_plan(int H, int W, int C, int c2, int c3, int bf16, int* th, int* tw, long long* bytes) {
  size_t s = 0;
  pick_tile(H, W, C, c2, c3, bf16 != 0, th, tw, &s);
  *bytes = static_cast<long long>(s);
  return *th > 0 ? 0 : int(cudaErrorInvalidConfiguration);
}

int yt_head_level(const void* x, float* dist, void* cls, const void* w0, const float* b0, const void* w1r,
                  const float* b1r, const void* w1c, const float* b1c, const float* w2r, const float* b2r,
                  const float* w2c, const float* b2c, const float* proj, int B, int H, int W, int C, int c2, int c3,
                  int nc, int reg_max, int bf16, void* stream) {
  if (reg_max != kRegMax || c2 % 8 || c3 % 8 || nc < 1) return int(cudaErrorInvalidValue);
  HeadArgs a{x, dist, cls, w0, b0, w1r, b1r, w1c, b1c, w2r, b2r, w2c, b2c, proj, B, H, W, C, c2, c3, nc, 0, 0};
  size_t bytes = 0;
  pick_tile(H, W, C, c2, c3, bf16 != 0, &a.th, &a.tw, &bytes);
  if (!a.th) return int(cudaErrorInvalidConfiguration);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16, true>(a, bytes, s) : launch<float, false>(a, bytes, s);
}

}  // extern "C"
