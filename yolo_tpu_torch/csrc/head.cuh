// One Detect level in one kernel, the shared body of head.cu and head_cm.cu:
// the merged reg|cls first 3x3 ConvBNAct, each branch's second 3x3 ConvBNAct,
// the reg 1x1 (4 * reg_max bins) with the DFL softmax-projection, and the cls
// 1x1 (nc logits). x (B, H, W, C) NHWC in; dist (B, H*W, 4) f32 out, and the
// cls output of the entry: the logits in the compute dtype (head.cu, the
// counterpart of yolo_tpu/ops/pallas_head.py::fused_head_level) or their
// logistic in f32 (head_cm.cu, yolo_tpu/ops/pallas_head2.py::head_level_cm).
// The template flag CM selects the cls epilogue; nothing else differs.
//
// The TPU kernels stream image rows through 3-row rings carried across grid
// steps (and pallas_head2 relays x out channel-major first); Hopper blocks run
// in no order and share nothing, so a block owns output tiles of one frame
// and recomputes the first conv's one-pixel halo. Zero outside the image
// stands in for the convs' padding. The rounding points are those of the
// plain twins (ops/cuda_head.py, ops/cuda_head_cm.py): every sum in f32,
// rounded to the compute dtype before its bias is added in that dtype.
//
// What bounds it on the H100: operations (65,176 MACs per pixel at the main
// path's P2, 57% of them the reg second 3x3; chip_smoke.py prints both bounds
// per level). The design, bf16 (f32, the exact-track mode, runs the CUDA-core
// body at the end of this file; TF32 would round its inputs):
// - Every product is an implicit GEMM on the tensor cores, pixels as rows
//   (mma.sync m16n8k16, f32 accumulators), both operands from shared memory
//   by ldmatrix; the reg second conv on wgmma (below). The maps (the input over tile + 2, the merged first conv over
//   tile + 1, each clipped to the image plus a one-pixel zero border) keep
//   pad16(channels) + 8 halves per pixel, so eight consecutive pixel rows fall
//   on 32 distinct banks.
// - The weights of every conv are streamed from global memory (L2) through a
//   ring of two slots, one bulk copy of the copy engine per step awaited on an
//   mbarrier, in the core-matrix layout that ops/cuda_head.py::pack_core
//   writes: per 16-wide K chunk, 8x8 blocks of 128 contiguous bytes, which an
//   ldmatrix reads without a bank conflict and wgmma reads as its no-swizzle
//   B operand. The reg 1x1 stays resident for the block's life, the cls 1x1
//   one pass of 16 outputs at a time (one bulk copy per pass when nc > 16).
// - A warp item is 16 mt pixels x all the output channels of its conv, taken
//   in passes of 8 NT channels (48 for the first conv, 64 for the reg second
//   conv, 32 for the cls one); the weights of a pass stream once per round of
//   items. The second convs never reach shared memory: their accumulator
//   fragments, through bias and SiLU, are the A fragments of the 1x1 that
//   follows (an m16n8 pair of sums is an m16k16 operand). The reg 1x1's bins
//   stay in registers: a box side's 16 bins lie in the 4 lanes of a quad, so
//   the DFL max and its two sums are local plus two shuffle steps, side by
//   side. With c2 > 64 (yolov8x: 80) the reg conv takes more passes, and its
//   items one m-tile whose 1x1 sums build up pass by pass. The cls 1x1 adds
//   its partial products pass by pass in registers, 16 outputs at a time
//   (more classes run the cls conv again per 16).
// - The reg second conv (57% of P2's products) runs on wgmma m64n64k16: A
//   by ldmatrix into registers, B the ring slot read through a no-swizzle
//   descriptor, a warpgroup's item two m64 tiles. Timed untraced against the
//   same conv on mma.sync + ldmatrix, the kernel was 3.9% faster over the main
//   path's four levels at 128 frames and even at one frame (NVIDIA H100 80GB
//   HBM3, 700 W; chip_smoke.py, PERF.md).
// - Epilogues work on channel pairs in packed bf16 with the _rn intrinsics
//   (no contraction into an fma that rounds once), biases are loaded once per
//   item, pixel indices turn into rows and columns by a multiplication.
// - Blocks are persistent (one to an SM: 8 warps of up to 255 registers); a
//   block walks tiles, and the next tile's input is copied by 16-byte
//   cp.async while the second convs of this one run.
//   The plan (plan_for) costs each candidate tile by its rounds of items and
//   ring steps and by its waves over the SMs for this batch.
#pragma once

#include "common.cuh"

#include <map>
#include <mutex>
#include <tuple>

#ifdef YT_HEAD_TRACE
namespace yt {  // the measurement build's switch, defined in head.cu
extern long long* g_head_trace;  // where the next launches write one block's cycle counts, or null
}  // namespace yt
#endif

namespace {

using namespace yt;
using bf16_t = __nv_bfloat16;

constexpr int kRegMax = 16;
constexpr int kBins = 4 * kRegMax;  // the reg 1x1's outputs, and the reg second conv's pass width
constexpr int kF32Threads = 256;
constexpr size_t kMaxSmem = 232448;  // 227 KB: the most one block may ask for
constexpr int kRing = 2;
// The bf16 block's shape: 8 warps, items of 2 m-tiles, the K chunk loop unrolled by 2. Timed
// against other shapes on the H100 (PERF.md): first-conv items of 4 m-tiles were 27% slower
// over the main path's levels, 16 warps of at most 128 registers 22%, no unrolling 3%.
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
// bf16 warp items: 16 MT pixels (the reg conv on wgmma: MT m64 tiles of a warpgroup) x passes of 8 NT channels
constexpr int kMt0 = 2, kNt0 = 6;  // merged first conv
constexpr int kMt1 = 2, kNt1 = 8;  // reg second conv, c2 <= 64: one pass, its 1x1 and DFL in the pass's epilogue
constexpr int kMt2 = 2, kNt2 = 4;  // cls second conv
constexpr int kUnroll = 2;         // K chunks of an mma.sync loop unrolled together
constexpr int kNcSlice = 16;       // cls 1x1 outputs per run of the cls conv: the part of its weights kept resident
// the refusals of the C entries, apart from CUDA's error codes (which are positive)
constexpr int kNotTaken = -1, kNoTileFits = -2;

__host__ __device__ inline int pad_to(int c, int m) { return cdiv(c, m) * m; }

struct HeadArgs {
  const void* x;  // (B, H, W, C)
  float* dist;    // (B, H*W, 4)
  void* cls;      // (B, H*W, nc): logits in the compute dtype, or (CM) f32 scores
  const float *w0, *w1r, *w1c, *w2r, *w2c;  // f32: HWIO [taps][cin][cout]
  const bf16_t* wp;                          // bf16: ops/cuda_head.py::pack_core
  const float *b0, *b1r, *b1c, *b2r, *b2c;
  const float* proj;  // [reg_max] DFL projection
  int B, H, W, C, c2, c3, nc;
  int th, tw;  // output tile
  int slot;    // bf16: halves of one ring slot
#ifdef YT_HEAD_TRACE
  long long* trace;  // null, or kTraceStages x kTraceSlots cycle counts of block `trace_block`, then its tiles
  int trace_block;
#endif
};

// ---------------------------------------------------------------- bf16 ----

// The bf16 pack, in halves: each conv as passes of its output channels, each pass as
// [tap][16-wide K chunk][n / 8][k / 8][n % 8][k % 8] (pack_core in ops/cuda_head.py).
// The merged first conv's outputs are padded so that the cls slice [c2, c2 + pad32(c3)) of its map
// lies inside it and its passes are whole. The reg second conv reads pad16(c2) channels (those past
// c2 are cls channels, times zero weights) and writes pad64(c2) in passes of 64, the K of the reg 1x1.
// The cls 1x1 is kept in passes of kNcSlice outputs, one of which is resident at a time.
struct Pack {
  int kx, n1, kr, nr, k3, ncp;  // pad16(C), the first conv's padded outputs, pad16(c2), pad64(c2), pad32(c3), pad16(nc)
  size_t w0, w1r, w1c, w2r, w2c, total;
  __host__ __device__ size_t resident() const { return nr * kBins + size_t(k3) * kNcSlice; }  // halves: the reg 1x1 and one cls 1x1 pass
};
__host__ __device__ inline Pack pack_of(int C, int c2, int c3, int nc) {
  Pack p;
  p.kx = pad16(C);
  p.kr = pad16(c2);
  p.nr = pad_to(c2, kBins);
  p.k3 = pad_to(c3, 8 * kNt2);
  p.n1 = pad_to(c2 + p.k3, 8 * kNt0);
  p.ncp = pad_to(nc, kNcSlice);
  p.w0 = 0;
  p.w1r = p.w0 + size_t(9) * p.kx * p.n1;
  p.w1c = p.w1r + size_t(9) * p.kr * p.nr;
  p.w2r = p.w1c + size_t(9) * p.k3 * p.k3;
  p.w2c = p.w2r + size_t(p.nr) * kBins;
  p.total = p.w2c + size_t(p.k3) * p.ncp;
  return p;
}

// shared memory of a bf16 block, byte offsets: input map | first-conv map | resident 1x1 weights | ring | barriers
struct Layout {
  size_t xs, t1, w2, ring, bars, total;
};
__host__ __device__ inline Layout layout_of(const Pack& pk, int H, int W, int th, int tw, int slot) {
  Layout l;
  l.xs = 0;
  l.t1 = l.xs + size_t(imin(th + 4, H + 2)) * imin(tw + 4, W + 2) * (pk.kx + 8) * 2;
  l.w2 = l.t1 + size_t(imin(th, H) + 2) * (imin(tw, W) + 2) * (pk.n1 + 8) * 2;
  l.ring = l.w2 + pk.resident() * 2;
  l.bars = l.ring + size_t(kRing) * slot * 2;
  l.total = l.bars + 3 * sizeof(uint64_t);
  return l;
}

// Built with -DYT_HEAD_TRACE (chip_smoke.py --profile does, into a library of its own), thread 0
// of one interior block adds the cycles between its ticks to a (stage, slot) counter, over all
// the tiles of that block: where one warp's time goes. Without the macro nothing of it is compiled.
constexpr int kTraceStages = 4, kTraceSlots = 7;
enum TraceStage { kStaging = 0, kFirst = 1, kReg = 2, kCls = 3 };
enum TraceSlot { kCopyWait = 0, kBarrierWait = 1, kCopyIssue = 2, kLoop = 3, kEpilogue = 4, kOther = 5, kSteps = 6 };
struct Trace {
#ifdef YT_HEAD_TRACE
  long long* out = nullptr;
  long long t = 0, acc[kTraceStages][kTraceSlots] = {};
  int stage = 0, tiles = 0;
  __device__ __forceinline__ void start(const HeadArgs& a) {
    if (a.trace && int(blockIdx.x) == a.trace_block && threadIdx.x == 0) out = a.trace, t = clock64();
  }
  __device__ __forceinline__ void at(TraceStage s) { stage = s; }
  __device__ __forceinline__ void tick(TraceSlot slot) {
    if (out) {
      const long long now = clock64();
      acc[stage][slot] += now - t;
      t = now;
    }
  }
  __device__ __forceinline__ void step() { acc[stage][kSteps] += 1; }
  __device__ __forceinline__ void tile() { tiles += 1; }
  __device__ __forceinline__ void finish() {
    if (out) {
      for (int s = 0; s < kTraceStages; ++s)
        for (int i = 0; i < kTraceSlots; ++i) out[s * kTraceSlots + i] = acc[s][i];
      out[kTraceStages * kTraceSlots] = tiles;
    }
  }
#else
  __device__ void start(const HeadArgs&) {}
  __device__ void at(TraceStage) {}
  __device__ void tick(TraceSlot) {}
  __device__ void step() {}
  __device__ void tile() {}
  __device__ void finish() {}
#endif
};

// A block's tile. Image coordinates; the input map's frame starts at (oy, ox), the first-conv
// map's at (y0 - 1, x0 - 1) with width w + 2; (ry, rx, rh, rw) is the part of the first-conv
// map inside the image, in its frame's coordinates.
struct Tile {
  int b, y0, x0, h, w;
  int oy, ox, FH, FW;
  int ry, rx, rh, rw;
};
__device__ __forceinline__ Tile tile_of(const HeadArgs& a, int t) {
  const int tiles_x = cdiv(a.W, a.tw), per_frame = tiles_x * cdiv(a.H, a.th);
  Tile T;
  T.b = t / per_frame;
  t -= T.b * per_frame;
  T.y0 = (t / tiles_x) * a.th;
  T.x0 = (t % tiles_x) * a.tw;
  T.h = imin(a.th, a.H - T.y0);
  T.w = imin(a.tw, a.W - T.x0);
  T.oy = imax(T.y0 - 2, -1);
  T.ox = imax(T.x0 - 2, -1);
  T.FH = imin(T.y0 + T.h + 2, a.H + 1) - T.oy;
  T.FW = imin(T.x0 + T.w + 2, a.W + 1) - T.ox;
  const int iy0 = imax(T.y0 - 1, 0), iy1 = imin(T.y0 + T.h + 1, a.H);
  const int ix0 = imax(T.x0 - 1, 0), ix1 = imin(T.x0 + T.w + 1, a.W);
  T.ry = iy0 - (T.y0 - 1);
  T.rx = ix0 - (T.x0 - 1);
  T.rh = iy1 - iy0;
  T.rw = ix1 - ix0;
  return T;
}

struct Ring {
  bf16_t* buf;    // kRing slots of `slot` halves
  uint64_t* bar;  // one mbarrier per slot: its phase completes when the step's weights have landed
  int slot;
};

// m-tiles of an item: `most`, halved while the items would leave half the holders of a round idle
__host__ __device__ inline int item_mt(int npx, int rows, int most, int holders) {
  int mt = most;
  while (mt > 1 && cdiv(npx, rows * mt) <= holders / 2) mt /= 2;
  return mt;
}

// ---- wgmma m64n64k16 (the reg second conv), A from registers
// (the mma.sync A fragment of each warp's 16 rows), B from shared memory through a no-swizzle
// descriptor of the core-matrix layout, f32 accumulators in the mma.sync order (d[4 j + e] =
// n-tile j, element e)

__device__ __forceinline__ uint64_t wg_desc(const void* smem, uint32_t lbo, uint32_t sbo) {
  return uint64_t((smem_u32(smem) & 0x3FFFF) >> 4) | (uint64_t(lbo >> 4) << 16) | (uint64_t(sbo >> 4) << 32);
}
__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keep the compiler from moving reads or writes of the accumulators across the asynchronous product
__device__ __forceinline__ void wg_pin(float (&d)[8][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) asm volatile("" : "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])::"memory");
}
__device__ __forceinline__ void wg_m64n64k16(float (&d)[8][4], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]),
        "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]),
        "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]),
        "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// One 3x3 conv of a block on the tensor cores, as an implicit GEMM: rows = `npx` pixels of the
// A map `amap` (frame width `fw`, `ld` halves per pixel; `pix(p)` is pixel p's offset), K = 9
// taps x kct 16-wide chunks, N = npass passes of 8 NT channels, each pass's weights `kct * 9`
// chunks of NT * 128 halves from `wg`. An item is 16 mt pixels (with WG, mt m64 tiles of a
// warpgroup, this warp's 16 rows of each) x all passes; the items are dealt to the warps (or
// warpgroups) in rounds, and all warps walk the ring steps of (round, pass) together: a step is
// copied into the ring one step ahead of its use, as one bulk copy that the last warp asks the
// copy engine for, awaited on the slot's mbarrier; one block barrier per step frees the other
// slot. `pass_epi(pass, base, mt, acc)` takes an item's sums of one pass (base[i]: the first
// pixel of this warp's m-tile i), `item_epi(base, mt)` follows its last pass; `pre()` runs once,
// after the first barrier (every warp is done with the block's previous stage). `g0` is the count of
// ring steps the block has taken (step number -> slot and phase parity); the new count is returned.
template <int MT, int NT, bool WG, class Pix, class PassEpi, class ItemEpi, class Pre>
__device__ __forceinline__ int gemm(Trace& tr, const Ring& rg, int g0, const bf16_t* __restrict__ wg, int kct, int npass,
                                     const bf16_t* amap, int fw, int ld, int npx, Pix pix, PassEpi pass_epi,
                                     ItemEpi item_epi, Pre pre) {
  static_assert(!WG || NT == 8, "wgmma serves the reg conv's 64-channel passes");
  constexpr int kHolders = WG ? kWarps / 4 : kWarps, kRows = WG ? 64 : 16;
  // with WG all MT m64 tiles are multiplied (mt < MT repeats the last one's rows)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nq = 9 * kct, chunk = NT * 128;
  const int per_step = imin(nq, rg.slot / chunk), steps = cdiv(nq, per_step);
  const int mt = item_mt(npx, kRows, MT, kHolders), items = cdiv(npx, kRows * mt);
  const int total = cdiv(items, kHolders) * npass * steps;
  const int holder = WG ? warp >> 2 : warp, sub = WG ? (warp & 3) * 16 : 0;
  auto load = [&](int g) {
    if (threadIdx.x == kThreads - 32 && g < total) {
      const int s0 = (g % steps) * per_step, pass = (g / steps) % npass, slot = (g0 + g) % kRing;
      bulk_copy_g2s(rg.buf + size_t(slot) * rg.slot, wg + (size_t(pass) * nq + s0) * chunk,
                    uint32_t(imin(per_step, nq - s0)) * chunk * 2, rg.bar + slot);
    }
  };
  tr.tick(kOther);
  __syncthreads();
  tr.tick(kBarrierWait);
  pre();
  load(0);
  tr.tick(kCopyIssue);
  // this lane's row of an ldmatrix of B: 8x8 blocks (n / 8, k / 8) of 64 halves, n-tile j at j * 128, two per x4
  const int lane_b = ((lane >> 4) * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * 8;
  float acc[MT][NT][4];
  int base[MT], po[MT];
  bool live = false;
  int st = 0, pass = 0, turn = 0;
  for (int g = 0; g < total; ++g) {
    if (st == 0) {
      const int item = turn * kHolders + holder;
      live = item < items;
#pragma unroll
      for (int i = 0; i < MT; ++i) {
#pragma unroll
        for (int j = 0; j < NT; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;
        base[i] = (item * mt + imin(i, mt - 1)) * kRows + sub;
        po[i] = pix(imin(base[i] + (lane & 15), npx - 1)) + (lane >> 4) * 8;
      }
      tr.tick(kOther);
    }
    const int slot = (g0 + g) % kRing;
    mbar_wait(rg.bar + slot, ((g0 + g) / kRing) & 1);  // step g has landed
    tr.tick(kCopyWait);
    __syncthreads();  // everyone's has; the slot of step g - 1 is free
    tr.tick(kBarrierWait);
    tr.step();
    load(g + 1);
    tr.tick(kCopyIssue);
    const int s0 = st * per_step, cnt = imin(per_step, nq - s0);
    const bf16_t* wb = rg.buf + size_t(slot) * rg.slot;
    if (WG || live) {
      if constexpr (WG) {  // every warpgroup multiplies, a dead item on clamped rows: no branch around wgmma
#pragma unroll
        for (int i = 0; i < MT; ++i) wg_pin(acc[i]);
        // A fragments in two sets: a chunk's loads go into the set whose product is done
        uint32_t af0[MT][4], af1[MT][4];
        auto chunk_wg = [&](int c, uint32_t(&af)[MT][4]) {
          const int q = s0 + c, tap = q / kct;
          const int off = ((tap / 3 - 1) * fw + (tap % 3 - 1)) * ld + (q - tap * kct) * 16;
#pragma unroll
          for (int i = 0; i < MT; ++i) ldmatrix_x4(af[i], amap + po[i] + off);
          const uint64_t desc = wg_desc(wb + c * chunk, 128, 256);
          wg_fence();  // the A registers just loaded are visible to the product
#pragma unroll
          for (int i = 0; i < MT; ++i) wg_m64n64k16(acc[i], af[i], desc);
          wg_commit();
          wg_wait<1>();  // the previous chunk's product is done: its A set is free
        };
        for (int c = 0; c < cnt; c += 2) {
          chunk_wg(c, af0);
          if (c + 1 < cnt) chunk_wg(c + 1, af1);
        }
        wg_wait<0>();  // all of this step: its ring slot may be refilled after the next barrier
#pragma unroll
        for (int i = 0; i < MT; ++i) wg_pin(acc[i]);
      } else {
#pragma unroll kUnroll
        for (int c = 0; c < cnt; ++c) {
          const int q = s0 + c, tap = q / kct;
          const int off = ((tap / 3 - 1) * fw + (tap % 3 - 1)) * ld + (q - tap * kct) * 16;
          uint32_t af[MT][4];
#pragma unroll
          for (int i = 0; i < MT; ++i) {
            if (i < mt) ldmatrix_x4(af[i], amap + po[i] + off);
          }
          const bf16_t* bp = wb + c * chunk + lane_b;
#pragma unroll
          for (int j = 0; j < NT; j += 2) {
            uint32_t bq[4];
            ldmatrix_x4(bq, bp + j * 128);
#pragma unroll
            for (int i = 0; i < MT; ++i) {
              if (i < mt) {
                mma_bf16_16816(acc[i][j], af[i], bq[0], bq[1]);
                mma_bf16_16816(acc[i][j + 1], af[i], bq[2], bq[3]);
              }
            }
          }
        }
      }
      tr.tick(kLoop);
      if (live && st == steps - 1) {
        pass_epi(pass, base, mt, acc);
        if (pass == npass - 1) item_epi(base, mt);
        tr.tick(kEpilogue);
      }
    }
    if (++st == steps) {
      st = 0;
      if (++pass == npass) pass = 0, ++turn;
    }
  }
  return g0 + total;
}

// The reg 1x1's sums of side s (bins 16 s .. 16 s + 15, its n-tiles 2 s and 2 s + 1: a quad's 4 lanes hold a
// row's) over the 64 channels of reg pass `pass`, given as A fragments 16 channels at a time; w2r is the resident
// pack of that 1x1 ([K chunk][n / 8][k / 8][n % 8][k % 8]).
__device__ __forceinline__ void reg_side_sums(const bf16_t* w2r, int lane_b, const uint32_t (&af)[kNt1 / 2][4], int pass,
                                              int s, float (&d)[2][4]) {
#pragma unroll
  for (int k = 0; k < kNt1 / 2; ++k) {
    uint32_t bq[4];
    ldmatrix_x4(bq, w2r + (pass * (kNt1 / 2) + k) * (kBins * 16) + lane_b + 2 * s * 128);
    mma_bf16_16816(d[0], af[k], bq[0], bq[1]);
    mma_bf16_16816(d[1], af[k], bq[2], bq[3]);
  }
}

// the DFL of side s from its sums (bias b2r and projection proj added here): the distance of this lane's row r
// into res[r][s]
__device__ __forceinline__ void dfl_side(const float* __restrict__ b2r, const float* __restrict__ proj, int tig,
                                         const float (&d)[2][4], int s, float (&res)[2][4]) {
  float pj[2][2];  // the projection of this lane's bins 8 h + 2 tig + e
  bf16x2_t bs[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int bin = 8 * h + 2 * tig;
    pj[h][0] = __ldg(proj + bin), pj[h][1] = __ldg(proj + bin + 1);
    bs[h] = __floats2bfloat162_rn(__ldg(b2r + 16 * s + bin), __ldg(b2r + 16 * s + bin + 1));
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float v[2][2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float2 f = __bfloat1622float2(bias2(d[h][2 * r], d[h][2 * r + 1], bs[h]));
      v[h][0] = f.x, v[h][1] = f.y;
    }
    float m = fmaxf(fmaxf(v[0][0], v[0][1]), fmaxf(v[1][0], v[1][1]));
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
    float num = 0.f, den = 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float ex = rnd<true>(__expf(rnd<true>(v[h][e] - m)));  // fast: rounded to bf16 next
        num += ex * pj[h][e];
        den += ex;
      }
    num += __shfl_xor_sync(0xffffffffu, num, 1);
    den += __shfl_xor_sync(0xffffffffu, den, 1);
    num += __shfl_xor_sync(0xffffffffu, num, 2);
    den += __shfl_xor_sync(0xffffffffu, den, 2);
    res[r][s] = num / den;
  }
}

// the bf16 block: CM selects the cls epilogue, ONE a reg second conv of one pass (c2 <= 64, the main path's
// levels): in one kernel with the form of more passes, the block spilled registers (ptxas)
template <bool CM, bool ONE>
__global__ void __launch_bounds__(kThreads, 1) head_mma_kernel(HeadArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int H = a.H, W = a.W, C = a.C, c2 = a.c2, c3 = a.c3, nc = a.nc;
  const Pack pk = pack_of(C, c2, c3, nc);
  const Layout L = layout_of(pk, H, W, a.th, a.tw, a.slot);
  const int ldx = pk.kx + 8, ld1 = pk.n1 + 8;
  bf16_t* xs = reinterpret_cast<bf16_t*>(smem + L.xs);
  bf16_t* t1 = reinterpret_cast<bf16_t*>(smem + L.t1);
  const bf16_t* w2r = reinterpret_cast<const bf16_t*>(smem + L.w2);
  bf16_t* w2c = reinterpret_cast<bf16_t*>(smem + L.w2) + size_t(pk.nr) * kBins;  // one pass of kNcSlice cls 1x1 outputs
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + L.bars);
  const Ring rg{reinterpret_cast<bf16_t*>(smem + L.ring), bar, a.slot};
  int ring_steps = 0;
  const bf16_t *w0 = a.wp + pk.w0, *w1r = a.wp + pk.w1r, *w1c = a.wp + pk.w1c;
  const int kx = pk.kx, n1 = pk.n1, k3 = pk.k3;
  const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  const int lane_b = ((lane >> 4) * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * 8;
  const int tiles = a.B * cdiv(H, a.th) * cdiv(W, a.tw);
  const size_t HW = size_t(H) * W;
  const bf16_t* x = static_cast<const bf16_t*>(a.x);

  Trace tr;
  tr.start(a);
  if (threadIdx.x == 0) {
    for (int s = 0; s < 3; ++s) mbar_init(bar + s, 1);
    mbar_init_fence();
  }
  zero_smem(smem + L.xs, L.t1 - L.xs);  // the input map's pad channels stay zero
  __syncthreads();
  // the resident 1x1 weights: the reg one and the first pass of the cls one (contiguous in the pack)
  if (threadIdx.x == 0) bulk_copy_g2s(smem + L.w2, a.wp + pk.w2r, uint32_t(pk.resident()) * 2, bar + 2);

  // the input over a tile + 2 by 16-byte asynchronous copies; the frame's pixels outside the image are zeros
  auto stage = [&](const Tile& T) {
    const int cv = C / 8, n = T.FH * T.FW * cv;
    const RowCol byq(cv), byx(T.FW);
    for (int i = threadIdx.x; i < n; i += kThreads) {
      int p, q, fy, fx;
      byq(i, p, q);
      byx(p, fy, fx);
      const int iy = T.oy + fy, ix = T.ox + fx;
      bf16_t* dst = xs + p * ldx + q * 8;
      if (iy >= 0 && iy < H && ix >= 0 && ix < W) {
        cp_async16(dst, x + ((size_t(T.b) * H + iy) * W + ix) * C + q * 8);
      } else {
        *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
      }
    }
    cp_async_commit();
  };
  if (int(blockIdx.x) < tiles) stage(tile_of(a, blockIdx.x));
  mbar_wait(bar + 2, 0);  // the resident 1x1 weights

  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const Tile T = tile_of(a, t);
    tr.tile();
    tr.at(kStaging);
    cp_async_wait(0);  // this tile's input; the first barrier of the next GEMM shows it to all
    tr.tick(kCopyWait);
    const size_t out0 = size_t(T.b) * HW;
    const RowCol rect(T.rw), tile(T.w);
    const int FW1 = T.w + 2;
    // image pixel index of the tile's pixel p
    auto out_px = [&](int p) {
      int ty, tx;
      tile(p, ty, tx);
      return out0 + size_t(T.y0 + ty) * W + T.x0 + tx;
    };
    // first-conv map offset of the tile's pixel p (the centre tap of the second convs)
    auto t1_px = [&](int p) {
      int ty, tx;
      tile(p, ty, tx);
      return ((ty + 1) * FW1 + tx + 1) * ld1;
    };

    // ---- merged first conv (reg | cls) over the tile + 1 inside the image
    tr.at(kFirst);
    ring_steps = gemm<kMt0, kNt0, false>(
        tr, rg, ring_steps, w0, kx / 16, n1 / (8 * kNt0), xs, T.FW, ldx, T.rh * T.rw,
        [&](int p) {
          int ry, rx;
          rect(p, ry, rx);
          return ((T.y0 - 1 + T.ry + ry - T.oy) * T.FW + T.x0 - 1 + T.rx + rx - T.ox) * ldx;
        },
        [&](int pass, const int(&base)[kMt0], int mt, const float(&acc)[kMt0][kNt0][4]) {
          const int nb = pass * 8 * kNt0;
          bf16x2_t bj[kNt0];
#pragma unroll
          for (int j = 0; j < kNt0; ++j) {
            const int oc = nb + j * 8 + 2 * tig;
            bj[j] = oc < c2 + c3 ? __floats2bfloat162_rn(__ldg(a.b0 + oc), __ldg(a.b0 + oc + 1)) : __floats2bfloat162_rn(0.f, 0.f);
          }
          const int npx = T.rh * T.rw;
#pragma unroll
          for (int i = 0; i < kMt0; ++i) {
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int p = base[i] + gid + 8 * r;
              if (i < mt && p < npx) {
                int ry, rx;
                rect(p, ry, rx);
                bf16_t* d = t1 + ((T.ry + ry) * FW1 + T.rx + rx) * ld1 + nb + 2 * tig;
#pragma unroll
                for (int j = 0; j < kNt0; ++j) pair_at(d + j * 8) = act2(acc[i][j][2 * r], acc[i][j][2 * r + 1], bj[j]);
              }
            }
          }
        },
        [](const int(&)[kMt0], int) {},
        [&] {  // the first-conv map's frame outside the image reads as the second convs' zero padding
          const int FH1 = T.h + 2, nb = 2 * FW1 + 2 * T.h, cv = ld1 / 8 - 1;
          for (int i = threadIdx.x; i < nb * cv; i += kThreads) {
            const int e = i / cv, q = i - e * cv;
            const int fy = e < FW1 ? 0 : e < 2 * FW1 ? FH1 - 1 : 1 + (e - 2 * FW1) / 2;
            const int fx = e < 2 * FW1 ? e % FW1 : ((e - 2 * FW1) & 1) * (FW1 - 1);
            const int iy = T.y0 - 1 + fy, ix = T.x0 - 1 + fx;
            if (iy < 0 || iy >= H || ix < 0 || ix >= W) *reinterpret_cast<uint4*>(t1 + (fy * FW1 + fx) * ld1 + q * 8) = make_uint4(0, 0, 0, 0);
          }
        });

    // ---- reg second conv in passes of 64 outputs, its 1x1 and the DFL, in registers. With one pass (c2 <= 64) an
    // item is kMt1 m-tiles and the pass's epilogue does it all; with more, an item is one m-tile whose 1x1 sums
    // build up pass by pass, and the DFL follows the last pass.
    tr.at(kReg);
    const int n2 = T.h * T.w;
    {
      constexpr int MT = ONE ? kMt1 : 1;
      float dr[4][2][4] = {};  // more than one pass: the 1x1's sums of the item so far, by side
      // the four distances of the item's m-tile at p0: lane tig == r of each quad writes row r's
      auto store_dist = [&](int p0, const float(&res)[2][4]) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int p = p0 + gid + 8 * r;
          if (tig == r && p < n2) *reinterpret_cast<float4*>(a.dist + out_px(p) * 4) = make_float4(res[r][0], res[r][1], res[r][2], res[r][3]);
        }
      };
      ring_steps = gemm<MT, kNt1, true>(
          tr, rg, ring_steps, w1r, pk.kr / 16, ONE ? 1 : pk.nr / kBins, t1, FW1, ld1, n2, t1_px,
          [&](int pass, const int(&base)[MT], int mt, const float(&acc)[MT][kNt1][4]) {
            bf16x2_t bj[kNt1];
#pragma unroll
            for (int j = 0; j < kNt1; ++j) {
              const int oc = pass * kBins + j * 8 + 2 * tig;
              bj[j] = oc < c2 ? __floats2bfloat162_rn(__ldg(a.b1r + oc), __ldg(a.b1r + oc + 1)) : __floats2bfloat162_rn(0.f, 0.f);
            }
#pragma unroll
            for (int i = 0; i < MT; ++i) {
              if (i >= mt) continue;
              uint32_t af[kNt1 / 2][4];  // the pass's 64 channels as the 1x1's A operand, 16 at a time
#pragma unroll
              for (int k = 0; k < kNt1 / 2; ++k) {
                af[k][0] = as_u32(act2(acc[i][2 * k][0], acc[i][2 * k][1], bj[2 * k]));
                af[k][1] = as_u32(act2(acc[i][2 * k][2], acc[i][2 * k][3], bj[2 * k]));
                af[k][2] = as_u32(act2(acc[i][2 * k + 1][0], acc[i][2 * k + 1][1], bj[2 * k + 1]));
                af[k][3] = as_u32(act2(acc[i][2 * k + 1][2], acc[i][2 * k + 1][3], bj[2 * k + 1]));
              }
              if constexpr (ONE) {
                float res[2][4];
#pragma unroll
                for (int s = 0; s < 4; ++s) {
                  float d[2][4] = {};
                  reg_side_sums(w2r, lane_b, af, 0, s, d);
                  dfl_side(a.b2r, a.proj, tig, d, s, res);
                }
                store_dist(base[i], res);
              } else {
#pragma unroll
                for (int s = 0; s < 4; ++s) reg_side_sums(w2r, lane_b, af, pass, s, dr[s]);
              }
            }
          },
          [&](const int(&base)[MT], int) {
            if constexpr (!ONE) {
              float res[2][4];
#pragma unroll
              for (int s = 0; s < 4; ++s) {
                dfl_side(a.b2r, a.proj, tig, dr[s], s, res);
#pragma unroll
                for (int h = 0; h < 2; ++h) dr[s][h][0] = dr[s][h][1] = dr[s][h][2] = dr[s][h][3] = 0.f;
              }
              store_dist(base[0], res);
            }
          },
          [&] {  // every warp is done with the input map: the next tile's input flies while this one's second convs run
            tr.at(kStaging);
            if (t + int(gridDim.x) < tiles) stage(tile_of(a, t + gridDim.x));
            tr.tick(kCopyIssue);
            tr.at(kReg);
          });
    }

    // ---- cls second conv and its 1x1, pass by pass: the 1x1's sums build up in registers, kNcSlice outputs at a
    // time (more classes run the conv again per kNcSlice, each with that pass of the 1x1 resident)
    tr.at(kCls);
    const int runs = cdiv(nc, kNcSlice);
    for (int k0 = 0; k0 < nc; k0 += kNcSlice) {
      // bar 2's phase that holds this run's pass of the cls 1x1: phase 0 (the block's first load) holds pass 0;
      // with more than one run, each run after the block's first loads its pass as the next phase
      const int phase = runs > 1 ? ((t - int(blockIdx.x)) / int(gridDim.x)) * runs + k0 / kNcSlice : 0;
      float z[kMt2][2][4] = {};
      ring_steps = gemm<kMt2, kNt2, false>(
          tr, rg, ring_steps, w1c, k3 / 16, k3 / (8 * kNt2), t1 + c2, FW1, ld1, n2, t1_px,
          [&](int pass, const int(&)[kMt2], int mt, const float(&acc)[kMt2][kNt2][4]) {
            const int nb = pass * 8 * kNt2;
            bf16x2_t bj[kNt2];
#pragma unroll
            for (int j = 0; j < kNt2; ++j) {
              const int oc = nb + j * 8 + 2 * tig;
              bj[j] = oc < c3 ? __floats2bfloat162_rn(__ldg(a.b1c + oc), __ldg(a.b1c + oc + 1)) : __floats2bfloat162_rn(0.f, 0.f);
            }
            mbar_wait(bar + 2, phase & 1);  // this pass of the cls 1x1 has landed
#pragma unroll
            for (int i = 0; i < kMt2; ++i) {
              if (i >= mt) continue;
#pragma unroll
              for (int k = 0; k < kNt2 / 2; ++k) {
                uint32_t af[4];
                af[0] = as_u32(act2(acc[i][2 * k][0], acc[i][2 * k][1], bj[2 * k]));
                af[1] = as_u32(act2(acc[i][2 * k][2], acc[i][2 * k][3], bj[2 * k]));
                af[2] = as_u32(act2(acc[i][2 * k + 1][0], acc[i][2 * k + 1][1], bj[2 * k + 1]));
                af[3] = as_u32(act2(acc[i][2 * k + 1][2], acc[i][2 * k + 1][3], bj[2 * k + 1]));
                uint32_t bq[4];
                ldmatrix_x4(bq, w2c + (nb / 16 + k) * (kNcSlice * 16) + lane_b);
                mma_bf16_16816(z[i][0], af, bq[0], bq[1]);
                mma_bf16_16816(z[i][1], af, bq[2], bq[3]);
              }
            }
          },
          [&](const int(&base)[kMt2], int mt) {
#pragma unroll
            for (int j = 0; j < 2; ++j) {
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int k = k0 + j * 8 + 2 * tig + e;
                const float bk = k < nc ? __ldg(a.b2c + k) : 0.f;
#pragma unroll
                for (int i = 0; i < kMt2; ++i) {
#pragma unroll
                  for (int r = 0; r < 2; ++r) {
                    const int p = base[i] + gid + 8 * r;
                    if (i < mt && k < nc && p < n2) {
                      const float v = rnd<true>(rnd<true>(z[i][j][2 * r + e]) + bk);
                      const size_t at = out_px(p) * nc + k;
                      if constexpr (CM) {
                        static_cast<float*>(a.cls)[at] = 1.0f / (1.0f + expf(-v));
                      } else {
                        static_cast<bf16_t*>(a.cls)[at] = __float2bfloat16_rn(v);
                      }
                    }
                    z[i][j][2 * r + e] = 0.f;
                  }
                }
              }
            }
          },
          [&] {  // every warp is done with the resident pass of the cls 1x1: fetch this run's unless it is there
            if (phase > 0 && threadIdx.x == 0) bulk_copy_g2s(w2c, a.wp + pk.w2c + size_t(k0) * k3, uint32_t(k3) * kNcSlice * 2, bar + 2);
          });
    }
  }
  tr.finish();
}

// ----------------------------------------------------------------- f32 ----

// The exact-track mode on the CUDA cores (common.cuh's conv_smem; TF32 would round the inputs):
// one block per tile, every map in shared memory in f32 with an odd pixel stride. x (B, H, W, C)
// NHWC read straight into the input map; the cls output is f32 logits, or (CM) their logistic.
struct F32Smem {
  size_t xs, t1, r2, cc, total;
};
__host__ __device__ inline size_t align16(size_t v) { return (v + 15) & ~size_t(15); }
__host__ __device__ inline F32Smem f32_smem(int th, int tw, int C, int c2, int c3) {
  F32Smem s;
  s.xs = align16(size_t(th + 4) * (tw + 4) * map_ld(C, false) * 4);
  s.t1 = align16(size_t(th + 2) * (tw + 2) * map_ld(c2 + c3, false) * 4);
  s.r2 = align16(size_t(th) * tw * map_ld(c2, false) * 4);
  s.cc = align16(size_t(th) * tw * map_ld(c3, false) * 4);
  s.total = s.xs + s.t1 + s.r2 + s.cc;
  return s;
}

template <bool CM>
__global__ void __launch_bounds__(kF32Threads) head_f32_kernel(HeadArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int th = a.th, tw = a.tw, H = a.H, W = a.W, C = a.C, c2 = a.c2, c3 = a.c3, nc = a.nc;
  const int FWX = tw + 4, FHX = th + 4;  // input frame: image origin (oy - 2, ox - 2)
  const int FW1 = tw + 2, FH1 = th + 2;  // first-conv frame: image origin (oy - 1, ox - 1)
  const int c23 = c2 + c3;
  const int ldx = map_ld(C, false), ld1 = map_ld(c23, false), ldr = map_ld(c2, false), ldc = map_ld(c3, false);
  const F32Smem L = f32_smem(th, tw, C, c2, c3);
  float* xs = reinterpret_cast<float*>(smem);
  float* t1 = reinterpret_cast<float*>(smem + L.xs);
  float* r2 = reinterpret_cast<float*>(smem + L.xs + L.t1);
  float* cc = reinterpret_cast<float*>(smem + L.xs + L.t1 + L.r2);

  const int tiles_x = cdiv(W, tw);
  const int b = blockIdx.y;
  const int oy = (blockIdx.x / tiles_x) * th;  // image row of the tile's first row
  const int ox = (blockIdx.x % tiles_x) * tw;
  const size_t HW = size_t(H) * W;
  const float* x = static_cast<const float*>(a.x) + size_t(b) * HW * C;

  // ---- input tile + 2 (zero outside the image)
  for (int idx = threadIdx.x; idx < FHX * FWX * C; idx += blockDim.x) {
    const int p = idx / C, ci = idx - p * C;
    const int fy = p / FWX, fx = p - fy * FWX;
    const int iy = oy - 2 + fy, ix = ox - 2 + fx;
    xs[size_t(p) * ldx + ci] = (iy >= 0 && iy < H && ix >= 0 && ix < W) ? x[(size_t(iy) * W + ix) * C + ci] : 0.f;
  }
  __syncthreads();

  // a pixel of the tile that lies inside the image
  auto out_index = [&](int py, int px, size_t* at) {
    const int iy = oy + py, ix = ox + px;
    *at = size_t(b) * HW + size_t(iy) * W + ix;
    return iy < H && ix < W;
  };
  // ---- merged first conv (reg | cls) over tile + 1, zero outside the map
  conv_smem<3, 8, float>(xs, FWX, ldx, C, a.w0, c23, c23, 1, 1, FH1, FW1, [&](int fy, int fx, int oc0, float(&acc)[8]) {
    const int iy = oy - 2 + fy, ix = ox - 2 + fx;
    const bool in_map = iy >= 0 && iy < H && ix >= 0 && ix < W;
    float* d = t1 + ((fy - 1) * FW1 + fx - 1) * ld1 + oc0;
#pragma unroll
    for (int o = 0; o < 8; ++o) d[o] = in_map ? silu<false>(bias_add<false>(acc[o], __ldg(a.b0 + oc0 + o))) : 0.f;
  });
  __syncthreads();
  // ---- the second convs over the tile
  conv_smem<3, 8, float>(t1, FW1, ld1, c2, a.w1r, c2, c2, 1, 1, th, tw, [&](int fy, int fx, int oc0, float(&acc)[8]) {
    float* d = r2 + ((fy - 1) * tw + fx - 1) * ldr + oc0;
#pragma unroll
    for (int o = 0; o < 8; ++o) d[o] = silu<false>(bias_add<false>(acc[o], __ldg(a.b1r + oc0 + o)));
  });
  conv_smem<3, 8, float>(t1 + c2, FW1, ld1, c3, a.w1c, c3, c3, 1, 1, th, tw, [&](int fy, int fx, int oc0, float(&acc)[8]) {
    float* d = cc + ((fy - 1) * tw + fx - 1) * ldc + oc0;
#pragma unroll
    for (int o = 0; o < 8; ++o) d[o] = silu<false>(bias_add<false>(acc[o], __ldg(a.b1c + oc0 + o)));
  });
  __syncthreads();
  // ---- reg 1x1 + DFL: one item is one pixel and one side (reg_max bins)
  conv_smem<1, kRegMax, float>(r2, tw, ldr, c2, a.w2r, 4 * kRegMax, 4 * kRegMax, 0, 0, th, tw,
                               [&](int py, int px, int oc0, float(&acc)[kRegMax]) {
                                 size_t at;
                                 if (!out_index(py, px, &at)) return;
                                 float m = __int_as_float(0xff800000);  // -inf
#pragma unroll
                                 for (int j = 0; j < kRegMax; ++j) {
                                   acc[j] = bias_add<false>(acc[j], __ldg(a.b2r + oc0 + j));
                                   m = fmaxf(m, acc[j]);
                                 }
                                 float num = 0.f, den = 0.f;
#pragma unroll
                                 for (int j = 0; j < kRegMax; ++j) {
                                   const float e = expf(acc[j] - m);
                                   num += e * __ldg(a.proj + j);
                                   den += e;
                                 }
                                 a.dist[at * 4 + oc0 / kRegMax] = num / den;
                               });
  // ---- cls 1x1: nc single-channel items per pixel
  conv_smem<1, 1, float>(cc, tw, ldc, c3, a.w2c, nc, nc, 0, 0, th, tw, [&](int py, int px, int k, float(&acc)[1]) {
    size_t at;
    if (!out_index(py, px, &at)) return;
    const float v = bias_add<false>(acc[0], __ldg(a.b2c + k));
    static_cast<float*>(a.cls)[at * nc + k] = CM ? 1.0f / (1.0f + expf(-v)) : v;
  });
}

// ---------------------------------------------------------------- host ----

using Kernel = void (*)(HeadArgs);

struct Plan {
  int th = 0, tw = 0, slot = 0, blocks = 0, tiles = 0, per_sm = 1;
  size_t smem = 0;
};

struct Level {
  int B, H, W, C, c2, c3, nc;
  bool bf16;
};

// the C entries take: bf16 needs 16-byte input pixels (and some tile must fit, which the plan finds out)
bool takes(const Level& s) {
  if (s.B < 1 || s.B > 65535 || s.H < 1 || s.W < 1 || s.C < 1 || s.nc < 1 || s.c2 % 8 || s.c3 % 8) return false;
  return !s.bf16 || s.C % 8 == 0;
}

// the card's SM count, asked once
cudaError_t sm_count(int* sms) {
  static int n = 0;
  if (!n) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
  }
  *sms = n;
  return cudaSuccess;
}

// The plan's cost model (bf16), in units of one warp's m16n8k16 product: `barrier` is what a ring
// step costs beside its products (its block barrier, copy wait and issue). chip_smoke.py --profile
// (`[head plans]`) holds the model's choice against a timed sweep of the candidates.
struct Model {
  double barrier = 12.0;
};

// ring slot of a candidate: the largest of 32, 16 and 8 KB that leaves the block within its shared
// memory, or 0; a slot holds at least one K chunk of any pass (16 x 64 halves)
int slot_for(const Pack& pk, int H, int W, int th, int tw) {
  for (int kb : {32, 16, 8}) {
    const int slot = kb * 512;
    if (layout_of(pk, H, W, th, tw, slot).total <= kMaxSmem) return slot;
  }
  return 0;
}

// One candidate tile of a level: its launch shape and modelled time, or false if its block does
// not fit. A GEMM costs its rounds of items (per pass: products per K chunk and ldmatrix loads,
// plus a barrier per ring step); a block costs the GEMMs of an interior tile; the launch costs
// the waves of persistent blocks over the SMs.
bool candidate(const Level& s, int sms, const Model& m, Plan* p, double* cost) {
  const int H = s.H, W = s.W, th = p->th, tw = p->tw;
  if (th < 1 || tw < 1 || th > H || tw > W) return false;
  p->tiles = s.B * cdiv(H, th) * cdiv(W, tw);
  if (!s.bf16) {
    p->smem = f32_smem(th, tw, s.C, s.c2, s.c3).total;
    if (p->smem > kMaxSmem) return false;
    p->slot = 0;
    p->blocks = p->tiles;
    p->per_sm = p->smem <= (size_t(113) << 10) ? 2 : 1;
    // halo recompute of the first conv, per output pixel
    *cost = double(th + 2) * (tw + 2) / (double(th) * tw);
    return true;
  }
  const Pack pk = pack_of(s.C, s.c2, s.c3, s.nc);
  p->slot = slot_for(pk, H, W, th, tw);
  if (!p->slot) return false;
  p->smem = layout_of(pk, H, W, th, tw, p->slot).total;
  auto gemm_cost = [&](int npx, int kct, int npass, int MT, int NT, int holders, int rows) {
    const int mt = item_mt(npx, rows, MT, holders);
    const int nq = 9 * kct, steps = cdiv(nq, imin(nq, p->slot / (NT * 128)));
    return double(cdiv(cdiv(npx, rows * mt), holders)) * npass *
           (nq * (mt * NT + mt + NT / 2) + steps * m.barrier);
  };
  const int px1 = imin(th + 2, H) * imin(tw + 2, W), px2 = th * tw;
  double t = gemm_cost(px1, pk.kx / 16, pk.n1 / (8 * kNt0), kMt0, kNt0, kWarps, 16);
  const int npr = pk.nr / kBins;  // passes of the reg second conv
  t += gemm_cost(px2, pk.kr / 16, npr, npr == 1 ? kMt1 : 1, kNt1, kWarps, 16) + cdiv(px2, 16 * kWarps) * 4.0 * (kNt1 + kNt1) * npr;
  t += gemm_cost(px2, pk.k3 / 16, pk.k3 / (8 * kNt2), kMt2, kNt2, kWarps, 16) * cdiv(s.nc, kNcSlice);
  p->blocks = imin(p->tiles, sms);
  p->per_sm = 1;
  *cost = t * cdiv(p->tiles, p->blocks);
  return true;
}

// every candidate the plan weighs, in order (the first stays on a tie): f(plan, modelled time)
template <class F>
cudaError_t each_candidate(const Level& s, const Model& m, F f) {
  int sms = 0;
  cudaError_t e = sm_count(&sms);
  if (e != cudaSuccess) return e;
  if (!s.bf16) {  // the f32 tiles of the earlier kernels: the least halo within 113 KB (two blocks an SM), else 227 KB;
    // where none fits (C = 1024: 4 KB an input pixel), the narrow tiles, whose input frame (th + 4) x (tw + 4) fits
    static const int cand[][2] = {{16, 32}, {16, 16}, {8, 32}, {8, 16}, {8, 8}, {4, 16}, {4, 8}, {4, 4}, {2, 8}, {2, 4}};
    static const int narrow[][2] = {{1, 4}, {2, 2}, {1, 2}, {1, 1}};
    bool any = false;
    for (size_t budget : {size_t(113) << 10, kMaxSmem}) {
      for (const auto& c : cand) {
        Plan p;
        p.th = imin(c[0], s.H), p.tw = imin(c[1], s.W);
        double cost = 0.0;
        if (candidate(s, sms, m, &p, &cost) && p.smem <= budget) f(p, cost), any = true;
      }
      if (any) return cudaSuccess;
    }
    for (const auto& c : narrow) {
      Plan p;
      p.th = imin(c[0], s.H), p.tw = imin(c[1], s.W);
      double cost = 0.0;
      if (candidate(s, sms, m, &p, &cost)) f(p, cost);
    }
    return cudaSuccess;
  }
  const int ths[] = {s.H, 32, 16, 14, 8, 6, 4, 2, 1}, tws[] = {s.W, 64, 40, 32, 30, 20, 16, 14, 8, 4};
  for (int th : ths) {
    for (int tw : tws) {
      Plan p;
      p.th = th, p.tw = tw;
      double cost = 0.0;
      if (candidate(s, sms, m, &p, &cost)) f(p, cost);
    }
  }
  return cudaSuccess;
}

// the plan of a level: the candidate with the least modelled time
int plan_for(const Level& s, Plan* best) {
  static std::map<std::tuple<int, int, int, int, int, int, int, bool>, Plan> cache;
  static std::mutex mu;
  std::lock_guard<std::mutex> lock(mu);
  const auto key = std::make_tuple(s.B, s.H, s.W, s.C, s.c2, s.c3, s.nc, s.bf16);
  auto hit = cache.find(key);
  if (hit != cache.end()) {
    *best = hit->second;
    return 0;
  }
  double best_cost = -1.0;
  cudaError_t e = each_candidate(s, Model{}, [&](const Plan& p, double cost) {
    if (best_cost < 0 || cost < best_cost) best_cost = cost, *best = p;
  });
  if (e != cudaSuccess) return int(e);
  if (best_cost < 0) return kNoTileFits;
  cache[key] = *best;
  return 0;
}

template <bool CM>
Kernel kernel_of(const Level& s) {
  if (!s.bf16) return head_f32_kernel<CM>;
  return s.c2 <= kBins ? head_mma_kernel<CM, true> : head_mma_kernel<CM, false>;
}

// what the kernel does with a level: out = {tile rows, tile columns, blocks, tiles, blocks an SM
// holds, shared bytes per block, bytes of a ring slot (0 in f32), instruction (0 fmaf, 1 wgmma for
// the reg second conv and mma.sync for the others)}
int plan_entry(const Level& s, long long* out) {
  if (!takes(s)) return kNotTaken;
  Plan p;
  const int e = plan_for(s, &p);
  if (e) return e;
  const long long vals[] = {p.th, p.tw, p.blocks, p.tiles, p.per_sm, (long long)p.smem, 2LL * p.slot,
                            s.bf16 ? 1 : 0};
  for (int i = 0; i < 8; ++i) out[i] = vals[i];
  return 0;
}

// the candidates the plan weighs, in its order: plans[i] = {tile rows, tile columns, bytes of a
// ring slot, blocks, shared bytes}, costs[i] = the modelled time; at most `room`, *count = how many
int candidates_entry(const Level& s, double barrier, int room, long long* plans, double* costs, int* count) {
  if (!takes(s)) return kNotTaken;
  Model m;
  if (barrier == barrier) m.barrier = barrier;  // a NaN keeps the built-in constant
  int k = 0;
  cudaError_t e = each_candidate(s, m, [&](const Plan& p, double cost) {
    if (k < room) {
      const long long vals[] = {p.th, p.tw, 2LL * p.slot, p.blocks, (long long)p.smem};
      for (int i = 0; i < 5; ++i) plans[k * 5 + i] = vals[i];
      costs[k] = cost;
    }
    ++k;
  });
  *count = k;
  return int(e);
}

// th = 0 launches the level's plan; th > 0 the tile given (a measurement's way in)
template <bool CM>
int forward(HeadArgs a, int th, int tw, void* stream) {
  const Level s{a.B, a.H, a.W, a.C, a.c2, a.c3, a.nc, a.wp != nullptr};
  if (!takes(s)) return kNotTaken;
  Plan p;
  if (th > 0) {
    int sms = 0;
    cudaError_t e = sm_count(&sms);
    if (e != cudaSuccess) return int(e);
    double cost = 0.0;
    p.th = th, p.tw = tw;
    if (!candidate(s, sms, Model{}, &p, &cost)) return kNoTileFits;
  } else {
    const int e = plan_for(s, &p);
    if (e) return e;
  }
  a.th = p.th, a.tw = p.tw, a.slot = p.slot;
  const Kernel k = kernel_of<CM>(s);
  dim3 grid(p.blocks);
  if (!s.bf16) grid = dim3(p.tiles / a.B, a.B);
#ifdef YT_HEAD_TRACE
  a.trace = g_head_trace;
  a.trace_block = int(grid.x) / 2;
#endif
  // the limit is lifted to what this launch needs: the card sizes L1 by it
  cudaError_t e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, int(p.smem));
  if (e != cudaSuccess) return int(e);
  k<<<grid, s.bf16 ? kThreads : kF32Threads, p.smem, static_cast<cudaStream_t>(stream)>>>(a);
  YT_RETURN_LAUNCH_ERROR();
}

}  // namespace
