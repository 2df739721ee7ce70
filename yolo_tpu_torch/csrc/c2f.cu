// One whole C2f block in one kernel: cv1 1x1 -> split -> n Bottlenecks (two
// 3x3 ConvBNAct each, optional residual) -> concat -> cv2 1x1, with every
// intermediate map in shared memory. A mode with a second, half-resolution
// input computes C2f(concat(up2x_nearest(small), skip)) without the upsampled
// map or the concat ever existing.
//
// Replaces yolo_tpu/ops/pallas_c2f.py::_c2f_kernel (entries fused_c2f and
// fused_c2f_upconcat). The TPU kernel streams image rows in order and carries
// ring buffers from one grid step to the next; Hopper blocks run in no order
// and share nothing, so a block owns one output tile of one frame and
// recomputes the halo its chain of 3x3 convs needs (2n pixels).
//
// What bounds it on the H100: operations by the roofline (a block moves only
// its input(s) and its output through device memory; chip_smoke.py prints both
// bounds per instance), but the kernel is 20-30x above that bound: its GEMMs
// are small (16..96 output channels, K = 16..96 per weight slice, 80..1200
// pixels per stage). chip_smoke.py --profile counts where one interior block's
// first warp spends its cycles (`[c2f trace]`; NVIDIA H100 80GB HBM3, 700 W,
// bf16, 128 frames; PERF.md has the table):
// - the ldmatrix + mma.sync loop takes 26% of them at c = 12 and 60% at c = 96.
//   There a 3x3 conv's 648 mma of a warp take about 24,000 cycles, 10.7 per mma
//   and tensor core: by the instruction counts (5 ldmatrix.x4 to 12 mma) the
//   shared-memory pipe is the busier one, so a larger item or wgmma, which
//   reads its operands from shared memory itself, is what could shorten it
//   (a guess from counts; 64x48 items on 8 warps were slower, wgmma is untried);
// - the epilogues (bias, SiLU, rounding, stores) take 16-34%: most at c = 12,
//   where they outweigh the products;
// - cv1 takes a fifth to a half of a block though its products are a tenth:
//   every (round, ring step) of it stages its input pixels, waits for them and
//   only then multiplies, so the latency of the copies is paid per step;
// - block barriers take under 1% and the waits for the weight copies 4-8%.
// On the 64x80 (c = 24) and 32x40 (c = 48) maps the two maps and the kept
// segments fill the 227 KB, which sets the tile (16x16, 32x4, 32x8) and so the
// recompute; the 16x20 maps (c = 96) take a 4x20 band, one 20 KB tap per step.
// What the design does about halo recompute, operand traffic and latency:
// - The frame of a tile is clipped to the image plus the convs' one-pixel
//   zero border, and every stage's rectangle to the image, so a tile that
//   spans the image in one direction recomputes nothing there. The plan
//   (plan_for) weighs, per candidate tile and slices per ring step, the
//   rounds of warp items of every stage, the ring steps, and the waves of
//   blocks over the SMs for this batch; with few frames (B = 1) it takes
//   small tiles to spread over the SMs. chip_smoke.py --profile holds its
//   choice against a timed sweep of the candidates (`[c2f plans]`).
// - Every bf16 conv is an implicit GEMM on the tensor cores (mma.sync
//   m16n8k16, f32 accumulators; operands by ldmatrix) whose two operands are
//   both in shared memory: pixels are M, read from the shifted rows of a map
//   (pixel stride pad16(c) + 8 halves, conflict-free); the weights come as
//   slices [pad16(c) out][pad16(c) + 8 in] (one 3x3 tap, one K chunk of cv1,
//   or one concat segment of cv2), streamed from global memory through a ring
//   of two steps of 1, 3 or 9 slices: a step is one bulk copy of the copy
//   engine (TMA without a tensor map), asked for by one thread of the last
//   warp and awaited on an mbarrier, with one block barrier per step to free
//   the other slot; all warps of the block read the slices from there (1.4%
//   faster than 16-byte cp.async by all threads; a third step was never
//   faster and cost its shared memory). mma.sync serves
//   every instance: at N = 16..96 and K = 16..96 per slice, on stages of a few
//   hundred pixels whose rows are shifted per tap, a 64-row wgmma tile with
//   its swizzled operand layouts was not tried.
// - A block is 16 warps of at most 128 registers: measured faster than 8
//   warps with larger items or two blocks of 8 on an SM. A warp item is 32 or
//   64 pixels by up to 48 channels, halved on a stage too small to occupy
//   half the warps.
// - cv1 runs on the tensor cores too: the input pixels (x, or skip plus the
//   small[h/2, w/2] row of each pixel in upconcat mode, read per pixel, never
//   upsampled in memory) are staged by cp.async into the second map's room
//   inside the GEMM, step by step: the pixels that one round of warp items
//   covers, for the K chunks of one ring step, so that all warps have an item
//   whatever c1 is (staging whole pixels at full K left 64 pixels a pass at
//   c1 = 288, and cv1 then took half the time of the upconcat instances).
// - cv2 is one GEMM over the concat at the end, its K walking the segments
//   y_a, y_b, m_0 .. m_{n-1} kept in shared memory over the tile (the last one
//   read from the map), so its sums live in accumulator registers.
// - The epilogue works on channel pairs in packed bf16 (add, multiply and
//   convert round once, as the scalar forms of common.cuh do); a thread loads
//   its biases once per item and turns pixel indices into rows and columns by
//   a multiplication (RowCol), which together took 12% off the kernel.
// In f32 (the exact-track mode; tensor cores would round to tf32) the same
// tiles run on the CUDA cores: cv1 from global memory, the convs through
// common.cuh's conv_smem, cv2 as f32 partial sums per segment in shared
// memory. PERF.md has every instance's time beside its bound and cuDNN's.
// Wide and deep blocks (yolov8 s-x, yolov8-small m-x, yolov10 m-x: c up to 352,
// n up to 10) fit no such tile: a bf16 tap of c x c outgrows a ring step, and
// the two maps over the chain's halo 2n outgrow the 227 KB. Where no one-launch
// tile fits, the plan (plan_for) splits the block into launches of the same
// kernel (the general instantiation, SPLIT):
// - passes: the first launch computes cv1 and bottlenecks [0, nb), each next one
//   the following nb from the previous one's last map, over a halo of 2 nb only;
//   each writes its concat segments (y_a, y_b, m_i) over its tile to a global
//   buffer `cat`, (B, H, W, (2 + n) c8) with c8 = c padded to 8, and a last
//   launch runs cv2 over `cat` as a staged 1x1 GEMM, as cv1 reads x;
// - N chunks: where a ring step of whole slices does not fit, each GEMM computes
//   `np` of its output channels at a time, so a ring slot holds np rows of a
//   slice (np x (pad16(c) + 8)); the packed slices stay as they are, a step
//   copies a row range of them.
// Plans that fit without them are the ones they were (the general
// instantiation is never weighed for them).
#include "common.cuh"

#include <map>
#include <mutex>
#include <tuple>
#include <type_traits>

namespace {

using namespace yt;
using bf16_t = __nv_bfloat16;

constexpr int kThreads = 256;  // f32 blocks
// bf16 blocks: 16 warps of at most 128 registers; one block fills an SM's register file, and
// twice the warps hide the step barriers and fragment loads better than two blocks of eight
constexpr int kMmaWarps = 16;
constexpr size_t kMaxSmem = 232448;  // 227 KB: the most one block may ask for
// steps of the weight ring: the copy of the next step flies while this one is multiplied. A third
// step was never faster on the card and cost a step's shared memory (PERF.md has the sweep).
constexpr int kRing = 2;

// what a launch computes: the whole block, or one pass of a split plan
enum Mode { kWhole = 0, kHead = 1, kMid = 2, kTail = 3 };

struct C2fArgs {
  const void* x;      // plain: (B, H, W, c1); upconcat: skip (B, H, W, c1 - cs)
  const void* small;  // upconcat: (B, H/2, W/2, cs); plain: null
  void* out;          // (B, H, W, c2o)
  const float* w1;    // f32: cv1 [c1][2c] (upconcat: the small channels' rows first)
  const float* b1;    // [2c]
  const float* wm;    // f32: bottleneck i conv j (2i + j) as [9][c][c]
  const float* bm;    // bias of bottleneck i conv j at (2i + j) * c
  const float* w2;    // f32: cv2 [(2 + n) c][c2o]
  const float* b2;    // [c2o]
  const bf16_t* wp;   // bf16: every conv as slices [pad16(c)][pad16(c) + 8], see ops/cuda_c2f.py::pack_slices
  int B, H, W, c1, cs, c, c2o, n, shortcut;
  int th, tw;  // output tile
  int grp;     // weight slices per step of the weight ring (bf16)
  // the general instantiation (SPLIT) only:
  void* cat;   // split plans: the concat segments (B, H, W, (2 + n) c8) between passes; null otherwise
  int mode;    // kWhole; kHead: cv1 and bottlenecks [0, nb); kMid: bottlenecks [j0, j0 + nb); kTail: cv2 over cat
  int j0, nb;  // the bottlenecks of a kHead / kMid pass
  int np;      // bf16: output channels of a GEMM (its N chunk; pad16(c) without chunks)
#ifdef YT_C2F_TRACE
  long long* trace;  // null, or kTraceStages x kTraceSlots cycle counts of block `trace_block`
  int trace_block;
#endif
};

// Built with -DYT_C2F_TRACE (chip_smoke.py --profile does, into a library of its own), thread 0
// of one interior block of a bf16 launch adds the cycles between its ticks to a slot of the GEMM
// it is in: where one warp's time goes, stage by stage. Without the macro nothing of it is compiled.
constexpr int kTraceStages = 16, kTraceSlots = 7;
enum TraceSlot { kCopyWait = 0, kBarrierWait = 1, kCopyIssue = 2, kLoop = 3, kEpilogue = 4, kOther = 5, kSteps = 6 };
struct Trace {
#ifdef YT_C2F_TRACE
  long long* out = nullptr;
  long long t = 0, acc[kTraceSlots] = {};
  int stage = 0;
  __device__ __forceinline__ void start(const C2fArgs& a) {
    if (a.trace && int(blockIdx.x) == a.trace_block && threadIdx.x == 0) out = a.trace, t = clock64();
  }
  __device__ __forceinline__ void tick(TraceSlot slot) {
    if (out) {
      const long long now = clock64();
      acc[slot] += now - t;
      t = now;
    }
  }
  __device__ __forceinline__ void step() { acc[kSteps] += 1; }
  // the GEMM is over: its counts go out (the write is not counted: the clock restarts after it)
  __device__ __forceinline__ void next() {
    if (out) {
#pragma unroll
      for (int i = 0; i < kTraceSlots; ++i) out[stage * kTraceSlots + i] = acc[i], acc[i] = 0;
      stage = stage + 1 < kTraceStages ? stage + 1 : stage;
      t = clock64();
    }
  }
#else
  __device__ void start(const C2fArgs&) {}
  __device__ void tick(TraceSlot) {}
  __device__ void step() {}
  __device__ void next() {}
#endif
};

// the largest frame of a th x tw tile: the tile and its halo R, clipped to the image plus a one-pixel border
__host__ __device__ inline int frame_px(int H, int W, int th, int tw, int R) {
  return imin(th + 2 * R, H + 2) * imin(tw + 2 * R, W + 2);
}

// the halo of a launch: the chain's 2n (whole block), its pass's 2 nb, none for cv2 alone
__host__ __device__ inline int pass_halo(int mode, int n, int nb) { return mode == kTail ? 0 : 2 * (mode == kWhole ? n : nb); }

// shared memory of a bf16 block: map | nseg tile segments | map | weight ring | the ring's barriers. The second
// map's room also stages cv1's input, a round of pixels and a ring step's K chunks at a time. A whole block keeps
// 1 + n segments over its tile (y_a, y_b, m_0 .. m_{n-2}), a pass of a split plan none; the ring holds kRing steps
// of `grp` slices of np rows.
struct MmaLayout {
  size_t map, seg, total;  // bytes
};
__host__ __device__ inline MmaLayout mma_layout(int H, int W, int th, int tw, int R, int nseg, int c, int ring_slices, int np) {
  const int kp = pad16(c), ld = kp + 8;
  MmaLayout l;
  l.map = size_t(frame_px(H, W, th, tw, R)) * ld * 2;
  l.seg = size_t(th) * tw * ld * 2;
  l.total = 2 * l.map + nseg * l.seg + size_t(ring_slices) * np * ld * 2 + kRing * sizeof(uint64_t);
  return l;
}

// shared memory of an f32 block: two maps, and in a whole block the f32 cv2 accumulator over the tile (a split
// plan's last pass reads its concat from global memory and needs none)
__host__ __device__ inline size_t f32_map_bytes(int H, int W, int th, int tw, int R, int c) {
  return (size_t(frame_px(H, W, th, tw, R)) * map_ld(c, false) * 4 + 15) & ~size_t(15);
}
__host__ __device__ inline size_t f32_smem(int H, int W, int th, int tw, int R, int c, int c2o, int mode) {
  if (mode == kTail) return 0;
  return 2 * f32_map_bytes(H, W, th, tw, R, c) + (mode == kWhole ? size_t(th) * tw * (c2o | 1) * 4 : 0);
}

// the channels of one pixel's concat in `cat`: 2 + n segments of c padded to 8 (16-byte copies stay aligned)
__host__ __device__ inline int cat_ld(int c, int n) { return (2 + n) * ((c + 7) & ~7); }

// A block's tile and frame. Frame coordinates are image coordinates minus (oy, ox).
struct Rect {
  int y, x, h, w;
};
struct Geo {
  int b, y0, x0, oy, ox, FH, FW, th, tw, H, W;
  __device__ Geo(const C2fArgs& a, int R) {
    const int tiles_x = (a.W + a.tw - 1) / a.tw, tiles = tiles_x * ((a.H + a.th - 1) / a.th);
    const int t = blockIdx.x % tiles;
    b = blockIdx.x / tiles;
    th = a.th, tw = a.tw, H = a.H, W = a.W;
    y0 = (t / tiles_x) * th;
    x0 = (t % tiles_x) * tw;
    oy = imax(y0 - R, -1);
    ox = imax(x0 - R, -1);
    FH = imin(y0 + th + R, H + 1) - oy;
    FW = imin(x0 + tw + R, W + 1) - ox;
  }
  // the tile grown by `halo`, clipped to the image, in frame coordinates
  __device__ Rect rect(int halo) const {
    const int iy0 = imax(y0 - halo, 0), iy1 = imin(y0 + th + halo, H);
    const int ix0 = imax(x0 - halo, 0), ix1 = imin(x0 + tw + halo, W);
    return {iy0 - oy, ix0 - ox, iy1 - iy0, ix1 - ix0};
  }
};

// ---------------------------------------------------------------- bf16 ----

// 16-pixel tiles in a warp item of a GEMM over npx pixels: the instantiation's `most`, halved
// while the items would leave half the warps of a round idle
__host__ __device__ inline int item_mtiles(int npx, int nchunks, int most, int warps) {
  int mt = most;
  while (mt > 1 && ((npx + 16 * mt - 1) / (16 * mt)) * nchunks <= warps / 2) mt /= 2;
  return mt;
}

// the most pixels the items of one round of a GEMM cover (an upper bound)
__host__ __device__ inline int round_px(int npx, int kp, int most, int nt, int warps) {
  const int nchunks = (kp + 8 * nt - 1) / (8 * nt);
  const int px = ((warps + nchunks - 1) / nchunks + (warps % nchunks ? 1 : 0)) * 16 * item_mtiles(npx, nchunks, most, warps);
  return px < npx ? px : npx;
}

// K chunks of cv1 to a ring step: as many (at most `most`) as `room` halves hold for `px` staged
// rows of (chunks * kp + 8) halves; one chunk always fits, a map has a row of kp + 8 for every pixel
__host__ __device__ inline int cv1_group(int room, int kp, int most, int px) {
  int g = most;
  while (g > 1 && (g * kp + 8) * px > room) --g;
  return g;
}

struct Ring {
  bf16_t* buf;    // kRing steps of grp slices
  uint64_t* bar;  // one mbarrier per step: its phase completes when the step's slices have landed
  int* done;      // ring steps the block's GEMMs have taken so far: step number -> slot and phase parity
  int grp;
  int sl;  // halves per slice in a slot: np * (kp + 8)
  int np, kp;
  int gsl;   // halves between slices in global memory: kp * (kp + 8), the packed slices' own size
  int rows;  // rows of a slice a step copies: np, or fewer in a conv's last N chunk
};

// one ring step of `cnt` slices of `rows` rows each, `gsl` halves apart in global memory and `sl` apart in the
// slot: one expected byte count on the step's barrier, one bulk copy per slice
__device__ __forceinline__ void bulk_copy_rows(bf16_t* dst, const bf16_t* src, int cnt, int sl, int gsl, uint32_t bytes,
                                               uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes * cnt) : "memory");
  for (int q = 0; q < cnt; ++q) {
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
                     smem_u32(dst + size_t(q) * sl)),
                 "l"(src + size_t(q) * gsl), "r"(bytes), "r"(smem_u32(bar))
                 : "memory");
  }
}

// One implicit GEMM of a block on the tensor cores: rows = `npx` pixels,
// N = rg.np output channels, K = `nsl` slices of rg.kp. A warp item is
// 16*MT pixels (fewer on a small stage, item_mtiles) x 8*NT channels; the
// items are dealt to the warps in rounds, and all warps walk the slices
// together, rg.grp slices to a step: step g of
// the flat sequence (rounds x steps) is copied into the ring one step
// ahead of its use, as one bulk copy that thread 0 asks the copy engine
// for; the threads wait for it on the slot's mbarrier, and one block barrier
// per step frees the other slot for the next copy.
// `pix(p, o0, o1)` gives pixel p's row offsets, `at(s, o0, o1)` the row's
// pointer for slice s; the sums of channels oc, oc + 1 < nvalid of pixel p go
// through the ConvBNAct epilogue (act2, with bias[oc], bias[oc + 1], which a
// thread loads once per item) and `put(hnd(p), oc, y)` stores the pair. KS is
// rg.kp / 16 at compile time (the K loop of a slice unrolls, so fragment loads
// run ahead of the mma), or 0 for a width without an instantiation; NW is the
// block's warps. Where the A
// operand is not in shared memory yet (cv1), `stg(p0, np, s0, cnt)` starts the
// copies of pixels [p0, p0 + np), the ones a round's items cover, for slices
// [s0, s0 + cnt) of a step, between two barriers of that step; InPlace says
// there is nothing to stage. CH (the general instantiation) copies a step slice by slice, the rows of an N
// chunk; otherwise a step is one copy of whole, adjacent slices.
struct InPlace {
  __device__ void operator()(int, int, int, int) const {}
};
template <int MT, int NT, int KS, int NW, bool CH = false, class Pix, class At, class Hnd, class Put, class Stg = InPlace>
__device__ __forceinline__ void gemm(Trace& tr, const Ring& rg, const bf16_t* __restrict__ wsl, int nsl, int npx,
                                     const float* __restrict__ bias, int nvalid, Pix pix, At at, Hnd hnd, Put put,
                                     Stg stg = Stg()) {
  constexpr bool kStaged = !std::is_same<Stg, InPlace>::value;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  const int kw8 = rg.kp + 8;
  const int nchunks = (rg.np + 8 * NT - 1) / (8 * NT);
  const int mt = item_mtiles(npx, nchunks, MT, NW);  // 16-pixel tiles of an item in this GEMM
  const int mtiles = (npx + 16 * mt - 1) / (16 * mt);
  const int items = mtiles * nchunks;
  const int steps = (nsl + rg.grp - 1) / rg.grp;  // per round
  const int total = ((items + NW - 1) / NW) * steps;
  const int g0 = *rg.done;  // the block's count of ring steps before this GEMM
  auto load = [&](int g) {
    if (threadIdx.x == (NW - 1) * 32 && g < total) {  // the last warp is the first to be without an item
      const int s0 = (g % steps) * rg.grp, cnt = imin(rg.grp, nsl - s0), slot = (g0 + g) % kRing;
      if constexpr (CH) {
        bulk_copy_rows(rg.buf + size_t(slot) * rg.grp * rg.sl, wsl + size_t(s0) * rg.gsl, cnt, rg.sl, rg.gsl,
                       uint32_t(rg.rows) * kw8 * 2, rg.bar + slot);
      } else {
        bulk_copy_g2s(rg.buf + size_t(slot) * rg.grp * rg.sl, wsl + size_t(s0) * rg.sl, uint32_t(cnt) * rg.sl * 2, rg.bar + slot);
      }
    }
  };
  tr.tick(kOther);
  __syncthreads();  // the A operand is written; the ring's last readers are done
  tr.tick(kBarrierWait);
  load(0);
  tr.tick(kCopyIssue);

  float acc[MT][NT][4];
  int o0[MT], o1[MT];
  int m = 0, nb = 0, st = 0, turn = 0;
  bool live = false;
  for (int g = 0; g < total; ++g) {
    if (st == 0) {
      const int item = turn * NW + warp;
      live = item < items;
      m = item / nchunks;  // a round's items cover one range of pixels
      nb = (item % nchunks) * 8 * NT;
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
#pragma unroll
        for (int j = 0; j < NT; ++j) acc[mi][j][0] = acc[mi][j][1] = acc[mi][j][2] = acc[mi][j][3] = 0.f;
        pix(imin((m * mt + imin(mi, mt - 1)) * 16 + (lane & 15), npx - 1), o0[mi], o1[mi]);
      }
      tr.tick(kOther);
    }
    mbar_wait(rg.bar + (g0 + g) % kRing, ((g0 + g) / kRing) & 1);  // step g has landed
    tr.tick(kCopyWait);
    __syncthreads();  // everyone's has; the slot of step g - 1 and the staged pixels are free
    tr.tick(kBarrierWait);
    tr.step();
    if constexpr (kStaged) {
      const int p0 = (turn * NW / nchunks) * 16 * mt;
      const int p1 = imin(npx, (((turn + 1) * NW - 1) / nchunks + 1) * 16 * mt);
      stg(p0, p1 - p0, st * rg.grp, imin(rg.grp, nsl - st * rg.grp));
      cp_async_commit();
      load(g + 1);
      tr.tick(kCopyIssue);
      cp_async_wait(0);  // the staged pixels
      tr.tick(kCopyWait);
      __syncthreads();
      tr.tick(kBarrierWait);
    } else {
      load(g + 1);
      tr.tick(kCopyIssue);
    }
    if (live) {
      const int s0 = st * rg.grp, cnt = imin(rg.grp, nsl - s0);
      const bf16_t* bp = rg.buf + size_t((g0 + g) % kRing) * rg.grp * rg.sl +
                         (nb + (lane & 7) + ((lane >> 4) << 3)) * kw8 + ((lane >> 3) & 1) * 8;
      for (int q = 0; q < cnt; ++q, bp += rg.sl) {
        const bf16_t* ap[MT];
#pragma unroll
        for (int mi = 0; mi < MT; ++mi) ap[mi] = at(s0 + q, o0[mi], o1[mi]) + (lane >> 4) * 8;
#pragma unroll
        for (int kc = 0; kc < (KS ? KS * 16 : rg.kp); kc += 16) {
          uint32_t af[MT][4];
#pragma unroll
          for (int mi = 0; mi < MT; ++mi) {
            if (mi < mt) ldmatrix_x4(af[mi], ap[mi] + kc);
          }
#pragma unroll
          for (int j = 0; j < NT; j += 2) {
            if (nb + j * 8 < rg.np) {
              uint32_t bq[4];
              ldmatrix_x4(bq, bp + j * 8 * kw8 + kc);
#pragma unroll
              for (int mi = 0; mi < MT; ++mi) {
                if (mi < mt) {
                  mma_bf16_16816(acc[mi][j], af[mi], bq[0], bq[1]);
                  mma_bf16_16816(acc[mi][j + 1], af[mi], bq[2], bq[3]);
                }
              }
            }
          }
        }
      }
      tr.tick(kLoop);
      if (st == steps - 1) {
        bf16x2_t bj[NT];  // the biases of this lane's channel pairs, rounded as the epilogue wants them
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int oc = nb + j * 8 + tig * 2;
          bj[j] = oc < nvalid ? __floats2bfloat162_rn(__ldg(bias + oc), __ldg(bias + oc + 1)) : __floats2bfloat162_rn(0.f, 0.f);
        }
#pragma unroll
        for (int mi = 0; mi < MT; ++mi) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int p = (m * mt + mi) * 16 + gid + r * 8;
            if (mi < mt && p < npx) {
              const auto h = hnd(p);
#pragma unroll
              for (int j = 0; j < NT; ++j) {
                const int oc = nb + j * 8 + tig * 2;
                if (oc < nvalid) put(h, oc, act2(acc[mi][j][2 * r], acc[mi][j][2 * r + 1], bj[j]));
              }
            }
          }
        }
      }
    }
    tr.tick(kEpilogue);
    if (++st == steps) st = 0, ++turn;
  }
  *rg.done = g0 + total;
  tr.next();
}

// SPLIT: the general instantiation, which also runs N chunks (np < pad16(c)) and the passes of a split plan
// (C2fArgs::mode); without it the launch is a whole block with np = pad16(c), the code of every plan that fits so.
template <int MT, int NT, int KS, int NW, bool SPLIT = false>
__global__ void __launch_bounds__(NW * 32) c2f_mma_kernel(C2fArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = a.n, c = a.c, c2o = a.c2o, H = a.H, W = a.W;
  const int mode = SPLIT ? a.mode : kWhole;
  const int j0 = SPLIT ? a.j0 : 0, nbk = SPLIT && mode != kWhole ? a.nb : n;  // this launch's bottlenecks
  const int R = SPLIT ? pass_halo(mode, n, nbk) : 2 * n;
  const int kp = pad16(c), ld = kp + 8;
  const int np = SPLIT ? a.np : kp;
  const int nk1 = (a.c1 + kp - 1) / kp;
  const int nseg = mode == kWhole ? 1 + n : 0;
  const MmaLayout L = mma_layout(H, W, a.th, a.tw, R, nseg, c, kRing * a.grp, np);
  bf16_t* buf0 = reinterpret_cast<bf16_t*>(smem);
  bf16_t* segs = reinterpret_cast<bf16_t*>(smem + L.map);  // whole block: y_a, y_b, m_0 .. m_{n-2} over the tile
  bf16_t* buf1 = reinterpret_cast<bf16_t*>(smem + L.map + nseg * L.seg);
  const int segh = int(L.seg / 2);
  unsigned char* ring = smem + 2 * L.map + nseg * L.seg;
  int ring_steps = 0;
  const Ring rg{reinterpret_cast<bf16_t*>(ring), reinterpret_cast<uint64_t*>(ring + size_t(kRing) * a.grp * np * ld * 2),
                &ring_steps, a.grp, np * ld, np, kp, kp * ld, np};
  const size_t SL = size_t(rg.gsl);
  // the ring of N chunk q of a conv with `cout` outputs: the chunk's rows of each slice
  auto chunk = [&](int q, int cout) {
    Ring r = rg;
    if (SPLIT) r.rows = r.np = imin(np, pad16(cout) - q * np);
    return r;
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < kRing; ++s) mbar_init(rg.bar + s, 1);
    mbar_init_fence();
  }

  const Geo g(a, R);
  const int FW = g.FW, tY = g.y0 - g.oy, tX = g.x0 - g.ox;
  const Rect T = g.rect(0);
  // offset into a tile segment of frame pixel (fy, fx), or -1 outside the tile
  auto tile_off = [&](int fy, int fx) {
    const int ty = fy - tY, tx = fx - tX;
    return (ty >= 0 && ty < T.h && tx >= 0 && tx < T.w) ? (ty * T.w + tx) * ld : -1;
  };
  // split plans: the concat in global memory, and the offset of frame pixel (fy, fx)'s concat there (-1 off the tile)
  bf16_t* cat = static_cast<bf16_t*>(a.cat);
  const int cld = cat_ld(c, n), c8 = (c + 7) & ~7;
  auto cat_off = [&](int fy, int fx) -> long long {
    const int ty = fy - tY, tx = fx - tX;
    if (ty < 0 || ty >= T.h || tx < 0 || tx >= T.w) return -1;
    return ((long long)(g.b * H + g.y0 + ty) * W + g.x0 + tx) * cld;
  };
  // 8 channels [k, k + 8) of a concat segment from global memory, of which those from c on read as zeros
  auto seg8 = [&](bf16_t* dst, const bf16_t* src, int k) {
    if (k + 8 <= c) {
      cp_async16(dst, src);
    } else if (k < c) {  // c % 8 == 4: half a copy
      *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(src);
      *reinterpret_cast<uint2*>(dst + 4) = make_uint2(0, 0);
    } else {
      *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
    }
  };

  Trace tr;
  tr.start(a);
  // padded channels and the one-pixel border must read as zeros
  zero_smem(smem, L.map + nseg * L.seg);
  if (SPLIT && mode == kMid) zero_smem(reinterpret_cast<unsigned char*>(buf1), L.map);

  // ---- a 1x1 conv whose input is staged from global memory into buf1 (cv1; cv2 of a split plan's last pass):
  // N chunk rq of slices w over `nsl` K chunks of kp, over rectangle rc; fetch(dst, iy, ix, ch) stages input
  // channels [ch, ch + 8) of image pixel (iy, ix)
  auto staged = [&](const Rect rc, const Ring& rq, const bf16_t* w, int nsl, const float* bias, int nvalid, auto hnd,
                    auto put, auto fetch) {
    const int npx = rc.h * rc.w;
    const RowCol yx(rc.w);
    Ring r1 = rq;  // as many K chunks to a step as the staged rows of a round leave room for
    r1.grp = cv1_group(int(L.map / 2), kp, imin(rq.grp, nsl), round_px(npx, rq.np, MT, NT, NW));
    const int rowh = r1.grp * kp + 8;
    int cur_p0 = 0, cur_s0 = 0;
    gemm<MT, NT, KS, NW, SPLIT>(
        tr, r1, w, nsl, npx, bias, nvalid, [&](int p, int& o0, int& o1) { o0 = p, o1 = 0; },
        [&](int s, int o0, int) { return buf1 + (o0 - cur_p0) * rowh + (s - cur_s0) * kp; }, hnd, put,
        [&](int p0, int np_, int s0, int cnt) {
          cur_p0 = p0, cur_s0 = s0;
          const int q8 = cnt * kp / 8;
          for (int i = threadIdx.x; i < np_ * q8; i += NW * 32) {
            const int r = i / q8, k = (i - r * q8) * 8;
            int iy, ix;
            yx(p0 + r, iy, ix);
            fetch(buf1 + r * rowh + k, iy + g.oy + rc.y, ix + g.ox + rc.x, s0 * kp + k);
          }
        });
  };

  bf16_t* out = static_cast<bf16_t*>(a.out);
  const RowCol yxT(T.w);
  // the output offset of tile pixel p
  auto out_off = [&](int p) {
    int ty, tx;
    yxT(p, ty, tx);
    return ((size_t(g.b) * H + g.y0 + ty) * W + g.x0 + tx) * c2o;
  };
  if (SPLIT && mode == kTail) {  // ---- cv2 over the concat in global memory; K walks its segments
    const bf16_t* cin = cat;
    for (int oh = 0; oh * kp < c2o; ++oh) {
      for (int q = 0; q * np < imin(kp, c2o - oh * kp); ++q) {
        const int ob = oh * kp + q * np;
        staged(T, chunk(q, imin(kp, c2o - oh * kp)), a.wp + size_t(2 * nk1 + 2 * n * 9 + oh * (2 + n)) * SL + size_t(q) * np * ld,
               2 + n, a.b2 + ob, imin(np, c2o - ob), out_off, [&](size_t off, int oc, bf16x2_t y) { pair_at(out + off + ob + oc) = y; },
               [&](bf16_t* dst, int iy, int ix, int ch) {
                 const int s = ch / kp, k = ch - s * kp;
                 seg8(dst, cin + ((size_t(g.b) * H + iy) * W + ix) * cld + s * c8 + k, k);
               });
      }
    }
    return;
  }

  // ---- cv1: one half (0: y_a, 1: y_b) over a rectangle, input staged in buf1
  const bf16_t* x = static_cast<const bf16_t*>(a.x);
  const bf16_t* small = static_cast<const bf16_t*>(a.small);
  const int cs = a.cs, ck = a.c1 - a.cs;
  auto fetch_x = [&](bf16_t* dst, int iy, int ix, int ch) {
    if (ch < cs) {
      cp_async16(dst, small + ((size_t(g.b) * (H / 2) + iy / 2) * (W / 2) + ix / 2) * cs + ch);
    } else if (ch < a.c1) {
      cp_async16(dst, x + ((size_t(g.b) * H + iy) * W + ix) * ck + (ch - cs));
    } else {
      *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
    }
  };
  const int nq = SPLIT ? cdiv(c, np) : 1;  // N chunks of a conv with c outputs
  const Rect rb = g.rect(R);
  const RowCol yxb(rb.w);
  if (mode == kWhole) {
    for (int q = 0; q < nq; ++q) {
      const int ob = q * np;
      // y_a over the tile: only cv2 reads it
      staged(T, chunk(q, c), a.wp + size_t(q) * np * ld, nk1, a.b1 + ob, imin(np, c - ob), [&](int p) { return p * ld; },
             [&](int off, int oc, bf16x2_t y) { pair_at(segs + off + ob + oc) = y; }, fetch_x);
      // y_b over the whole frame: the bottleneck chain's input
      staged(
          rb, chunk(q, c), a.wp + size_t(nk1) * SL + size_t(q) * np * ld, nk1, a.b1 + c + ob, imin(np, c - ob),
          [&](int p) {
            int fy, fx;
            yxb(p, fy, fx);
            fy += rb.y, fx += rb.x;
            return make_int2((fy * FW + fx) * ld, tile_off(fy, fx));
          },
          [&](int2 off, int oc, bf16x2_t y) {
            pair_at(buf0 + off.x + ob + oc) = y;
            if (off.y >= 0) pair_at(segs + segh + off.y + ob + oc) = y;
          },
          fetch_x);
    }
  } else if (SPLIT && mode == kHead) {
    for (int q = 0; q < nq; ++q) {
      const int ob = q * np;
      staged(
          T, chunk(q, c), a.wp + size_t(q) * np * ld, nk1, a.b1 + ob, imin(np, c - ob),
          [&](int p) {
            int ty, tx;
            yxT(p, ty, tx);
            return cat_off(tY + ty, tX + tx);
          },
          [&](long long off, int oc, bf16x2_t y) { pair_at(cat + off + ob + oc) = y; }, fetch_x);
      staged(
          rb, chunk(q, c), a.wp + size_t(nk1) * SL + size_t(q) * np * ld, nk1, a.b1 + c + ob, imin(np, c - ob),
          [&](int p) {
            int fy, fx;
            yxb(p, fy, fx);
            fy += rb.y, fx += rb.x;
            return make_longlong2((fy * FW + fx) * ld, cat_off(fy, fx));
          },
          [&](longlong2 off, int oc, bf16x2_t y) {
            pair_at(buf0 + off.x + ob + oc) = y;
            if (off.y >= 0) pair_at(cat + off.y + c8 + ob + oc) = y;
          },
          fetch_x);
    }
  } else if (SPLIT) {  // kMid: the chain's input, the last map of the pass before, over the frame
    __syncthreads();  // the maps are zero before the copies land
    for (int i = threadIdx.x; i < rb.h * rb.w * (c8 / 8); i += NW * 32) {
      const int p = i / (c8 / 8), k = (i - p * (c8 / 8)) * 8;
      int fy, fx;
      yxb(p, fy, fx);
      fy += rb.y, fx += rb.x;
      seg8(buf0 + (fy * FW + fx) * ld + k, cat + ((size_t(g.b) * H + g.oy + fy) * W + g.ox + fx) * cld + (1 + j0) * c8 + k, k);
    }
    cp_async_commit();
    cp_async_wait(0);
  }
  if (mode != kMid) {
    __syncthreads();
    zero_smem(reinterpret_cast<unsigned char*>(buf1), L.map);  // it held the staged input
  }

  // ---- the bottleneck chain: buf0 -> buf1 -> buf0 (in place: an element reads only its own residual)
  for (int i = j0; i < j0 + nbk; ++i) {
    const int k = i - j0;
    const Rect r1 = g.rect(R - 2 * k - 1), r2 = g.rect(R - 2 * k - 2);
    const float* b_1 = a.bm + (2 * i) * c;
    const float* b_2 = a.bm + (2 * i + 1) * c;
    const bf16_t* w_1 = a.wp + size_t(2 * nk1 + (2 * i) * 9) * SL;
    auto tap = [&](const bf16_t* in) {
      return [=](int s, int o0, int) { return in + o0 + ((s / 3 - 1) * FW + (s % 3 - 1)) * ld; };
    };
    // offset into a map of pixel p of a rectangle
    auto map_off = [&](const Rect& rc, const RowCol& yx, int p) {
      int fy, fx;
      yx(p, fy, fx);
      return ((rc.y + fy) * FW + rc.x + fx) * ld;
    };
    const RowCol yx1(r1.w), yx2(r2.w);
    for (int q = 0; q < nq; ++q) {
      const int ob = q * np;
      gemm<MT, NT, KS, NW, SPLIT>(
          tr, chunk(q, c), w_1 + size_t(q) * np * ld, 9, r1.h * r1.w, b_1 + ob, imin(np, c - ob),
          [&](int p, int& o0, int& o1) { o0 = map_off(r1, yx1, p), o1 = 0; }, tap(buf0), [&](int p) { return map_off(r1, yx1, p); },
          [&](int off, int oc, bf16x2_t y) { pair_at(buf1 + off + ob + oc) = y; });
    }
    for (int q = 0; q < nq; ++q) {
      const int ob = q * np;
      if (mode == kWhole) {
        bf16_t* keep = i < n - 1 ? segs + (2 + i) * segh : nullptr;  // the last m is read from buf0 itself
        gemm<MT, NT, KS, NW, SPLIT>(
            tr, chunk(q, c), w_1 + 9 * SL + size_t(q) * np * ld, 9, r2.h * r2.w, b_2 + ob, imin(np, c - ob),
            [&](int p, int& o0, int& o1) { o0 = map_off(r2, yx2, p), o1 = 0; }, tap(buf1),
            [&](int p) {
              int fy, fx;
              yx2(p, fy, fx);
              fy += r2.y, fx += r2.x;
              return make_int2((fy * FW + fx) * ld, keep ? tile_off(fy, fx) : -1);
            },
            [&](int2 off, int oc, bf16x2_t y) {
              bf16x2_t& d = pair_at(buf0 + off.x + ob + oc);
              if (a.shortcut) y = __hadd2_rn(y, d);
              d = y;
              if (off.y >= 0) pair_at(keep + off.y + ob + oc) = y;
            });
      } else if (SPLIT) {  // every m of a pass goes to the concat: cv2 and the next pass read it there
        bf16_t* keep = cat + (2 + i) * c8;
        gemm<MT, NT, KS, NW, SPLIT>(
            tr, chunk(q, c), w_1 + 9 * SL + size_t(q) * np * ld, 9, r2.h * r2.w, b_2 + ob, imin(np, c - ob),
            [&](int p, int& o0, int& o1) { o0 = map_off(r2, yx2, p), o1 = 0; }, tap(buf1),
            [&](int p) {
              int fy, fx;
              yx2(p, fy, fx);
              fy += r2.y, fx += r2.x;
              return make_longlong2((fy * FW + fx) * ld, cat_off(fy, fx));
            },
            [&](longlong2 off, int oc, bf16x2_t y) {
              bf16x2_t& d = pair_at(buf0 + off.x + ob + oc);
              if (a.shortcut) y = __hadd2_rn(y, d);
              d = y;
              if (off.y >= 0) pair_at(keep + off.y + ob + oc) = y;
            });
      }
    }
  }
  if (mode != kWhole) return;

  // ---- cv2 over the concat, one GEMM per chunk of kp output channels (and N chunk of it); K walks the segments
  const bf16_t* w_2 = a.wp + size_t(2 * nk1 + 2 * n * 9) * SL;
  for (int oh = 0; oh * kp < c2o; ++oh) {
    for (int q = 0; q < (SPLIT ? cdiv(imin(kp, c2o - oh * kp), np) : 1); ++q) {
      const int ob = oh * kp + q * np;
      gemm<MT, NT, KS, NW, SPLIT>(
          tr, chunk(q, imin(kp, c2o - oh * kp)), w_2 + size_t(oh * (2 + n)) * SL + size_t(q) * np * ld, 2 + n, T.h * T.w,
          a.b2 + ob, SPLIT ? imin(np, c2o - ob) : c2o - ob,
          [&](int p, int& o0, int& o1) {
            int ty, tx;
            yxT(p, ty, tx);
            o0 = p * ld, o1 = ((tY + ty) * FW + tX + tx) * ld;
          },
          [&](int s, int o0, int o1) { return s < 1 + n ? segs + s * segh + o0 : buf0 + o1; }, out_off,
          [&](size_t off, int oc, bf16x2_t y) { pair_at(out + off + ob + oc) = y; });
    }
  }
}


// ----------------------------------------------------------------- f32 ----

// two blocks to an SM where the maps allow it: the 128 registers this leaves a thread let the
// compiler keep more weight loads in flight than it does when left to choose
// SPLIT: the general instantiation, which also runs the passes of a split plan (C2fArgs::mode)
template <int OCB, bool SPLIT = false>
__global__ void __launch_bounds__(kThreads, 2) c2f_f32_kernel(C2fArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = a.n, c = a.c, c2o = a.c2o, H = a.H, W = a.W, tw = a.tw;
  const int mode = SPLIT ? a.mode : kWhole;
  const int j0 = SPLIT ? a.j0 : 0, nbk = SPLIT && mode != kWhole ? a.nb : n;  // this launch's bottlenecks
  const int R = SPLIT ? pass_halo(mode, n, nbk) : 2 * n;
  const int ld = map_ld(c, false), ld2 = c2o | 1;
  const size_t map_bytes = f32_map_bytes(H, W, a.th, tw, R, c);
  float* buf0 = reinterpret_cast<float*>(smem);
  float* buf1 = reinterpret_cast<float*>(smem + map_bytes);
  float* acc2 = reinterpret_cast<float*>(smem + 2 * map_bytes);
  const Geo g(a, R);
  const int FW = g.FW, tY = g.y0 - g.oy, tX = g.x0 - g.ox;
  const Rect T = g.rect(0);
  float* cat = static_cast<float*>(a.cat);
  const int cld = cat_ld(c, n), c8 = (c + 7) & ~7;
  float* out = static_cast<float*>(a.out);
  if (SPLIT && mode == kTail) {  // cv2 over the concat in global memory: OCB output channels of a tile pixel a thread
    const int npx = T.h * T.w;
    for (int it = threadIdx.x; it < npx * (c2o / OCB); it += kThreads) {
      const int gr = it / npx, p = it - gr * npx;
      const int iy = g.y0 + p / T.w, ix = g.x0 + p % T.w;
      const int oc0 = gr * OCB;
      const float* cp = cat + ((size_t(g.b) * H + iy) * W + ix) * cld;
      float acc[OCB];
#pragma unroll
      for (int o = 0; o < OCB; ++o) acc[o] = 0.f;
      for (int sg = 0; sg < 2 + n; ++sg) {
        for (int ci = 0; ci < c; ++ci) {
          const float v = cp[sg * c8 + ci];
          float wv[OCB];
          load_w<OCB>(a.w2 + size_t(sg * c + ci) * c2o + oc0, wv);
#pragma unroll
          for (int o = 0; o < OCB; ++o) acc[o] = fmaf(v, wv[o], acc[o]);
        }
      }
      float* d = out + ((size_t(g.b) * H + iy) * W + ix) * c2o + oc0;
#pragma unroll
      for (int o = 0; o < OCB; ++o) d[o] = silu<false>(bias_add<false>(acc[o], __ldg(a.b2 + oc0 + o)));
    }
    return;
  }
  // a split plan's pass: a map's tile into concat segment `seg`
  auto store_seg = [&](const float* src, int seg) {
    for (int i = threadIdx.x; i < T.h * T.w * c; i += kThreads) {
      const int p = i / c, ch = i - p * c, ty = p / T.w, tx = p - ty * T.w;
      cat[((size_t(g.b) * H + g.y0 + ty) * W + g.x0 + tx) * cld + seg * c8 + ch] = src[((T.y + ty) * FW + T.x + tx) * ld + ch];
    }
  };
  // frame pixels outside the image are never written: they read as the convs' zero padding
  for (int i = threadIdx.x; i < g.FH * FW; i += kThreads) {
    const int iy = g.oy + i / FW, ix = g.ox + i % FW;
    if (iy < 0 || iy >= H || ix < 0 || ix >= W) {
      for (int ch = 0; ch < c; ++ch) buf0[i * ld + ch] = buf1[i * ld + ch] = 0.f;
    }
  }
  __syncthreads();

  const float* x = static_cast<const float*>(a.x);
  const float* small = static_cast<const float*>(a.small);
  const int cs = a.cs, ck = a.c1 - a.cs, c2 = 2 * c;

  // ---- cv1 (1x1 from global memory): channels [half*c, half*c + c) over a rectangle
  auto cv1 = [&](int half, float* dst, const Rect rc) {
    const int npx = rc.h * rc.w;
    for (int it = threadIdx.x; it < npx * (c / OCB); it += kThreads) {
      const int gr = it / npx, p = it - gr * npx;
      const int fy = rc.y + p / rc.w, fx = rc.x + p % rc.w;
      const int iy = g.oy + fy, ix = g.ox + fx;
      const int oc0 = half * c + gr * OCB;
      float acc[OCB];
#pragma unroll
      for (int o = 0; o < OCB; ++o) acc[o] = 0.f;
      if (cs) {
        const float* sp = small + ((size_t(g.b) * (H / 2) + iy / 2) * (W / 2) + ix / 2) * cs;
        for (int ci = 0; ci < cs; ++ci) {
          const float v = sp[ci];
          float wv[OCB];
          load_w<OCB>(a.w1 + ci * c2 + oc0, wv);
#pragma unroll
          for (int o = 0; o < OCB; ++o) acc[o] = fmaf(v, wv[o], acc[o]);
        }
      }
      const float* xp = x + ((size_t(g.b) * H + iy) * W + ix) * ck;
      for (int ci = 0; ci < ck; ++ci) {
        const float v = xp[ci];
        float wv[OCB];
        load_w<OCB>(a.w1 + (cs + ci) * c2 + oc0, wv);
#pragma unroll
        for (int o = 0; o < OCB; ++o) acc[o] = fmaf(v, wv[o], acc[o]);
      }
      float* d = dst + (fy * FW + fx) * ld + gr * OCB;
#pragma unroll
      for (int o = 0; o < OCB; ++o) d[o] = silu<false>(bias_add<false>(acc[o], __ldg(a.b1 + oc0 + o)));
    }
  };

  // ---- cv2 partial product of concat segment `seg` (a map of c channels) over the tile
  auto cv2_acc = [&](const float* src, int seg, bool init) {
    conv_smem<1, 8, float>(src, FW, ld, c, a.w2 + size_t(seg) * c * c2o, c2o, c2o, T.y, T.x, T.h, T.w,
                           [&](int fy, int fx, int oc0, float(&acc)[8]) {
                             float* d = acc2 + ((fy - tY) * tw + (fx - tX)) * ld2 + oc0;
#pragma unroll
                             for (int o = 0; o < 8; ++o) d[o] = init ? acc[o] : d[o] + acc[o];
                           });
  };

  if (mode == kWhole || mode == kHead) {
    cv1(1, buf0, g.rect(R));  // y_b over the whole frame: the bottleneck chain's input
    cv1(0, buf1, T);          // y_a over the tile: only cv2 reads it
    __syncthreads();
    if (mode == kWhole) {
      cv2_acc(buf1, 0, true);
      cv2_acc(buf0, 1, false);
    } else {
      store_seg(buf1, 0);
      store_seg(buf0, 1);
    }
  } else if (SPLIT) {  // kMid: the chain's input, the last map of the pass before, over the frame
    const Rect rb = g.rect(R);
    for (int i = threadIdx.x; i < rb.h * rb.w * c; i += kThreads) {
      const int p = i / c, ch = i - p * c, fy = rb.y + p / rb.w, fx = rb.x + p % rb.w;
      buf0[(fy * FW + fx) * ld + ch] = cat[((size_t(g.b) * H + g.oy + fy) * W + g.ox + fx) * cld + (1 + j0) * c8 + ch];
    }
  }

  for (int i = j0; i < j0 + nbk; ++i) {
    const int k = i - j0;
    const Rect r1 = g.rect(R - 2 * k - 1), r2 = g.rect(R - 2 * k - 2);
    const float* b_1 = a.bm + (2 * i) * c;
    const float* b_2 = a.bm + (2 * i + 1) * c;
    const float* w_1 = a.wm + size_t(2 * i) * 9 * c * c;
    __syncthreads();  // buf0 complete; the last readers of buf1 are done
    conv_smem<3, OCB, float>(buf0, FW, ld, c, w_1, c, c, r1.y, r1.x, r1.h, r1.w,
                             [&](int fy, int fx, int oc0, float(&acc)[OCB]) {
                               float* d = buf1 + (fy * FW + fx) * ld + oc0;
#pragma unroll
                               for (int o = 0; o < OCB; ++o) d[o] = silu<false>(bias_add<false>(acc[o], __ldg(b_1 + oc0 + o)));
                             });
    __syncthreads();
    // second conv in place over buf0: an output element reads only its own residual
    conv_smem<3, OCB, float>(buf1, FW, ld, c, w_1 + 9 * c * c, c, c, r2.y, r2.x, r2.h, r2.w,
                             [&](int fy, int fx, int oc0, float(&acc)[OCB]) {
                               float* d = buf0 + (fy * FW + fx) * ld + oc0;
#pragma unroll
                               for (int o = 0; o < OCB; ++o) {
                                 float v = silu<false>(bias_add<false>(acc[o], __ldg(b_2 + oc0 + o)));
                                 if (a.shortcut) v += d[o];
                                 d[o] = v;
                               }
                             });
    __syncthreads();
    if (mode == kWhole) {
      cv2_acc(buf0, 2 + i, false);
    } else {
      store_seg(buf0, 2 + i);
    }
  }
  if (mode != kWhole) return;
  __syncthreads();

  // ---- cv2 epilogue: consecutive threads write consecutive channels of a pixel
  for (int idx = threadIdx.x; idx < T.h * T.w * c2o; idx += kThreads) {
    const int p = idx / c2o, o = idx - p * c2o;
    const int ty = p / T.w, tx = p - ty * T.w;
    const float v = silu<false>(bias_add<false>(acc2[(ty * tw + tx) * ld2 + o], __ldg(a.b2 + o)));
    out[((size_t(g.b) * H + g.y0 + ty) * W + g.x0 + tx) * c2o + o] = v;
  }
}

// ---------------------------------------------------------------- host ----

using Kernel = void (*)(C2fArgs);

// which instantiation serves an instance, and the rows of its warp item; `general` is the one that also runs N
// chunks and split passes (SPLIT), which only plans that fit no other tile take
struct Variant {
  Kernel kern;
  int mt, nt;  // bf16: item = 16 mt pixels x 8 nt channels; f32: nt = output channels per thread
  int threads;
};
Variant variant_of(int c, bool bf16, bool general = false) {
  if (!bf16) {
    if (general) return c % 8 ? Variant{c2f_f32_kernel<4, true>, 0, 4, kThreads} : Variant{c2f_f32_kernel<8, true>, 0, 8, kThreads};
    return c % 8 ? Variant{c2f_f32_kernel<4>, 0, 4, kThreads} : Variant{c2f_f32_kernel<8>, 0, 8, kThreads};
  }
  if (general) return {c2f_mma_kernel<2, 6, 0, kMmaWarps, true>, 2, 6, 32 * kMmaWarps};
  switch (pad16(c)) {
    case 16: return {c2f_mma_kernel<4, 2, 1, kMmaWarps>, 4, 2, 32 * kMmaWarps};
    case 32: return {c2f_mma_kernel<2, 4, 2, kMmaWarps>, 2, 4, 32 * kMmaWarps};
    case 48: return {c2f_mma_kernel<2, 6, 3, kMmaWarps>, 2, 6, 32 * kMmaWarps};
    case 96: return {c2f_mma_kernel<2, 6, 6, kMmaWarps>, 2, 6, 32 * kMmaWarps};
    default: return {c2f_mma_kernel<2, 6, 0, kMmaWarps>, 2, 6, 32 * kMmaWarps};
  }
}

// One launch of an instance: mode kWhole (the whole block), kHead (the chain passes of a split plan, nb bottlenecks
// each: the time of all of them, the shared bytes of the largest) or kTail (its last launch, cv2 over the concat);
// its tile, slices per ring step and N chunk (bf16), and what the plan works out for it.
struct Launch {
  int mode = kWhole, th = 0, tw = 0, grp = 0, np = 0, nb = 0;
  int blocks = 0, per_sm = 0;
  size_t smem = 0;
};

struct Plan {
  Launch main;  // the whole block, or a split plan's chain passes
  Launch tail;  // a split plan's cv2 launch (mode kTail); unused otherwise
  bool split() const { return main.mode == kHead; }  // the general instantiation's plan
};

// registers of a kernel and the card's SM count, asked once
cudaError_t kernel_facts(Kernel k, int* regs, int* sms) {
  static std::map<Kernel, int> seen;
  static int n_sm = 0;
  auto it = seen.find(k);
  if (it == seen.end()) {
    cudaFuncAttributes fa;
    cudaError_t e = cudaFuncGetAttributes(&fa, k);
    int dev = 0;
    if (e == cudaSuccess) e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    it = seen.emplace(k, fa.numRegs).first;
  }
  *regs = it->second;
  *sms = n_sm;
  return cudaSuccess;
}

// The plan's cost model, in units of one warp-level mma. `barrier` is what a ring step costs beside
// its products (its block barrier, copy wait and copy issue): without it a single frame takes tiles so
// small that steps outweigh products. `shared` is the time of a wave of two blocks to an SM over that of
// a wave of one (only f32 blocks are small enough to share): two blocks hide each other's latencies, but
// they share the SM's fmaf rate. Both are set from chip_smoke.py --profile's sweep, which times the
// candidates on the card and shows the choice with either constant at its neutral value (0 and 1).
struct Model {
  double barrier = 12.0, shared = 1.3;
};

// the refusals of the C entries, apart from CUDA's error codes (which are positive)
constexpr int kNotTaken = -1, kNoTileFits = -2;

struct Instance {
  int B, H, W, c1, c, c2o, n;
  bool bf16;
};

// Whether launch `L` of an instance fits, and its modelled time. A stage costs its rounds of warp items (bf16:
// tensor-core steps per item plus a barrier per ring step, once per N chunk; f32: fmaf per thread); a block costs
// its stages on the worst-placed (interior) tile; the launch costs the waves of blocks over the SMs.
bool launch_cost(const Instance& s, const Variant& v, int regs, int sms, const Model& m, Launch* L, double* cost) {
  const int H = s.H, W = s.W, n = s.n, c = s.c, th = L->th, tw = L->tw;
  if (th < 1 || tw < 1 || th > H || tw > W) return false;
  if (s.bf16 && L->grp < 1) return false;
  const int kp = pad16(c), nk1 = cdiv(s.c1, kp), warps = v.threads / 32;
  const int np = s.bf16 ? L->np : kp, R = pass_halo(L->mode, n, L->nb);
  size_t map_halves = 0;
  if (s.bf16) {
    const MmaLayout l = mma_layout(H, W, th, tw, R, L->mode == kWhole ? 1 + n : 0, c, kRing * L->grp, np);
    L->smem = l.total, map_halves = l.map / 2;
  } else {
    L->grp = 0;
    L->smem = f32_smem(H, W, th, tw, R, c, s.c2o, L->mode);
  }
  if (L->smem > kMaxSmem) return false;
  // px pixels through nsl slices (bf16) or a K of nsl * c (f32), N output channels
  auto stage = [&](int px, int nsl, int N, bool staged = false) {
    if (s.bf16) {
      const int nchunks = cdiv(np, 8 * v.nt), mt = item_mtiles(px, nchunks, v.mt, warps);
      const int items = cdiv(px, 16 * mt) * nchunks;
      const int grp = staged ? cv1_group(int(map_halves), kp, imin(L->grp, nsl), round_px(px, np, v.mt, v.nt, warps)) : L->grp;
      return cdiv(items, warps) * (nsl * (kp / 16 * mt * v.nt) + cdiv(nsl, grp) * m.barrier);
    }
    return cdiv(px * (N / v.nt), kThreads) * double(nsl) * c * v.nt;
  };
  auto rect_px = [&](int halo) { return imin(th + 2 * halo, H) * imin(tw + 2 * halo, W); };
  const int nq = s.bf16 ? cdiv(c, np) : 1, nq2 = s.bf16 ? cdiv(kp, np) : 1;  // N chunks of a conv, of a cv2 chunk
  double t = 0.0;
  if (L->mode == kTail) {
    t = s.bf16 ? cdiv(s.c2o, kp) * nq2 * stage(th * tw, 2 + n, kp, true) : (2 + n) * stage(th * tw, 1, s.c2o);
  } else {
    if (s.bf16) {
      t += nq * (stage(rect_px(R), nk1, c, true) + stage(th * tw, nk1, c, true));
      if (L->mode == kWhole) t += cdiv(s.c2o, kp) * nq2 * stage(th * tw, 2 + n, c);
    } else {
      t += (stage(rect_px(R), 1, c) + stage(th * tw, 1, c)) * s.c1 / c;
      if (L->mode == kWhole) t += (2 + n) * stage(th * tw, 1, s.c2o);
    }
    if (L->mode == kWhole) {
      for (int k = 0; k < 2 * n; ++k) t += nq * stage(rect_px(R - 1 - k), 9, c);
    } else {  // every pass of the chain, the last one over the bottlenecks left
      for (int j0 = 0; j0 < n; j0 += L->nb) {
        const int Rp = 2 * imin(L->nb, n - j0);
        for (int k = 0; k < Rp; ++k) t += nq * stage(rect_px(Rp - 1 - k), 9, c);
      }
    }
  }
  const int by_regs = imax(1, 65536 / (imax(regs, 1) * v.threads));
  L->blocks = s.B * cdiv(H, th) * cdiv(W, tw);
  L->per_sm = imax(1, imin(2, imin(by_regs, int((kMaxSmem + 1024) / (L->smem + 1024)))));
  *cost = t * cdiv(L->blocks, sms * L->per_sm) * (L->per_sm == 2 && L->blocks > sms ? m.shared : 1.0);
  return true;
}

const int kTileRows[] = {0, 64, 32, 16, 8, 4, 2, 1};  // 0: the map's height
const int kGroups[] = {9, 3, 1};                      // bf16: weight slices per ring step

// the tile widths the plan weighs for a map W wide
template <class F>
void each_tile(const Instance& s, F f) {
  const int tws[] = {s.W, (s.W + 1) / 2, 64, 32, 16, 8, 4};
  for (int th : kTileRows) {
    for (int tw : tws) f(th ? th : s.H, tw);
  }
}

// every one-launch candidate the plan weighs first, in order (the first stays on a tie): f(launch, modelled time)
template <class F>
cudaError_t each_candidate(const Instance& s, const Model& m, F f) {
  const Variant v = variant_of(s.c, s.bf16);
  int regs = 0, sms = 0;
  cudaError_t e = kernel_facts(v.kern, &regs, &sms);
  if (e != cudaSuccess) return e;
  each_tile(s, [&](int th, int tw) {
    for (int grp : kGroups) {
      if (!s.bf16 && grp != kGroups[0]) break;
      Launch L;
      L.th = th, L.tw = tw, L.grp = grp, L.np = pad16(s.c);
      double cost = 0.0;
      if (launch_cost(s, v, regs, sms, m, &L, &cost)) f(L, cost);
    }
  });
  return cudaSuccess;
}

// The plan of an instance that no one-launch tile of whole slices fits: the general instantiation's split plan with
// the least modelled time over N chunks of np output channels (bf16) and passes of nb bottlenecks: the chain's passes
// and a cv2 launch, each with its own tile.
cudaError_t general_plan(const Instance& s, const Model& m, Plan* best, double* best_cost) {
  const Variant v = variant_of(s.c, s.bf16, true);
  int regs = 0, sms = 0;
  cudaError_t e = kernel_facts(v.kern, &regs, &sms);
  if (e != cudaSuccess) return e;
  const int kp = pad16(s.c);
  int nps[10], k = 0;
  nps[k++] = kp;
  if (s.bf16) {
    for (int np : {192, 160, 128, 96, 64, 48, 32, 16}) {
      if (np < kp) nps[k++] = np;
    }
  }
  // where the tile is an instance's least-cost one for launches of this mode (and nb)
  auto best_launch = [&](int mode, int nb, int np, Launch* out, double* out_cost) {
    *out_cost = -1.0;
    each_tile(s, [&](int th, int tw) {
      for (int grp : kGroups) {
        if (!s.bf16 && grp != kGroups[0]) break;
        Launch L;
        L.mode = mode, L.th = th, L.tw = tw, L.grp = grp, L.np = np, L.nb = nb;
        double cost = 0.0;
        if (launch_cost(s, v, regs, sms, m, &L, &cost) && (*out_cost < 0 || cost < *out_cost)) *out = L, *out_cost = cost;
      }
    });
  };
  Launch tail;
  double tail_cost = -1.0;
  for (int i = 0; i < k; ++i) {
    Launch L;
    double cost;
    best_launch(kTail, 0, nps[i], &L, &cost);
    if (cost >= 0 && (tail_cost < 0 || cost < tail_cost)) tail = L, tail_cost = cost;
  }
  *best_cost = -1.0;
  for (int i = 0; i < k; ++i) {
    for (int nb = s.n; nb >= 1 && tail_cost >= 0; --nb) {
      Launch L;
      double cost;
      best_launch(kHead, nb, nps[i], &L, &cost);
      if (cost >= 0 && (*best_cost < 0 || cost + tail_cost < *best_cost)) best->main = L, best->tail = tail, *best_cost = cost + tail_cost;
    }
  }
  return cudaSuccess;
}

// the plan of an instance: the one-launch candidate with the least modelled time, else the general plan
int plan_for(const Instance& s, Plan* best) {
  static std::map<std::tuple<int, int, int, int, int, int, int, bool>, Plan> cache;
  static std::mutex mu;
  std::lock_guard<std::mutex> lock(mu);
  const auto key = std::make_tuple(s.B, s.H, s.W, s.c1, s.c, s.c2o, s.n, s.bf16);
  auto hit = cache.find(key);
  if (hit != cache.end()) {
    *best = hit->second;
    return 0;
  }
  double best_cost = -1.0;
  Plan p;
  cudaError_t e = each_candidate(s, Model{}, [&](const Launch& L, double cost) {
    if (best_cost < 0 || cost < best_cost) best_cost = cost, p.main = L;
  });
  if (e != cudaSuccess) return int(e);
  if (best_cost < 0) {
    e = general_plan(s, Model{}, &p, &best_cost);
    if (e != cudaSuccess) return int(e);
  }
  if (best_cost < 0) return kNoTileFits;
  cache[key] = *best = p;
  return 0;
}

bool takes(int c1, int cs, int c, int c2o, int n, int H, int W, bool bf16) {
  if (n < 1 || c % 4 || (cs && (H % 2 || W % 2))) return false;
  return bf16 ? (c1 % 8 == 0 && cs % 8 == 0 && c2o % 2 == 0) : c2o % 8 == 0;
}

// the shared bytes of a launch of a split plan's pass over nb bottlenecks (the last pass may have fewer than
// the plan's), or of its cv2 launch
size_t pass_smem(const Instance& s, const Launch& L, int nb) {
  const int R = pass_halo(L.mode, s.n, nb);
  return s.bf16 ? mma_layout(s.H, s.W, L.th, L.tw, R, 0, s.c, kRing * L.grp, L.np).total
                : f32_smem(s.H, s.W, L.th, L.tw, R, s.c, s.c2o, L.mode);
}

#ifdef YT_C2F_TRACE
long long* g_trace = nullptr;
#endif

}  // namespace

extern "C" {

// Every entry returns 0, a CUDA error code (positive), -1 for an instance the kernel does not take
// or -2 where no tile of it fits the shared memory.

// what the kernel does with an instance: out = {tile rows, tile columns, blocks, blocks an SM holds,
// shared bytes per block, steps of the weight ring and slices per step (0 in f32), pixels per warp item (0 in f32),
// output channels of a ring slice (the N chunk; pad16(c) without chunks), launches (1, or the passes of a split plan
// and its cv2 launch), bottlenecks per pass (0: one launch), the cv2 launch's tile rows, tile columns, N chunk and
// slices per ring step, and the elements of the concat buffer the caller gives a split plan (0: none)}
int yt_c2f_plan(int B, int H, int W, int c1, int cs, int c, int c2o, int n, int bf16, long long* out) {
  if (!takes(c1, cs, c, c2o, n, H, W, bf16 != 0)) return kNotTaken;
  Plan p;
  const int e = plan_for(Instance{B, H, W, c1, c, c2o, n, bf16 != 0}, &p);
  if (e) return e;
  const Launch& L = p.main;
  const bool sp = p.split();
  const long long vals[] = {L.th, L.tw, L.blocks, L.per_sm, (long long)L.smem, bf16 ? kRing : 0, L.grp,
                            16 * variant_of(c, bf16 != 0, sp).mt, bf16 ? L.np : 0, sp ? cdiv(n, L.nb) + 1 : 1,
                            sp ? L.nb : 0, sp ? p.tail.th : 0, sp ? p.tail.tw : 0, sp && bf16 ? p.tail.np : 0,
                            sp ? p.tail.grp : 0, sp ? (long long)B * H * W * cat_ld(c, n) : 0};
  for (int i = 0; i < 16; ++i) out[i] = vals[i];
  return 0;
}

// The one-launch candidates the plan weighs first for an instance, in its order: plans[i] = {tile rows, tile
// columns, slices per ring step, blocks, blocks an SM holds, shared bytes}, costs[i] = the modelled time; at
// most `room` of them, *count = how many there are (none where the instance needs the general plan). `model` =
// {barrier, shared}, where it is not null, replaces the built-in constants (a NaN keeps the built-in one).
int yt_c2f_candidates(int B, int H, int W, int c1, int cs, int c, int c2o, int n, int bf16, const double* model,
                      int room, long long* plans, double* costs, int* count) {
  if (!takes(c1, cs, c, c2o, n, H, W, bf16 != 0)) return kNotTaken;
  Model m;
  if (model && model[0] == model[0]) m.barrier = model[0];
  if (model && model[1] == model[1]) m.shared = model[1];
  int k = 0;
  cudaError_t e = each_candidate(Instance{B, H, W, c1, c, c2o, n, bf16 != 0}, m, [&](const Launch& L, double cost) {
    if (k < room) {
      const long long vals[] = {L.th, L.tw, L.grp, L.blocks, L.per_sm, (long long)L.smem};
      for (int i = 0; i < 6; ++i) plans[k * 6 + i] = vals[i];
      costs[k] = cost;
    }
    ++k;
  });
  *count = k;
  return int(e);
}

#ifdef YT_C2F_TRACE
// the next launches write one interior block's cycle counts per stage to `trace` (kTraceStages x kTraceSlots, device memory)
int yt_c2f_set_trace(long long* trace) {
  g_trace = trace;
  return 0;
}
#endif

// th = 0 launches the instance's plan (a split plan needs `cat`, as many elements as yt_c2f_plan names, in the
// activations' dtype); th > 0 launches the one-launch tile and slices per ring step given (a measurement's way in)
int yt_c2f_forward(const void* x, const void* small, void* out, const float* w1, const float* b1, const float* wm,
                   const float* bm, const float* w2, const float* b2, const void* wp, void* cat, int B, int H, int W,
                   int c1, int cs, int c, int c2o, int n, int shortcut, int bf16, int th, int tw, int grp, void* stream) {
  if (!takes(c1, cs, c, c2o, n, H, W, bf16 != 0)) return kNotTaken;
  const Instance s{B, H, W, c1, c, c2o, n, bf16 != 0};
  Plan p;
  if (th > 0) {
    const Variant v1 = variant_of(c, bf16 != 0);
    int regs = 0, sms = 0;
    cudaError_t e = kernel_facts(v1.kern, &regs, &sms);
    if (e != cudaSuccess) return int(e);
    double cost = 0.0;
    p.main.th = th, p.main.tw = tw, p.main.grp = grp, p.main.np = pad16(c);
    if (!launch_cost(s, v1, regs, sms, Model{}, &p.main, &cost)) return kNoTileFits;
  } else {
    const int e = plan_for(s, &p);
    if (e) return e;
    if (p.split() && !cat) return kNotTaken;
  }
  const Variant v = variant_of(c, bf16 != 0, p.split());
  // one launch: `L` over nb bottlenecks from j0 (a split plan's pass), or the whole block
  auto launch = [&](const Launch& L, int j0, int nb, size_t smem) -> int {
    C2fArgs a{x,  small, out, w1, b1, wm, bm,       w2,   b2,   static_cast<const bf16_t*>(wp),
              B,  H,     W,   c1, cs, c,  c2o,      n,    shortcut,
              L.th, L.tw, L.grp};
    a.cat = cat, a.mode = L.mode, a.j0 = j0, a.nb = nb, a.np = L.np;
#ifdef YT_C2F_TRACE
    a.trace = g_trace;
    const int tiles_x = cdiv(W, L.tw), tiles_y = cdiv(H, L.th);
    a.trace_block = (B / 2) * tiles_x * tiles_y + (tiles_y / 2) * tiles_x + tiles_x / 2;
#endif
    // the limit is lifted to what this launch needs, not to the most a block may ask for: the card
    // sizes L1 by it, and the f32 kernel reads its weights through L1
    cudaError_t e = cudaFuncSetAttribute(v.kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return int(e);
    v.kern<<<B * cdiv(H, L.th) * cdiv(W, L.tw), v.threads, smem, static_cast<cudaStream_t>(stream)>>>(a);
    return int(cudaGetLastError());
  };
  if (!p.split()) return launch(p.main, 0, n, p.main.smem);
  for (int j0 = 0; j0 < n; j0 += p.main.nb) {
    Launch L = p.main;
    L.mode = j0 ? kMid : kHead;
    const int nb = imin(p.main.nb, n - j0);
    const int e = launch(L, j0, nb, pass_smem(s, L, nb));
    if (e) return e;
  }
  return launch(p.tail, 0, 0, pass_smem(s, p.tail, 0));
}

}  // extern "C"
