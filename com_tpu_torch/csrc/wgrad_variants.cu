// T1-T4: the four tensor-core formulations of the 3x3 conv weight gradient,
//
//   dw[dy, dx, ci, co] = sum_{b,h,w} xpad[b, h+dy, w+dx, ci] * g[b, h, w, co]
//
// (xpad: x zero-padded by one pixel), the function of K2w.  They replace the
// kernels of the wgrad-formulation sweep, tools/perf/microbench_wgrad_kernels.py:
//   T1 `wgrad_gcol`  (:84)  g shifted per tap into a column buffer; one
//                           product x^T (cin, K) . g_col (K, 9 cout)
//   T2 `wgrad_xcol`  (:128) x shifted per tap into a column buffer; one
//                           product x_col^T (9 cin, K) . g (K, cout): the
//                           taps along M
//   T3 `wgrad_gt9`   (:175) g^T (cout, K) once, nine products against
//                           views of one x halo tile at the taps' offsets
//   T4 `wgrad_gtcol` (:220) g^T (cout, K) once, one product against the x
//                           column buffer (K, 9 cin): the taps along N
// Inputs bfloat16 NHWC, output float32 (3, 3, Cin, Cout).
//
// What bounds them on an H100: operations and bytes about equally.  At the
// sweep's shapes (2, 468, 468, 64->64) and (2, 468, 468, 128->64) a call is
// 32.3 and 64.6 GFLOP against 112 and 168 MB read: 0.033 and 0.065 ms at
// the bf16 tensor-core peak, 0.034 and 0.050 ms at 3.35 TB/s.  What bounds
// this design is the staging: the tile sweep (tools/perf/conv_tiles.py)
// finds T1, T2 and T4 ~30-40 % shorter without the loads, ~24 % without
// the column copy and ~10 % without the products, and T3, which has no
// column copy, ~55-60 % shorter without its loads and ~18 % without its
// products.
//
// Design, after K2w (conv3x3_wgrad.cu).  Each variant reads one operand in
// place (g; x for T1) and shifts the other per tap (x; g for T1).  A block
// owns one kernel row dy, 64 channels of the shifted operand (its 192
// columns: the three dx x 64 channels), 64 channels of the operand read in
// place, and one chunk of pixels of the latter, which it walks in steps of
// one image row segment of 64 pixels.  A step's stage holds the shifted
// operand's halo row (x's row h + dy - 1, or g's row h + 1 - dy for T1)
// over pixels -1 .. 64 of the segment (66 x 64 channels, zeros off the map
// and past W) and the other operand's row segment (64 x 64), as
// [pixel][channel] rows as they lie in memory, filled by 16-byte `cp.async`
// copies through a ring of stages.  The three dy blocks that read one halo
// row share it through L2.  Channel counts that are no multiple of 8, or
// pointers off 16 bytes, take a slower branch with element loads.
//
// T2 (`xcol_kernel`, 8 warps) copies its column buffer (64 pixels x 192
// columns, column dx * 64 + c = x at halo pixel p + dx, channel c) from the
// halo row and multiplies it as A against g as B, fragments read with
// `ldmatrix.trans` (the contraction runs over pixels, the slow axis of
// both) into warp-level `mma.sync.m16n8k16` (bf16 in, f32 accumulators):
// K2w's machinery, so T2 against K2w prices the column buffer.
// T1 and T4 (`gtcol_kernel`, 3 warpgroups, one a dx): `wgmma.m64n64k16`
// with A = the in-place operand's row segment transposed (64 channels x 16
// pixels) and B = the dx's block of a column buffer (16 pixels x 64
// channels), both read by the tensor cores from shared memory in the
// 128-byte swizzled layout, M- and N-major (the transpose bits bf16
// allows): each is [pixel][64 channels] rows of 128 bytes, 16-byte group j
// of pixel p at slot j ^ (p % 8).  Column block dx, pixel p is the halo's
// pixel p + dx (T4) or p + 2 - dx (T1: g at w + 1 - dx, `gpad[2-dy:,
// 2-dx:]`).  The column buffer is double: a step's products run while the
// next step's buffer is copied, so a step needs one barrier.
// T3 (`gt9_kernel`, 3 warpgroups) has no column buffer: the halo row is
// staged swizzled too, and warpgroup dx's B is the view of it that starts
// at pixel row dx + kk, read in place by `wgmma`.  Such a view starts
// inside an 8-row swizzle atom; its descriptor's base-offset field is set
// by the PTX ISA's rule, from where the swizzle pattern starts (the stage's
// 1024-byte boundary).
//
// Chunks and th.  The TPU kernels' grid steps are row tiles of th image
// rows of one sample; here th keeps that meaning for the chunks: a chunk
// is `tiles_per_chunk` consecutive row tiles (the last of a sample may be
// shorter than th; a chunk may run into the next sample) by a run of
// `segs_per_chunk` row segments, so its boundaries fall on multiples of th
// rows.  The wrapper sizes the two (ops/wgrad_variants.py `xcol_gtcol_plan`)
// so that the grid is at most one wave of the blocks the card holds at once
// (`t1_resident_blocks` .. `t4_resident_blocks`), splitting a row tile
// along W where the row tiles alone are too few or too coarse for that.
// Each block writes an f32 partial for its chunk and a second pass adds the
// chunks' partials in a fixed order: no float atomics, the same result on
// every run.  Each partial is in its variant's orientation, the TPU's:
// (9 Cin, Cout) for T2, (Cin, 9 Cout) for T1, (Cout, 9 Cin) for T3 and T4;
// the second pass reshapes to (3, 3, Cin, Cout).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using hopper::bf16;

constexpr int kSeg = 64;               // pixels a step: one row segment
constexpr int kHaloPix = kSeg + 2;     // halo pixels of a row a step
constexpr int kCs = 64;                // shifted-operand channels a block: a 128-byte swizzled row
constexpr int kCp = 64;                // in-place operand channels a block: wgmma's M
constexpr int kCols = 3 * kCs;         // the column buffer's columns: dx * kCs + c
constexpr int kStages = 3;             // T1, T2, T4
constexpr int kGt9Stages = 3;          // T3
constexpr int kHaloStride = kCs + 8;   // bf16 a padded halo pixel: 8 pixels fall on 8 bank groups
constexpr int kHaloElems = kHaloPix * kHaloStride;
static_assert(kStages >= 3, "step t waits for stage t + 1 while stage t + 2 is in flight");
static_assert(kGt9Stages >= 2, "a stage in flight while one is multiplied");
static_assert(kCs == 64 && kCp == 64, "wgmma: one 128-byte swizzled row a pixel");

// T2: [kStages][halo row | row segment], then [2][kSeg][kColStride]
constexpr int kXcolThreads = 256;   // 8 warps
constexpr int kXcolWarpsM = 4;      // along M (the 192 columns)
constexpr int kRowStride = kCp + 8;  // padded rows, as for the halo
constexpr int kColStride = kCols + 8;
constexpr int kXcolStageElems = kHaloElems + kSeg * kRowStride;
constexpr int kColElems = kSeg * kColStride;
constexpr size_t kXcolSmem = sizeof(bf16) * (kStages * kXcolStageElems + 2 * kColElems);
constexpr int kXcolWarpsN = kXcolThreads / 32 / kXcolWarpsM;
constexpr int kWM = kCols / kXcolWarpsM, kWN = kCp / kXcolWarpsN;  // a warp's tile
constexpr int kMT = kWM / 16, kNT = kWN / 8;                        // its m16 and n8 tiles
static_assert(kWM % 16 == 0 && kWN % 16 == 0, "warp tiling; B fragments load two n8 tiles");
static_assert(kHaloElems % 8 == 0 && kXcolStageElems % 8 == 0 && kColElems % 8 == 0,
              "16-byte aligned stage parts");

// T1, T3, T4: 3 warpgroups; stages 1024-byte aligned.  T1 and T4:
// [kStages][row segment (swizzled) | halo row (padded)], then [2][3 dx][block];
// T3: [kGt9Stages][row segment | halo row, both swizzled]
constexpr int kWgThreads = 384;
constexpr int kBlockElems = kSeg * 64;  // a swizzled [64 pixels][64 channels] block, 8 KB
constexpr int kColStageBytes = (kBlockElems * 2 + kHaloElems * 2 + 1023) / 1024 * 1024;
constexpr size_t kGtcolSmem = kStages * kColStageBytes + 2 * 3 * kBlockElems * 2 + 1024;
constexpr int kGt9StageBytes = (kBlockElems * 2 + kHaloPix * 64 * 2 + 1023) / 1024 * 1024;
constexpr size_t kGt9Smem = kGt9Stages * kGt9StageBytes + 1024;

enum { kGcol = 1, kXcol = 2, kGt9 = 3, kGtcol = 4 };

struct Args {
  const bf16* plain;  // the operand read in place, (B, H, W, Cp): g; x for T1
  const bf16* shift;  // the operand shifted per tap, (B, H, W, Cs): x; g for T1
  float* part;        // (chunks, 9 * Cp * Cs), each in the variant's orientation
  int H, W, Cp, Cs, th, segs, sample_tiles, row_tiles, p_tiles, s_tiles, tiles_per_chunk,
      segs_per_chunk, pieces;
};

// This block's tile (dy, its first shifted and in-place channel) and chunk:
// image rows r0 .. r0 + T / nseg - 1 of the B * H, row segments s0 .. s0 +
// nseg - 1, walked row by row in T steps.  The halo row of image row h is
// h + drow: x's h + dy - 1, or g's h + 1 - dy (T1, `flip`).
struct Work {
  int dy, drow, cs0, cp0, r0, s0, nseg, T;
  __device__ Work(const Args& a, bool flip) {
    cp0 = blockIdx.x % a.p_tiles * kCp;
    cs0 = blockIdx.x / a.p_tiles % a.s_tiles * kCs;
    dy = blockIdx.x / (a.p_tiles * a.s_tiles);
    drow = flip ? 1 - dy : dy - 1;
    const int rt0 = blockIdx.y / a.pieces * a.tiles_per_chunk;
    const int rt1 = min(rt0 + a.tiles_per_chunk, a.row_tiles);
    r0 = rt0 / a.sample_tiles * a.H + rt0 % a.sample_tiles * a.th;
    const int r1 = rt1 / a.sample_tiles * a.H + rt1 % a.sample_tiles * a.th;
    s0 = blockIdx.y % a.pieces * a.segs_per_chunk;
    nseg = min(a.segs_per_chunk, a.segs - s0);
    T = (r1 - r0) * nseg;
  }

  // Step t's halo row into hs and the in-place operand's row segment into
  // ps (kSwizzleH / kSwizzleP: wgmma's swizzled rows, else padded rows), by
  // a block of kN threads; one cp.async group, empty past the chunk's end.
  template <int kN, bool kVec, bool kSwizzleH, bool kSwizzleP>
  __device__ __forceinline__ void stage(const Args& a, int t, bf16* hs, bf16* ps) const {
    if (t < T) {
      const int row = r0 + t / nseg, seg = s0 + t % nseg;
      const int b = row / a.H, h = row - b * a.H;
      hopper::stage_row<kN, kVec, kSwizzleH>(hs, kSwizzleH ? kCs : kHaloStride, kCs / 8,
                                             a.shift + (size_t)b * a.H * a.W * a.Cs, a.shift,
                                             h + drow, seg * kSeg - 1, kHaloPix, cs0, a.Cs, a.H,
                                             a.W);
      hopper::stage_row<kN, kVec, kSwizzleP>(ps, kSwizzleP ? kCp : kRowStride, kCp / 8,
                                             a.plain + (size_t)b * a.H * a.W * a.Cp, a.plain, h,
                                             seg * kSeg, kSeg, cp0, a.Cp, a.H, a.W);
    }
    hopper::cp_async_commit();
  }
};

// ---- T2 ----

template <bool kVec>
__global__ void __launch_bounds__(kXcolThreads, 2) xcol_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);
  bf16* cols = ring + kStages * kXcolStageElems;
  const Work wk(a, false);
  const int T = wk.T;
  auto fetch = [&](int t) {
    bf16* st = ring + (t % kStages) * kXcolStageElems;
    wk.stage<kXcolThreads, kVec, false, false>(a, t, st, st + kHaloElems);
  };
  // step t's column buffer from its x row: column dx * kCs + c of pixel p
  // is the x row's pixel p + dx, channel c
  auto build_col = [&](int t) {
    if (t >= T) return;
    const bf16* xs = ring + (t % kStages) * kXcolStageElems;
    bf16* col = cols + (t & 1) * kColElems;
#pragma unroll
    for (int i = threadIdx.x; i < kSeg * 3 * (kCs / 8); i += kXcolThreads) {
      const int grp = i % (kCs / 8), dx = i / (kCs / 8) % 3, p = i / (3 * (kCs / 8));
      *reinterpret_cast<uint4*>(col + p * kColStride + dx * kCs + grp * 8) =
          *reinterpret_cast<const uint4*>(xs + (p + dx) * kHaloStride + grp * 8);
    }
  };

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = (warp % kXcolWarpsM) * kWM, wn = (warp / kXcolWarpsM) * kWN;
  const int lrow = lane & 7, lmat = lane >> 3;
  // A (columns x pixels) from [pixel][column] storage: matrices (k, m),
  // (k, m+8), (k+8, m), (k+8, m+8)
  const int a_k = lrow + (lmat >> 1) * 8, a_m = wm + (lmat & 1) * 8;
  // B (pixels x Cout) from [pixel][channel] storage: matrices (k, n),
  // (k+8, n), (k, n+8), (k+8, n+8)
  const int b_k = lrow + (lmat & 1) * 8, b_n = wn + (lmat >> 1) * 8;

  float acc[kMT][kNT][4];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) fetch(s);
  hopper::cp_async_wait<kStages - 2>();  // stage 0 has landed (this thread's copies)
  __syncthreads();
  build_col(0);

  for (int t = 0; t < T; ++t) {
    hopper::cp_async_wait<kStages - 3>();  // stage t + 1 has landed (this thread's copies)
    __syncthreads();  // everyone's; column buffer t is built; stage t - 1 and buffer t - 1 are free
    fetch(t + kStages - 1);
    build_col(t + 1);
    const bf16* col = cols + (t & 1) * kColElems;
    const bf16* gs = ring + (t % kStages) * kXcolStageElems + kHaloElems;
#pragma unroll
    for (int kk = 0; kk < kSeg; kk += 16) {
      uint32_t af[kMT][4], bfr[kNT / 2][4];
#pragma unroll
      for (int i = 0; i < kMT; ++i)
        hopper::ldmatrix_x4_trans(af[i], col + (kk + a_k) * kColStride + a_m + i * 16);
#pragma unroll
      for (int j = 0; j < kNT / 2; ++j)
        hopper::ldmatrix_x4_trans(bfr[j], gs + (kk + b_k) * kRowStride + b_n + j * 16);
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int j = 0; j < kNT; ++j)
          hopper::mma_bf16(acc[i][j], af[i], bfr[j >> 1][(j & 1) * 2],
                           bfr[j >> 1][(j & 1) * 2 + 1]);
    }
  }
  hopper::cp_async_wait<0>();

  // this chunk's partial, (9 Cin, Cout)
  float* out = a.part + (size_t)blockIdx.y * 9 * a.Cs * a.Cp;
  const int gid = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = wm + i * 16 + gid + (e >> 1) * 8;  // the column: dx * kCs + channel
        const int tap = wk.dy * 3 + m / kCs, ci = wk.cs0 + m % kCs;
        const int co = wk.cp0 + wn + j * 8 + t4 * 2 + (e & 1);
        if (ci < a.Cs && co < a.Cp) out[((size_t)tap * a.Cs + ci) * a.Cp + co] = acc[i][j][e];
      }
}

// ---- T1, T3, T4: wgmma ----

// wgmma's shared-memory descriptor of a swizzled [pixel][64] block: start
// address, 8-row groups 1024 bytes apart along K (SBO), one 64-wide block
// along M or N (LBO unused), 128-byte swizzle.
__device__ __forceinline__ uint64_t wg_desc(const bf16* p) {
  return ((hopper::smem_addr(p) & 0x3FFFF) >> 4) | (1ull << 16) | ((1024ull >> 4) << 32) |
         (1ull << 62);
}

// The descriptor of a swizzled [pixel][64] block's rows from `row` on (the
// block 1024-byte aligned, its swizzle pattern starting there).  The start
// address lies inside an 8-row pattern where row % 8 != 0; the base-offset
// field (bits 49-51) is then (pattern start address >> 7) & 7, the PTX
// ISA's rule.
__device__ __forceinline__ uint64_t wg_desc_rows(const bf16* block, int row) {
  return wg_desc(block + row * 64) |
         (uint64_t)((hopper::smem_addr(block) >> 7) & 7) << 49;
}

// d (64 x 64 f32, a warpgroup's fragments) += A (desc a, M-major) * B (desc b, N-major)
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// keep the accumulators in place across the asynchronous products
__device__ __forceinline__ void wg_fence_operands(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The dynamic shared memory from its first 1024-byte boundary on.
__device__ __forceinline__ unsigned char* align_1024(unsigned char* smem) {
  return smem + ((1024 - (hopper::smem_addr(smem) & 1023)) & 1023);
}

// This chunk's partial, (Cp, 9 Cs): row m = the in-place channel, column n
// = the shifted channel of tap dy * 3 + wg.
__device__ __forceinline__ void store_wg_partial(const float (&acc)[32], const Args& a,
                                                 const Work& wk, int wg) {
  float* out = a.part + (size_t)blockIdx.y * 9 * a.Cp * a.Cs;
  const int lane = threadIdx.x & 31, wrow = threadIdx.x % 128 / 32 * 16;
  const int gid = lane >> 2, t4 = lane & 3, tap = wk.dy * 3 + wg;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int cp = wk.cp0 + wrow + gid + (e >> 1) * 8, cs = wk.cs0 + j * 8 + t4 * 2 + (e & 1);
      if (cp < a.Cp && cs < a.Cs) out[((size_t)cp * 9 + tap) * a.Cs + cs] = acc[j * 4 + e];
    }
}

// T1 (V = kGcol: A = x^T, B = g's column blocks) and T4 (V = kGtcol: A =
// g^T, B = x's column blocks).
template <int V, bool kVec>
__global__ void __launch_bounds__(kWgThreads, 2) gtcol_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base = align_1024(smem_raw);
  auto stage_p = [&](int t) {
    return reinterpret_cast<bf16*>(base + (t % kStages) * kColStageBytes);
  };
  bf16* cols = reinterpret_cast<bf16*>(base + kStages * kColStageBytes);
  const Work wk(a, V == kGcol);
  const int T = wk.T;
  auto load = [&](int t) {
    wk.stage<kWgThreads, kVec, false, true>(a, t, stage_p(t) + kBlockElems, stage_p(t));
  };
  // step t's three column blocks, swizzled: block dx, pixel p is the halo
  // row's pixel p + dx (T4) or p + 2 - dx (T1)
  auto build_cols = [&](int t) {
    if (t >= T) return;
    const bf16* hs = stage_p(t) + kBlockElems;
    bf16* col = cols + (t & 1) * 3 * kBlockElems;
#pragma unroll
    for (int i = threadIdx.x; i < kSeg * 3 * 8; i += kWgThreads) {
      const int grp = i % 8, dx = i / 8 % 3, p = i / 24;
      const int q = p + (V == kGcol ? 2 - dx : dx);
      *reinterpret_cast<uint4*>(col + dx * kBlockElems + p * 64 + (grp ^ (p & 7)) * 8) =
          *reinterpret_cast<const uint4*>(hs + q * kHaloStride + grp * 8);
    }
  };

  const int wg = threadIdx.x / 128;  // this warpgroup's dx
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) load(s);
  hopper::cp_async_wait<kStages - 2>();
  __syncthreads();
  build_cols(0);

  for (int t = 0; t < T; ++t) {
    hopper::cp_async_wait<kStages - 3>();
    // this thread's copies and column writes, visible to wgmma's (async) reads
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    load(t + kStages - 1);
    const bf16* ps = stage_p(t);
    const bf16* cs = cols + ((t & 1) * 3 + wg) * kBlockElems;
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < kSeg; kk += 16)
      wgmma_m64n64k16(acc, wg_desc(ps + kk * 64), wg_desc(cs + kk * 64));
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    build_cols(t + 1);
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    wg_fence_operands(acc);
  }
  hopper::cp_async_wait<0>();
  store_wg_partial(acc, a, wk, wg);
}

// T3: A = g^T, B = warpgroup dx's view of the swizzled x halo row, pixel
// rows dx .. dx + 63, read in place.
template <bool kVec>
__global__ void __launch_bounds__(kWgThreads, 2) gt9_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base = align_1024(smem_raw);
  auto stage_p = [&](int t) {
    return reinterpret_cast<bf16*>(base + (t % kGt9Stages) * kGt9StageBytes);
  };
  const Work wk(a, false);
  const int T = wk.T;
  auto load = [&](int t) {
    wk.stage<kWgThreads, kVec, true, true>(a, t, stage_p(t) + kBlockElems, stage_p(t));
  };

  const int wg = threadIdx.x / 128;  // this warpgroup's dx
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;

#pragma unroll
  for (int s = 0; s < kGt9Stages - 1; ++s) load(s);

  for (int t = 0; t < T; ++t) {
    hopper::cp_async_wait<kGt9Stages - 2>();  // stage t has landed (this thread's copies)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();  // everyone's; stage t - 1's products are done: its slot is free
    load(t + kGt9Stages - 1);
    const bf16* ps = stage_p(t);
    const bf16* hs = ps + kBlockElems;
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < kSeg; kk += 16)
      wgmma_m64n64k16(acc, wg_desc(ps + kk * 64), wg_desc_rows(hs, wg + kk));
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    wg_fence_operands(acc);
  }
  hopper::cp_async_wait<0>();
  store_wg_partial(acc, a, wk, wg);
}

// ---- all four ----

// dw[tap, ci, co] = sum over chunks c = 0, 1, ... of part[c], in that
// order, read in the variant's orientation (coalesced over the partials).
template <int V>
__global__ void reduce_kernel(const float* __restrict__ part, float* __restrict__ dw,
                              int chunks, int Cp, int Cs) {
  const long long n = 9LL * Cp * Cs;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float sum = 0.f;
  for (int c = 0; c < chunks; ++c) sum += part[(size_t)c * n + i];
  if (V == kXcol) {
    dw[i] = sum;  // (9 Cin, Cout) is (3, 3, Cin, Cout)
  } else {
    const long long p = i / (9LL * Cs), w = i % (9LL * Cs);  // w = tap * Cs + shifted channel
    if (V == kGcol)
      dw[(w / Cs * Cp + p) * Cs + w % Cs] = sum;  // (Cin, 9 Cout)
    else
      dw[w * Cp + p] = sum;  // (Cout, 9 Cin)
  }
}

// Variant V's partial kernel, its threads and its shared memory.
template <int V, bool kVec>
struct Kernel {
  static constexpr int kN = V == kXcol ? kXcolThreads : kWgThreads;
  static constexpr size_t kBytes = V == kXcol ? kXcolSmem : V == kGt9 ? kGt9Smem : kGtcolSmem;
  static auto fn() {
    if constexpr (V == kXcol)
      return xcol_kernel<kVec>;
    else if constexpr (V == kGt9)
      return gt9_kernel<kVec>;
    else
      return gtcol_kernel<V, kVec>;
  }
};

template <int V, bool kVec>
cudaError_t set_smem() {
  return cudaFuncSetAttribute(Kernel<V, kVec>::fn(), cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)Kernel<V, kVec>::kBytes);
}

template <int V, bool kVec>
cudaError_t occupancy(int* blocks) {
  typedef Kernel<V, kVec> K;
  cudaError_t err = set_smem<V, kVec>();
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, K::fn(), K::kN, K::kBytes);
}

template <int V>
int resident_blocks() {
  int dev = 0, sms = 0, a = 0, b = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      occupancy<V, true>(&a) != cudaSuccess || occupancy<V, false>(&b) != cudaSuccess)
    return -1;
  return sms * min(a, b);
}

template <int V, bool kVec>
cudaError_t launch_partial(const Args& a, dim3 grid, cudaStream_t st) {
  typedef Kernel<V, kVec> K;
  cudaError_t err = set_smem<V, kVec>();
  if (err != cudaSuccess) return err;
  auto kernel = K::fn();
  kernel<<<grid, K::kN, K::kBytes, st>>>(a);
  return cudaGetLastError();
}

template <int V>
int wgrad(const void* x, const void* g, void* part, void* dw, int B, int H, int W, int Cin,
          int Cout, int th, int tiles_per_chunk, int segs_per_chunk, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cout <= 0 || th <= 0 || tiles_per_chunk <= 0 ||
      segs_per_chunk <= 0 || (long long)B * H * W > INT32_MAX || tiles_per_chunk > B * H)
    return (int)cudaErrorInvalidValue;
  const bool flip = V == kGcol;  // T1 reads x in place and shifts g
  Args a;
  a.plain = static_cast<const bf16*>(flip ? x : g);
  a.shift = static_cast<const bf16*>(flip ? g : x);
  a.part = static_cast<float*>(part);
  a.H = H, a.W = W, a.th = th;
  a.Cp = flip ? Cin : Cout;
  a.Cs = flip ? Cout : Cin;
  a.segs = (W + kSeg - 1) / kSeg;
  a.sample_tiles = (H + th - 1) / th;
  a.row_tiles = B * a.sample_tiles;
  a.p_tiles = (a.Cp + kCp - 1) / kCp;
  a.s_tiles = (a.Cs + kCs - 1) / kCs;
  a.tiles_per_chunk = tiles_per_chunk;
  a.segs_per_chunk = segs_per_chunk;
  a.pieces = (a.segs + segs_per_chunk - 1) / segs_per_chunk;
  const long long chunks = (long long)((a.row_tiles - 1) / tiles_per_chunk + 1) * a.pieces;
  if (chunks > 65535) return (int)cudaErrorInvalidValue;
  const bool vec = Cin % 8 == 0 && Cout % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(g) % 16 == 0;
  const dim3 grid(3 * a.p_tiles * a.s_tiles, (unsigned)chunks);
  cudaError_t err =
      vec ? launch_partial<V, true>(a, grid, st) : launch_partial<V, false>(a, grid, st);
  if (err != cudaSuccess) return (int)err;
  const long long n = 9LL * Cin * Cout;
  reduce_kernel<V><<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
      a.part, static_cast<float*>(dw), (int)chunks, a.Cp, a.Cs);
  return (int)cudaGetLastError();
}

}  // namespace

// Blocks of each variant's partial kernel that the current device runs at
// once (the fewer of its two load branches), or -1 on an error.
extern "C" int t1_resident_blocks() { return resident_blocks<kGcol>(); }

extern "C" int t2_resident_blocks() { return resident_blocks<kXcol>(); }

extern "C" int t3_resident_blocks() { return resident_blocks<kGt9>(); }

extern "C" int t4_resident_blocks() { return resident_blocks<kGtcol>(); }

// x: (B, H, W, Cin), g: (B, H, W, Cout), bfloat16, contiguous; part:
// (chunks, 9 * Cin * Cout) f32 scratch, chunks = ceil(B * ceil(H / th) /
// tiles_per_chunk) * ceil(ceil(W / 64) / segs_per_chunk); dw: (3, 3, Cin,
// Cout) f32.  Each returns a cudaError_t.
extern "C" int t1_wgrad_gcol(const void* x, const void* g, void* part, void* dw, int B, int H,
                             int W, int Cin, int Cout, int th, int tiles_per_chunk,
                             int segs_per_chunk, void* stream) {
  return wgrad<kGcol>(x, g, part, dw, B, H, W, Cin, Cout, th, tiles_per_chunk, segs_per_chunk,
                      stream);
}

extern "C" int t2_wgrad_xcol(const void* x, const void* g, void* part, void* dw, int B, int H,
                             int W, int Cin, int Cout, int th, int tiles_per_chunk,
                             int segs_per_chunk, void* stream) {
  return wgrad<kXcol>(x, g, part, dw, B, H, W, Cin, Cout, th, tiles_per_chunk, segs_per_chunk,
                      stream);
}

extern "C" int t3_wgrad_gt9(const void* x, const void* g, void* part, void* dw, int B, int H,
                            int W, int Cin, int Cout, int th, int tiles_per_chunk,
                            int segs_per_chunk, void* stream) {
  return wgrad<kGt9>(x, g, part, dw, B, H, W, Cin, Cout, th, tiles_per_chunk, segs_per_chunk,
                     stream);
}

extern "C" int t4_wgrad_gtcol(const void* x, const void* g, void* part, void* dw, int B, int H,
                              int W, int Cin, int Cout, int th, int tiles_per_chunk,
                              int segs_per_chunk, void* stream) {
  return wgrad<kGtcol>(x, g, part, dw, B, H, W, Cin, Cout, th, tiles_per_chunk, segs_per_chunk,
                       stream);
}
