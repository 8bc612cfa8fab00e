// T2 and T4: the two column-buffer formulations of the 3x3 conv weight
// gradient with the shifted operand x,
//
//   dw[dy, dx, ci, co] = sum_{b,h,w} xpad[b, h+dy, w+dx, ci] * g[b, h, w, co]
//
// (xpad: x zero-padded by one pixel).  They replace two kernels of the
// wgrad-formulation sweep, tools/perf/microbench_wgrad_kernels.py:
//   T2 `wgrad_xcol`  (:128) x shifted per tap into a column buffer; one
//                           product x_col^T (9 cin, K) . g (K, cout): the
//                           taps along M
//   T4 `wgrad_gtcol` (:220) g^T (cout, K) once, one product against the x
//                           column buffer (K, 9 cin): the taps along N
// Inputs bfloat16 NHWC, output float32 (3, 3, Cin, Cout).  (T1 and T3 are
// in wgrad_variants.cu.)
//
// What bounds them on an H100: operations and bytes about equally.  At the
// sweep's shapes (2, 468, 468, 64->64) and (2, 468, 468, 128->64) a call is
// 32.3 and 64.6 GFLOP against 112 and 168 MB read: 0.033 and 0.065 ms at
// the bf16 tensor-core peak, 0.034 and 0.050 ms at 3.35 TB/s.  What bounds
// this design is the staging: the tile sweep (tools/perf/conv_tiles.py)
// finds a call ~30 % shorter without the loads, ~24 % without the column
// copy and ~10 % without the products.
//
// Design, after K2w (conv3x3_wgrad.cu).  A block owns one kernel row dy, 64
// input channels (its 192 columns: the three dx x 64 Cin) and 64 output
// channels, and one chunk of pixels, which it walks in steps of one image
// row segment of 64 pixels.  A step's stage holds x's row h + dy - 1 over
// pixels -1 .. 64 of the segment (66 x 64 channels, zeros off the map and
// past W) and g's row segment (64 x 64), as [pixel][channel] rows as they
// lie in memory, filled by 16-byte `cp.async` copies through a ring of
// kStages stages.  From the x row the block copies its column buffer (64
// pixels x 192 columns, column dx * 64 + c = x at pixel p + dx, channel c)
// in shared memory, and multiplies it with g.  The column buffer is double:
// step t + 1's is copied while step t's is multiplied, so a step needs one
// barrier.  The three dy blocks that read one x row share it through L2.
// Channel counts that are no multiple of 8, or pointers off 16 bytes, take
// a slower branch with element loads.
//
// T2 (`xcol_kernel`, 8 warps): A = the column buffer, B = g, fragments read
// with `ldmatrix.trans` (the contraction runs over pixels, the slow axis of
// both) into warp-level `mma.sync.m16n8k16` (bf16 in, f32 accumulators):
// K2w's machinery, so T2 against K2w prices the column buffer.
// T4 (`gtcol_kernel`, 3 warpgroups, one a dx): `wgmma.m64n64k16` with A =
// g^T (64 Cout x 16 pixels) and B = the dx's block of the column buffer (16
// pixels x 64 Cin), both read by the tensor cores from shared memory in the
// 128-byte swizzled layout, M- and N-major (the transpose bits bf16 allows):
// g's row segment and each column block are [pixel][64 channels] rows of
// 128 bytes, 16-byte group j of pixel p at slot j ^ (p % 8).  A step's
// products run while the next step's column buffer is copied.  T4 on
// `mma.sync` (T2's machinery, taps along N) took 0.03-2 % longer in turns
// and was deleted.
//
// Chunks and th.  The TPU kernels' grid steps are row tiles of th image
// rows of one sample; here th keeps that meaning for the chunks: a chunk
// is `tiles_per_chunk` consecutive row tiles (the last of a sample may be
// shorter than th; a chunk may run into the next sample) by a run of
// `segs_per_chunk` row segments, so its boundaries fall on multiples of th
// rows.  The wrapper sizes the two (ops/wgrad_variants.py `xcol_gtcol_plan`)
// so that the grid is at most one wave of the blocks the card holds at once
// (`t2_resident_blocks`, `t4_resident_blocks`), splitting a row tile along W
// where the row tiles alone are too few or too coarse for that.  Each block
// writes an f32 partial for its chunk and a second pass adds the chunks'
// partials in a fixed order: no float atomics, the same result on every
// run.  Each partial is in its variant's orientation, (9 Cin, Cout) for T2
// and (Cout, 9 Cin) for T4; the second pass reshapes to (3, 3, Cin, Cout).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using hopper::bf16;

constexpr int kSeg = 64;            // pixels a step: one row segment
constexpr int kHaloPix = kSeg + 2;  // x pixels of a row a step
constexpr int kCi = 64;             // input channels a block: a 128-byte row in T4's layout
constexpr int kCo = 64;             // output channels a block: T4's M
constexpr int kCols = 3 * kCi;      // the column buffer's columns: dx * kCi + c
constexpr int kStages = 3;
constexpr int kXStride = kCi + 8;   // bf16 a staged x pixel: 8 pixels fall on 8 bank groups
constexpr int kXElems = kHaloPix * kXStride;
static_assert(kStages >= 3, "step t waits for stage t + 1 while stage t + 2 is in flight");
static_assert(kCi == 64 && kCo == 64, "T4: one 128-byte swizzled row a pixel");

// T2: [kStages][x row | g row segment], then [2][kSeg][kColStride]
constexpr int kXcolThreads = 256;   // 8 warps
constexpr int kXcolWarpsM = 4;      // along M (the 192 columns)
constexpr int kGStride = kCo + 8;   // padded rows, as for x
constexpr int kColStride = kCols + 8;
constexpr int kXcolStageElems = kXElems + kSeg * kGStride;
constexpr int kColElems = kSeg * kColStride;
constexpr size_t kXcolSmem = sizeof(bf16) * (kStages * kXcolStageElems + 2 * kColElems);
constexpr int kXcolWarpsN = kXcolThreads / 32 / kXcolWarpsM;
constexpr int kWM = kCols / kXcolWarpsM, kWN = kCo / kXcolWarpsN;  // a warp's tile
constexpr int kMT = kWM / 16, kNT = kWN / 8;                        // its m16 and n8 tiles
static_assert(kWM % 16 == 0 && kWN % 16 == 0, "warp tiling; B fragments load two n8 tiles");
static_assert(kXElems % 8 == 0 && kXcolStageElems % 8 == 0 && kColElems % 8 == 0,
              "16-byte aligned stage parts");

// T4: [kStages][g row segment (swizzled) | x row], then [2][3 dx][block], 1024-byte aligned
constexpr int kGtcolThreads = 384;      // 3 warpgroups
constexpr int kBlockElems = kSeg * 64;  // a swizzled [64 pixels][64 channels] block, 8 KB
constexpr int kGtcolStageBytes = (kBlockElems * 2 + kXElems * 2 + 1023) / 1024 * 1024;
constexpr size_t kGtcolSmem = kStages * kGtcolStageBytes + 2 * 3 * kBlockElems * 2 + 1024;

enum { kXcol = 2, kGtcol = 4 };

struct Args {
  const bf16* x;  // (B, H, W, Cin)
  const bf16* g;  // (B, H, W, Cout)
  float* part;    // (chunks, 9 * Cin * Cout), each in the variant's orientation
  int H, W, Cin, Cout, th, segs, sample_tiles, row_tiles, ci_tiles, co_tiles, tiles_per_chunk,
      segs_per_chunk, pieces;
};

// This block's tile (dy, its first input and output channel) and chunk:
// image rows r0 .. r0 + T / nseg - 1 of the B * H, row segments s0 .. s0 +
// nseg - 1, walked row by row in T steps.
struct Work {
  int dy, ci0, co0, r0, s0, nseg, T;
  __device__ explicit Work(const Args& a) {
    co0 = blockIdx.x % a.co_tiles * kCo;
    ci0 = blockIdx.x / a.co_tiles % a.ci_tiles * kCi;
    dy = blockIdx.x / (a.co_tiles * a.ci_tiles);
    const int rt0 = blockIdx.y / a.pieces * a.tiles_per_chunk;
    const int rt1 = min(rt0 + a.tiles_per_chunk, a.row_tiles);
    r0 = rt0 / a.sample_tiles * a.H + rt0 % a.sample_tiles * a.th;
    const int r1 = rt1 / a.sample_tiles * a.H + rt1 % a.sample_tiles * a.th;
    s0 = blockIdx.y % a.pieces * a.segs_per_chunk;
    nseg = min(a.segs_per_chunk, a.segs - s0);
    T = (r1 - r0) * nseg;
  }

  // Step t's x row into xs and g's row segment into gs (kSwizzleG: wgmma's
  // swizzled rows, else rows of kGStride), by a block of kN threads; one
  // cp.async group, empty past the chunk's end.
  template <int kN, bool kVec, bool kSwizzleG>
  __device__ __forceinline__ void stage(const Args& a, int t, bf16* xs, bf16* gs) const {
    if (t < T) {
      const int row = r0 + t / nseg, seg = s0 + t % nseg;
      const int b = row / a.H, h = row - b * a.H;
      hopper::stage_row<kN, kVec>(xs, kXStride, kCi / 8, a.x + (size_t)b * a.H * a.W * a.Cin,
                                  a.x, h + dy - 1, seg * kSeg - 1, kHaloPix, ci0, a.Cin, a.H,
                                  a.W);
      hopper::stage_row<kN, kVec, kSwizzleG>(gs, kSwizzleG ? kCo : kGStride, kCo / 8,
                                             a.g + (size_t)b * a.H * a.W * a.Cout, a.g, h,
                                             seg * kSeg, kSeg, co0, a.Cout, a.H, a.W);
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
  const Work wk(a);
  const int T = wk.T;
  auto fetch = [&](int t) {
    bf16* st = ring + (t % kStages) * kXcolStageElems;
    wk.stage<kXcolThreads, kVec, false>(a, t, st, st + kXElems);
  };
  // step t's column buffer from its x row: column dx * kCi + c of pixel p
  // is the x row's pixel p + dx, channel c
  auto build_col = [&](int t) {
    if (t >= T) return;
    const bf16* xs = ring + (t % kStages) * kXcolStageElems;
    bf16* col = cols + (t & 1) * kColElems;
#pragma unroll
    for (int i = threadIdx.x; i < kSeg * 3 * (kCi / 8); i += kXcolThreads) {
      const int grp = i % (kCi / 8), dx = i / (kCi / 8) % 3, p = i / (3 * (kCi / 8));
      *reinterpret_cast<uint4*>(col + p * kColStride + dx * kCi + grp * 8) =
          *reinterpret_cast<const uint4*>(xs + (p + dx) * kXStride + grp * 8);
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
    const bf16* gs = ring + (t % kStages) * kXcolStageElems + kXElems;
#pragma unroll
    for (int kk = 0; kk < kSeg; kk += 16) {
      uint32_t af[kMT][4], bfr[kNT / 2][4];
#pragma unroll
      for (int i = 0; i < kMT; ++i)
        hopper::ldmatrix_x4_trans(af[i], col + (kk + a_k) * kColStride + a_m + i * 16);
#pragma unroll
      for (int j = 0; j < kNT / 2; ++j)
        hopper::ldmatrix_x4_trans(bfr[j], gs + (kk + b_k) * kGStride + b_n + j * 16);
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
  float* out = a.part + (size_t)blockIdx.y * 9 * a.Cin * a.Cout;
  const int gid = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = wm + i * 16 + gid + (e >> 1) * 8;  // the column: dx * kCi + channel
        const int tap = wk.dy * 3 + m / kCi, ci = wk.ci0 + m % kCi;
        const int co = wk.co0 + wn + j * 8 + t4 * 2 + (e & 1);
        if (ci < a.Cin && co < a.Cout)
          out[((size_t)tap * a.Cin + ci) * a.Cout + co] = acc[i][j][e];
      }
}

// ---- T4 ----

// wgmma's shared-memory descriptor of a swizzled [pixel][64] block: start
// address, 8-row groups 1024 bytes apart along K (SBO), one 64-wide block
// along M or N (LBO unused), 128-byte swizzle.
__device__ __forceinline__ uint64_t wg_desc(const bf16* p) {
  return ((hopper::smem_addr(p) & 0x3FFFF) >> 4) | (1ull << 16) | ((1024ull >> 4) << 32) |
         (1ull << 62);
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

template <bool kVec>
__global__ void __launch_bounds__(kGtcolThreads, 2) gtcol_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (hopper::smem_addr(smem_raw) & 1023)) & 1023);
  auto stage_g = [&](int t) {
    return reinterpret_cast<bf16*>(base + (t % kStages) * kGtcolStageBytes);
  };
  bf16* cols = reinterpret_cast<bf16*>(base + kStages * kGtcolStageBytes);
  const Work wk(a);
  const int T = wk.T;
  auto load = [&](int t) {
    wk.stage<kGtcolThreads, kVec, true>(a, t, stage_g(t) + kBlockElems, stage_g(t));
  };
  // step t's three column blocks, swizzled: block dx, pixel p is the x
  // row's pixel p + dx
  auto build_cols = [&](int t) {
    if (t >= T) return;
    const bf16* xs = stage_g(t) + kBlockElems;
    bf16* col = cols + (t & 1) * 3 * kBlockElems;
#pragma unroll
    for (int i = threadIdx.x; i < kSeg * 3 * 8; i += kGtcolThreads) {
      const int grp = i % 8, dx = i / 8 % 3, p = i / 24;
      *reinterpret_cast<uint4*>(col + dx * kBlockElems + p * 64 + (grp ^ (p & 7)) * 8) =
          *reinterpret_cast<const uint4*>(xs + (p + dx) * kXStride + grp * 8);
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
    const bf16* gs = stage_g(t);
    const bf16* cs = cols + ((t & 1) * 3 + wg) * kBlockElems;
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < kSeg; kk += 16)
      wgmma_m64n64k16(acc, wg_desc(gs + kk * 64), wg_desc(cs + kk * 64));
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    build_cols(t + 1);
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    wg_fence_operands(acc);
  }
  hopper::cp_async_wait<0>();

  // this chunk's partial, (Cout, 9 Cin): row m = Cout, column n = Cin of tap dy * 3 + wg
  float* out = a.part + (size_t)blockIdx.y * 9 * a.Cin * a.Cout;
  const int lane = threadIdx.x & 31, wrow = threadIdx.x % 128 / 32 * 16;
  const int gid = lane >> 2, t4 = lane & 3, tap = wk.dy * 3 + wg;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int co = wk.co0 + wrow + gid + (e >> 1) * 8, ci = wk.ci0 + j * 8 + t4 * 2 + (e & 1);
      if (ci < a.Cin && co < a.Cout) out[((size_t)co * 9 + tap) * a.Cin + ci] = acc[j * 4 + e];
    }
}

// ---- both ----

// dw[tap, ci, co] = sum over chunks c = 0, 1, ... of part[c], in that
// order, read in the variant's orientation (coalesced over the partials).
template <int V>
__global__ void reduce_kernel(const float* __restrict__ part, float* __restrict__ dw,
                              int chunks, int Cin, int Cout) {
  const long long n = 9LL * Cin * Cout;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float sum = 0.f;
  for (int c = 0; c < chunks; ++c) sum += part[(size_t)c * n + i];
  if (V == kXcol) {
    dw[i] = sum;  // (9 Cin, Cout) is (3, 3, Cin, Cout)
  } else {
    const long long co = i / (9LL * Cin), w = i % (9LL * Cin);
    dw[w * Cout + co] = sum;
  }
}

// Variant V's partial kernel, its threads and its shared memory.
template <int V, bool kVec>
struct Kernel {
  static constexpr int kN = V == kXcol ? kXcolThreads : kGtcolThreads;
  static constexpr size_t kBytes = V == kXcol ? kXcolSmem : kGtcolSmem;
  static auto fn() {
    if constexpr (V == kXcol)
      return xcol_kernel<kVec>;
    else
      return gtcol_kernel<kVec>;
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
  Args a;
  a.x = static_cast<const bf16*>(x);
  a.g = static_cast<const bf16*>(g);
  a.part = static_cast<float*>(part);
  a.H = H, a.W = W, a.Cin = Cin, a.Cout = Cout, a.th = th;
  a.segs = (W + kSeg - 1) / kSeg;
  a.sample_tiles = (H + th - 1) / th;
  a.row_tiles = B * a.sample_tiles;
  a.ci_tiles = (Cin + kCi - 1) / kCi;
  a.co_tiles = (Cout + kCo - 1) / kCo;
  a.tiles_per_chunk = tiles_per_chunk;
  a.segs_per_chunk = segs_per_chunk;
  a.pieces = (a.segs + segs_per_chunk - 1) / segs_per_chunk;
  const long long chunks = (long long)((a.row_tiles - 1) / tiles_per_chunk + 1) * a.pieces;
  if (chunks > 65535) return (int)cudaErrorInvalidValue;
  const bool vec = Cin % 8 == 0 && Cout % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(g) % 16 == 0;
  const dim3 grid(3 * a.ci_tiles * a.co_tiles, (unsigned)chunks);
  cudaError_t err =
      vec ? launch_partial<V, true>(a, grid, st) : launch_partial<V, false>(a, grid, st);
  if (err != cudaSuccess) return (int)err;
  const long long n = 9LL * Cin * Cout;
  reduce_kernel<V><<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
      a.part, static_cast<float*>(dw), (int)chunks, Cin, Cout);
  return (int)cudaGetLastError();
}

}  // namespace

// Blocks of each kernel that the current device runs at once (the fewer of
// its two load branches), or -1 on an error.
extern "C" int t2_resident_blocks() { return resident_blocks<kXcol>(); }

extern "C" int t4_resident_blocks() { return resident_blocks<kGtcol>(); }

// x: (B, H, W, Cin), g: (B, H, W, Cout), bfloat16, contiguous; part:
// (chunks, 9 * Cin * Cout) f32 scratch, chunks = ceil(B * ceil(H / th) /
// tiles_per_chunk) * ceil(ceil(W / 64) / segs_per_chunk); dw: (3, 3, Cin,
// Cout) f32.  Each returns a cudaError_t.
extern "C" int t2_wgrad_xcol(const void* x, const void* g, void* part, void* dw, int B, int H,
                             int W, int Cin, int Cout, int th, int tiles_per_chunk,
                             int segs_per_chunk, void* stream) {
  return wgrad<kXcol>(x, g, part, dw, B, H, W, Cin, Cout, th, tiles_per_chunk, segs_per_chunk,
                      stream);
}

extern "C" int t4_wgrad_gtcol(const void* x, const void* g, void* part, void* dw, int B, int H,
                              int W, int Cin, int Cout, int th, int tiles_per_chunk,
                              int segs_per_chunk, void* stream) {
  return wgrad<kGtcol>(x, g, part, dw, B, H, W, Cin, Cout, th, tiles_per_chunk, segs_per_chunk,
                       stream);
}
