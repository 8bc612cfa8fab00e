// K2: 3x3 stride-1 SAME convolution, NHWC x HWIO -> NHWC.
//
// Replaces com_tpu/ops/pallas/conv2d.py `_conv3x3_fwd_pallas`
// (`_conv_kernel`): nine taps, products accumulated in f32, one rounding to
// the input's dtype (float32 or bfloat16) at the end.  The backward pass
// launches it too, for the input gradient: the output gradient convolved
// with the kernel rotated 180 degrees and its channel axes swapped
// (conv2d.py:544-553).
//
// What bounds it on an H100: operations.  At the backbone's shapes (2, 468,
// 468, 64->64), (2, 234, 234, 128->128) and (2, 117, 117, 256->256) each
// call is 32.3 GFLOP against 28-56 MB of traffic, far above the card's
// ratio of operations to bytes; at the bf16 tensor-core peak the bound is
// about 33 us a call, in f32 (three TF32 products an operation at 495
// TFLOP/s) about 196 us.
//
// bf16 (`k2_conv3x3_bf16`): an implicit GEMM on the tensor cores.  M is the
// output pixels of kTR = 8 image rows x one 64-pixel row segment, N a tile
// of 64 output channels, K the nine taps x Cin.  There is no im2col buffer:
// a stage holds the kTR + 2 halo rows of the segment (66 pixels each, zeros
// off the map) for kKc = 32 input channels, and the nine taps' A fragments
// are read with `ldmatrix` straight from it at each tap's (row, pixel)
// offset; B is the stage's 9 x 32 x 64 slice of the weights, read with
// `ldmatrix.trans` from its HWIO rows.  Each of 8 warps owns one output row
// (64 pixels) x all 64 channels (128 f32 accumulators a thread, so each
// fragment read from shared memory feeds 4 or 8 products) and runs
// `mma.sync.m16n8k16` (bf16 in, f32 accumulators).  The stages go through
// a ring of kStages = 2 buffers filled by `cp.async`: the next stage is in
// flight while one multiplies, with one barrier a stage.  The grid is
// persistent: one block an SM (the ring takes 184 KB of shared memory), each
// walking the work items (row step, segment, channel tile) blockIdx.x,
// blockIdx.x + gridDim.x, ... with the channel tile fastest, so the blocks
// that run together share halo rows and weights in L2; the ring runs on
// across items, so it never drains between them.  An item's accumulators
// are stored as bf16 after its last Cin chunk.  Ragged rows, segments
// (468 = 7 * 64 + 20), channels and Cout are zero-filled on load and masked
// on store.  Channel counts that are no multiple of 8, or pointers off 16
// bytes, take a slower branch with element loads and synchronous stores to
// shared memory.  The tile sweep (tools/perf/conv_tiles.py) times the call
// with the main loop's loads or its products taken out: each half alone
// takes most of the call, so neither the math nor the staging alone bounds
// it; the copies' address arithmetic (~19 `cp.async` a thread a stage)
// shares the instruction slots with the `ldmatrix`/`mma` stream.  TMA for the
// loads, then wgmma for the products, are the next step; wgmma needs B in
// its shared-memory descriptor layout (the weights re-laid out as (Cout, 3,
// 3, Cin) and staged as 8-row x 16-byte core matrices).
//
// f32 (`k2_conv3x3_f32`): an implicit GEMM in three TF32 passes on `wgmma`.
// TF32 keeps 10 of f32's 23 mantissa bits, so each operand is split once,
// v = hi + lo (`hopper::split_tf32`: hi rounded to TF32, lo the rest, which
// the tensor cores truncate), and each product runs as lo*hi + hi*lo +
// hi*hi, the small products first; that holds the result to about 2^-20 of
// sum |x||w|.  The tensor cores' f32 sums round toward zero (accumulated
// there over a whole Cin, positive sums come out low by more than the 1e-5
// gate: the tile sweep's `inacc`), so each stage's 27 products go into
// accumulators of their own,
// added to the f32 accumulators with round-to-nearest adds after the stage:
// the order is fixed, no atomics, the same bits on every run.  A work item
// is 64 * WG output pixels (R rows of S columns: the map's width cut into
// equal segments of at most 64, the count that needs the fewest items) x
// 64 output channels; a block is WG warpgroups, each issuing
// `wgmma.m64n64k8` on its 64 pixels: A (pixels x 8 input channels) from
// registers, loaded with `ldmatrix` from the halo at each tap's offset and
// split there; B from shared memory, the tap's 64 output channels x 8 input
// channels in the 32-byte swizzled K-major layout (the wrapper passes the
// weights as (3, 3, Cout, Cin)).  A stage holds the item's (R + 2) x (S + 2)
// halo pixels and the nine taps' B tiles for kFKc = 8 input channels,
// copied by `cp.async` (16 bytes, or 4 where Cin or a pointer is ragged)
// into a ring of kFStages = 2; each thread rounds the weights it copied to
// TF32 in place and writes their remainders to a second tile (double
// buffered), so a stage needs one barrier.  WG is 4 (one block an SM,
// twice the pixels a stage's weights serve) where those items fill the card
// kFWideItems = 3 times over, else 2 (two blocks an SM, twice the items on
// small maps: CaDDN's (2,47,35,256) has 128).  The tile sweep (noload,
// nomma, nosplit) finds the staging and the products each about a third of
// the call and the splits a tenth: B is read from shared memory by each of
// the three passes, and the stages' copies and splits share that memory
// with them.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using hopper::bf16;

// ---- bf16: implicit GEMM on the tensor cores ----

constexpr int kTR = 8;                 // output rows per work item, one per warp along M
constexpr int kSeg = 64;               // output pixels of a row segment
constexpr int kHaloPix = kSeg + 2;     // halo pixels of a row segment
constexpr int kKc = 32;                // input channels per stage
constexpr int kN = 64;                 // output channels per work item
constexpr int kXStride = kKc + 8;      // bf16 a halo pixel: 8 pixels fall on 8 bank groups
constexpr int kWStride = kN + 8;       // bf16 a weight row (144 bytes), likewise
constexpr int kHaloElems = (kTR + 2) * kHaloPix * kXStride;
constexpr int kWElems = 9 * kKc * kWStride;
constexpr int kStageElems = kHaloElems + kWElems;
constexpr int kStages = 2;
constexpr int kTcThreads = 256;        // 8 warps: kTR output rows x kWarpsN slices of kN
constexpr int kWarpsN = kTcThreads / 32 / kTR;
constexpr int kWN = kN / kWarpsN;      // output channels a warp
constexpr int kNT = kWN / 8;           // its n8 tiles
static_assert(kTcThreads / 32 % kTR == 0 && kNT % 2 == 0 && kKc % 16 == 0, "warp tiling");
constexpr size_t kTcSmem = sizeof(bf16) * kStages * kStageElems;
static_assert(kHaloElems % 8 == 0 && kStageElems % 8 == 0, "16-byte aligned stage parts");

struct TcArgs {
  const bf16* x;  // (B, H, W, Cin)
  const bf16* w;  // (3, 3, Cin, Cout)
  bf16* y;        // (B, H, W, Cout)
  int H, W, Cin, Cout;
  int segs, ntiles, rsteps, chunks, items;
};

struct Item {
  int b, h0, c0, co0;
};

// Work items run with the channel tile fastest, then the segment, the row
// step and the sample.
__device__ __forceinline__ Item item_at(const TcArgs& a, int item) {
  Item it;
  const int nt = item % a.ntiles;
  int q = item / a.ntiles;
  const int seg = q % a.segs;
  q /= a.segs;
  it.h0 = (q % a.rsteps) * kTR;
  it.b = q / a.rsteps;
  it.c0 = seg * kSeg;
  it.co0 = nt * kN;
  return it;
}

// One stage: the halo rows h0-1 .. h0+kTR of the segment (pixels c0-1 ..
// c0+64) for input channels ci0 .. ci0+31, and the weights of those
// channels for output channels co0 .. co0+63; zero wherever the map, Cin or
// Cout ends.
template <bool kVec>
__device__ __forceinline__ void load_stage(const TcArgs& a, const Item& it, int ci0,
                                           bf16* __restrict__ hs, bf16* __restrict__ ws) {
  const bf16* xb = a.x + (size_t)it.b * a.H * a.W * a.Cin;
  constexpr int kXGroups = kKc / 8;
  for (int i = threadIdx.x; i < (kTR + 2) * kHaloPix * kXGroups; i += kTcThreads) {
    const int grp = i % kXGroups, p = i / kXGroups;
    const int hp = p % kHaloPix, hr = p / kHaloPix;
    const int row = it.h0 - 1 + hr, col = it.c0 - 1 + hp, ci = ci0 + grp * 8;
    bf16* dst = hs + p * kXStride + grp * 8;
    const bool in = row >= 0 && row < a.H && col >= 0 && col < a.W && ci < a.Cin;
    const bf16* src = xb + ((size_t)row * a.W + col) * a.Cin + ci;
    if (kVec) {  // Cin is a multiple of 8: the group is all in or all out
      hopper::cp_async16(dst, in ? src : a.x, in);
    } else {
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      bf16* e = reinterpret_cast<bf16*>(&v);
      if (in) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (ci + j < a.Cin) e[j] = src[j];
      }
      *reinterpret_cast<uint4*>(dst) = v;
    }
  }
  constexpr int kWGroups = kN / 8;
  for (int i = threadIdx.x; i < 9 * kKc * kWGroups; i += kTcThreads) {
    const int grp = i % kWGroups, r = i / kWGroups;  // r = tap * kKc + k
    const int tap = r / kKc, ci = ci0 + r % kKc, co = it.co0 + grp * 8;
    bf16* dst = ws + r * kWStride + grp * 8;
    const bool in = ci < a.Cin && co < a.Cout;
    const bf16* src = a.w + ((size_t)tap * a.Cin + ci) * a.Cout + co;
    if (kVec) {  // Cout is a multiple of 8
      hopper::cp_async16(dst, in ? src : a.w, in);
    } else {
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      bf16* e = reinterpret_cast<bf16*>(&v);
      if (in) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (co + j < a.Cout) e[j] = src[j];
      }
      *reinterpret_cast<uint4*>(dst) = v;
    }
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kTcThreads, 1) conv3x3_tc_kernel(TcArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);

  const int my_items = (a.items - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  const int T = my_items * a.chunks;  // this block's stages: (item, Cin chunk), chunk fastest
  auto fetch = [&](int t) {
    if (t < T) {
      const Item it = item_at(a, blockIdx.x + (t / a.chunks) * gridDim.x);
      bf16* hs = ring + (t % kStages) * kStageElems;
      load_stage<kVec>(a, it, (t % a.chunks) * kKc, hs, hs + kHaloElems);
    }
    hopper::cp_async_commit();  // one group a stage, empty past the end
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) fetch(s);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wr = warp % kTR;         // this warp's output row in the item
  const int wn = (warp / kTR) * kWN; // and its first channel in the item's kN
  const int lrow = lane & 7, lmat = lane >> 3;  // the row and matrix this lane gives ldmatrix
  // A (pixels x channels, [m][k] storage): matrices (m, k), (m+8, k), (m, k+8), (m+8, k+8)
  const int a_m = lrow + (lmat & 1) * 8, a_k = (lmat >> 1) * 8;
  // B (channels x outputs, [k][n] storage): matrices (k, n), (k+8, n), (k, n+8), (k+8, n+8)
  const int b_k = lrow + (lmat & 1) * 8, b_n = wn + (lmat >> 1) * 8;

  float acc[4][kNT][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (int t = 0; t < T; ++t) {
    hopper::cp_async_wait<kStages - 2>();  // stage t has landed (this thread's copies)
    __syncthreads();                       // everyone's, and stage t-1 is free
    fetch(t + kStages - 1);
    const bf16* hs = ring + (t % kStages) * kStageElems;
    const bf16* ws = hs + kHaloElems;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
      const bf16* arow = hs + ((wr + dy) * kHaloPix + dx + a_m) * kXStride + a_k;
#pragma unroll
      for (int ks = 0; ks < kKc; ks += 16) {
        uint32_t af[4][4], bfr[kNT / 2][4];
#pragma unroll
        for (int i = 0; i < 4; ++i) hopper::ldmatrix_x4(af[i], arow + i * 16 * kXStride + ks);
#pragma unroll
        for (int j = 0; j < kNT / 2; ++j)
          hopper::ldmatrix_x4_trans(bfr[j], ws + (tap * kKc + ks + b_k) * kWStride + b_n + j * 16);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < kNT; ++j)
            hopper::mma_bf16(acc[i][j], af[i], bfr[j >> 1][(j & 1) * 2],
                             bfr[j >> 1][(j & 1) * 2 + 1]);
      }
    }

    if (t % a.chunks == a.chunks - 1) {  // the item's last Cin chunk: store and restart
      const Item it = item_at(a, blockIdx.x + (t / a.chunks) * gridDim.x);
      const int oh = it.h0 + wr;
      const int gid = lane >> 2, t4 = lane & 3;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kNT; ++j)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int ow = it.c0 + i * 16 + gid + half * 8;
            const int co = it.co0 + wn + j * 8 + t4 * 2;
            const float v0 = acc[i][j][half * 2], v1 = acc[i][j][half * 2 + 1];
            acc[i][j][half * 2] = acc[i][j][half * 2 + 1] = 0.f;
            if (oh >= a.H || ow >= a.W || co >= a.Cout) continue;
            bf16* yp = a.y + (((size_t)it.b * a.H + oh) * a.W + ow) * a.Cout + co;
            if (kVec) {  // Cout is even and co is even: both in, 4-byte aligned
              *reinterpret_cast<__nv_bfloat162*>(yp) = __floats2bfloat162_rn(v0, v1);
            } else {
              yp[0] = __float2bfloat16(v0);
              if (co + 1 < a.Cout) yp[1] = __float2bfloat16(v1);
            }
          }
    }
  }
  hopper::cp_async_wait<0>();
}

template <bool kVec>
cudaError_t launch_tc(const TcArgs& a, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(conv3x3_tc_kernel<kVec>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kTcSmem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  const int grid = a.items < sms ? a.items : sms;  // one block an SM, persistent
  conv3x3_tc_kernel<kVec><<<grid, kTcThreads, kTcSmem, st>>>(a);
  return cudaGetLastError();
}

// ---- f32: three-pass TF32 implicit GEMM on the tensor cores (wgmma) ----

constexpr int kFKc = 8;             // input channels a stage: one k8 step a tap (32-byte B rows)
constexpr int kFStages = 2;         // the cp.async ring
constexpr int kFABufs = 3;          // A fragment buffers: taps whose products are in flight
constexpr int kFWideItems = 3;      // 4 warpgroups a block from this many wide items an SM on
constexpr int kFN = 64;             // output channels an item: wgmma's N
constexpr int kFSeg = 64;           // the widest row segment
constexpr int kFXStride = kFKc + 4;  // floats a halo pixel: 8 pixels' 16-byte rows on 8 bank groups
constexpr int kFWTap = kFN * kFKc;  // floats of a tap's B tile (64 rows of 32 bytes)
constexpr int kFWElems = 9 * kFWTap;
static_assert(kFKc == 8, "a B row is one 32-byte swizzle row");
static_assert(kFWTap % 64 == 0, "256-byte aligned B tiles");

// The tiles of WG warpgroups a block, each owning 64 of an item's pixels:
// 2 (two blocks an SM) or 4 (one, sharing a stage's weights over twice the
// pixels).
template <int WG>
struct FTile {
  static constexpr int kThreads = 128 * WG;
  static constexpr int kMinBlocks = 4 / WG;  // blocks an SM
  static constexpr int kM = 64 * WG;         // output pixels an item
  static constexpr int kHaloCap = (kM / kFSeg + 2) * (kFSeg + 2) + 4;  // halo pixels a stage holds
  static constexpr int kHaloElems = (kHaloCap * kFXStride + 63) / 64 * 64;  // 256-byte multiple
  static constexpr int kStageElems = kHaloElems + kFWElems;
  // the ring, two stages' weight remainders, 256 bytes to align the base
  static constexpr size_t kSmem = sizeof(float) * (kFStages * kStageElems + 2 * kFWElems) + 256;
};

struct FArgs {
  const float* x;  // (B, H, W, Cin)
  const float* w;  // (3, 3, Cout, Cin): K-major, the wrapper's re-layout
  float* y;        // (B, H, W, Cout)
  int H, W, Cin, Cout;
  int S, R;        // an item's pixels: R rows of S columns
  int segs, ntiles, rsteps, chunks, items;
};

// Work items run with the channel tile fastest, then the segment, the row
// step and the sample, as the bf16 kernel's.
__device__ __forceinline__ Item f_item_at(const FArgs& a, int item) {
  Item it;
  const int nt = item % a.ntiles;
  int q = item / a.ntiles;
  const int seg = q % a.segs;
  q /= a.segs;
  it.h0 = (q % a.rsteps) * a.R;
  it.b = q / a.rsteps;
  it.c0 = seg * a.S;
  it.co0 = nt * kFN;
  return it;
}

// One stage: the item's halo, rows h0-1 .. h0+R x columns c0-1 .. c0+S, for
// input channels ci0 .. ci0+7 (kFXStride floats a pixel), and each tap's B
// tile: output channels co0 .. co0+63 as rows of those 8 input channels, in
// wgmma's 32-byte swizzled layout; zero wherever the map, Cin or Cout ends.
template <int WG, bool kVec>
__device__ __forceinline__ void f_load_stage(const FArgs& a, const Item& it, int ci0,
                                             float* __restrict__ hs, float* __restrict__ ws) {
  const float* xb = a.x + (size_t)it.b * a.H * a.W * a.Cin;
  const int hw = a.S + 2;
  for (int i = threadIdx.x; i < (a.R + 2) * hw * 2; i += FTile<WG>::kThreads) {
    const int grp = i & 1, p = i >> 1;
    const int row = it.h0 - 1 + p / hw, col = it.c0 - 1 + p % hw, c = ci0 + grp * 4;
    const bool pin = row >= 0 && row < a.H && col >= 0 && col < a.W;
    const float* src = xb + ((size_t)row * a.W + col) * a.Cin + c;
    float* dst = hs + p * kFXStride + grp * 4;
    if (kVec) {  // Cin is a multiple of 4: the group is all in or all out
      hopper::cp_async16(dst, pin && c < a.Cin ? src : a.x, pin && c < a.Cin);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        hopper::cp_async4(dst + j, pin && c + j < a.Cin ? src + j : a.x, pin && c + j < a.Cin);
    }
  }
  for (int i = threadIdx.x; i < 9 * kFN * 2; i += FTile<WG>::kThreads) {
    const int half = i & 1, r = i >> 1;  // r = tap * kFN + n
    const int tap = r / kFN, n = r % kFN;
    const int co = it.co0 + n, ci = ci0 + half * 4;
    float* dst = ws + tap * kFWTap + n * kFKc + ((half ^ ((n >> 2) & 1)) * 4);
    const float* src = a.w + ((size_t)tap * a.Cout + co) * a.Cin + ci;
    if (kVec) {
      const bool in = co < a.Cout && ci < a.Cin;
      hopper::cp_async16(dst, in ? src : a.w, in);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool in = co < a.Cout && ci + j < a.Cin;
        hopper::cp_async4(dst + j, in ? src + j : a.w, in);
      }
    }
  }
}

template <int WG, bool kVec>
__global__ void __launch_bounds__(FTile<WG>::kThreads, FTile<WG>::kMinBlocks)
    conv3x3_f32_kernel(FArgs a) {
  using Tile = FTile<WG>;
  extern __shared__ unsigned char smem_raw[];
  float* ring = reinterpret_cast<float*>(
      smem_raw + ((256 - (hopper::smem_addr(smem_raw) & 255)) & 255));
  float* lo_tiles = ring + kFStages * Tile::kStageElems;  // stage t's B remainders at t % 2

  const int my_items = (a.items - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  const int T = my_items * a.chunks;  // this block's stages: (item, Cin chunk), chunk fastest
  auto fetch = [&](int t) {
    if (t < T) {
      const Item it = f_item_at(a, blockIdx.x + (t / a.chunks) * gridDim.x);
      float* hs = ring + (t % kFStages) * Tile::kStageElems;
      f_load_stage<WG, kVec>(a, it, (t % a.chunks) * kFKc, hs, hs + Tile::kHaloElems);
    }
    hopper::cp_async_commit();  // one group a stage, empty past the end
  };
#pragma unroll
  for (int s = 0; s < kFStages - 1; ++s) fetch(s);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, t4 = lane & 3;
  const int hw = a.S + 2;
  // the halo row this lane gives `ldmatrix` (A's rows 0-7 / 8-15 of the
  // warp's 16, channels 0-3 / 4-7): its pixel at tap (0, 0); a pixel slot
  // past the item's R rows reads halo pixel 0 and is not stored
  const int wrow = 64 * (warp >> 2) + 16 * (warp & 3);  // the warp's first row of the item
  const int m = wrow + (lane & 7) + 8 * ((lane >> 3) & 1);
  const int a_off = (m / a.S < a.R ? (m / a.S * hw + m % a.S) * kFXStride : 0) + 4 * (lane >> 4);

  float acc[32], part[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = part[i] = 0.f;

  for (int t = 0; t < T; ++t) {
    hopper::cp_async_wait<kFStages - 2>();  // stage t has landed (this thread's copies)
    const float* hs = ring + (t % kFStages) * Tile::kStageElems;
    float* ws = ring + (t % kFStages) * Tile::kStageElems + Tile::kHaloElems;
    float* w_lo = lo_tiles + (t & 1) * kFWElems;  // last read by stage t - 2's products
    // B: each weight this thread copied rounded to TF32 in place, its
    // remainder to w_lo (the chunks of f_load_stage's loop)
    for (int i = threadIdx.x; i < 9 * kFN * 2; i += Tile::kThreads) {
      const int half = i & 1, r = i >> 1, n = r % kFN;
      const int off = r / kFN * kFWTap + n * kFKc + ((half ^ ((n >> 2) & 1)) * 4);
      const float4 v = *reinterpret_cast<const float4*>(ws + off);
      uint4 hi, lo;
      hopper::split_tf32(v.x, hi.x, lo.x);
      hopper::split_tf32(v.y, hi.y, lo.y);
      hopper::split_tf32(v.z, hi.z, lo.z);
      hopper::split_tf32(v.w, hi.w, lo.w);
      *reinterpret_cast<uint4*>(ws + off) = hi;
      *reinterpret_cast<uint4*>(w_lo + off) = lo;
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to wgmma's reads
    __syncthreads();  // everyone's stage t; stage t-1's products are done, its slot free
    fetch(t + kFStages - 1);
    const uint64_t d_hi = hopper::wg_desc_sw32(ws), d_lo = hopper::wg_desc_sw32(w_lo);
    uint32_t a_hi[kFABufs][4], a_lo[kFABufs][4];  // a tap's fragments stay until its products end
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int b = tap % kFABufs;
      if (tap >= kFABufs) hopper::wgmma_wait<kFABufs - 1>();  // tap - kFABufs's products are done
      uint32_t raw[4];
      hopper::ldmatrix_x4(raw, reinterpret_cast<const bf16*>(
                                   hs + a_off + ((tap / 3) * hw + tap % 3) * kFXStride));
#pragma unroll
      for (int e = 0; e < 4; ++e) hopper::split_tf32(__uint_as_float(raw[e]), a_hi[b][e], a_lo[b][e]);
      const uint64_t off = (uint64_t)(tap * kFWTap * 4) >> 4;  // the tap's B tile
      hopper::wgmma_fence();
      hopper::wgmma_3xtf32(part, a_hi[b], a_lo[b], d_hi + off, d_lo + off, tap > 0);
      hopper::wgmma_commit();
    }
    hopper::wgmma_wait<0>();
    hopper::fence_operands(part);
    // the stage's sums, rounded toward zero in the tensor cores, into the
    // f32 accumulators with round-to-nearest adds
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] += part[i];

    if (t % a.chunks == a.chunks - 1) {  // the item's last Cin chunk: store and restart
      const Item it = f_item_at(a, blockIdx.x + (t / a.chunks) * gridDim.x);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int mm = wrow + gid + 8 * half;
        const int r = mm / a.S, c = mm % a.S;
        const int oh = it.h0 + r, ow = it.c0 + c;
        const bool pix = r < a.R && oh < a.H && ow < a.W;
        float* yp = a.y + (((size_t)it.b * a.H + oh) * a.W + ow) * a.Cout;
#pragma unroll
        for (int j = 0; j < 8; ++j) {  // columns 8 j + 2 t4, + 1
          const int co = it.co0 + 8 * j + 2 * t4;
          const float v0 = acc[4 * j + 2 * half], v1 = acc[4 * j + 2 * half + 1];
          if (!pix || co >= a.Cout) continue;
          if (a.Cout % 2 == 0) {  // both in, 8-byte aligned
            *reinterpret_cast<float2*>(yp + co) = make_float2(v0, v1);
          } else {
            yp[co] = v0;
            if (co + 1 < a.Cout) yp[co + 1] = v1;
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    }
  }
  hopper::cp_async_wait<0>();
}

// The blocks of the WG-warpgroup kernel the current device holds at once.
template <int WG, bool kVec>
cudaError_t f_resident(int* blocks) {
  cudaError_t err = cudaFuncSetAttribute(conv3x3_f32_kernel<WG, kVec>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)FTile<WG>::kSmem);
  int dev = 0, sms = 0, per_sm = 0;
  if (err != cudaSuccess || (err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, conv3x3_f32_kernel<WG, kVec>, FTile<WG>::kThreads, FTile<WG>::kSmem)) !=
          cudaSuccess)
    return err;
  *blocks = sms * (per_sm > 0 ? per_sm : 1);
  return cudaSuccess;
}

template <int WG, bool kVec>
cudaError_t launch_f32(const FArgs& a, cudaStream_t st) {
  int resident = 0;
  const cudaError_t err = f_resident<WG, kVec>(&resident);
  if (err != cudaSuccess) return err;
  const int grid = a.items < resident ? a.items : resident;  // the blocks that fit, persistent
  conv3x3_f32_kernel<WG, kVec><<<grid, FTile<WG>::kThreads, FTile<WG>::kSmem, st>>>(a);
  return cudaGetLastError();
}

// Row segments of S <= 64 columns and items of R rows for WG-warpgroup
// tiles: the fewest items (segments x row steps) over a few segment counts,
// then the fewest segments.
template <int WG>
void f_plan(FArgs& a, int B) {
  long long best = -1;
  for (int segs = (a.W + kFSeg - 1) / kFSeg, n = 0; n < 4 && segs <= a.W; ++segs, ++n) {
    const int S = (a.W + segs - 1) / segs;
    const int R = min(FTile<WG>::kM / S, FTile<WG>::kHaloCap / (S + 2) - 2);
    const long long cost = (long long)segs * ((a.H + R - 1) / R);
    if (best < 0 || cost < best) best = cost, a.segs = segs, a.S = S, a.R = R;
  }
  a.rsteps = (a.H + a.R - 1) / a.R;
  a.ntiles = (a.Cout + kFN - 1) / kFN;
  a.chunks = (a.Cin + kFKc - 1) / kFKc;
  const long long items = (long long)B * a.rsteps * a.segs * a.ntiles;
  a.items = items * a.chunks > INT32_MAX ? -1 : (int)items;
}

}  // namespace

// x: (B, H, W, Cin), w: (3, 3, Cout, Cin) (K-major: the HWIO kernel with
// its channel axes swapped), y: (B, H, W, Cout), float32, contiguous; on
// the tensor cores in three TF32 passes.  Returns a cudaError_t.
extern "C" int k2_conv3x3_f32(const void* x, const void* w, void* y, int B, int H, int W,
                              int Cin, int Cout, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cout <= 0) return (int)cudaErrorInvalidValue;
  FArgs a;
  a.x = static_cast<const float*>(x);
  a.w = static_cast<const float*>(w);
  a.y = static_cast<float*>(y);
  a.H = H, a.W = W, a.Cin = Cin, a.Cout = Cout;
  // four warpgroups a block where their items fill the card kFWideItems
  // times over (their weights serve twice the pixels), else two
  int dev = 0, sms = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  FArgs wide = a;
  f_plan<4>(wide, B);
  const bool use_wide = wide.items >= (long long)kFWideItems * sms;
  if (use_wide) a = wide;
  else f_plan<2>(a, B);
  if (a.items < 0) return (int)cudaErrorInvalidValue;
  const bool vec = Cin % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(w) % 16 == 0;
  if (use_wide) return (int)(vec ? launch_f32<4, true>(a, st) : launch_f32<4, false>(a, st));
  return (int)(vec ? launch_f32<2, true>(a, st) : launch_f32<2, false>(a, st));
}

// The same for bfloat16 x, w and y, on the tensor cores.  Returns a
// cudaError_t.
extern "C" int k2_conv3x3_bf16(const void* x, const void* w, void* y, int B, int H, int W,
                               int Cin, int Cout, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  TcArgs a;
  a.x = static_cast<const bf16*>(x);
  a.w = static_cast<const bf16*>(w);
  a.y = static_cast<bf16*>(y);
  a.H = H, a.W = W, a.Cin = Cin, a.Cout = Cout;
  a.segs = (W + kSeg - 1) / kSeg;
  a.ntiles = (Cout + kN - 1) / kN;
  a.rsteps = (H + kTR - 1) / kTR;
  a.chunks = (Cin + kKc - 1) / kKc;
  const long long items = (long long)B * a.rsteps * a.segs * a.ntiles;
  if (B <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cout <= 0 || items * a.chunks > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  a.items = (int)items;
  const bool vec = Cin % 8 == 0 && Cout % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(w) % 16 == 0;
  return (int)(vec ? launch_tc<true>(a, st) : launch_tc<false>(a, st));
}
