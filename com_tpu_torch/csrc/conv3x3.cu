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
// about 33 us a call.
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
// f32 (`k2_conv3x3_f32`, unchanged from the first port): a direct
// convolution on the CUDA cores (f32 FMA).  A block owns an output tile of
// kTH x kTW pixels and kCO output channels of one sample; it walks the
// input channels in chunks of kCK (halo tile and weights in shared memory
// as f32), every thread accumulating 4 pixels x 8 output channels.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using hopper::bf16;

// ---- f32: direct convolution on the CUDA cores ----

constexpr int kTH = 8;    // output rows per block
constexpr int kTW = 16;   // output columns per block
constexpr int kCO = 64;   // output channels per block
constexpr int kCK = 8;    // input channels per chunk
constexpr int kCKP = kCK + 1;  // padded pixel stride in shared memory (no bank conflicts)
constexpr int kThreads = 256;
constexpr int kHaloW = kTW + 2;
constexpr int kHalo = (kTH + 2) * kHaloW;

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }

template <typename T>
__global__ void __launch_bounds__(kThreads)
conv3x3_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ y, int H, int W,
           int Cin, int Cout, int tiles_w) {
  __shared__ float s_in[kHalo * kCKP];
  __shared__ __align__(16) float s_w[9 * kCK * kCO];  // [tap][ci][co]
  const int ty = blockIdx.x / tiles_w, tx = blockIdx.x % tiles_w;
  const int h0 = ty * kTH, w0 = tx * kTW;
  const int co0 = blockIdx.y * kCO;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int g = tid & 7;          // output channels co0 + 8g .. 8g + 7
  const int pg = tid >> 3;        // pixel group 0..31
  const int pr = pg >> 2;         // tile row 0..7
  const int pc = (pg & 3) * 4;    // tile columns pc .. pc + 3
  const T* xb = x + (size_t)b * H * W * Cin;

  float acc[4][8];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int k = 0; k < 8; ++k) acc[j][k] = 0.f;

  for (int c0 = 0; c0 < Cin; c0 += kCK) {
    for (int e = tid; e < kHalo * kCK; e += kThreads) {
      const int ci = e % kCK, p = e / kCK;
      const int gh = h0 - 1 + p / kHaloW, gw = w0 - 1 + p % kHaloW, gc = c0 + ci;
      float v = 0.f;
      if (gh >= 0 && gh < H && gw >= 0 && gw < W && gc < Cin)
        v = to_f(xb[((size_t)gh * W + gw) * Cin + gc]);
      s_in[p * kCKP + ci] = v;
    }
    for (int e = tid; e < 9 * kCK * kCO; e += kThreads) {
      const int co = e % kCO, q = e / kCO;
      const int ci = q % kCK, tap = q / kCK;
      const int gc = c0 + ci, gco = co0 + co;
      float v = 0.f;
      if (gc < Cin && gco < Cout) v = to_f(w[((size_t)tap * Cin + gc) * Cout + gco]);
      s_w[e] = v;
    }
    __syncthreads();
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
#pragma unroll
        for (int ci = 0; ci < kCK; ++ci) {
          float xin[4];
#pragma unroll
          for (int j = 0; j < 4; ++j)
            xin[j] = s_in[((pr + dy) * kHaloW + pc + j + dx) * kCKP + ci];
          const float4* wp =
              reinterpret_cast<const float4*>(&s_w[((dy * 3 + dx) * kCK + ci) * kCO + g * 8]);
          const float4 wa = wp[0], wb = wp[1];
          const float wv[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int k = 0; k < 8; ++k) acc[j][k] = fmaf(xin[j], wv[k], acc[j][k]);
        }
      }
    }
    __syncthreads();
  }

  const int oh = h0 + pr;
  if (oh >= H) return;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int ow = w0 + pc + j;
    if (ow >= W) continue;
    T* yp = y + (((size_t)b * H + oh) * W + ow) * Cout;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int co = co0 + g * 8 + k;
      if (co < Cout) yp[co] = from_f<T>(acc[j][k]);
    }
  }
}

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

}  // namespace

// x: (B, H, W, Cin), w: (3, 3, Cin, Cout), y: (B, H, W, Cout), float32,
// contiguous.  Returns a cudaError_t.
extern "C" int k2_conv3x3_f32(const void* x, const void* w, void* y, int B, int H, int W,
                              int Cin, int Cout, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tiles_w = (W + kTW - 1) / kTW, tiles_h = (H + kTH - 1) / kTH;
  dim3 grid(tiles_w * tiles_h, (Cout + kCO - 1) / kCO, B);
  conv3x3_kernel<float><<<grid, kThreads, 0, st>>>(static_cast<const float*>(x),
                                               static_cast<const float*>(w),
                                               static_cast<float*>(y), H, W, Cin, Cout, tiles_w);
  return (int)cudaGetLastError();
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
