// K2w: weight gradient of the 3x3 stride-1 SAME convolution, NHWC.
//
//   dw[dy, dx, ci, co] = sum_{b,h,w} xpad[b, h+dy, w+dx, ci] * g[b, h, w, co]
//
// with xpad the input zero-padded by one pixel.  Replaces
// com_tpu/ops/pallas/conv2d.py `_conv3x3_wgrad_pallas` (`_wgrad_kernel`):
// inputs float32 or bfloat16, the output float32 (3, 3, Cin, Cout).
//
// What bounds it on an H100: operations.  At the training shapes (2, 468,
// 468, 64->64), (2, 234, 234, 128->128) and (2, 117, 117, 256->256) each
// call is 2 * 9 * Cin * Cout * B*H*W = 32.3 GFLOP against 28-56 MB read;
// at the bf16 tensor-core peak the bound is about 33 us a call.
//
// The reduction runs over B*H*W pixels (438,048 at 468 x 468) and the
// output is small (36,864-589,824 values), so the work is split along the
// pixels.  The TPU kernel carried the sum in its output block from one grid
// step to the next; Hopper blocks run in no order.  Each block owns one
// output tile and one chunk of pixels and writes its f32 partial tile; a
// second small pass adds the chunks' partials in a fixed order.  No float
// atomics, so the result is the same on every run.
//
// bf16 (`k2w_conv3x3_wgrad_bf16`): tensor cores, after the wgrad sweep's T3
// (x's shifted views read in place, no column buffer) in T2's orientation
// (taps along M).  A block owns one kernel row dy, 64 input channels and 64
// output channels: M = the three taps dx x 64 Cin, N = 64 Cout, K = pixels.
// Its chunk of pixels is a run of row segments (64 pixels of one image row
// h); for each, a stage holds x's row h + dy - 1 over pixels -1 .. 64 of
// the segment (zeros off the map) and g's row segment, both as [pixel]
// [channel] rows as they lie in memory.  A's fragments for tap dx are read
// with `ldmatrix.trans` from x's row at pixel offset dx, B's from g, and 8
// warps (4 along M, 2 along N) run `mma.sync.m16n8k16` (bf16 in, f32
// accumulators).  Stages go through a ring of kStages buffers filled by
// `cp.async`, three in flight while one multiplies, one barrier a stage.
// Fixing dy per block means each stage needs one x row, not a ring of three:
// three blocks read each x row, through L2.  The wrapper sizes the chunks so
// that the grid is one full wave of the blocks the card holds at once
// (`k2w_resident_blocks_bf16`).  Channel counts that are no multiple of 8,
// or pointers off 16 bytes, take a slower branch with element loads.  The
// tile sweep (tools/perf/conv_tiles.py) finds the staging the bound: the
// call is much shorter without the loads and no shorter without the
// products, and larger tiles (all three dy a block, or 128 Cout) do not
// move it.  TMA is the next step.  wgmma would need B (g, pixel-major) in
// its transposed shared-memory descriptor layout; this version stays on
// the warp-level instruction.
//
// f32 (`k2w_conv3x3_wgrad_f32`, unchanged from the first port): CUDA
// cores.  A block owns one (tap, 64-wide Cin tile, 64-wide Cout tile) and
// one chunk of pixels; 32 pixels at a time of the shifted input and of g go
// to shared memory as f32, and each of 256 threads accumulates a 4 x 4
// (ci, co) piece of the outer products (f32 FMA).  Each thread loads one
// pixel's eight channels of x and of g per batch (16-byte loads where the
// channel counts and pointers allow) and the next batch into registers
// while the block multiplies the current one.  The tile index runs fastest
// in the grid, so the blocks that read one chunk of pixels run together and
// share it through L2; the wrapper sizes the grid to two full waves
// (`k2w_resident_blocks_f32`).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

// ---- f32: CUDA cores ----

constexpr int kTile = 64;      // Cin and Cout per block
constexpr int kPix = 32;       // pixels per shared-memory batch
constexpr int kRow = kTile + 4;  // row stride in shared memory (keeps float4 alignment)
constexpr int kThreads = 256;
constexpr int kGroup = 8;      // channels one thread loads per pixel (kThreads = kPix * kTile / kGroup)

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }

// Eight consecutive channels from src (16-byte aligned) as f32.
__device__ __forceinline__ void load8(const float* src, float* v) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(src));
  const float4 b = __ldg(reinterpret_cast<const float4*>(src) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// Channels c0 .. c0+7 (those below n) of the row at src, zero past n.
template <typename T, bool kVec>
__device__ __forceinline__ void load_group(const T* src, int c0, int n, float* v) {
  if (kVec) {  // n is a multiple of 8, so the group is all in or all out
    if (c0 < n) load8(src + c0, v);
    return;
  }
#pragma unroll
  for (int i = 0; i < kGroup; ++i)
    if (c0 + i < n) v[i] = to_f(src[c0 + i]);
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
wgrad_partial_kernel(const T* __restrict__ x, const T* __restrict__ g, float* __restrict__ part,
                     int H, int W, int Cin, int Cout, int P, int chunk, int ci_tiles,
                     int co_tiles) {
  __shared__ __align__(16) float s_x[kPix * kRow];
  __shared__ __align__(16) float s_g[kPix * kRow];
  const int grp = blockIdx.x;
  const int cot = grp % co_tiles;
  const int cit = (grp / co_tiles) % ci_tiles;
  const int tap = grp / (co_tiles * ci_tiles);
  const int dy = tap / 3 - 1, dx = tap % 3 - 1;
  const int ci0 = cit * kTile, co0 = cot * kTile;
  const int p0 = blockIdx.y * chunk;
  const int p1 = min(P, p0 + chunk);
  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;  // ci = ci0 + 4 ty + i, co = co0 + 4 tx + j
  const int lk = tid / (kTile / kGroup);   // the pixel this thread loads in a batch
  const int lc = (tid % (kTile / kGroup)) * kGroup;  // and its first channel in the tile

  // one pixel's channels lc .. lc+7 of x (shifted by the tap) and of g
  float xr[kGroup], gr[kGroup];
  auto load = [&](int p) {
#pragma unroll
    for (int i = 0; i < kGroup; ++i) xr[i] = gr[i] = 0.f;
    if (p >= p1) return;
    const int w = p % W, row = p / W, h = row % H;  // row = b * H + h
    load_group<T, kVec>(g + (size_t)p * Cout + co0, lc, Cout - co0, gr);
    const int hs = h + dy, ws = w + dx;
    if (hs >= 0 && hs < H && ws >= 0 && ws < W)
      load_group<T, kVec>(x + ((size_t)(row + dy) * W + ws) * Cin + ci0, lc, Cin - ci0, xr);
  };

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  load(p0 + lk);
  for (int pb = p0; pb < p1; pb += kPix) {
    float4* sx = reinterpret_cast<float4*>(&s_x[lk * kRow + lc]);
    float4* sg = reinterpret_cast<float4*>(&s_g[lk * kRow + lc]);
    sx[0] = make_float4(xr[0], xr[1], xr[2], xr[3]);
    sx[1] = make_float4(xr[4], xr[5], xr[6], xr[7]);
    sg[0] = make_float4(gr[0], gr[1], gr[2], gr[3]);
    sg[1] = make_float4(gr[4], gr[5], gr[6], gr[7]);
    __syncthreads();
    load(pb + kPix + lk);  // the next batch, in flight while this one is multiplied
#pragma unroll 8
    for (int k = 0; k < kPix; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&s_x[k * kRow + ty * 4]);
      const float4 q = *reinterpret_cast<const float4*>(&s_g[k * kRow + tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float qv[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], qv[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* out = part + ((size_t)blockIdx.y * 9 + tap) * Cin * Cout;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int ci = ci0 + ty * 4 + i;
    if (ci >= Cin) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int co = co0 + tx * 4 + j;
      if (co < Cout) out[(size_t)ci * Cout + co] = acc[i][j];
    }
  }
}

// dw[i] = sum over chunks c = 0, 1, ... of part[c][i], in that order.
__global__ void wgrad_reduce_kernel(const float* __restrict__ part, float* __restrict__ dw,
                                    long long n, int chunks) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int c = 0; c < chunks; ++c) s += part[(size_t)c * n + i];
  dw[i] = s;
}

template <typename T>
void launch_partial(const void* x, const void* g, float* part, int H, int W, int Cin, int Cout,
                    int P, int chunk, int chunks, int ci_tiles, int co_tiles, cudaStream_t st) {
  const dim3 grid(9 * ci_tiles * co_tiles, chunks);
  const T* xt = static_cast<const T*>(x);
  const T* gt = static_cast<const T*>(g);
  const bool vec = Cin % kGroup == 0 && Cout % kGroup == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(g) % 16 == 0;
  if (vec)
    wgrad_partial_kernel<T, true><<<grid, kThreads, 0, st>>>(xt, gt, part, H, W, Cin, Cout, P,
                                                             chunk, ci_tiles, co_tiles);
  else
    wgrad_partial_kernel<T, false><<<grid, kThreads, 0, st>>>(xt, gt, part, H, W, Cin, Cout, P,
                                                              chunk, ci_tiles, co_tiles);
}


// ---- bf16: tensor cores ----

using hopper::bf16;

constexpr int kSeg = 64;            // pixels a step: one row segment
constexpr int kHaloPix = kSeg + 2;  // x pixels of a row a step
constexpr int kDY = 1;              // kernel rows dy a block
constexpr int kCi = 64;             // input channels a block
constexpr int kCo = 64;             // output channels a block
constexpr int kWarpsM = 4;          // warps along M (kDY * 3 taps * kCi rows)
constexpr int kStages = 4;
constexpr int kTcThreads = 256;
constexpr int kXStride = kCi + 8;   // bf16 a staged x pixel: 8 pixels fall on 8 bank groups
constexpr int kGStride = kCo + 8;   // likewise for g
constexpr int kXRowElems = kHaloPix * kXStride;
constexpr int kXElems = kDY * kXRowElems;
constexpr int kStageElems = kXElems + kSeg * kGStride;
constexpr size_t kTcSmem = sizeof(bf16) * kStages * kStageElems;
constexpr int kM = kDY * 3 * kCi;
constexpr int kWarpsN = kTcThreads / 32 / kWarpsM;
constexpr int kWM = kM / kWarpsM, kWN = kCo / kWarpsN;  // a warp's tile
constexpr int kMT = kWM / 16, kNT = kWN / 8;             // its m16 and n8 tiles
static_assert(kWM % 16 == 0 && kNT % 2 == 0 && kCi % 16 == 0 && 3 % kDY == 0, "warp tiling");
static_assert(kXElems % 8 == 0 && kStageElems % 8 == 0, "16-byte aligned stage parts");

struct TcArgs {
  const bf16* x;  // (B, H, W, Cin)
  const bf16* g;  // (B, H, W, Cout)
  float* part;    // (chunks, 3, 3, Cin, Cout)
  int H, W, Cin, Cout, segs, ci_tiles, co_tiles, steps, steps_per_chunk;
};

template <bool kVec>
__global__ void __launch_bounds__(kTcThreads) wgrad_tc_kernel(TcArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);

  const int cot = blockIdx.x % a.co_tiles;
  const int cit = (blockIdx.x / a.co_tiles) % a.ci_tiles;
  const int dy0 = blockIdx.x / (a.co_tiles * a.ci_tiles) * kDY;
  const int ci0 = cit * kCi, co0 = cot * kCo;
  const int s0 = blockIdx.y * a.steps_per_chunk;
  const int T = min(a.steps, s0 + a.steps_per_chunk) - s0;  // this block's row segments

  auto fetch = [&](int t) {
    if (t < T) {
      const int s = s0 + t;  // s = (b * H + h) * segs + seg
      const int seg = s % a.segs, bh = s / a.segs;
      const int h = bh % a.H, b = bh / a.H;
      bf16* xs = ring + (t % kStages) * kStageElems;
      const bf16* xb = a.x + (size_t)b * a.H * a.W * a.Cin;
#pragma unroll
      for (int r = 0; r < kDY; ++r)  // x's row h + dy - 1 for the block's kernel rows dy
        hopper::stage_row<kTcThreads, kVec>(xs + r * kXRowElems, kXStride, kCi / 8, xb, a.x,
                                            h + dy0 + r - 1, seg * kSeg - 1, kHaloPix, ci0,
                                            a.Cin, a.H, a.W);
      hopper::stage_row<kTcThreads, kVec>(xs + kXElems, kGStride, kCo / 8,
                                          a.g + (size_t)b * a.H * a.W * a.Cout, a.g, h,
                                          seg * kSeg, kSeg, co0, a.Cout, a.H, a.W);
    }
    hopper::cp_async_commit();  // one group a stage, empty past the end
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) fetch(s);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = (warp % kWarpsM) * kWM, wn = (warp / kWarpsM) * kWN;
  const int lrow = lane & 7, lmat = lane >> 3;
  // A (Cin x pixels) from [pixel][channel] storage: matrices (k, m), (k, m+8), (k+8, m), (k+8, m+8)
  const int a_k = lrow + (lmat >> 1) * 8, a_m = (lmat & 1) * 8;
  // B (pixels x Cout) from [pixel][channel] storage: matrices (k, n), (k+8, n), (k, n+8), (k+8, n+8)
  const int b_k = lrow + (lmat & 1) * 8, b_n = wn + (lmat >> 1) * 8;
  // each m16 tile lies in one tap: M row m is tap m / kCi (dy - dy0 = tap / 3,
  // dx = tap % 3) and channel m % kCi, read at pixel offset dx of x's row
  int a_off[kMT];
#pragma unroll
  for (int i = 0; i < kMT; ++i) {
    const int m = wm + i * 16, tap = m / kCi;
    a_off[i] = tap / 3 * kXRowElems + (a_k + tap % 3) * kXStride + m % kCi + a_m;
  }

  float acc[kMT][kNT][4];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (int t = 0; t < T; ++t) {
    hopper::cp_async_wait<kStages - 2>();  // stage t has landed (this thread's copies)
    __syncthreads();                       // everyone's, and stage t-1 is free
    fetch(t + kStages - 1);
    const bf16* xs = ring + (t % kStages) * kStageElems;
    const bf16* gs = xs + kXElems;
#pragma unroll
    for (int kk = 0; kk < kSeg; kk += 16) {
      uint32_t af[kMT][4], bfr[kNT / 2][4];
#pragma unroll
      for (int i = 0; i < kMT; ++i) hopper::ldmatrix_x4_trans(af[i], xs + kk * kXStride + a_off[i]);
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

  // this chunk's partial of dw[dy, dx, ci, co]
  float* out = a.part + (size_t)blockIdx.y * 9 * a.Cin * a.Cout;
  const int gid = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = wm + i * 16 + gid + (e >> 1) * 8;
        const int ci = ci0 + m % kCi, co = co0 + wn + j * 8 + t4 * 2 + (e & 1);
        if (ci < a.Cin && co < a.Cout)
          out[((size_t)(dy0 * 3 + m / kCi) * a.Cin + ci) * a.Cout + co] = acc[i][j][e];
      }
}

template <bool kVec>
cudaError_t set_tc_smem() {
  return cudaFuncSetAttribute(wgrad_tc_kernel<kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)kTcSmem);
}

template <bool kVec>
cudaError_t tc_occupancy(int* blocks) {
  cudaError_t err = set_tc_smem<kVec>();
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, wgrad_tc_kernel<kVec>, kTcThreads,
                                                       kTcSmem);
}

}  // namespace

// Blocks of the f32 partial kernel that the current device runs at once
// (the fewer of its two variants), or -1 on an error.
extern "C" int k2w_resident_blocks_f32() {
  int dev = 0, sms = 0, a = 0, b = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&a, wgrad_partial_kernel<float, true>,
                                                    kThreads, 0) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&b, wgrad_partial_kernel<float, false>,
                                                    kThreads, 0) != cudaSuccess)
    return -1;
  return sms * min(a, b);
}

// x: (B, H, W, Cin), g: (B, H, W, Cout), float32, contiguous; part:
// (chunks, 3, 3, Cin, Cout) f32 scratch; dw: (3, 3, Cin, Cout) f32.
// Returns a cudaError_t.
extern "C" int k2w_conv3x3_wgrad_f32(const void* x, const void* g, void* part, void* dw, int B,
                                     int H, int W, int Cin, int Cout, int chunks, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long P = (long long)B * H * W;
  if (P > INT32_MAX - 2 * kPix) return (int)cudaErrorInvalidValue;  // pixel indices are int
  const int chunk = (int)((P + chunks - 1) / chunks);
  const int ci_tiles = (Cin + kTile - 1) / kTile, co_tiles = (Cout + kTile - 1) / kTile;
  float* fpart = static_cast<float*>(part);
  launch_partial<float>(x, g, fpart, H, W, Cin, Cout, (int)P, chunk, chunks, ci_tiles, co_tiles,
                        st);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long n = 9LL * Cin * Cout;
  wgrad_reduce_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(fpart, static_cast<float*>(dw),
                                                                    n, chunks);
  return (int)cudaGetLastError();
}

// Blocks of the bf16 tensor-core kernel that the current device runs at
// once (the fewer of its two variants), or -1 on an error.
extern "C" int k2w_resident_blocks_bf16() {
  int dev = 0, sms = 0, a = 0, b = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      tc_occupancy<true>(&a) != cudaSuccess || tc_occupancy<false>(&b) != cudaSuccess)
    return -1;
  return sms * min(a, b);
}

// x: (B, H, W, Cin), g: (B, H, W, Cout), bfloat16, contiguous; part:
// (chunks, 3, 3, Cin, Cout) f32 scratch; dw: (3, 3, Cin, Cout) f32.  The
// pixels go as B * H * ceil(W / 64) row segments, chunk c taking segments
// c * steps_per_chunk .. (c + 1) * steps_per_chunk - 1; every chunk must
// hold at least one.  Returns a cudaError_t.
extern "C" int k2w_conv3x3_wgrad_bf16(const void* x, const void* g, void* part, void* dw, int B,
                                      int H, int W, int Cin, int Cout, int chunks,
                                      int steps_per_chunk, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  TcArgs a;
  a.x = static_cast<const bf16*>(x);
  a.g = static_cast<const bf16*>(g);
  a.part = static_cast<float*>(part);
  a.H = H, a.W = W, a.Cin = Cin, a.Cout = Cout;
  a.segs = (W + kSeg - 1) / kSeg;
  a.ci_tiles = (Cin + kCi - 1) / kCi;
  a.co_tiles = (Cout + kCo - 1) / kCo;
  const long long steps = (long long)B * H * a.segs;
  if (B <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cout <= 0 || chunks <= 0 ||
      steps_per_chunk <= 0 || steps > INT32_MAX || chunks > 65535 ||
      (long long)(chunks - 1) * steps_per_chunk >= steps ||
      (long long)chunks * steps_per_chunk < steps)
    return (int)cudaErrorInvalidValue;
  a.steps = (int)steps;
  a.steps_per_chunk = steps_per_chunk;
  const bool vec = Cin % 8 == 0 && Cout % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(g) % 16 == 0;
  cudaError_t err = vec ? set_tc_smem<true>() : set_tc_smem<false>();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(3 / kDY * a.ci_tiles * a.co_tiles, chunks);
  if (vec)
    wgrad_tc_kernel<true><<<grid, kTcThreads, kTcSmem, st>>>(a);
  else
    wgrad_tc_kernel<false><<<grid, kTcThreads, kTcSmem, st>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const long long n = 9LL * Cin * Cout;
  wgrad_reduce_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(a.part,
                                                                    static_cast<float*>(dw), n,
                                                                    chunks);
  return (int)cudaGetLastError();
}
