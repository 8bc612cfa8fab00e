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
// at the bf16 tensor-core peak the bound is about 33 us a call, in f32
// (three TF32 products an operation at 495 TFLOP/s) about 196 us.
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
// f32 (`k2w_conv3x3_wgrad_f32`): three TF32 passes on `wgmma`
// (`hopper::split_tf32`: each value split once into hi + lo; lo*hi + hi*lo
// + hi*hi, to about 2^-20 of sum |x||g|).  A block owns one kernel row dy,
// 64 input and 64 output channels and runs three warpgroups, one a tap dx:
// each `wgmma.m64n64k8` has M = 64 input channels, N = 64 output channels,
// K = 8 pixels.  The pixels go as row segments, the map's width cut into
// ceil(W / 64) equal ones (35 of 35 pixels, not 35 of 64), a segment a
// stage and its K the segment rounded up to 8, the pixels past it zero.  A
// stage holds x's row h + dy - 1 over the segment and its halo ([pixel]
// [channel], 72 floats a pixel) and g's row segment.  A = x^T at pixel k +
// dx comes from registers: 8-byte loads along the channels (M rows gid and
// gid + 8 of a warp's 16 are channels 2 gid and 2 gid + 1), split there.  B
// must be K-major for TF32, so the thread that copies a 4-channel x
// 4-pixel piece of g transposes it into the k8 steps' 32-byte swizzled
// tiles (channel rows of 8 pixels), rounded to TF32, with the remainders in
// tiles beside (double buffered): one barrier a stage.  The tensor cores'
// f32 sums round toward zero, so a stage's products go into accumulators
// of their own, added to the block's f32 accumulators with round-to-nearest
// adds.  Stages go through a ring of kFStages = 2 buffers filled by
// `cp.async` (4-byte copies where channel counts or pointers are ragged);
// 139 KB of shared memory, one block an SM; the wrapper sizes the chunks to
// two waves of those blocks (`k2w_resident_blocks_f32`, `ops/conv2d.py`
// `wgrad_plan`).  The tile sweep finds the staging and the products each
// about a quarter of the call, the splits a twentieth.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

// dw[i] = sum over chunks c = 0, 1, ... of part[c][i], in that order.
__global__ void wgrad_reduce_kernel(const float* __restrict__ part, float* __restrict__ dw,
                                    long long n, int chunks) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int c = 0; c < chunks; ++c) s += part[(size_t)c * n + i];
  dw[i] = s;
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

// ---- f32: three-pass TF32 on the tensor cores (wgmma) ----

constexpr int kFCi = 64;            // input channels a block: wgmma's M
constexpr int kFCo = 64;            // output channels a block: wgmma's N
constexpr int kFStages = 2;         // the cp.async ring
constexpr int kFABufs = 3;          // A fragment buffers: k8 steps whose products are in flight
constexpr int kFThreads = 384;      // 3 warpgroups, one a tap dx
constexpr int kFSeg = 64;           // the widest row segment: K slots a stage
constexpr int kFXStride = kFCi + 8;  // floats a staged x pixel: rows t4 on 4 octets of banks
constexpr int kFGStride = kFCo + 4;  // floats a staged g pixel
constexpr int kFXElems = (kFSeg + 2) * kFXStride;
constexpr int kFStageElems = (kFXElems + kFSeg * kFGStride + 63) / 64 * 64;  // 256-byte multiple
constexpr int kFBTile = kFCo * 8;   // floats of a k8 step's B tile: 64 rows of 8 pixels (32 bytes)
constexpr int kFBElems = kFSeg / 8 * kFBTile;  // a stage's B tiles
// the ring, two stages' B tiles rounded to TF32 and their remainders, 256
// bytes to align the base
constexpr size_t kFSmem = sizeof(float) * (kFStages * kFStageElems + 4 * kFBElems) + 256;
static_assert(kFCi == 64 && kFCo == 64 && kFSeg % 8 == 0, "wgmma m64n64k8 tiles");
static_assert(kFXStride % 32 == 8, "conflict-free A loads");

struct FArgs {
  const float* x;  // (B, H, W, Cin)
  const float* g;  // (B, H, W, Cout)
  float* part;     // (chunks, 3, 3, Cin, Cout)
  int H, W, Cin, Cout;
  int S, segs, ksteps;  // segment width, segments a row, k8 steps a stage (S rounded up)
  int ci_tiles, co_tiles, steps, steps_per_chunk;
};

template <bool kVec>
__global__ void __launch_bounds__(kFThreads, 1) wgrad_f32_kernel(FArgs a) {
  extern __shared__ unsigned char smem_raw[];
  float* ring = reinterpret_cast<float*>(
      smem_raw + ((256 - (hopper::smem_addr(smem_raw) & 255)) & 255));
  float* b_tiles = ring + kFStages * kFStageElems;  // [t & 1][hi, lo][k8 step] B tiles

  const int cot = blockIdx.x % a.co_tiles;
  const int cit = (blockIdx.x / a.co_tiles) % a.ci_tiles;
  const int dy = blockIdx.x / (a.co_tiles * a.ci_tiles);
  const int ci0 = cit * kFCi, co0 = cot * kFCo;
  const int s0 = blockIdx.y * a.steps_per_chunk;
  const int T = max(0, min(a.steps, s0 + a.steps_per_chunk) - s0);  // this block's segments
  const int kpix = a.ksteps * 8;
  const int pieces = kFCo / 4 * (kpix / 4);  // g's 4-channel x 4-pixel pieces a stage

  auto fetch = [&](int t) {
    if (t < T) {
      const int s = s0 + t;  // s = (b * H + h) * segs + seg
      const int seg = s % a.segs, bh = s / a.segs;
      const int h = bh % a.H, b = bh / a.H;
      const int c0 = seg * a.S;
      float* xs = ring + (t % kFStages) * kFStageElems;
      // x's row h + dy - 1 over the segment and its halo, zero past them
      hopper::stage_row_f32<kFThreads, kVec>(xs, kFXStride, kFCi / 4,
                                             a.x + (size_t)b * a.H * a.W * a.Cin, a.x,
                                             h + dy - 1, c0 - 1, kpix + 2, c0 - 1, c0 + a.S + 1,
                                             ci0, a.Cin, a.H, a.W);
      // g's row h over the segment (zero past it), in pieces of 4 channels x
      // 4 pixels: the thread that copies a piece transposes it
      const bool row_in = h < a.H;
      const float* gb = a.g + ((size_t)b * a.H + h) * a.W * a.Cout;
      float* gs = xs + kFXElems;
      for (int q = threadIdx.x; q < pieces; q += kFThreads) {
        const int cg = q % (kFCo / 4), pb = q / (kFCo / 4);
        const int co = co0 + cg * 4;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int p = pb * 4 + j, col = c0 + p;
          const bool in = row_in && p < a.S && col < a.W;
          const float* src = gb + (size_t)col * a.Cout + co;
          float* dst = gs + p * kFGStride + cg * 4;
          if (kVec) {  // Cout is a multiple of 4: the group is all in or all out
            hopper::cp_async16(dst, in && co < a.Cout ? src : a.g, in && co < a.Cout);
          } else {
#pragma unroll
            for (int k = 0; k < 4; ++k)
              hopper::cp_async4(dst + k, in && co + k < a.Cout ? src + k : a.g,
                                in && co + k < a.Cout);
          }
        }
      }
    }
    hopper::cp_async_commit();  // one group a stage, empty past the end
  };
#pragma unroll
  for (int s = 0; s < kFStages - 1; ++s) fetch(s);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, t4 = lane & 3;
  const int dx = warp >> 2, w4 = warp & 3;  // this warp's tap and its 16 of the 64 channels
  // A (M = ci x K = pixels) from x's [pixel][channel] rows at pixel k + dx:
  // rows gid and gid + 8 of the warp's 16 are channels 2 gid and 2 gid + 1
  const int a_off = (t4 + dx) * kFXStride + 16 * w4 + 2 * gid;

  float acc[32], part[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = part[i] = 0.f;

  for (int t = 0; t < T; ++t) {
    hopper::cp_async_wait<kFStages - 2>();  // stage t has landed (this thread's copies)
    const float* xs = ring + (t % kFStages) * kFStageElems;
    const float* gs = xs + kFXElems;
    float* bt = b_tiles + (t & 1) * 2 * kFBElems;  // last read by stage t - 2's products
    // B: this thread's pieces of g transposed to [channel][pixel] rows of the
    // k8 steps' tiles (32-byte swizzle), rounded to TF32, remainders beside
    for (int q = threadIdx.x; q < pieces; q += kFThreads) {
      const int cg = q % (kFCo / 4), pb = q / (kFCo / 4);
      float v[4][4];  // [pixel][channel]
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 r = *reinterpret_cast<const float4*>(gs + (pb * 4 + j) * kFGStride + cg * 4);
        v[j][0] = r.x, v[j][1] = r.y, v[j][2] = r.z, v[j][3] = r.w;
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int n = cg * 4 + c;
        const int off = pb / 2 * kFBTile + n * 8 + (((pb & 1) ^ ((n >> 2) & 1)) * 4);
        uint4 hi, lo;
        hopper::split_tf32(v[0][c], hi.x, lo.x);
        hopper::split_tf32(v[1][c], hi.y, lo.y);
        hopper::split_tf32(v[2][c], hi.z, lo.z);
        hopper::split_tf32(v[3][c], hi.w, lo.w);
        *reinterpret_cast<uint4*>(bt + off) = hi;
        *reinterpret_cast<uint4*>(bt + kFBElems + off) = lo;
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to wgmma's reads
    __syncthreads();  // everyone's stage t; stage t-1's products are done, its slot free
    fetch(t + kFStages - 1);
    const uint64_t d_hi = hopper::wg_desc_sw32(bt), d_lo = hopper::wg_desc_sw32(bt + kFBElems);
    uint32_t a_hi[kFABufs][4], a_lo[kFABufs][4];  // a step's fragments stay until its products end
#pragma unroll
    for (int ks = 0; ks < kFSeg / 8; ++ks) {
      if (ks >= a.ksteps) break;
      const int b = ks % kFABufs;
      if (ks >= kFABufs) hopper::wgmma_wait<kFABufs - 1>();  // ks - kFABufs's products are done
      // a0, a1 = pixel 8 ks + t4 (+ dx), channels 2 gid, 2 gid + 1; a2, a3 = pixel + 4
      const float2 u = *reinterpret_cast<const float2*>(xs + ks * 8 * kFXStride + a_off);
      const float2 w = *reinterpret_cast<const float2*>(xs + (ks * 8 + 4) * kFXStride + a_off);
      hopper::split_tf32(u.x, a_hi[b][0], a_lo[b][0]);
      hopper::split_tf32(u.y, a_hi[b][1], a_lo[b][1]);
      hopper::split_tf32(w.x, a_hi[b][2], a_lo[b][2]);
      hopper::split_tf32(w.y, a_hi[b][3], a_lo[b][3]);
      const uint64_t off = (uint64_t)(ks * kFBTile * 4) >> 4;  // the step's B tile
      hopper::wgmma_fence();
      hopper::wgmma_3xtf32(part, a_hi[b], a_lo[b], d_hi + off, d_lo + off, ks > 0);
      hopper::wgmma_commit();
    }
    hopper::wgmma_wait<0>();
    hopper::fence_operands(part);
    // the stage's sums, rounded toward zero in the tensor cores, into the
    // f32 accumulators with round-to-nearest adds
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] += part[i];
  }
  hopper::cp_async_wait<0>();

  // this chunk's partial of dw[dy, dx, ci, co] (zeros for an empty chunk)
  float* out = a.part + ((size_t)blockIdx.y * 9 + dy * 3 + dx) * a.Cin * a.Cout;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int ci = ci0 + 16 * w4 + 2 * gid + half;
    if (ci >= a.Cin) continue;
    float* row = out + (size_t)ci * a.Cout;
#pragma unroll
    for (int j = 0; j < 8; ++j) {  // columns 8 j + 2 t4, + 1
      const int co = co0 + 8 * j + 2 * t4;
      const float v0 = acc[4 * j + 2 * half], v1 = acc[4 * j + 2 * half + 1];
      if (co >= a.Cout) continue;
      if (a.Cout % 2 == 0) {  // both in, 8-byte aligned (part is the wrapper's allocation)
        *reinterpret_cast<float2*>(row + co) = make_float2(v0, v1);
      } else {
        row[co] = v0;
        if (co + 1 < a.Cout) row[co + 1] = v1;
      }
    }
  }
}

template <bool kVec>
cudaError_t f32_occupancy(int* blocks) {
  cudaError_t err = cudaFuncSetAttribute(wgrad_f32_kernel<kVec>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kFSmem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, wgrad_f32_kernel<kVec>, kFThreads,
                                                       kFSmem);
}

}  // namespace

// Blocks of the f32 tensor-core kernel that the current device runs at
// once (the fewer of its two variants), or -1 on an error.
extern "C" int k2w_resident_blocks_f32() {
  int dev = 0, sms = 0, a = 0, b = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      f32_occupancy<true>(&a) != cudaSuccess || f32_occupancy<false>(&b) != cudaSuccess)
    return -1;
  return sms * min(a, b);
}

// x: (B, H, W, Cin), g: (B, H, W, Cout), float32, contiguous; part:
// (chunks, 3, 3, Cin, Cout) f32 scratch; dw: (3, 3, Cin, Cout) f32.  The
// pixels go as B * H * ceil(W / 64) row segments of equal width, chunk c
// taking segments c * per .. (c + 1) * per - 1 with per = ceil(segments /
// chunks) (a chunk past the last segment writes a zero partial).  Returns a
// cudaError_t.
extern "C" int k2w_conv3x3_wgrad_f32(const void* x, const void* g, void* part, void* dw, int B,
                                     int H, int W, int Cin, int Cout, int chunks, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cout <= 0 || chunks <= 0 || chunks > 65535)
    return (int)cudaErrorInvalidValue;
  FArgs a;
  a.x = static_cast<const float*>(x);
  a.g = static_cast<const float*>(g);
  a.part = static_cast<float*>(part);
  a.H = H, a.W = W, a.Cin = Cin, a.Cout = Cout;
  a.segs = (W + kFSeg - 1) / kFSeg;
  a.S = (W + a.segs - 1) / a.segs;
  a.ksteps = (a.S + 7) / 8;
  a.ci_tiles = (Cin + kFCi - 1) / kFCi;
  a.co_tiles = (Cout + kFCo - 1) / kFCo;
  const long long steps = (long long)B * H * a.segs;
  if (steps > INT32_MAX) return (int)cudaErrorInvalidValue;
  a.steps = (int)steps;
  a.steps_per_chunk = (int)((steps + chunks - 1) / chunks);
  const bool vec = Cin % 4 == 0 && Cout % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(g) % 16 == 0;
  int dummy = 0;
  cudaError_t err = vec ? f32_occupancy<true>(&dummy) : f32_occupancy<false>(&dummy);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(3 * a.ci_tiles * a.co_tiles, chunks);  // (dy, Cin tile, Cout tile) x chunks
  if (vec)
    wgrad_f32_kernel<true><<<grid, kFThreads, kFSmem, st>>>(a);
  else
    wgrad_f32_kernel<false><<<grid, kFThreads, kFSmem, st>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const long long n = 9LL * Cin * Cout;
  wgrad_reduce_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(a.part,
                                                                    static_cast<float*>(dw), n,
                                                                    chunks);
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
