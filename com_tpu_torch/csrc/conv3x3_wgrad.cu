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
// Design.  The reduction runs over B*H*W pixels (438,048 at 468 x 468) and
// the output is small (36,864-589,824 values), so the work has to be split
// along the pixels.  The TPU kernel carried the sum in its output block from
// one grid step to the next; Hopper blocks run in no order.  Here each
// block owns one (tap, 64-wide Cin tile, 64-wide Cout tile) output tile and
// one chunk of pixels, and writes its f32 partial tile; a second small pass
// adds the chunks' partials in a fixed order.  No float atomics, so the
// result is the same on every run.  Inside a block, 32 pixels at a time of
// the shifted input and of g go to shared memory as f32, and each of 256
// threads accumulates a 4 x 4 (ci, co) piece of the outer products on the
// CUDA cores (f32 FMA), so the ceiling is the f32 rate, not the tensor
// cores.  To keep the loads off that path, each thread loads one pixel's
// eight channels of x and of g per batch (one 16-byte load for bf16, two
// for f32, where the channel counts and pointers allow; else element by
// element), with its pixel's (row, column) found once, and it loads the
// next batch into registers while the block multiplies the current one.
// The tile index runs fastest in the grid, so the 9-144 blocks that read
// one chunk of pixels run together and share it through L2.  All blocks do
// the same work, so the wrapper chooses the number of chunks to make the
// grid two full waves of the blocks the card holds at once
// (`k2w_resident_blocks`): a grid just past one wave would take two.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;      // Cin and Cout per block
constexpr int kPix = 32;       // pixels per shared-memory batch
constexpr int kRow = kTile + 4;  // row stride in shared memory (keeps float4 alignment)
constexpr int kThreads = 256;
constexpr int kGroup = 8;      // channels one thread loads per pixel (kThreads = kPix * kTile / kGroup)

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Eight consecutive channels from src (16-byte aligned) as f32.
__device__ __forceinline__ void load8(const float* src, float* v) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(src));
  const float4 b = __ldg(reinterpret_cast<const float4*>(src) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* src, float* v) {
  const uint4 r = __ldg(reinterpret_cast<const uint4*>(src));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
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

}  // namespace

// Blocks of the partial kernel that the current device runs at once (the
// fewest over its variants), or -1 on an error.
extern "C" int k2w_resident_blocks() {
  int dev = 0, sms = 0, a = 0, b = 0, c = 0, d = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&a, wgrad_partial_kernel<float, true>,
                                                    kThreads, 0) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&b, wgrad_partial_kernel<float, false>,
                                                    kThreads, 0) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &c, wgrad_partial_kernel<__nv_bfloat16, true>, kThreads, 0) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &d, wgrad_partial_kernel<__nv_bfloat16, false>, kThreads, 0) != cudaSuccess)
    return -1;
  return sms * min(min(a, b), min(c, d));
}

// x: (B, H, W, Cin), g: (B, H, W, Cout), contiguous, one dtype (0 = float32,
// 1 = bfloat16); part: (chunks, 3, 3, Cin, Cout) f32 scratch; dw: (3, 3,
// Cin, Cout) f32.  Returns a cudaError_t.
extern "C" int k2w_conv3x3_wgrad(const void* x, const void* g, void* part, void* dw, int B,
                                 int H, int W, int Cin, int Cout, int chunks, int dtype,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long P = (long long)B * H * W;
  if (P > INT32_MAX - 2 * kPix) return (int)cudaErrorInvalidValue;  // pixel indices are int
  const int chunk = (int)((P + chunks - 1) / chunks);
  const int ci_tiles = (Cin + kTile - 1) / kTile, co_tiles = (Cout + kTile - 1) / kTile;
  float* fpart = static_cast<float*>(part);
  if (dtype == 0)
    launch_partial<float>(x, g, fpart, H, W, Cin, Cout, (int)P, chunk, chunks, ci_tiles, co_tiles,
                          st);
  else
    launch_partial<__nv_bfloat16>(x, g, fpart, H, W, Cin, Cout, (int)P, chunk, chunks, ci_tiles,
                                  co_tiles, st);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long n = 9LL * Cin * Cout;
  wgrad_reduce_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(fpart, static_cast<float*>(dw),
                                                                    n, chunks);
  return (int)cudaGetLastError();
}
