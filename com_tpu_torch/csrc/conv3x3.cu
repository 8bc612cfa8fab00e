// K2: 3x3 stride-1 SAME convolution, NHWC x HWIO -> NHWC.
//
// Replaces com_tpu/ops/pallas/conv2d.py `_conv3x3_fwd_pallas`
// (`_conv_kernel`): nine taps accumulated in f32, input and output in the
// input's dtype (float32 or bfloat16).  The backward pass launches it too,
// for the input gradient: the output gradient convolved with the kernel
// rotated 180 degrees and its channel axes swapped (conv2d.py:544-553).
//
// What bounds it on an H100: operations.  At the serving shapes (2, 468,
// 468, 64->64), (2, 234, 234, 128->128) and (2, 117, 117, 256->256) each
// call is 32.3 GFLOP against 28-56 MB of traffic, far above the card's
// ratio of operations to bytes; at the bf16 tensor-core peak the bound is
// about 33 us a call.
//
// Design.  This first version is a direct convolution on the CUDA cores
// (f32 FMA), so its ceiling is the f32 rate, not the tensor cores.  A block
// owns an output tile of kTH x kTW pixels and kCO output channels of one
// sample.  It walks the input channels in chunks of kCK: the halo tile
// (kTH + 2) x (kTW + 2) x kCK (zero outside the image) and the chunk's
// 3 x 3 x kCK x kCO weights go to shared memory as f32, then every thread
// accumulates 4 pixels x 8 output channels in registers over the nine
// taps.  Ragged edges (468, 234 and 117 are no multiples of the tile) are
// masked on load and store.  The TPU kernel's row tiles with three halo
// views of VMEM become one halo load per chunk; there is no cross-block
// state.  Tensor-core tiles (mma / wgmma with TMA) are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

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

}  // namespace

// x: (B, H, W, Cin), w: (3, 3, Cin, Cout), y: (B, H, W, Cout), all
// contiguous and of one dtype (0 = float32, 1 = bfloat16).  Returns a
// cudaError_t.
extern "C" int k2_conv3x3(const void* x, const void* w, void* y, int B, int H, int W, int Cin,
                          int Cout, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tiles_w = (W + kTW - 1) / kTW, tiles_h = (H + kTH - 1) / kTH;
  dim3 grid(tiles_w * tiles_h, (Cout + kCO - 1) / kCO, B);
  if (dtype == 0)
    conv3x3_kernel<float><<<grid, kThreads, 0, st>>>(static_cast<const float*>(x),
                                                 static_cast<const float*>(w),
                                                 static_cast<float*>(y), H, W, Cin, Cout, tiles_w);
  else
    conv3x3_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
        static_cast<__nv_bfloat16*>(y), H, W, Cin, Cout, tiles_w);
  return (int)cudaGetLastError();
}
