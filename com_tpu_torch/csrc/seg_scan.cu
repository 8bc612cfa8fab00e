// K1: per-row run totals over pillar-sorted rows.
//
// Replaces com_tpu/ops/pallas/seg_scan.py `_run_bcast_pallas`
// (`_fwd_kernel` and `_rev_kernel`): for vals (B, N, C) and per-sample
// sorted segment ids seg (B, N), out[b, i] = sum or max of vals[b, j] over
// all j with seg[b, j] == seg[b, i].  The backward pass of either op is
// built from its sums (seg_scan.py:284-299): the run sum of the gradient
// and, for max, the run count of tied maxima.
//
// What bounds it on an H100: bytes.  The work is one read of vals and seg
// and one write of out, a few operations per element; at the serving shapes
// ((2, 163840, 8) f32 and (2, 163840, 32) bf16) the card's memory rate gives
// 7-13 us.
//
// Design.  The TPU kernel carried a (1, C) total from one grid step to the
// next, which relies on the TPU running its grid in order.  Hopper blocks
// run in no order, so the carry becomes a second pass:
//   1. k1_partials: each block takes a tile of kTile rows of one sample and
//      runs an inclusive segmented scan in shared memory (log2(kTile)
//      Hillis-Steele steps, channels in chunks of kChunk).  It writes two
//      (C,) partials per tile: `head`, the total of the tile's first piece
//      (the rows that share the first row's id), and `tail`, the total of
//      its last piece.
//   2. k1_bcast: each block rescans its tile, reads each row's piece total
//      at the piece's last row, and adds the carries of runs that cross the
//      tile's edges.  The run of the tile's first row starts at
//      lower_bound(seg, id) (a binary search in device memory); its left
//      carry is the reduction of `tail` over the tiles from that start up to
//      this tile, done by all threads of the block at once.  The right carry
//      is the same over `head` to the run's last tile.
// Every run is so reduced in f32 without one thread walking it: a run as
// long as the whole sample (a padded, empty scene) costs each of its tiles
// a parallel reduction over at most N / kTile partials.  Max is exact; sum
// differs from a sequential sum only by f32 rounding.  For max a non-finite
// total becomes 0, as in the plain version.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 1024;   // rows per block
constexpr int kChunk = 8;     // channels per pass
constexpr int kThreads = 256;
constexpr int kPer = kTile * kChunk / kThreads;  // values per thread
constexpr int kLanes = kThreads / kChunk;        // threads per channel

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

__device__ __forceinline__ float comb(float a, float b, bool is_max) {
  return is_max ? fmaxf(a, b) : a + b;
}

// first index in [lo, hi) with s[i] > key (s sorted)
__device__ __forceinline__ int upper_bound(const int* s, int lo, int hi, int key) {
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (s[mid] > key) hi = mid; else lo = mid + 1;
  }
  return lo;
}

// first index in [lo, hi) with s[i] >= key (s sorted)
__device__ __forceinline__ int lower_bound(const int* s, int lo, int hi, int key) {
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (s[mid] >= key) hi = mid; else lo = mid + 1;
  }
  return lo;
}

// Load channels [c0, c0 + kChunk) of the tile into s_v (row-major, kChunk
// wide); rows past nv and channels past C read 0.
template <typename T>
__device__ __forceinline__ void load_chunk(float* s_v, const T* v, int nv, int C, int c0) {
  for (int e = threadIdx.x; e < kTile * kChunk; e += kThreads) {
    int r = e / kChunk, ch = e % kChunk;
    float x = 0.f;
    if (r < nv && c0 + ch < C) x = to_f(v[(size_t)r * C + c0 + ch]);
    s_v[e] = x;
  }
}

// In-place inclusive segmented scan of s_v along rows (seg ids in s_seg).
// Rows are sorted by id, so s_seg[r] == s_seg[r - d] means every row in
// between shares the id.
__device__ __forceinline__ void scan_chunk(float* s_v, const int* s_seg, bool is_max) {
  float nxt[kPer];
  __syncthreads();
  for (int d = 1; d < kTile; d <<= 1) {
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      int e = threadIdx.x + k * kThreads;
      int r = e / kChunk;
      float x = s_v[e];
      if (r >= d && s_seg[r] == s_seg[r - d]) x = comb(x, s_v[e - d * kChunk], is_max);
      nxt[k] = x;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kPer; ++k) s_v[threadIdx.x + k * kThreads] = nxt[k];
    __syncthreads();
  }
}

__device__ __forceinline__ void load_seg(int* s_seg, const int* sg, int nv) {
  for (int r = threadIdx.x; r < kTile; r += kThreads) s_seg[r] = r < nv ? sg[r] : INT_MAX;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
k1_partials(const T* __restrict__ vals, const int* __restrict__ seg,
            float* __restrict__ head, float* __restrict__ tail,
            int N, int C, int nt, int is_max) {
  __shared__ int s_seg[kTile];
  __shared__ float s_v[kTile * kChunk];
  __shared__ int s_head_end;
  const int t = blockIdx.x, b = blockIdx.y;
  const int r0 = t * kTile;
  const int nv = min(kTile, N - r0);
  const int* sg = seg + (size_t)b * N + r0;
  const T* v = vals + ((size_t)b * N + r0) * C;
  load_seg(s_seg, sg, nv);
  __syncthreads();
  if (threadIdx.x == 0) s_head_end = upper_bound(s_seg, 0, nv, s_seg[0]) - 1;
  float* hd = head + ((size_t)b * nt + t) * C;
  float* tl = tail + ((size_t)b * nt + t) * C;
  for (int c0 = 0; c0 < C; c0 += kChunk) {
    load_chunk(s_v, v, nv, C, c0);
    scan_chunk(s_v, s_seg, is_max);
    if (threadIdx.x < kChunk && c0 + threadIdx.x < C) {
      hd[c0 + threadIdx.x] = s_v[s_head_end * kChunk + threadIdx.x];
      tl[c0 + threadIdx.x] = s_v[(nv - 1) * kChunk + threadIdx.x];
    }
    __syncthreads();
  }
}

// Reduce part[b, t_from .. t_to] (inclusive) per channel of the chunk into
// out_c[kChunk]; all threads of the block take part.
__device__ __forceinline__ void range_reduce(const float* part, int C, int c0, int t_from,
                                             int t_to, bool is_max, float* s_red,
                                             float* out_c) {
  const float ident = is_max ? -INFINITY : 0.f;
  const int ch = threadIdx.x % kChunk, j = threadIdx.x / kChunk;
  float acc = ident;
  if (c0 + ch < C)
    for (int tt = t_from + j; tt <= t_to; tt += kLanes)
      acc = comb(acc, part[(size_t)tt * C + c0 + ch], is_max);
  s_red[threadIdx.x] = acc;
  __syncthreads();
  for (int s = kLanes / 2; s > 0; s >>= 1) {
    if (j < s) s_red[threadIdx.x] = comb(s_red[threadIdx.x], s_red[threadIdx.x + s * kChunk], is_max);
    __syncthreads();
  }
  if (threadIdx.x < kChunk) out_c[threadIdx.x] = s_red[threadIdx.x];
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
k1_bcast(const T* __restrict__ vals, const int* __restrict__ seg,
         const float* __restrict__ head, const float* __restrict__ tail,
         T* __restrict__ out, int N, int C, int nt, int is_max) {
  __shared__ int s_seg[kTile];
  __shared__ int s_pend[kTile];  // local index of the last row of each row's piece
  __shared__ float s_v[kTile * kChunk];
  __shared__ float s_red[kThreads];
  __shared__ float s_lc[kChunk], s_rc[kChunk];
  __shared__ int s_info[4];  // has_left, t_lo, has_right, t_hi
  const int t = blockIdx.x, b = blockIdx.y;
  const int r0 = t * kTile;
  const int nv = min(kTile, N - r0);
  const int* sb = seg + (size_t)b * N;  // the whole sample's ids
  const T* v = vals + ((size_t)b * N + r0) * C;
  T* o = out + ((size_t)b * N + r0) * C;
  load_seg(s_seg, sb + r0, nv);
  __syncthreads();
  for (int r = threadIdx.x; r < nv; r += kThreads)
    s_pend[r] = upper_bound(s_seg, r, nv, s_seg[r]) - 1;
  if (threadIdx.x == 0) {
    const int s0 = s_seg[0], sl = s_seg[nv - 1];
    const int has_left = r0 > 0 && sb[r0 - 1] == s0;
    const int has_right = r0 + nv < N && sb[r0 + nv] == sl;
    s_info[0] = has_left;
    s_info[1] = has_left ? lower_bound(sb, 0, r0, s0) / kTile : t;
    s_info[2] = has_right;
    s_info[3] = has_right ? (upper_bound(sb, r0 + nv, N, sl) - 1) / kTile : t;
  }
  __syncthreads();
  const int has_left = s_info[0], t_lo = s_info[1];
  const int has_right = s_info[2], t_hi = s_info[3];
  const int s0 = s_seg[0], sl = s_seg[nv - 1];
  const float* tl = tail + (size_t)b * nt * C;
  const float* hd = head + (size_t)b * nt * C;
  for (int c0 = 0; c0 < C; c0 += kChunk) {
    load_chunk(s_v, v, nv, C, c0);
    scan_chunk(s_v, s_seg, is_max);
    if (has_left) range_reduce(tl, C, c0, t_lo, t - 1, is_max, s_red, s_lc);
    __syncthreads();
    if (has_right) range_reduce(hd, C, c0, t + 1, t_hi, is_max, s_red, s_rc);
    __syncthreads();
    for (int e = threadIdx.x; e < kTile * kChunk; e += kThreads) {
      const int r = e / kChunk, ch = e % kChunk;
      if (r >= nv || c0 + ch >= C) continue;
      const int id = s_seg[r];
      float x = s_v[s_pend[r] * kChunk + ch];
      if (has_left && id == s0) x = comb(x, s_lc[ch], is_max);
      if (has_right && id == sl) x = comb(x, s_rc[ch], is_max);
      if (is_max && !isfinite(x)) x = 0.f;
      o[(size_t)r * C + c0 + ch] = from_f<T>(x);
    }
    __syncthreads();
  }
}

template <typename T>
int launch(const void* vals, const int* seg, void* out, float* head, float* tail, int B,
           int N, int C, int is_max, cudaStream_t st) {
  const int nt = (N + kTile - 1) / kTile;
  dim3 grid(nt, B);
  k1_partials<T><<<grid, kThreads, 0, st>>>(static_cast<const T*>(vals), seg, head, tail, N,
                                            C, nt, is_max);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  k1_bcast<T><<<grid, kThreads, 0, st>>>(static_cast<const T*>(vals), seg, head, tail,
                                         static_cast<T*>(out), N, C, nt, is_max);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int k1_tile_rows() { return kTile; }

// vals, out: (B, N, C) contiguous, dtype 0 = float32, 1 = bfloat16.
// seg: (B, N) int32, sorted within each sample.  head, tail: (B, ceil(N /
// kTile), C) float32 scratch.  op: 0 = sum, 1 = max.  Returns a cudaError_t.
extern "C" int k1_run_bcast(const void* vals, const int* seg, void* out, float* head,
                            float* tail, int B, int N, int C, int op, int dtype,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(vals, seg, out, head, tail, B, N, C, op, st);
  return launch<__nv_bfloat16>(vals, seg, out, head, tail, B, N, C, op, st);
}
