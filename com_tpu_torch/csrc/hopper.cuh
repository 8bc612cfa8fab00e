// Building blocks shared by the tensor-core convolution kernels (conv3x3.cu,
// conv3x3_wgrad.cu, wgrad_variants.cu): asynchronous 16- and 4-byte copies
// into shared memory, the staging of image row segments with them (bf16 and
// f32), `ldmatrix` fragment loads, the bf16 `mma.sync.m16n8k16`, and for f32
// operands the TF32 split and `wgmma.m64n64k8` in three passes, all with f32
// accumulators.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global src to shared dst, in flight until `cp_async_wait`;
// with `valid` false nothing is read and dst is zero-filled (src must still
// be a mapped address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// 4 bytes from global src to shared dst, zero-filled when `valid` is false
// (src must still be a mapped address).
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

// Wait until at most N committed groups of this thread are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Channels c0 .. c0+8*groups-1 of `npix` pixels of image row `row` (sample
// base src, (H, W, C) bf16), starting at column col0, into shared rows of
// `stride` bf16, by a block of kThreads threads; zero off the map and past
// C.  kVec (C a multiple of 8, src 16-byte aligned): 16-byte `cp.async`
// copies, in flight until `cp_async_wait` (`any` is a mapped address for
// the zero-filled ones); else element loads through registers.  kSwizzle:
// rows of 64 channels (stride 64, groups 8) in the 128-byte swizzled layout
// of `wgmma`'s shared-memory operands (dst 1024-byte aligned): group j of
// pixel p goes to 16-byte slot j ^ (p % 8) of its row.
template <int kThreads, bool kVec, bool kSwizzle = false>
__device__ __forceinline__ void stage_row(bf16* __restrict__ dst, int stride, int groups,
                                          const bf16* __restrict__ src, const bf16* any, int row,
                                          int col0, int npix, int c0, int C, int H, int W) {
  const bool row_in = row >= 0 && row < H;
  for (int i = threadIdx.x; i < npix * groups; i += kThreads) {
    const int grp = i % groups, p = i / groups;
    const int col = col0 + p, c = c0 + grp * 8;
    const bool in = row_in && col >= 0 && col < W && c < C;
    const bf16* s = src + ((size_t)row * W + col) * C + c;
    bf16* d = dst + p * stride + (kSwizzle ? grp ^ (p & 7) : grp) * 8;
    if (kVec) {  // C is a multiple of 8: the group is all in or all out
      cp_async16(d, in ? s : any, in);
    } else {
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      bf16* e = reinterpret_cast<bf16*>(&v);
      if (in) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (c + j < C) e[j] = s[j];
      }
      *reinterpret_cast<uint4*>(d) = v;
    }
  }
}

// The f32 counterpart of `stage_row`: channels c0 .. c0+4*groups-1 of the
// pixels col0 .. col0+npix-1 of image row `row` (sample base src, (H, W, C)
// f32) into shared rows of `stride` floats; zero off the map, past C and at
// the columns outside [lo, hi) (a row segment's own pixels and halo).
// kVec (C a multiple of 4, src 16-byte aligned): one 16-byte `cp.async` a
// group of 4 channels; else one 4-byte `cp.async` a channel.  Every copy
// is in flight until `cp_async_wait`.
template <int kThreads, bool kVec>
__device__ __forceinline__ void stage_row_f32(float* __restrict__ dst, int stride, int groups,
                                              const float* __restrict__ src, const float* any,
                                              int row, int col0, int npix, int lo, int hi, int c0,
                                              int C, int H, int W) {
  const bool row_in = row >= 0 && row < H;
  lo = max(lo, 0);
  hi = min(hi, W);
  for (int i = threadIdx.x; i < npix * groups; i += kThreads) {
    const int grp = i % groups, p = i / groups;
    const int col = col0 + p, c = c0 + grp * 4;
    const bool in = row_in && col >= lo && col < hi;
    const float* s = src + ((size_t)row * W + col) * C + c;
    float* d = dst + p * stride + grp * 4;
    if (kVec) {  // C is a multiple of 4: the group is all in or all out
      cp_async16(d, in && c < C ? s : any, in && c < C);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) cp_async4(d + j, in && c + j < C ? s + j : any, in && c + j < C);
    }
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a (m16 x k16, row) * b (k16 x n8, col), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// v as a TF32 pair, split as CUTLASS's fast f32 products split it: hi = v
// rounded to TF32 by adding half its last bit and truncating (two integer
// instructions; `cvt.rna.tf32.f32` compiles to a longer sequence), lo =
// v - hi (exact, at most 2^-11 of |v|), left for the tensor cores to
// truncate to TF32, so that hi + lo holds v to 2^-21 of |v|.
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi));
}

// wgmma's shared-memory descriptor of a K-major TF32 tile with 32-byte rows
// (8 values of K) in the 32-byte swizzled layout: 16-byte half j of row n
// at j ^ ((n >> 2) & 1), rows 32 bytes apart, 8-row groups 256 bytes apart
// (SBO); the tile 256-byte aligned.
__device__ __forceinline__ uint64_t wg_desc_sw32(const void* p) {
  return ((smem_addr(p) & 0x3FFFF) >> 4) | (1ull << 16) | ((256ull >> 4) << 32) | (3ull << 62);
}

// d (64 x 64 f32, a warpgroup's fragments) = a (64 x 8 TF32 in registers: each warp's 16
// rows as mma.m16n8k8's A) * b (desc: 64 rows of N x 8 of K) + (scale_d ? d : 0)
__device__ __forceinline__ void wgmma_m64n64k8_tf32(float (&d)[32], const uint32_t (&a)[4],
                                                    uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// d = a * b in three TF32 passes (+ d where scale_d), the small products
// first: a_lo * b_hi, a_hi * b_lo, a_hi * b_hi (b_hi, b_lo: descriptors of
// the B tile rounded to TF32 and of its remainders)
__device__ __forceinline__ void wgmma_3xtf32(float (&d)[32], const uint32_t (&a_hi)[4],
                                             const uint32_t (&a_lo)[4], uint64_t b_hi,
                                             uint64_t b_lo, int scale_d) {
  wgmma_m64n64k8_tf32(d, a_lo, b_hi, scale_d);
  wgmma_m64n64k8_tf32(d, a_hi, b_lo, 1);
  wgmma_m64n64k8_tf32(d, a_hi, b_hi, 1);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N committed wgmma groups of this warpgroup are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep fragments in place across the asynchronous products
template <int N>
__device__ __forceinline__ void fence_operands(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

}  // namespace hopper
