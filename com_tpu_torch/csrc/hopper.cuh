// Building blocks shared by the tensor-core convolution kernels (conv3x3.cu,
// conv3x3_wgrad.cu, wgrad_xcol_gtcol.cu): asynchronous 16-byte copies into
// shared memory, the staging of image row segments with them, `ldmatrix`
// fragment loads and the bf16 `mma.sync.m16n8k16` with f32 accumulators.
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

}  // namespace hopper
