// T1 and T3: two tensor-core formulations of the 3x3 conv weight gradient,
//
//   dw[dy, dx, ci, co] = sum_{b,h,w} xpad[b, h+dy, w+dx, ci] * g[b, h, w, co]
//
// (xpad: x zero-padded by one pixel), the function of K2w.  They replace two
// kernels of the wgrad-formulation sweep,
// tools/perf/microbench_wgrad_kernels.py:
//   T1 `wgrad_gcol`  (:84)  g shifted per tap into a column buffer; one
//                           product x^T (cin, K) . g_col (K, 9 cout)
//   T3 `wgrad_gt9`   (:175) g^T (cout, K) once, nine products against views
//                           of one x halo tile, at the taps' column offsets
// Inputs bfloat16 NHWC, output float32 (3, 3, Cin, Cout).  T2 and T4, the
// sweep's other two, are in wgrad_xcol_gtcol.cu.
//
// What bounds them on an H100: operations and bytes about equally.  At the
// sweep's shapes (2, 468, 468, 64->64) and (2, 468, 468, 128->64) a call is
// 32.3 and 64.6 GFLOP against 112 and 168 MB read: 0.033 and 0.065 ms at
// the bf16 tensor-core peak, 0.034 and 0.050 ms at 3.35 TB/s.
//
// Design (the sweep's first, once shared by all four formulations).  Both
// run on the tensor cores with warp-level `mma.sync.m16n8k16` (bf16 in, f32
// accumulators).  NHWC stores both
// operands channel-contiguous, while the contraction runs over pixels, the
// slow axis of both: the operands are staged in shared memory as
// [pixel][channel] rows, as they lie in memory, and `ldmatrix.trans` turns
// them into fragments that contract over pixels.  Rows are padded to 8 mod
// 64 bf16 so that the 8 rows an `ldmatrix` reads fall on distinct banks.
//
// Each variant's output is the TPU's: (cin, 9 cout) for T1, (cout, 9 cin)
// for T3, with the nine taps along the wide dimension.  A block owns one
// tile of it, 64 channels of the operand read in place (the narrow
// dimension) by 192 columns of the nine taps of the
// shifted one (the wide dimension; each tap's channels padded to a multiple
// of 8, so that no 8-wide fragment straddles two taps), and one (sample, row
// tile) of th rows x W pixels, the TPU's grid step.  The TPU carried its sum
// from one grid step to the next in its output block; Hopper blocks run in
// no order, so each block writes an f32 partial for its row tile and a
// second pass adds the row tiles in a fixed order while it reshapes to
// (3, 3, Cin, Cout): no float atomics, the same result on every run.
// Splitting the output as well as the rows gives 180-708 blocks at the
// sweep's shapes, against 118 or 60 row tiles.
//
// Inside a block the pixels go in steps of one image row segment of 64
// pixels.  The shifted operand sits in a ring of three halo rows (the rows
// above, at and below the step's row, 66 pixels each); walking down the
// row tile, each step loads one new halo row and the step's row of the
// other operand.  Pixels off the map, past W and past h (the TPU's pad
// rows) are zero in shared memory; nothing padded is stored in device
// memory.  T1 then copies the block's 192 columns of the nine shifted
// views into a column buffer (64 x 192) and multiplies it; T3 points
// `ldmatrix` at the shifted views of the halo rows directly.  Loads are
// 16 bytes where channel counts and pointers allow, else element by
// element.  Correct first: no cp.async, TMA or wgmma yet.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;  // 8 warps
constexpr int kPix = 64;       // pixels per step (one row segment), 4 mma k-steps
constexpr int kHalo = kPix + 2;
constexpr int kNarrow = 64;    // channels of the in-place operand per block
constexpr int kWide = 192;     // columns of the nine taps per block
constexpr int kPlainStride = kNarrow + 8;
constexpr int kColStride = kWide + 8;
constexpr int kMaxChannels = 256;

enum { kGcol = 1, kGt9 = 3 };

template <int V>
struct Form {
  static constexpr bool kShiftG = V == kGcol;  // g shifted (T1); x shifted (T3)
  static constexpr bool kViews = V == kGt9;    // halo views (T3); a column buffer (T1)
  static constexpr int kBM = kNarrow;          // the taps along N
  static constexpr int kBN = kWide;
  static constexpr int kWarpsM = 2;
  static constexpr int kWarpsN = kThreads / 32 / kWarpsM;
  static constexpr int kWM = kBM / kWarpsM, kWN = kBN / kWarpsN;  // a warp's tile
  static constexpr int kMT = kWM / 16, kNT = kWN / 8;             // its m16 and n8 tiles
  static_assert(kNT % 2 == 0, "B fragments load two n8 tiles at a time");
};

struct Args {
  const bf16* plain;  // operand read in place (x for T1, g otherwise), (B, H, W, Cn)
  const bf16* shift;  // operand shifted per tap (g for T1, x otherwise), (B, H, W, Cs)
  float* part;        // (B * row_tiles, Cn * 9 * Cs), in the variants' orientation
  int H, W, Cn, Cs, Cs8, th, row_tiles, narrow_tiles, halo_stride;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Pixels col0 .. col0+npix-1 of image row `row` of one sample (src points at
// the sample), channels ch0 .. ch0+nch-1 (nch a multiple of 8), into npix
// shared-memory rows of `stride` bf16; zero off the map and past C.
template <bool kVec>
__device__ __forceinline__ void stage_row(bf16* dst, int stride, const bf16* __restrict__ src,
                                          int row, int col0, int npix, int ch0, int nch, int C,
                                          int H, int W) {
  const int groups = nch / 8;
  const bool row_in = row >= 0 && row < H;
  for (int i = threadIdx.x; i < npix * groups; i += kThreads) {
    const int p = i / groups, c = ch0 + (i - p * groups) * 8;
    const int col = col0 + p;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row_in && col >= 0 && col < W) {
      const bf16* s = src + ((size_t)row * W + col) * C + c;
      if (kVec) {  // C is a multiple of 8: the group is all in or all out
        if (c < C) v = __ldg(reinterpret_cast<const uint4*>(s));
      } else {
        bf16* e = reinterpret_cast<bf16*>(&v);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (c + j < C) e[j] = s[j];
      }
    }
    *reinterpret_cast<uint4*>(dst + p * stride + (c - ch0)) = v;
  }
}

template <int V, bool kVec>
__global__ void __launch_bounds__(kThreads, 2) wgrad_partial_kernel(Args a) {
  typedef Form<V> F;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* halo = reinterpret_cast<bf16*>(smem_raw);  // [3 slots][kHalo pixels][halo_stride]
  bf16* plain_s = halo + 3 * kHalo * a.halo_stride;  // [kPix][kPlainStride]
  bf16* col_s = plain_s + kPix * kPlainStride;       // [kPix][kColStride] (T1)

  const int ntile = blockIdx.x % a.narrow_tiles, wtile = blockIdx.x / a.narrow_tiles;
  const int n0 = ntile * kNarrow, w0 = wtile * kWide;  // first narrow channel, first wide column
  const int s = blockIdx.y, b = s / a.row_tiles;
  const int r0 = (s - b * a.row_tiles) * a.th, r1 = min(a.H, r0 + a.th);
  const bf16* plain = a.plain + (size_t)b * a.H * a.W * a.Cn;
  const bf16* shift = a.shift + (size_t)b * a.H * a.W * a.Cs;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = (warp % F::kWarpsM) * F::kWM, wn = (warp / F::kWarpsM) * F::kWN;
  const int lrow = lane & 7, lmat = lane >> 3;  // the row and matrix this lane gives ldmatrix

  float acc[F::kMT][F::kNT][4];
#pragma unroll
  for (int i = 0; i < F::kMT; ++i)
#pragma unroll
    for (int j = 0; j < F::kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  // halo row of image row q, for rows r0 - 1 .. r1 of this row tile
  const int hs = a.halo_stride;
  auto slot = [=](int q) { return halo + (q - r0 + 1) % 3 * kHalo * hs; };
  // the row and pixel offsets into the halo of a tap's shifted view
  auto tap_view = [](int tap, int& hr, int& hp) {
    const int dy = tap / 3, dx = tap - 3 * (tap / 3);
    hr = F::kShiftG ? 2 - dy : dy;  // T1 reads g at (h + 1 - dy, w + 1 - dx)
    hp = F::kShiftG ? 2 - dx : dx;  // the others x at (h + dy - 1, w + dx - 1)
  };
  // T3: the halo row and the offset in it at which each of this lane's B
  // loads starts (its tap's view, its 8 channels); the same on every step
  int view_hr[F::kNT / 2], view_off[F::kNT / 2];
#pragma unroll
  for (int j = 0; j < F::kNT / 2; ++j) {
    const int w = w0 + wn + j * 16 + (lmat >> 1) * 8;
    int tap = w / a.Cs8, ch = w - tap * a.Cs8;
    if (tap > 8) {  // past the ninth tap: read anything, never written out
      tap = 8;
      ch = 0;
    }
    int hp;
    tap_view(tap, view_hr[j], hp);
    view_off[j] = hp * a.halo_stride + ch;
  }

  for (int c0 = 0; c0 < a.W; c0 += kPix) {
    stage_row<kVec>(slot(r0 - 1), a.halo_stride, shift, r0 - 1, c0 - 1, kHalo, 0, a.Cs8, a.Cs,
                    a.H, a.W);
    stage_row<kVec>(slot(r0), a.halo_stride, shift, r0, c0 - 1, kHalo, 0, a.Cs8, a.Cs, a.H,
                    a.W);
    for (int r = r0; r < r1; ++r) {
      stage_row<kVec>(slot(r + 1), a.halo_stride, shift, r + 1, c0 - 1, kHalo, 0, a.Cs8, a.Cs,
                      a.H, a.W);
      stage_row<kVec>(plain_s, kPlainStride, plain, r, c0, kPix, n0, kNarrow, a.Cn, a.H, a.W);
      __syncthreads();
      if (!F::kViews) {  // the block's columns of the nine shifted views, side by side
        for (int i = threadIdx.x; i < kPix * (kWide / 8); i += kThreads) {
          const int p = i / (kWide / 8), j = (i - p * (kWide / 8)) * 8;
          const int w = w0 + j, tap = w / a.Cs8;
          uint4 v = make_uint4(0u, 0u, 0u, 0u);
          if (tap < 9) {
            int hr, hp;
            tap_view(tap, hr, hp);
            v = *reinterpret_cast<const uint4*>(slot(r - 1 + hr) + (p + hp) * a.halo_stride +
                                                (w - tap * a.Cs8));
          }
          *reinterpret_cast<uint4*>(col_s + p * kColStride + j) = v;
        }
        __syncthreads();
      }

      const bf16* rows[3] = {slot(r - 1), slot(r), slot(r + 1)};

#pragma unroll
      for (int kk = 0; kk < kPix; kk += 16) {
        // A (m16 x k16) from [k][m] storage: matrices (k, m), (k, m+8), (k+8, m), (k+8, m+8)
        uint32_t af[F::kMT][4];
#pragma unroll
        for (int i = 0; i < F::kMT; ++i) {
          const int k = kk + lrow + (lmat >> 1) * 8, m = wm + i * 16 + (lmat & 1) * 8;
          ldmatrix_x4_trans(af[i], plain_s + k * kPlainStride + m);
        }
        // B (k16 x two n8) from [k][n] storage: matrices (k, n), (k+8, n), (k, n+8), (k+8, n+8)
        uint32_t bfr[F::kNT / 2][4];
#pragma unroll
        for (int j = 0; j < F::kNT / 2; ++j) {
          const int k = kk + lrow + (lmat & 1) * 8, n = wn + j * 16 + (lmat >> 1) * 8;
          const bf16* p;
          if (F::kViews)  // the tap's shifted view of the halo rows
            p = (view_hr[j] == 0 ? rows[0] : view_hr[j] == 1 ? rows[1] : rows[2]) +
                k * a.halo_stride + view_off[j];
          else
            p = col_s + k * kColStride + n;
          ldmatrix_x4_trans(bfr[j], p);
        }
#pragma unroll
        for (int i = 0; i < F::kMT; ++i)
#pragma unroll
          for (int j = 0; j < F::kNT; ++j)
            mma_bf16(acc[i][j], af[i], bfr[j / 2][(j & 1) * 2], bfr[j / 2][(j & 1) * 2 + 1]);
      }
      __syncthreads();
    }
  }

  // this row tile's partial, in the variant's orientation: (narrow, 9 wide)
  float* out = a.part + (size_t)s * 9 * a.Cn * a.Cs;
  const int gid = lane >> 2, tid4 = lane & 3;
#pragma unroll
  for (int i = 0; i < F::kMT; ++i)
#pragma unroll
    for (int j = 0; j < F::kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = wm + i * 16 + gid + (e >> 1) * 8, n = wn + j * 8 + tid4 * 2 + (e & 1);
        const int nc = n0 + m, w = w0 + n;
        const int tap = w / a.Cs8, ch = w - tap * a.Cs8;
        if (tap > 8 || ch >= a.Cs || nc >= a.Cn) continue;
        out[(size_t)nc * 9 * a.Cs + tap * a.Cs + ch] = acc[i][j][e];
      }
}

// dw[tap, ci, co] = sum over row tiles t = 0, 1, ... of part[t], in that
// order, read in the variant's orientation.
template <int V>
__global__ void wgrad_reduce_kernel(const float* __restrict__ part, float* __restrict__ dw,
                                    int tiles, int Cn, int Cs) {
  typedef Form<V> F;
  const long long n = 9LL * Cn * Cs;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float sum = 0.f;
  for (int t = 0; t < tiles; ++t) sum += part[(size_t)t * n + i];
  const int nc = (int)(i / (9LL * Cs)), w = (int)(i % (9LL * Cs));
  const int tap = w / Cs, ch = w % Cs;
  // T1 reads x in place (narrow = Cin); T3 g (narrow = Cout)
  const int ci = F::kShiftG ? nc : ch, co = F::kShiftG ? ch : nc;
  const int Cin = F::kShiftG ? Cn : Cs, Cout = F::kShiftG ? Cs : Cn;
  dw[((size_t)tap * Cin + ci) * Cout + co] = sum;
}

template <int V, bool kVec>
cudaError_t launch_partial(const Args& a, dim3 grid, size_t smem, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(wgrad_partial_kernel<V, kVec>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  wgrad_partial_kernel<V, kVec><<<grid, kThreads, smem, st>>>(a);
  return cudaGetLastError();
}

template <int V>
int wgrad(const void* x, const void* g, void* part, void* dw, int B, int H, int W, int Cin,
          int Cout, int th, void* stream) {
  typedef Form<V> F;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || H <= 0 || W <= 0 || th <= 0 || Cin <= 0 || Cout <= 0 || Cin > kMaxChannels ||
      Cout > kMaxChannels)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.plain = static_cast<const bf16*>(F::kShiftG ? x : g);
  a.shift = static_cast<const bf16*>(F::kShiftG ? g : x);
  a.part = static_cast<float*>(part);
  a.H = H, a.W = W, a.th = th;
  a.Cn = F::kShiftG ? Cin : Cout;
  a.Cs = F::kShiftG ? Cout : Cin;
  a.Cs8 = (a.Cs + 7) / 8 * 8;
  a.halo_stride = (a.Cs8 + 63) / 64 * 64 + 8;
  a.row_tiles = (H + th - 1) / th;
  a.narrow_tiles = (a.Cn + kNarrow - 1) / kNarrow;
  const int wide_tiles = (9 * a.Cs8 + kWide - 1) / kWide;
  const long long tiles = (long long)B * a.row_tiles;
  if (tiles > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid(a.narrow_tiles * wide_tiles, (unsigned)tiles);
  const size_t smem = sizeof(bf16) * (3 * kHalo * a.halo_stride + kPix * kPlainStride +
                                      (F::kViews ? 0 : kPix * kColStride));
  const bool vec = a.Cn % 8 == 0 && a.Cs % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(g) % 16 == 0;
  cudaError_t err = vec ? launch_partial<V, true>(a, grid, smem, st)
                        : launch_partial<V, false>(a, grid, smem, st);
  if (err != cudaSuccess) return (int)err;
  const long long n = 9LL * Cin * Cout;
  wgrad_reduce_kernel<V><<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
      a.part, static_cast<float*>(dw), (int)tiles, a.Cn, a.Cs);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (B, H, W, Cin), g: (B, H, W, Cout), bfloat16, contiguous; part: (B *
// ceil(H / th), 9 * Cin * Cout) f32 scratch; dw: (3, 3, Cin, Cout) f32.
// Cin and Cout at most 256.  Each returns a cudaError_t.
extern "C" int t1_wgrad_gcol(const void* x, const void* g, void* part, void* dw, int B, int H,
                             int W, int Cin, int Cout, int th, void* stream) {
  return wgrad<kGcol>(x, g, part, dw, B, H, W, Cin, Cout, th, stream);
}

extern "C" int t3_wgrad_gt9(const void* x, const void* g, void* part, void* dw, int B, int H,
                            int W, int Cin, int Cout, int th, void* stream) {
  return wgrad<kGt9>(x, g, part, dw, B, H, W, Cin, Cout, th, stream);
}
