// K1: per-row run totals over pillar-sorted rows, and the fused backward of
// the max.
//
// Replaces com_tpu/ops/pallas/seg_scan.py `_run_bcast_pallas` (`_fwd_kernel`
// and `_rev_kernel`): for vals (B, N, C) and per-sample sorted segment ids
// seg (B, N), out[b, i] = sum or max of vals[b, j] over all j with
// seg[b, j] == seg[b, i].  Op 2 of `k1_call` is the VJP of the max
// (seg_scan.py:284-299) in one pass: for each run and channel gsum = sum g
// and nties = number of rows with vals == out, both in f32, then
// dvals = (vals == out) ? gsum / max(nties, 1) : 0, rounded once.
//
// What bounds it on an H100: bytes.  The work is one read of vals and seg
// and one write of out, a few operations per element: at (2, 163840, 32)
// bf16 about 42 MB, 13 us at 3.35 TB/s; the backward reads g, vals and out,
// about 25 us.  Pillar runs are short (1.85 rows on average, a few dozen at
// most) but a run may also cover a whole sample (a padded, empty scene), so
// no thread may walk a run.
//
// Design.  The TPU kernel carried a (1, C) total from one grid step to the
// next; Hopper blocks run in no order, so the carries across tiles are a
// scan over per-tile partials, and three launches make a call:
//   * k1_main: a block takes a tile of rows of one sample and a group of
//     channels.  A thread owns one 16-byte channel vector (8 bf16 or 4 f32)
//     of kRows consecutive rows: it loads them with 16-byte loads (element
//     loads where the row is no multiple of 16 bytes or a pointer is off 16
//     bytes), all at once, and folds them in registers into the totals of
//     its pieces (the stretches of equal ids among its rows).  Across the
//     threads of the tile the pieces' carries are two segmented scans keyed
//     by the ids, forward over each thread's last piece and in reverse over
//     its first: `__shfl_up_sync` / `__shfl_down_sync` within a warp, then
//     one warp over the warps' aggregates.  Every row whose run lies within
//     the tile so gets its total from one read and is written; the tile's
//     first and last runs leave their totals within the tile as the `head`
//     and `tail` partials.
//   * k1_carries: for each sample and channel, the same segmented scans
//     over the tiles' partials, keyed by the tiles' edge ids (one tile a
//     thread): what the tiles on either side hold of the runs that cross
//     each edge.
//   * k1_fixup writes the rows of the runs that cross a tile's edge: the
//     tile's partial plus the carries.  That is a couple of rows a tile on
//     real scenes; a whole-sample run has every row of a tile written there
//     instead of in k1_main, so every row is still read and written once
//     (the backward keeps a crossing row's ties in dvals as 1 / 0 meanwhile).
//   * k1_carries and k1_fixup are launched as programmatic dependents
//     (griddepcontrol), so each is in place when its predecessor ends.
// No thread walks a run: a run as long as the sample is a few scan steps.
// Why not one launch with a look-back over the tiles' partials: a tile's
// last run may continue into later tiles, so the tile would wait on tiles
// after it; on a whole-sample run every resident block would wait on tiles
// not yet resident (320 tiles at the path's shape against 264 resident
// blocks), and k1_main alone takes 70-77 % of a call's device time.
// One machinery serves the three functions through a combine: sum, max, or
// the pair (sum of g, count of tied maxima).  Max is exact; sums are f32
// and differ from a sequential sum by rounding only, in an order fixed by
// the tile shapes.  For max a non-finite total becomes 0, as in the plain
// version.  `k1_call` is the one entry point.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;        // k1_main, k1_fixup: threads a block
constexpr int kFwdRows = 8;          // rows a thread, forward
constexpr int kBwdRows = 4;          // rows a thread, max backward
constexpr int kMinBlocks = 2;        // k1_main: resident blocks an SM the registers must allow
constexpr int kCarryThreads = 1024;  // k1_carries: one tile a thread up to 1024 tiles
constexpr int kWarps = kThreads / 32;
constexpr int kSlots = 32 / kWarps;  // channel vectors a block: warp 0 scans kWarps x kSlots
constexpr unsigned kFull = 0xffffffffu;

// ---- combines ------------------------------------------------------------

struct SumOp {
  typedef float V;
  static __device__ __forceinline__ V ident() { return 0.f; }
  static __device__ __forceinline__ V comb(V a, V b) { return a + b; }
};

struct MaxOp {
  typedef float V;
  static __device__ __forceinline__ V ident() { return -INFINITY; }
  static __device__ __forceinline__ V comb(V a, V b) { return fmaxf(a, b); }
};

struct PairOp {  // (sum of g, count of tied maxima)
  typedef float2 V;
  static __device__ __forceinline__ V ident() { return make_float2(0.f, 0.f); }
  static __device__ __forceinline__ V comb(V a, V b) { return make_float2(a.x + b.x, a.y + b.y); }
};

__device__ __forceinline__ float shfl_up(float v, int d) { return __shfl_up_sync(kFull, v, d); }
__device__ __forceinline__ float shfl_down(float v, int d) {
  return __shfl_down_sync(kFull, v, d);
}
__device__ __forceinline__ float2 shfl_up(float2 v, int d) {
  return make_float2(shfl_up(v.x, d), shfl_up(v.y, d));
}
__device__ __forceinline__ float2 shfl_down(float2 v, int d) {
  return make_float2(shfl_down(v.x, d), shfl_down(v.y, d));
}

// ---- 16 bytes of one row ---------------------------------------------------

// Four words: 4 f32, or 8 bf16 two to a word (the even element in the low
// half).
struct Pack {
  uint32_t w[4];
};

template <typename T> struct Row16;

template <> struct Row16<float> {
  static constexpr int kVec = 4;
  static __device__ __forceinline__ void unpack(const Pack& p, float (&x)[4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = __uint_as_float(p.w[i]);
  }
  static __device__ __forceinline__ Pack pack(const float (&x)[4]) {
    Pack p;
#pragma unroll
    for (int i = 0; i < 4; ++i) p.w[i] = __float_as_uint(x[i]);
    return p;
  }
  static __device__ __forceinline__ uint32_t get(const float* e) { return __float_as_uint(*e); }
  static __device__ __forceinline__ void set(float* e, uint32_t b) { *e = __uint_as_float(b); }
  static __device__ __forceinline__ uint32_t elem(const Pack& p, int i) { return p.w[i]; }
  static __device__ __forceinline__ void put(Pack& p, int i, uint32_t b) { p.w[i] = b; }
};

template <> struct Row16<__nv_bfloat16> {
  static constexpr int kVec = 8;
  static __device__ __forceinline__ void unpack(const Pack& p, float (&x)[8]) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      __nv_bfloat162 h;
      memcpy(&h, &p.w[j], 4);
      const float2 f = __bfloat1622float2(h);
      x[2 * j] = f.x;
      x[2 * j + 1] = f.y;
    }
  }
  static __device__ __forceinline__ Pack pack(const float (&x)[8]) {
    Pack p;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(x[2 * j], x[2 * j + 1]);
      memcpy(&p.w[j], &h, 4);
    }
    return p;
  }
  static __device__ __forceinline__ uint32_t get(const __nv_bfloat16* e) {
    return __bfloat16_as_ushort(*e);
  }
  static __device__ __forceinline__ void set(__nv_bfloat16* e, uint32_t b) {
    *e = __ushort_as_bfloat16((unsigned short)b);
  }
  static __device__ __forceinline__ uint32_t elem(const Pack& p, int i) {
    return p.w[i >> 1] >> (i & 1) * 16 & 0xffffu;
  }
  static __device__ __forceinline__ void put(Pack& p, int i, uint32_t b) {
    p.w[i >> 1] = (i & 1) ? (p.w[i >> 1] & 0xffffu) | b << 16 : (p.w[i >> 1] & 0xffff0000u) | b;
  }
};

// The 16 bytes at channel c0 of a row: one vector load, or element loads
// (zeros past C).
template <typename T>
__device__ __forceinline__ Pack load16(const T* row, int c0, int C, bool vec) {
  Pack p;
  if (vec) {
    const int4 q = __ldcs(reinterpret_cast<const int4*>(row + c0));
    p.w[0] = q.x, p.w[1] = q.y, p.w[2] = q.z, p.w[3] = q.w;
  } else {
    p.w[0] = p.w[1] = p.w[2] = p.w[3] = 0;
#pragma unroll
    for (int i = 0; i < Row16<T>::kVec; ++i)
      if (c0 + i < C) Row16<T>::put(p, i, Row16<T>::get(row + c0 + i));
  }
  return p;
}

template <typename T>
__device__ __forceinline__ void store16(T* row, int c0, int C, bool vec, const Pack& p) {
  if (vec) {
    __stcs(reinterpret_cast<int4*>(row + c0), make_int4(p.w[0], p.w[1], p.w[2], p.w[3]));
  } else {
#pragma unroll
    for (int i = 0; i < Row16<T>::kVec; ++i)
      if (c0 + i < C) Row16<T>::set(row + c0 + i, Row16<T>::elem(p, i));
  }
}

// ---- what is reduced, and what a row gets back -----------------------------

// run_bcast: the value is the row itself; the output is the run's total.
template <typename T, typename O, bool kIsMax>
struct FwdTask {
  typedef O Op;
  typedef typename O::V V;
  static constexpr int kVec = Row16<T>::kVec;
  static constexpr int kRows = kFwdRows;
  struct Raw { Pack v; };
  struct Aux {};
  const T* vals;
  T* out;
  __device__ __forceinline__ void fetch(size_t row, int c0, int C, bool vec, Raw& r) const {
    r.v = load16(vals + row * C, c0, C, vec);
  }
  __device__ __forceinline__ void unpack(const Raw& r, V (&x)[kVec], Aux&) const {
    Row16<T>::unpack(r.v, x);
  }
  __device__ __forceinline__ void finish(size_t row, int c0, int C, bool vec,
                                         const V (&tot)[kVec], const Aux&) const {
    float y[kVec];
#pragma unroll
    for (int i = 0; i < kVec; ++i) y[i] = kIsMax && !isfinite(tot[i]) ? 0.f : tot[i];
    store16(out + row * C, c0, C, vec, Row16<T>::pack(y));
  }
  // a row whose total k1_fixup writes: nothing to keep
  __device__ __forceinline__ void mark(size_t, int, int, bool, const Aux&) const {}
  __device__ __forceinline__ Aux unmark(size_t, int, int, bool) const { return Aux{}; }
};

// The max backward: the value is (g, [vals == out]); a row gets gsum / nties where
// it holds a maximum.
template <typename T>
struct MaxBwdTask {
  typedef PairOp Op;
  typedef float2 V;
  static constexpr int kVec = Row16<T>::kVec;
  static constexpr int kRows = kBwdRows;
  struct Raw { Pack g, v, o; };
  struct Aux { uint32_t tie; };
  const T* g;
  const T* vals;
  const T* out;
  T* dvals;
  __device__ __forceinline__ void fetch(size_t row, int c0, int C, bool vec, Raw& r) const {
    r.g = load16(g + row * C, c0, C, vec);
    r.v = load16(vals + row * C, c0, C, vec);
    r.o = load16(out + row * C, c0, C, vec);
  }
  __device__ __forceinline__ void unpack(const Raw& r, V (&x)[kVec], Aux& a) const {
    float gf[kVec], vf[kVec], of[kVec];
    Row16<T>::unpack(r.g, gf);
    Row16<T>::unpack(r.v, vf);
    Row16<T>::unpack(r.o, of);
    a.tie = 0;
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      a.tie |= (uint32_t)(vf[i] == of[i]) << i;
      x[i] = make_float2(gf[i], vf[i] == of[i] ? 1.f : 0.f);
    }
  }
  __device__ __forceinline__ void finish(size_t row, int c0, int C, bool vec,
                                         const V (&tot)[kVec], const Aux& a) const {
    float y[kVec];
#pragma unroll
    for (int i = 0; i < kVec; ++i)
      y[i] = (a.tie >> i & 1u) ? __fdividef(tot[i].x, fmaxf(tot[i].y, 1.f)) : 0.f;
    store16(dvals + row * C, c0, C, vec, Row16<T>::pack(y));
  }
  // a row whose total k1_fixup writes keeps its ties in dvals as 1 / 0
  __device__ __forceinline__ void mark(size_t row, int c0, int C, bool vec, const Aux& a) const {
    float y[kVec];
#pragma unroll
    for (int i = 0; i < kVec; ++i) y[i] = (a.tie >> i & 1u) ? 1.f : 0.f;
    store16(dvals + row * C, c0, C, vec, Row16<T>::pack(y));
  }
  __device__ __forceinline__ Aux unmark(size_t row, int c0, int C, bool vec) const {
    float y[kVec];
    Row16<T>::unpack(load16(dvals + row * C, c0, C, vec), y);
    Aux a{0};
#pragma unroll
    for (int i = 0; i < kVec; ++i) a.tie |= (uint32_t)(y[i] != 0.f) << i;
    return a;
  }
};

// ---- the machinery -----------------------------------------------------------

// Channel vectors a block spans (a power of two, at most kSlots), hence the
// tile: kThreads / slots threads along the rows.
template <class Task>
__host__ __device__ __forceinline__ int group_slots(int C) {
  const int v = (C + Task::kVec - 1) / Task::kVec;
  int p = 1;
  while (p < v && p < kSlots) p <<= 1;
  return p;
}

template <class Task>
__host__ __device__ __forceinline__ int tile_rows(int C) {
  return kThreads / group_slots<Task>(C) * Task::kRows;
}

struct Geo {  // where a thread sits
  int t, b, lane, warp, vpg, vl, chunk, nch, tr, c0, r0, nv;
  bool active;
};

template <class Task>
__device__ __forceinline__ Geo geo(int N, int C, int vpg) {
  Geo g;
  g.t = blockIdx.x;
  g.b = blockIdx.y;
  g.lane = threadIdx.x & 31;
  g.warp = threadIdx.x >> 5;
  g.vpg = vpg;
  g.vl = threadIdx.x & (vpg - 1);
  g.chunk = threadIdx.x / vpg;  // a warp holds 32 / vpg consecutive chunks
  g.nch = kThreads / vpg;
  g.tr = g.nch * Task::kRows;
  g.c0 = (blockIdx.z * vpg + g.vl) * Task::kVec;
  g.active = g.c0 < C;
  g.r0 = g.t * g.tr;
  g.nv = min(g.tr, N - g.r0);
  return g;
}

__device__ __forceinline__ void griddep_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}
__device__ __forceinline__ void griddep_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// Segmented scans keyed by sorted ids over lanes [0, n) of a warp, a channel
// vector every vpg lanes, forward over (fid, fv) and in reverse over
// (rid, rv), exclusive: on return (fid, fv) is what the earlier lanes hold of
// the run of the returned fid, (rid, rv) what the later lanes hold of the run
// of rid; identity values (id INT_MIN) where no lane lies on that side.
template <class Op, int VEC>
__device__ __forceinline__ void warp_scans(int lane, int vpg, int n, int& fid,
                                           typename Op::V (&fv)[VEC], int& rid,
                                           typename Op::V (&rv)[VEC]) {
  for (int off = vpg; off < n; off <<= 1) {
    const int ofid = __shfl_up_sync(kFull, fid, off);
    const int orid = __shfl_down_sync(kFull, rid, off);
    const bool fin = lane >= off && ofid == fid, rin = lane + off < n && orid == rid;
    // runs are short: most steps move no value in the whole warp
    if (__any_sync(kFull, fin))
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const typename Op::V fo = shfl_up(fv[i], off);
        if (fin) fv[i] = Op::comb(fo, fv[i]);
      }
    if (__any_sync(kFull, rin))
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const typename Op::V ro = shfl_down(rv[i], off);
        if (rin) rv[i] = Op::comb(rv[i], ro);
      }
  }
  const int xf = __shfl_up_sync(kFull, fid, vpg), xr = __shfl_down_sync(kFull, rid, vpg);
  const bool fhas = lane >= vpg, rhas = lane + vpg < n;
  fid = fhas ? xf : INT_MIN;
  rid = rhas ? xr : INT_MIN;
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    const typename Op::V fo = shfl_up(fv[i], vpg), ro = shfl_down(rv[i], vpg);
    fv[i] = fhas ? fo : Op::ident();
    rv[i] = rhas ? ro : Op::ident();
  }
}

// The two exclusive segmented scans over the chunks of a block: forward over
// each chunk's last piece (fid, fv) gives (xf, xfv), what the earlier chunks
// hold of the run of xf; in reverse over its first piece (rid, rv) gives
// (xr, xrv), what the later chunks hold of the run of xr.  Within each warp
// by shuffles; then warp 0 scans the NW warps' aggregates in shared memory
// (NW * vpg <= 32 lanes), in place.
template <class Op, int VEC, int NW>
__device__ __forceinline__ void block_scans(const Geo& g, int fid,
                                            const typename Op::V (&fv)[VEC], int rid,
                                            const typename Op::V (&rv)[VEC],
                                            int (*s_fid)[kSlots],
                                            typename Op::V (*s_fv)[kSlots][VEC],
                                            int (*s_rid)[kSlots],
                                            typename Op::V (*s_rv)[kSlots][VEC], int& xf,
                                            typename Op::V (&xfv)[VEC], int& xr,
                                            typename Op::V (&xrv)[VEC]) {
  typedef typename Op::V V;
  xf = fid;
  xr = rid;
#pragma unroll
  for (int i = 0; i < VEC; ++i) xfv[i] = fv[i], xrv[i] = rv[i];
  warp_scans<Op, VEC>(g.lane, g.vpg, 32, xf, xfv, xr, xrv);
  // a warp's aggregates: its last chunk's run (forward), its first chunk's
  // (reverse), each the chunk's piece and what the warp holds beside it
  if (g.lane >= 32 - g.vpg) {
    s_fid[g.warp][g.vl] = fid;
#pragma unroll
    for (int i = 0; i < VEC; ++i) s_fv[g.warp][g.vl][i] = xf == fid ? Op::comb(xfv[i], fv[i]) : fv[i];
  }
  if (g.lane < g.vpg) {
    s_rid[g.warp][g.vl] = rid;
#pragma unroll
    for (int i = 0; i < VEC; ++i) s_rv[g.warp][g.vl][i] = xr == rid ? Op::comb(rv[i], xrv[i]) : rv[i];
  }
  __syncthreads();
  if (g.warp == 0) {
    const int n = NW * g.vpg, w = g.lane / g.vpg;
    const bool in = g.lane < n;
    int wf = in ? s_fid[w][g.vl] : INT_MIN, wr = in ? s_rid[w][g.vl] : INT_MIN;
    V wfv[VEC], wrv[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      wfv[i] = in ? s_fv[w][g.vl][i] : Op::ident();
      wrv[i] = in ? s_rv[w][g.vl][i] : Op::ident();
    }
    warp_scans<Op, VEC>(g.lane, g.vpg, n, wf, wfv, wr, wrv);
    if (in) {
      s_fid[w][g.vl] = wf;
      s_rid[w][g.vl] = wr;
#pragma unroll
      for (int i = 0; i < VEC; ++i) s_fv[w][g.vl][i] = wfv[i], s_rv[w][g.vl][i] = wrv[i];
    }
  }
  __syncthreads();
  // the other warps' share joins where the run reaches this chunk
  const int pf = s_fid[g.warp][g.vl], pr = s_rid[g.warp][g.vl];
  const bool first = g.lane < g.vpg, last = g.lane >= 32 - g.vpg;
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    const V pfv = s_fv[g.warp][g.vl][i], prv = s_rv[g.warp][g.vl][i];
    xfv[i] = first ? pfv : xf == pf ? Op::comb(pfv, xfv[i]) : xfv[i];
    xrv[i] = last ? prv : xr == pr ? Op::comb(xrv[i], prv) : xrv[i];
  }
  if (first) xf = pf;
  if (last) xr = pr;
}

// The tile's rows: every row whose run lies within the tile gets its total;
// the totals within the tile of its first and last runs go to head and
// tail, and the rows of a run that crosses an edge are left to k1_fixup.
template <class Task>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
k1_main(Task task, const int* __restrict__ seg, typename Task::V* __restrict__ head,
        typename Task::V* __restrict__ tail, int N, int C, int nt, int vpg, int vec) {
  typedef typename Task::Op Op;
  typedef typename Task::V V;
  constexpr int R = Task::kRows, VEC = Task::kVec;
  __shared__ int s_seg[kThreads * R];
  __shared__ int s_fid[kWarps][kSlots], s_rid[kWarps][kSlots];
  __shared__ V s_fv[kWarps][kSlots][VEC], s_rv[kWarps][kSlots][VEC];
  const Geo g = geo<Task>(N, C, vpg);
  const int* sb = seg + (size_t)g.b * N;
  const size_t row0 = (size_t)g.b * N + g.r0;
  typename Task::Raw raw[R];
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int r = g.chunk * R + k;
    if (g.active && r < g.nv) task.fetch(row0 + r, g.c0, C, vec, raw[k]);
  }
  for (int i = threadIdx.x; i < g.tr; i += kThreads)
    s_seg[i] = i < g.nv ? __ldg(sb + g.r0 + i) : INT_MAX;
  // the runs that cross the tile's edges: their rows are k1_fixup's
  const int s0 = __ldg(sb + g.r0), sl = __ldg(sb + g.r0 + g.nv - 1);
  const bool cross_l = g.r0 > 0 && __ldg(sb + g.r0 - 1) == s0;
  const bool cross_r = g.r0 + g.nv < N && __ldg(sb + g.r0 + g.nv) == sl;
  __syncthreads();

  V x[R][VEC];
  int id[R];
  typename Task::Aux aux[R];
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int r = g.chunk * R + k;
    id[k] = s_seg[r];
    if (g.active && r < g.nv) {
      task.unpack(raw[k], x[k], aux[k]);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) x[k][i] = Op::ident();
    }
  }
  // fold the thread's rows: running totals forward, then each piece's total
  // back over the piece
#pragma unroll
  for (int k = 1; k < R; ++k)
    if (id[k] == id[k - 1])
#pragma unroll
      for (int i = 0; i < VEC; ++i) x[k][i] = Op::comb(x[k - 1][i], x[k][i]);
#pragma unroll
  for (int k = R - 2; k >= 0; --k)
    if (id[k] == id[k + 1])
#pragma unroll
      for (int i = 0; i < VEC; ++i) x[k][i] = x[k + 1][i];
  const int id0 = id[0], idn = id[R - 1];  // the chunk's first and last pieces
  // the pieces between the first and the last are whole (a crossing run is
  // a first or a last piece): store them now
#pragma unroll
  for (int k = 1; k < R - 1; ++k) {
    const int r = g.chunk * R + k;
    if (g.active && r < g.nv && id[k] != id0 && id[k] != idn)
      task.finish(row0 + r, g.c0, C, vec, x[k], aux[k]);
  }
  // what the tile's other chunks hold of the first and the last piece's runs
  V hv[VEC], tv[VEC], ev[VEC], rv[VEC];
  int eid, rid;
#pragma unroll
  for (int i = 0; i < VEC; ++i) hv[i] = x[0][i], tv[i] = x[R - 1][i];
  block_scans<Op, VEC, kWarps>(g, idn, tv, id0, hv, s_fid, s_fv, s_rid, s_rv, eid, ev, rid, rv);
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    if (id0 == eid) hv[i] = Op::comb(ev[i], hv[i]);
    if (idn == rid) tv[i] = Op::comb(tv[i], rv[i]);
    if (id0 == idn) hv[i] = tv[i] = Op::comb(hv[i], id0 == rid ? rv[i] : Op::ident());
  }
  if (!g.active) return;
  const size_t at = ((size_t)g.b * nt + g.t) * C + g.c0;
  if (g.chunk == 0)  // the tile's first run, within the tile
#pragma unroll
    for (int i = 0; i < VEC; ++i)
      if (g.c0 + i < C) head[at + i] = hv[i];
  if (g.chunk == g.nch - 1)  // its last run (of a full tile)
#pragma unroll
    for (int i = 0; i < VEC; ++i)
      if (g.c0 + i < C) tail[at + i] = tv[i];
  const bool cross_h = (cross_l && id0 == s0) || (cross_r && id0 == sl);
  const bool cross_t = (cross_l && idn == s0) || (cross_r && idn == sl);
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int r = g.chunk * R + k;
    if (r >= g.nv) continue;
    const int idk = s_seg[r];
    if (idk == id0) {
      if (cross_h) task.mark(row0 + r, g.c0, C, vec, aux[k]);
      else task.finish(row0 + r, g.c0, C, vec, hv, aux[k]);
    } else if (idk == idn) {
      if (cross_t) task.mark(row0 + r, g.c0, C, vec, aux[k]);
      else task.finish(row0 + r, g.c0, C, vec, tv, aux[k]);
    }
  }
}

// The carries across tile edges, by the segmented scans over the tiles of
// one sample and channel (a block each), keyed by the tiles' last ids
// (forward, over the tail partials) and first ids (in reverse, over the head
// partials): carry_l[t] is what the tiles before t hold of the run tile t
// starts with, carry_r[t] what the tiles after t hold of the run it ends
// with.  They are read only where that run crosses the edge.
template <class Op>
__global__ void __launch_bounds__(kCarryThreads)
k1_carries(const int* __restrict__ seg, const typename Op::V* head, const typename Op::V* tail,
           typename Op::V* __restrict__ carry_l, typename Op::V* __restrict__ carry_r, int N,
           int C, int nt, int tr) {
  typedef typename Op::V V;
  constexpr int NW = kCarryThreads / 32;
  __shared__ int s_fid[NW][kSlots], s_rid[NW][kSlots];
  __shared__ V s_fv[NW][kSlots][1], s_rv[NW][kSlots][1];
  griddep_launch_dependents();
  const int c = blockIdx.x, b = blockIdx.y;
  Geo g = {};
  g.lane = threadIdx.x & 31;
  g.warp = threadIdx.x >> 5;
  g.vpg = 1;
  const int per = (nt + kCarryThreads - 1) / kCarryThreads;
  const int t0 = min((int)threadIdx.x * per, nt), t1 = min(t0 + per, nt);
  const int* sb = seg + (size_t)b * N;
  const size_t base = (size_t)b * nt * C + c;
  auto last_id = [&](int t) { return __ldg(sb + min((t + 1) * tr, N) - 1); };
  auto first_id = [&](int t) { return __ldg(sb + (size_t)t * tr); };
  griddep_wait();  // the partials come from k1_main
  // fold the thread's tiles, forward and in reverse
  int fid = INT_MIN, rid = INT_MIN;
  V fv[1] = {Op::ident()}, rv[1] = {Op::ident()};
  for (int t = t0; t < t1; ++t) {
    const int k = last_id(t);
    const V v = tail[base + (size_t)t * C];
    fv[0] = k == fid ? Op::comb(fv[0], v) : v;
    fid = k;
  }
  for (int t = t1 - 1; t >= t0; --t) {
    const int k = first_id(t);
    const V v = head[base + (size_t)t * C];
    rv[0] = k == rid ? Op::comb(v, rv[0]) : v;
    rid = k;
  }
  int xf, xr;
  V xfv[1], xrv[1];
  block_scans<Op, 1, NW>(g, fid, fv, rid, rv, s_fid, s_fv, s_rid, s_rv, xf, xfv, xr, xrv);
  for (int t = t0; t < t1; ++t) {
    const int k = last_id(t);
    const V v = tail[base + (size_t)t * C];
    xfv[0] = k == xf ? Op::comb(xfv[0], v) : v;
    xf = k;
    if (t + 1 < nt) carry_l[base + (size_t)(t + 1) * C] = xfv[0];
  }
  for (int t = t1 - 1; t >= t0; --t) {
    const int k = first_id(t);
    const V v = head[base + (size_t)t * C];
    xrv[0] = k == xr ? Op::comb(v, xrv[0]) : v;
    xr = k;
    if (t > 0) carry_r[base + (size_t)(t - 1) * C] = xrv[0];
  }
}

// The rows of the runs that cross the tile's edges: the tile's partial of
// the run plus the carries from the tiles on either side.  A couple of rows
// a tile on real scenes, every row of a tile inside one run.
template <class Task>
__global__ void __launch_bounds__(kThreads)
k1_fixup(Task task, const int* __restrict__ seg, const typename Task::V* head,
         const typename Task::V* tail, const typename Task::V* carry_l,
         const typename Task::V* carry_r, int N, int C, int nt, int vpg, int vec) {
  typedef typename Task::Op Op;
  typedef typename Task::V V;
  constexpr int R = Task::kRows, VEC = Task::kVec;
  const Geo g = geo<Task>(N, C, vpg);
  const int* sb = seg + (size_t)g.b * N;
  const int s0 = __ldg(sb + g.r0), sl = __ldg(sb + g.r0 + g.nv - 1);
  const bool cross_l = g.r0 > 0 && __ldg(sb + g.r0 - 1) == s0;
  const bool cross_r = g.r0 + g.nv < N && __ldg(sb + g.r0 + g.nv) == sl;
  if (!(cross_l || cross_r) || !g.active) return;
  const size_t row0 = (size_t)g.b * N + g.r0;
  bool in_h[R], in_t[R];
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int r = g.chunk * R + k;
    const int id = r < g.nv ? __ldg(sb + g.r0 + r) : 0;
    in_h[k] = r < g.nv && cross_l && id == s0;
    in_t[k] = r < g.nv && cross_r && id == sl;
  }
  griddep_wait();  // the carries come from k1_carries, the partials and marks from k1_main
  typename Task::Aux aux[R];
#pragma unroll
  for (int k = 0; k < R; ++k)
    if (in_h[k] || in_t[k]) aux[k] = task.unmark(row0 + g.chunk * R + k, g.c0, C, vec);
  const size_t at = ((size_t)g.b * nt + g.t) * C + g.c0;
  V h[VEC], t[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    const bool in = g.c0 + i < C;
    const V lc = cross_l && in ? carry_l[at + i] : Op::ident();
    const V rc = cross_r && in ? carry_r[at + i] : Op::ident();
    h[i] = Op::comb(lc, in ? head[at + i] : Op::ident());
    t[i] = Op::comb(in ? tail[at + i] : Op::ident(), rc);
    if (s0 == sl) h[i] = t[i] = Op::comb(h[i], rc);  // one run over the tile
  }
#pragma unroll
  for (int k = 0; k < R; ++k)
    if (in_h[k]) task.finish(row0 + g.chunk * R + k, g.c0, C, vec, h, aux[k]);
    else if (in_t[k]) task.finish(row0 + g.chunk * R + k, g.c0, C, vec, t, aux[k]);
}

template <class Task>
int launch(const Task& task, const int* seg, void* scratch, int B, int N, int C, bool vec,
           cudaStream_t st) {
  typedef typename Task::V V;
  typedef typename Task::Op Op;
  const int vpg = group_slots<Task>(C), tr = tile_rows<Task>(C);
  const int nt = (N + tr - 1) / tr;
  const int groups = ((C + Task::kVec - 1) / Task::kVec + vpg - 1) / vpg;
  const dim3 grid(nt, B, groups);
  const size_t part = (size_t)B * nt * C;
  V* head = static_cast<V*>(scratch);
  V* tail = head + part;
  V* carry_l = tail + part;
  V* carry_r = carry_l + part;
  k1_main<Task><<<grid, kThreads, 0, st>>>(task, seg, head, tail, N, C, nt, vpg, (int)vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // k1_carries and k1_fixup start as programmatic dependents (griddepcontrol)
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, B);
  cfg.blockDim = dim3(kCarryThreads);
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, k1_carries<Op>, seg, (const V*)head, (const V*)tail, carry_l,
                           carry_r, N, C, nt, tr);
  if (err != cudaSuccess) return (int)err;
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  err = cudaLaunchKernelEx(&cfg, k1_fixup<Task>, task, seg, (const V*)head, (const V*)tail,
                           (const V*)carry_l, (const V*)carry_r, N, C, nt, vpg, (int)vec);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <typename T>
int call(const void* g, const void* vals, const void* fwd, const int* seg, void* y, void* scratch,
         int B, int N, int C, int op, cudaStream_t st) {
  const T* v = static_cast<const T*>(vals);
  T* o = static_cast<T*>(y);
  bool vec = aligned16(vals) && aligned16(y) && (C * sizeof(T)) % 16 == 0;
  if (op == 2) {
    vec = vec && aligned16(g) && aligned16(fwd);
    MaxBwdTask<T> task{static_cast<const T*>(g), v, static_cast<const T*>(fwd), o};
    return launch(task, seg, scratch, B, N, C, vec, st);
  }
  if (op == 1) {
    FwdTask<T, MaxOp, true> task{v, o};
    return launch(task, seg, scratch, B, N, C, vec, st);
  }
  FwdTask<T, SumOp, false> task{v, o};
  return launch(task, seg, scratch, B, N, C, vec, st);
}

template <typename T>
int rows_of(int C, int op) {
  if (op == 2) return tile_rows<MaxBwdTask<T>>(C);
  if (op == 1) return tile_rows<FwdTask<T, MaxOp, true>>(C);
  return tile_rows<FwdTask<T, SumOp, false>>(C);
}

}  // namespace

// Rows of a tile for C channels of dtype (0 = float32, 1 = bfloat16) and op
// (0 = sum, 1 = max, 2 = max backward): a call's scratch holds four
// (B, ceil(N / rows), C) arrays of float32 (op 0, 1) or float32 pairs (op 2).
extern "C" int k1_tile_rows(int C, int dtype, int op) {
  return dtype == 0 ? rows_of<float>(C, op) : rows_of<__nv_bfloat16>(C, op);
}

// One K1 call on (B, N, C) contiguous tensors of dtype 0 = float32 or
// 1 = bfloat16 and seg (B, N) int32, sorted within each sample.  op 0 = sum,
// 1 = max: y = the run totals of vals (g and fwd unused, may be null);
// op 2 = the max's backward: y = dvals from g, vals (the forward's input)
// and fwd (its output).  scratch: see k1_tile_rows.  Returns a cudaError_t.
extern "C" int k1_call(const void* g, const void* vals, const void* fwd, const int* seg, void* y,
                       void* scratch, int B, int N, int C, int op, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return call<float>(g, vals, fwd, seg, y, scratch, B, N, C, op, st);
  return call<__nv_bfloat16>(g, vals, fwd, seg, y, scratch, B, N, C, op, st);
}
