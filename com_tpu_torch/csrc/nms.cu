// K4: greedy NMS suppression over score-sorted candidates, batched.
//
// Replaces com_tpu/ops/pallas/nms_kernel.py `greedy_suppress_pallas`
// (`_suppress_kernel`): given over (B, K, K) 0/1 ("candidate i suppresses
// candidate j") and valid (B, K), keep[b, i] is true iff candidate i is valid
// and no earlier KEPT candidate suppresses it.  Suppressed starts as "not
// valid", and a box suppresses later boxes only when it is kept.
//
// What bounds it on an H100: latency.  The bytes are few (250 KB of 0/1 a
// sample at K = 500) and the operations fewer; the greedy pass is a chain of
// dependent decisions.  The TPU kernel walks all K candidates, one vector
// row-max a step, over the f32 matrix in VMEM.
//
// Design: a sweep whose dependent chain is as long as the conflicting
// candidates, not K, behind a pack spread over the card.
//   1. Pack (k4_pack): one warp a (row, 64-column word) of every sample, two
//      ballots, into a (B, K, stride) scratch of bit rows: row i holds
//      ceil(K / 64) words at an odd stride, so that the lanes of a warp
//      reading one word of 32 rows hit distinct banks.
//   2. Sweep (k4_sweep, one block a sample, launched as the pack's
//      programmatic dependent with griddepcontrol): the block builds its
//      valid words and waits for the pack; then warp 0 takes one
//      64-candidate word w at a time.  Lane l holds words l and l + 32 of the
//      "removed" mask (invalid or suppressed) in registers.
//      a. Resolve word w.  Each lane loads the diagonal-block rows of
//         candidates l and l + 32 and marks the alive ones whose row hits an
//         alive later candidate of the word; two ballots give that
//         "conflict" set.  Only its members run the sequential chain (bit
//         scan, the member's row, clear what it suppresses); every other
//         alive candidate is kept and suppresses nothing in the word.  Dead, invalid and conflict-free
//         candidates cost bit operations.
//      b. Every lane ORs the rows of the word's kept candidates into each of
//         its words past w, with 64 loads a word, none waiting on another.
//   Where the rows live depends on K.  Up to 1,344 candidates (the rows fit
//   one block's 227 KB) the sweep first copies them into shared memory with
//   16-byte loads (sweep_smem, one word of the removed mask a lane).  Past
//   that, up to 4,096 (64 words), it reads them where the pack wrote them,
//   through L2 (sweep_l2, two words a lane): the rows of a (4, 4096) call
//   are 8.5 MB, and the H100's L2 holds 50 MB.
// The pack is its own kernel because a pack inside the sweep's block streams
// a sample's 250 KB through one SM: about three times slower on an H100.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;      // threads of the sweep's block (they copy the rows in)
constexpr int kPackThreads = 512;  // threads of a pack block, one warp a (row, word)
constexpr int kSmemLimit = 227 * 1024;
constexpr int kMaxWords = 64;      // two words of the removed mask a lane of the sweep
constexpr int kMaxK = 64 * kMaxWords;

typedef unsigned long long u64;

__host__ __device__ __forceinline__ int row_words(int K) { return (K + 63) / 64; }
// Row stride in words: odd, so that 32 rows' words at one column fall in distinct banks.
__host__ __device__ __forceinline__ int row_stride(int K) { return row_words(K) | 1; }

__device__ __forceinline__ void griddep_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}
__device__ __forceinline__ void griddep_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// Valid bits of the sample, one word a 64 candidates, by the block's warps.
__device__ void valid_words(const uint8_t* vd, int K, u64* vbits) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  for (int wd = warp; wd < row_words(K); wd += nwarps) {
    const int j0 = wd * 64 + lane, j1 = j0 + 32;
    const unsigned lo = __ballot_sync(0xffffffffu, j0 < K && vd[j0] != 0);
    const unsigned hi = __ballot_sync(0xffffffffu, j1 < K && vd[j1] != 0);
    if (lane == 0) vbits[wd] = ((u64)hi << 32) | lo;
  }
}

// Warp 0's sweep over the rows in shared memory (at most 21 words, one a
// lane); writes keep[0, K).
__device__ void sweep_smem(const u64* rows, const u64* vbits, uint8_t* kp, int K, int ns) {
  const int lane = threadIdx.x & 31, nw = row_words(K);
  u64 removed = lane < nw ? ~vbits[lane] : ~0ull;
  for (int w = 0; w < nw; ++w) {
    const u64 alive0 = ~__shfl_sync(0xffffffffu, removed, w);
    // a. conflicts: alive candidates whose row hits a later alive one of the
    //    word (the rows past K are padding, and no alive bit reads them)
    const u64* diag = rows + (size_t)(w * 64) * ns + w;
    const int hi = lane + 32;
    const u64 lo_row = diag[(size_t)lane * ns], hi_row = diag[(size_t)hi * ns];
    const bool c_lo = (alive0 >> lane & 1ull) && (lo_row & (~0ull << (lane + 1)) & alive0);
    const bool c_hi = (alive0 >> hi & 1ull) && hi < 63 && (hi_row & (~0ull << (hi + 1)) & alive0);
    u64 conflict = ((u64)__ballot_sync(0xffffffffu, c_hi) << 32) | __ballot_sync(0xffffffffu, c_lo);
    u64 alive = alive0;
    while (conflict) {  // uniform across the warp
      const int e = __ffsll(conflict) - 1;
      conflict &= conflict - 1;
      if (alive >> e & 1ull) {
        const u64 later = e == 63 ? 0ull : ~0ull << (e + 1);
        alive &= ~(diag[(size_t)e * ns] & later);
      }
    }
    const u64 kept = alive;  // every candidate still alive is kept
    for (int e = lane; e < 64; e += 32)
      if (w * 64 + e < K) kp[w * 64 + e] = (uint8_t)(kept >> e & 1ull);
    // b. the kept rows into the later words: all 64 rows loaded and masked
    //    by their kept bit, no load waiting on another (a load under a
    //    branch, or a bit-scan loop, waits for each in turn: ~37 cycles a
    //    kept row on an H100)
    if (kept && lane > w && lane < nw) {
      const u64* col = rows + (size_t)(w * 64) * ns + lane;
      u64 acc[4] = {0, 0, 0, 0};
#pragma unroll
      for (int e = 0; e < 64; ++e) acc[e & 3] |= col[(size_t)e * ns] & (0ull - (kept >> e & 1ull));
      removed |= acc[0] | acc[1] | acc[2] | acc[3];
    }
  }
}

// Warp 0's sweep over the rows where the pack wrote them, read through L2
// only (the scratch is rewritten every call: no L1 line of an earlier call
// may be read); up to 64 words, lane l holding words l and l + 32 of the
// removed mask in removed[q]; writes keep[0, K).  No row past K may be read:
// a row index past the word's last candidate reads that candidate's row
// instead, which its alive or kept bit (0) masks off.  No load sits under a
// branch or a predicate, where it would wait for the one before it; a
// conflict's row comes by a shuffle from the lane that loaded it.  Keep the
// word selections as loops over kWords: written with a plain ternary, the
// same sweep compiled to fewer registers and ran slower on an H100.
__device__ void sweep_l2(const u64* rows, const u64* vbits, uint8_t* kp, int K, int ns) {
  constexpr int kWords = 2;
  const int lane = threadIdx.x & 31, nw = row_words(K);
  u64 removed[kWords];
#pragma unroll
  for (int q = 0; q < kWords; ++q) {
    const int wd = lane + 32 * q;
    removed[q] = wd < nw ? ~vbits[wd] : ~0ull;
  }
  for (int w = 0; w < nw; ++w) {
    u64 held = removed[0];
#pragma unroll
    for (int q = 1; q < kWords; ++q) held = (w >> 5) == q ? removed[q] : held;
    const u64 alive0 = ~__shfl_sync(0xffffffffu, held, w & 31);
    const int n = min(64, K - w * 64);  // the word's candidates
    // a. conflicts, as in sweep_smem
    const u64* diag = rows + (size_t)(w * 64) * ns + w;
    const int hi = lane + 32;
    const int last = n - 1;
    const u64 lo_row = __ldcg(diag + (size_t)min(lane, last) * ns);
    const u64 hi_row = __ldcg(diag + (size_t)min(hi, last) * ns);
    const bool c_lo = (alive0 >> lane & 1ull) && (lo_row & (~0ull << (lane + 1)) & alive0);
    const bool c_hi = (alive0 >> hi & 1ull) && hi < 63 && (hi_row & (~0ull << (hi + 1)) & alive0);
    u64 conflict = ((u64)__ballot_sync(0xffffffffu, c_hi) << 32) | __ballot_sync(0xffffffffu, c_lo);
    u64 alive = alive0;
    while (conflict) {  // uniform across the warp
      const int e = __ffsll(conflict) - 1;
      conflict &= conflict - 1;
      const u64 row = __shfl_sync(0xffffffffu, e < 32 ? lo_row : hi_row, e & 31);
      if (alive >> e & 1ull) alive &= ~(row & (e == 63 ? 0ull : ~0ull << (e + 1)));
    }
    const u64 kept = alive;  // every candidate still alive is kept
    for (int e = lane; e < n; e += 32) kp[w * 64 + e] = (uint8_t)(kept >> e & 1ull);
    // b. the kept rows into each of the lane's later words
    if (!kept) continue;
#pragma unroll
    for (int q = 0; q < kWords; ++q) {
      const int wd = lane + 32 * q;
      if (wd > w && wd < nw) {
        const u64* col = rows + (size_t)(w * 64) * ns + wd;
        u64 acc[4] = {0, 0, 0, 0};
#pragma unroll
        for (int e = 0; e < 64; ++e)
          acc[e & 3] |= __ldcg(col + (size_t)min(e, last) * ns) & (0ull - (kept >> e & 1ull));
        removed[q] |= acc[0] | acc[1] | acc[2] | acc[3];
      }
    }
  }
}

// One warp a (row, word) of every sample, two ballots.
__global__ void __launch_bounds__(kPackThreads)
k4_pack(const uint8_t* __restrict__ over, u64* __restrict__ packed, int K) {
  griddep_launch_dependents();
  const int lane = threadIdx.x & 31, nw = row_words(K), ns = row_stride(K);
  const int q = blockIdx.x * (kPackThreads / 32) + (threadIdx.x >> 5);
  if (q >= K * nw) return;  // whole warps leave together
  const int b = blockIdx.y, i = q / nw, wd = q % nw, j0 = wd * 64 + lane, j1 = j0 + 32;
  const uint8_t* ov = over + ((size_t)b * K + i) * K;
  const unsigned lo = __ballot_sync(0xffffffffu, j0 < K && ov[j0] != 0);
  const unsigned hi = __ballot_sync(0xffffffffu, j1 < K && ov[j1] != 0);
  if (lane == 0) packed[((size_t)b * K + i) * ns + wd] = ((u64)hi << 32) | lo;
}

// kInL2 false: the rows copied into shared memory, the valid words after
// them; true: the valid words alone in shared memory, the rows read where
// the pack wrote them.
template <bool kInL2>
__global__ void __launch_bounds__(kThreads)
k4_sweep(const u64* __restrict__ packed, const uint8_t* __restrict__ valid,
         uint8_t* __restrict__ keep, int K) {
  extern __shared__ u64 smem[];
  const int ns = row_stride(K), b = blockIdx.x;
  const u64* pk = packed + (size_t)b * K * ns;
  u64* vbits = kInL2 ? smem : smem + (size_t)row_words(K) * 64 * ns;
  valid_words(valid + (size_t)b * K, K, vbits);
  griddep_wait();  // the rows come from k4_pack
  if constexpr (kInL2) {
    __syncthreads();
    if (threadIdx.x < 32) sweep_l2(pk, vbits, keep + (size_t)b * K, K, ns);
  } else {
    // 16-byte loads where aligned, which odd K leaves the odd samples not
    u64* rows = smem;
    const int n = K * ns;
    if ((reinterpret_cast<uintptr_t>(pk) & 15) == 0) {
      for (int q = threadIdx.x; q < n / 2; q += blockDim.x)
        reinterpret_cast<ulonglong2*>(rows)[q] = __ldcg(reinterpret_cast<const ulonglong2*>(pk) + q);
      if (threadIdx.x == 0 && (n & 1)) rows[n - 1] = __ldcg(pk + n - 1);
    } else {
      for (int q = threadIdx.x; q < n; q += blockDim.x) rows[q] = __ldcg(pk + q);
    }
    __syncthreads();
    if (threadIdx.x < 32) sweep_smem(rows, vbits, keep + (size_t)b * K, K, ns);
  }
}

// Shared memory of the rows' in-block layout: the rows padded to whole words
// of candidates, then the valid words.
size_t smem_bytes(int K) {
  return ((size_t)row_words(K) * 64 * row_stride(K) + row_words(K)) * sizeof(u64);
}

// The dynamic shared memory above 48 KB is allowed once a device.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel) {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 64 && done[dev])) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
  if (err == cudaSuccess && dev < 64) done[dev] = true;
  return err;
}

}  // namespace

// The most candidates k4_greedy_suppress takes.
extern "C" int k4_max_candidates() { return kMaxK; }

// over: (B, K, K) uint8 0/1, valid: (B, K) uint8, keep: (B, K) uint8, all
// contiguous, 1 <= K <= k4_max_candidates().  packed: a (B, K, ceil(K / 64)
// | 1) uint64 scratch.  The sweep copies the rows into (64 W * (W | 1) + W)
// * 8 bytes of shared memory, W = ceil(K / 64), where that fits in 227 KB,
// and reads them from the scratch otherwise.  Returns a cudaError_t.
extern "C" int k4_greedy_suppress(const void* over, const void* valid, void* keep, void* packed,
                                  int B, int K, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (K < 1 || K > kMaxK) return (int)cudaErrorInvalidValue;
  const bool in_smem = smem_bytes(K) <= (size_t)kSmemLimit;
  const size_t smem = in_smem ? smem_bytes(K) : row_words(K) * sizeof(u64);
  const uint8_t* ov = static_cast<const uint8_t*>(over);
  const uint8_t* vd = static_cast<const uint8_t*>(valid);
  uint8_t* kp = static_cast<uint8_t*>(keep);
  cudaError_t err = in_smem ? allow_smem(k4_sweep<false>) : cudaSuccess;
  if (err != cudaSuccess) return (int)err;
  u64* pk = static_cast<u64*>(packed);
  const int warps = kPackThreads / 32;
  k4_pack<<<dim3((K * row_words(K) + warps - 1) / warps, B), kPackThreads, 0, st>>>(ov, pk, K);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = in_smem ? cudaLaunchKernelEx(&cfg, k4_sweep<false>, (const u64*)pk, vd, kp, K)
                : cudaLaunchKernelEx(&cfg, k4_sweep<true>, (const u64*)pk, vd, kp, K);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
