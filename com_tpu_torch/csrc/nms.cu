// K4: greedy NMS suppression over score-sorted candidates, batched.
//
// Replaces com_tpu/ops/pallas/nms_kernel.py `greedy_suppress_pallas`
// (`_suppress_kernel`): given over (B, K, K) 0/1 ("candidate i suppresses
// candidate j") and valid (B, K), keep[b, i] is true iff candidate i is valid
// and no earlier KEPT candidate suppresses it.  Suppressed starts as "not
// valid", and a box suppresses later boxes only when it is kept.
//
// What bounds it on an H100: latency.  The bytes are tiny (250 KB of 0/1 a
// sample at K = 500) and the operations few; the greedy pass is sequential
// in i by definition, so the time is K dependent steps.
//
// Design, in the style of pcdet's nms_gpu, in two launches:
//   1. k4_pack: many blocks pack the rows of `over` into ceil(K / 64)
//      64-bit words each (one warp a word, two ballots), into a (B, K,
//      words) scratch the wrapper allocates.  Every warp issues its own
//      loads, so the 0/1 bytes stream in parallel across the card.
//   2. k4_sweep: one block per sample copies its packed rows into shared
//      memory and builds the "suppressed" mask from `valid`; then warp 0
//      sweeps i = 0 .. K-1: every lane reads bit i (one shared word, a
//      broadcast); if it is clear, i is kept and the lanes OR row i into
//      the mask, one word a lane.  No step of the sweep touches device
//      memory, so each of the K dependent steps costs a few shared-memory
//      accesses.
// The TPU kernel instead kept the f32 (K, K) matrix in VMEM and did a
// vector row-max per step.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
k4_pack(const uint8_t* __restrict__ over, unsigned long long* __restrict__ rows, int K,
        int nwords) {
  const int lane = threadIdx.x & 31;
  const int q = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);  // (row, word) of sample
  if (q >= K * nwords) return;  // whole warps leave together
  const int b = blockIdx.y, i = q / nwords, j0 = (q % nwords) * 64 + lane, j1 = j0 + 32;
  const uint8_t* ov = over + ((size_t)b * K + i) * K;
  const unsigned lo = __ballot_sync(0xffffffffu, j0 < K && ov[j0] != 0);
  const unsigned hi = __ballot_sync(0xffffffffu, j1 < K && ov[j1] != 0);
  if (lane == 0) rows[(size_t)b * K * nwords + q] = ((unsigned long long)hi << 32) | lo;
}

__global__ void __launch_bounds__(kThreads)
k4_sweep(const unsigned long long* __restrict__ packed, const uint8_t* __restrict__ valid,
         uint8_t* __restrict__ keep, int K, int nwords) {
  extern __shared__ unsigned long long smem[];
  unsigned long long* rows = smem;                       // K * nwords
  unsigned long long* supp = smem + (size_t)K * nwords;  // nwords
  const int b = blockIdx.x;
  const unsigned long long* pk = packed + (size_t)b * K * nwords;
  const uint8_t* vd = valid + (size_t)b * K;
  uint8_t* kp = keep + (size_t)b * K;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;

  for (int q = threadIdx.x; q < K * nwords; q += blockDim.x) rows[q] = pk[q];
  // suppressed starts as "not valid"
  for (int wd = warp; wd < nwords; wd += nwarps) {
    const int j0 = wd * 64 + lane, j1 = j0 + 32;
    const unsigned lo = __ballot_sync(0xffffffffu, j0 < K && vd[j0] == 0);
    const unsigned hi = __ballot_sync(0xffffffffu, j1 < K && vd[j1] == 0);
    if (lane == 0) supp[wd] = ((unsigned long long)hi << 32) | lo;
  }
  for (int j = threadIdx.x; j < K; j += blockDim.x) kp[j] = 0;
  __syncthreads();

  if (warp != 0) return;
  for (int i = 0; i < K; ++i) {
    const int wi = i >> 6;
    const bool alive = ((supp[wi] >> (i & 63)) & 1ull) == 0;
    __syncwarp();  // every lane has read bit i before any lane ORs into word wi
    if (alive) {
      const unsigned long long* row = rows + (size_t)i * nwords;
      for (int wd = wi + lane; wd < nwords; wd += 32) supp[wd] |= row[wd];
      if (lane == 0) kp[i] = 1;
    }
    __syncwarp();
  }
}

}  // namespace

// Bytes of shared memory the kernel needs for K candidates.
extern "C" long long k4_smem_bytes(int K) {
  const long long nwords = (K + 63) / 64;
  return (K * nwords + nwords) * 8;
}

// 64-bit words of the packed (B, K, words) scratch for K candidates.
extern "C" long long k4_packed_words(int K) { return (long long)K * ((K + 63) / 64); }

// over: (B, K, K) uint8 0/1, valid: (B, K) uint8, keep: (B, K) uint8, all
// contiguous; packed: B * k4_packed_words(K) uint64 scratch.  Returns a
// cudaError_t.
extern "C" int k4_greedy_suppress(const void* over, const void* valid, void* keep, void* packed,
                                  int B, int K, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nwords = (K + 63) / 64;
  const size_t smem = (size_t)k4_smem_bytes(K);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(k4_sweep, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int warps = kThreads / 32;
  dim3 grid((K * nwords + warps - 1) / warps, B);
  k4_pack<<<grid, kThreads, 0, st>>>(static_cast<const uint8_t*>(over),
                                     static_cast<unsigned long long*>(packed), K, nwords);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  k4_sweep<<<B, kThreads, smem, st>>>(static_cast<const unsigned long long*>(packed),
                                      static_cast<const uint8_t*>(valid),
                                      static_cast<uint8_t*>(keep), K, nwords);
  return (int)cudaGetLastError();
}
