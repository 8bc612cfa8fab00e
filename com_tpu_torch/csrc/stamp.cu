// K3: per-object window stamping onto a dense (B, C, H, W) f32 canvas.
//
// Replaces com_tpu/ops/pallas/stamp.py `_stamp_pallas` (`_stamp_kernel`):
// every valid object stamps a (2r+1) x (2r+1) window around its integer
// center in its class plane, r <= R (16).  Two modes:
//   gauss      the canvas starts at `fill` (0 for heatmap targets) and each
//              cell takes the max of itself and exp(-(dx^2+dy^2)/(2 s^2)),
//              s = (2r+1)/6, the analytic form the TPU kernel evaluates;
//   last_wins  the canvas starts at `fill` and the window is overwritten
//              with a per-object constant; where windows overlap, the
//              highest object index wins (the reference's sequential loop).
// Objects arrive preprocessed by the wrapper: centers and classes clamped
// into the canvas, radius clamped to [0, R], -1 for an invalid object.
//
// What bounds it on an H100: bytes.  The canvas (2 x 3 x 468 x 468 f32,
// 5.3 MB) is written once; the window cells (~100 objects a sample, most
// with r of 2-6) are a small fraction of it, so the bound is the canvas
// write, a few microseconds.
//
// Design.  The TPU kernel walks the objects in order (`fori_loop`) over a
// canvas held in VMEM, which is what makes "last wins" and max-combining
// trivial there.  Hopper blocks run in no order, so the order is rebuilt
// with atomics: one block per (object slot, sample), threads over the
// window cells, invalid slots exit at once.
//   gauss: stamped values are > 0, and for floats >= 0 the order of their
//   int bit patterns is their numeric order (and any value >= 0 is above
//   every negative fill), so atomicMax on the bits is an exact max.
//   last_wins: a first pass takes atomicMax of (object index + 1) into an
//   int32 winner canvas; a second, elementwise pass writes values[winner-1]
//   where winner > 0 and `fill` elsewhere.  Both are deterministic.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void fill_kernel(float* __restrict__ out, long long n, float fill) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = fill;
}

// mode 0 (gauss): atomicMax of the gaussian's bits into `canvas` (float);
// mode 1 (last_wins): atomicMax of index + 1 into `canvas` (int32 winner).
__global__ void __launch_bounds__(kThreads)
window_kernel(const int* __restrict__ cx, const int* __restrict__ cy,
              const int* __restrict__ rr, const int* __restrict__ cls, int* __restrict__ canvas,
              int N, int C, int H, int W, int mode) {
  const int i = blockIdx.x, b = blockIdx.y;
  const int o = b * N + i;
  const int r = rr[o];
  if (r < 0) return;
  const int x0 = cx[o], y0 = cy[o];
  const int k = 2 * r + 1;
  const float sig = (float)k / 6.0f;
  const float denom = 2.0f * sig * sig;
  int* plane = canvas + ((size_t)b * C + cls[o]) * H * W;
  for (int e = threadIdx.x; e < k * k; e += blockDim.x) {
    const int dy = e / k - r, dx = e % k - r;
    const int y = y0 + dy, x = x0 + dx;
    if (y < 0 || y >= H || x < 0 || x >= W) continue;
    int v;
    if (mode == 0) {
      const float d2 = (float)(dx * dx + dy * dy);
      v = __float_as_int(expf(-d2 / denom));
    } else {
      v = i + 1;
    }
    atomicMax(plane + (size_t)y * W + x, v);
  }
}

__global__ void resolve_kernel(const int* __restrict__ winner, const float* __restrict__ vals,
                               float* __restrict__ out, long long n, long long chw, int N,
                               float fill) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int w = winner[i];
  out[i] = w > 0 ? vals[(i / chw) * N + (w - 1)] : fill;
}

}  // namespace

// cx, cy, rr, cls: (B, N) int32; vals: (B, N) f32 (read in last_wins mode);
// out: (B, C, H, W) f32; winner: (B, C, H, W) int32 scratch (last_wins
// mode only, may be null for gauss).  mode 0 = gauss, 1 = last_wins.
// Returns a cudaError_t.
extern "C" int k3_stamp(const void* cx, const void* cy, const void* rr, const void* cls,
                        const void* vals, void* out, void* winner, int B, int N, int C, int H,
                        int W, int mode, float fill, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long n = (long long)B * C * H * W;
  const unsigned fill_blocks = (unsigned)((n + kThreads - 1) / kThreads);
  const dim3 grid(N, B);
  const int* icx = static_cast<const int*>(cx);
  const int* icy = static_cast<const int*>(cy);
  const int* irr = static_cast<const int*>(rr);
  const int* icls = static_cast<const int*>(cls);
  float* fout = static_cast<float*>(out);
  if (mode == 0) {
    fill_kernel<<<fill_blocks, kThreads, 0, st>>>(fout, n, fill);
    if (N > 0)
      window_kernel<<<grid, kThreads, 0, st>>>(icx, icy, irr, icls, reinterpret_cast<int*>(fout),
                                               N, C, H, W, 0);
  } else {
    int* win = static_cast<int*>(winner);
    cudaError_t err = cudaMemsetAsync(win, 0, (size_t)n * sizeof(int), st);
    if (err != cudaSuccess) return (int)err;
    if (N > 0)
      window_kernel<<<grid, kThreads, 0, st>>>(icx, icy, irr, icls, win, N, C, H, W, 1);
    resolve_kernel<<<fill_blocks, kThreads, 0, st>>>(win, static_cast<const float*>(vals), fout,
                                                     n, (long long)C * H * W, N, fill);
  }
  return (int)cudaGetLastError();
}
