// The Schur fill-in of bundle adjustment's reduced camera system, one
// launch a group of the solve's plan, for Hopper (sm_90a).
//
// Replaces no TPU kernel.  The JAX package's _local_system
// (boofcv_tpu/geo/ba.py) forms the fill-in as a one-hot einsum that XLA
// fuses, or for large scenes as a scatter-add of the [P, L, L, D, D] pair
// products.  The port's plain version (geo/ba._fill_in on a CPU tensor)
// writes every pair product W_l^T Y_m of a group into a [pairs, D, D]
// tensor (a mul and two addcmul_ passes), gathers a copy of it in
// view-pair order and sums the runs with segment_reduce: at BAL Venice's
// counts 104.6 M formed pairs an iteration, 33.9 GB of products passed
// over about five times.
//
// What it computes, for each view pair k = v_l * V + v_m (a "run"):
//   S[k] -= sum over the entries e of pair_perm[pair_offsets[k] :
//           pair_offsets[k + 1]], in that order, of W[l(e)]^T Y[m(e)],
// W, Y [N, 3, D] a group's slot arrays and (l(e), m(e)) the two slots of
// pair e.  A pair index is decoded from the group's pieces (pair0, slot0,
// width): the last piece with pair0 <= e holds it, and e - pair0 =
// (point * width + l) * width + m, as the plain version lays its products
// out.  Each element of a run's [D, D] sum is added front to back in run
// order by one thread, and written once; a run is one warp's, and no two
// warps share an element, so there are no atomics and two launches give
// the same bits (geo/ba.py's own rule).  A product is formed as the plain
// version forms it, w0 y0, then + w1 y1, then + w2 y2, each in T, the two
// adds as fmas (as PyTorch's addcmul_ on the card computes them), and the
// run's sum from zero, as segment_reduce adds it.  The two agree to T's
// rounding wherever the plain version's adds are not fused.
//
// Bound.  At Venice's counts (95.8 M valid pairs, D = 9, float32) the work
// is 95.8 M x 81 x (3 multiply-adds + 1 add) = 54 GFLOP, 0.81 ms at 67
// TFLOP/s; from device memory it reads W and Y once (1.08 GB), the pair
// indices (0.77 GB) and each run's offsets, and reads and writes each
// non-empty run's block of S once a group (about 0.3 GB a group), ~0.8 ms
// at 3.35 TB/s.  What binds in practice is the gather: each pair reads two
// rows of 27 floats (216 B) at slots that follow no pattern, 20.7 GB an
// iteration out of L2 or L1, and spreads them over the warp's lanes.
//
// Design.  Warps walk the non-empty runs in key order (the runs table
// lists them first), so the warps in flight at one time work on nearby
// view pairs: they share view v_l's W rows and the Y rows of the views
// around it, which stay in the 50 MB L2.  A warp takes its run's entries
// 32 at a time: each lane reads one pair index and decodes it (a binary
// search over the pieces, copied to shared memory); then for each entry
// the warp reads W's and Y's rows with two coalesced loads (lane c holds
// element c of each row), the next entry's rows in flight while this one
// is summed, and lanes exchange the operands by shuffles.  Lane
// (i, strip) owns row i and three consecutive columns of the run's
// [D, D] block: 3 W and 9 Y operands for 9 products a pair (27 of the
// warp's 32 lanes at D = 9).  The grid is what the card holds at once;
// each warp takes every (grid's warps)-th run.  What bounds this design is
// its shuffles, 14 a pair for the warp, about one a clock on an SM: ~6 ms
// an iteration at Venice's counts (an H100 measured 11-12 ms; reading 2,
// 4 or 8 entries ahead instead of 1 took more registers and ran 6-10 %
// slower).

#include <cuda_runtime.h>

extern "C" {

// Pieces a group may hold: one a bucket of track lengths, and a bucket
// spans a ninth more lengths than the one before (geo/ba._plan).
#define SCHUR_FILL_MAX_PIECES 128

// One launch's arguments, filled by the caller.  Device pointers, each
// array contiguous: W, Y [N, 3, D] and S [R, D, D] float32 (f64 = 0) or
// float64 (f64 = 1); pair_perm [pairs] and pair_offsets [R + 1] int64;
// runs [R] int32, the non-empty runs first in key order.  pieces: each
// piece's (pair0, slot0, width), by pair0.
struct SchurFillArgs {
  const void* W;
  const void* Y;
  const long long* pair_perm;
  const long long* pair_offsets;
  const int* runs;
  void* S;
  int num_runs, num_pieces, d, f64;
  int pieces[3 * SCHUR_FILL_MAX_PIECES];
};

}  // extern "C"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFull = 0xffffffffu;

// The two slots of pair e of the group (pieces in shared memory).
__device__ __forceinline__ void decode(long long e, const int* pieces,
                                       int num_pieces, int& sl, int& sm) {
  int lo = 0, hi = num_pieces - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (pieces[3 * mid] <= e) lo = mid; else hi = mid - 1;
  }
  const int w = pieces[3 * lo + 2];
  const int local = static_cast<int>(e - pieces[3 * lo]);
  const int point = local / (w * w);
  const int rem = local - point * w * w;
  const int l = rem / w;
  const int first = pieces[3 * lo + 1] + point * w;
  sl = first + l;
  sm = first + rem - l * w;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
schur_fill_kernel(const SchurFillArgs a) {
  __shared__ int pieces[3 * SCHUR_FILL_MAX_PIECES];
  for (int t = threadIdx.x; t < 3 * a.num_pieces; t += kThreads)
    pieces[t] = a.pieces[t];
  __syncthreads();

  const int D = a.d, D3 = 3 * D;
  const int lane = threadIdx.x & 31;
  const int strips = (D + 2) / 3;
  const bool owner = lane < D * strips;
  const int i = owner ? lane / strips : 0;
  const int j0 = owner ? (lane - i * strips) * 3 : 0;
  int col[3];
#pragma unroll
  for (int q = 0; q < 3; ++q) col[q] = min(j0 + q, D - 1);
  const bool has_row = lane < D3;
  const T* __restrict__ W = static_cast<const T*>(a.W);
  const T* __restrict__ Y = static_cast<const T*>(a.Y);
  T* __restrict__ S = static_cast<T*>(a.S);

  const int warps = gridDim.x * kWarps;
  for (int r = blockIdx.x * kWarps + (threadIdx.x >> 5); r < a.num_runs;
       r += warps) {
    const int run = __ldg(a.runs + r);
    const long long start = __ldg(a.pair_offsets + run);
    const long long end = __ldg(a.pair_offsets + run + 1);
    if (start == end) break;                 // every later run is empty
    T acc[3] = {T(0), T(0), T(0)};
    for (long long base = start; base < end; base += 32) {
      const int n = static_cast<int>(min(32LL, end - base));
      int sl = 0, sm = 0;
      if (lane < n)
        decode(__ldg(a.pair_perm + base + lane), pieces, a.num_pieces, sl,
               sm);
      int l = __shfl_sync(kFull, sl, 0), m = __shfl_sync(kFull, sm, 0);
      T wv = has_row ? __ldg(W + static_cast<long long>(l) * D3 + lane)
                     : T(0);
      T yv = has_row ? __ldg(Y + static_cast<long long>(m) * D3 + lane)
                     : T(0);
      for (int k = 0; k < n; ++k) {
        T wn = T(0), yn = T(0);
        if (k + 1 < n) {                     // the same for every lane
          l = __shfl_sync(kFull, sl, k + 1);
          m = __shfl_sync(kFull, sm, k + 1);
          if (has_row) {
            wn = __ldg(W + static_cast<long long>(l) * D3 + lane);
            yn = __ldg(Y + static_cast<long long>(m) * D3 + lane);
          }
        }
        const T w0 = __shfl_sync(kFull, wv, i);
        const T w1 = __shfl_sync(kFull, wv, D + i);
        const T w2 = __shfl_sync(kFull, wv, 2 * D + i);
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          const T y0 = __shfl_sync(kFull, yv, col[q]);
          const T y1 = __shfl_sync(kFull, yv, D + col[q]);
          const T y2 = __shfl_sync(kFull, yv, 2 * D + col[q]);
          T p = w0 * y0;
          p = fma(w1, y1, p);
          p = fma(w2, y2, p);
          acc[q] = acc[q] + p;
        }
        wv = wn;
        yv = yn;
      }
    }
    if (owner) {
      T* out = S + static_cast<long long>(run) * D * D + i * D;
#pragma unroll
      for (int q = 0; q < 3; ++q)
        if (j0 + q < D) out[j0 + q] = out[j0 + q] - acc[q];
    }
  }
}

template <typename T>
int launch(const SchurFillArgs* a, cudaStream_t stream) {
  // the blocks the card holds at once, found once a process and device
  static int resident[64] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (resident[dev] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, schur_fill_kernel<T>, kThreads, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    resident[dev] = sms * (per_sm > 0 ? per_sm : 1);
  }
  const long long want = (static_cast<long long>(a->num_runs) + kWarps - 1)
                         / kWarps;
  const int grid = static_cast<int>(want < resident[dev] ? want
                                                         : resident[dev]);
  schur_fill_kernel<T><<<grid, kThreads, 0, stream>>>(*a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launch on `stream` (torch's current stream); returns the cudaError_t of
// the launch (0 on success).  The caller checks shapes, dtypes, contiguity,
// device and the index ranges.
int schur_fill_launch(const SchurFillArgs* a, void* stream) {
  if (a->num_runs <= 0) return 0;
  if (a->d < 1 || a->d > 9 || a->num_pieces < 1
      || a->num_pieces > SCHUR_FILL_MAX_PIECES)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return a->f64 ? launch<double>(a, s) : launch<float>(a, s);
}

const char* schur_fill_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
