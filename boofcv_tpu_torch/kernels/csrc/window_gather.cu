// Batched per-track window gather for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel boofcv_tpu/kernels/window_gather.py::_kernel
// (launched by gather_windows through pl.pallas_call).  The TPU kernel needs
// an 8-row-aligned origin, a 128-lane tile plus a lane roll, and an
// edge-padded copy of the image for load headroom; all of that is Mosaic's
// contract.  What it computes is kept here:
//
//   out[n, i, j] = img[clamp(oy[n] + i, 0, h - 1), clamp(ox[n] + j, 0, w - 1)]
//
// for any integer origin, so the clamp IS the edge padding and no padded
// copy of the image is made.  B streams go in one launch (the reference
// vmaps its kernel): the origins are [B, N] flattened, window n reads image
// n / N, and the images lie `img_stride` elements apart (0 when the streams
// share one frame).
//
// Bound: pure data movement.  A call reads the touched image rows (the 50 MB
// L2 holds a 640x480 frame) and writes N * wy * wx floats: at B = 1 the
// sparse SAD's 7x102 strips are 2.3 MB (0.68 us at 3.35 TB/s), its 7x7
// patches 0.2 MB; at B = 256 (131,072 windows) the strips are 374 MB.
//
// Design: the threads of the whole grid walk the N * wy * wx outputs in
// order, so neighbouring threads read neighbouring pixels of a window row
// and write neighbouring outputs (coalesced loads and stores), and a block
// serves several windows, never a ragged tail of one.  A thread takes kVec
// outputs a trip, strided by the grid's width: it issues every load of the
// trip (each output's window origin, then its pixel) before its first
// store, so a trip costs two round trips to memory whatever kVec is.  The
// grid fills the card once (kBlocksPerSm blocks an SM) and walks larger
// work in trips, so B = 1 spreads over the SMs and B = 256 streams with
// kVec * 2,048 outputs in flight on every SM.  The three window shapes in
// use (7x102 and 7x7 of the sparse SAD, 24x16 of KLT) are template
// parameters, so an output's index splits into window, row and column by
// multiplications; any other shape takes the same kernel with run-time
// sizes and divisions.  Shared-memory staging or TMA buys nothing for a
// copy: every byte is read once.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 4;          // outputs a thread a trip
constexpr int kBlocksPerSm = 8;  // grid: at most this many blocks an SM

// The walk, for STACKED images (`img_stride` apart, image n / per_image)
// or one shared image.  WY = WX = 0: the window's size at run time
// (wy_rt x wx_rt).  Loads are unconditional (an output past the end reads
// the last output's pixel and is not stored), so a trip's loads issue
// back to back.
template <int WY, int WX, bool STACKED, typename Index>
__device__ __forceinline__ void gather_walk(
    const float* __restrict__ imgs, long long img_stride, int h, int w,
    const int* __restrict__ oy, const int* __restrict__ ox, int per_image,
    int wy_rt, int wx_rt, Index total, float* __restrict__ out) {
  const int wx = WX ? WX : wx_rt;
  const Index area = WY ? static_cast<Index>(WY * WX)
                        : static_cast<Index>(wy_rt) * wx_rt;
  const Index span = static_cast<Index>(gridDim.x) * kThreads;
  for (Index e0 = static_cast<Index>(blockIdx.x) * kThreads + threadIdx.x;
       e0 < total; e0 += span * kVec) {
    float v[kVec];
#pragma unroll
    for (int q = 0; q < kVec; ++q) {
      const Index e = min(e0 + q * span, total - 1);
      const Index n = e / area;
      const int k = static_cast<int>(e - n * area);
      const int i = k / wx;
      const int j = k - i * wx;
      const float* __restrict__ img =
          STACKED ? imgs + static_cast<long long>(n / per_image) * img_stride
                  : imgs;
      const int y = min(max(__ldg(oy + n) + i, 0), h - 1);
      const int x = min(max(__ldg(ox + n) + j, 0), w - 1);
      v[q] = __ldg(img + static_cast<long long>(y) * w + x);
    }
#pragma unroll
    for (int q = 0; q < kVec; ++q) {
      const Index e = e0 + q * span;
      if (e < total) out[e] = v[q];
    }
  }
}

template <int WY, int WX, typename Index>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
window_gather_kernel(const float* __restrict__ imgs, long long img_stride,
                     int h, int w, const int* __restrict__ oy,
                     const int* __restrict__ ox, int per_image, int wy_rt,
                     int wx_rt, Index total, float* __restrict__ out) {
  if (img_stride)
    gather_walk<WY, WX, true>(imgs, img_stride, h, w, oy, ox, per_image,
                              wy_rt, wx_rt, total, out);
  else
    gather_walk<WY, WX, false>(imgs, img_stride, h, w, oy, ox, per_image,
                               wy_rt, wx_rt, total, out);
}

// Returns at once: what a launch of the gather's grid costs the device
// before any window is read (a measurement probe, not on any path).
__global__ void window_gather_empty_kernel() {}

int sm_count() {
  static int count[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (count[dev] == 0) {
    int c = 0;
    cudaDeviceGetAttribute(&c, cudaDevAttrMultiProcessorCount, dev);
    count[dev] = c > 0 ? c : 132;
  }
  return count[dev];
}

// Blocks for `total` outputs: kVec outputs a thread, but a block on every
// SM while there is an output for each of its threads; at most the cap,
// then trips.
long long blocks_for(long long total) {
  const long long sms = sm_count();
  const long long cap = sms * kBlocksPerSm;
  const long long per_block = static_cast<long long>(kThreads) * kVec;
  const long long one_each = (total + kThreads - 1) / kThreads;
  long long want = (total + per_block - 1) / per_block;
  if (want < sms) want = one_each < sms ? one_each : sms;
  return want < cap ? want : cap;
}

template <typename Index>
int launch_typed(const float* img, long long img_stride, int h, int w,
                 const int* oy, const int* ox, int per_image, int wy, int wx,
                 long long total, float* out, cudaStream_t s) {
  const int blocks = static_cast<int>(blocks_for(total));
  const Index t = static_cast<Index>(total);
#define WG_LAUNCH(WY_, WX_)                                                  \
  window_gather_kernel<WY_, WX_, Index><<<blocks, kThreads, 0, s>>>(         \
      img, img_stride, h, w, oy, ox, per_image, wy, wx, t, out)
  if (wy == 7 && wx == 102) WG_LAUNCH(7, 102);
  else if (wy == 7 && wx == 7) WG_LAUNCH(7, 7);
  else if (wy == 24 && wx == 16) WG_LAUNCH(24, 16);
  else WG_LAUNCH(0, 0);
#undef WG_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// One launch's arguments, filled by the caller (a struct, so that the host
// passes one pointer): `n` windows in all, `per_image` of them on each
// image, `img_stride` elements apart (0: one image).  All pointers are
// device pointers.
struct WindowGatherArgs {
  const float* img;
  long long img_stride;
  int h, w;
  const int* oy;
  const int* ox;
  int n, per_image, wy, wx;
  float* out;
};

// Launch on `stream` (torch's current stream); returns the cudaError_t of
// the launch (0 on success).  The caller checks shapes, dtypes, contiguity
// and device.
int window_gather_launch(const WindowGatherArgs* a, void* stream) {
  if (a->n <= 0) return 0;
  if (a->per_image <= 0 || a->img_stride < 0 || a->wy <= 0 || a->wx <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long total = static_cast<long long>(a->n) * a->wy * a->wx;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (total < (1LL << 30))  // int indices, with room for a trip past it
    return launch_typed<int>(a->img, a->img_stride, a->h, a->w, a->oy, a->ox,
                             a->per_image, a->wy, a->wx, total, a->out, s);
  return launch_typed<long long>(a->img, a->img_stride, a->h, a->w, a->oy,
                                 a->ox, a->per_image, a->wy, a->wx, total,
                                 a->out, s);
}

// The empty kernel on the grid and block that `n` windows of wy x wx get.
int window_gather_empty_launch(int n, int wy, int wx, void* stream) {
  if (n <= 0) return 0;
  const long long total = static_cast<long long>(n) * wy * wx;
  window_gather_empty_kernel<<<static_cast<int>(blocks_for(total)), kThreads,
                               0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

const char* window_gather_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
