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
// Bound: pure data movement.  At the KLT shape (N=512 windows of 24x16 on a
// 640x480 f32 level) a call writes 786 KB and reads the touched image rows,
// which the 50 MB L2 holds, so the kernel is bound by launch latency and by
// store bandwidth, never by arithmetic.  Design: one CTA per window, threads
// stride over wy*wx in row-major order, so neighbouring threads read
// neighbouring columns of one image row and write neighbouring outputs
// (coalesced stores, mostly coalesced loads).  Shared-memory staging or TMA
// buys nothing for a copy this small.

#include <cuda_runtime.h>

namespace {

__global__ void window_gather_kernel(const float* __restrict__ imgs,
                                     long long img_stride, int h, int w,
                                     const int* __restrict__ oy,
                                     const int* __restrict__ ox,
                                     int per_image, int wy, int wx,
                                     float* __restrict__ out) {
  const int n = blockIdx.x;
  const float* __restrict__ img =
      imgs + static_cast<long long>(n / per_image) * img_stride;
  const int y0 = oy[n];
  const int x0 = ox[n];
  const int area = wy * wx;
  float* dst = out + static_cast<long long>(n) * area;
  for (int k = threadIdx.x; k < area; k += blockDim.x) {
    const int i = k / wx;
    const int j = k - i * wx;
    const int y = min(max(y0 + i, 0), h - 1);
    const int x = min(max(x0 + j, 0), w - 1);
    dst[k] = __ldg(img + static_cast<long long>(y) * w + x);
  }
}

// Returns at once: what a launch of the gather's grid costs the device
// before any window is read (a measurement probe, not on any path).
__global__ void window_gather_empty_kernel() {}

// The same under another name, so that a trace can tell its padding from
// the probe above (see window_gather_pad_launch).
__global__ void window_gather_pad_kernel() {}

int threads_for(int area) {
  const int threads = ((area + 31) / 32) * 32;
  return threads > 256 ? 256 : threads;
}

}  // namespace

extern "C" {

// Launch on `stream` (torch's current stream); returns the cudaError_t of
// the launch (0 on success).  `n` windows in all, `per_image` of them on each
// image.  All pointers are device pointers; the caller checks shapes, dtypes,
// contiguity and device.
int window_gather_launch(const float* img, long long img_stride, int h, int w,
                         const int* oy, const int* ox, int n, int per_image,
                         int wy, int wx, float* out, void* stream) {
  if (n <= 0) return 0;
  if (per_image <= 0 || img_stride < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  window_gather_kernel<<<n, threads_for(wy * wx), 0,
                         static_cast<cudaStream_t>(stream)>>>(
      img, img_stride, h, w, oy, ox, per_image, wy, wx, out);
  return static_cast<int>(cudaGetLastError());
}

// The empty kernel on the grid and block that `n` windows of wy x wx get.
int window_gather_empty_launch(int n, int wy, int wx, void* stream) {
  if (n <= 0) return 0;
  window_gather_empty_kernel<<<n, threads_for(wy * wx), 0,
                               static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

// `count` one-warp launches of the pad kernel, back to back.  A profiler
// that loses the first device events of a trace loses these when they lead
// it; they carry no work.
int window_gather_pad_launch(int count, void* stream) {
  for (int i = 0; i < count; ++i)
    window_gather_pad_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

const char* window_gather_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
