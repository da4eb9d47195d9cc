// Pyramidal KLT tracking of N features in one launch, for Hopper (sm_90a).
//
// Replaces, together, the Pallas TPU kernel
// boofcv_tpu/kernels/window_gather.py::_kernel (pl.pallas_call at line 95)
// and the XLA loop it feeds, boofcv_tpu/feature/klt.py::_track_level_windowed
// and ::track_pyramid.  On the TPU every level gathered each track's 24x16
// window into device memory so that XLA's fused Gauss-Newton loop could read
// it back.  Here the window never leaves the SM: a warp gathers its track's
// window into shared memory (the same clamped reads as window_gather.cu) and
// runs that track's Gauss-Newton iterations on it, for every pyramid level,
// coarse to fine.  What it computes is track_pyramid's "windowed" method,
// step for step (see track_pyramid_reference in feature/klt.py).
//
// Bound: bytes.  At the main-path shape (512 tracks, 640x480, pyramid
// 1/2/4/8, 7x7 templates) a call reads at most 1.19 MB of image (the touched
// pixels of level 0, all of the coarser levels), 1.20 MB of templates and
// 4 KB of positions, and writes 8 KB: about 0.7 us at 3.35 TB/s.  The
// arithmetic (about 15 flops per patch pixel and evaluation, at most 9
// evaluations per level) is an order of magnitude below that at the f32 rate.
// In practice the kernel is bound by the latency of one track's dependent
// chain (level after level, iteration after iteration), which is why a track
// gets a whole warp and not a thread.
//
// Design: one warp per track, four warps per block.  A lane owns PIX patch
// pixels (two for the 7x7 patch) and keeps their template, gradient-x and
// gradient-y values in registers for the level; the window lives in the
// warp's slice of shared memory (1,536 B for 24x16).  Sums over the patch are
// xor-butterfly shuffles, after which every lane holds the same bits, so the
// iteration loop's exit is warp-uniform and needs no vote.  The loop leaves
// early: once the step falls below the tolerance the reference freezes the
// track but keeps evaluating it, and reports the mean |error| of its last
// evaluation; one more evaluation at the frozen position gives that value.
// Level pointers and sizes arrive in a by-value struct, so the host builds no
// pointer table on the device.
//
// Streams: B independent streams of N tracks go in one launch of B*N warps
// (the reference vmaps its step).  Positions and templates are [B, N, ...]
// flattened, so a warp's track index also indexes them; its images are those
// of stream n / N, `stride[l]` elements apart on level l: h_l * w_l for a
// stack of frames, 0 when every stream tracks on one shared frame, whose
// pixels are then read from device memory once.  At B = 16 the launch is
// 8,192 warps in 2,048 blocks of 6 KB shared memory, the first shape that
// covers the card's 132 SMs.
//
// Build: -fmad=false.  The plain version computes every product and sum as a
// separate rounded operation; without contraction into FMA the kernel differs
// from it only in the order of the 49-term sums.

#include <cuda_runtime.h>

#define KLT_MAX_LEVELS 8

struct KltLevels {
  const float* img[KLT_MAX_LEVELS];   // [h, w] level image of stream 0
  const float* desc[KLT_MAX_LEVELS];  // [N, P, P] template
  const float* gx[KLT_MAX_LEVELS];    // [N, P, P] template gradient in x
  const float* gy[KLT_MAX_LEVELS];    // [N, P, P] template gradient in y
  long long stride[KLT_MAX_LEVELS];   // elements between two streams' images
  int h[KLT_MAX_LEVELS];
  int w[KLT_MAX_LEVELS];
  float ratio[KLT_MAX_LEVELS];  // scales[l] / scales[l - 1] for l >= 1
  float top_scale;              // scales[n_levels - 1]
  int n_levels;
};

struct KltParams {
  int n;           // tracks in all (streams x tracks per stream)
  int per_stream;  // tracks per stream
  int radius;
  int max_iterations;
  float max_per_pixel_error;
  float min_determinant;
  float convergence_tol;
};

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr int kSublanes = 8;  // row alignment of the window origin

// KltTrackFault codes (feature/klt.py)
constexpr int kTrackOk = 0;
constexpr int kFaultOutOfBounds = 1;
constexpr int kFaultFailed = 2;
constexpr int kFaultLargeError = 4;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Python's a // b for b > 0 (C's a / b truncates toward zero).
__device__ __forceinline__ int floor_div(int a, int b) {
  const int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return fminf(fmaxf(v, lo), hi);
}

template <int PIX>
__global__ void klt_track_kernel(KltLevels lv, KltParams prm,
                                 const float* __restrict__ ys,
                                 const float* __restrict__ xs,
                                 float* __restrict__ out_y,
                                 float* __restrict__ out_x,
                                 int* __restrict__ out_fault,
                                 int* __restrict__ out_evals) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n = blockIdx.x * kWarpsPerBlock + warp;
  if (n >= prm.n) return;  // the whole warp leaves; no block barrier is used
  const int stream = n / prm.per_stream;

  const int r = prm.radius;
  const int p = 2 * r + 1;
  const int area = p * p;
  const int wy = (p + 2 <= 16) ? 24 : 32;
  const int wx = (p + 2 <= 16) ? 16 : 32;
  const int sy = (wy - (p + 1)) / 2;
  const int sx = (wx - (p + 1)) / 2;
  const float margin_y = static_cast<float>(wy - p - 1);
  const float margin_x = static_cast<float>(wx - p - 1);
  float* win = smem + warp * wy * wx;

  // this lane's patch pixels: in-window offset from the patch's top-left
  bool act[PIX];
  int off[PIX];
#pragma unroll
  for (int q = 0; q < PIX; ++q) {
    const int k = lane + 32 * q;
    act[q] = k < area;
    const int a = k / p;
    off[q] = act[q] ? a * wx + (k - a * p) : 0;
  }

  float cy = ys[n] / lv.top_scale;
  float cx = xs[n] / lv.top_scale;
  int fault = kTrackOk;
  int evals = 0;

  for (int l = lv.n_levels - 1; l >= 0; --l) {
    const float* __restrict__ img =
        lv.img[l] + static_cast<long long>(stream) * lv.stride[l];
    const int h = lv.h[l];
    const int w = lv.w[l];

    // templates into registers; the 2x2 normal matrix
    float d[PIX], gx[PIX], gy[PIX];
    float sxx = 0.0f, sxy = 0.0f, syy = 0.0f;
    const long long base = static_cast<long long>(n) * area;
#pragma unroll
    for (int q = 0; q < PIX; ++q) {
      const long long k = base + lane + 32 * q;
      d[q] = act[q] ? __ldg(lv.desc[l] + k) : 0.0f;
      gx[q] = act[q] ? __ldg(lv.gx[l] + k) : 0.0f;
      gy[q] = act[q] ? __ldg(lv.gy[l] + k) : 0.0f;
      sxx += gx[q] * gx[q];
      sxy += gx[q] * gy[q];
      syy += gy[q] * gy[q];
    }
    const float gxx = warp_sum(sxx);
    const float gxy = warp_sum(sxy);
    const float gyy = warp_sum(syy);
    const float det = gxx * gyy - gxy * gxy;
    const bool ok_det = det / static_cast<float>(area) >= prm.min_determinant;
    const float safe_det = (det == 0.0f) ? 1.0f : det;

    // window origin: 8-row-aligned oy, both clamps (aligned_window_origin)
    const int oy_ideal = static_cast<int>(floorf(cy)) - r - sy;
    const int oy = min(max(floor_div(oy_ideal, kSublanes) * kSublanes, 0),
                       max((h / kSublanes) * kSublanes - wy, 0));
    const int ox = min(max(static_cast<int>(floorf(cx)) - r - sx, 0),
                       max(w - wx, 0));
    float py = cy - static_cast<float>(r) - static_cast<float>(oy);
    float px = cx - static_cast<float>(r) - static_cast<float>(ox);

    // the gather: win[i, j] = img[clamp(oy + i), clamp(ox + j)]
    __syncwarp();  // the previous level's reads of the window are over
    for (int k = lane; k < wy * wx; k += 32) {
      const int i = k / wx;
      const int j = k - i * wx;
      const int y = min(max(oy + i, 0), h - 1);
      const int x = min(max(ox + j, 0), w - 1);
      win[k] = __ldg(img + static_cast<long long>(y) * w + x);
    }
    __syncwarp();

    // Gauss-Newton steps inside the window
    bool done = false;
    float per_pixel = 0.0f;
    for (int it = 0; it < prm.max_iterations; ++it) {
      const float pyc = clampf(py, 0.0f, margin_y);
      const float pxc = clampf(px, 0.0f, margin_x);
      const float fby = floorf(pyc);
      const float fbx = floorf(pxc);
      const float fy = pyc - fby;
      const float fx = pxc - fbx;
      const float omfy = 1.0f - fy;
      const float omfx = 1.0f - fx;
      const float* tl = win + static_cast<int>(fby) * wx
                        + static_cast<int>(fbx);
      float s_abs = 0.0f, s_x = 0.0f, s_y = 0.0f;
#pragma unroll
      for (int q = 0; q < PIX; ++q) {
        if (act[q]) {
          const float* wp = tl + off[q];
          const float t0 = omfx * wp[0] + fx * wp[1];
          const float t1 = omfx * wp[wx] + fx * wp[wx + 1];
          const float e = (omfy * t0 + fy * t1) - d[q];
          s_abs += fabsf(e);
          s_x += e * gx[q];
          s_y += e * gy[q];
        }
      }
      per_pixel = warp_sum(s_abs) / static_cast<float>(area);
      ++evals;
      if (done) break;  // that was the evaluation at the frozen position
      const float bx_ = warp_sum(s_x);
      const float by_ = warp_sum(s_y);
      const float dx = (gyy * bx_ - gxy * by_) / safe_det;
      const float dy = (gxx * by_ - gxy * bx_) / safe_det;
      py -= dy;
      px -= dx;
      done = fabsf(dx) < prm.convergence_tol
             && fabsf(dy) < prm.convergence_tol;
    }

    // level result: the unclamped py, px decide in_bounds
    const float cy_l = clampf(py, 0.0f, margin_y) + static_cast<float>(r)
                       + static_cast<float>(oy);
    const float cx_l = clampf(px, 0.0f, margin_x) + static_cast<float>(r)
                       + static_cast<float>(ox);
    const bool in_bounds =
        cy_l >= static_cast<float>(r) && cy_l <= static_cast<float>(h - 1 - r)
        && cx_l >= static_cast<float>(r)
        && cx_l <= static_cast<float>(w - 1 - r)
        && py > 0.0f && py < margin_y && px > 0.0f && px < margin_x;
    int f = kTrackOk;
    if (per_pixel > prm.max_per_pixel_error) f = kFaultLargeError;
    if (!ok_det) f = kFaultFailed;
    if (!in_bounds) f = kFaultOutOfBounds;

    // carry: a faulted level keeps the incoming position
    if (f == kTrackOk) {
      cy = cy_l;
      cx = cx_l;
    }
    fault = max(fault, f);
    if (l > 0) {
      cy *= lv.ratio[l];
      cx *= lv.ratio[l];
    }
  }

  if (lane == 0) {
    out_y[n] = cy;
    out_x[n] = cx;
    out_fault[n] = fault;
    out_evals[n] = evals;
  }
}

}  // namespace

extern "C" {

// Launch on `stream` (torch's current stream); returns the cudaError_t of
// the launch (0 on success).  `lv` and `prm` are host structs, passed on to
// the kernel by value; every pointer inside `lv` and every other pointer is a
// device pointer.  The caller checks shapes, dtypes, contiguity and device.
int klt_track_launch(const KltLevels* lv, const KltParams* prm,
                     const float* ys, const float* xs, float* out_y,
                     float* out_x, int* out_fault, int* out_evals,
                     void* stream) {
  if (prm->n <= 0) return 0;
  if (lv->n_levels < 1 || lv->n_levels > KLT_MAX_LEVELS || prm->radius < 1
      || prm->per_stream < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int p = 2 * prm->radius + 1;
  const int wy = (p + 2 <= 16) ? 24 : 32;
  const int wx = (p + 2 <= 16) ? 16 : 32;
  const int blocks = (prm->n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const int threads = 32 * kWarpsPerBlock;
  const size_t shared = sizeof(float) * kWarpsPerBlock * wy * wx;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p * p <= 64) {
    klt_track_kernel<2><<<blocks, threads, shared, s>>>(
        *lv, *prm, ys, xs, out_y, out_x, out_fault, out_evals);
  } else if (p * p <= 256) {
    klt_track_kernel<8><<<blocks, threads, shared, s>>>(
        *lv, *prm, ys, xs, out_y, out_x, out_fault, out_evals);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* klt_track_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
