// Pyramidal KLT tracking of N features in one launch, for Hopper (sm_90a).
//
// Replaces, together, the Pallas TPU kernel
// boofcv_tpu/kernels/window_gather.py::_kernel (pl.pallas_call at line 95)
// and the XLA loop it feeds, boofcv_tpu/feature/klt.py::_track_level_windowed
// and ::track_pyramid.  On the TPU every level gathered each track's 24x16
// window into device memory so that XLA's fused Gauss-Newton loop could read
// it back.  Here the window never leaves the SM: a warp copies its track's
// window into shared memory (the same clamped reads as window_gather.cu)
// and runs that track's Gauss-Newton iterations on it, for
// every pyramid level, coarse to fine.  What it computes is track_pyramid's
// "windowed" method, step for step (see track_pyramid_reference in
// feature/klt.py).
//
// Bound.  At the main-path shape (512 tracks, 640x480, pyramid 1/2/4/8, 7x7
// templates) a call moves about 2.2 MB (the touched pixels of every level,
// the templates, the positions): 0.65 us at 3.35 TB/s.  The arithmetic
// (about 15 flops per patch pixel and evaluation, 5 evaluations per track
// and level on that scene) is below that at the f32 rate.  At B = 1 the
// kernel is bound instead by one track's dependent chain: level after level
// a window fetch, then up to max_iterations evaluations, each a bilinear
// resample, three sums across the warp and a Gauss-Newton step.  At
// B = 256 (131,072 tracks) the templates alone are 308 MB; the chains of
// other tracks hide each other, and what stands between the kernel and the
// byte bound is the instructions and shared-memory wavefronts each
// evaluation issues.
//
// Design: one warp per track, two warps a block.  Everything that shapes
// the chain is a template parameter: the window (24x16 or 32x32, as the
// patch needs), its row pitch in shared memory (24x16 rows lie 20 floats
// apart, so a 7x7 patch's 32 lanes meet at most two to a bank), and PIX,
// the patch pixels a lane owns (2 up to 8x8 patches, 8 up to 16x16).  So:
// - the window is one round trip: every lane issues all its 4-byte
//   cp.async copies at once (WY*WX/32 of them, unrolled, no registers),
//   then one wait and one __syncwarp;
// - the templates and gradients of the next level are loaded while this
//   level iterates (they do not depend on the position), so the window is
//   the only fetch left on the chain; the level's 2x2 normal matrix and the
//   reciprocal of its determinant are made while its window is in flight;
// - an evaluation is branch-free (a lane's unused patch slots read the
//   patch's first pixel and count 0) and makes its sums with one butterfly
//   of five steps for all of them; the mean |error| is divided once, for
//   the evaluation that ends the level, the only one read;
// - with many tracks (SPLIT, above kSplitAbove), a level's last
//   evaluation is peeled off the loop, so that only it sums |error| (and
//   the one at the frozen position sums nothing else): about 10 % fewer
//   instructions at B >= 16.  The longer program costs one warp's chain
//   more than the sum it saves, so few tracks keep one loop that makes all
//   three sums every evaluation.  Single against split loop on an H100
//   (chip_smoke.py --sweep): 512 tracks 0.0122 against 0.0128 ms, 2,048
//   0.0169 against 0.0168, 4,096 0.0297 against 0.0287, 8,192 0.0535
//   against 0.0489, 131,072 0.684 against 0.614: they cross near 2,048;
// - the step's two quotients (and the level's mean |error|) come from the
//   divisor's double-precision reciprocal: a float quotient a / b rounded
//   from the double a * (1 / b) is the float division's result, bit for
//   bit, whenever that result is a normal float (the product is within
//   2^-52 of a / b, relatively, and no quotient of two floats lies closer
//   than 2^-49 to a rounding boundary of the float grid); a quotient below
//   2^-125 takes the float division.  The two quotients' chains run side
//   by side, and an evaluation's chain holds no division.
// A track keeps the reference's semantics: once a step falls below the
// tolerance it is frozen but evaluated once more, and its mean |error| is
// that evaluation's.
//
// Sum order: a lane adds its PIX values as a tree whose first level pairs
// slot q with q + PIX/2, then the warp adds across lanes by an xor
// butterfly from 16 down to 1 (slot k = lane + 32 q; unused slots hold 0).
//
// Streams: B independent streams of N tracks go in one launch (the
// reference vmaps its step).  Positions and templates are [B, N, ...]
// flattened, so a warp's track index also indexes them; its images are
// those of stream n / N, `stride[l]` elements apart on level l: h_l * w_l
// for a stack of frames, 0 when every stream tracks on one shared frame,
// whose pixels are then read from device memory once.
//
// Build: -fmad=false.  The plain version computes every product and sum as a
// separate rounded operation; without contraction into FMA the kernel differs
// from it only in the order of the patch sums.

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

struct KltBuffers {  // device pointers: [N] positions in, the outputs
  const float* ys;
  const float* xs;
  float* out_y;
  float* out_x;
  int* out_fault;
  int* out_evals;
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

constexpr int kWarpsPerBlock = 2;
// Tracks above which 7x7 and smaller patches take the SPLIT loop (see the
// header); both loops give the same bits.  -DKLT_SPLIT_ABOVE=... builds
// another cut (chip_smoke.py --sweep times both loops at every count).
#ifndef KLT_SPLIT_ABOVE
#define KLT_SPLIT_ABOVE 2048
#endif
constexpr int kSplitAbove = KLT_SPLIT_ABOVE;
constexpr int kSublanes = 8;  // row alignment of the window origin

// KltTrackFault codes (feature/klt.py)
constexpr int kTrackOk = 0;
constexpr int kFaultOutOfBounds = 1;
constexpr int kFaultFailed = 2;
constexpr int kFaultLargeError = 4;

// A lane's PIX values summed as a tree: q pairs with q + PIX/2 first.
template <int PIX>
__device__ __forceinline__ float lane_tree(const float (&v)[PIX]) {
  float t[PIX];
#pragma unroll
  for (int q = 0; q < PIX; ++q) t[q] = v[q];
#pragma unroll
  for (int half = PIX / 2; half > 0; half >>= 1) {
#pragma unroll
    for (int q = 0; q < half; ++q) t[q] = t[q] + t[q + half];
  }
  return t[0];
}

// Sums across the warp by an xor butterfly, several interleaved; every
// lane ends with the same bits, and a sum's bits do not depend on how many
// others go with it.
__device__ __forceinline__ void warp_sum1(float& a) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) a = a + __shfl_xor_sync(0xffffffffu, a, o);
}

__device__ __forceinline__ void warp_sum2(float& a, float& b) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float a2 = __shfl_xor_sync(0xffffffffu, a, o);
    const float b2 = __shfl_xor_sync(0xffffffffu, b, o);
    a = a + a2;
    b = b + b2;
  }
}

__device__ __forceinline__ void warp_sum3(float& a, float& b, float& c) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float a2 = __shfl_xor_sync(0xffffffffu, a, o);
    const float b2 = __shfl_xor_sync(0xffffffffu, b, o);
    const float c2 = __shfl_xor_sync(0xffffffffu, c, o);
    a = a + a2;
    b = b + b2;
    c = c + c2;
  }
}

// Python's a // b for b > 0 (C's a / b truncates toward zero).
__device__ __forceinline__ int floor_div(int a, int b) {
  const int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return fminf(fmaxf(v, lo), hi);
}

// Whether q, a / b rounded from the double a * (1 / b), may be below the
// normal floats, where it need not be the float division's (see the
// header): a nonzero a whose rounded quotient is under 2^-125.
__device__ __forceinline__ bool tiny(float q, float a) {
  return fabsf(q) < 0x1p-125f && a != 0.0f;
}

// a / b, rounded to float as the float division rounds it, from b's double
// reciprocal rb = 1 / (double)b.
__device__ __forceinline__ float quotient(float a, float b, double rb) {
  const float q = __double2float_rn(static_cast<double>(a) * rb);
  return tiny(q, a) ? a / b : q;
}

// The step's two quotients a / b and c / b together: both products before
// one (warp-uniform, all but never taken) branch to the float divisions.
__device__ __forceinline__ void quotients(float a, float c, float b,
                                          double rb, float& qa, float& qc) {
  qa = __double2float_rn(static_cast<double>(a) * rb);
  qc = __double2float_rn(static_cast<double>(c) * rb);
  if (tiny(qa, a) || tiny(qc, c)) {
    qa = a / b;
    qc = c / b;
  }
}

__device__ __forceinline__ void copy4_async(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void copies_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// One evaluation of the patch at in-window top-left (py, px): a lane's
// slots of |error|, error * gradient-x and error * gradient-y (0 in unused
// slots, which read the patch's first pixel).
template <int WP, int PIX>
__device__ __forceinline__ void evaluate(
    const float* win, float py, float px, float margin_y, float margin_x,
    const int (&off)[PIX], const bool (&act)[PIX], const float (&d)[PIX],
    const float (&gx)[PIX], const float (&gy)[PIX], float (&va)[PIX],
    float (&vx)[PIX], float (&vy)[PIX]) {
  const float pyc = clampf(py, 0.0f, margin_y);
  const float pxc = clampf(px, 0.0f, margin_x);
  const float fby = floorf(pyc);
  const float fbx = floorf(pxc);
  const float fy = pyc - fby;
  const float fx = pxc - fbx;
  const float omfy = 1.0f - fy;
  const float omfx = 1.0f - fx;
  const float* tl = win + static_cast<int>(fby) * WP + static_cast<int>(fbx);
#pragma unroll
  for (int q = 0; q < PIX; ++q) {
    const float* wp = tl + off[q];
    const float t0 = omfx * wp[0] + fx * wp[1];
    const float t1 = omfx * wp[WP] + fx * wp[WP + 1];
    const float e = (omfy * t0 + fy * t1) - d[q];
    va[q] = act[q] ? fabsf(e) : 0.0f;
    vx[q] = act[q] ? e * gx[q] : 0.0f;
    vy[q] = act[q] ? e * gy[q] : 0.0f;
  }
}

// A lane's template, gradient-x and gradient-y slots of one level.
template <int PIX>
__device__ __forceinline__ void load_templates(
    const float* desc, const float* grad_x, const float* grad_y,
    long long base, int lane, const bool (&act)[PIX], float (&d)[PIX],
    float (&gx)[PIX], float (&gy)[PIX]) {
#pragma unroll
  for (int q = 0; q < PIX; ++q) {
    const long long k = base + lane + 32 * q;
    d[q] = act[q] ? __ldg(desc + k) : 0.0f;
    gx[q] = act[q] ? __ldg(grad_x + k) : 0.0f;
    gy[q] = act[q] ? __ldg(grad_y + k) : 0.0f;
  }
}

template <int WY, int WX, int WP, int PIX, bool SPLIT>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
klt_track_kernel(KltLevels lv, KltParams prm, const float* __restrict__ ys,
                 const float* __restrict__ xs, float* __restrict__ out_y,
                 float* __restrict__ out_x, int* __restrict__ out_fault,
                 int* __restrict__ out_evals) {
  constexpr int kCopies = WY * WX / 32;  // window copies a lane
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n = blockIdx.x * kWarpsPerBlock + warp;
  if (n >= prm.n) return;  // the whole warp leaves; no block barrier is used
  const int stream = n / prm.per_stream;

  const int r = prm.radius;
  const int p = 2 * r + 1;
  const int area = p * p;
  const int sy = (WY - (p + 1)) / 2;
  const int sx = (WX - (p + 1)) / 2;
  const float margin_y = static_cast<float>(WY - p - 1);
  const float margin_x = static_cast<float>(WX - p - 1);
  const double rarea = 1.0 / static_cast<double>(area);
  float* win = smem + warp * (WY * WP);

  // this lane's patch slots: in-window offset from the patch's top-left
  // (an unused slot reads the first pixel and counts 0)
  bool act[PIX];
  int off[PIX];
#pragma unroll
  for (int q = 0; q < PIX; ++q) {
    const int k = lane + 32 * q;
    act[q] = k < area;
    const int a = k / p;
    off[q] = act[q] ? a * WP + (k - a * p) : 0;
  }

  const long long base = static_cast<long long>(n) * area;
  float d[PIX], gx[PIX], gy[PIX];
  {
    const int top = lv.n_levels - 1;
    load_templates<PIX>(lv.desc[top], lv.gx[top], lv.gy[top], base, lane,
                        act, d, gx, gy);
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

    // window origin: 8-row-aligned oy, both clamps (aligned_window_origin)
    const int oy_ideal = static_cast<int>(floorf(cy)) - r - sy;
    const int oy = min(max(floor_div(oy_ideal, kSublanes) * kSublanes, 0),
                       max((h / kSublanes) * kSublanes - WY, 0));
    const int ox = min(max(static_cast<int>(floorf(cx)) - r - sx, 0),
                       max(w - WX, 0));
    float py = cy - static_cast<float>(r) - static_cast<float>(oy);
    float px = cx - static_cast<float>(r) - static_cast<float>(ox);

    // the window, one round trip: win[i, j] = img[clamp(oy + i),
    // clamp(ox + j)]; the previous level's reads of it are over
    __syncwarp();
#pragma unroll
    for (int t = 0; t < kCopies; ++t) {
      const int k = lane + 32 * t;
      const int i = k / WX;
      const int j = k % WX;
      const int y = min(max(oy + i, 0), h - 1);
      const int x = min(max(ox + j, 0), w - 1);
      copy4_async(win + i * WP + j, img + static_cast<long long>(y) * w + x);
    }

    // the next level's templates, in flight while this level iterates
    float nd[PIX], ngx[PIX], ngy[PIX];
    if (l > 0)
      load_templates<PIX>(lv.desc[l - 1], lv.gx[l - 1], lv.gy[l - 1], base,
                          lane, act, nd, ngx, ngy);

    // this level's 2x2 normal matrix, while the window is in flight
    float gxx, gxy, gyy;
    {
      float vxx[PIX], vxy[PIX], vyy[PIX];
#pragma unroll
      for (int q = 0; q < PIX; ++q) {
        vxx[q] = gx[q] * gx[q];
        vxy[q] = gx[q] * gy[q];
        vyy[q] = gy[q] * gy[q];
      }
      gxx = lane_tree<PIX>(vxx);
      gxy = lane_tree<PIX>(vxy);
      gyy = lane_tree<PIX>(vyy);
      warp_sum3(gxx, gxy, gyy);
    }
    const float det = gxx * gyy - gxy * gxy;
    const bool ok_det = det / static_cast<float>(area) >= prm.min_determinant;
    const float safe_det = (det == 0.0f) ? 1.0f : det;
    const double rdet = 1.0 / static_cast<double>(safe_det);

    copies_wait();
    __syncwarp();

    // Gauss-Newton steps inside the window
    bool done = false;
    float last_abs = 0.0f;
    const int cap = prm.max_iterations;
    if constexpr (SPLIT) {
      // only the level's last evaluation (at the frozen position after a
      // converged step, or the cap's) sums its |error|, and the frozen one
      // nothing else; both are peeled off the loop
      float va[PIX], vx[PIX], vy[PIX];
      const auto step = [&](float bx_, float by_) {
        float dx, dy;
        quotients(gyy * bx_ - gxy * by_, gxx * by_ - gxy * bx_, safe_det,
                  rdet, dx, dy);
        py -= dy;
        px -= dx;
        done = fabsf(dx) < prm.convergence_tol
               && fabsf(dy) < prm.convergence_tol;
      };
      int it = 0;
      for (; it < cap - 1 && !done; ++it) {
        evaluate<WP, PIX>(win, py, px, margin_y, margin_x, off, act, d, gx,
                          gy, va, vx, vy);
        ++evals;
        float bx_ = lane_tree<PIX>(vx);
        float by_ = lane_tree<PIX>(vy);
        warp_sum2(bx_, by_);
        step(bx_, by_);
      }
      if (it < cap) {
        evaluate<WP, PIX>(win, py, px, margin_y, margin_x, off, act, d, gx,
                          gy, va, vx, vy);
        ++evals;
        last_abs = lane_tree<PIX>(va);
        if (done) {
          warp_sum1(last_abs);
        } else {
          float bx_ = lane_tree<PIX>(vx);
          float by_ = lane_tree<PIX>(vy);
          warp_sum3(last_abs, bx_, by_);
          step(bx_, by_);
        }
      }
    } else {
      for (int it = 0; it < cap; ++it) {
        float ea[PIX], ex[PIX], ey[PIX];
        evaluate<WP, PIX>(win, py, px, margin_y, margin_x, off, act, d, gx,
                          gy, ea, ex, ey);
        float s_abs = lane_tree<PIX>(ea);
        float bx_ = lane_tree<PIX>(ex);
        float by_ = lane_tree<PIX>(ey);
        warp_sum3(s_abs, bx_, by_);
        last_abs = s_abs;
        ++evals;
        if (done) break;  // that was the evaluation at the frozen position
        float dx, dy;
        quotients(gyy * bx_ - gxy * by_, gxx * by_ - gxy * bx_, safe_det,
                  rdet, dx, dy);
        py -= dy;
        px -= dx;
        done = fabsf(dx) < prm.convergence_tol
               && fabsf(dy) < prm.convergence_tol;
      }
    }
    const float per_pixel =
        quotient(last_abs, static_cast<float>(area), rarea);

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
#pragma unroll
      for (int q = 0; q < PIX; ++q) {
        d[q] = nd[q];
        gx[q] = ngx[q];
        gy[q] = ngy[q];
      }
    }
  }

  if (lane == 0) {
    out_y[n] = cy;
    out_x[n] = cx;
    out_fault[n] = fault;
    out_evals[n] = evals;
  }
}

// quotient() and quotients() on n triples, for the card test that holds
// them to the float division bit for bit: q[i] = a[i] / b[i] by quotient(),
// q[n + i] and q[2n + i] = a[i] / b[i] and c[i] / b[i] by quotients().
__global__ void quotient_test_kernel(const float* a, const float* b,
                                     const float* c, float* q, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const double rb = 1.0 / static_cast<double>(b[i]);
  q[i] = quotient(a[i], b[i], rb);
  quotients(a[i], c[i], b[i], rb, q[n + i], q[2 * n + i]);
}

template <int WY, int WX, int WP, int PIX, bool SPLIT>
int launch(const KltLevels* lv, const KltParams* prm, const KltBuffers* b,
           cudaStream_t s) {
  const int blocks = (prm->n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const size_t shared = sizeof(float) * kWarpsPerBlock * WY * WP;
  klt_track_kernel<WY, WX, WP, PIX, SPLIT>
      <<<blocks, 32 * kWarpsPerBlock, shared, s>>>(
          *lv, *prm, b->ys, b->xs, b->out_y, b->out_x, b->out_fault,
          b->out_evals);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launch on `stream` (torch's current stream); returns the cudaError_t of
// the launch (0 on success).  `lv`, `prm` and `b` are host structs, the
// first two passed on to the kernel by value; every pointer inside them is
// a device pointer.  The caller checks shapes, dtypes, contiguity and
// device.
int klt_track_launch(const KltLevels* lv, const KltParams* prm,
                     const KltBuffers* b, void* stream) {
  if (prm->n <= 0) return 0;
  if (lv->n_levels < 1 || lv->n_levels > KLT_MAX_LEVELS || prm->radius < 1
      || prm->per_stream < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int p = 2 * prm->radius + 1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p * p <= 64)  // 24x16 window, two patch pixels a lane
    return prm->n > kSplitAbove
               ? launch<24, 16, 20, 2, true>(lv, prm, b, s)
               : launch<24, 16, 20, 2, false>(lv, prm, b, s);
  if (p * p > 256) return static_cast<int>(cudaErrorInvalidValue);
  if (p + 2 <= 16)  // 24x16 window, eight a lane
    return launch<24, 16, 20, 8, false>(lv, prm, b, s);
  return launch<32, 32, 32, 8, false>(lv, prm, b, s);
}

// The step's quotients on n triples of device arrays (a test entry, see
// quotient_test_kernel); q holds 3n floats.
int klt_quotient_test_launch(const float* a, const float* b, const float* c,
                             float* q, int n, void* stream) {
  if (n <= 0) return 0;
  quotient_test_kernel<<<(n + 255) / 256, 256, 0,
                         static_cast<cudaStream_t>(stream)>>>(a, b, c, q, n);
  return static_cast<int>(cudaGetLastError());
}

const char* klt_track_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
