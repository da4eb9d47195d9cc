// The P3P RANSAC bank of B streams in one launch, for Hopper (sm_90a).
//
// Replaces no TPU kernel.  The JAX package's bank (boofcv_tpu/geo/robust.py
// ransac with pnp.p3p_grunert and reprojection_error_sq) is a handful of
// batched ops that XLA fuses; the port's plain route, geo/robust.ransac on
// the same solver and scorer, is eager PyTorch and launches about 390 small
// kernels a call.  This kernel computes what that route computes for
// ransac_pnp(p3p="grunert"):
//   1. for each index set (K a stream, from robust.sample_indices or the
//      caller), Grunert's P3P with its four solutions, in the precision
//      pnp.p3p_grunert(dtype=float32) runs: the front half in float32, the
//      resolvent cubic's three-root branch and everything after it in
//      float64 (smalllinalg.cubic_roots promotes it through a float64
//      arange; the single-root branch is float32, promoted afterwards), and
//      rigid_from_three_points in float32;
//   2. every solution against every point of its stream in float32, as
//      pnp.reprojection_error_sq: Xc = R w + t, z replaced by 1e-12 where
//      |z| < 1e-12, err = |Xc.xy / z - obs|^2, +inf where z <= 0; inf where
//      the solution is not ok, the error is NaN or the point is masked;
//   3. each solution's inlier count (err <= thr) and MSAC sum
//      (min(err, thr)), reduced in one fixed order (each thread's points in
//      turn, then xor shuffles, then the warps in turn), so the same inputs
//      give the same bits on every run;
//   4. each stream's winner: the largest counts - msac / (worst + 1), the
//      ratio in float32 and the difference in float64, worst the stream's
//      largest MSAC, the first index on ties and NaN above all (as
//      torch.argmax);
//   5. the winner's R, t, ok, inlier count and MSAC, and its inlier mask,
//      re-scored with the same device function.
// Each op is written as PyTorch's CUDA op computes it, so that the kernel
// gives the plain route's bits where that route's ops are elementwise or
// small reductions: the float64 stages where PyTorch promotes; a Python
// scalar divisor as a multiply by its float32 reciprocal; a norm or sum
// over 3 as (x0 + x2) + x1 (the reduction's lanes); cross products as
// fma(a, b, -(c d)); the 3 x 3 products as an FMA chain, the
// matrix-vector one as fma(a1, b1, a0 b0) + a2 b2; the mean of three as
// their sum times 1/3.  The file is built with -fmad=false, so every
// other product and sum is rounded on its own, as the eager ops round it.
// The MSAC sums run in another order than torch.sum's, so they agree to
// rounding.
//
// Bound.  A stream's bank reads its points (world and obs, 40 bytes a point
// in float64) and K index sets, and writes N + a few bytes: 29 KB at
// N = 600, K = 200, 9 ns at 3.35 TB/s.  The scoring is ~25 float32
// operations a point and solution, 12 MFLOP a stream at K = 200 and
// N = 600: 0.18 us at 67 TFLOP/s, which binds.  What sets the time is the
// solve's dependent chain in one lane (a cubic and quartic with float64
// acos/cos/sqrt) ahead of the scoring, hidden by running many blocks an SM.
//
// Design: one block a (stream, sample).  Lane 0 reads the sample and solves
// the quartic into shared memory; lanes 0-3 each finish one root (the side
// lengths and the rigid alignment); then the block's threads stride over
// the stream's points, scoring all four solutions from one load of each
// point (the points stay in L2: every block of a stream reads them).  Each
// block writes its four solutions (pose, ok, count, MSAC) to scratch; the
// stream's last block to finish (an atomic ticket taken after
// __threadfence) makes the selection and writes the outputs, and returns
// its ticket to 0, so one launch does a call and the next launch finds the
// tickets zero.  The block size follows N.  The kernel allocates nothing.

#include <cuda_runtime.h>
#include <math.h>

extern "C" {

// One launch's arguments, filled by the caller.  Inputs are device pointers
// to contiguous arrays: world [B, N, 3] and obs [B, N, 2] in float32 (flag
// 0) or float64 (flag 1), idx [B, K, 3] int64, valid [B, N] bool or null
// (every point valid).  sol is scratch of B * K * 4 * 16 floats; tickets
// [B] must be zero and are left zero.  Outputs: R [B, 3, 3], t [B, 3], the
// winner's MSAC [B] (float32), its inlier count [B] (int64), ok [B] and the
// inlier mask [B, N] (bool).
struct PnpBankArgs {
  const void* world;
  const void* obs;
  const long long* idx;
  const unsigned char* valid;
  float* sol;
  unsigned int* tickets;
  float* R_out;
  float* t_out;
  float* err_out;
  long long* count_out;
  unsigned char* ok_out;
  unsigned char* inliers_out;
  int b, n, k;
  float thr;
  int world_f64, obs_f64;
};

}  // extern "C"

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxWarps = kMaxThreads / 32;
// a solution in scratch: R (9, row-major), t (3), ok, inlier count (int
// bits), MSAC, padding
constexpr int kSolWords = 16;
constexpr int kOk = 12, kCount = 13, kMsac = 14;
constexpr float kThird = 1.0f / 3.0f;     // 1 / 3.0 as PyTorch's float32 op
constexpr float kInv27 = 1.0f / 27.0f;
constexpr float kInv256 = 1.0f / 256.0f;
// cubic_roots' 2 pi k / 3 in float64: (2.0 * math.pi) * k, times 1 / 3.0
constexpr double kTwoPi = 6.283185307179586;
constexpr double kThirdD = 1.0 / 3.0;

__device__ __forceinline__ float load(const void* p, int f64, long long i) {
  return f64 ? static_cast<float>(__ldg(static_cast<const double*>(p) + i))
             : __ldg(static_cast<const float*>(p) + i);
}

// torch.clamp's one-sided forms: NaN passes through
template <typename T>
__device__ __forceinline__ T clamp_min(T x, T lo) {
  return isnan(x) ? x : (x < lo ? lo : x);
}
template <typename T>
__device__ __forceinline__ T clamp_max(T x, T hi) {
  return isnan(x) ? x : (x > hi ? hi : x);
}

// torch.where(|x| < eps, eps, x)
__device__ __forceinline__ double guard(double x, double eps) {
  return fabs(x) < eps ? eps : x;
}

// smalllinalg._cbrt in float32: sign(x) * |x| ** (1/3)
__device__ __forceinline__ float cbrt_t(float x) {
  const float s = static_cast<float>((0.0f < x) - (x < 0.0f));
  return s * powf(fabsf(x), kThird);
}

// max that propagates NaN (torch.amax)
__device__ __forceinline__ double nan_max(double a, double b) {
  if (isnan(a) || isnan(b)) return NAN;
  return a > b ? a : b;
}
__device__ __forceinline__ float nan_max(float a, float b) {
  if (isnan(a) || isnan(b)) return NAN;
  return a > b ? a : b;
}

// torch.linalg.norm and torch.sum over a last axis of 3, as the CUDA
// reduction adds its lanes
__device__ __forceinline__ float norm3(float x, float y, float z) {
  return sqrtf((x * x + z * z) + y * y);
}
__device__ __forceinline__ float dot3(const float* a, const float* b) {
  return (a[0] * b[0] + a[2] * b[2]) + a[1] * b[1];
}

// smalllinalg.quartic_roots on float32 coefficients: roots [4] in float64
// and which are real.  The resolvent cubic (cubic_roots) runs in float32
// to its branch; its three-root branch is float64 from theta on.
__device__ void quartic_roots(float c4, float c3, float c2, float c1,
                              float c0, double* roots, bool* real) {
  // the 1e-300 guard rounds to 0 in float32: c4 as it is
  const float a = c3 / c4, b = c2 / c4, c = c1 / c4, d = c0 / c4;
  const float p = b - 3.0f * a * a * 0.125f;
  const float q = c - a * b * 0.5f + a * a * a * 0.125f;
  const float r = d - a * c * 0.25f + a * a * b * 0.0625f
                  - 3.0f * powf(a, 4.0f) * kInv256;
  const float shift = -a * 0.25f;

  // cubic_roots(1, p, p p / 4 - r, -q q / 8)
  const float cb = p;
  const float cc = p * p * 0.25f - r;
  const float cd = -q * q * 0.125f;
  const float cp = cc - cb * cb * kThird;
  const float cq = 2.0f * (cb * cb * cb) * kInv27 - cb * cc * kThird + cd;
  const float hq = cq * 0.5f, tp = cp * kThird;
  const float disc = hq * hq + tp * tp * tp;
  const float cshift = -cb * kThird;
  double mroot;
  if (disc > 0.0f) {
    const float sq = sqrtf(clamp_min(disc, 0.0f));
    const float u = cbrt_t(-cq * 0.5f + sq);
    const float v = cbrt_t(-cq * 0.5f - sq);
    mroot = static_cast<double>(u + v + cshift);
  } else {
    const float pm = isnan(cp) ? cp : fminf(cp, -0.0f);  // max=-1e-300
    const float m = 2.0f * sqrtf(-pm * kThird);
    const float arg = clamp_max(clamp_min(3.0f * cq / (pm * m), -1.0f), 1.0f);
    const float theta = acosf(arg) * kThird;
    mroot = -INFINITY;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const double ang = kTwoPi * static_cast<double>(k) * kThirdD;
      const double rk = static_cast<double>(m)
                            * cos(static_cast<double>(theta) - ang)
                        + static_cast<double>(cshift);
      mroot = nan_max(mroot, rk);
    }
  }
  const double m = clamp_min(mroot, 1e-300);
  const double sqrt2m = sqrt(2.0 * m);
  const double qs = guard(sqrt2m, 1e-300);
  const double ph = static_cast<double>(p * 0.5f);
  const double qq = static_cast<double>(q) / (2.0 * qs);
  const double C_plus = ph + m - qq;
  const double C_minus = ph + m + qq;
  const double d12 = m * 0.5 - C_plus, d34 = m * 0.5 - C_minus;
  const double s12 = sqrt(clamp_min(d12, 0.0));
  const double s34 = sqrt(clamp_min(d34, 0.0));
  const double sh = static_cast<double>(shift);
  roots[0] = -qs * 0.5 + s12 + sh;
  roots[1] = -qs * 0.5 - s12 + sh;
  roots[2] = qs * 0.5 + s34 + sh;
  roots[3] = qs * 0.5 - s34 + sh;
  real[0] = real[1] = d12 >= 0.0;
  real[2] = real[3] = d34 >= 0.0;
}

// One sample's quantities, shared by the block: the bearings and world
// points in float32, the P3P scalars and the quartic's roots.
struct Sample {
  float f[3][3];
  float w[3][3];
  float q1, c2, ca, cb, cg;
  double v[4];
  bool real[4];
  bool bad;          // an index outside [0, N): no solution
};

// Lane 0: read sample `s` of stream `sb` and solve up to the roots.
__device__ void solve_front(const PnpBankArgs& a, int sb, int sk,
                            Sample& S) {
  const long long* id = a.idx + (static_cast<long long>(sb) * a.k + sk) * 3;
  long long j[3];
  S.bad = false;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    j[i] = id[i];
    S.bad = S.bad || j[i] < 0 || j[i] >= a.n;
  }
  if (S.bad) return;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const long long pt = static_cast<long long>(sb) * a.n + j[i];
#pragma unroll
    for (int c = 0; c < 3; ++c) S.w[i][c] = load(a.world, a.world_f64,
                                                 pt * 3 + c);
    const float ox = load(a.obs, a.obs_f64, pt * 2);
    const float oy = load(a.obs, a.obs_f64, pt * 2 + 1);
    const float nf = norm3(ox, oy, 1.0f);
    S.f[i][0] = ox / nf;
    S.f[i][1] = oy / nf;
    S.f[i][2] = 1.0f / nf;
  }
  const float(*w)[3] = S.w;
  const float(*f)[3] = S.f;
  const float a_ = norm3(w[1][0] - w[2][0], w[1][1] - w[2][1],
                         w[1][2] - w[2][2]);
  const float b_ = norm3(w[0][0] - w[2][0], w[0][1] - w[2][1],
                         w[0][2] - w[2][2]);
  const float c_ = norm3(w[0][0] - w[1][0], w[0][1] - w[1][1],
                         w[0][2] - w[1][2]);
  const float ca = dot3(f[1], f[2]);
  const float cb = dot3(f[0], f[2]);
  const float cg = dot3(f[0], f[1]);
  const float a2 = a_ * a_, b2 = b_ * b_, c2 = c_ * c_;
  const float q1 = (a2 - c2) / b2;
  const float q2 = (a2 + c2) / b2;
  const float q3 = (b2 - c2) / b2;
  const float q4 = (b2 - a2) / b2;
  const float ca2 = ca * ca, cb2 = cb * cb, cg2 = cg * cg;
  const float A4 = (q1 - 1.0f) * (q1 - 1.0f) - 4.0f * c2 / b2 * ca2;
  const float A3 = 4.0f * (q1 * (1.0f - q1) * cb - (1.0f - q2) * ca * cg
                           + 2.0f * c2 / b2 * ca2 * cb);
  const float A2 = 2.0f * (q1 * q1 - 1.0f + 2.0f * (q1 * q1) * cb2
                           + 2.0f * q3 * ca2 - 4.0f * q2 * ca * cb * cg
                           + 2.0f * q4 * cg2);
  const float A1 = 4.0f * (-q1 * (1.0f + q1) * cb
                           + 2.0f * a2 / b2 * cg2 * cb
                           - (1.0f - q2) * ca * cg);
  const float A0 = (1.0f + q1) * (1.0f + q1) - 4.0f * a2 / b2 * cg2;
  quartic_roots(A4, A3, A2, A1, A0, S.v, S.real);
  S.q1 = q1;
  S.c2 = c2;
  S.ca = ca;
  S.cb = cb;
  S.cg = cg;
}

// rigid_from_three_points' orthonormal triangle frame of p [3 points][3],
// as columns e1, e2, e3: E[k] is e_{k+1}.
__device__ void frame(const float p[3][3], float E[3][3]) {
  float u[3], v[3], w[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    u[c] = p[1][c] - p[0][c];
    v[c] = p[2][c] - p[0][c];
  }
  const float nu = clamp_min(norm3(u[0], u[1], u[2]), 1e-30f);
#pragma unroll
  for (int c = 0; c < 3; ++c) E[0][c] = u[c] / nu;
  const float d = dot3(v, E[0]);
#pragma unroll
  for (int c = 0; c < 3; ++c) w[c] = v[c] - d * E[0][c];
  const float nw = clamp_min(norm3(w[0], w[1], w[2]), 1e-30f);
#pragma unroll
  for (int c = 0; c < 3; ++c) E[1][c] = w[c] / nw;
  // torch.linalg.cross
  E[2][0] = __fmaf_rn(E[0][1], E[1][2], -(E[0][2] * E[1][1]));
  E[2][1] = __fmaf_rn(E[0][2], E[1][0], -(E[0][0] * E[1][2]));
  E[2][2] = __fmaf_rn(E[0][0], E[1][1], -(E[0][1] * E[1][0]));
}

// Lane s of 0-3: root s of the sample to a pose (R, t) and its flag, into
// sol[kSolWords].
__device__ void solve_root(const Sample& S, int s, float* sol) {
  if (S.bad) {
#pragma unroll
    for (int i = 0; i < 12; ++i) sol[i] = NAN;
    sol[kOk] = 0.0f;
    return;
  }
  const double v = S.v[s];
  const double q1 = S.q1, cg = S.cg;
  const double num = static_cast<double>(S.q1 - 1.0f) * v * v
                     - static_cast<double>(2.0f * S.q1 * S.cb) * v + 1.0
                     + q1;
  const double den = guard(2.0 * (cg - v * static_cast<double>(S.ca)),
                           1e-30);
  const double u = num / den;
  const double s1sq = guard(1.0 + u * u - 2.0 * u * cg, 1e-30);
  const double s1 = sqrt(clamp_min(static_cast<double>(S.c2) / s1sq, 0.0));
  const double sd[3] = {s1, u * s1, v * s1};
  const bool ok = S.real[s] && sd[0] > 0.0 && sd[1] > 0.0 && sd[2] > 0.0;
  float cam[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int c = 0; c < 3; ++c)
      cam[i][c] = static_cast<float>(sd[i] * static_cast<double>(S.f[i][c]));
  float Ew[3][3], Ec[3][3];
  frame(S.w, Ew);
  frame(cam, Ec);
  // R = Bc Bw^T: R[i][j] = sum_k Ec[k][i] Ew[k][j], the GEMM's FMA chain
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      sol[3 * i + j] = __fmaf_rn(
          Ec[2][i], Ew[2][j],
          __fmaf_rn(Ec[1][i], Ew[1][j], Ec[0][i] * Ew[0][j]));
  float cw[3], cc[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    cw[c] = (S.w[0][c] + S.w[1][c] + S.w[2][c]) * kThird;
    cc[c] = (cam[0][c] + cam[1][c] + cam[2][c]) * kThird;
  }
  // t = cc - R cw, the batched matrix-vector product's order
#pragma unroll
  for (int i = 0; i < 3; ++i)
    sol[9 + i] = cc[i] - (__fmaf_rn(sol[3 * i + 1], cw[1],
                                    sol[3 * i] * cw[0])
                          + sol[3 * i + 2] * cw[2]);
  sol[kOk] = ok ? 1.0f : 0.0f;
}

// The squared reprojection error of one point under one solution, inf
// where it is unusable (not ok, behind the camera, NaN, masked).
__device__ __forceinline__ float point_error(const float* sol, float wx,
                                             float wy, float wz, float ox,
                                             float oy, bool valid) {
  // world R^T as the GEMM's FMA chain, then + t
  const float X = __fmaf_rn(sol[2], wz, __fmaf_rn(sol[1], wy, sol[0] * wx))
                  + sol[9];
  const float Y = __fmaf_rn(sol[5], wz, __fmaf_rn(sol[4], wy, sol[3] * wx))
                  + sol[10];
  const float Z = __fmaf_rn(sol[8], wz, __fmaf_rn(sol[7], wy, sol[6] * wx))
                  + sol[11];
  const float z = fabsf(Z) < 1e-12f ? 1e-12f : Z;
  const float dx = X / z - ox, dy = Y / z - oy;
  float e = dx * dx + dy * dy;
  if (Z <= 0.0f) e = INFINITY;
  if (!(sol[kOk] != 0.0f) || !valid || isnan(e)) e = INFINITY;
  return e;
}

// torch.argmax's order on (value, index): larger first, NaN above all, the
// lower index on ties.  bj < 0 is "none yet".
__device__ __forceinline__ bool better(double o, int j, double bo, int bj) {
  if (bj < 0) return true;
  const bool on = isnan(o), bn = isnan(bo);
  if (on != bn) return on;
  if (!on && o != bo) return o > bo;
  return j < bj;
}

__device__ __forceinline__ void load_point(const PnpBankArgs& a, long long pt,
                                           float* p, bool* valid) {
  p[0] = load(a.world, a.world_f64, pt * 3);
  p[1] = load(a.world, a.world_f64, pt * 3 + 1);
  p[2] = load(a.world, a.world_f64, pt * 3 + 2);
  p[3] = load(a.obs, a.obs_f64, pt * 2);
  p[4] = load(a.obs, a.obs_f64, pt * 2 + 1);
  *valid = a.valid == nullptr || a.valid[pt] != 0;
}

__global__ void __launch_bounds__(kMaxThreads)
pnp_bank_kernel(const PnpBankArgs a) {
  __shared__ Sample S;
  __shared__ float sol[4][kSolWords];
  __shared__ int warp_count[kMaxWarps][4];
  __shared__ float warp_msac[kMaxWarps][4];
  __shared__ double warp_best[kMaxWarps];
  __shared__ int warp_best_j[kMaxWarps];
  __shared__ int last;

  const int sk = blockIdx.x, sb = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthreads = blockDim.x, nwarps = nthreads >> 5;
  const int n = a.n;
  const long long row = static_cast<long long>(sb) * n;

  if (tid == 0) solve_front(a, sb, sk, S);
  __syncthreads();
  if (tid < 4) solve_root(S, tid, sol[tid]);
  __syncthreads();

  // 4 solutions x N points: counts and MSAC sums
  int count[4] = {0, 0, 0, 0};
  float msac[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int i = tid; i < n; i += nthreads) {
    float p[5];
    bool valid;
    load_point(a, row + i, p, &valid);
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const float e = point_error(sol[s], p[0], p[1], p[2], p[3], p[4],
                                  valid);
      count[s] += e <= a.thr;
      msac[s] += fminf(e, a.thr);
    }
  }
#pragma unroll
  for (int s = 0; s < 4; ++s) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      count[s] += __shfl_xor_sync(0xffffffffu, count[s], off);
      msac[s] += __shfl_xor_sync(0xffffffffu, msac[s], off);
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      warp_count[warp][s] = count[s];
      warp_msac[warp][s] = msac[s];
    }
  }
  __syncthreads();
  float* bank = a.sol + static_cast<long long>(sb) * a.k * 4 * kSolWords;
  if (tid < 4) {
    int c = 0;
    float m = 0.0f;
    for (int w = 0; w < nwarps; ++w) {
      c += warp_count[w][tid];
      m += warp_msac[w][tid];
    }
    float* out = bank + (static_cast<long long>(sk) * 4 + tid) * kSolWords;
#pragma unroll
    for (int i = 0; i < 13; ++i) out[i] = sol[tid][i];
    out[kCount] = __int_as_float(c);
    out[kMsac] = m;
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(a.tickets + sb, 1u) == a.k - 1u;
  __syncthreads();
  if (!last) return;

  // the stream's last block: its winner, from every block's scratch
  __threadfence();
  const int M = 4 * a.k;
  float worst = -INFINITY;
  for (int j = tid; j < M; j += nthreads)
    worst = nan_max(worst, __ldcg(bank + j * kSolWords + kMsac));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    worst = nan_max(worst, __shfl_xor_sync(0xffffffffu, worst, off));
  if (lane == 0) warp_msac[warp][0] = worst;
  __syncthreads();
  worst = warp_msac[0][0];
  for (int w = 1; w < nwarps; ++w) worst = nan_max(worst, warp_msac[w][0]);
  const float scale = worst + 1.0f;
  double best = 0.0;
  int best_j = -1;
  for (int j = tid; j < M; j += nthreads) {
    const float* e = bank + j * kSolWords;
    const double o = static_cast<double>(__float_as_int(__ldcg(e + kCount)))
                     - static_cast<double>(__ldcg(e + kMsac) / scale);
    if (better(o, j, best, best_j)) {
      best = o;
      best_j = j;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const double o = __shfl_xor_sync(0xffffffffu, best, off);
    const int j = __shfl_xor_sync(0xffffffffu, best_j, off);
    if (j >= 0 && better(o, j, best, best_j)) {
      best = o;
      best_j = j;
    }
  }
  if (lane == 0) {
    warp_best[warp] = best;
    warp_best_j[warp] = best_j;
  }
  __syncthreads();
  if (tid < kSolWords) {
    best = warp_best[0];
    best_j = warp_best_j[0];
    for (int w = 1; w < nwarps; ++w)
      if (warp_best_j[w] >= 0
          && better(warp_best[w], warp_best_j[w], best, best_j)) {
        best = warp_best[w];
        best_j = warp_best_j[w];
      }
    sol[0][tid] = __ldcg(bank + best_j * kSolWords + tid);
  }
  __syncthreads();
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < 9; ++i) a.R_out[sb * 9 + i] = sol[0][i];
#pragma unroll
    for (int i = 0; i < 3; ++i) a.t_out[sb * 3 + i] = sol[0][9 + i];
    a.ok_out[sb] = sol[0][kOk] != 0.0f;
    a.count_out[sb] = __float_as_int(sol[0][kCount]);
    a.err_out[sb] = sol[0][kMsac];
    a.tickets[sb] = 0u;
  }
  for (int i = tid; i < n; i += nthreads) {
    float p[5];
    bool valid;
    load_point(a, row + i, p, &valid);
    a.inliers_out[row + i] =
        point_error(sol[0], p[0], p[1], p[2], p[3], p[4], valid) <= a.thr;
  }
}

// Threads a block: a warp for each 128 points (four solutions each), from
// 2 to 8 warps.
int block_threads(int n) {
  const int warps = (n + 127) / 128;
  return 32 * (warps < 2 ? 2 : (warps > kMaxWarps ? kMaxWarps : warps));
}

}  // namespace

extern "C" {

// Launch on `stream` (torch's current stream): a block for each sample of
// each stream, K x B; returns the cudaError_t of the launch (0 on
// success).  The caller checks shapes, dtypes, contiguity and device, and
// that B <= 65535, K >= 1 and N >= 1.
int pnp_bank_launch(const PnpBankArgs* a, void* stream) {
  if (a->b <= 0) return 0;
  if (a->n < 1 || a->k < 1 || a->b > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(a->k, a->b);
  pnp_bank_kernel<<<grid, block_threads(a->n), 0,
                    static_cast<cudaStream_t>(stream)>>>(*a);
  return static_cast<int>(cudaGetLastError());
}

const char* pnp_bank_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
