// Gauss-Newton pose refinement of B problems in one launch, for Hopper
// (sm_90a).
//
// Replaces no TPU kernel.  The JAX package's gauss_newton_pose
// (boofcv_tpu/geo/pnp.py) is a lax.while_loop that XLA fuses into a few
// device loops; the port's plain version, geo/pnp._gn_pose_loop, is eager
// PyTorch and launches about 110 small kernels an iteration (the stacks of
// the [N, 2, 6] Jacobian, two GEMMs, cholesky_ex, two triangular solves,
// exp_se3, compose, the frozen flag).  This kernel runs what
// geo/pnp._gn_pose_f32 computes: `iterations` float32 Gauss-Newton steps on
// se(3), then two float64 Newton-polar steps R (1.5 I - 0.5 R^T R).
//
// What it computes, step for step as the plain loop (float32 throughout):
//   Xc = R w + t; z = Xc.z, replaced by 1e-12 where |z| < 1e-12;
//   (x, y) = Xc.xy / z; r = (x, y) - obs;
//   J = [[-xy, 1 + x^2, -y, 1/z, 0, -x/z], [-(1 + y^2), xy, x, 0, 1/z, -y/z]];
//   H = sum (w J)^T J + damping I; g = sum J^T (w r);
//   L = chol(H), NaN everywhere when a pivot is not > 0 (or is NaN);
//   dx = -H^-1 g; (R, t) <- exp_se3(dx) o (R, t);
//   frozen <- frozen | !(max |dx| > step_tol).
// An update is applied only while no earlier step was at or under the
// tolerance; since a frozen problem's pose never changes again, the block
// leaves the loop there (the reference's early exit), with the same result.
// Sums run in another order than the plain version's GEMMs, so the two
// agree to float32 resolution, not bit for bit.
//
// Bound.  A problem reads 48 bytes a point (world, obs and weight in
// float64 as RANSAC passes them): 28.8 KB at N = 600, 8.6 ns at 3.35
// TB/s, and about 150 float32 operations a point and iteration, 4.5 MFLOP
// for 50 iterations (67 ns at 67 TFLOP/s).  Neither binds: each iteration
// hangs on the one before, through a block-wide sum of 27 numbers and a
// serial 6x6 Cholesky, two triangular solves, exp_se3 (sqrt, sin, cos) and
// a 3x3 product.  So the bound is that dependent chain, a few microseconds
// an iteration.
//
// Design: one block per problem, so B problems run side by side and a
// problem's result does not depend on its batch-mates.  Each thread walks
// the points by the block's stride, converts its inputs to float32 in
// registers (the plain loop's .to(float32)) and accumulates the 21 unique
// entries of J^T W J and the 6 of J^T W r; the warps sum them with xor
// shuffles, warp 0 adds the warps' partial sums, and its lane 0 solves,
// updates the pose in shared memory and sets the frozen flag.  The pose
// never leaves the SM between iterations: the whole refine is one launch
// and no round trip to device memory.  Inputs are re-read from L1/L2 each
// iteration (28.8 KB a problem), which keeps any N possible.

#include <cuda_runtime.h>
#include <math.h>

extern "C" {

// One launch's arguments, filled by the caller (a struct, so that the host
// passes one pointer).  Input pointers are device pointers to float32
// (flag 0) or float64 (flag 1) arrays, contiguous: R [B, 3, 3], t [B, 3],
// world [B, N, 3], obs [B, N, 2], wgt [B, N].  Outputs are float64.
struct GnPoseArgs {
  const void* R;
  const void* t;
  const void* world;
  const void* obs;
  const void* wgt;
  double* R_out;  // [B, 3, 3]
  double* t_out;  // [B, 3]
  int b, n, iterations;
  float damping, step_tol;
  int R_f64, t_f64, world_f64, obs_f64, wgt_f64;
};

}  // extern "C"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// the upper triangle of J^T W J row by row (21), then J^T W r (6)
constexpr int kSums = 27;

__device__ __forceinline__ float load(const void* p, int f64, long long i) {
  return f64 ? static_cast<float>(__ldg(static_cast<const double*>(p) + i))
             : __ldg(static_cast<const float*>(p) + i);
}

// c = a b for row-major 3x3 matrices.
template <typename T>
__device__ __forceinline__ void mul33(const T* a, const T* b, T* c) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      c[3 * i + j] = a[3 * i] * b[j] + a[3 * i + 1] * b[3 + j]
                     + a[3 * i + 2] * b[6 + j];
}

// dx = -H^-1 g from the 27 sums, H's diagonal raised by `damping`, by
// Cholesky; all NaN when a pivot is not > 0 (cholesky_ex's info != 0).
__device__ void gn_solve(const float* s, float damping, float* dx) {
  float H[6][6];
  int k = 0;
#pragma unroll
  for (int a = 0; a < 6; ++a)
#pragma unroll
    for (int b = a; b < 6; ++b) H[a][b] = H[b][a] = s[k++];
#pragma unroll
  for (int a = 0; a < 6; ++a) H[a][a] += damping;
  float L[6][6];
  bool ok = true;
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    float d = H[j][j];
#pragma unroll
    for (int m = 0; m < j; ++m) d -= L[j][m] * L[j][m];
    ok = ok && d > 0.f;
    L[j][j] = sqrtf(d);
#pragma unroll
    for (int i = j + 1; i < 6; ++i) {
      float e = H[i][j];
#pragma unroll
      for (int m = 0; m < j; ++m) e -= L[i][m] * L[j][m];
      L[i][j] = e / L[j][j];
    }
  }
  float y[6], x[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float e = s[21 + i];
#pragma unroll
    for (int m = 0; m < i; ++m) e -= L[i][m] * y[m];
    y[i] = e / L[i][i];
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float e = y[i];
#pragma unroll
    for (int m = i + 1; m < 6; ++m) e -= L[m][i] * x[m];
    x[i] = e / L[i][i];
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) dx[i] = ok ? -x[i] : __int_as_float(0x7fc00000);
}

// geo/se3.exp_se3 in float32, small-angle branches included: dR
// (row-major) and dt of xi = (w, v).
__device__ void exp_se3(const float* xi, float* dR, float* dt) {
  const float wx = xi[0], wy = xi[1], wz = xi[2];
  const float t2 = wx * wx + wy * wy + wz * wz;
  const float K[9] = {0.f, -wz, wy, wz, 0.f, -wx, -wy, wx, 0.f};
  float K2[9];
  mul33(K, K, K2);
  const bool small = t2 < 1e-14f;
  const float t2s = small ? 1.f : t2;
  const float theta = sqrtf(t2s);
  const float sn = sinf(theta), cs = cosf(theta);
  const float a = small ? 1.f - t2 / 6.f : sn / theta;
  const float b = small ? 0.5f - t2 / 24.f : (1.f - cs) / t2s;
  const float c = small ? 1.f / 6.f - t2 / 120.f
                        : (theta - sn) / (t2s * theta);
  float V[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    const float eye = (k % 4 == 0) ? 1.f : 0.f;
    dR[k] = eye + a * K[k] + b * K2[k];
    V[k] = eye + b * K[k] + c * K2[k];
  }
#pragma unroll
  for (int i = 0; i < 3; ++i)
    dt[i] = V[3 * i] * xi[3] + V[3 * i + 1] * xi[4] + V[3 * i + 2] * xi[5];
}

__global__ void __launch_bounds__(kThreads) gn_pose_kernel(const GnPoseArgs a) {
  __shared__ float part[kWarps][kSums];
  __shared__ float sums[kSums];
  __shared__ float pose[12];  // R row-major, then t
  __shared__ int frozen;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long p = blockIdx.x;
  if (tid < 9)
    pose[tid] = load(a.R, a.R_f64, p * 9 + tid);
  else if (tid < 12)
    pose[tid] = load(a.t, a.t_f64, p * 3 + tid - 9);
  if (tid == 0) frozen = 0;
  __syncthreads();
  const long long first = p * a.n;
  for (int it = 0; it < a.iterations && !frozen; ++it) {
    float R[9], t[3];
#pragma unroll
    for (int k = 0; k < 9; ++k) R[k] = pose[k];
#pragma unroll
    for (int k = 0; k < 3; ++k) t[k] = pose[9 + k];
    float acc[kSums];
#pragma unroll
    for (int k = 0; k < kSums; ++k) acc[k] = 0.f;
    for (int i = tid; i < a.n; i += kThreads) {
      const long long q = first + i;
      const float X = load(a.world, a.world_f64, 3 * q);
      const float Y = load(a.world, a.world_f64, 3 * q + 1);
      const float Z = load(a.world, a.world_f64, 3 * q + 2);
      const float u = load(a.obs, a.obs_f64, 2 * q);
      const float v = load(a.obs, a.obs_f64, 2 * q + 1);
      const float w = load(a.wgt, a.wgt_f64, q);
      const float xc = R[0] * X + R[1] * Y + R[2] * Z + t[0];
      const float yc = R[3] * X + R[4] * Y + R[5] * Z + t[1];
      float z = R[6] * X + R[7] * Y + R[8] * Z + t[2];
      if (fabsf(z) < 1e-12f) z = 1e-12f;
      const float iz = 1.f / z;
      const float x = xc * iz;
      const float y = yc * iz;
      const float jx[6] = {-(x * y), 1.f + x * x, -y, iz, 0.f, -(x * iz)};
      const float jy[6] = {-(1.f + y * y), x * y, x, 0.f, iz, -(y * iz)};
      const float wrx = (x - u) * w;
      const float wry = (y - v) * w;
      int k = 0;
#pragma unroll
      for (int r = 0; r < 6; ++r) {
        // (w J)^T J as the plain loop weights it: w J first, so that a
        // masked row (w = 0) adds 0 even where J is huge
        const float ax = jx[r] * w, ay = jy[r] * w;
#pragma unroll
        for (int c = r; c < 6; ++c) acc[k++] += ax * jx[c] + ay * jy[c];
      }
#pragma unroll
      for (int r = 0; r < 6; ++r) acc[21 + r] += jx[r] * wrx + jy[r] * wry;
    }
#pragma unroll
    for (int k = 0; k < kSums; ++k) {
      float s = acc[k];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, off);
      if (lane == 0) part[warp][k] = s;
    }
    __syncthreads();
    if (warp == 0) {
      if (lane < kSums) {
        float s = part[0][lane];
#pragma unroll
        for (int w = 1; w < kWarps; ++w) s += part[w][lane];
        sums[lane] = s;
      }
      __syncwarp();
      if (lane == 0) {
        float dx[6], dR[9], dt[3], Rn[9];
        gn_solve(sums, a.damping, dx);
        exp_se3(dx, dR, dt);
        mul33(dR, R, Rn);
#pragma unroll
        for (int k = 0; k < 9; ++k) pose[k] = Rn[k];
#pragma unroll
        for (int i = 0; i < 3; ++i)
          pose[9 + i] = dR[3 * i] * t[0] + dR[3 * i + 1] * t[1]
                        + dR[3 * i + 2] * t[2] + dt[i];
        // torch.amax propagates NaN: a NaN step freezes the problem
        float big = 0.f;
        bool nan = false;
#pragma unroll
        for (int k = 0; k < 6; ++k) {
          nan = nan || isnan(dx[k]);
          big = fmaxf(big, fabsf(dx[k]));
        }
        frozen = nan || !(big > a.step_tol);
      }
    }
    __syncthreads();
  }
  if (tid == 0) {
    // two Newton-polar steps R (1.5 I - 0.5 R^T R) in float64
    double Rd[9], M[9], A[9], Rt[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) Rd[k] = pose[k];
#pragma unroll
    for (int step = 0; step < 2; ++step) {
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j) Rt[3 * i + j] = Rd[3 * j + i];
      mul33(Rt, Rd, M);
#pragma unroll
      for (int k = 0; k < 9; ++k)
        A[k] = ((k % 4 == 0) ? 1.5 : 0.0) - 0.5 * M[k];
      mul33(Rd, A, M);
#pragma unroll
      for (int k = 0; k < 9; ++k) Rd[k] = M[k];
    }
#pragma unroll
    for (int k = 0; k < 9; ++k) a.R_out[p * 9 + k] = Rd[k];
#pragma unroll
    for (int k = 0; k < 3; ++k) a.t_out[p * 3 + k] = pose[9 + k];
  }
}

}  // namespace

extern "C" {

// Launch on `stream` (torch's current stream), one block per problem;
// returns the cudaError_t of the launch (0 on success).  The caller checks
// shapes, dtypes, contiguity and device.
int gn_pose_launch(const GnPoseArgs* a, void* stream) {
  if (a->b <= 0) return 0;
  if (a->n < 0 || a->iterations < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  gn_pose_kernel<<<a->b, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      *a);
  return static_cast<int>(cudaGetLastError());
}

const char* gn_pose_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
