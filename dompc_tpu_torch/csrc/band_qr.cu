// Banded Householder-QR sweep over N independent block-tridiagonal chains.
//
// Solves  A_n x_n = r_n  for every chain n, where A_n has diagonal blocks
// D (S, b, b), super-diagonal blocks U (S-1, b, b) (stage k rows, stage k+1
// columns), sub-diagonal blocks Lo (S-1, b, b) (stage k+1 rows, stage k
// columns), and r_n has t right-hand-side columns.
//
// Replaces the TPU kernels of dompc_tpu/solver/pallas_band.py:
//   _band_fwd_kernel (l.244, host function band_solve_qr_pallas_lanes l.329) and
//   _band_bwd_kernel (l.281), i.e. the forward elimination and the back
//   substitution, here in ONE kernel.  The TPU split the sweep into two
//   pallas_calls only because Mosaic has no dynamic VMEM indexing; a CUDA
//   block indexes its own stages.
//
// Design (one thread block per chain):
//   * The (2b, 3b+t) stage panel [carry ; L_{k-1} D_k U_k r_k] sits in
//     shared memory (26 x 51 at the flagship b=13, t=12: 5.3 KB in float,
//     10.6 KB in double).
//   * Each Householder column step: warp 0 computes the max-abs scale and
//     the scaled norm of the column with warp shuffles (the scaling keeps
//     1e22 barrier diagonals from overflowing the sum of squares in float);
//     then every thread owns panel columns and applies the rank-1 update
//     to them.  The reflector is exactly pallas_band.py:196-209, with the
//     same vtv > 1e-30 and |d| > 1e-30 guards.
//   * The top b rows of each eliminated panel [R_k | B_k | C_k | c_k] go to
//     a global scratch F (allocated by the caller); back substitution
//     x_k = R_k^{-1} (c_k - B_k x_{k+1} - C_k x_{k+2}) reads them back, one
//     thread per right-hand-side column.
//
// What bounds it on an H100: neither bytes nor flops.  At the flagship
// (S=21, b=13, t=12) a chain reads and writes ~67 KB in float and does
// ~1.2 MFLOP, but its S*b = 273 column steps
// are a chain of dependent shared-memory reductions with two block
// barriers each, so one block's time is latency (barriers, shuffles,
// shared-memory round trips).  At the solver's batch of one (9 chains)
// only 9 of 132 SMs are busy; throughput comes from more chains per launch
// (N = 9 * batch), not from a faster single chain.  Making one chain
// faster (several chains per block, the panel in registers, fewer
// barriers) is later work.
#include <cuda_runtime.h>

extern __shared__ __align__(16) unsigned char band_qr_smem[];

__device__ __forceinline__ float absval(float a) { return fabsf(a); }
__device__ __forceinline__ double absval(double a) { return fabs(a); }
__device__ __forceinline__ float maxval(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double maxval(double a, double b) { return fmax(a, b); }
__device__ __forceinline__ float sqrtval(float a) { return sqrtf(a); }
__device__ __forceinline__ double sqrtval(double a) { return sqrt(a); }

// Householder-eliminate the first n_elim columns of the (m, ncols) panel P
// (row stride ld) in place.  v: shared scratch of m entries; sc: one
// shared scalar.  Columns left of the current pivot are not updated: no
// later step reads them.
template <typename T>
__device__ void eliminate(T* P, int ld, int m, int n_elim, int ncols, T* v,
                          T* sc) {
  const int tid = threadIdx.x;
  for (int j = 0; j < n_elim; ++j) {
    if (tid < 32) {
      const int lane = tid;
      T amax = T(0);
      for (int i = j + lane; i < m; i += 32) amax = maxval(amax, absval(P[i * ld + j]));
      for (int o = 16; o > 0; o >>= 1)
        amax = maxval(amax, __shfl_xor_sync(0xffffffffu, amax, o));
      const T inv_scale = amax > T(0) ? T(1) / amax : T(0);
      T sigma = T(0);
      for (int i = j + lane; i < m; i += 32) {
        const T xs = P[i * ld + j] * inv_scale;
        v[i] = xs;
        sigma += xs * xs;
      }
      for (int o = 16; o > 0; o >>= 1)
        sigma += __shfl_xor_sync(0xffffffffu, sigma, o);
      if (lane == 0) {  // lane 0 wrote v[j] itself
        const T xj = v[j];
        const T normx = sqrtval(sigma);
        const T sgn = xj >= T(0) ? T(1) : T(-1);
        const T alpha = -sgn * normx;
        const T vtv = sigma - xj * xj + (xj - alpha) * (xj - alpha);
        v[j] = xj - alpha;
        sc[0] = vtv > T(1e-30) ? T(2) / vtv : T(0);
      }
    }
    __syncthreads();
    const T beta = sc[0];
    for (int c = j + tid; c < ncols; c += blockDim.x) {
      T w = T(0);
      for (int i = j; i < m; ++i) w += v[i] * P[i * ld + c];
      const T bw = beta * w;
      for (int i = j; i < m; ++i) P[i * ld + c] -= bw * v[i];
    }
    __syncthreads();
  }
}

// Back substitution of one right-hand-side column c: xr[:, c] holds the
// right-hand side on entry and the solution on exit; R is the (b, b) upper
// triangle at the top-left of P (row stride ld).
template <typename T>
__device__ void tri_solve_column(const T* P, int ld, int b, int t, int c,
                                 T* xr) {
  for (int i = b - 1; i >= 0; --i) {
    T acc = xr[i * t + c];
    for (int j = i + 1; j < b; ++j) acc -= P[i * ld + j] * xr[j * t + c];
    T d = P[i * ld + i];
    d = absval(d) > T(1e-30) ? d : T(1e-30);
    xr[i * t + c] = acc / d;
  }
}

template <typename T>
__global__ void band_qr_kernel(const T* __restrict__ D, const T* __restrict__ U,
                               const T* __restrict__ Lo, const T* __restrict__ rhs,
                               T* __restrict__ x, T* __restrict__ F, int S, int b,
                               int t) {
  const int np = 3 * b + t;
  const int m = 2 * b;
  const int bnp = b * np;
  const int bt = b * t;
  T* P = reinterpret_cast<T*>(band_qr_smem);  // (2b, np) panel
  T* v = P + m * np;                           // reflector, 2b
  T* x1 = v + m;                               // x_{k+1}, (b, t)
  T* x2 = x1 + bt;                             // x_{k+2}, (b, t)
  T* xr = x2 + bt;                             // x_k being solved, (b, t)
  T* sc = xr + bt;                             // reflector beta

  const long long n = blockIdx.x;
  const int tid = threadIdx.x;
  const T* Dn = D + n * S * b * b;
  const T* Un = U + n * (S - 1) * b * b;
  const T* Ln = Lo + n * (S - 1) * b * b;
  const T* rn = rhs + n * S * bt;
  T* xn = x + n * S * bt;
  T* Fn = F + n * (S > 1 ? S - 1 : 1) * bnp;

  // carry <- [D_0 | U_0 | 0 | r_0] in the top b rows
  for (int e = tid; e < bnp; e += blockDim.x) {
    const int i = e / np, c = e % np;
    T val = T(0);
    if (c < b) val = Dn[i * b + c];
    else if (c < 2 * b) val = S > 1 ? Un[i * b + c - b] : T(0);
    else if (c >= 3 * b) val = rn[i * t + c - 3 * b];
    P[e] = val;
  }
  __syncthreads();

  for (int k = 1; k < S; ++k) {
    // bottom b rows <- [L_{k-1} | D_k | U_k | r_k]
    for (int e = tid; e < bnp; e += blockDim.x) {
      const int i = e / np, c = e % np;
      T val = T(0);
      if (c < b) val = Ln[(k - 1) * b * b + i * b + c];
      else if (c < 2 * b) val = Dn[k * b * b + i * b + c - b];
      else if (c < 3 * b) val = k < S - 1 ? Un[k * b * b + i * b + c - 2 * b] : T(0);
      else val = rn[k * bt + i * t + c - 3 * b];
      P[bnp + e] = val;
    }
    __syncthreads();
    eliminate(P, np, m, b, np, v, sc);
    // emit [R_k | B_k | C_k | c_k]; carry [Dhat | Uhat | 0 | rhat] up
    for (int e = tid; e < bnp; e += blockDim.x) {
      const int c = e % np;
      Fn[(k - 1) * bnp + e] = P[e];
      T val = T(0);
      if (c < 2 * b) val = P[bnp + e + b];
      else if (c >= 3 * b) val = P[bnp + e];
      P[e] = val;
    }
    __syncthreads();
  }

  // last stage: QR of [Dhat | rhat], then x_{S-1}
  eliminate(P, np, b, b, np, v, sc);
  for (int c = tid; c < t; c += blockDim.x) {
    for (int i = 0; i < b; ++i) {
      xr[i * t + c] = P[i * np + 3 * b + c];
      x2[i * t + c] = T(0);
    }
    tri_solve_column(P, np, b, t, c, xr);
    for (int i = 0; i < b; ++i) {
      x1[i * t + c] = xr[i * t + c];
      xn[(S - 1) * bt + i * t + c] = xr[i * t + c];
    }
  }

  for (int k = S - 2; k >= 0; --k) {
    __syncthreads();
    for (int e = tid; e < bnp; e += blockDim.x) P[e] = Fn[k * bnp + e];
    __syncthreads();
    for (int c = tid; c < t; c += blockDim.x) {
      for (int i = 0; i < b; ++i) {
        T acc = P[i * np + 3 * b + c];
        for (int j = 0; j < b; ++j)
          acc -= P[i * np + b + j] * x1[j * t + c] + P[i * np + 2 * b + j] * x2[j * t + c];
        xr[i * t + c] = acc;
      }
      tri_solve_column(P, np, b, t, c, xr);
      for (int i = 0; i < b; ++i) {
        x2[i * t + c] = x1[i * t + c];
        x1[i * t + c] = xr[i * t + c];
        xn[k * bt + i * t + c] = xr[i * t + c];
      }
    }
  }
}

template <typename T>
static int launch(const T* D, const T* U, const T* Lo, const T* rhs, T* x, T* F,
                  int N, int S, int b, int t, void* stream) {
  if (N <= 0) return 0;
  const int np = 3 * b + t;
  const size_t smem = sizeof(T) * (size_t)(2 * b * np + 2 * b + 3 * b * t + 2);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        band_qr_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  int threads = ((np + 31) / 32) * 32;
  if (threads > 256) threads = 256;
  band_qr_kernel<T><<<N, threads, smem, (cudaStream_t)stream>>>(D, U, Lo, rhs, x, F, S,
                                                                b, t);
  return (int)cudaGetLastError();
}

extern "C" int band_qr_solve_f32(const float* D, const float* U, const float* Lo,
                                 const float* rhs, float* x, float* F, int N, int S,
                                 int b, int t, void* stream) {
  return launch<float>(D, U, Lo, rhs, x, F, N, S, b, t, stream);
}

extern "C" int band_qr_solve_f64(const double* D, const double* U, const double* Lo,
                                 const double* rhs, double* x, double* F, int N, int S,
                                 int b, int t, void* stream) {
  return launch<double>(D, U, Lo, rhs, x, F, N, S, b, t, stream);
}
