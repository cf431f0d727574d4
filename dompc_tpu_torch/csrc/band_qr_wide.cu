// Banded Householder-QR sweep over N independent block-tridiagonal chains
// with wide blocks (33 <= b <= 97, row buckets 64 and 97), float and
// double: one thread block of 512 threads per chain, blocked Householder
// with a compact-WY trailing update on the FP64 tensor cores
// (band_wide.cuh, shared with band_sweep_tiled.cu's wide buckets, holds the
// device code and its design notes).  band_qr.cu takes the narrow buckets
// (b <= 32); solver/band_qr.py:band_solve picks the kernel from b.
//
// Solves  A_n x_n = r_n  for every chain n: diagonal blocks D (S, b, b),
// super-diagonal U (S-1, b, b), sub-diagonal Lo (S-1, b, b), right-hand
// sides r (S, b, t).
//
// Replaces, for wide bands, the TPU kernels of
// dompc_tpu/solver/pallas_band.py: _band_fwd_kernel (l.244) and
// _band_bwd_kernel (l.281), in one kernel, as band_qr.cu does for the
// narrow ones.
//
// What bounds it on an H100: the S*b dependent column steps of a chain,
// then the trailing products' shared-memory traffic (band_wide.cuh).
#include "band_wide.cuh"

extern __shared__ __align__(16) unsigned char band_qr_wide_smem[];

template <typename T, int MB>
__global__ void __launch_bounds__(wide::kThreads, 1)
    band_qr_wide_kernel(const T* __restrict__ D, const T* __restrict__ U,
                        const T* __restrict__ Lo, const T* __restrict__ rhs, T* x, T* F,
                        int S, int b, int t, int nt, int nbuf) {
  const wide::Chain<T> ch =
      wide::make_chain(D, U, Lo, rhs, x, F, (long long)blockIdx.x, S, b, t);
  wide::solve_chain<T, MB>(ch, reinterpret_cast<T*>(band_qr_wide_smem), nt, nbuf);
}

template <typename T, int MB>
static int launch_rows(const T* D, const T* U, const T* Lo, const T* rhs, T* x, T* F, int N,
                       int S, int b, int t, const wide::Plan& p, cudaStream_t stream) {
  const size_t smem = p.words * sizeof(T);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        band_qr_wide_kernel<T, MB>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  band_qr_wide_kernel<T, MB><<<(unsigned)N, wide::kThreads, smem, stream>>>(
      D, U, Lo, rhs, x, F, S, b, t, p.nt, p.nbuf);
  return (int)cudaGetLastError();
}

// tcp, nch: the caller's plan (solver/band_qr.py:wide_plan), which must be
// one chunk of all t right-hand sides; F: (N, S, b, 3b + t).  Launches on
// the given stream, allocates nothing, returns cudaGetLastError().
template <typename T>
static int launch(const T* D, const T* U, const T* Lo, const T* rhs, T* x, T* F, int N,
                  int S, int b, int t, int tcp, int nch, void* stream) {
  if (N <= 0) return 0;
  wide::Plan p;
  if (S < 1 || !wide::plan(b, t, (int)sizeof(T), &p) || tcp != t || nch != 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (p.rows == 64) return launch_rows<T, 64>(D, U, Lo, rhs, x, F, N, S, b, t, p, s);
  return launch_rows<T, 97>(D, U, Lo, rhs, x, F, N, S, b, t, p, s);
}

extern "C" int band_qr_wide_solve_f32(const float* D, const float* U, const float* Lo,
                                      const float* rhs, float* x, float* F, int N, int S,
                                      int b, int t, int tcp, int nch, void* stream) {
  return launch<float>(D, U, Lo, rhs, x, F, N, S, b, t, tcp, nch, stream);
}

extern "C" int band_qr_wide_solve_f64(const double* D, const double* U, const double* Lo,
                                      const double* rhs, double* x, double* F, int N, int S,
                                      int b, int t, int tcp, int nch, void* stream) {
  return launch<double>(D, U, Lo, rhs, x, F, N, S, b, t, tcp, nch, stream);
}
