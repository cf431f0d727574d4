// Banded Householder-QR sweep over N independent block-tridiagonal chains
// with narrow blocks (b <= 32), float and double: one thread block per
// chain, one panel column per thread, the column's rows in registers.
// Wider blocks (33 <= b <= 97) go to band_qr_wide.cu, whose panel lives in
// shared memory (solver/band_qr.py:qr_kernel decides from b).
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
// Design (the column-step machinery is band_core.cuh's, shared with
// band_sweep_tiled.cu):
//   * A block of W = 3b + t threads rounded up to 32 (64 at the flagship
//     b = 13, t = 12); thread p owns one panel column and keeps its 2b
//     rows in registers, in a row bucket MB >= b fixed by the template
//     (instances 4, 8, 13, 16, 32, in float and double; band_core.cuh's
//     buckets 64 and 97 are built here no more: their 2b rows a thread
//     spilled to local memory, and band_qr_wide.cu takes those widths).
//   * One __syncthreads per column step: the owner of pivot j writes the
//     reflector (v, beta) into one of two shared slots, alternating by the
//     parity of the step, the block synchronizes, every thread reads v
//     (a broadcast) and updates its column in registers, and the owner of
//     pivot j+1 builds the next reflector at once.
//   * Stage changes relabel which thread owns which column, so no data
//     moves between threads; the next stage's rows are prefetched with
//     cp.async into each thread's own staging slots; the factors go to the
//     global scratch F and come back, prefetched, for the back
//     substitution, whose products are spread over all threads.
//   * More right-hand sides than a block of qr_max_threads(MB) (256) can
//     hold are split over blockIdx into chunks (only at widths no system
//     of the repository builds).
//
// What bounds it on an H100: latency, neither bytes nor flops.  At the
// flagship (S=21, b=13, t=12) a chain reads and writes ~67 KB in float and
// does ~1.2 MFLOP, but its S*b = 273 column steps are a dependent chain:
// broadcast reads of v, a 26-term dot product, the update, the next
// pivot's scale, norm and divisions, and one barrier.  At the solver's
// batch of one (9 chains) only 9 of 132 SMs are busy; no layout changes
// that, so the time of one column step is what counts.  Tensor cores and
// TMA do not apply at these shapes (band_core.cuh says why).
#include "band_core.cuh"

extern __shared__ __align__(16) unsigned char band_qr_smem[];

template <typename T, int MB>
__global__ void __launch_bounds__(band::qr_max_threads(MB))
    band_qr_kernel(const T* __restrict__ D, const T* __restrict__ U,
                   const T* __restrict__ Lo, const T* __restrict__ rhs, T* __restrict__ x,
                   T* __restrict__ F, int S, int b, int t, int tcp, int nch, int nbuf) {
  const band::Chain<T> ch =
      band::make_item(D, U, Lo, rhs, x, F, (long long)blockIdx.x, S, b, t, tcp, nch);
  band::solve_chain<T, MB, 1, band::BlockGroup, false>(
      ch, reinterpret_cast<T*>(band_qr_smem), nbuf);
}

template <typename T, int MB>
static int launch_rows(const T* D, const T* U, const T* Lo, const T* rhs, T* x, T* F,
                       int N, int S, int b, int t, const band::Plan& p,
                       cudaStream_t stream) {
  const size_t smem = p.words * sizeof(T);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        band_qr_kernel<T, MB>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  band_qr_kernel<T, MB><<<(unsigned)N * p.nch, p.W, smem, stream>>>(
      D, U, Lo, rhs, x, F, S, b, t, p.tcp, p.nch, p.nbuf);
  return (int)cudaGetLastError();
}

// tcp, nch: the caller's plan (solver/band_qr.py:qr_plan), checked against
// this launcher's own; F: (N * nch, S, b, 3b + tcp).  Launches on the
// given stream, allocates nothing, returns cudaGetLastError().
template <typename T>
static int launch(const T* D, const T* U, const T* Lo, const T* rhs, T* x, T* F,
                  int N, int S, int b, int t, int tcp, int nch, void* stream) {
  if (N <= 0) return 0;
  band::Plan p;
  if (S < 1 || !band::qr_plan(b, t, (int)sizeof(T), &p) || p.tcp != tcp || p.nch != nch)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (p.rows) {
    case 4: return launch_rows<T, 4>(D, U, Lo, rhs, x, F, N, S, b, t, p, s);
    case 8: return launch_rows<T, 8>(D, U, Lo, rhs, x, F, N, S, b, t, p, s);
    case 13: return launch_rows<T, 13>(D, U, Lo, rhs, x, F, N, S, b, t, p, s);
    case 16: return launch_rows<T, 16>(D, U, Lo, rhs, x, F, N, S, b, t, p, s);
    case 32: return launch_rows<T, 32>(D, U, Lo, rhs, x, F, N, S, b, t, p, s);
  }  // wider buckets: band_qr_wide.cu
  return (int)cudaErrorInvalidValue;
}

extern "C" int band_qr_solve_f32(const float* D, const float* U, const float* Lo,
                                 const float* rhs, float* x, float* F, int N, int S,
                                 int b, int t, int tcp, int nch, void* stream) {
  return launch<float>(D, U, Lo, rhs, x, F, N, S, b, t, tcp, nch, stream);
}

extern "C" int band_qr_solve_f64(const double* D, const double* U, const double* Lo,
                                 const double* rhs, double* x, double* F, int N, int S,
                                 int b, int t, int tcp, int nch, void* stream) {
  return launch<double>(D, U, Lo, rhs, x, F, N, S, b, t, tcp, nch, stream);
}
