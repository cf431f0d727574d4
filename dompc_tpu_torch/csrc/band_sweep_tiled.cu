// Tiled banded Householder-QR sweep over N independent block-tridiagonal
// chains, float32: one warp per chain, G chains (warps) per block, each
// lane's panel columns in registers.
//
// Solves  A_n x_n = r_n  for every chain n, where A_n has diagonal blocks
// D (S, b, b), super-diagonal blocks U (S-1, b, b) (stage k rows, stage k+1
// columns), sub-diagonal blocks Lo (S-1, b, b) (stage k+1 rows, stage k
// columns), and r_n has t right-hand-side columns.
//
// Replaces the TPU kernel dompc_tpu/solver/pallas_band.py:_band_sweep_kernel
// (l.45; host function band_solve_qr_pallas l.433, pallas_call l.468).  That
// kernel keeps G chains per program whole in VMEM, the factor scratch F
// included, with the Householder column loop vectorized across the tile.
// Here (the column-step machinery is band_core.cuh's, shared with
// band_qr.cu):
//   * One warp owns one chain and never waits on a block barrier.  Each
//     lane owns tiled_cols(MB) panel columns (2 at the flagship b = 13,
//     t = 12: 51 columns over 32 lanes) and keeps their 2b rows in
//     registers, in a row bucket MB >= b fixed by the template.
//   * The pivot column is exchanged with __shfl_sync: every lane gathers
//     it from its owner and builds the same reflector itself, so a column
//     step has no barrier at all.  (The other exchange, the warp's own pair
//     of shared reflector slots and one __syncwarp per column step, as
//     band_qr.cu does with __syncthreads, was slower at every measured
//     shape: PERF.md.)
//   * The factors go to a global scratch F as they are made (1152 chains:
//     61 MB, mostly L2-resident) and come back prefetched with cp.async
//     for the back substitution; shared memory holds no factors (9.8 KB a
//     warp at the flagship: staging buffers, x ring), so it no longer
//     limits how many chains an SM holds.
//   * G = 4 warps a block and at most 168 registers a thread
//     (__launch_bounds__(128, 3)): 3 blocks, 12 warps, per SM, so 1584
//     chains, and every chain of a batch of 128 flagship problems (1152
//     chains), are resident in one wave.  The last block masks its
//     missing warps; no padding chains.
//
// Bound on an H100: the bytes of D, U, Lo and rhs read once and x written
// once, over 3.35 TB/s, are 0.181 us at the flagship (9 chains) and 23.2 us
// at 1152 chains; the ~1.2 MFLOP per chain is smaller still against
// 67 TFLOP/s.  What a launch really waits on is the S*b = 273 dependent
// column steps of each chain; with every chain resident, the warps of an
// SM hide each other's step latency.  Tensor cores and TMA do not apply at
// these shapes (band_core.cuh says why).
#include "band_core.cuh"

extern __shared__ __align__(16) float tiled_smem[];

template <int MB>
__global__ void __launch_bounds__(32 * band::kTiledMaxG, 3)
    band_sweep_tiled_kernel(const float* __restrict__ D, const float* __restrict__ U,
                            const float* __restrict__ Lo, const float* __restrict__ rhs,
                            float* __restrict__ x, float* __restrict__ F, long long items,
                            int S, int b, int t, int tcp, int nch, int nbuf, int words) {
  const int warp = threadIdx.x >> 5;
  const long long item = (long long)blockIdx.x * (blockDim.x >> 5) + warp;
  if (item >= items) return;  // the last block masks its missing chains
  const band::Chain<float> ch =
      band::make_item(D, U, Lo, rhs, x, F, item, S, b, t, tcp, nch);
  band::solve_chain<float, MB, band::tiled_cols(MB), band::WarpGroup, true>(
      ch, tiled_smem + (size_t)warp * words, nbuf);
}

template <int MB>
static int launch_rows(const float* D, const float* U, const float* Lo, const float* rhs,
                       float* x, float* F, int N, int S, int b, int t, int G,
                       const band::Plan& p, cudaStream_t stream) {
  const size_t smem = sizeof(float) * p.words * G;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(band_sweep_tiled_kernel<MB>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long items = (long long)N * p.nch;
  const unsigned blocks = (unsigned)((items + G - 1) / G);
  band_sweep_tiled_kernel<MB><<<blocks, 32 * G, smem, stream>>>(
      D, U, Lo, rhs, x, F, items, S, b, t, p.tcp, p.nch, p.nbuf, (int)p.words);
  return (int)cudaGetLastError();
}

// tcp, nch, G: the caller's plan (solver/band_qr.py:tiled_plan), checked
// against this launcher's own; F: (N * nch, S, b, 3b + tcp).  Launches on
// the given stream, allocates nothing, returns cudaGetLastError().
extern "C" int band_sweep_tiled_f32(const float* D, const float* U, const float* Lo,
                                    const float* rhs, float* x, float* F, int N, int S,
                                    int b, int t, int tcp, int nch, int G, void* stream) {
  if (N <= 0) return 0;
  band::Plan p;
  if (S < 1 || !band::tiled_plan(b, t, &p) || p.tcp != tcp || p.nch != nch || G < 1 ||
      G > band::kTiledMaxG || sizeof(float) * p.words * G > band::kSmemMax)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (p.rows) {
    case 4: return launch_rows<4>(D, U, Lo, rhs, x, F, N, S, b, t, G, p, s);
    case 8: return launch_rows<8>(D, U, Lo, rhs, x, F, N, S, b, t, G, p, s);
    case 13: return launch_rows<13>(D, U, Lo, rhs, x, F, N, S, b, t, G, p, s);
    case 16: return launch_rows<16>(D, U, Lo, rhs, x, F, N, S, b, t, G, p, s);
    case 32: return launch_rows<32>(D, U, Lo, rhs, x, F, N, S, b, t, G, p, s);
    case 64: return launch_rows<64>(D, U, Lo, rhs, x, F, N, S, b, t, G, p, s);
    case 97: return launch_rows<97>(D, U, Lo, rhs, x, F, N, S, b, t, G, p, s);
  }
  return (int)cudaErrorInvalidValue;
}
