// Tiled banded Householder-QR sweep over N independent block-tridiagonal
// chains, float32, with a design per row bucket (one template instance
// each): buckets 4, 8, 13, 16 one warp per chain, G chains a block; bucket
// 32 one block of a few warps per chain; buckets 64 and 97 one block per
// chain, blocked Householder with a compact-WY trailing update.
//
// Solves  A_n x_n = r_n  for every chain n, where A_n has diagonal blocks
// D (S, b, b), super-diagonal blocks U (S-1, b, b) (stage k rows, stage k+1
// columns), sub-diagonal blocks Lo (S-1, b, b) (stage k+1 rows, stage k
// columns), and r_n has t right-hand-side columns.
//
// Replaces the TPU kernel dompc_tpu/solver/pallas_band.py:_band_sweep_kernel
// (l.45; host function band_solve_qr_pallas l.433, pallas_call l.468).  That
// kernel keeps G chains per program whole in VMEM, the factor scratch F
// included, with the Householder column loop vectorized across the tile,
// at any b.  Here one launch takes one row bucket, and the buckets get
// different designs, because what one thread can hold in registers is what
// changes with b:
//   * Buckets <= 16 (band_core.cuh's column step, shared with band_qr.cu):
//     one warp owns one chain and never waits on a block barrier.  Each
//     lane owns tiled_cols(MB) panel columns (2 at the flagship b = 13,
//     t = 12: 51 columns over 32 lanes) and keeps their 2b rows in
//     registers.  The pivot column is exchanged with __shfl_sync: every
//     lane gathers it from its owner and builds the same reflector itself,
//     so a column step has no barrier at all.  (The warp's own pair of
//     shared reflector slots and one __syncwarp per column step was slower
//     at every measured shape: PERF.md.)  The factors go to a global
//     scratch F as they are made (1152 chains: 61 MB, mostly L2-resident)
//     and come back prefetched with cp.async for the back substitution.
//     G = 4 warps a block and at most 168 registers a thread
//     (__launch_bounds__(128, 3)): 3 blocks, 12 warps, per SM, so 1584
//     chains, and every chain of a batch of 128 flagship problems (1152
//     chains), are resident in one wave.
//   * Bucket 32 (b = 17..32): a lane holding tiled_cols(32) = 4 columns of
//     64 rows needs 256 registers for them alone and spilled 3,316 B, and
//     the warp's 32 lanes worked through all 3b + t columns at every one
//     of the S*b dependent column steps.  Here a chain gets W = 3b + tcp
//     threads rounded up to 32 (K = W / 32 warps), one panel column a
//     thread with its 2b rows in registers, as band_qr.cu<float,32> (178
//     registers, no spills): band_core.cuh's solve_chain with the
//     BlockGroup, the reflector passed through a pair of shared slots and
//     one barrier a column step.  One chain a block (G = 1): 2 to 4 chains
//     a block, each on its own named barrier, measured no faster at any
//     shape (PERF.md); the launch bounds allow 256 threads a block.
//   * Buckets 64 and 97 (b = 33..97): 2b rows a column no longer fit a
//     thread's registers at all (1,940 values a lane at bucket 97 in the
//     warp design), so a chain takes a block of 512 threads and
//     band_wide.cuh's blocked-WY sweep, shared with band_qr_wide.cu: the
//     panel in shared memory, T by doubling, the trailing products on the
//     FP64 tensor cores (mma.sync m8n8k4, float inputs converted exactly;
//     no TF32), the columns streamed in cp.async tiles, one chunk at any t.
//     G = 1.
//
// Bound on an H100: bytes of D, U, Lo and rhs read once and x written once,
// over 3.35 TB/s, are 0.181 us at the flagship (9 chains) and 23.2 us at
// 1152 chains; the operations are smaller still against the card's peak.
// What a launch really waits on is the S*b dependent column steps of each
// chain: resident warps of an SM hide each other's step latency at
// buckets <= 16, a group of warps shares a chain's columns at bucket 32,
// and the wide buckets move the trailing update off the dependent chain.
#include "band_core.cuh"
#include "band_wide.cuh"

extern __shared__ __align__(16) float tiled_smem[];

// Threads a block and blocks an SM the instance is compiled for.
__host__ __device__ constexpr int block_threads(int rows) {
  return rows <= 32 ? band::tiled_block_threads(rows) : wide::kThreads;
}
__host__ __device__ constexpr int min_blocks(int rows) { return rows <= 16 ? 3 : 1; }

// items: (chain, chunk) pairs; tcp, nch, nbuf, words: the band_core.cuh
// plan (buckets <= 32); nt, nbuf: the band_wide.cuh plan (buckets 64, 97)
template <int MB>
__global__ void __launch_bounds__(block_threads(MB), min_blocks(MB))
    band_sweep_tiled_kernel(const float* __restrict__ D, const float* __restrict__ U,
                            const float* __restrict__ Lo, const float* __restrict__ rhs,
                            float* __restrict__ x, float* __restrict__ F, long long items,
                            int S, int b, int t, int tcp, int nch, int nbuf, int words,
                            int nt) {
  if constexpr (MB <= 16) {  // one warp per chain
    const int warp = threadIdx.x >> 5;
    const long long item = (long long)blockIdx.x * (blockDim.x >> 5) + warp;
    if (item >= items) return;  // the last block masks its missing chains
    const band::Chain<float> ch =
        band::make_item(D, U, Lo, rhs, x, F, item, S, b, t, tcp, nch);
    band::solve_chain<float, MB, band::tiled_cols(MB), band::WarpGroup, true>(
        ch, tiled_smem + (size_t)warp * words, nbuf);
  } else if constexpr (MB == 32) {  // a block of a few warps per chain
    const band::Chain<float> ch =
        band::make_item(D, U, Lo, rhs, x, F, (long long)blockIdx.x, S, b, t, tcp, nch);
    band::solve_chain<float, MB, 1, band::BlockGroup, false>(ch, tiled_smem, nbuf);
  } else {  // a block per chain
    const wide::Chain<float> ch =
        wide::make_chain(D, U, Lo, rhs, x, F, (long long)blockIdx.x, S, b, t);
    wide::solve_chain<float, MB>(ch, tiled_smem, nt, nbuf);
  }
}

template <int MB>
static int launch_rows(const float* D, const float* U, const float* Lo, const float* rhs,
                       float* x, float* F, long long items, int S, int b, int t, int tcp,
                       int nch, int nbuf, size_t words, int nt, unsigned blocks, dim3 threads,
                       size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(band_sweep_tiled_kernel<MB>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  band_sweep_tiled_kernel<MB><<<blocks, threads, smem, stream>>>(
      D, U, Lo, rhs, x, F, items, S, b, t, tcp, nch, nbuf, (int)words, nt);
  return (int)cudaGetLastError();
}

// tcp, nch, G: the caller's plan (solver/band_qr.py:tiled_plan), checked
// against this launcher's own (G <= 4 at buckets <= 16, G = 1 at 32;
// buckets 64 and 97: one chunk of all t and G = 1); F: (N * nch, S, b, 3b + tcp).  Launches on the given stream,
// allocates nothing, returns cudaGetLastError().
extern "C" int band_sweep_tiled_f32(const float* D, const float* U, const float* Lo,
                                    const float* rhs, float* x, float* F, int N, int S,
                                    int b, int t, int tcp, int nch, int G, void* stream) {
  if (N <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int rows = band::row_bucket(b);
  if (S < 1 || G < 1 || rows < 0) return (int)cudaErrorInvalidValue;
  if (rows > 32) {
    wide::Plan p;
    if (!wide::plan(b, t, (int)sizeof(float), &p) || tcp != t || nch != 1 || G != 1)
      return (int)cudaErrorInvalidValue;
    const size_t smem = sizeof(float) * p.words;
    if (rows == 64)
      return launch_rows<64>(D, U, Lo, rhs, x, F, N, S, b, t, t, 1, p.nbuf, p.words, p.nt,
                             (unsigned)N, dim3(wide::kThreads), smem, s);
    return launch_rows<97>(D, U, Lo, rhs, x, F, N, S, b, t, t, 1, p.nbuf, p.words, p.nt,
                           (unsigned)N, dim3(wide::kThreads), smem, s);
  }
  band::Plan p;
  if (!band::tiled_plan(b, t, &p) || p.tcp != tcp || p.nch != nch ||
      G > (p.rows <= 16 ? band::kTiledMaxG : 1) || sizeof(float) * p.words * G > band::kSmemMax)
    return (int)cudaErrorInvalidValue;
  const long long items = (long long)N * p.nch;
  const unsigned blocks = (unsigned)((items + G - 1) / G);
  const dim3 warps(32 * G), panel(p.W);
  const size_t smem = sizeof(float) * p.words * G;
  switch (p.rows) {
    case 4: return launch_rows<4>(D, U, Lo, rhs, x, F, items, S, b, t, p.tcp, p.nch, p.nbuf,
                                  p.words, 0, blocks, warps, smem, s);
    case 8: return launch_rows<8>(D, U, Lo, rhs, x, F, items, S, b, t, p.tcp, p.nch, p.nbuf,
                                  p.words, 0, blocks, warps, smem, s);
    case 13: return launch_rows<13>(D, U, Lo, rhs, x, F, items, S, b, t, p.tcp, p.nch, p.nbuf,
                                    p.words, 0, blocks, warps, smem, s);
    case 16: return launch_rows<16>(D, U, Lo, rhs, x, F, items, S, b, t, p.tcp, p.nch, p.nbuf,
                                    p.words, 0, blocks, warps, smem, s);
    case 32: return launch_rows<32>(D, U, Lo, rhs, x, F, items, S, b, t, p.tcp, p.nch, p.nbuf,
                                    p.words, 0, blocks, panel, smem, s);
  }
  return (int)cudaErrorInvalidValue;
}
