// Tiled banded Householder-QR sweep over N independent block-tridiagonal
// chains, float32: one warp per chain, G chains (warps) per block, each
// chain's stage factors resident in shared memory for the whole sweep.
//
// Solves  A_n x_n = r_n  for every chain n, where A_n has diagonal blocks
// D (S, b, b), super-diagonal blocks U (S-1, b, b) (stage k rows, stage k+1
// columns), sub-diagonal blocks Lo (S-1, b, b) (stage k+1 rows, stage k
// columns), and r_n has t right-hand-side columns.
//
// Replaces the TPU kernel dompc_tpu/solver/pallas_band.py:_band_sweep_kernel
// (l.45; host function band_solve_qr_pallas l.433, pallas_call l.468).  That
// kernel keeps G chains per program whole in VMEM: the packed stage rows
// [L_{k-1} | D_k | U_k | r_k] and the factor scratch F (G, S, b, 3b+t), with
// the Householder column loop vectorized across the tile.  Here:
//   * One warp owns one chain.  A column step synchronizes only within its
//     warp: the max-abs scale and the scaled norm of the column are warp
//     shuffles, the panel update is split over the lanes by column, and
//     __syncwarp orders the shared-memory phases.  No step needs a block
//     barrier (band_qr.cu, one block per chain, takes two __syncthreads per
//     column step, 273 steps at the flagship).
//   * The reflector is the TPU kernel's exactly (pallas_band.py:69-82): the
//     column scaled by its max-abs, so 1e22 barrier diagonals do not
//     overflow the float sum of squares, with the vtv > 1e-30 guard, and
//     the |d| > 1e-30 guard of the triangular solves (l.101).
//   * The (2b, 3b+t) panel, the reflector and the back-substitution
//     vectors of each chain live in shared memory, and so do its factors F
//     (S-1, b, 3b+t) when they fit: 20*13*51*4 B = 53 KB at the flagship
//     (S=21, b=13, t=12), so G=3 chains fit in the 227 KB a block may use.
//     F then never goes to device memory.  When one chain's factors do not
//     fit (S=101: 265 KB), the caller passes a global scratch for F
//     instead (f_in_smem = 0): a launch parameter, not a second path.
//   * The last block masks its missing warps; no padding chains.
//
// Bound on an H100: the bytes of D, U, Lo and rhs read once and x written
// once, over 3.35 TB/s: 0.181 us at the flagship (9 chains) and 23.2 us at
// 1152 chains (a batch of 128 problems); the ~1.2 MFLOP per chain is
// smaller still against 67 TFLOP/s.  Like band_qr.cu, one chain is a chain
// of S*b dependent column steps, so a launch is latency: what this layout
// does about it is drop the block barriers and the factor round trips to
// device memory, and run G chains per SM side by side.
#include <cuda_runtime.h>

extern __shared__ __align__(16) float tiled_smem[];

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Householder-eliminate the first n_elim columns of the warp's (m, ncols)
// panel P (row stride ld) in place; v: the warp's reflector (m entries).
// Columns left of the current pivot are not updated: no later step reads
// them.
__device__ void warp_eliminate(float* P, int ld, int m, int n_elim, int ncols,
                               float* v, int lane) {
  for (int j = 0; j < n_elim; ++j) {
    float amax = 0.f;
    for (int i = j + lane; i < m; i += 32) amax = fmaxf(amax, fabsf(P[i * ld + j]));
    amax = warp_max(amax);
    const float inv_scale = amax > 0.f ? 1.f / amax : 0.f;
    float sigma = 0.f;
    for (int i = j + lane; i < m; i += 32) {
      const float xs = P[i * ld + j] * inv_scale;
      v[i] = xs;
      sigma += xs * xs;
    }
    sigma = warp_sum(sigma);
    __syncwarp();
    const float xj = v[j];
    const float alpha = -(xj >= 0.f ? 1.f : -1.f) * sqrtf(sigma);
    const float vtv = sigma - xj * xj + (xj - alpha) * (xj - alpha);
    const float beta = vtv > 1e-30f ? 2.f / vtv : 0.f;
    __syncwarp();
    if (lane == 0) v[j] = xj - alpha;
    __syncwarp();
    for (int c = j + lane; c < ncols; c += 32) {
      float w = 0.f;
      for (int i = j; i < m; ++i) w += v[i] * P[i * ld + c];
      const float bw = beta * w;
      for (int i = j; i < m; ++i) P[i * ld + c] -= bw * v[i];
    }
    __syncwarp();
  }
}

// Back substitution of one right-hand-side column c: xr[:, c] holds the
// right-hand side on entry and the solution on exit; R is the (b, b) upper
// triangle at the top-left of its panel (row stride ld).
__device__ void tri_solve_column(const float* R, int ld, int b, int t, int c,
                                 float* xr) {
  for (int i = b - 1; i >= 0; --i) {
    float acc = xr[i * t + c];
    for (int j = i + 1; j < b; ++j) acc -= R[i * ld + j] * xr[j * t + c];
    float d = R[i * ld + i];
    d = fabsf(d) > 1e-30f ? d : 1e-30f;
    xr[i * t + c] = acc / d;
  }
}

__global__ void band_sweep_tiled_kernel(const float* __restrict__ D,
                                        const float* __restrict__ U,
                                        const float* __restrict__ Lo,
                                        const float* __restrict__ rhs,
                                        float* __restrict__ x,
                                        float* __restrict__ Fg, int N, int S,
                                        int b, int t, int G, int f_in_smem) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long n = (long long)blockIdx.x * G + warp;
  if (n >= N) return;  // the last block masks its missing chains

  const int np = 3 * b + t;
  const int m = 2 * b;
  const int bnp = b * np;
  const int bt = b * t;
  const long long fwords = (long long)(S > 1 ? S - 1 : 1) * bnp;
  const long long words = 2 * bnp + m + 3 * bt + (f_in_smem ? fwords : 0);
  float* P = tiled_smem + warp * words;  // (2b, np) panel
  float* v = P + 2 * bnp;                // reflector, 2b
  float* x1 = v + m;                     // x_{k+1}, (b, t)
  float* x2 = x1 + bt;                   // x_{k+2}, (b, t)
  float* xr = x2 + bt;                   // x_k being solved, (b, t)
  float* F = f_in_smem ? xr + bt : Fg + n * fwords;  // (S-1, b, np)

  const float* Dn = D + n * S * b * b;
  const float* Un = U + n * (S - 1) * b * b;
  const float* Ln = Lo + n * (S - 1) * b * b;
  const float* rn = rhs + n * S * bt;
  float* xn = x + n * S * bt;

  // carry <- [D_0 | U_0 | 0 | r_0] in the top b rows
  for (int e = lane; e < bnp; e += 32) {
    const int i = e / np, c = e % np;
    float val = 0.f;
    if (c < b) val = Dn[i * b + c];
    else if (c < 2 * b) val = S > 1 ? Un[i * b + c - b] : 0.f;
    else if (c >= 3 * b) val = rn[i * t + c - 3 * b];
    P[e] = val;
  }
  __syncwarp();

  for (int k = 1; k < S; ++k) {
    // bottom b rows <- [L_{k-1} | D_k | U_k | r_k]
    for (int e = lane; e < bnp; e += 32) {
      const int i = e / np, c = e % np;
      float val;
      if (c < b) val = Ln[(k - 1) * b * b + i * b + c];
      else if (c < 2 * b) val = Dn[k * b * b + i * b + c - b];
      else if (c < 3 * b) val = k < S - 1 ? Un[k * b * b + i * b + c - 2 * b] : 0.f;
      else val = rn[k * bt + i * t + c - 3 * b];
      P[bnp + e] = val;
    }
    __syncwarp();
    warp_eliminate(P, np, m, b, np, v, lane);
    // emit [R_k | B_k | C_k | c_k]; carry [Dhat | Uhat | 0 | rhat] up
    for (int e = lane; e < bnp; e += 32) {
      const int c = e % np;
      F[(long long)(k - 1) * bnp + e] = P[e];
      float val = 0.f;
      if (c < 2 * b) val = P[bnp + e + b];
      else if (c >= 3 * b) val = P[bnp + e];
      P[e] = val;
    }
    __syncwarp();
  }

  // last stage: QR of [Dhat | rhat], then x_{S-1}; lane c solves column c
  warp_eliminate(P, np, b, b, np, v, lane);
  for (int c = lane; c < t; c += 32) {
    for (int i = 0; i < b; ++i) {
      xr[i * t + c] = P[i * np + 3 * b + c];
      x2[i * t + c] = 0.f;
    }
    tri_solve_column(P, np, b, t, c, xr);
    for (int i = 0; i < b; ++i) {
      x1[i * t + c] = xr[i * t + c];
      xn[(long long)(S - 1) * bt + i * t + c] = xr[i * t + c];
    }
  }
  __syncwarp();  // every lane's factors are visible to every lane

  // x_k = R_k^{-1} (c_k - B_k x_{k+1} - C_k x_{k+2}); a lane touches only
  // its own columns of x1, x2, xr, so no further synchronization
  for (int k = S - 2; k >= 0; --k) {
    const float* Fk = F + (long long)k * bnp;
    for (int c = lane; c < t; c += 32) {
      for (int i = 0; i < b; ++i) {
        float acc = Fk[i * np + 3 * b + c];
        for (int j = 0; j < b; ++j)
          acc -= Fk[i * np + b + j] * x1[j * t + c] + Fk[i * np + 2 * b + j] * x2[j * t + c];
        xr[i * t + c] = acc;
      }
      tri_solve_column(Fk, np, b, t, c, xr);
      for (int i = 0; i < b; ++i) {
        x2[i * t + c] = x1[i * t + c];
        x1[i * t + c] = xr[i * t + c];
        xn[(long long)k * bt + i * t + c] = xr[i * t + c];
      }
    }
  }
}

// G chains per block; F in shared memory (f_in_smem = 1, Fg unused) or in
// the caller's global scratch Fg (N, max(S-1, 1), b, 3b+t).  Launches on the
// given stream, allocates nothing, returns cudaGetLastError().
extern "C" int band_sweep_tiled_f32(const float* D, const float* U, const float* Lo,
                                    const float* rhs, float* x, float* Fg, int N,
                                    int S, int b, int t, int G, int f_in_smem,
                                    void* stream) {
  if (N <= 0) return 0;
  if (G < 1 || G > 32) return (int)cudaErrorInvalidValue;
  const int np = 3 * b + t;
  size_t words = (size_t)(2 * b * np + 2 * b + 3 * b * t);
  if (f_in_smem) words += (size_t)(S > 1 ? S - 1 : 1) * b * np;
  const size_t smem = sizeof(float) * words * G;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        band_sweep_tiled_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (N + G - 1) / G;
  band_sweep_tiled_kernel<<<blocks, 32 * G, smem, (cudaStream_t)stream>>>(
      D, U, Lo, rhs, x, Fg, N, S, b, t, G, f_in_smem);
  return (int)cudaGetLastError();
}
