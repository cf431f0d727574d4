// Blocked-Householder (compact-WY) sweep of one block-tridiagonal chain
// with a wide band (33 <= b <= 97, row buckets 64 and 97) by one thread
// block of 512 threads: the device code and launch plan that band_qr_wide.cu
// (float and double, behind band_qr.band_solve) and band_sweep_tiled.cu
// (float, its buckets 64 and 97, behind band_qr.band_solve_tiled) share.
// solver/band_qr.py:wide_plan mirrors wide::plan.
//
// Solves  A x = r  for one chain: diagonal blocks D (S, b, b),
// super-diagonal U (S-1, b, b), sub-diagonal Lo (S-1, b, b), right-hand
// sides r (S, b, t).  The same function as band_qr.band_solve_qr_multi and
// band_core.cuh: elimination e works on the (2b, 3b+t) panel
//     [ Dhat | Uhat |  0  | rhat ]      carry (top b rows)
//     [ L_e  | D_e+1| U_e+1| r_e+1 ]    stage e+1 (absent at e = S-1)
// with the scaled Householder reflector of
// dompc_tpu/solver/pallas_band.py:69-82 (the column scaled by its max-abs,
// so 1e22 barrier diagonals do not overflow float; beta = 0 unless
// v.v > 1e-30), and the back substitution keeps the |d| > 1e-30 guard of
// pallas_band.py:101.
//
// Why not band_core.cuh's design: it keeps each thread's panel column, 2b
// rows, in registers.  At b = 83 that is 166 values a thread, which spill
// to local memory on every row of every column step (ptxas: 19,660 B of
// spill stores at row bucket 97 in double), and its right-hand sides go to
// chunks that each repeat the elimination.  Here:
//   1. Panel in shared memory.  The 2b x b pivot columns [Dhat; L_e] are
//      staged column-major (column stride 4 times an odd number: see
//      panel_ld).  Column step j: warp 0 owns the pivot; the other 15
//      warps share the columns right of it.  A warp applies reflector j to
//      a column with its lanes over the rows (7 rows a lane at most) and
//      one shuffle reduction, two columns at once (their reductions
//      interleaved: one at a time, or three, measured slower);
//      warp 0 then builds reflector j+1 from the column it just updated
//      (max-abs as an integer redux of the bit patterns, the sum of squares
//      as a shuffle reduction) and writes v in place.  One __syncthreads a
//      column step.  The reflectors stay in place as V, their betas in a
//      vector, R's diagonal in another.
//   2. T.  R's strict upper part leaves for F; the Gram matrix G = V'V
//      (strict upper, packed) is formed on the tensor cores, then T by
//      doubling (sibling blocks: T_AB = -T_AA G_AB T_BB) into the place R
//      left, so that Q' = I - V T' V'.
//   3. Trailing update as products.  The other 2b + t columns
//      [Uhat 0 rhat; D_e+1 U_e+1 r_e+1] stream through shared memory in
//      tiles of nt columns (the last one cut to its columns, in blocks of
//      8; cp.async; double-buffered when two buffers fit, the next tile
//      loading while this one is updated): W = V'C,
//      W = -T'W, C += V W as 8 x 8 x 4 products on the float64 tensor
//      cores (mma.sync m8n8k4; float inputs converted, exactly), one warp
//      a row block of 8 across the tile (one A fragment for its four
//      8 x 8 blocks).  The columns stream, so every t is one chunk:
//      there are no right-hand-side chunks.  No TF32: its ~3 digits are
//      too few for the 1e22-diagonal barrier chains.
//   4. The top b rows of the updated columns go to F as [B_e | C_e | c_e]
//      (R_e went there in step 2), the bottom b rows to F's next stage as
//      the carry, where the next elimination reads them: F is the chain's
//      workspace, L2-resident.  F: (N, S, b, 3b + t).
//   5. Back substitution: per stage, R_k staged transposed in shared
//      memory, y = c_k - B_k x_k+1 - C_k x_k+2 over (row, right-hand side)
//      pairs, then R_k y solved one warp per right-hand side (rows over
//      lanes in registers, one shuffle broadcast a row).
//
// What bounds it on an H100: the S*b dependent column steps of a chain,
// above all warp 0's chain in each (two shuffle reductions, a redux, a
// square root and two reciprocals), slowed by the other warps' column
// updates on its scheduler (keeping its three sibling warps idle shortens
// the chain by a fifth and lengthens the wait by as much); next, the
// trailing products, bound by shared memory bandwidth (an 8-byte fragment
// load a lane per product for B, one per four for A); scripts/wide_probe.py
// splits a launch's clock cycles by phase.  Bytes from device memory are
// not the limit: a chain moves ~1.3 MB, through L2.
#pragma once
#include <cuda_runtime.h>
#include <stddef.h>

namespace wide {

constexpr int kThreads = 512;                 // one block per chain
constexpr int kWarps = kThreads / 32;
constexpr size_t kSmemMax = 232448;           // dynamic shared memory of one H100 block
constexpr unsigned kFull = 0xffffffffu;

inline int row_bucket(int b) { return b < 33 || b > 97 ? -1 : (b <= 64 ? 64 : 97); }
__host__ __device__ constexpr int quad(int n) { return (n + 3) / 4 * 4; }
// Strides chosen so that the operand fragments of the 8 x 8 x 4 products
// (8 rows by 4 consecutive entries, or 4 rows by 8) hit distinct banks:
// the panel's column stride is 4 times an odd number >= 2b, a tile's (and
// W's) row stride nt + 8 words in float, nt + 4 in double.
__host__ __device__ constexpr int panel_ld(int b) {
  return ((2 * b + 3) / 4 + (((2 * b + 3) / 4) % 2 == 0 ? 1 : 0)) * 4;
}
__host__ __device__ constexpr int tile_ld(int nt, int itemsize) { return nt + 32 / itemsize; }

struct Plan {
  int rows, nt, nbuf;
  size_t words;
};

// Shared words: the panel, beta and R's diagonal, then the larger of G
// (packed strict upper; it is done before the first tile loads) and
// [nbuf tile buffers | W (b, nt)].  The back substitution reuses the
// panel (R_k transposed), the diagonal vector (1/d) and the tile buffers
// (y and the x it needs).
inline size_t plan_words(int b, int nt, int nbuf, int itemsize) {
  const size_t tile = (size_t)quad(2 * b * tile_ld(nt, itemsize));
  const size_t gram = (size_t)quad(b * (b - 1) / 2);
  const size_t tiles = nbuf * tile + quad(b * tile_ld(nt, itemsize));
  return (size_t)quad(panel_ld(b) * b) + 2 * (size_t)quad(b) + (gram > tiles ? gram : tiles);
}

// The widest tile (32, 16 or 8 columns) that fits, double-buffered when
// it can be (nt = 16 with two buffers fits every b <= 97 in double).  The
// right-hand sides never split.
inline bool plan(int b, int t, int itemsize, Plan* p) {
  p->rows = row_bucket(b);
  if (p->rows < 0 || t < 0) return false;
  for (int nt = 32; nt >= 8; nt /= 2)
    for (int nbuf = 2; nbuf >= 1; --nbuf) {
      p->nt = nt;
      p->nbuf = nbuf;
      p->words = plan_words(b, nt, nbuf, itemsize);
      if (p->words * itemsize <= kSmemMax) return true;
    }
  return false;
}

// ---------------------------------------------------------------------------
// device side
// ---------------------------------------------------------------------------

__device__ __forceinline__ float absval(float a) { return fabsf(a); }
__device__ __forceinline__ double absval(double a) { return fabs(a); }
__device__ __forceinline__ float maxval(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double maxval(double a, double b) { return fmax(a, b); }
__device__ __forceinline__ float sqrtval(float a) { return sqrtf(a); }
__device__ __forceinline__ double sqrtval(double a) { return sqrt(a); }
// 1 / a, correctly rounded (the value of the division, without its
// slow-path check)
__device__ __forceinline__ float recip(float a) { return __frcp_rn(a); }
__device__ __forceinline__ double recip(double a) { return __drcp_rn(a); }
// The largest of the lanes' a >= 0: non-negative floats order as their bit
// patterns, so one integer reduction (two for double: the high words, then
// the low words of those that hold the largest high word)
__device__ __forceinline__ float warp_max_nonneg(float a) {
  return __uint_as_float(__reduce_max_sync(0xffffffffu, __float_as_uint(a)));
}
__device__ __forceinline__ double warp_max_nonneg(double a) {
  const unsigned hi = (unsigned)__double2hiint(a), lo = (unsigned)__double2loint(a);
  const unsigned H = __reduce_max_sync(0xffffffffu, hi);
  const unsigned L = __reduce_max_sync(0xffffffffu, hi == H ? lo : 0u);
  return __hiloint2double((int)H, (int)L);
}

template <typename T>
__device__ __forceinline__ void cp_async(T* dst, const T* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d), "l"(src),
               "n"((int)sizeof(T))
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Sums and maxima of a lane's values as pairwise trees (a chain of
// dependent adds is what a column step waits on)
template <typename T, int N>
__device__ __forceinline__ T tree_sum(const T (&a)[N]) {
  T s[N];
#pragma unroll
  for (int i = 0; i < N; ++i) s[i] = a[i];
#pragma unroll
  for (int w = 1; w < N; w *= 2)
#pragma unroll
    for (int i = 0; i + w < N; i += 2 * w) s[i] += s[i + w];
  return s[0];
}

template <typename T, int N>
__device__ __forceinline__ T tree_max(const T (&a)[N]) {
  T s[N];
#pragma unroll
  for (int i = 0; i < N; ++i) s[i] = a[i];
#pragma unroll
  for (int w = 1; w < N; w *= 2)
#pragma unroll
    for (int i = 0; i + w < N; i += 2 * w) s[i] = maxval(s[i], s[i + w]);
  return s[0];
}

template <typename T>
__device__ __forceinline__ T warp_sum(T s) {
#pragma unroll
  for (int off = 16; off; off >>= 1) s += __shfl_xor_sync(kFull, s, off);
  return s;
}


// D += A B for one 8 x 8 x 4 step on the float64 tensor cores
// (mma.sync m8n8k4): lane l holds A[l/4][l%4], B[l%4][l/4] and
// D[l/4][2(l%4)], D[l/4][2(l%4)+1].
__device__ __forceinline__ void dmma(double& d0, double& d1, double a, double b) {
  asm("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, {%3}, {%0, %1};\n"
      : "+d"(d0), "+d"(d1)
      : "d"(a), "d"(b));
}

// A fast run of the product below: steps k = kf0, kf0 + 4, ... < kf1
// with a = pa[k sa] (0 unless aok) and, for column block u < nb (the
// same for the warp's lanes: the other blocks are skipped), b = pb[k sb +
// 8 u] (0 unless bok), pa and pb this lane's elements at k = 0; even and
// odd steps in separate accumulators.
template <typename T, int NB>
__device__ __forceinline__ void mma_run(double (&d)[NB][2], int kf0, int kf1, const T* pa, int sa,
                                        bool aok, const T* pb, int sb, bool bok, int nb) {
  double e[NB][2];
#pragma unroll
  for (int u = 0; u < NB; ++u) e[u][0] = e[u][1] = 0.0;
  const T* qa = pa + (size_t)kf0 * sa;
  const T* qb = pb + (size_t)kf0 * sb;
  const int sa4 = 4 * sa, sb4 = 4 * sb;
  int k = kf0;
  for (; k + 4 < kf1; k += 8, qa += 2 * sa4, qb += 2 * sb4) {
    const double a0 = aok ? (double)qa[0] : 0.0, a1 = aok ? (double)qa[sa4] : 0.0;
#pragma unroll
    for (int u = 0; u < NB; ++u)
      if (u < nb) {
        dmma(d[u][0], d[u][1], a0, bok ? (double)qb[8 * u] : 0.0);
        dmma(e[u][0], e[u][1], a1, bok ? (double)qb[sb4 + 8 * u] : 0.0);
      }
  }
  for (; k < kf1; k += 4, qa += sa4, qb += sb4) {
    const double a = aok ? (double)qa[0] : 0.0;
#pragma unroll
    for (int u = 0; u < NB; ++u)
      if (u < nb) dmma(d[u][0], d[u][1], a, bok ? (double)qb[8 * u] : 0.0);
  }
#pragma unroll
  for (int u = 0; u < NB; ++u) {
    d[u][0] += e[u][0];
    d[u][1] += e[u][1];
  }
}

// One warp: the NB 8 x 8 blocks of D at rows i0, columns j0 + 8 u (u <
// nb, the same for the warp's lanes: mma.sync runs on the whole warp; the
// others are left as they are) += sum over k in [k0, k1) of A(i, k) B(k, j),
// one fragment of A for all of them.  The steps in [kf0, kf1) (multiples
// of 4) need no mask and read through pointers (mma_run); the others read
// through accessors that return 0 outside the operands.  Both types
// multiply in float64: float inputs are exact in double, and the sums
// only gain digits.
template <typename T, int NB, class FA, class FB>
__device__ __forceinline__ void block_mma(double (&d)[NB][2], int i0, int j0, int k0, int k1,
                                          int kf0, int kf1, const T* pa, int sa, bool aok,
                                          const T* pb, int sb, bool bok, int nb, int lane, FA A,
                                          FB B) {
  const int gi = lane >> 2, tk = lane & 3;
  int k = k0 & ~3;
  if (kf1 <= kf0) kf0 = kf1 = k;
  for (; k < kf0 && k < k1; k += 4) {
    const double a = A(i0 + gi, k + tk);
#pragma unroll
    for (int u = 0; u < NB; ++u)
      if (u < nb) dmma(d[u][0], d[u][1], a, B(k + tk, j0 + 8 * u + gi));
  }
  if (kf1 > kf0) {
    mma_run<T, NB>(d, kf0, kf1, pa, sa, aok, pb, sb, bok, nb);
    k = kf1;
  }
  for (; k < k1; k += 4) {
    const double a = A(i0 + gi, k + tk);
#pragma unroll
    for (int u = 0; u < NB; ++u)
      if (u < nb) dmma(d[u][0], d[u][1], a, B(k + tk, j0 + 8 * u + gi));
  }
}

// One chain's pointers and sizes.
template <typename T>
struct Chain {
  const T* D;
  const T* U;
  const T* Lo;
  const T* rhs;
  T* x;
  T* F;  // (S, b, ldf)
  int S, b, t, ldf;
};

// Chain n of a launch over the (N, S, b, b) / (N, S-1, b, b) / (N, S, b, t)
// inputs; F holds (N, S, b, 3b + t).
template <typename T>
__device__ __forceinline__ Chain<T> make_chain(const T* D, const T* U, const T* Lo,
                                               const T* rhs, T* x, T* F, long long n,
                                               int S, int b, int t) {
  const size_t bb = (size_t)b * b;
  Chain<T> ch;
  ch.D = D + n * S * bb;
  ch.U = U + n * (S - 1) * bb;
  ch.Lo = Lo + n * (S - 1) * bb;
  ch.rhs = rhs + n * S * b * t;
  ch.x = x + n * S * b * t;
  ch.ldf = 3 * b + t;
  ch.F = F + n * S * b * ch.ldf;
  ch.S = S;
  ch.b = b;
  ch.t = t;
  return ch;
}

// Reflector j applied to panel column c (the warp's lanes hold rows
// lane + 32 q; rows above j are final and untouched); col returns the
// column's updated rows, zero above j.
template <typename T, int RL>
__device__ __forceinline__ void apply_col(T* P, int ldp, int c, int j, int m, const T (&v)[RL],
                                          T beta, int lane, T (&col)[RL]) {
  T* pc = P + (size_t)c * ldp;
  T pr[RL];
#pragma unroll
  for (int q = 0; q < RL; ++q) {
    const int r = lane + 32 * q;
    col[q] = (r >= j && r < m) ? pc[r] : T(0);
    pr[q] = v[q] * col[q];
  }
  const T bw = beta * warp_sum(tree_sum(pr));
#pragma unroll
  for (int q = 0; q < RL; ++q) {
    const int r = lane + 32 * q;
    col[q] -= bw * v[q];
    if (r >= j && r < m) pc[r] = col[q];
  }
}

// Reflector j applied to the NC panel columns c0, c0 + dc, ... at once
// (as apply_col, their reductions interleaved: each is a chain of
// dependent shuffles).
template <typename T, int RL, int NC>
__device__ __forceinline__ void apply_cols(T* P, int ldp, int c0, int dc, int j, int m,
                                           const T (&v)[RL], T beta, int lane) {
  T col[NC][RL], s[NC];
#pragma unroll
  for (int g = 0; g < NC; ++g) {
    T pr[RL];
#pragma unroll
    for (int q = 0; q < RL; ++q) {
      const int r = lane + 32 * q;
      col[g][q] = (r >= j && r < m) ? P[(size_t)(c0 + g * dc) * ldp + r] : T(0);
      pr[q] = v[q] * col[g][q];
    }
    s[g] = tree_sum(pr);
  }
#pragma unroll
  for (int off = 16; off; off >>= 1)
#pragma unroll
    for (int g = 0; g < NC; ++g) s[g] += __shfl_xor_sync(kFull, s[g], off);
#pragma unroll
  for (int g = 0; g < NC; ++g) {
    const T bw = beta * s[g];
#pragma unroll
    for (int q = 0; q < RL; ++q) {
      const int r = lane + 32 * q;
      if (r >= j && r < m) P[(size_t)(c0 + g * dc) * ldp + r] = col[g][q] - bw * v[q];
    }
  }
}

// The reflector of panel column p from its rows (x: the lanes' rows, rows
// above p ignored), exactly pallas_band.py:69-82 up to the order of the
// sums: v = x / max|x| with v[p] -= alpha, beta = 2 / v.v (0 unless
// v.v > 1e-30).  v goes in place into column p; beta and R's diagonal
// (alpha * max|x|, the pivot's value after the reflection) to their
// vectors.  One warp.
template <typename T, int RL>
__device__ __forceinline__ void make_reflector(T* P, int ldp, int p, int m, const T (&x)[RL],
                                               T* beta, T* rdiag, int lane) {
  T v[RL], a[RL];
#pragma unroll
  for (int q = 0; q < RL; ++q) {
    const int r = lane + 32 * q;
    v[q] = (r >= p && r < m) ? x[q] : T(0);
    a[q] = absval(v[q]);
  }
  const T amax = warp_max_nonneg(tree_max(a));
  const T inv = amax > T(0) ? recip(amax) : T(0);
#pragma unroll
  for (int q = 0; q < RL; ++q) {
    v[q] *= inv;
    a[q] = v[q] * v[q];
  }
  const T s = tree_sum(a);
  // the pivot's entry from shared memory, where this warp has just put the
  // column (selecting it from the registers compiles to a local-memory
  // array indexed by p)
  __syncwarp();
  const T xp = P[(size_t)p * ldp + p] * inv;
  const T sigma = warp_sum(s);
  const T alpha = -(xp >= T(0) ? T(1) : T(-1)) * sqrtval(sigma);
  const T vtv = sigma - xp * xp + (xp - alpha) * (xp - alpha);
#pragma unroll
  for (int q = 0; q < RL; ++q) {
    const int r = lane + 32 * q;
    if (r >= p && r < m) P[(size_t)p * ldp + r] = r == p ? xp - alpha : v[q];
  }
  if (lane == 0) {
    beta[p] = vtv > T(1e-30) ? T(2) * recip(vtv) : T(0);
    rdiag[p] = alpha * amax;
  }
}

// Solve one chain.  MB: the row bucket (64 or 97); RL rows of the 2b-row
// panel per lane, RB rows of a b-row block per lane.
template <typename T, int MB>
__device__ void solve_chain(const Chain<T>& ch, T* sm, int nt, int nbuf) {
  constexpr int RL = (2 * MB + 31) / 32;
  constexpr int RB = (MB + 31) / 32;
  const int S = ch.S, b = ch.b, t = ch.t, ldf = ch.ldf;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ldp = panel_ld(b), ldc = tile_ld(nt, (int)sizeof(T));
  const size_t bb = (size_t)b * b;

  T* P = sm;                                // panel: V, R / T strict upper
  T* beta = P + quad(ldp * b);
  T* rdiag = beta + quad(b);
  T* G = rdiag + quad(b);                   // Gram matrix, packed by column
  T* Cb0 = G;                               // tile buffers, after T is built
  T* Cb1 = Cb0 + (nbuf - 1) * quad(2 * b * ldc);
  T* W = Cb0 + nbuf * quad(2 * b * ldc);    // (b, ldc)

  // F_0 takes the first stage's rows: D_0 (R slot), U_0 (B slot), r_0 (c slot)
  for (int idx = tid; idx < b * b; idx += kThreads) {
    const int i = idx / b, c = idx - i * b;
    ch.F[(size_t)i * ldf + c] = ch.D[idx];
    if (S > 1) ch.F[(size_t)i * ldf + b + c] = ch.U[idx];
  }
  for (int idx = tid; idx < b * t; idx += kThreads) {
    const int i = idx / t, c = idx - i * t;
    ch.F[(size_t)i * ldf + 3 * b + c] = ch.rhs[idx];
  }
  __syncthreads();

  for (int e = 0; e < S; ++e) {
    const bool last = e == S - 1;
    const int m = last ? b : 2 * b;
    T* Fe = ch.F + (size_t)e * b * ldf;
    T* Fn = Fe + (size_t)b * ldf;  // the next stage's F (carry); unused when last
    // the trailing columns n in [0, 2b + t) this elimination updates: the
    // zero block's U_{e+1} is absent at e = S-2, everything but the
    // right-hand sides at e = S-1
    const int ncols = last ? t : (e == S - 2 ? b + t : 2 * b + t);
    auto logical = [=](int q) { return last ? 2 * b + q : (e == S - 2 && q >= b ? q + b : q); };
    const int ntiles = (ncols + nt - 1) / nt;
    // a tile's columns in 8-column blocks: nt / 8, fewer in the last tile
    auto tile_c8 = [=](int tile) { return ((ncols - tile * nt < nt ? ncols - tile * nt : nt) + 7) / 8; };

    // stage the panel [Dhat; L_e] (column-major)
    for (int idx = tid; idx < m * b; idx += kThreads) {
      const int r = idx / b, c = idx - r * b;
      const T* src = r < b ? Fe + (size_t)r * ldf + c : ch.Lo + e * bb + (size_t)(r - b) * b + c;
      cp_async(P + (size_t)c * ldp + r, src);
    }
    cp_async_commit();
    auto load_tile = [=](T* buf, int tile) {
      const int w = 8 * tile_c8(tile);
      for (int idx = tid; idx < m * w; idx += kThreads) {
        const int r = idx / w, cc = idx - r * w, q = tile * nt + cc;
        T* dst = buf + (size_t)r * ldc + cc;
        const T* src = nullptr;
        if (q < ncols) {
          const int n = logical(q);
          if (r < b) {
            if (n < b || n >= 2 * b) src = Fe + (size_t)r * ldf + b + n;
          } else {
            const int rr = r - b;
            if (n < b) src = ch.D + (e + 1) * bb + (size_t)rr * b + n;
            else if (n < 2 * b) src = ch.U + (e + 1) * bb + (size_t)rr * b + (n - b);
            else src = ch.rhs + ((size_t)(e + 1) * b + rr) * t + (n - 2 * b);
          }
        }
        if (src) cp_async(dst, src);
        else *dst = T(0);
      }
      cp_async_commit();
    };
    cp_async_wait<0>();
    __syncthreads();

    // ---- 1. the panel: b column steps, one barrier each ----
    if (warp == 0) {
      T x[RL];
#pragma unroll
      for (int q = 0; q < RL; ++q) {
        const int r = lane + 32 * q;
        x[q] = r < m ? P[r] : T(0);
      }
      make_reflector<T, RL>(P, ldp, 0, m, x, beta, rdiag, lane);
    }
    __syncthreads();
    for (int j = 0; j + 1 < b; ++j) {
      T v[RL];
#pragma unroll
      for (int q = 0; q < RL; ++q) {
        const int r = lane + 32 * q;
        v[q] = (r >= j && r < m) ? P[(size_t)j * ldp + r] : T(0);
      }
      const T bj = beta[j];
      T col[RL];
      if (warp == 0) {  // the next pivot column, then its reflector
        apply_col<T, RL>(P, ldp, j + 1, j, m, v, bj, lane, col);
        make_reflector<T, RL>(P, ldp, j + 1, m, col, beta, rdiag, lane);
      } else {          // columns j+2.., over warps 1..15, two at a time
        const int c0 = j + 1 + warp;
        const int nc = c0 < b ? (b - c0 + kWarps - 2) / (kWarps - 1) : 0;
        for (int g = 0; g < nc; g += 2) {
          if (nc - g >= 2)
            apply_cols<T, RL, 2>(P, ldp, c0 + g * (kWarps - 1), kWarps - 1, j, m, v, bj, lane);
          else
            apply_cols<T, RL, 1>(P, ldp, c0 + g * (kWarps - 1), kWarps - 1, j, m, v, bj, lane);
        }
      }
      __syncthreads();
    }

    // ---- 2. R_e to F; G = V'V; T ----
    for (int idx = tid; idx < b * b; idx += kThreads) {
      const int i = idx / b, c = idx - i * b;
      if (c >= i) Fe[(size_t)i * ldf + c] = c == i ? rdiag[i] : P[(size_t)c * ldp + i];
    }
    // V' and V as product operands (zero outside the trapezoid: v_i is zero
    // above its pivot row i)
    auto Vt = [=](int i, int r) -> double {
      return (i < b && r >= i && r < m) ? (double)P[(size_t)i * ldp + r] : 0.0;
    };
    auto Vm = [=](int r, int k) -> double {
      return (k < b && r >= k && r < m) ? (double)P[(size_t)k * ldp + r] : 0.0;
    };
    const int nb8 = (b + 7) / 8;
    // G[i][k] = v_i . v_k for i < k, by 8 x 8 blocks of the upper triangle
    for (int blk = warp; blk < nb8 * nb8; blk += kWarps) {
      const int ib = blk / nb8, kb = blk - ib * nb8;
      if (ib > kb) continue;
      double d[1][2] = {{0.0, 0.0}};
      const int i = 8 * ib + (lane >> 2), kk = 8 * kb + (lane >> 2), tk = lane & 3;
      block_mma<T, 1>(d, 8 * ib, 8 * kb, 8 * kb, m, 8 * kb + 8, m & ~3,
                      P + (size_t)(i < b ? i : b - 1) * ldp + tk, 1, i < b,
                      P + (size_t)(kk < b ? kk : b - 1) * ldp + tk, 1, kk < b, 1, lane, Vt,
                      Vm);
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int k = 8 * kb + 2 * (lane & 3) + u;
        if (i < k && k < b) G[k * (k - 1) / 2 + i] = (T)d[0][u];
      }
    }
    __syncthreads();  // R has left the strict upper part; G is complete
    // T (upper, T[i][i] = beta_i, T[i][j] at P[j * ldp + i]) by doubling:
    // for sibling blocks A = [a, a+s), B = [a+s, a+2s) whose diagonal blocks
    // are complete, T_AB = -T_AA (G_AB T_BB), since
    // (I - V_A T_AA V_A')(I - V_B T_BB V_B') = I - V T V'
    for (int s = 1; s < b; s *= 2) {
      // pairs a = 0, 2s, 4s, ...; only the last one's B may be short
      const int npairs = (b - s + 2 * s - 1) / (2 * s);
      const int nlast = b - 2 * s * (npairs - 1) - s < s ? b - 2 * s * (npairs - 1) - s : s;
      const int nel = (npairs - 1) * s * s + s * nlast;
      // element idx: pair a, row i of A (fastest: a warp reads T's and X's
      // column j as one broadcast, and consecutive rows of the columns l
      // on distinct banks), column j of B
      auto at = [=](int idx, int& i, int& j, int& a) {
        const int pr = idx / (s * s) < npairs - 1 ? idx / (s * s) : npairs - 1;
        const int el = idx - pr * (s * s);
        a = 2 * s * pr;
        i = a + el % s;
        j = a + s + el / s;
      };
      for (int idx = tid; idx < nel; idx += kThreads) {  // X = G_AB T_BB
        int i, j, a;
        at(idx, i, j, a);
        // four partial sums: the dot is a chain of dependent adds
        T* Tj = P + (size_t)j * ldp;
        T x[4] = {T(0), T(0), T(0), T(0)};
        int l = a + s;
        for (; l + 3 < j; l += 4) {
#pragma unroll
          for (int u = 0; u < 4; ++u) x[u] += G[(l + u) * (l + u - 1) / 2 + i] * Tj[l + u];
        }
        for (; l < j; ++l) x[0] += G[l * (l - 1) / 2 + i] * Tj[l];
        Tj[i] = ((x[0] + x[1]) + (x[2] + x[3])) + G[j * (j - 1) / 2 + i] * beta[j];
      }
      __syncthreads();
      constexpr int kEl = (97 * 97 / 4 + kThreads - 1) / kThreads;  // nel <= b * b / 4
      T tv[kEl];
#pragma unroll
      for (int u = 0; u < kEl; ++u) {  // T_AB = -T_AA X, held until all have read X
        const int idx = tid + u * kThreads;
        T acc = T(0);
        if (idx < nel) {
          int i, j, a;
          at(idx, i, j, a);
          const T* Tj = P + (size_t)j * ldp;
          T y[4] = {beta[i] * Tj[i], T(0), T(0), T(0)};
          int l = i + 1;
          for (; l + 3 < a + s; l += 4) {
#pragma unroll
            for (int u = 0; u < 4; ++u) y[u] += P[(size_t)(l + u) * ldp + i] * Tj[l + u];
          }
          for (; l < a + s; ++l) y[0] += P[(size_t)l * ldp + i] * Tj[l];
          acc = (y[0] + y[1]) + (y[2] + y[3]);
        }
        tv[u] = -acc;
      }
      __syncthreads();
#pragma unroll
      for (int u = 0; u < kEl; ++u) {
        const int idx = tid + u * kThreads;
        if (idx < nel) {
          int i, j, a;
          at(idx, i, j, a);
          P[(size_t)j * ldp + i] = tv[u];
        }
      }
      __syncthreads();
    }

    // ---- 3-4. the trailing columns, tile by tile: C -= V T' V' C ----
    // as three products on the tensor cores: W = V'C, W = -T'W, C += V W
    auto Tt = [=](int j, int i) -> double {  // T' (lower triangular)
      return (j >= b || i > j) ? 0.0 : (i == j ? (double)beta[j] : (double)P[(size_t)j * ldp + i]);
    };
    auto Wm = [=](int i, int c) -> double { return i < b ? (double)W[(size_t)i * ldc + c] : 0.0; };
    const int mb8 = (m + 7) / 8;
    if (ntiles > 0) load_tile(Cb0, 0);
    for (int tile = 0; tile < ntiles; ++tile) {
      T* C = (tile & 1) ? Cb1 : Cb0;
      if (nbuf == 1 && tile > 0) {
        __syncthreads();  // the previous tile is consumed
        load_tile(C, tile);
      }
      cp_async_wait<0>();
      __syncthreads();  // this tile is in; the other buffer is free
      if (nbuf == 2 && tile + 1 < ntiles) load_tile((tile & 1) ? Cb0 : Cb1, tile + 1);
      auto Cm = [=](int r, int c) -> double { return r < m ? (double)C[(size_t)r * ldc + c] : 0.0; };
      // a warp takes a row block of the tile's nc8 column blocks (at most
      // 4: nt <= 32), one A fragment for all of them
      const int nc8 = tile_c8(tile);
      for (int jb = warp; jb < nb8; jb += kWarps) {  // W = V'C
        double d[4][2] = {};
        const int jr = 8 * jb + (lane >> 2), tk = lane & 3;
        block_mma<T, 4>(d, 8 * jb, 0, 8 * jb, m, 8 * jb + 8, m & ~3,
                        P + (size_t)(jr < b ? jr : b - 1) * ldp + tk, 1, jr < b,
                        C + (size_t)tk * ldc + (lane >> 2), ldc, true, nc8, lane, Vt, Cm);
        if (jr >= b) continue;
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int c = 8 * v + 2 * (lane & 3);
          if (v < nc8) {
            W[(size_t)jr * ldc + c] = (T)d[v][0];
            W[(size_t)jr * ldc + c + 1] = (T)d[v][1];
          }
        }
      }
      __syncthreads();
      static_assert(13 <= kWarps, "a warp holds one row block of T'W");
      double wt[4][2] = {};
      if (warp < nb8) {  // W = -T'W, held until all have read W
        const int jb = warp, jr = 8 * jb + (lane >> 2), tk = lane & 3;
        block_mma<T, 4>(wt, 8 * jb, 0, 0, 8 * jb + 8 < b ? 8 * jb + 8 : b, 0, 8 * jb,
                        P + (size_t)(jr < b ? jr : b - 1) * ldp + tk, 1, jr < b,
                        W + (size_t)tk * ldc + (lane >> 2), ldc, true, nc8, lane, Tt, Wm);
      }
      __syncthreads();
      if (warp < nb8 && 8 * warp + (lane >> 2) < b) {
        const int j = 8 * warp + (lane >> 2);
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int c = 8 * v + 2 * (lane & 3);
          if (v < nc8) {
            W[(size_t)j * ldc + c] = (T)(-wt[v][0]);
            W[(size_t)j * ldc + c + 1] = (T)(-wt[v][1]);
          }
        }
      }
      __syncthreads();
      // C += V W; the top rows go to F_e, the bottom rows to F_{e+1} (carry)
      for (int rb = warp; rb < mb8; rb += kWarps) {
        const int r = 8 * rb + (lane >> 2), c0 = 2 * (lane & 3);
        double d[4][2];
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          d[v][0] = v < nc8 ? Cm(r, c0 + 8 * v) : 0.0;
          d[v][1] = v < nc8 ? Cm(r, c0 + 8 * v + 1) : 0.0;
        }
        const int kf1 = 8 * rb < (b & ~3) ? 8 * rb : (b & ~3);
        block_mma<T, 4>(d, 8 * rb, 0, 0, 8 * rb + 8 < b ? 8 * rb + 8 : b, 0, kf1,
                        P + (size_t)(lane & 3) * ldp + (r < m ? r : 0), ldp, r < m,
                        W + (size_t)(lane & 3) * ldc + (lane >> 2), ldc, true, nc8, lane, Vm, Wm);
        if (r >= m) continue;
#pragma unroll
        for (int v = 0; v < 4; ++v)
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int q = tile * nt + c0 + 8 * v + u;
            if (v >= nc8 || q >= ncols) continue;
            const int n = logical(q);
            if (r < b) Fe[(size_t)r * ldf + b + n] = (T)d[v][u];
            else Fn[(size_t)(r - b) * ldf + (n < 2 * b ? n : b + n)] = (T)d[v][u];
          }
      }
    }
    __syncthreads();  // F_{e+1}'s carry is written; the panel and tiles are free
  }

  // ---- 5. back substitution, x_k = R_k^{-1} (c_k - B_k x_{k+1} - C_k x_{k+2}) ----
  const int ldr = b | 1;
  const int ldy = nt | 1;
  T* Rt = P;                        // R_k transposed: R[r][i] at Rt[i * ldr + r]
  T* dinv = rdiag;
  T* y = Cb0;                       // (b, ldy): one tile of right-hand sides
  T* X = y + quad(b * ldy);         // (2b, ldy): [x_{k+1}; x_{k+2}] of the tile
  for (int k = S - 1; k >= 0; --k) {
    const T* Fk = ch.F + (size_t)k * b * ldf;
    const int nj = k + 2 < S ? 2 * b : (k + 1 < S ? b : 0);  // [B_k C_k]'s columns
    // R_k and the x the right-hand sides need, staged with cp.async (all in
    // flight at once: they come from L2)
    for (int idx = tid; idx < b * b; idx += kThreads) {
      const int r = idx / b, i = idx - r * b;
      if (i >= r) cp_async(Rt + (size_t)i * ldr + r, Fk + (size_t)r * ldf + i);
    }
    cp_async_commit();
    T* xk = ch.x + (size_t)k * b * t;
    for (int c0 = 0; c0 < t; c0 += nt) {
      const int tc = t - c0 < nt ? t - c0 : nt;
      __syncthreads();  // the previous tile is consumed
      for (int idx = tid; idx < nj * tc; idx += kThreads) {
        const int jj = idx / tc, c = idx - jj * tc;  // rows of x_{k+1}, then x_{k+2}
        cp_async(X + (size_t)jj * ldy + c, xk + (size_t)(b + jj) * t + c0 + c);
      }
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      for (int i = tid; i < b; i += kThreads) {
        T d = Rt[(size_t)i * ldr + i];
        d = absval(d) > T(1e-30) ? d : T(1e-30);
        dinv[i] = recip(d);
      }
      // y = c_k - [B_k C_k] X: four lanes a (row, right-hand side), each a
      // quarter of the 2b columns, summed with two shuffles
      const int ntask = 4 * b * tc;
      for (int base = tid - lane; base < ntask; base += kThreads) {
        const int task = base + lane, qq = task & 3, pr = task >> 2;
        const int i = pr / tc, c = pr - i * tc;
        T a[4] = {T(0), T(0), T(0), T(0)};
        if (task < ntask) {
          const T* Fi = Fk + (size_t)i * ldf + b;
          const T* Xc = X + c;
          int jj = qq;
          for (; jj + 12 < nj; jj += 16) {
            a[0] += Fi[jj] * Xc[(size_t)jj * ldy];
            a[1] += Fi[jj + 4] * Xc[(size_t)(jj + 4) * ldy];
            a[2] += Fi[jj + 8] * Xc[(size_t)(jj + 8) * ldy];
            a[3] += Fi[jj + 12] * Xc[(size_t)(jj + 12) * ldy];
          }
          for (; jj < nj; jj += 4) a[0] += Fi[jj] * Xc[(size_t)jj * ldy];
        }
        T sum = (a[0] + a[1]) + (a[2] + a[3]);
        sum += __shfl_xor_sync(kFull, sum, 1);
        sum += __shfl_xor_sync(kFull, sum, 2);
        if (task < ntask && qq == 0) y[(size_t)i * ldy + c] = Fk[(size_t)i * ldf + 3 * b + c0 + c] - sum;
      }
      __syncthreads();
      // R_k x = y: one warp a right-hand side, rows over lanes in
      // registers (row i is lane i % 32's slot i / 32; the slots unrolled,
      // so that every register index is a constant), x back into y
      for (int c = warp; c < tc; c += kWarps) {
        T yv[RB];
#pragma unroll
        for (int q = 0; q < RB; ++q) {
          const int r = lane + 32 * q;
          yv[q] = r < b ? y[(size_t)r * ldy + c] : T(0);
        }
#pragma unroll
        for (int q = RB - 1; q >= 0; --q) {
          for (int i = (32 * q + 31 < b - 1 ? 32 * q + 31 : b - 1); i >= 32 * q; --i) {
            const T xi = __shfl_sync(kFull, yv[q] * dinv[i], i & 31);
            const T* Ri = Rt + (size_t)i * ldr;
#pragma unroll
            for (int qq = 0; qq <= q; ++qq) {
              const int r = lane + 32 * qq;
              if (r < i) yv[qq] -= Ri[r] * xi;
              else if (r == i) yv[qq] = xi;
            }
          }
        }
#pragma unroll
        for (int q = 0; q < RB; ++q) {
          const int r = lane + 32 * q;
          if (r < b) y[(size_t)r * ldy + c] = yv[q];
        }
      }
      __syncthreads();
      for (int idx = tid; idx < b * tc; idx += kThreads) {
        const int r = idx / tc, c = idx - r * tc;
        xk[(size_t)r * t + c0 + c] = y[(size_t)r * ldy + c];
      }
    }
    __syncthreads();  // x_k is written; R_k's stage is free
  }
}

}  // namespace wide
