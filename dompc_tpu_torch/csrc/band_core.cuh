// Register-resident banded Householder-QR sweep of one block-tridiagonal
// chain: the device code that band_qr.cu (one thread block per chain) and
// band_sweep_tiled.cu (one warp per chain) share, and the launch plans
// that solver/band_qr.py mirrors (qr_plan, tiled_plan).
//
// The chain: diagonal blocks D (S, b, b), super-diagonal U (S-1, b, b),
// sub-diagonal Lo (S-1, b, b), right-hand sides r (S, b, t).  Elimination
// e = 0..S-1 works on the (2b, 3b+t) panel
//     [ Dhat | Uhat |  0  | rhat ]      carry (top b rows)
//     [ L_e  | D_e+1| U_e+1| r_e+1 ]    stage e+1 (bottom b rows; zero at e = S-1)
// and eliminates its first b columns with the scaled Householder reflector
// of dompc_tpu/solver/pallas_band.py:69-82 (= :196-209): the column scaled
// by its max-abs, so 1e22 barrier diagonals do not overflow the sum of
// squares in float, with the vtv > 1e-30 guard.  The top rows are the
// stage factors [R_e | B_e | C_e | c_e]; the bottom rows of columns
// b..3b-1 and of the right-hand sides carry up.  Back substitution
// x_k = R_k^{-1} (c_k - B_k x_{k+1} - C_k x_{k+2}) keeps the |d| > 1e-30
// guard (pallas_band.py:101).
//
// Design:
//   * Each thread of the group owns CPT panel columns and keeps each
//     column's 2b rows in registers: T top[CPT][MB], bot[CPT][MB], MB the
//     row bucket (a template parameter >= b).  Loops over rows are fully
//     unrolled; entries past the panel stay exactly zero, so they add
//     nothing to a sum and need no predicate.
//   * The pivot row is always register 0: column step j finishes row j of
//     every column, which leaves for the factor scratch F at once (row j
//     of [R_e | B_e | C_e | c_e]), and the top rows shift up by one, the
//     shift riding on the update's FMAs.  No register is indexed by j, so
//     the reflector (max-abs, scale, norm, alpha, beta) is straight-line
//     code with no selects; after b steps the top rows have all left.
//   * A column step: the reflector (v, beta) of pivot column j is built
//     from the owner's registers and reaches every thread, which applies
//     it to its own columns with register FMAs (the dot product in eight
//     partial sums).  A block (band_qr.cu) exchanges it through a shared
//     slot: two slots alternating by step parity, so ONE barrier per
//     column step and none before a slot is reused.  A warp
//     (band_sweep_tiled.cu) gathers the pivot column with __shfl_sync and
//     every lane builds the same reflector itself: no barrier at all.
//   * Stage changes move no data between threads: the thread that held
//     logical column c+b is relabelled c, so each thread only moves its
//     own bottom rows to its top rows; the threads that held the
//     eliminated columns 0..b-1 become the zero block 2b..3b-1.
//   * The next stage's rows of a thread's columns are copied into the
//     thread's own staging slots with cp.async while the current stage is
//     eliminated (commit/wait groups; no barrier, since no other thread
//     reads them).  Back substitution prefetches F_{k-1} the same way
//     while stage k is solved (double-buffered when it fits).  The copies
//     are single 4- or 8-byte elements: a b x b block is 676 bytes at
//     b = 13 in float, neither 16-byte sized nor 16-byte aligned, so TMA
//     bulk copies (and 16-byte cp.async) do not apply.
//   * Back substitution spreads c_k - B_k x_{k+1} - C_k x_{k+2} over all
//     (row, right-hand side) pairs of the group, then solves R_k one
//     right-hand side per thread in registers.  F_k is staged with its
//     blocks zero-padded to the bucket and 16-byte rows, and x in a ring
//     at a bank-spreading stride, so no row or column needs a guard and
//     rows and columns load as 16-byte vectors.
//   * Right-hand sides beyond the group's columns, or beyond what a
//     block's shared memory holds, are split into chunks, each solved by
//     its own group (the structural elimination is repeated; F holds one
//     slice per chunk).
//
// What bounds it on an H100: the S*b dependent column steps of a chain,
// not bytes or flops.  At the flagship (S=21, b=13, t=12) a chain moves
// ~67 KB (float) and does ~1.2 MFLOP, i.e. 0.18 us of bytes for 9 chains,
// but 273 column steps of ~850-1000 cycles each: one warp working
// through short dependent instruction chains (tools/band_probe.py).
// Tensor cores are not used: a panel of m = 2b = 26 rows takes one rank-1
// update per column; a blocked WY update of 13 reflectors could feed mma
// only in TF32, which keeps ~3 digits (not enough for the 1e22-diagonal
// barrier chains), or as f64 DMMA at 8x8x4, and neither shortens the
// dependent reflector chain.
#pragma once
#include <cuda_runtime.h>
#include <stddef.h>

namespace band {

// Row buckets: the register arrays' sizes.  13 is the flagship's b; 97 is
// the widest b that float32 inputs may have (the wrappers' acceptance).
constexpr int kBuckets[] = {4, 8, 13, 16, 32, 64, 97};
constexpr int kNumBuckets = sizeof(kBuckets) / sizeof(kBuckets[0]);

inline int row_bucket(int b) {
  for (int i = 0; i < kNumBuckets; ++i)
    if (b <= kBuckets[i]) return kBuckets[i];
  return -1;
}

// words of one reflector slot: v (2 * rows) and beta, rounded up to 4 so
// that a slot moves in 16-byte vectors
__host__ __device__ constexpr int slot_words(int rows) { return (2 * rows + 1 + 3) / 4 * 4; }
// the back substitution stages F_k as [R | B | C | c] with each block
// padded to quad(rows) columns and the row stride a multiple of 4, so a
// row moves in 16-byte vectors; unrolled buckets (rows <= 32) also stage
// rows past b as zeros
__host__ __device__ constexpr int quad(int n) { return (n + 3) / 4 * 4; }
__host__ __device__ constexpr int staged_rows(int rows, int b) { return rows <= 32 ? rows : b; }
__host__ __device__ constexpr int staged_stride(int rows, int tcp) {
  return 3 * quad(rows) + quad(tcp);
}
// stride of a right-hand side in the x ring (rows contiguous): in the
// unrolled buckets a multiple of 4 with an odd quotient, so 8 threads
// reading 16-byte vectors of 8 right-hand sides hit distinct banks; odd in
// the rest, for scalar reads
__host__ __device__ constexpr int ring_stride(int rows) {
  return rows > 32 ? (rows | 1) : ((quad(rows) / 4) & 1) ? quad(rows) : quad(rows) + 4;
}
// band_qr: threads a block may have (one panel column each)
__host__ __device__ constexpr int qr_max_threads(int rows) {
  return (3 * rows + 1 + 31) / 32 * 32 > 256 ? (3 * rows + 1 + 31) / 32 * 32 : 256;
}
// band_sweep_tiled: panel columns per lane (room for >= 16 right-hand
// sides beside the 3 * rows structural columns)
__host__ __device__ constexpr int tiled_cols(int rows) { return (3 * rows + 16 + 31) / 32; }

constexpr size_t kSmemMax = 232448;  // dynamic shared memory of one H100 block
constexpr int kTiledMaxG = 4;        // warps (chains) per tiled block

// Right-hand-side chunking: at most `room` columns per group.
inline void chunk(int t, int room, int* tcp, int* nch) {
  int tmax = t < 1 ? 1 : t;
  if (tmax > room) tmax = room;
  *nch = t <= 0 ? 1 : (t + tmax - 1) / tmax;
  *tcp = t <= 0 ? 0 : (t + *nch - 1) / *nch;
}

// Words of one staging buffer, a multiple of 4: the next stage's rows
// (b x W physical columns) in the forward sweep, the staged F_k in the
// back substitution.
__host__ __device__ constexpr int stage_words(int rows, int b, int W, int tcp) {
  return quad(b * W > staged_rows(rows, b) * staged_stride(rows, tcp)
                  ? b * W
                  : staged_rows(rows, b) * staged_stride(rows, tcp));
}

// Shared words of one group, a multiple of 4 (groups stay 16-byte
// aligned): 2 reflector slots, nbuf staging buffers and the ring of three
// x blocks of tcp right-hand sides.
inline size_t group_words(int rows, int b, int W, int tcp, int nbuf) {
  return (size_t)2 * slot_words(rows) + (size_t)nbuf * stage_words(rows, b, W, tcp) +
         quad(3 * ring_stride(rows) * tcp);
}

struct Plan {
  int rows, W, tcp, nch, nbuf;
  size_t words;  // per group
};

// Staging buffers and words of a group (W: fixed, or 0 for band_qr's 3b +
// tcp rounded up to 32); while a group does not fit one block's shared
// memory, the right-hand sides go to more, narrower chunks.
inline bool fit(int b, int t, int W, int itemsize, Plan* p) {
  for (int n = p->nch;;) {
    p->W = W ? W : (3 * b + p->tcp + 31) / 32 * 32;
    p->nbuf = group_words(p->rows, b, p->W, p->tcp, 2) * itemsize <= kSmemMax ? 2 : 1;
    p->words = group_words(p->rows, b, p->W, p->tcp, p->nbuf);
    if (p->words * itemsize <= kSmemMax) return true;
    if (p->tcp <= 1) return false;
    p->tcp = (t + n) / (n + 1);
    p->nch = (t + p->tcp - 1) / p->tcp;
    ++n;
  }
}

// band_qr.cu: one block of W threads per (chain, chunk); itemsize bytes.
inline bool qr_plan(int b, int t, int itemsize, Plan* p) {
  p->rows = row_bucket(b);
  if (b < 1 || p->rows < 0) return false;
  chunk(t, qr_max_threads(p->rows) - 3 * b, &p->tcp, &p->nch);
  return fit(b, t, 0, itemsize, p);
}

// band_sweep_tiled.cu (float): one warp per (chain, chunk).
inline bool tiled_plan(int b, int t, Plan* p) {
  p->rows = row_bucket(b);
  if (b < 1 || p->rows < 0) return false;
  chunk(t, 32 * tiled_cols(p->rows) - 3 * b, &p->tcp, &p->nch);
  return fit(b, t, 32 * tiled_cols(p->rows), 4, p);
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
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// A reflector slot (N words, a multiple of 4, 16-byte aligned) moved in
// 16-byte vectors between shared memory and a register array.
template <typename T> struct Vec16;
template <> struct Vec16<float> { using type = float4; };
template <> struct Vec16<double> { using type = double2; };

template <typename T, int N>
__device__ __forceinline__ void load16(T (&dst)[N], const T* src) {
  using V = typename Vec16<T>::type;
  constexpr int K = 16 / sizeof(T);
#pragma unroll
  for (int u = 0; u < N / K; ++u)
    *reinterpret_cast<V*>(&dst[u * K]) = reinterpret_cast<const V*>(src)[u];
}

template <typename T, int N>
__device__ __forceinline__ void store16(T* dst, const T (&src)[N]) {
  using V = typename Vec16<T>::type;
  constexpr int K = 16 / sizeof(T);
#pragma unroll
  for (int u = 0; u < N / K; ++u)
    reinterpret_cast<V*>(dst)[u] = *reinterpret_cast<const V*>(&src[u * K]);
}

struct BlockGroup {  // one thread block per chain
  __device__ static int rank() { return threadIdx.x; }
  __device__ static int size() { return blockDim.x; }
  __device__ static void sync() { __syncthreads(); }
};

struct WarpGroup {  // one warp per chain
  __device__ static int rank() { return threadIdx.x & 31; }
  __device__ static int size() { return 32; }
  __device__ static void sync() { __syncwarp(); }
};

// One (chain, right-hand-side chunk): pointers already offset to the chain.
template <typename T>
struct Chain {
  const T* D;
  const T* U;
  const T* Lo;
  const T* rhs;
  T* x;
  T* F;       // (S, b, ldf): this item's factor scratch
  int S, b, t;
  int c0, tc; // this item's right-hand sides [c0, c0 + tc)
  int tcp;    // the plan's chunk width (ldf = 3b + tcp)
};

// Work item `item` = (chain n, chunk g) of a launch over N chains of the
// (N, S, b, b) / (N, S-1, b, b) / (N, S, b, t) inputs; F holds
// (N * nch, S, b, 3b + tcp).
template <typename T>
__device__ __forceinline__ Chain<T> make_item(const T* D, const T* U, const T* Lo,
                                              const T* rhs, T* x, T* F, long long item,
                                              int S, int b, int t, int tcp, int nch) {
  const long long n = item / nch;
  const int g = (int)(item % nch);
  const long long bb = (long long)b * b;
  Chain<T> ch;
  ch.D = D + n * S * bb;
  ch.U = U + n * (S - 1) * bb;
  ch.Lo = Lo + n * (S - 1) * bb;
  ch.rhs = rhs + n * S * b * t;
  ch.x = x + n * S * b * t;
  ch.F = F + item * S * b * (3 * b + tcp);
  ch.S = S;
  ch.b = b;
  ch.t = t;
  ch.c0 = g * tcp;
  ch.tc = t - ch.c0 < tcp ? t - ch.c0 : tcp;
  ch.tcp = tcp;
  return ch;
}

// Column c of stage k's row block [L_{k-1} | D_k | U_k | r_k] (element i at
// p[i * ld]); nullptr where the block is zero (L_{-1}, U_{S-1}).
template <typename T>
__device__ __forceinline__ const T* stage_col(const Chain<T>& ch, int k, int c, int& ld) {
  const int b = ch.b;
  const size_t bb = (size_t)b * b;
  ld = b;
  if (c < b) return k >= 1 ? ch.Lo + (k - 1) * bb + c : nullptr;
  if (c < 2 * b) return ch.D + k * bb + (c - b);
  if (c < 3 * b) return k < ch.S - 1 ? ch.U + k * bb + (c - 2 * b) : nullptr;
  ld = ch.t;
  return ch.rhs + (size_t)k * b * ch.t + ch.c0 + (c - 3 * b);
}

// Max-abs and sum of squares over the MB entries of two arrays, as short
// trees (the dependent chains of a column step are what the kernels wait on).
template <typename T, int MB>
__device__ __forceinline__ T max_abs(const T (&a)[MB], const T (&c)[MB]) {
  T m[8];
#pragma unroll
  for (int u = 0; u < 8; ++u) m[u] = T(0);
#pragma unroll
  for (int i = 0; i < MB; ++i) {
    m[i & 3] = maxval(m[i & 3], absval(a[i]));
    m[4 + (i & 3)] = maxval(m[4 + (i & 3)], absval(c[i]));
  }
  return maxval(maxval(maxval(m[0], m[1]), maxval(m[2], m[3])),
                maxval(maxval(m[4], m[5]), maxval(m[6], m[7])));
}

template <typename T>
__device__ __forceinline__ T sum8(const T (&s)[8]) {
  return ((s[0] + s[1]) + (s[2] + s[3])) + ((s[4] + s[5]) + (s[6] + s[7]));
}

// The reflector of the column (ct: the top rows from the pivot row down,
// cb: the bottom rows; entries past the panel are zero), exactly
// pallas_band.py:69-82 up to the order of the sums: v = x / max|x| with
// v[0] -= alpha, beta = 2 / v.v (0 unless v.v > 1e-30).
template <typename T, int MB>
__device__ __forceinline__ void reflector(const T (&ct)[MB], const T (&cb)[MB],
                                          T (&vt)[MB], T (&vb)[MB], T& beta) {
  const T amax = max_abs<T, MB>(ct, cb);
  const T inv = amax > T(0) ? T(1) / amax : T(0);
  T s[8];
#pragma unroll
  for (int u = 0; u < 8; ++u) s[u] = T(0);
#pragma unroll
  for (int i = 0; i < MB; ++i) {
    vt[i] = ct[i] * inv;
    vb[i] = cb[i] * inv;
    s[i & 3] += vt[i] * vt[i];
    s[4 + (i & 3)] += vb[i] * vb[i];
  }
  const T sigma = sum8(s);
  const T xj = vt[0];
  const T alpha = -(xj >= T(0) ? T(1) : T(-1)) * sqrtval(sigma);
  const T vtv = sigma - xj * xj + (xj - alpha) * (xj - alpha);
  beta = vtv > T(1e-30) ? T(2) / vtv : T(0);
  vt[0] = xj - alpha;
}

// column -= beta * v * (v . column); returns the pivot row's final value
// and shifts the top rows up by one (the next pivot row to index 0, a zero
// in at the end): the shift rides on the update's FMAs.
template <typename T, int MB>
__device__ __forceinline__ T apply(T (&ct)[MB], T (&cb)[MB], const T (&vt)[MB],
                                   const T (&vb)[MB], T beta) {
  T w[8];
#pragma unroll
  for (int u = 0; u < 8; ++u) w[u] = T(0);
#pragma unroll
  for (int i = 0; i < MB; ++i) {
    w[i & 3] += vt[i] * ct[i];
    w[4 + (i & 3)] += vb[i] * cb[i];
  }
  const T bw = beta * sum8(w);
  const T fin = ct[0] - bw * vt[0];
#pragma unroll
  for (int i = 0; i + 1 < MB; ++i) ct[i] = ct[i + 1] - bw * vt[i + 1];
  ct[MB - 1] = T(0);
#pragma unroll
  for (int i = 0; i < MB; ++i) cb[i] -= bw * vb[i];
  return fin;
}

// Build the reflector of the column and post it to a shared slot
// ([v_top | v_bot | beta | pad], written as 16-byte vectors).
template <typename T, int MB, int VS>
__device__ __forceinline__ void post_reflector(const T (&ct)[MB], const T (&cb)[MB], T* slot) {
  T vt[MB], vb[MB], beta, img[VS];
  reflector<T, MB>(ct, cb, vt, vb, beta);
#pragma unroll
  for (int i = 0; i < MB; ++i) { img[i] = vt[i]; img[MB + i] = vb[i]; }
#pragma unroll
  for (int i = 2 * MB; i < VS; ++i) img[i] = i == 2 * MB ? beta : T(0);
  store16<T, VS>(slot, img);
}

// Solve one chain (one right-hand-side chunk of it) with a group of
// threads (Grp); sm: the group's shared words (group_words), nbuf: staging
// buffers (1 or 2).  SHFL (warp groups): exchange the pivot column with
// shuffles; otherwise through the shared reflector slots.
template <typename T, int MB, int CPT, class Grp, bool SHFL>
__device__ void solve_chain(const Chain<T>& ch, T* sm, int nbuf) {
  constexpr int QU = CPT <= 4 ? CPT : 1;  // wider instances index their
  constexpr int RU = MB <= 32 ? MB : 1;   // columns (and rows, in the back
  constexpr int VS = slot_words(MB);      // substitution) in local memory
  const int S = ch.S, b = ch.b, tc = ch.tc, tcp = ch.tcp;
  const int b3 = 3 * b, npc = b3 + tc, ldf = b3 + tcp;
  const int r = Grp::rank(), G = Grp::size(), W = G * CPT;
  const int bufw = stage_words(MB, b, W, tcp);
  T* slots = sm;                  // 2 x VS
  T* stg = slots + 2 * VS;        // nbuf x bufw
  T* ring = stg + nbuf * bufw;    // 3 x (tcp, ring_stride(MB))

  // top[q]: the column's top-half rows from the current pivot row down;
  // bot[q]: its bottom-half rows; entries past the panel stay zero
  T top[CPT][MB], bot[CPT][MB];
  int lc[CPT];  // logical column of each owned physical column; -1: idle
#pragma unroll (QU)
  for (int q = 0; q < CPT; ++q) {
    const int P = r + q * G;
    lc[q] = P < npc ? P : -1;
    int ldt = 0, ldb = 0;
    const T* st = nullptr;
    const T* sb = nullptr;
    if (lc[q] >= 0) {
      const int c = lc[q];
      st = c < 2 * b ? stage_col(ch, 0, c + b, ldt) : (c < b3 ? nullptr : stage_col(ch, 0, c, ldt));
      sb = S > 1 ? stage_col(ch, 1, c, ldb) : nullptr;
    }
#pragma unroll
    for (int i = 0; i < MB; ++i) {
      top[q][i] = (st && i < b) ? st[(size_t)i * ldt] : T(0);
      bot[q][i] = (sb && i < b) ? sb[(size_t)i * ldb] : T(0);
    }
  }

  int rot = 0;   // physical column of logical column 0: (e * b) mod 3b
  int step = 0;  // column steps so far (slot parity)
  for (int e = 0; e < S; ++e) {
    // prefetch the rows of stage e+2 (elimination e+1) for the columns
    // this thread will own then
    if (e + 2 < S) {
      T* buf = stg + (nbuf == 2 ? ((e + 1) & 1) : 0) * bufw;
#pragma unroll (QU)
      for (int q = 0; q < CPT; ++q) {
        if (lc[q] < 0) continue;
        int c = lc[q];
        if (c < b3) c = c < b ? c + 2 * b : c - b;
        int ld;
        const T* src = stage_col(ch, e + 2, c, ld);
        if (!src) continue;
        const int P = r + q * G;
#pragma unroll
        for (int i = 0; i < MB; ++i)
          if (i < b) cp_async(buf + i * W + P, src + (size_t)i * ld);
      }
      cp_async_commit();
    }

    // b column steps; step j finishes row j of every column: [R_e | B_e |
    // C_e | c_e] leaves for F one row at a time
    T* fp[CPT];
#pragma unroll (QU)
    for (int q = 0; q < CPT; ++q) fp[q] = ch.F + (size_t)e * b * ldf + (lc[q] < 0 ? 0 : lc[q]);
    for (int j = 0; j < b; ++j, ++step) {
      T vt[MB], vb[MB], beta;
      if constexpr (SHFL) {
        int pj = j + rot;
        if (pj >= b3) pj -= b3;
        const int lane = pj % G, qj = pj / G;
        T ct[MB], cb[MB];
#pragma unroll
        for (int i = 0; i < MB; ++i) {
          T a, c;
          if constexpr (QU == CPT) {
            a = top[0][i];
            c = bot[0][i];
#pragma unroll
            for (int q = 1; q < CPT; ++q)
              if (q == qj) { a = top[q][i]; c = bot[q][i]; }
          } else {
            a = top[qj][i];
            c = bot[qj][i];
          }
          ct[i] = __shfl_sync(0xffffffffu, a, lane);
          cb[i] = __shfl_sync(0xffffffffu, c, lane);
        }
        reflector<T, MB>(ct, cb, vt, vb, beta);
      } else {
        T* slot = slots + (step & 1) * VS;
        if (j == 0) {  // the first pivot of the stage (later ones: below)
#pragma unroll (QU)
          for (int q = 0; q < CPT; ++q)
            if (lc[q] == 0) post_reflector<T, MB, VS>(top[q], bot[q], slot);
        }
        Grp::sync();  // the one barrier of the column step
        T img[VS];
        load16<T, VS>(img, slot);
#pragma unroll
        for (int i = 0; i < MB; ++i) { vt[i] = img[i]; vb[i] = img[MB + i]; }
        beta = img[2 * MB];
      }
#pragma unroll (QU)
      for (int q = 0; q < CPT; ++q) {
        const T fin = apply<T, MB>(top[q], bot[q], vt, vb, beta);
        if (lc[q] >= 0) *fp[q] = fin;
        fp[q] += ldf;
      }
      if constexpr (!SHFL) {
        if (j + 1 < b) {  // the owner of the next pivot builds it at once
          T* next = slots + ((step + 1) & 1) * VS;
#pragma unroll (QU)
          for (int q = 0; q < CPT; ++q)
            if (lc[q] == j + 1) post_reflector<T, MB, VS>(top[q], bot[q], next);
        }
      }
    }
    if (e + 1 == S) break;

    // carry up: relabel (c+b -> c, eliminated 0..b-1 -> zero block
    // 2b..3b-1), move the bottom rows up (the top rows have all left),
    // take the next stage's rows
    const bool staged = e + 2 < S;
    if (staged) cp_async_wait_all();
    const T* buf = stg + (nbuf == 2 ? ((e + 1) & 1) : 0) * bufw;
    rot += b;
    if (rot >= b3) rot -= b3;
#pragma unroll (QU)
    for (int q = 0; q < CPT; ++q) {
      if (lc[q] < 0) continue;
      const int old = lc[q];
      int c = old;
      if (c < b3) c = c < b ? c + 2 * b : c - b;
      lc[q] = c;
      int ld;
      const bool valid = staged && stage_col(ch, e + 2, c, ld) != nullptr;
      const int P = r + q * G;
#pragma unroll
      for (int i = 0; i < MB; ++i) {
        top[q][i] = old < b ? T(0) : bot[q][i];
        bot[q][i] = (valid && i < b) ? buf[i * W + P] : T(0);
      }
    }
  }

  // back substitution: F_k staged in shared memory (prefetched one stage
  // ahead when two buffers fit); x_k in a ring of three blocks,
  // right-hand side c at c * XS.  The pads and the x rows past b are zero,
  // so the unrolled loops need no guards, and rows move as vectors.
  constexpr bool UNR = RU == MB;
  constexpr int MBV = quad(MB);             // staged block stride
  constexpr int LF = 3 * MBV;               // staged column of c_k
  constexpr int XS = ring_stride(MB);
  const int lds = staged_stride(MB, tcp);   // staged row stride
  const int nr = staged_rows(MB, b);        // MB when unrolled, else b
  const int xblk = XS * tcp;
  for (int idx = r; idx < nbuf * bufw; idx += G) stg[idx] = T(0);
  for (int idx = r; idx < 3 * xblk; idx += G) ring[idx] = T(0);
  Grp::sync();  // every thread's F rows are written, the pads are zero
  auto fetch = [&](int k) {
    T* dst = stg + (nbuf == 2 ? (k & 1) : 0) * bufw;
    const T* src = ch.F + (size_t)k * b * ldf;
    for (int c = r; c < ldf; c += G) {
      const int blk = c < b ? 0 : c < 2 * b ? 1 : c < b3 ? 2 : 3;
      T* d = dst + blk * MBV + (c - blk * b);
      for (int i = 0; i < b; ++i) cp_async(d + i * lds, src + i * ldf + c);
    }
    cp_async_commit();
  };
  // a row of B or C (at Fi) times a right-hand side's x (at y), into a[0..3]
  auto dot = [&](const T* Fi, const T* y, T* a) {
    if constexpr (UNR) {
      T fv[MBV], yv[MBV];
      load16<T, MBV>(fv, Fi);
      load16<T, MBV>(yv, y);
#pragma unroll
      for (int jj = 0; jj < MB; ++jj) a[jj & 3] -= fv[jj] * yv[jj];
    } else {
      for (int jj = 0; jj < nr; ++jj) a[jj & 3] -= Fi[jj] * y[jj];
    }
  };
  fetch(S - 1);
  // this thread's first (row, right-hand side) pair and its stride
  const int di = tc > 0 ? G / tc : 0, dc = tc > 0 ? G - di * tc : 0;
  const int i0 = tc > 0 ? r / tc : b, c0 = tc > 0 ? r - i0 * tc : 0;
  for (int k = S - 1; k >= 0; --k) {
    cp_async_wait_all();
    Grp::sync();  // F_k and x_{k+1} visible; the other buffer is free
    if (k > 0 && nbuf == 2) fetch(k - 1);
    const T* Fk = stg + (nbuf == 2 ? (k & 1) : 0) * bufw;
    T* xk = ring + (k % 3) * xblk;
    const T* x1 = ring + ((k + 1) % 3) * xblk;
    const T* x2 = ring + ((k + 2) % 3) * xblk;
    // c_k - B_k x_{k+1} - C_k x_{k+2}, one (row, right-hand side) pair per
    // thread at a time
    for (int i = i0, c = c0; i < b; i += di, c += dc) {
      if (c >= tc) { c -= tc; ++i; if (i >= b) break; }
      const T* Fi = Fk + i * lds;
      T a[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) a[u] = T(0);
      a[0] = Fi[LF + c];
      if (k + 1 < S) dot(Fi + MBV, x1 + c * XS, a);
      if (k + 2 < S) dot(Fi + 2 * MBV, x2 + c * XS, a + 4);
      xk[c * XS + i] = sum8(a);
    }
    Grp::sync();
    // R_k x_k = (that), one right-hand side per thread, in registers
    for (int c = r; c < tc; c += G) {
      T* y = xk + c * XS;
      T xv[UNR ? MBV : MB];
      if constexpr (UNR) load16<T, MBV>(xv, y);
      else for (int i = 0; i < nr; ++i) xv[i] = y[i];
#pragma unroll (RU)
      for (int i = nr - 1; i >= 0; --i) {
        const T* Fi = Fk + i * lds;
        T a0 = xv[i], a1 = T(0);
        if constexpr (UNR) {
          T rv[MBV];
          load16<T, MBV>(rv, Fi);
#pragma unroll
          for (int jj = i + 1; jj < MB; ++jj) {
            if (jj & 1) a1 -= rv[jj] * xv[jj];
            else a0 -= rv[jj] * xv[jj];
          }
        } else {
          for (int jj = i + 1; jj < nr; ++jj) {
            if (jj & 1) a1 -= Fi[jj] * xv[jj];
            else a0 -= Fi[jj] * xv[jj];
          }
        }
        T d = Fi[i];
        d = absval(d) > T(1e-30) ? d : T(1e-30);
        xv[i] = (a0 + a1) / d;
      }
      if constexpr (UNR) store16<T, MBV>(y, xv);
      else for (int i = 0; i < nr; ++i) y[i] = xv[i];
      T* xo = ch.x + (size_t)k * b * ch.t + ch.c0 + c;
#pragma unroll (RU)
      for (int i = 0; i < MB; ++i)
        if (i < b) xo[(size_t)i * ch.t] = xv[i];
    }
    if (k > 0 && nbuf == 1) {
      Grp::sync();  // F_k fully read before the one buffer is refilled
      fetch(k - 1);
    }
  }
}

}  // namespace band
