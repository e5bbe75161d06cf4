// Batched no-pivot banded LU solve with R right-hand sides that share the
// band matrix of their column: one elimination per column, R substitutions;
// and its one-right-hand-side case, `banded_solve`.
//
// Replaces the TPU kernels `banded_solve_multi_pallas` (`_banded_multi_kernel`)
// and `banded_solve_pallas` (`_banded_kernel`) of
// tempestmodel_tpu/ops/pallas_banded.py (the implicit vertical tracer update:
// every species of a column has the same matrix; the unfused path's Newton
// solve, one right-hand side).  The multi kernel holds
// a 512-column tile with its U-factor and the forward solutions in on-chip
// memory; the idea that carries over is that these never reach device
// memory.  Layout: the column axis minor in `bands (n, 2q+1, ncol)`,
// `rhs (n, R, ncol)` and `out (n, R, ncol)`; the half-bandwidth Q is a
// template parameter (1..8), R a run-time size.
//
// Bound on an H100 (3.35 TB/s): bytes.  The function must read bands and rhs
// once and write out once: at n = 30, q = 1, R = 3, ncol = 86 400, float32
// that is 3 x 31.1 MB = 93.3 MB, about 0.028 ms.  Arithmetic is about 30
// flops per row and column (0.08 GFLOP, microseconds).  `banded_solve` at
// the unfused path's Newton systems (n = 91, q = 4, R = 1, ncol = 86 400,
// float32): 283 MB of bands, 31 MB of rhs, 31 MB of x, about 0.103 ms.
//
// The tile form (`multi_tile_kernel`, the moist wave's and every shape
// whose tile fits): a block owns a tile of C columns (C a multiple of 32,
// one thread a column) and all its rows.
//   1. stage: every band row and right-hand-side row of the tile, n (2q+1+R)
//      rows of C values, goes into shared memory by asynchronous copies, all
//      issued at once: one 1-D bulk copy (TMA, `cp.async.bulk`) a row where
//      rows and pointers are 16-byte multiples, else `cp.async` of 8 or 4
//      bytes (`copy`, chosen per launch by ops/cuda_banded.copy_width and
//      checked here).  The copies complete on one mbarrier per chunk of
//      `chunk` rows, so the elimination of row 0 starts when the first chunk
//      has landed while the later chunks are still in flight;
//   2. the elimination, one thread a column for the first C threads
//      (column = lane: a warp's accesses hit C consecutive values, no bank
//      conflict), each chunk as soon as it has landed: row i's multipliers
//      from the last Q U rows (kept in registers) written over the band's
//      first Q entries, its U row over the rest, in place;
//   3. the substitutions, every thread: the block has C x G threads and
//      thread (c, g) takes right-hand sides g, g + G, ... of column c; the
//      forward values overwrite the right-hand side in place, the last Q
//      forward values and then the last Q solutions stay in registers, and
//      each solution goes to `out` as it is found, the tile's only trip to
//      device memory (a warp stores C consecutive values).
// Nothing else goes to device memory: no U-factor scratch, no second pass
// over `out`.  The substitutions of the R right-hand sides are independent
// once the column is eliminated, so they run side by side: a column's
// dependent chain is the elimination plus one right-hand side's
// substitutions, not R of them.  A tile of 32 columns of the moist wave's
// systems takes 23 KB (float32), so several tiles share an SM and one
// tile's serial elimination overlaps another's copies and substitutions.
//
// The stream form (`multi_stream_kernel`, shapes whose tile of 32 columns
// does not fit a block's 227 KB: many rows with a wide band or many
// right-hand sides): one thread a column reads its band and right-hand-side
// rows from device memory as it eliminates them (coalesced across the
// warp), keeps the U rows of the last `chunk` rows in shared memory, and
// parks the forward values in `out`.  The back substitution walks the
// chunks from the last; for every chunk but the last it first eliminates
// again from row 0 (multipliers and U rows only) to rebuild that chunk's U
// rows.  Still no scratch: `out` and shared memory hold everything.  The
// host chooses the form by shape (ops/cuda_banded.banded_multi_launch_shape).
//
// The ring form (`solve_ring_kernel`, `banded_solve`: R = 1, every shape
// whose U rows fit a block).  With one right-hand side the forward value
// folds into the elimination, so a row's multipliers are dead once the row
// is eliminated and a column keeps on chip only what the back substitution
// needs: each row's U row and forward value, (q + 2) n values (2.2 KB a
// column at n = 91, q = 4, float32).  A block is one warp and owns C
// columns (32, 16 or 8; lane = column).  The band rows do not sit on chip
// whole: row i's 2q + 2 staged values of a column (its band row and
// right-hand side) stream through a ring of RING_SLOTS slots, each lane
// copying its own column's values by `cp.async`, one commit group a row,
// and waiting on its own groups (`cp.async.wait_group`), so RING_SLOTS - 1
// rows are in flight while a row is eliminated (fewer were slower on an
// H100) and no lane waits on another.  The back substitution reads the U rows where they lie and
// writes x once, coalesced across the warp.  Nothing but x goes to device
// memory.  A block of C = 32 columns takes 75 KB at n = 91, q = 4 (float32;
// C = 16 in float64), so three blocks share an SM; the host rule
// (ops/cuda_banded.banded_solve_launch_shape) takes the C that keeps the
// most columns on an SM.  A column is a serial chain, so the time is that
// chain's over the columns an SM holds: the row loop runs two rows an
// iteration, so that a row's first steps overlap the previous row's last,
// and the quotients come from the pivots' reciprocals (`quick_div`, the
// division's bits; a column whose operands leave the range where that
// holds is solved again by divisions).  Staging
// the rows by 1-D bulk copies on an mbarrier, a copy a staged row, was 2.8x
// slower on an H100 (2.2x with plain loads prefetched into registers): the
// issue of ten small copies a row took about 880 cycles, half of a warp's
// time.  Shapes whose U rows do not fit a block even at C = 8 run the
// stream form with R = 1.
//
// Every form does the arithmetic of models/vertical_banded.banded_solve_t /
// banded_solve_multi_t in its order: a division per multiplier (the ring
// form: its bits, `quick_div`), each update a fused multiply-add; the same
// code eliminates a row in every form, so the stream form's second
// elimination rebuilds the first one's U rows bit for bit.
//
// Plain C interface (no PyTorch header): the launch goes to the given
// stream, nothing synchronises or allocates, and the entry point returns
// cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int MAX_Q = 8;
constexpr int MAX_THREADS = 256;  // most threads a block
constexpr int MAX_BARS = 16;      // the tile form's mbarriers
constexpr int BAR_BYTES = 8 * MAX_BARS;
constexpr int SMEM_MAX = 232448;  // dynamic shared memory of an H100 block
constexpr int FORM_TILE = 0, FORM_STREAM = 1, FORM_RING = 2;
constexpr int RING_SLOTS = 5;     // the ring form's slots a lane

template <typename T>
struct MultiArgs {
  const T* bands;
  const T* rhs;
  T* out;
  long long ncol;
  int n, R;
  int C;      // columns a block
  int chunk;  // tile: rows an mbarrier; stream: U rows kept on chip
  int copy;   // tile: bytes a staging copy (16: bulk copies)
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void bar_init(unsigned long long* bar,
                                         unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(
                   smem_addr(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_arrive_expect(unsigned long long* bar,
                                                  unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_addr(bar)), "r"(bytes) : "memory");
}
// waits until the phase of parity `parity` has completed
__device__ __forceinline__ void bar_wait(unsigned long long* bar,
                                         unsigned parity) {
  asm volatile(
      "{\n .reg .pred done;\n WAIT_%=:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      " @!done bra WAIT_%=;\n}" ::"r"(smem_addr(bar)), "r"(parity)
      : "memory");
}
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)), "l"(src), "r"(bytes),
      "r"(smem_addr(bar)) : "memory");
}
template <int BYTES>
__device__ __forceinline__ void copy_async(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;" ::"r"(
                   smem_addr(dst)), "l"(src), "n"(BYTES) : "memory");
}
// the mbarrier receives one arrival once this thread's cp.async are done
__device__ __forceinline__ void copies_arrive(unsigned long long* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
                   smem_addr(bar)) : "memory");
}

// a * b + c rounded once (the updates of the elimination and substitutions)
__device__ __forceinline__ float fma_rn(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double fma_rn(double a, double b, double c) {
  return __fma_rn(a, b, c);
}

__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}

// The ring form's quotients w / p, bit for bit those of the division, from
// y = 1 / p formed once a pivot, off the chain of the eliminations that
// divide by it: a division puts its whole latency on that chain, and its
// slow path for the zero entries that fill most of the Newton systems'
// bands (the ring form took 1.5x as long on them as on random systems with
// divisions, on an H100).  q = w y corrected once by the exact residual
// w - p q (two fmas) is the correctly rounded quotient by Markstein's
// theorem where y is 1 / p rounded to nearest and normal, and w, w y, the
// residual and the quotient neither overflow nor underflow.  `Range` keeps
// that with a margin: a pivot in [lo, hi], |w| >= w_lo (the residual's
// bits stay above the subnormal range), a quotient in [lo, q_hi]; a zero w
// gives w y, which has the division's sign.  Anything else clears `ok`, a
// predicate beside the chain (no branch), and a column whose `ok` is
// cleared is solved again by divisions (`solve_ring_kernel`).
// tests/test_torch_banded_solve.py holds the outcome bit for bit against
// the division, on the card (`banded_div_*`) and emulated on the CPU.
template <typename T>
struct Range;
template <>
struct Range<float> {
  static constexpr float lo = 0x1p-124f, hi = 0x1p124f, w_lo = 0x1p-100f,
                         q_hi = 0x1p126f;
};
template <>
struct Range<double> {
  static constexpr double lo = 0x1p-1020, hi = 0x1p1020, w_lo = 0x1p-967,
                          q_hi = 0x1p1022;
};
template <typename T>
__device__ __forceinline__ T recip(T p, bool& ok) {
  const T a = fabs(p);
  ok = ok & (a >= Range<T>::lo) & (a <= Range<T>::hi);
  return T(1) / p;
}
template <typename T>
__device__ __forceinline__ T quick_div(T w, T p, T y, bool& ok) {
  const T q = mul_rn(w, y);
  const T r = fma_rn(fma_rn(-p, q, w), y, q);
  const T a = fabs(r);
  const bool zero = w == T(0);
  ok = ok & (zero | ((a >= Range<T>::lo) & (a <= Range<T>::q_hi) &
                     (fabs(w) >= Range<T>::w_lo)));
  return zero ? q : r;
}

// Row i's elimination: w (its 2Q+1 band entries) becomes its U row in
// w[Q..2Q] and f its Q multipliers, from `up`, the U rows of rows i-Q ..
// i-1 (identity rows before row 0, whose multipliers are the band's zero
// entries); then `up` slides by one row.  QUICK (the ring form): each
// quotient by `quick_div` from `ur`, the pivots' reciprocals, which slide
// with `up` (the new row's formed once here), clearing `ok` as there; else
// (the tile and stream forms) by the division.
template <typename T, int Q, bool QUICK>
__device__ __forceinline__ void eliminate(T (&w)[2 * Q + 1], T (&f)[Q],
                                          T (&up)[Q][Q + 1], T (&ur)[Q],
                                          bool& ok) {
#pragma unroll
  for (int t = 0; t < Q; ++t) {
    f[t] = QUICK ? quick_div(w[t], up[t][0], ur[t], ok) : w[t] / up[t][0];
#pragma unroll
    for (int j = 1; j <= Q; ++j)
      w[t + j] = fma_rn(-f[t], up[t][j], w[t + j]);
  }
#pragma unroll
  for (int t = 0; t + 1 < Q; ++t) {
#pragma unroll
    for (int j = 0; j <= Q; ++j) up[t][j] = up[t + 1][j];
    ur[t] = ur[t + 1];
  }
#pragma unroll
  for (int j = 0; j <= Q; ++j) up[Q - 1][j] = w[Q + j];
  if (QUICK) ur[Q - 1] = recip(w[Q], ok);
}

template <typename T, int Q>
__device__ __forceinline__ void identity_rows(T (&up)[Q][Q + 1],
                                              T (&ur)[Q]) {
#pragma unroll
  for (int t = 0; t < Q; ++t) {
    up[t][0] = T(1);
    ur[t] = T(1);
#pragma unroll
    for (int j = 1; j <= Q; ++j) up[t][j] = T(0);
  }
}

// Tile form: C columns, blockDim.x = C G threads.  Shared memory: the
// mbarriers, then the tile, row i of it (2Q+1 band rows, then R
// right-hand-side rows, C values each) at i (2Q+1+R) C.
template <typename T, int Q>
__global__ void __launch_bounds__(MAX_THREADS)
    multi_tile_kernel(const __grid_constant__ MultiArgs<T> g) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  constexpr int NB = 2 * Q + 1;
  const int n = g.n, R = g.R, C = g.C, W = NB + R, H = g.chunk;
  const long long ncol = g.ncol;
  const long long col0 = (long long)blockIdx.x * C;
  const int ncb = (int)(ncol - col0 < C ? ncol - col0 : C);
  const int tid = threadIdx.x, nth = blockDim.x;
  unsigned long long* bars = reinterpret_cast<unsigned long long*>(smem_raw);
  T* tile = reinterpret_cast<T*>(smem_raw + BAR_BYTES);
  const int nbar = (n + H - 1) / H;
  const bool bulk = g.copy == 16;

  // ---- 1. stage every row of the tile ---------------------------------
  if (tid == 0) {
    for (int j = 0; j < nbar; ++j) bar_init(&bars[j], bulk ? 1 : nth);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    if (bulk)
      for (int j = 0; j < nbar; ++j) {
        const int rows = (j + 1) * H < n ? H : n - j * H;
        bar_arrive_expect(&bars[j], (unsigned)(rows * W * ncb * sizeof(T)));
      }
  }
  __syncthreads();
  // staged row e = i W + s: band row s of row i, or right-hand side s - NB
  auto source = [&](int e) {
    const int i = e / W, s = e - i * W;
    return s < NB ? g.bands + ((long long)i * NB + s) * ncol + col0
                  : g.rhs + ((long long)i * R + (s - NB)) * ncol + col0;
  };
  if (bulk) {
    const unsigned bytes = (unsigned)(ncb * sizeof(T));
    for (int e = tid; e < n * W; e += nth)
      bulk_copy(tile + (long long)e * C, source(e), bytes, &bars[e / W / H]);
  } else {
    const int V = g.copy / (int)sizeof(T);  // values a copy; V divides ncb
    const int pieces = ncb / V;
    for (int j = 0; j < nbar; ++j) {
      const int e0 = j * H * W, e1 = ((j + 1) * H < n ? (j + 1) * H : n) * W;
      for (int idx = tid; idx < (e1 - e0) * pieces; idx += nth) {
        const int e = e0 + idx / pieces, v = (idx % pieces) * V;
        if (g.copy == 8)
          copy_async<8>(tile + (long long)e * C + v, source(e) + v);
        else
          copy_async<4>(tile + (long long)e * C + v, source(e) + v);
      }
      copies_arrive(&bars[j]);
    }
  }
  const int c = tid % C, grp = tid / C, G = nth / C;
  T* col = tile + c;
#define S(i, s) col[((long long)(i) * W + (s)) * C]

  // ---- 2. the elimination of column c, by the first C threads -----------
  // the multipliers over the band's first Q entries, the U row over the
  // rest; a chunk of rows is eliminated as soon as its copies have landed
  if (grp == 0 && c < ncb) {
    T up[Q][Q + 1], ur[Q];
    bool ok = true;  // not read: the division is exact
    identity_rows<T, Q>(up, ur);
    for (int i = 0; i < n; ++i) {
      if (i % H == 0) bar_wait(&bars[i / H], 0);
      T w[NB], f[Q];
#pragma unroll
      for (int d = 0; d < NB; ++d) w[d] = S(i, d);
      eliminate<T, Q, false>(w, f, up, ur, ok);
#pragma unroll
      for (int t = 0; t < Q; ++t) S(i, t) = f[t];
#pragma unroll
      for (int j = 0; j <= Q; ++j) S(i, Q + j) = w[Q + j];
    }
  }
  __syncthreads();  // every copy has landed, every column is eliminated

  // ---- 3. the substitutions: thread (c, grp) takes right-hand sides grp,
  // grp + G, ... of column c, the last Q solutions in registers (zero
  // outside the matrix, where the band's entries are zero too)
  if (c >= ncb) return;
  T* o = g.out + col0 + c;
  for (int r = grp; r < R; r += G) {
    T win[Q];
#pragma unroll
    for (int t = 0; t < Q; ++t) win[t] = T(0);   // y of rows i-Q .. i-1
    for (int i = 0; i < n; ++i) {
      T y = S(i, NB + r);
#pragma unroll
      for (int t = 0; t < Q; ++t) y = fma_rn(-S(i, t), win[t], y);
      S(i, NB + r) = y;
#pragma unroll
      for (int t = 0; t + 1 < Q; ++t) win[t] = win[t + 1];
      win[Q - 1] = y;
    }
#pragma unroll
    for (int d = 0; d < Q; ++d) win[d] = T(0);   // x of rows i+1 .. i+Q
    for (int i = n - 1; i >= 0; --i) {
      T acc = S(i, NB + r);
#pragma unroll
      for (int d = 0; d < Q; ++d) acc = fma_rn(-S(i, Q + 1 + d), win[d], acc);
      const T x = acc / S(i, Q);
      o[((long long)i * R + r) * ncol] = x;
#pragma unroll
      for (int d = Q - 1; d > 0; --d) win[d] = win[d - 1];
      win[0] = x;
    }
  }
#undef S
}

// Stream form.  Shared memory: the U rows of `chunk` rows, row slot h's
// entry j of column c at (h (Q+1) + j) C + c.
template <typename T, int Q>
__global__ void __launch_bounds__(MAX_THREADS)
    multi_stream_kernel(const __grid_constant__ MultiArgs<T> g) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  constexpr int NB = 2 * Q + 1;
  const int n = g.n, R = g.R, C = g.C, H = g.chunk;
  const long long ncol = g.ncol;
  const long long c = (long long)blockIdx.x * C + threadIdx.x;
  if (c >= ncol) return;
  T* us = reinterpret_cast<T*>(smem_raw) + threadIdx.x;
  const T* b = g.bands + c;
  const T* rh = g.rhs + c;
  T* o = g.out + c;
#define U(slot, j) us[((slot) * (Q + 1) + (j)) * C]
#define OUT(i, r) o[((long long)(i) * R + (r)) * ncol]
  T up[Q][Q + 1], ur[Q];
  bool ok = true;  // not read: the division is exact
  identity_rows<T, Q>(up, ur);
  for (int i = 0; i < n; ++i) {
    T w[NB], f[Q];
#pragma unroll
    for (int d = 0; d < NB; ++d) w[d] = b[((long long)i * NB + d) * ncol];
    eliminate<T, Q, false>(w, f, up, ur, ok);
#pragma unroll
    for (int j = 0; j <= Q; ++j) U(i % H, j) = w[Q + j];
    for (int r = 0; r < R; ++r) {
      T y = rh[((long long)i * R + r) * ncol];
#pragma unroll
      for (int t = 0; t < Q; ++t)
        if (i - Q + t >= 0) y = fma_rn(-f[t], OUT(i - Q + t, r), y);
      OUT(i, r) = y;
    }
  }
  const int last = (n - 1) / H;
  for (int ch = last; ch >= 0; --ch) {
    const int lo = ch * H, hi = lo + H < n ? lo + H : n;
    if (ch < last) {  // rebuild the chunk's U rows
      identity_rows<T, Q>(up, ur);
      for (int i = 0; i < hi; ++i) {
        T w[NB], f[Q];
#pragma unroll
        for (int d = 0; d < NB; ++d) w[d] = b[((long long)i * NB + d) * ncol];
        eliminate<T, Q, false>(w, f, up, ur, ok);
        if (i >= lo) {
#pragma unroll
          for (int j = 0; j <= Q; ++j) U(i - lo, j) = w[Q + j];
        }
      }
    }
    for (int i = hi - 1; i >= lo; --i) {
      T u[Q + 1];
#pragma unroll
      for (int j = 0; j <= Q; ++j) u[j] = U(i - lo, j);
      for (int r = 0; r < R; ++r) {
        T acc = OUT(i, r);
#pragma unroll
        for (int d = 0; d < Q; ++d)
          if (i + 1 + d < n) acc = fma_rn(-u[d + 1], OUT(i + 1 + d, r), acc);
        OUT(i, r) = acc / u[0];
      }
    }
  }
#undef U
#undef OUT
}

// a cp.async commit group of this thread's copies, and the wait until at
// most N of its groups are still in flight
__device__ __forceinline__ void commit_group() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wait_groups() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Ring form: one warp, C columns (lane = column; lanes past the last column
// return at once).  Shared memory: the ring (slot s, staged row r at
// (s (2Q+2) + r) C), then the U store (row i's entry j at (i (Q+2) + j) C:
// the U row at j = 0..Q, the forward value at j = Q+1).  A lane copies and
// reads only its own column's values, so it waits on its own copies alone
// (one commit group a row) and no step of the warp waits for another lane.
// `ring_column` solves the lane's column once and writes x: QUICK, its
// quotients by `quick_div`, returning `ok`; else by the division.
template <typename T, int Q, bool QUICK>
__device__ __forceinline__ bool ring_column(const MultiArgs<T>& g, T* ring,
                                            long long col) {
  constexpr int NB = 2 * Q + 1, NS = NB + 1, D = RING_SLOTS;
  const int n = g.n, C = g.C;
  const long long ncol = g.ncol;
  T* ust = ring + D * NS * C;
  const T* b = g.bands + col;
  const T* rh = g.rhs + col;
  // row i's staged rows into slot i % D, one commit group (empty past the
  // last row, so that the group of row i is always the (i + 1)-th).  D - 1
  // rows are in flight: row i + D - 1 refills the slot of row i - 1, read
  // into registers an iteration earlier, so no copy lands in a slot that
  // the same iteration reads.
  auto issue = [&](int i) {
    if (i < n) {
      T* dst = ring + (i % D) * NS * C;
#pragma unroll
      for (int d = 0; d < NB; ++d)
        copy_async<sizeof(T)>(dst + d * C, b + ((long long)i * NB + d) * ncol);
      copy_async<sizeof(T)>(dst + NB * C, rh + (long long)i * ncol);
    }
    commit_group();
  };
#pragma unroll
  for (int i = 0; i + 1 < D; ++i) issue(i);

  // the elimination with the forward values folded in; the last Q U rows,
  // their pivots' reciprocals and forward values in registers (identity
  // rows and zeros before row 0); two rows an iteration, so that a row's
  // first steps (older pivots) overlap the previous row's last
  bool ok = true;
  T up[Q][Q + 1], ur[Q], yp[Q];
  identity_rows<T, Q>(up, ur);
#pragma unroll
  for (int t = 0; t < Q; ++t) yp[t] = T(0);
#pragma unroll 2
  for (int i = 0; i < n; ++i) {
    wait_groups<D - 2>();           // row i's copies have landed
    const T* row = ring + (i % D) * NS * C;
    T w[NB], f[Q];
#pragma unroll
    for (int d = 0; d < NB; ++d) w[d] = row[d * C];
    T y = row[NB * C];
    issue(i + D - 1);               // into the slot of row i - 1
    eliminate<T, Q, QUICK>(w, f, up, ur, ok);
#pragma unroll
    for (int t = 0; t < Q; ++t) y = fma_rn(-f[t], yp[t], y);
#pragma unroll
    for (int t = 0; t + 1 < Q; ++t) yp[t] = yp[t + 1];
    yp[Q - 1] = y;
    T* u = ust + (long long)i * (Q + 2) * C;
#pragma unroll
    for (int j = 0; j <= Q; ++j) u[j * C] = w[Q + j];
    u[(Q + 1) * C] = y;
  }

  // the back substitution (a division a row, as in the other forms); xn[d]
  // = x of row i + 1 + d (zero outside the matrix, where the band's entries
  // are zero too)
  T xn[Q];
#pragma unroll
  for (int d = 0; d < Q; ++d) xn[d] = T(0);
  T* o = g.out + col;
  for (int i = n - 1; i >= 0; --i) {
    const T* u = ust + (long long)i * (Q + 2) * C;
    T acc = u[(Q + 1) * C];
#pragma unroll
    for (int d = 0; d < Q; ++d) acc = fma_rn(-u[(d + 1) * C], xn[d], acc);
    const T x = acc / u[0];
    o[(long long)i * ncol] = x;
#pragma unroll
    for (int d = Q - 1; d > 0; --d) xn[d] = xn[d - 1];
    xn[0] = x;
  }
  return ok;
}

// Every column is solved by `quick_div`; a column whose operands left its
// range (`ok` cleared: never on the Newton systems) is solved again, by
// divisions, over what the first pass wrote.  Its copies have all landed:
// the first pass waited on the group of its last row, and the groups after
// it are empty.
template <typename T, int Q>
__global__ void __launch_bounds__(32)
    solve_ring_kernel(const __grid_constant__ MultiArgs<T> g) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const long long col = (long long)blockIdx.x * g.C + threadIdx.x;
  if (col >= g.ncol || (int)threadIdx.x >= g.C) return;
  T* ring = reinterpret_cast<T*>(smem_raw) + threadIdx.x;
  if (!ring_column<T, Q, true>(g, ring, col))
    ring_column<T, Q, false>(g, ring, col);
}

// out[k] = w[k] / p[k] as the ring form takes it: `quick_div`, or the
// division where that clears `ok`
template <typename T>
__global__ void div_kernel(const T* w, const T* p, T* out, long long count) {
  for (long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       k < count; k += (long long)gridDim.x * blockDim.x) {
    bool ok = true;
    const T q = quick_div(w[k], p[k], recip(p[k], ok), ok);
    out[k] = ok ? q : w[k] / p[k];
  }
}

template <typename T>
int launch_div(const void* w, const void* p, void* out, long long count,
               void* stream) {
  if (count < 0) return -1;
  if (count == 0) return 0;
  const long long blocks = (count + 255) / 256;
  div_kernel<T><<<(unsigned)(blocks < 65536 ? blocks : 65536), 256, 0,
                  (cudaStream_t)stream>>>((const T*)w, (const T*)p, (T*)out,
                                          count);
  return (int)cudaGetLastError();
}

template <typename T, int Q, int FORM>
int launch_form(const MultiArgs<T>& g, int threads, size_t smem,
                cudaStream_t stream) {
  auto kernel = FORM == FORM_TILE     ? multi_tile_kernel<T, Q>
                : FORM == FORM_STREAM ? multi_stream_kernel<T, Q>
                                      : solve_ring_kernel<T, Q>;
  // opt in to more than the default 48 KB once per device
  static bool opted[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (smem > 48 * 1024 && dev < 64 && !opted[dev]) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (e != cudaSuccess) return (int)e;
    opted[dev] = true;
  }
  const unsigned blocks = (unsigned)((g.ncol + g.C - 1) / g.C);
  kernel<<<blocks, threads, smem, stream>>>(g);
  return (int)cudaGetLastError();
}

template <typename T, int Q>
int launch_q(const MultiArgs<T>& g, int form, int threads, size_t smem,
             cudaStream_t stream) {
  return form == FORM_TILE
             ? launch_form<T, Q, FORM_TILE>(g, threads, smem, stream)
         : form == FORM_STREAM
             ? launch_form<T, Q, FORM_STREAM>(g, threads, smem, stream)
             : launch_form<T, Q, FORM_RING>(g, threads, smem, stream);
}

inline bool aligned(const void* q, int bytes) {
  return reinterpret_cast<unsigned long long>(q) % bytes == 0;
}

// Checks the launch shape (ops/cuda_banded.banded_multi_launch_shape) and
// the copy width (cuda_banded.copy_width) and launches; -1 for a shape or
// width the kernel does not take, -2 for more shared memory than a block
// has.
template <typename T>
int launch(const void* bands, const void* rhs, void* out, int n, int R,
           long long ncol, int q, int form, int cols, int threads, int chunk,
           int copy, void* stream_) {
  constexpr int ES = sizeof(T);
  if (q < 1 || q > MAX_Q || R < 1 || n < 0 || ncol < 0 || chunk < 1)
    return -1;
  if (form == FORM_RING) {
    if (R != 1 || threads != 32 || (cols != 8 && cols != 16 && cols != 32) ||
        chunk != RING_SLOTS)
      return -1;
  } else if (form == FORM_TILE || form == FORM_STREAM) {
    if (cols < 32 || cols % 32 || threads % cols || threads < cols ||
        threads > MAX_THREADS)
      return -1;
  } else {
    return -1;
  }
  if (n == 0 || ncol == 0) return 0;
  if ((ncol + cols - 1) / cols > 2147483647LL) return -1;
  MultiArgs<T> g;
  g.bands = (const T*)bands;
  g.rhs = (const T*)rhs;
  g.out = (T*)out;
  g.ncol = ncol; g.n = n; g.R = R; g.C = cols; g.chunk = chunk;
  g.copy = copy;
  size_t smem;
  if (form == FORM_TILE) {
    if (copy == 16 || copy == 8) {
      if ((ncol * ES) % copy || !aligned(bands, copy) || !aligned(rhs, copy))
        return -1;
    } else if (copy != ES) {
      return -1;
    }
  }
  if (form == FORM_TILE) {
    if ((n + chunk - 1) / chunk > MAX_BARS) return -1;
    smem = BAR_BYTES + (size_t)n * (2 * q + 1 + R) * cols * ES;
  } else if (form == FORM_RING) {
    smem = ((size_t)RING_SLOTS * (2 * q + 2) + (size_t)n * (q + 2)) * cols *
           ES;
  } else {
    if (chunk > n || threads != cols) return -1;
    smem = (size_t)chunk * (q + 1) * cols * ES;
  }
  if (smem > (size_t)SMEM_MAX) return -2;
  const cudaStream_t st = (cudaStream_t)stream_;
  switch (q) {
    case 1: return launch_q<T, 1>(g, form, threads, smem, st);
    case 2: return launch_q<T, 2>(g, form, threads, smem, st);
    case 3: return launch_q<T, 3>(g, form, threads, smem, st);
    case 4: return launch_q<T, 4>(g, form, threads, smem, st);
    case 5: return launch_q<T, 5>(g, form, threads, smem, st);
    case 6: return launch_q<T, 6>(g, form, threads, smem, st);
    case 7: return launch_q<T, 7>(g, form, threads, smem, st);
    default: return launch_q<T, 8>(g, form, threads, smem, st);
  }
}

}  // namespace

extern "C" {

// form: 0 tile, 1 stream, 2 ring (R = 1); cols: columns a block (ring: 8,
// 16 or 32); threads: a multiple of cols (tile: cols x the groups of
// right-hand sides; stream: cols; ring: 32); chunk: rows an mbarrier (tile),
// U rows kept on chip (stream) or RING_SLOTS (ring); copy: 16 (bulk
// copies), 8 or 4 bytes (cp.async; the tile form's staging; the ring form
// copies one value at a time).  Returns
// cudaGetLastError(), -1 for a shape or copy width the kernel does not
// take, -2 for more shared memory than a block has.
int banded_solve_multi_f32(const void* bands, const void* rhs, void* out,
                           int n, int R, long long ncol, int q, int form,
                           int cols, int threads, int chunk, int copy,
                           void* stream) {
  return launch<float>(bands, rhs, out, n, R, ncol, q, form, cols, threads,
                       chunk, copy, stream);
}

int banded_solve_multi_f64(const void* bands, const void* rhs, void* out,
                           int n, int R, long long ncol, int q, int form,
                           int cols, int threads, int chunk, int copy,
                           void* stream) {
  return launch<double>(bands, rhs, out, n, R, ncol, q, form, cols, threads,
                        chunk, copy, stream);
}

// out = w / p elementwise, each quotient as the ring form takes it
// (`recip`, `quick_div`, the division where `ok` is cleared): the tests
// hold it bit for bit against the division.  Returns cudaGetLastError(), -1 for a negative count.
int banded_div_f32(const void* w, const void* p, void* out, long long count,
                   void* stream) {
  return launch_div<float>(w, p, out, count, stream);
}

int banded_div_f64(const void* w, const void* p, void* out, long long count,
                   void* stream) {
  return launch_div<double>(w, p, out, count, stream);
}

}  // extern "C"
