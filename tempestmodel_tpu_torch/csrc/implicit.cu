// HEVI implicit Newton update of (Rt, W, Rho), one launch per iteration.
//
// Replaces the TPU kernel `fused_implicit_update` (`_kernel`, called at
// tempestmodel_tpu/fast/pallas_implicit.py:597).  That kernel holds a tile of
// columns with every per-level intermediate and all 9 x 91 band rows in
// on-chip memory, folds column sub-tiles into the sublane axis, and unrolls
// the 91-row LU statically.  The idea that carries over is the first one:
// the band rows of a tile live on chip and never reach device memory.
//
// Per column the kernel solves the interleaved Newton system
//   [Rt_0, W_0, Rho_0, Rt_1, ..., Rho_{nz-1}, W_nz]          (n = 3 nz + 1)
// with a no-pivot banded LU of half-bandwidth Q = 4 (the row order and the
// recurrence of models/vertical_banded.banded_solve_t), after assembling
// its rows (aux terms, residual, analytic Jacobian, exact or reference mode,
// with or without the time term).
//
// Bound on an H100 (3.35 TB/s): bytes.  The function must read 5 state
// fields (8 with the time term), 9 metric fields and c2 and write 3: at
// nz = 30, ncol = 86 400, float32 about 180 MB (211 MB), 54 us (63 us).
// Arithmetic is a few hundred flops a row, one exp and one log a level.
// This kernel moves just those bytes: nothing but the three increments
// goes to device memory (no band tensor, no U-factor scratch), and the
// stencil table (70 values a level) is read through the read-only cache.
//
// The design.  A block owns a tile of C columns and all their levels:
//   1. stage: every input row of the tile is copied into shared memory by
//      cp.async, V values a copy (16 bytes where the column count, C and
//      every pointer allow it, else 8 or one value: a template parameter
//      chosen per launch and checked here); the level fields go where step
//      3 will write the W rows, the interface fields where step 4 will
//      write the level rows;
//   2. levels (every thread; a thread keeps one column and walks every
//      (threads / C)-th level): the Exner pressure and its derivative,
//      u^xi, the kinetic energy, 1 / jac and the time terms, once a level;
//   3. interfaces (every thread): the interpolants and u^xi of each
//      interface once, and the whole W row of the system (9 band entries
//      and the residual) from the level values of step 2;
//   4. level rows (every thread): the Rt and Rho rows from the interface
//      values of step 3, each stored as its five structural nonzeros and
//      its residual;
//   5. the banded LU, one thread per column, on the rows in shared memory:
//      a level's three rows a step with the next level's rows prefetched
//      into registers, one reciprocal a pivot (kept in the pivot's place),
//      the first (structurally zero) step of the level rows skipped, the U
//      rows over the assembled rows; the back substitution reads them there
//      and writes the increments.
// Stencils read clamped indices (the table's coefficients vanish outside
// the column), so the assembly has no data-dependent branch.  Several
// blocks share an SM, so the serial LU of one overlaps the parallel steps
// of another; the launch shape (C, threads) comes from
// fast/implicit_cuda.py (implicit_launch_shape), as does the copy width
// (copy_width).  On an NVIDIA H100 80GB HBM3 at 700 W the float32 launch
// at the flagship's shapes (C = 16) takes 0.234 ms, 23 % of its bound: a
// block's life is about a third LU (one warp, 16 of its lanes) and the
// rest staging and assembly, and the SMs issue about 40 % of their
// instruction slots, so it is bound by latency at the three tiles an SM's
// shared memory holds (PERF.md section 6, kernels/implicit_phases.py).
//
// The vertical operators are 2-5-point stencils whose windows are
// compile-time constants and whose coefficients come from the table
// (fast/implicit_cuda.py LAYOUT); the wrapper's predicate sends any
// configuration whose operators do not fit to the unfused path.
//
// The asynchronous copy goes through copy_async<BYTES>, commit_stage and
// wait_stages<N>, as in stage.cu, and the pivots' reciprocal through
// recip; a host rehearsal of this source defines IMPLICIT_EMULATED and
// gives them as a plain copy, two no-ops and a division.
//
// Plain C interface (no PyTorch header): the launch goes to the given
// stream, nothing synchronises or allocates, and the entry point returns
// cudaGetLastError().

#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int Q = 4;            // half-bandwidth
constexpr int NB = 2 * Q + 1;   // band entries of a row
constexpr int RS = NB + 1;      // values of a stored W row: band, residual
// values of a stored level row: its five structural nonzeros (Rt_k: band
// entries 1, 4, 5, 7, 8; Rho_k: 1, 3, 4, 6, 7), then the residual; after
// the elimination its U row (reciprocal pivot, Q entries) and forward value
constexpr int RL = 6;
constexpr int SMEM_MAX = 232448;  // dynamic shared memory of an H100 block
// threads a block; three blocks of MAX_THREADS fit an SM's registers (in
// float64 the LU's register windows and prefetched rows take up to 168)
constexpr int MAX_THREADS = 128;
constexpr int MIN_RESIDENT = 3;

// columns of the stencil table, one row per level / interface
// (fast/implicit_cuda.py LAYOUT).  "o" is the block offset of a Jacobian
// entry, -1, 0, +1 in this order wherever three slots follow one another.
constexpr int I_IN2I = 0;    // 4: levels i-2 .. i+1        -> interface i
constexpr int I_DN2I = 4;    // 4
constexpr int I_TB = 8;      // 3 x 4: TB_o, levels i-2 .. i+1
constexpr int I_DD = 20;     // 5: interfaces i-2 .. i+2    -> interface i
constexpr int I_II2N = 25;   // 2: interfaces k, k+1        -> level k
constexpr int I_DI2N = 27;   // 2
constexpr int I_TA = 29;     // 3 x 2: TA_o, interfaces k, k+1
constexpr int I_WL = 35;     // 2: edges on interfaces k, k+1
constexpr int I_WR = 37;     // 2
constexpr int I_UL = 39;     // 2 x 2: Ul_o for o = 0, 1
constexpr int I_UR = 43;     // 2 x 2
constexpr int I_PL = 47;     // 3: levels k-1, k, k+1       -> level k
constexpr int I_PR = 50;     // 3
constexpr int I_DDB = 53;    // 3: band of DD at o
constexpr int I_DN2IB = 56;  // 3: band of Dn2i at o
constexpr int I_IN2IB = 59;  // 3: band of In2i at o
constexpr int I_DI2NB = 62;  // 2: band of Di2n at o = 0, 1
constexpr int I_PLB = 64;    // 3
constexpr int I_PRB = 67;    // 3
constexpr int NCOLS = 70;

// Staged inputs, in the order of the ptrs array: level fields (nz rows),
// interface fields (nz + 1 rows), c2 (4 rows).  rt0, rho0, w0 are staged
// with the time term only.
enum {
  S_RT, S_RHO, S_RT0, S_RHO0, S_U, S_V, S_CAXI, S_CBXI, S_CXIXI, S_JAC,
  S_W, S_W0, S_CAXII, S_CBXII, S_CXI, S_JACI, S_DRDXI,
  S_C2, NSTAGE
};
constexpr int N_INTERFACE_FIELDS = S_C2 - S_W;

// level values of step 2, (nz, C, NL): a level's values of a column lie
// together (NL is odd, so the lanes of a warp hit distinct banks)
enum { L_RT, L_RHO, L_U, L_V, L_PI, L_DPD, L_KE, L_XID, L_IJAC, L_TRT,
       L_TRHO, NL };
// interface values of step 3, (nz + 1, C, NF)
enum { F_XID, F_JAC, F_RT, F_RHO, F_CXI, NF };

// First row of staged field f, as (row, C) slabs: the level fields (read
// in step 2 only) where step 3 writes the W rows, the interface fields and
// c2 (read in steps 2 and 3) where step 4 writes the level rows.
__host__ __device__ __forceinline__ int stage_row(int f, int nz) {
  return f < S_W ? f * nz
                 : (f < S_C2 ? f - S_W : N_INTERFACE_FIELDS) * (nz + 1);
}

// A column's band rows lie together, row after row, so that the LU reads
// each entry at a fixed offset from one pointer, two values a load (every
// row starts at an even value).  The stride between two columns is twice
// an odd number, so the pairs of the lanes of a warp hit distinct banks.
// W rows: the nz + 1 of a column (room for the staged level fields too);
// level rows: its 2 nz (Rt_k at 2k, Rho_k at 2k + 1), or the staged
// interface fields' share where that is more (few levels).
__host__ __device__ __forceinline__ int pair_stride(int n) {
  return ((n + 1) / 2) | 1;  // pairs, odd
}
__host__ __device__ __forceinline__ int w_stride(int nz) {
  return 2 * pair_stride((nz + 1) * RS);
}
__host__ __device__ __forceinline__ int l_stride(int nz) {
  const int rows = 2 * nz * RL, staged = stage_row(S_C2, nz) + 4;
  return 2 * pair_stride(rows > staged ? rows : staged);
}

// Shared memory of a block of C columns, in values: W rows, level rows,
// level and interface values.  fast/implicit_cuda.py implicit_smem_bytes
// repeats it.
__host__ __device__ __forceinline__ long long smem_values(int nz, int C) {
  return (long long)C * (w_stride(nz) + l_stride(nz) + NL * nz +
                         NF * (nz + 1));
}

template <typename T>
struct ImplicitArgs {
  const T* in[NSTAGE];  // staged inputs (time-term fields null without it)
  const T* tab;         // read through the read-only cache
  T* drt;  // outputs
  T* dw;
  T* drho;
  T inv_dt, Cp, kappa, rp0, grav, upw;
  int nz, ref_jacobian, time_term, C;
  long long ncol;
};

#ifndef IMPLICIT_EMULATED
// BYTES (4, 8 or 16) from device memory into shared memory, asynchronously
template <int BYTES>
__device__ __forceinline__ void copy_async(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d),
                 "l"(src), "n"(BYTES));
}
// close the copies issued since the last call into one group
__device__ __forceinline__ void commit_stage() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// wait until at most N of this thread's groups are still in flight
template <int N>
__device__ __forceinline__ void wait_stages() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
// the reciprocal of a pivot: the hardware's approximation in float32 (one
// instruction, within 1 ulp; it sits on the elimination's critical path),
// correctly rounded in float64
__device__ __forceinline__ float recip(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ double recip(double x) { return __drcp_rn(x); }
#endif

// a row of the stencil table, read through the read-only cache (every
// block reads the same small table)
template <typename T>
struct TabRow {
  const T* p;
  __device__ __forceinline__ T operator[](int i) const { return __ldg(p + i); }
};

// m clamped to [0, hi]
__device__ __forceinline__ int clamp_index(int m, int hi) {
  return m < 0 ? 0 : (m > hi ? hi : m);
}

// sign of u^xi as the Jacobian sees it: sign() in reference mode, the
// subgradient choice (+1 at 0) in exact mode
template <typename T>
__device__ __forceinline__ T jac_sign(T x, int ref_jacobian) {
  if (ref_jacobian) return T((x > T(0)) - (x < T(0)));
  return x >= T(0) ? T(1) : T(-1);
}

// two values in one shared-memory access (8 bytes in float32, 16 in
// float64); p is a pair boundary
template <typename T> struct Pair;
template <> struct Pair<float> { using type = float2; };
template <> struct Pair<double> { using type = double2; };

template <typename T, int N>
__device__ __forceinline__ void load_pairs(T* v, const T* p) {
  using P = typename Pair<T>::type;
#pragma unroll
  for (int d = 0; d < N; d += 2) {
    const P q = *reinterpret_cast<const P*>(p + d);
    v[d] = q.x;
    v[d + 1] = q.y;
  }
}

template <typename T, int N>
__device__ __forceinline__ void store_pairs(T* p, const T* v) {
  using P = typename Pair<T>::type;
#pragma unroll
  for (int d = 0; d < N; d += 2) {
    P q;
    q.x = v[d];
    q.y = v[d + 1];
    *reinterpret_cast<P*>(p + d) = q;
  }
}

// A stored level row as band entries (zeros where it has none), then the
// residual.
template <typename T, bool RHO>
__device__ __forceinline__ void expand_level_row(T (&row)[RS],
                                                 const T (&a)[RL]) {
#pragma unroll
  for (int d = 0; d < NB; ++d) row[d] = T(0);
  row[1] = a[0];
  row[RHO ? 3 : 4] = a[1];
  row[RHO ? 4 : 5] = a[2];
  row[RHO ? 6 : 7] = a[3];
  row[RHO ? 7 : 8] = a[4];
  row[NB] = a[5];
}

// Eliminate an assembled row (band entries, residual) against the last Q U
// rows (banded_solve_t's recurrence, one multiply by the stored reciprocal
// a step), leave its U row in entries Q .. 2Q (the reciprocal of the pivot
// in the pivot's place) and its forward value in the residual's, and
// slide the window.  FIRST: the first step whose band entry is not zero by
// structure (1 for the level rows).
template <typename T, int FIRST>
__device__ __forceinline__ void eliminate(T (&row)[RS], T (&up)[Q][Q + 1],
                                          T (&yp)[Q]) {
#pragma unroll
  for (int t = FIRST; t < Q; ++t) {
    const T f = row[t] * up[t][0];
#pragma unroll
    for (int j = 1; j <= Q; ++j) row[t + j] -= f * up[t][j];
    row[NB] -= f * yp[t];
  }
  row[Q] = recip(row[Q]);
#pragma unroll
  for (int t = 0; t + 1 < Q; ++t) {
#pragma unroll
    for (int j = 0; j <= Q; ++j) up[t][j] = up[t + 1][j];
    yp[t] = yp[t + 1];
  }
#pragma unroll
  for (int j = 0; j <= Q; ++j) up[Q - 1][j] = row[Q + j];
  yp[Q - 1] = row[NB];
}

// x of one row; xn[d] = x[r + 1 + d] slides.  The newest unknown enters
// last, so one multiply-add and the pivot wait for it.
template <typename T>
__device__ __forceinline__ T solve_row(const T (&u)[RL], T (&xn)[Q]) {
  T acc = u[Q + 1];
#pragma unroll
  for (int d = Q - 1; d >= 0; --d) acc -= u[d + 1] * xn[d];
  const T x = acc * u[0];
#pragma unroll
  for (int d = Q - 1; d > 0; --d) xn[d] = xn[d - 1];
  xn[0] = x;
  return x;
}

template <typename T, int V>
__global__ void __launch_bounds__(MAX_THREADS, MIN_RESIDENT)
    fused_implicit_kernel(const ImplicitArgs<T> g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nz = g.nz, C = g.C, nth = blockDim.x, tid = threadIdx.x;
  const long long ncol = g.ncol;
  const long long col0 = (long long)blockIdx.x * C;
  const int ncb = (int)(ncol - col0 < C ? ncol - col0 : C);
  const int nzC = nz * C;
  // In steps 2-4 a thread keeps one column (C divides the thread count)
  // and walks every (nth / C)-th level or interface.
  const int c = tid % C, k0 = tid / C, dk = nth / C;
  const int WS = w_stride(nz), LS = l_stride(nz);
  T* wrow = reinterpret_cast<T*>(smem_raw);   // C x WS: W rows
  T* lrow = wrow + C * WS;                    // C x LS: level rows
  T* lev = lrow + C * LS;                     // (nz, C, NL)
  T* itf = lev + NL * nzC;                    // (nz + 1, C, NF)
  const T* tab = g.tab;                       // (nz + 1, NCOLS)

  // ---- 1. stage the tile's inputs -----------------------------------------
  {
    const int cv = C / V, nv = ncb / V;  // V divides C and ncol
    for (int f = 0; f < NSTAGE; ++f) {
      const T* src = g.in[f];
      if (src == nullptr) continue;
      const int rows = f < S_W ? nz : (f < S_C2 ? nz + 1 : 4);
      T* dst = (f < S_W ? wrow : lrow) + stage_row(f, nz) * C;
      for (int idx = tid; idx < rows * cv; idx += nth) {
        const int j = idx / cv, ch = idx - j * cv;
        if (ch < nv)
          copy_async<V * sizeof(T)>(dst + j * C + ch * V,
                                    src + j * ncol + col0 + ch * V);
      }
    }
    commit_stage();
    wait_stages<0>();
  }
  __syncthreads();

  const T inv_dt = g.inv_dt, upw = g.upw;
#define STG(f, row) \
  ((f) < S_W ? wrow : lrow)[(stage_row(f, nz) + (row)) * C + c]
#define LEV(f, m) lev[((m) * C + c) * NL + (f)]
#define ITF(f, i) itf[((i) * C + c) * NF + (f)]

  // ---- 2. level values ------------------------------------------------------
  for (int k = k0; k < nz; k += dk) {
    const TabRow<T> r{tab + k * NCOLS};
    const T rt = STG(S_RT, k), rho = STG(S_RHO, k);
    const T u = STG(S_U, k), v = STG(S_V, k);
    const T ca = STG(S_CAXI, k), cb = STG(S_CBXI, k);
    const T wn = r[I_II2N] * STG(S_W, k) + r[I_II2N + 1] * STG(S_W, k + 1);
    const T pin = g.Cp * exp(g.kappa * log(g.rp0 * rt));
    const T xidn = ca * u + cb * v + STG(S_CXIXI, k) * wn;
    const T cua = STG(S_C2, 0) * u + STG(S_C2, 1) * v + ca * wn;
    const T cub = STG(S_C2, 2) * u + STG(S_C2, 3) * v + cb * wn;
    T o[NL];
    o[L_RT] = rt;
    o[L_RHO] = rho;
    o[L_U] = u;
    o[L_V] = v;
    o[L_PI] = pin;
    o[L_DPD] = g.kappa * pin / rt;
    o[L_KE] = T(0.5) * (cua * u + cub * v + xidn * wn);
    o[L_XID] = xidn;
    o[L_IJAC] = T(1) / STG(S_JAC, k);
    o[L_TRT] = g.time_term ? (rt - STG(S_RT0, k)) * inv_dt : T(0);
    o[L_TRHO] = g.time_term ? (rho - STG(S_RHO0, k)) * inv_dt : T(0);
#pragma unroll
    for (int f = 0; f < NL; ++f) LEV(f, k) = o[f];
  }
  __syncthreads();

  // ---- 3. interface values and the W rows ---------------------------------
  for (int i = k0; i <= nz; i += dk) {
    const TabRow<T> r{tab + i * NCOLS};
    T rho_i = T(0), rt_i = T(0), u_i = T(0), v_i = T(0);
    T dpi_i = T(0), dke_i = T(0), du_i = T(0), dv_i = T(0);
    T tb[3] = {T(0), T(0), T(0)};
    // The table's coefficients vanish outside the column, so a stencil
    // reads a clamped level and needs no branch.
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = clamp_index(i - 2 + j, nz - 1);
      const T cin = r[I_IN2I + j], cdn = r[I_DN2I + j];
      const T um = LEV(L_U, m), vm = LEV(L_V, m);
      rho_i += cin * LEV(L_RHO, m);
      rt_i += cin * LEV(L_RT, m);
      u_i += cin * um;
      v_i += cin * vm;
      dpi_i += cdn * LEV(L_PI, m);
      dke_i += cdn * LEV(L_KE, m);
      du_i += cdn * um;
      dv_i += cdn * vm;
      const T xm = LEV(L_XID, m);
#pragma unroll
      for (int oi = 0; oi < 3; ++oi) tb[oi] += r[I_TB + 4 * oi + j] * xm;
    }
    const T wi = STG(S_W, i);
    const T ca_i = STG(S_CAXII, i), cb_i = STG(S_CBXII, i);
    const T cxi = STG(S_CXI, i), jac_i = STG(S_JACI, i);
    const bool inner = i > 0 && i < nz;
    const T xid = inner ? ca_i * u_i + cb_i * v_i + cxi * wi : T(0);
    ITF(F_XID, i) = xid;
    ITF(F_JAC, i) = jac_i;
    ITF(F_RT, i) = rt_i;
    ITF(F_RHO, i) = rho_i;
    ITF(F_CXI, i) = cxi;

    // row 3i+1 (3 nz for the top): W on interface i
    const T mask = inner ? T(1) : T(0);
    T ddw = T(0);
#pragma unroll
    for (int j = 0; j < 5; ++j)
      ddw += r[I_DD + j] * STG(S_W, clamp_index(i - 2 + j, nz));
    ddw *= mask;
    const T c2aa = STG(S_C2, 0), c2ab = STG(S_C2, 1);
    const T c2ba = STG(S_C2, 2), c2bb = STG(S_C2, 3);
    const T curl_coef = -(ca_i * du_i + cb_i * dv_i);
    const T cua_i = c2aa * u_i + c2ab * v_i + ca_i * wi;
    const T cub_i = c2ba * u_i + c2bb * v_i + cb_i * wi;
    const T curl = -cua_i * du_i - cub_i * dv_i;
    const T inv_rho_i = T(1) / rho_i;
    const T r1 = rt_i * inv_rho_i;
    const T r2 = dpi_i * inv_rho_i;
    const T r3 = -dpi_i * rt_i * inv_rho_i * inv_rho_i;
    const T ax = fabs(xid);
    T f_w = (dpi_i * r1 + g.grav * STG(S_DRDXI, i) + dke_i + curl) * mask;
    f_w = (f_w - upw * ax * ddw) * mask;
    if (g.time_term) f_w += (wi - STG(S_W0, i)) * inv_dt;
    T row[RS];
#pragma unroll
    for (int d = 0; d < NB; ++d) row[d] = T(0);
#pragma unroll
    for (int oi = 0; oi < 3; ++oi) {
      const int o = oi - 1, m = i + o;
      const T dpd = (m >= 0 && m < nz) ? LEV(L_DPD, m) : T(0);
      // (w, rt), (w, rho)
      row[Q + 3 * o - 1] +=
          mask * (r1 * r[I_DN2IB + oi] * dpd + r2 * r[I_IN2IB + oi]);
      row[Q + 3 * o + 1] += mask * r3 * r[I_IN2IB + oi];
      // (w, w)
      T val = tb[oi] - upw * ax * r[I_DDB + oi];
      if (o == 0) {
        val -= upw * jac_sign(xid, g.ref_jacobian) * ddw * cxi * mask;
        if (!g.ref_jacobian) val += curl_coef;
      }
      val *= mask;
      if (o == 1 && i == nz - 1) {
        // the column of W_nz sits one slot to the left of its place in
        // the level pattern
        row[Q + 3 * o - 1] += val;
        val = T(0);
      }
      if (o == 0) val += inv_dt;
      row[Q + 3 * o] += val;
    }
    row[NB] = f_w;
    store_pairs<T, RS>(wrow + c * WS + i * RS, row);
  }
  __syncthreads();

  // ---- 4. the Rt and Rho rows (over the staged inputs) --------------------
  for (int k = k0; k < nz; k += dk) {
    const TabRow<T> r{tab + k * NCOLS};
    const T xc = ITF(F_XID, k), xn = ITF(F_XID, k + 1);
    const T jc = ITF(F_JAC, k), jn = ITF(F_JAC, k + 1);
    const T cxc = ITF(F_CXI, k), cxn = ITF(F_CXI, k + 1);
    const T inv_jac = LEV(L_IJAC, k);
    const T d1c = jc * xc, d1n = jn * xn;
    const T ac = fabs(xc), an = fabs(xn);
    const T wl = r[I_WL] * ac + r[I_WL + 1] * an;
    const T wr = r[I_WR] * ac + r[I_WR + 1] * an;
    T lrt = T(0), rrt = T(0), lrho = T(0), rrho = T(0);
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const int m = clamp_index(k - 1 + j, nz - 1);
      const T cl = r[I_PL + j], cr = r[I_PR + j];
      const T a = LEV(L_RT, m), b = LEV(L_RHO, m);
      lrt += cl * a;
      rrt += cr * a;
      lrho += cl * b;
      rrho += cr * b;
    }
    const T sgc = jac_sign(xc, g.ref_jacobian) * cxc;
    const T sgn_ = jac_sign(xn, g.ref_jacobian) * cxn;
    T diag[3];
#pragma unroll
    for (int oi = 0; oi < 3; ++oi)
      diag[oi] = inv_jac * (r[I_TA + 2 * oi] * d1c +
                            r[I_TA + 2 * oi + 1] * d1n) -
                 wl * r[I_PLB + oi] - wr * r[I_PRB + oi];
    diag[1] += inv_dt;
    // penalty couplings of a level row to W at block offsets 0 and 1
    T ul[2], ur[2];
#pragma unroll
    for (int oo = 0; oo < 2; ++oo) {
      ul[oo] = r[I_UL + 2 * oo] * sgc + r[I_UL + 2 * oo + 1] * sgn_;
      ur[oo] = r[I_UR + 2 * oo] * sgc + r[I_UR + 2 * oo + 1] * sgn_;
    }
#pragma unroll
    for (int t = 0; t < 2; ++t) {  // row 3k (Rt_k), then 3k + 2 (Rho_k)
      const T x_c = t ? ITF(F_RHO, k) : ITF(F_RT, k);
      const T x_n = t ? ITF(F_RHO, k + 1) : ITF(F_RT, k + 1);
      const T lx = t ? lrho : lrt, rx = t ? rrho : rrt;
      T f = (r[I_DI2N] * (jc * x_c * xc) + r[I_DI2N + 1] * (jn * x_n * xn)) *
                inv_jac -
            lx * wl - rx * wr;
      f += t ? LEV(L_TRHO, k) : LEV(L_TRT, k);
      // the (x, w) entries at block offsets 0 and 1: interfaces k and k+1,
      // masked to the interior
      const T e_c = (k > 0) ? jc * x_c * cxc : T(0);
      const T e_n = (k + 1 < nz) ? jn * x_n * cxn : T(0);
      T wx[2];
#pragma unroll
      for (int oo = 0; oo < 2; ++oo)
        wx[oo] = inv_jac * r[I_DI2NB + oo] * (oo ? e_n : e_c) - lx * ul[oo] -
                 rx * ur[oo];
      // the five nonzeros in band order: x at offsets -1, 0, 1 (band
      // entries 1, 4, 7) and W one slot right of x (Rt) or left (Rho)
      T out[RL];
      out[0] = diag[0];
      out[1] = t ? wx[0] : diag[1];
      out[2] = t ? diag[1] : wx[0];
      out[3] = t ? wx[1] : diag[2];
      out[4] = t ? diag[2] : wx[1];
      out[5] = f;
      store_pairs<T, RL>(lrow + c * LS + (2 * k + t) * RL, out);
    }
  }
  __syncthreads();
#undef STG
#undef LEV
#undef ITF

  // ---- 5. banded LU, one thread per column --------------------------------
  // A level's three rows (Rt_k, W_k, Rho_k) a step, the next level's rows
  // loaded into registers before this level's U rows are stored; W_nz
  // last.  pl, pw: the column's rows Rt_k and W_k.
  if (tid < C) {
    T up[Q][Q + 1], yp[Q];
#pragma unroll
    for (int t = 0; t < Q; ++t) {
      up[t][0] = T(1);
#pragma unroll
      for (int j = 1; j <= Q; ++j) up[t][j] = T(0);
      yp[t] = T(0);
    }
    T* pl = lrow + c * LS;
    T* pw = wrow + c * WS;
    T rt[RL], w[RS], rho[RL];
    load_pairs<T, RL>(rt, pl);
    load_pairs<T, RS>(w, pw);
    load_pairs<T, RL>(rho, pl + RL);
#pragma unroll 2
    for (int k = 0; k < nz; ++k) {
      // the next level's rows; past the last level, W_nz (and this level's
      // rows again, unused)
      T* ql = k + 1 < nz ? pl + 2 * RL : pl;
      T* qw = pw + RS;
      T nrt[RL], nw[RS], nrho[RL];
      load_pairs<T, RL>(nrt, ql);
      load_pairs<T, RS>(nw, qw);
      load_pairs<T, RL>(nrho, ql + RL);
      T row[RS];
      expand_level_row<T, false>(row, rt);
      eliminate<T, 1>(row, up, yp);
      store_pairs<T, RL>(pl, row + Q);
      eliminate<T, 0>(w, up, yp);
      store_pairs<T, RL>(pw + Q, w + Q);
      expand_level_row<T, true>(row, rho);
      eliminate<T, 1>(row, up, yp);
      store_pairs<T, RL>(pl + RL, row + Q);
#pragma unroll
      for (int d = 0; d < RL; ++d) {
        rt[d] = nrt[d];
        rho[d] = nrho[d];
      }
#pragma unroll
      for (int d = 0; d < RS; ++d) w[d] = nw[d];
      pl = ql;
      pw = qw;
    }
    eliminate<T, 0>(w, up, yp);  // W_nz
    store_pairs<T, RL>(pw + Q, w + Q);

    // back substitution; xn[d] = x[r + 1 + d].  A row reads its U row
    // (reciprocal pivot, Q entries) and forward value; the increments go
    // straight to device memory (the lanes of a tile write adjacent
    // columns).
    const bool out = c < ncb;
    const long long o = col0 + c;
    T xn[Q];
#pragma unroll
    for (int d = 0; d < Q; ++d) xn[d] = T(0);
    {
      T u[RL];
      load_pairs<T, RL>(u, pw + Q);
      const T x = solve_row(u, xn);
      if (out) g.dw[nz * ncol + o] = x;
    }
    pl = lrow + c * LS + 2 * (nz - 1) * RL;
    pw -= RS;
    T brt[RL], bw[RL], brho[RL];
    load_pairs<T, RL>(brt, pl);
    load_pairs<T, RL>(bw, pw + Q);
    load_pairs<T, RL>(brho, pl + RL);
#pragma unroll 2
    for (int k = nz - 1; k >= 0; --k) {
      T* ql = k > 0 ? pl - 2 * RL : pl;
      T* qw = k > 0 ? pw - RS : pw;
      T nrt[RL], nw[RL], nrho[RL];
      load_pairs<T, RL>(nrt, ql);
      load_pairs<T, RL>(nw, qw + Q);
      load_pairs<T, RL>(nrho, ql + RL);
      const T x_rho = solve_row(brho, xn);
      const T x_w = solve_row(bw, xn);
      const T x_rt = solve_row(brt, xn);
      if (out) {
        g.drho[k * ncol + o] = x_rho;
        g.dw[k * ncol + o] = x_w;
        g.drt[k * ncol + o] = x_rt;
      }
#pragma unroll
      for (int d = 0; d < RL; ++d) {
        brt[d] = nrt[d];
        bw[d] = nw[d];
        brho[d] = nrho[d];
      }
      pl = ql;
      pw = qw;
    }
  }
}

template <typename T, int V>
int launch_one(const ImplicitArgs<T>& g, unsigned blocks, int threads,
               size_t smem, cudaStream_t st) {
  // opt in to more than the default 48 KB once per device
  static bool opted[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (smem > 48 * 1024 && dev < 64 && !opted[dev]) {
    const cudaError_t e = cudaFuncSetAttribute(
        fused_implicit_kernel<T, V>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (e != cudaSuccess) return (int)e;
    opted[dev] = true;
  }
  fused_implicit_kernel<T, V><<<blocks, threads, smem, st>>>(g);
  return (int)cudaGetLastError();
}

// ptrs: rt w rho | rt0 w0 rho0 | u_n v_n | con_a_xi con_b_xi con_xi_xi
// con_a_xi_int con_b_xi_int con_xi_xi_int jac jac_int deriv_r_int | c2 | tab
// | d_rt d_w d_rho.  scal: 1/dt Cp Rd/(Cp-Rd) Rd/P0 g 0.5/nz.
// ints: nz ref_jacobian time_term q | C threads V (the launch shape:
// fast/implicit_cuda.py implicit_launch_shape and copy_width).
// Returns cudaGetLastError(), -1 for shapes or launch shapes the kernel does
// not take (a half-bandwidth other than 4: the block offsets -1, 0, 1 of the
// assembly fill exactly that band; a copy width that does not divide C and
// ncol, or a staged pointer not aligned to it), -2 if the tile exceeds the
// 227 KB a block may have.
template <typename T>
int launch_implicit(const void* const* ptrs, const double* scal,
                    const int* ints, long long ncol, void* stream) {
  ImplicitArgs<T> g;
  const T* const* in = reinterpret_cast<const T* const*>(ptrs);
  const int time_term = ints[2];
  g.in[S_RT] = in[0];
  g.in[S_W] = in[1];
  g.in[S_RHO] = in[2];
  g.in[S_RT0] = time_term ? in[3] : nullptr;
  g.in[S_W0] = time_term ? in[4] : nullptr;
  g.in[S_RHO0] = time_term ? in[5] : nullptr;
  g.in[S_U] = in[6];
  g.in[S_V] = in[7];
  g.in[S_CAXI] = in[8];
  g.in[S_CBXI] = in[9];
  g.in[S_CXIXI] = in[10];
  g.in[S_CAXII] = in[11];
  g.in[S_CBXII] = in[12];
  g.in[S_CXI] = in[13];
  g.in[S_JAC] = in[14];
  g.in[S_JACI] = in[15];
  g.in[S_DRDXI] = in[16];
  g.in[S_C2] = in[17];
  g.tab = in[18];
  g.drt = (T*)ptrs[19];
  g.dw = (T*)ptrs[20];
  g.drho = (T*)ptrs[21];
  g.inv_dt = (T)scal[0];
  g.Cp = (T)scal[1];
  g.kappa = (T)scal[2];
  g.rp0 = (T)scal[3];
  g.grav = (T)scal[4];
  g.upw = (T)scal[5];
  g.nz = ints[0];
  g.ref_jacobian = ints[1];
  g.time_term = time_term;
  g.C = ints[4];
  g.ncol = ncol;
  const int threads = ints[5], V = ints[6];
  if (ints[3] != Q || g.nz < 2 || g.C < 1 || threads < 32 ||
      threads > MAX_THREADS || threads % 32 != 0 || threads % g.C != 0 ||
      ncol < 0)
    return -1;
  if (!(V == 1 || V == 2 || V == 4) || V * (int)sizeof(T) > 16 ||
      g.C % V != 0 || ncol % V != 0)
    return -1;
  for (int f = 0; f < NSTAGE; ++f)
    if (g.in[f] != nullptr &&
        (uintptr_t)g.in[f] % (uintptr_t)(V * sizeof(T)) != 0)
      return -1;
  const long long smem = sizeof(T) * smem_values(g.nz, g.C);
  if (smem > SMEM_MAX) return -2;
  if (ncol == 0) return (int)cudaGetLastError();
  const unsigned blocks = (unsigned)((ncol + g.C - 1) / g.C);
  cudaStream_t st = (cudaStream_t)stream;
  if constexpr (sizeof(T) == 4) {
    if (V == 4) return launch_one<T, 4>(g, blocks, threads, (size_t)smem, st);
  }
  if (V == 2) return launch_one<T, 2>(g, blocks, threads, (size_t)smem, st);
  return launch_one<T, 1>(g, blocks, threads, (size_t)smem, st);
}

}  // namespace

extern "C" {

int fused_implicit_f32(const void* const* ptrs, const double* scal,
                       const int* ints, long long ncol, void* stream) {
  return launch_implicit<float>(ptrs, scal, ints, ncol, stream);
}

int fused_implicit_f64(const void* const* ptrs, const double* scal,
                       const int* ints, long long ncol, void* stream) {
  return launch_implicit<double>(ptrs, scal, ints, ncol, stream);
}

}  // extern "C"
