// HEVI implicit Newton update of (Rt, W, Rho), one launch per iteration.
//
// Replaces the TPU kernel `fused_implicit_update` (`_kernel`) of
// tempestmodel_tpu/fast/pallas_implicit.py.  That kernel holds a tile of
// columns with every per-level intermediate and all 9 x 91 band rows in
// on-chip memory, folds column sub-tiles into the sublane axis, and unrolls
// the 91-row LU statically.  None of that is carried over.  Here: ONE THREAD
// PER COLUMN, columns on the minor axis of every operand, so each load and
// store of a warp is coalesced.  A thread walks its column bottom to top and
// STREAMS the rows of the interleaved Newton system
//   [Rt_0, W_0, Rho_0, Rt_1, ..., Rho_{nz-1}, W_nz]          (n = 3 nz + 1)
// through a no-pivot banded LU with half-bandwidth Q = 4: a row is assembled
// in registers (aux terms, residual, analytic Jacobian, exact or reference
// mode), eliminated against the last Q U-rows, and its U-row goes to a
// scratch tensor for the back substitution.  The (n, 2Q+1, ncol) band tensor
// never exists.  What a row needs of its neighbours:
//   - level rows (Rt_k, Rho_k) read interface quantities at k and k+1 only;
//     the pair is a two-deep sliding window in registers, each interface is
//     computed once;
//   - the W_i row reads level quantities (Exner pressure, u^xi, kinetic
//     energy) at the levels its derivative stencil touches, two in the
//     interior, recomputed there (one exp and one log each).
// The vertical operators are 2-5-point stencils whose windows are
// compile-time constants and whose coefficients come from a table staged in
// shared memory (fast/implicit_cuda.py LAYOUT); the wrapper's predicate
// sends any configuration whose operators do not fit to the unfused path.
// The forward solution is parked in the output tensors and overwritten by
// the increment during the back substitution.
//
// Bound on an H100 (3.35 TB/s): bytes.  The function must read 5 state
// fields (8 with the time term), 9 metric fields and c2 and write 3: at
// nz = 30, ncol = 86 400, float32 about 182 MB (213 MB), 54 us (64 us); this
// design adds a write and a read of the U-factor scratch (2 x 157 MB, about
// 94 us more).  Arithmetic is a few hundred flops a row.
//
// Plain C interface (no PyTorch header): the launch goes to the given
// stream, nothing synchronises or allocates, and the entry point returns
// cudaGetLastError().

#include <cuda_runtime.h>

namespace {

// Columns (threads) per block; kernels/tune_fused.py sweeps it with a -D
// flag.  At nz = 30, ncol = 86 400 on an H100 the time in float32 is the
// same within 7 % from 32 to 256; in float64 64, 128 and 256 are equal and
// 96, 160 and 192 cost 25-40 % more.
#ifndef IMPLICIT_THREADS
#define IMPLICIT_THREADS 128
#endif
constexpr int THREADS = IMPLICIT_THREADS;

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

template <typename T>
struct ImplicitArgs {
  const T* rt;  // current iterate
  const T* w;
  const T* rho;
  const T* rt0;  // start of the step (read with the time term only)
  const T* w0;
  const T* rho0;
  const T* un;
  const T* vn;
  const T* caxi;  // metric on levels ...
  const T* cbxi;
  const T* cxixi;
  const T* caxii;  // ... and on interfaces
  const T* cbxii;
  const T* cxi;
  const T* jac;
  const T* jaci;
  const T* drdxi;
  const T* c2;  // (4, ncol)
  const T* tab;
  T* drt;  // outputs
  T* dw;
  T* drho;
  T* ufac;  // scratch (n, Q+1, ncol)
  T inv_dt, Cp, kappa, rp0, grav, upw;
  int nz, ref_jacobian, time_term;
  long long ncol;
};

// what the rows need of one interface
template <typename T>
struct Interface {
  T xid;  // u^xi, zero on the bottom and top interfaces
  T rho_i, rt_i, u_i, v_i;
  T jac_i, cxi;
};

template <typename T>
__device__ __forceinline__ Interface<T> interface_at(const ImplicitArgs<T>& g,
                                                     const T* tab, int i,
                                                     long long col) {
  Interface<T> f;
  const T* r = tab + i * NCOLS;
  f.rho_i = f.rt_i = f.u_i = f.v_i = T(0);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const T c = r[I_IN2I + j];
    if (c != T(0)) {
      const long long o = (long long)(i - 2 + j) * g.ncol + col;
      f.rho_i += c * g.rho[o];
      f.rt_i += c * g.rt[o];
      f.u_i += c * g.un[o];
      f.v_i += c * g.vn[o];
    }
  }
  const long long o = (long long)i * g.ncol + col;
  f.jac_i = g.jaci[o];
  f.cxi = g.cxi[o];
  f.xid = (i > 0 && i < g.nz)
              ? g.caxii[o] * f.u_i + g.cbxii[o] * f.v_i + f.cxi * g.w[o]
              : T(0);
  return f;
}

// sign of u^xi as the Jacobian sees it: sign() in reference mode, the
// subgradient choice (+1 at 0) in exact mode
template <typename T>
__device__ __forceinline__ T jac_sign(T x, int ref_jacobian) {
  if (ref_jacobian) return T((x > T(0)) - (x < T(0)));
  return x >= T(0) ? T(1) : T(-1);
}

// Eliminate one assembled row against the last Q U-rows, store its U-row
// and forward value, and slide the window (banded.cu's recurrence).
template <typename T, int Q>
__device__ __forceinline__ void eliminate(T (&row)[2 * Q + 1], T y,
                                          T (&u_prev)[Q][Q + 1],
                                          T (&y_prev)[Q], T* urow, T* yslot,
                                          long long ncol) {
#pragma unroll
  for (int t = 0; t < Q; ++t) {
    const T f = row[t] / u_prev[t][0];
#pragma unroll
    for (int j = 1; j <= Q; ++j) row[t + j] -= f * u_prev[t][j];
    y -= f * y_prev[t];
  }
#pragma unroll
  for (int j = 0; j <= Q; ++j) urow[(long long)j * ncol] = row[Q + j];
  *yslot = y;
#pragma unroll
  for (int t = 0; t + 1 < Q; ++t) {
#pragma unroll
    for (int j = 0; j <= Q; ++j) u_prev[t][j] = u_prev[t + 1][j];
    y_prev[t] = y_prev[t + 1];
  }
#pragma unroll
  for (int j = 0; j <= Q; ++j) u_prev[Q - 1][j] = row[Q + j];
  y_prev[Q - 1] = y;
}

template <typename T, int Q>
__global__ void fused_implicit_kernel(const ImplicitArgs<T> g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* tab = reinterpret_cast<T*>(smem_raw);
  const int nz = g.nz;
  for (int i = threadIdx.x; i < (nz + 1) * NCOLS; i += blockDim.x)
    tab[i] = g.tab[i];
  __syncthreads();
  const long long ncol = g.ncol;
  const long long col = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= ncol) return;
  constexpr int NB = 2 * Q + 1;
  const T inv_dt = g.inv_dt, upw = g.upw;
  const T c2aa = g.c2[col], c2ab = g.c2[ncol + col];
  const T c2ba = g.c2[2 * ncol + col], c2bb = g.c2[3 * ncol + col];

  T u_prev[Q][Q + 1];
  T y_prev[Q];
#pragma unroll
  for (int t = 0; t < Q; ++t) {
    u_prev[t][0] = T(1);
#pragma unroll
    for (int j = 1; j <= Q; ++j) u_prev[t][j] = T(0);
    y_prev[t] = T(0);
  }

  Interface<T> Ic = interface_at(g, tab, 0, col);
  Interface<T> In = Ic;
  for (int k = 0; k <= nz; ++k) {
    const T* r = tab + k * NCOLS;
    const long long ok = (long long)k * ncol + col;
    const bool lev = k < nz;  // a level below this interface's W row?
    T row[NB];
    T diag[3] = {T(0), T(0), T(0)};
    T inv_jac = T(0), wl = T(0), wr = T(0);
    T lrho = T(0), rrho = T(0), sgc = T(0), sgn_ = T(0);
    if (lev) {
      In = interface_at(g, tab, k + 1, col);
      // ---- level quantities shared by the Rt_k and Rho_k rows ----------
      inv_jac = T(1) / g.jac[ok];
      const T d1c = Ic.jac_i * Ic.xid, d1n = In.jac_i * In.xid;
      const T ac = fabs(Ic.xid), an = fabs(In.xid);
      wl = r[I_WL] * ac + r[I_WL + 1] * an;
      wr = r[I_WR] * ac + r[I_WR + 1] * an;
      T lrt = T(0), rrt = T(0);
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const T cl = r[I_PL + j], cr = r[I_PR + j];
        if (cl != T(0) || cr != T(0)) {
          const long long o = (long long)(k - 1 + j) * ncol + col;
          const T a = g.rt[o], b = g.rho[o];
          lrt += cl * a;
          rrt += cr * a;
          lrho += cl * b;
          rrho += cr * b;
        }
      }
      sgc = jac_sign(Ic.xid, g.ref_jacobian) * Ic.cxi;
      sgn_ = jac_sign(In.xid, g.ref_jacobian) * In.cxi;
#pragma unroll
      for (int oi = 0; oi < 3; ++oi)
        diag[oi] = inv_jac * (r[I_TA + 2 * oi] * d1c +
                              r[I_TA + 2 * oi + 1] * d1n) -
                   wl * r[I_PLB + oi] - wr * r[I_PRB + oi];
      diag[1] += inv_dt;

      // ---- row 3k: Rt_k ------------------------------------------------
      T f_rt = (r[I_DI2N] * (Ic.jac_i * Ic.rt_i * Ic.xid) +
                r[I_DI2N + 1] * (In.jac_i * In.rt_i * In.xid)) * inv_jac -
               lrt * wl - rrt * wr;
      if (g.time_term) f_rt += (g.rt[ok] - g.rt0[ok]) * inv_dt;
#pragma unroll
      for (int d = 0; d < NB; ++d) row[d] = T(0);
#pragma unroll
      for (int oi = 0; oi < 3; ++oi) row[Q + 3 * (oi - 1)] += diag[oi];
      // (rt, w) entries at block offsets 0 and 1: interfaces k and k+1,
      // masked to the interior
      const T e_c = (k > 0) ? Ic.jac_i * Ic.rt_i * Ic.cxi : T(0);
      const T e_n = (k + 1 < nz) ? In.jac_i * In.rt_i * In.cxi : T(0);
#pragma unroll
      for (int oo = 0; oo < 2; ++oo)
        row[Q + 3 * oo + 1] +=
            inv_jac * r[I_DI2NB + oo] * (oo ? e_n : e_c) -
            lrt * (r[I_UL + 2 * oo] * sgc + r[I_UL + 2 * oo + 1] * sgn_) -
            rrt * (r[I_UR + 2 * oo] * sgc + r[I_UR + 2 * oo + 1] * sgn_);
      eliminate<T, Q>(row, f_rt, u_prev, y_prev,
                      g.ufac + (long long)(3 * k) * (Q + 1) * ncol + col,
                      g.drt + ok, ncol);
    }

    // ---- row 3k+1 (3 nz for the top): W on interface k ------------------
    {
      const Interface<T>& fi = Ic;
      const T mask = (k > 0 && k < nz) ? T(1) : T(0);
      T dpi_i = T(0), dke_i = T(0), du_i = T(0), dv_i = T(0);
      T tb[3] = {T(0), T(0), T(0)};
      T dpd[4] = {T(0), T(0), T(0), T(0)};  // d(pi)/d(rt) on levels k-2..k+1
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const T cdn = r[I_DN2I + j];
        if (cdn != T(0)) {
          const int m = k - 2 + j;
          const long long om = (long long)m * ncol + col;
          const T* rm = tab + m * NCOLS;
          const T um = g.un[om], vm = g.vn[om], rtm = g.rt[om];
          const T ca = g.caxi[om], cb = g.cbxi[om];
          const T wn = rm[I_II2N] * g.w[om] + rm[I_II2N + 1] * g.w[om + ncol];
          const T pin = g.Cp * exp(g.kappa * log(g.rp0 * rtm));
          dpd[j] = g.kappa * pin / rtm;
          const T xidn = ca * um + cb * vm + g.cxixi[om] * wn;
          const T cua = c2aa * um + c2ab * vm + ca * wn;
          const T cub = c2ba * um + c2bb * vm + cb * wn;
          const T ken = T(0.5) * (cua * um + cub * vm + xidn * wn);
          dpi_i += cdn * pin;
          dke_i += cdn * ken;
          du_i += cdn * um;
          dv_i += cdn * vm;
#pragma unroll
          for (int oi = 0; oi < 3; ++oi) tb[oi] += r[I_TB + 4 * oi + j] * xidn;
        }
      }
      T ddw = T(0);
#pragma unroll
      for (int j = 0; j < 5; ++j) {
        const T c = r[I_DD + j];
        if (c != T(0)) ddw += c * g.w[(long long)(k - 2 + j) * ncol + col];
      }
      ddw *= mask;
      const T wi = g.w[ok];
      const T ca_i = g.caxii[ok], cb_i = g.cbxii[ok];
      const T curl_coef = -(ca_i * du_i + cb_i * dv_i);
      const T cua_i = c2aa * fi.u_i + c2ab * fi.v_i + ca_i * wi;
      const T cub_i = c2ba * fi.u_i + c2bb * fi.v_i + cb_i * wi;
      const T curl = -cua_i * du_i - cub_i * dv_i;
      const T inv_rho_i = T(1) / fi.rho_i;
      const T r1 = fi.rt_i * inv_rho_i;
      const T r2 = dpi_i * inv_rho_i;
      const T r3 = -dpi_i * fi.rt_i * inv_rho_i * inv_rho_i;
      const T ax = fabs(fi.xid);
      T f_w = (dpi_i * fi.rt_i / fi.rho_i + g.grav * g.drdxi[ok] + dke_i +
               curl) * mask;
      f_w = (f_w - upw * ax * ddw) * mask;
      if (g.time_term) f_w += (wi - g.w0[ok]) * inv_dt;
#pragma unroll
      for (int d = 0; d < NB; ++d) row[d] = T(0);
#pragma unroll
      for (int oi = 0; oi < 3; ++oi) {
        const int o = oi - 1;
        // (w, rt), (w, rho)
        row[Q + 3 * o - 1] += mask * (r1 * r[I_DN2IB + oi] * dpd[oi + 1] +
                                      r2 * r[I_IN2IB + oi]);
        row[Q + 3 * o + 1] += mask * r3 * r[I_IN2IB + oi];
        // (w, w)
        T val = tb[oi] - upw * ax * r[I_DDB + oi];
        if (o == 0) {
          val -= upw * jac_sign(fi.xid, g.ref_jacobian) * ddw * fi.cxi * mask;
          if (!g.ref_jacobian) val += curl_coef;
        }
        val *= mask;
        if (o == 1 && k == nz - 1) {
          // the column of W_nz sits one slot to the left of its place in
          // the level pattern
          row[Q + 3 * o - 1] += val;
          val = T(0);
        }
        if (o == 0) val += inv_dt;
        row[Q + 3 * o] += val;
      }
      const int i_row = lev ? 3 * k + 1 : 3 * nz;
      eliminate<T, Q>(row, f_w, u_prev, y_prev,
                      g.ufac + (long long)i_row * (Q + 1) * ncol + col,
                      g.dw + ok, ncol);
    }

    if (lev) {
      // ---- row 3k+2: Rho_k ---------------------------------------------
      T f_rho = (r[I_DI2N] * (Ic.jac_i * Ic.rho_i * Ic.xid) +
                 r[I_DI2N + 1] * (In.jac_i * In.rho_i * In.xid)) * inv_jac -
                lrho * wl - rrho * wr;
      if (g.time_term) f_rho += (g.rho[ok] - g.rho0[ok]) * inv_dt;
#pragma unroll
      for (int d = 0; d < NB; ++d) row[d] = T(0);
#pragma unroll
      for (int oi = 0; oi < 3; ++oi) row[Q + 3 * (oi - 1)] += diag[oi];
      const T e_c = (k > 0) ? Ic.jac_i * Ic.rho_i * Ic.cxi : T(0);
      const T e_n = (k + 1 < nz) ? In.jac_i * In.rho_i * In.cxi : T(0);
#pragma unroll
      for (int oo = 0; oo < 2; ++oo)
        row[Q + 3 * oo - 1] +=
            inv_jac * r[I_DI2NB + oo] * (oo ? e_n : e_c) -
            lrho * (r[I_UL + 2 * oo] * sgc + r[I_UL + 2 * oo + 1] * sgn_) -
            rrho * (r[I_UR + 2 * oo] * sgc + r[I_UR + 2 * oo + 1] * sgn_);
      eliminate<T, Q>(row, f_rho, u_prev, y_prev,
                      g.ufac + (long long)(3 * k + 2) * (Q + 1) * ncol + col,
                      g.drho + ok, ncol);
      Ic = In;
    }
  }

  // ---- back substitution; x_next[d] = x[i + 1 + d] ----------------------
  T x_next[Q];
#pragma unroll
  for (int d = 0; d < Q; ++d) x_next[d] = T(0);
  for (int i = 3 * nz; i >= 0; --i) {
    const int k = i / 3, t = i - 3 * k;
    T* slot = (k == nz || t == 1) ? g.dw : (t == 0 ? g.drt : g.drho);
    slot += (long long)k * ncol + col;
    const T* urow = g.ufac + (long long)i * (Q + 1) * ncol + col;
    T acc = *slot;
#pragma unroll
    for (int d = 0; d < Q; ++d)
      acc -= urow[(long long)(d + 1) * ncol] * x_next[d];
    const T xi = acc / urow[0];
    *slot = xi;
#pragma unroll
    for (int d = Q - 1; d > 0; --d) x_next[d] = x_next[d - 1];
    x_next[0] = xi;
  }
}

// ptrs: rt w rho | rt0 w0 rho0 | u_n v_n | con_a_xi con_b_xi con_xi_xi
// con_a_xi_int con_b_xi_int con_xi_xi_int jac jac_int deriv_r_int | c2 | tab
// | d_rt d_w d_rho | ufac.  scal: 1/dt Cp Rd/(Cp-Rd) Rd/P0 g 0.5/nz.
// ints: nz ref_jacobian time_term q.
// Returns cudaGetLastError(), -1 for a half-bandwidth other than 4 (the
// block offsets -1, 0, 1 of the assembly fill exactly that band), -2 if the
// table exceeds the default shared-memory limit.
template <typename T>
int launch_implicit(const void* const* ptrs, const double* scal,
                    const int* ints, long long ncol, void* stream) {
  ImplicitArgs<T> g;
  const T* const* in = reinterpret_cast<const T* const*>(ptrs);
  g.rt = in[0];
  g.w = in[1];
  g.rho = in[2];
  g.rt0 = in[3];
  g.w0 = in[4];
  g.rho0 = in[5];
  g.un = in[6];
  g.vn = in[7];
  g.caxi = in[8];
  g.cbxi = in[9];
  g.cxixi = in[10];
  g.caxii = in[11];
  g.cbxii = in[12];
  g.cxi = in[13];
  g.jac = in[14];
  g.jaci = in[15];
  g.drdxi = in[16];
  g.c2 = in[17];
  g.tab = in[18];
  g.drt = (T*)ptrs[19];
  g.dw = (T*)ptrs[20];
  g.drho = (T*)ptrs[21];
  g.ufac = (T*)ptrs[22];
  g.inv_dt = (T)scal[0];
  g.Cp = (T)scal[1];
  g.kappa = (T)scal[2];
  g.rp0 = (T)scal[3];
  g.grav = (T)scal[4];
  g.upw = (T)scal[5];
  g.nz = ints[0];
  g.ref_jacobian = ints[1];
  g.time_term = ints[2];
  g.ncol = ncol;
  if (ints[3] != 4 || g.nz < 2) return -1;
  const size_t smem = sizeof(T) * (size_t)(g.nz + 1) * NCOLS;
  if (smem > 48 * 1024) return -2;
  if (ncol > 0) {
    const unsigned blocks = (unsigned)((ncol + THREADS - 1) / THREADS);
    fused_implicit_kernel<T, 4><<<blocks, THREADS, smem,
                                  (cudaStream_t)stream>>>(g);
  }
  return (int)cudaGetLastError();
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
