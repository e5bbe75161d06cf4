// One explicit RK stage of the nonhydrostatic dynamics in one launch.
//
// Replaces the TPU kernel `fused_stage` (`_kernel`) of
// tempestmodel_tpu/fast/stage_pallas.py.  That kernel works on a (panel,
// 8-row A-chunk) tile with all levels resident in on-chip memory, takes the
// b-derivatives as a matrix-unit product against a full (B, B)
// block-diagonal matrix and shifts whole level slabs for the vertical
// operators.  None of that is carried over.  Here:
//   - a block owns a tile of whole elements (TA x TB nodes, b fastest, a
//     warp on one row of the tile so loads and stores are coalesced) and a
//     chunk of STAGE_LEVELS levels; a thread owns one node and walks the
//     chunk's levels;
//   - the vertical 2-4-point operators (w_n, du/dxi, dv/dxi, the interface
//     velocity u^xi and the penalty upwinding weights) are short stencils
//     along the thread's own column, with coefficients from a small table
//     staged in shared memory (the windows are compile-time constants, the
//     coefficients are data: see fast/stage_cuda.py LAYOUT);
//   - six of the horizontal derivatives are of COMPUTED fields (kinetic
//     energy, Exner pressure, w_n and the four mass/heat fluxes), so each
//     level has two passes with a __syncthreads() between them: every
//     thread writes its pointwise values into nine shared-memory tiles, then
//     takes the element-local p-point derivative sums along a and b from
//     the tiles (the derivative and stiffness matrices, divided by the
//     element width, sit in shared memory too);
//   - the two-term RK base combination and the axpy happen at the store; a
//     single base never reads a second one (its pointers are null);
//   - tracers (the flat species-major field `(ntr * nz, P, A, B)`) are
//     advected in the same launch on the same mass fluxes jac * u^a, jac * u^b
//     that carry Rho: a thread keeps the two fluxes of its node in registers
//     and writes flux * tracer of up to STAGE_SPECIES species into two more
//     shared-memory tiles each in the level's first pass, so those species
//     cost no barrier of their own; further species go in groups of that
//     size through the same tiles, two barriers a group.  The tracer row is
//     s * nz + k while every metric term is indexed by the level k alone.
//     A group's tracer values are loaded together at the top of the level
//     and its base values at the top of the second pass, so their latency
//     hides behind the level's other work.  The kernel without tracers is an
//     instantiation of its own (TR = false) with none of this in it.
// Both metric forms are here: the separable Gal-Chen form (12 two-dimensional
// fields held in registers plus two level profiles) and the full
// three-dimensional metric tensors (the Cartesian grids' decay coordinate
// has no separable form, so their terrain takes this one).
// A Cartesian grid has an instantiation of its own (CART): the element
// matrices along b are a table of their own (the element widths along a and
// b differ), and on an x-z slice (`xz` = 1 or 2, the TPU kernel's `xz_zero`
// "U" or "V") the velocity slot that holds the physical V gets the vertical
// penalty increment only; the test is uniform over the launch.  The
// cubed-sphere instantiation reads the matrices along a for both axes and
// has no x-z test, as before the Cartesian grids came.  A Schar slice ((40, 1, 4, 400) swapped, (40, 1, 400, 4)
// not) is one or a few tiles wide: 13 or 100 tiles of 4 x 32 or 4 x 4 nodes,
// times 7 level chunks.
//
// Bound on an H100 (3.35 TB/s): bytes.  The function must read 5 evaluation
// fields and 4 (or 8) base fields and write 5 fields: 14 or 18 fields of
// (30, 6, 120, 120) float32, 145 or 187 MB with the 2-D metric, 43 or 56 us.
// Each species adds a read of the tracer and of its base (or two) and a write:
// 3 or 4 fields of that shape, 31 or 41 MB, 9 or 12 us.
// Arithmetic is about 400 flops a node and level (1 GFLOP, ~15 us at the
// float32 rate), one exp and one log among them.  The re-reads of U, V, W at
// neighbouring levels hit L1/L2.
//
// Plain C interface (no PyTorch header): the launch goes to the given
// stream, nothing synchronises or allocates, and the entry point returns
// cudaGetLastError().

#include <cuda_runtime.h>

#include <algorithm>

namespace {

// columns of the stencil table, one row per level / interface
// (fast/stage_cuda.py LAYOUT)
constexpr int C_II2N = 0;   // 2: interfaces k, k+1        -> level k
constexpr int C_DN2N = 2;   // 3: levels k-1, k, k+1        -> level k
constexpr int C_IN2I = 5;   // 4: levels i-2 .. i+1         -> interface i
constexpr int C_WL = 9;     // 2: |u^xi| at interfaces k, k+1 -> level k
constexpr int C_WR = 11;    // 2
constexpr int C_PL = 13;    // 3: levels k-1, k, k+1        -> level k
constexpr int C_PR = 16;    // 3
constexpr int C_SLEV = 19;  // separable metric profile on levels
constexpr int C_SINT = 20;  // ... and on interfaces
constexpr int NCOLS = 21;

// Levels walked by one block and the tile's target extents along a and b
// (whole elements: the launch rounds them to multiples of p);
// kernels/tune_fused.py sweeps them with -D flags.  (6, 4, 32) was the
// fastest of ten at (30, 6, 120, 120), p = 4, on an H100, within 3 % in
// float32 and the fastest in float64; 8 rows along a cost 15 % more.
#ifndef STAGE_LEVELS
#define STAGE_LEVELS 6
#endif
#ifndef STAGE_TILE_A
#define STAGE_TILE_A 4
#endif
#ifndef STAGE_TILE_B
#define STAGE_TILE_B 32
#endif
// what `xz` names: the slot of the physical V of an x-z slice
constexpr int XZ_U = 1, XZ_V = 2;
// Species whose flux tiles are filled in the level's first pass (and the
// size of the later groups); each costs two tiles of shared memory and a
// register.  With three species at (90, 6, 120, 120) float32 on an H100, 3
// was 6 % faster than 1 and 12 % faster than 2, which needs a second group
// for the third species (kernels/tune_fused.py).
#ifndef STAGE_SPECIES
#define STAGE_SPECIES 3
#endif
static_assert(STAGE_SPECIES >= 1, "a group of species has at least one");
constexpr int NTILES = 9;        // shared-memory tiles of computed fields

template <typename T>
struct StageArgs {
  const T* u;  // evaluation state
  const T* v;
  const T* rt;
  const T* rho;
  const T* w;
  const T* b1[4];  // base 1: U, V, Rt, Rho
  const T* b2[4];  // base 2, null for a single base
  const T* m2d;    // (12 | 5, P, A, B)
  // full 3-D metric, null in the separable form
  const T* caxi;
  const T* cbxi;
  const T* cxixi;
  const T* jac;
  const T* dra;
  const T* drb;
  const T* caxii;
  const T* cbxii;
  const T* cxixii;
  const T* tab;  // stencil table, then D/delta and S/delta along a and b
  //              // (the sphere's instantiation reads the first two only)
  T* out[5];     // U, V, Rt, Rho, ucz_x
  // tracers (ntr * nz, P, A, B), null without: evaluation state, base 1,
  // base 2 (null for a single base), result
  const T* tr;
  const T* btr1;
  const T* btr2;
  T* otr;
  T dt_s, cb1, cb2, Cp, kappa, rp0, grav;
  // cart (a Cartesian grid) only chooses the instantiation at launch; as a
  // host local instead it left this struct one int shorter and the tracer
  // instantiation 11 % slower on an H100 (the same code otherwise)
  int nz, P, A, B, p, use_sep, has_pen, xz, cart, TA, TB;
  int ntr, G;    // species, and species per group of flux tiles
};

// u^xi on interface i of the column at offset `col` inside a level slab;
// zero on the bottom and top interfaces.
template <typename T>
__device__ __forceinline__ T xi_dot_int(const StageArgs<T>& g, const T* tab,
                                        int i, long long col, long long level,
                                        T Ca, T Cb, T E, T F) {
  if (i <= 0 || i >= g.nz) return T(0);
  const T* r = tab + i * NCOLS;
  T ui = T(0), vi = T(0);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const T c = r[C_IN2I + j];
    if (c != T(0)) {
      const long long o = (long long)(i - 2 + j) * level + col;
      ui += c * g.u[o];
      vi += c * g.v[o];
    }
  }
  const long long o = (long long)i * level + col;
  const T wi = g.w[o];
  if (g.use_sep) {
    const T si = r[C_SINT];
    return si * (Ca * ui + Cb * vi) + (E + si * si * F) * wi;
  }
  return g.caxii[o] * ui + g.cbxii[o] * vi + g.cxixii[o] * wi;
}

// Grid: (tiles of one panel, panel, chunks of STAGE_LEVELS levels); block:
// TA * TB threads; dynamic shared memory: the table (with 2 element matrices,
// 4 for CART), then NTILES tiles, then 2 * G tracer flux tiles.
template <typename T, bool TR, bool CART>
__global__ void fused_stage_kernel(const StageArgs<T> g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* tab = reinterpret_cast<T*>(smem_raw);
  const int nz = g.nz, p = g.p, A = g.A, B = g.B, TA = g.TA, TB = g.TB;
  const int ntab = (nz + 1) * NCOLS + (CART ? 4 : 2) * p * p;
  const int nthreads = TA * TB;
  const int tid = threadIdx.x;
  for (int i = tid; i < ntab; i += nthreads) tab[i] = g.tab[i];
  const T* Dd = tab + (nz + 1) * NCOLS;  // Dd[s * p + i] = D[s, i] / delta_a
  const T* Sd = Dd + p * p;              // Sd[i * p + s] = S[i, s] / delta_a
  // ... over the element width along b
  const T* Ddb = CART ? Sd + p * p : Dd;
  const T* Sdb = CART ? Sd + 2 * p * p : Sd;
  T* tile = tab + ntab;
  T* sv = tile;
  T* su = tile + nthreads;
  T* swn = tile + 2 * nthreads;
  T* ske = tile + 3 * nthreads;
  T* sex = tile + 4 * nthreads;
  T* sfar = tile + 5 * nthreads;  // jac * u^a * rho
  T* sfbr = tile + 6 * nthreads;  // jac * u^b * rho
  T* sfat = tile + 7 * nthreads;  // jac * u^a * rt
  T* sfbt = tile + 8 * nthreads;  // jac * u^b * rt
  T* sftr = tile + NTILES * nthreads;  // per species of a group: a, b flux
  const int ntr = g.ntr, G = g.G;

  const int ty = tid / TB;
  const int tx = tid - ty * TB;
  const int tiles_b = (B + TB - 1) / TB;
  const int tile_a = blockIdx.x / tiles_b;
  const int tile_b = blockIdx.x - tile_a * tiles_b;
  const int a = tile_a * TA + ty;
  const int b = tile_b * TB + tx;
  // tiles hold whole elements, so an inactive thread's slots are never read
  const bool active = (a < A) && (b < B);
  const int pn = blockIdx.y;
  const long long slab = (long long)A * B;
  const long long level = (long long)g.P * slab;
  const long long col = active ? pn * slab + (long long)a * B + b : 0;
  // position inside the element, and the element's first row / column
  const int ia = ty % p, ea0 = ty - ia;
  const int ib = tx % p, eb0 = tx - ib;

  // the 2-D metric of this node
  const T c2aa = g.m2d[col], c2ab = g.m2d[level + col];
  const T c2ba = g.m2d[2 * level + col], c2bb = g.m2d[3 * level + col];
  const T fj = g.m2d[4 * level + col];
  T Ca = T(0), Cb = T(0), E = T(0), F = T(0), dZa = T(0), dZb = T(0);
  T jacl = T(0);
  if (g.use_sep) {
    Ca = g.m2d[5 * level + col];
    Cb = g.m2d[6 * level + col];
    E = g.m2d[7 * level + col];
    F = g.m2d[8 * level + col];
    dZa = g.m2d[9 * level + col];
    dZb = g.m2d[10 * level + col];
    jacl = g.m2d[11 * level + col];
  }
  const bool two_base = g.b2[0] != nullptr;
  __syncthreads();

  const int k0 = blockIdx.z * STAGE_LEVELS;
  const int k1 = min(nz, k0 + STAGE_LEVELS);
  for (int k = k0; k < k1; ++k) {
    const long long o = (long long)k * level + col;
    T u = T(0), v = T(0), rt = T(1), rho = T(1);
    T du_dxi = T(0), dv_dxi = T(0), pen_u = T(0), pen_v = T(0);
    T con_ua = T(0), con_ub = T(0), con_ux = T(0), jac = T(1);
    T dra = T(0), drb = T(0), base_a = T(0), base_b = T(0);
    // The species s0 .. s0 + G - 1 (G <= STAGE_SPECIES), in four steps: the
    // tracer values into registers; flux * tracer into the tracer tiles;
    // the base values into registers; the weak flux divergence, the base
    // combination and the axpy.
    T tv[TR ? STAGE_SPECIES : 1];
    auto load_tracers = [&](int s0) {
#pragma unroll
      for (int j = 0; j < STAGE_SPECIES; ++j)
        if (j < G && s0 + j < ntr)
          tv[j] = g.tr[((long long)(s0 + j) * nz + k) * level + col];
    };
    auto fill_tracers = [&](int s0) {
#pragma unroll
      for (int j = 0; j < STAGE_SPECIES; ++j)
        if (j < G && s0 + j < ntr) {
          sftr[(2 * j) * nthreads + tid] = base_a * tv[j];
          sftr[(2 * j + 1) * nthreads + tid] = base_b * tv[j];
        }
    };
    auto load_bases = [&](int s0) {
#pragma unroll
      for (int j = 0; j < STAGE_SPECIES; ++j)
        if (j < G && s0 + j < ntr) {
          const long long ot = ((long long)(s0 + j) * nz + k) * level + col;
          tv[j] = two_base ? g.cb1 * g.btr1[ot] + g.cb2 * g.btr2[ot]
                           : g.btr1[ot];
        }
    };
    auto store_tracers = [&](int s0) {
#pragma unroll
      for (int j = 0; j < STAGE_SPECIES; ++j)
        if (j < G && s0 + j < ntr) {
          const T* fa = sftr + (2 * j) * nthreads;
          const T* fb = fa + nthreads;
          T wk = T(0);
          for (int e = 0; e < p; ++e)
            wk += Sd[ia * p + e] * fa[(ea0 + e) * TB + tx] +
                  Sdb[ib * p + e] * fb[ty * TB + eb0 + e];
          const long long ot = ((long long)(s0 + j) * nz + k) * level + col;
          g.otr[ot] = tv[j] + g.dt_s * (wk / jac);
        }
    };
    if (active) {
      const T* r = tab + k * NCOLS;
      if constexpr (TR) load_tracers(0);
      u = g.u[o];
      v = g.v[o];
      rt = g.rt[o];
      rho = g.rho[o];
      const T w_n = r[C_II2N] * g.w[o] + r[C_II2N + 1] * g.w[o + level];
      T plu = T(0), pru = T(0), plv = T(0), prv = T(0);
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const T cd = r[C_DN2N + j], cl = r[C_PL + j], cr = r[C_PR + j];
        if (cd != T(0) || cl != T(0) || cr != T(0)) {
          const long long om = (long long)(k - 1 + j) * level + col;
          const T um = g.u[om], vm = g.v[om];
          du_dxi += cd * um;
          dv_dxi += cd * vm;
          plu += cl * um;
          plv += cl * vm;
          pru += cr * um;
          prv += cr * vm;
        }
      }
      if (g.has_pen) {
        const T x0 = fabs(xi_dot_int(g, tab, k, col, level, Ca, Cb, E, F));
        const T x1 = fabs(xi_dot_int(g, tab, k + 1, col, level, Ca, Cb, E, F));
        const T wl = r[C_WL] * x0 + r[C_WL + 1] * x1;
        const T wr = r[C_WR] * x0 + r[C_WR + 1] * x1;
        pen_u = plu * wl + pru * wr;
        pen_v = plv * wl + prv * wr;
      }
      T caxi, cbxi, cxixi;
      if (g.use_sep) {
        const T s = r[C_SLEV];
        caxi = s * Ca;
        cbxi = s * Cb;
        cxixi = E + (s * s) * F;
        dra = s * dZa;
        drb = s * dZb;
        jac = jacl;
      } else {
        caxi = g.caxi[o];
        cbxi = g.cbxi[o];
        cxixi = g.cxixi[o];
        dra = g.dra[o];
        drb = g.drb[o];
        jac = g.jac[o];
      }
      con_ua = c2aa * u + c2ab * v + caxi * w_n;
      con_ub = c2ba * u + c2bb * v + cbxi * w_n;
      con_ux = caxi * u + cbxi * v + cxixi * w_n;
      base_a = jac * con_ua;
      base_b = jac * con_ub;
      sv[tid] = v;
      su[tid] = u;
      swn[tid] = w_n;
      ske[tid] = T(0.5) * (con_ua * u + con_ub * v + con_ux * w_n);
      sex[tid] = g.Cp * exp(g.kappa * log(g.rp0 * rt));
      sfar[tid] = base_a * rho;
      sfbr[tid] = base_b * rho;
      sfat[tid] = base_a * rt;
      sfbt[tid] = base_b * rt;
      if constexpr (TR) fill_tracers(0);
    }
    __syncthreads();
    if (active) {
      if constexpr (TR) load_bases(0);
      T dv_da = T(0), dwn_da = T(0), dke_a = T(0), dpi_a = T(0);
      T du_db = T(0), dwn_db = T(0), dke_b = T(0), dpi_b = T(0);
      T wk_rho = T(0), wk_rt = T(0);
      for (int s = 0; s < p; ++s) {
        const int na = (ea0 + s) * TB + tx;  // node s of the element along a
        const int nb = ty * TB + eb0 + s;    // ... along b
        const T da = Dd[s * p + ia], db = Ddb[s * p + ib];
        const T sa = Sd[ia * p + s], sb = Sdb[ib * p + s];
        dv_da += da * sv[na];
        dwn_da += da * swn[na];
        dke_a += da * ske[na];
        dpi_a += da * sex[na];
        du_db += db * su[nb];
        dwn_db += db * swn[nb];
        dke_b += db * ske[nb];
        dpi_b += db * sex[nb];
        wk_rho += sa * sfar[na] + sb * sfbr[nb];
        wk_rt += sa * sfat[na] + sb * sfbt[nb];
      }
      const T jzeta_a = dwn_db - dv_dxi;
      const T jzeta_b = du_dxi - dwn_da;
      const T jzeta_x = dv_da - du_db;
      const T ucz_a = con_ub * jzeta_x - con_ux * jzeta_b;
      const T ucz_b = con_ux * jzeta_a - con_ua * jzeta_x;
      const T ucz_x = -con_ua * dwn_da - con_ub * dwn_db;
      const T theta = rt / rho;
      const T dU = (CART && g.xz == XZ_U) ? pen_u
                                : (ucz_a + fj * con_ub -
                                   (dpi_a * theta + dke_a + g.grav * dra)) +
                                      pen_u;
      const T dV = (CART && g.xz == XZ_V) ? pen_v
                                : (ucz_b - fj * con_ua -
                                   (dpi_b * theta + dke_b + g.grav * drb)) +
                                      pen_v;
      // weak divergence = -(a part + b part); tendency = -divergence / jac
      const T tend[4] = {dU, dV, wk_rt / jac, wk_rho / jac};
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        const T base = two_base ? g.cb1 * g.b1[f][o] + g.cb2 * g.b2[f][o]
                                : g.b1[f][o];
        g.out[f][o] = base + g.dt_s * tend[f];
      }
      g.out[4][o] = ucz_x;
      if constexpr (TR) store_tracers(0);
    }
    if constexpr (TR) {
      for (int s0 = G; s0 < ntr; s0 += G) {  // G >= 1 wherever ntr >= 1
        if (active) load_tracers(s0);
        __syncthreads();
        if (active) {
          fill_tracers(s0);
          load_bases(s0);
        }
        __syncthreads();
        if (active) store_tracers(s0);
      }
    }
    __syncthreads();
  }
}

// ptrs: u v rt rho w | base1 U V Rt Rho | base2 U V Rt Rho (null: single) |
// m2d | caxi cbxi cxixi jac dra drb caxii cbxii cxixii (null: separable) |
// tab | out U V Rt Rho ucz_x | tracers: eval, base1, base2 (null: single),
// out (all null without tracers).  scal: dt_s cb1 cb2 Cp Rd/(Cp-Rd) Rd/P0 g.
// ints: nz P A B p use_sep has_pen ntr xz cart (cart: a Cartesian grid, the
// CART instantiation; xz is read only there).
// Returns cudaGetLastError(), -1 for shapes the kernel does not take, -2 if
// the table and tiles exceed the default shared-memory limit.
template <typename T>
int launch_stage(const void* const* ptrs, const double* scal, const int* ints,
                 void* stream) {
  StageArgs<T> g;
  g.u = (const T*)ptrs[0];
  g.v = (const T*)ptrs[1];
  g.rt = (const T*)ptrs[2];
  g.rho = (const T*)ptrs[3];
  g.w = (const T*)ptrs[4];
  for (int f = 0; f < 4; ++f) {
    g.b1[f] = (const T*)ptrs[5 + f];
    g.b2[f] = (const T*)ptrs[9 + f];
  }
  g.m2d = (const T*)ptrs[13];
  g.caxi = (const T*)ptrs[14];
  g.cbxi = (const T*)ptrs[15];
  g.cxixi = (const T*)ptrs[16];
  g.jac = (const T*)ptrs[17];
  g.dra = (const T*)ptrs[18];
  g.drb = (const T*)ptrs[19];
  g.caxii = (const T*)ptrs[20];
  g.cbxii = (const T*)ptrs[21];
  g.cxixii = (const T*)ptrs[22];
  g.tab = (const T*)ptrs[23];
  for (int f = 0; f < 5; ++f) g.out[f] = (T*)ptrs[24 + f];
  g.tr = (const T*)ptrs[29];
  g.btr1 = (const T*)ptrs[30];
  g.btr2 = (const T*)ptrs[31];
  g.otr = (T*)ptrs[32];
  g.dt_s = (T)scal[0];
  g.cb1 = (T)scal[1];
  g.cb2 = (T)scal[2];
  g.Cp = (T)scal[3];
  g.kappa = (T)scal[4];
  g.rp0 = (T)scal[5];
  g.grav = (T)scal[6];
  g.nz = ints[0];
  g.P = ints[1];
  g.A = ints[2];
  g.B = ints[3];
  g.p = ints[4];
  g.use_sep = ints[5];
  g.has_pen = ints[6];
  g.ntr = ints[7];
  g.xz = ints[8];
  g.cart = ints[9];
  const int p = g.p;
  if (g.nz < 1 || g.P < 1 || p < 1 || p > 8 || g.A < p || g.B < p ||
      g.A % p != 0 || g.B % p != 0 || g.ntr < 0 || g.xz < 0 || g.xz > 2 ||
      (g.xz != 0 && !g.cart) ||
      (g.ntr > 0 && (!g.tr || !g.btr1 || !g.otr)) ||
      ((g.btr2 != nullptr) != (g.ntr > 0 && g.b2[0] != nullptr)))
    return -1;
  // whole elements per tile: about STAGE_TILE_B nodes along b (one warp a
  // row at 32) and STAGE_TILE_A along a
  g.TB = std::min(g.B, std::max(1, STAGE_TILE_B / p) * p);
  g.TA = std::min(g.A, std::max(1, STAGE_TILE_A / p) * p);
  const int nthreads = g.TA * g.TB;
  // as many species per group as asked for and as the default limit holds
  const auto smem_for = [&](int G) {
    return sizeof(T) * ((size_t)(g.nz + 1) * NCOLS +
                        (size_t)(g.cart ? 4 : 2) * p * p +
                        (size_t)(NTILES + 2 * G) * nthreads);
  };
  g.G = std::min(g.ntr, STAGE_SPECIES);
  while (g.G > 1 && smem_for(g.G) > 48 * 1024) --g.G;
  const size_t smem = smem_for(g.G);
  if (smem > 48 * 1024) return -2;
  const unsigned tiles = (unsigned)(((g.A + g.TA - 1) / g.TA) *
                                    ((g.B + g.TB - 1) / g.TB));
  const dim3 grid(tiles, (unsigned)g.P,
                  (unsigned)((g.nz + STAGE_LEVELS - 1) / STAGE_LEVELS));
  const cudaStream_t st = (cudaStream_t)stream;
  if (g.cart) {
    if (g.ntr > 0)
      fused_stage_kernel<T, true, true><<<grid, nthreads, smem, st>>>(g);
    else
      fused_stage_kernel<T, false, true><<<grid, nthreads, smem, st>>>(g);
  } else {
    if (g.ntr > 0)
      fused_stage_kernel<T, true, false><<<grid, nthreads, smem, st>>>(g);
    else
      fused_stage_kernel<T, false, false><<<grid, nthreads, smem, st>>>(g);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int fused_stage_f32(const void* const* ptrs, const double* scal,
                    const int* ints, void* stream) {
  return launch_stage<float>(ptrs, scal, ints, stream);
}

int fused_stage_f64(const void* const* ptrs, const double* scal,
                    const int* ints, void* stream) {
  return launch_stage<double>(ptrs, scal, ints, stream);
}

}  // extern "C"
