// One explicit RK stage of the nonhydrostatic dynamics in one launch.
//
// Replaces the TPU kernel `fused_stage` (`_kernel`, called at
// tempestmodel_tpu/fast/stage_pallas.py:440).  That kernel works on a
// (panel, 8-row A-chunk) tile with all levels resident in on-chip memory,
// takes the b-derivatives as a matrix-unit product against a full (B, B)
// block-diagonal matrix and shifts whole level slabs for the vertical
// operators.  None of that is carried over.
//
// Bound on an H100 (3.35 TB/s): bytes.  The function must read 5 evaluation
// fields and 4 (or 8) base fields and write 5 fields: 14 or 18 fields of
// (30, 6, 120, 120) float32, 145 or 187 MB with the 2-D metric, 43 or 56 us
// (45 / 57 us with the table and W's extra interface, as chip_smoke.py
// counts it).  Each species adds a read of the tracer and of its base (or
// two) and a write: 3 or 4 fields of that shape, 31 or 41 MB, 9 or 12 us.
// Arithmetic is about 400 flops a node and level (1 GFLOP, ~15 us at the
// float32 rate), one exp and one log among them.
//
// What the design does about it.  The first version of this kernel walked
// the levels of a thread strictly in series, two barriers a level,
// re-reading U, V and W up to 26 times per node and level; on an NVIDIA H100
// 80GB HBM3 at 700 W it took 0.1443 ms with one base (~1.0 TB/s).  This one:
//   - a block owns a tile of whole elements (TA x TB nodes, b fastest) and a
//     run of levels; a thread owns one node and walks the run upwards.  The
//     launch shape comes from fast/stage_cuda.py (stage_launch_shape: about
//     128 threads, a warp on one row, the ring as deep as residency allows,
//     the levels cut into as few chunks as fill the card);
//   - a register window along the thread's column: U and V at levels
//     k-1 .. k+2 and W at interfaces k, k+1 live in registers and each level
//     brings only the new row; the upwinding speed |u^xi| of interface k+1
//     carries over as interface k of the next level, so a level computes one
//     interface velocity, not two; the 2-D metric is read once per run;
//   - an asynchronous ring of level slabs in shared memory: every field read
//     once per node and level (U, V two levels ahead, W and the interface
//     metric one ahead, Rt, Rho, the bases, the full 3-D metric and each
//     species with its bases at the level itself) is copied by cp.async, R
//     ring stages deep (R >= 3), so the copies of levels k+1 .. k+R-2 are in
//     flight while level k is computed.  A copy is 16 bytes wide where B,
//     the tile row and every pointer allow it, else 8 or 4 (a size variant
//     chosen at launch: every shape runs the kernel);
//   - one barrier a level: the nine tiles of computed fields (kinetic
//     energy, Exner pressure, w_n and the four mass/heat fluxes, whose
//     element-local p-point derivatives need the neighbours' values) and the
//     tracer flux tiles are double-buffered, so a thread writes level k+1's
//     pointwise values while others still read level k's; the same barrier
//     publishes the next ring stage.  Species beyond the first group (the
//     launch's G) take one barrier a group;
//   - few instructions a level: once the copies hid the latency, the kernel
//     was bound by instruction issue (~630 a node and level by the SASS of
//     the first ring version, a quarter of them the ring's bookkeeping).  At
//     p = 4 an element's row along b, a thread's derivative coefficients and
//     a level's stencil record (NREC values, rows k and k + 1) come in
//     16-byte loads; ring slots advance without a modulo; one reciprocal of
//     the Jacobian serves every flux divergence;
//   - the two-term RK base combination and the axpy happen at the store; a
//     single base never reads a second one (its pointers are null).
// On that card at 700 W (PERF.md section 6, chip_smoke.py): 0.0796 ms one
// base, 0.0880 two bases (1.8x and 1.5x the bound above), float64 0.1676 /
// 0.1766; no registers spilled.
// Tracers (the flat species-major field `(ntr * nz, P, A, B)`) are advected
// in the same launch on the mass fluxes jac * u^a, jac * u^b that carry Rho;
// the tracer row is s * nz + k while every metric term is indexed by the
// level k alone.  The kernel without tracers is an instantiation of its own
// (TR = false).
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
// has no x-z test.
//
// The asynchronous copy goes through three small functions,
// copy_async<BYTES>, commit_stage and wait_stages<N>; a host rehearsal of
// this source defines STAGE_EMULATED_COPY and gives them as a plain copy and
// two no-ops.
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
// In shared memory the table is one record of NREC values a level, 16-byte
// aligned, with what level k reads of rows k and k + 1 (the interface
// above): its record comes in NREC / 4 vector loads.
constexpr int R_II2N = 0, R_DN2N = 2, R_WL = 5, R_WR = 7, R_PL = 9,
              R_PR = 12, R_SLEV = 15;
constexpr int R_IN2I = 16;  // u^xi of interface k + 1, and its profile
constexpr int R_SINT = 20;
constexpr int NREC = 24;
// where record slot j comes from: an offset into the table (row k at 0)
__device__ __forceinline__ int record_source(int j) {
  if (j < R_WL) return j;                               // II2N, DN2N
  if (j < R_SLEV) return C_WL + (j - R_WL);             // WL WR PL PR
  if (j == R_SLEV) return C_SLEV;
  if (j < R_SINT) return NCOLS + C_IN2I + (j - R_IN2I);
  if (j == R_SINT) return NCOLS + C_SINT;
  return -1;                                            // padding
}

// what `xz` names: the slot of the physical V of an x-z slice
constexpr int XZ_U = 1, XZ_V = 2;
constexpr int NTILES = 9;        // shared-memory tiles of computed fields
constexpr int MIN_RING = 3, MAX_RING = 6;
// the most dynamic shared memory one block may opt into on an H100
constexpr size_t SMEM_MAX = 232448;

// The slabs of one ring stage, in this order (fast/stage_cuda.py
// ring_slabs counts them the same way): U, V (level k+2), W (interface k+1),
// Rt, Rho, base 1 U V Rt Rho, base 2 U V Rt Rho (two bases only); the full
// 3-D metric (not in the separable form): caxi cbxi cxixi jac dra drb at
// level k, caxii cbxii cxixii at interface k+1; then per species its value,
// base 1 and base 2 (two bases only).
constexpr int S_U = 0, S_V = 1, S_W = 2, S_RT = 3, S_RHO = 4, S_B1 = 5;
constexpr int N3D = 9;

#ifndef STAGE_EMULATED_COPY
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
#endif

// One chunk of each slab s0, s0 + step, ... of a ring stage: from the
// slab's row (sptr[s] + koff) into dst (dst + dstep per slab); the U and V
// slabs (0 and 1) only where `uv` says their row exists.
template <int BYTES, typename T>
__device__ __forceinline__ void copy_slabs(T* dst, const T* const* sptr,
                                           long long koff, int s0, int ns,
                                           int step, int dstep, bool uv) {
  for (int s = s0; s < ns; s += step, dst += dstep)
    if (uv || s > S_V) copy_async<BYTES>(dst, sptr[s] + koff);
}

// wait_stages with the count known at launch only (R - 3 for R ring stages)
__device__ __forceinline__ void wait_ring(int n) {
  switch (n) {
    case 0: wait_stages<0>(); break;
    case 1: wait_stages<1>(); break;
    case 2: wait_stages<2>(); break;
    default: wait_stages<MAX_RING - MIN_RING>(); break;
  }
}

// four values from 16-byte aligned shared memory in 16-byte loads
__device__ __forceinline__ void load4(const float* src, float* o) {
  const float4 v = *reinterpret_cast<const float4*>(src);
  o[0] = v.x;
  o[1] = v.y;
  o[2] = v.z;
  o[3] = v.w;
}
__device__ __forceinline__ void load4(const double* src, double* o) {
  const double2 v = reinterpret_cast<const double2*>(src)[0];
  const double2 w = reinterpret_cast<const double2*>(src)[1];
  o[0] = v.x;
  o[1] = v.y;
  o[2] = w.x;
  o[3] = w.y;
}

// the NP values src[0 .. NP): by 16-byte loads at NP = 4 (the caller
// keeps src 16-byte aligned), else one by one
template <typename T, int NP>
__device__ __forceinline__ void load_row(const T* src, T* o) {
  if constexpr (NP == 4) {
    load4(src, o);
  } else {
#pragma unroll
    for (int s = 0; s < NP; ++s) o[s] = src[s];
  }
}

// The element-local p-point sums of one node from the tiles of computed
// fields (tl: v u w_n ke exner jac*u^a*rho jac*u^b*rho jac*u^a*rt
// jac*u^b*rt, nth values each).  cola: the node's column of the element
// along a (node s at cola[s * TB]); rowb: its row along b (node s at
// rowb[s]); ca, sa, cb, sb: the thread's p derivative and stiffness
// coefficients along a and b, contiguous in s.  NP = p known at compile
// time (4: the row and the coefficients in 16-byte loads), 0: p at run time.
template <typename T>
struct Sums {
  T dv_da, dwn_da, dke_a, dpi_a, du_db, dwn_db, dke_b, dpi_b, wk_rho, wk_rt;
};

template <typename T, int NP>
__device__ __forceinline__ Sums<T> element_sums(const T* cola, const T* rowb,
                                                const T* ca, const T* sa,
                                                const T* cb, const T* sb,
                                                int nth, int TB, int p) {
  Sums<T> r = {T(0), T(0), T(0), T(0), T(0), T(0), T(0), T(0), T(0), T(0)};
  if constexpr (NP > 0) {
    T da[NP], sda[NP], db[NP], sdb[NP];
    T ub[NP], wb[NP], kb[NP], xb[NP], rb[NP], tb[NP];
    load_row<T, NP>(ca, da);
    load_row<T, NP>(sa, sda);
    load_row<T, NP>(cb, db);
    load_row<T, NP>(sb, sdb);
    load_row<T, NP>(rowb + nth, ub);
    load_row<T, NP>(rowb + 2 * nth, wb);
    load_row<T, NP>(rowb + 3 * nth, kb);
    load_row<T, NP>(rowb + 4 * nth, xb);
    load_row<T, NP>(rowb + 6 * nth, rb);
    load_row<T, NP>(rowb + 8 * nth, tb);
#pragma unroll
    for (int s = 0; s < NP; ++s) {
      const T* c = cola + s * TB;
      r.dv_da += da[s] * c[0];
      r.dwn_da += da[s] * c[2 * nth];
      r.dke_a += da[s] * c[3 * nth];
      r.dpi_a += da[s] * c[4 * nth];
      r.du_db += db[s] * ub[s];
      r.dwn_db += db[s] * wb[s];
      r.dke_b += db[s] * kb[s];
      r.dpi_b += db[s] * xb[s];
      r.wk_rho += sda[s] * c[5 * nth] + sdb[s] * rb[s];
      r.wk_rt += sda[s] * c[7 * nth] + sdb[s] * tb[s];
    }
  } else {
    for (int s = 0; s < p; ++s) {
      const T* c = cola + s * TB;
      const T* e = rowb + s;
      r.dv_da += ca[s] * c[0];
      r.dwn_da += ca[s] * c[2 * nth];
      r.dke_a += ca[s] * c[3 * nth];
      r.dpi_a += ca[s] * c[4 * nth];
      r.du_db += cb[s] * e[nth];
      r.dwn_db += cb[s] * e[2 * nth];
      r.dke_b += cb[s] * e[3 * nth];
      r.dpi_b += cb[s] * e[4 * nth];
      r.wk_rho += sa[s] * c[5 * nth] + sb[s] * e[6 * nth];
      r.wk_rt += sa[s] * c[7 * nth] + sb[s] * e[8 * nth];
    }
  }
  return r;
}

// the weak p-point divergence of one tracer flux pair (fa along a, fb
// along b, the node's column and row as in element_sums)
template <typename T, int NP>
__device__ __forceinline__ T flux_sum(const T* fa, const T* fb, const T* sa,
                                      const T* sb, int TB, int p) {
  T wk = T(0);
  if constexpr (NP > 0) {
    T sda[NP], sdb[NP], fbr[NP];
    load_row<T, NP>(sa, sda);
    load_row<T, NP>(sb, sdb);
    load_row<T, NP>(fb, fbr);
#pragma unroll
    for (int e = 0; e < NP; ++e) wk += sda[e] * fa[e * TB] + sdb[e] * fbr[e];
  } else {
    for (int e = 0; e < p; ++e) wk += sa[e] * fa[e * TB] + sb[e] * fb[e];
  }
  return wk;
}

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
  // full 3-D metric, null in the separable form: caxi cbxi cxixi jac dra drb
  // (levels), caxii cbxii cxixii (interfaces)
  const T* m3[N3D];
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
  // cart (a Cartesian grid) only chooses the instantiation at launch; the
  // first version of this kernel measured its tracer instantiation 11 %
  // slower on an H100 with this int moved out of the struct
  int nz, P, A, B, p, use_sep, has_pen, xz, cart;
  // launch shape (fast/stage_cuda.py stage_launch_shape): tile, levels per
  // block, ring stages, species per group of flux tiles, copy width in
  // values; slabs per ring stage
  int TA, TB, L, R, G, V, nslab;
  int ntr;
};

// Grid: (tiles of one panel, panel, chunks of L levels); block: TA * TB
// threads; dynamic shared memory: the ring (R stages of nslab slabs), two
// buffers of NTILES + 2 * G tiles, the element coefficients (D along a
// transposed, S along a, D along b transposed, S along b: a thread's p
// values contiguous), the nz level records of the stencil table, then each
// slab's source pointer.
template <typename T, bool TR, bool CART>
__global__ void fused_stage_kernel(const StageArgs<T> g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nz = g.nz, p = g.p, A = g.A, B = g.B, TA = g.TA, TB = g.TB;
  const int nth = TA * TB, ns = g.nslab, R = g.R, V = g.V;
  const int G = TR ? g.G : 0, ntr = TR ? g.ntr : 0;
  const int tid = threadIdx.x;
  const int nbuf = (NTILES + 2 * G) * nth;
  const int pp = p * p;
  T* ring = reinterpret_cast<T*>(smem_raw);
  T* tiles = ring + (size_t)R * ns * nth;
  // the coefficients and records start 16-byte aligned (vector loads)
  const size_t cof_at =
      ((size_t)(R * ns * nth + 2 * nbuf) * sizeof(T) + 15) & ~(size_t)15;
  T* cof = reinterpret_cast<T*>(smem_raw + cof_at);
  T* rec = cof + 4 * pp;
  const size_t desc =
      (cof_at + (size_t)(4 * pp + nz * NREC) * sizeof(T) + 7) & ~(size_t)7;
  const T** sptr = reinterpret_cast<const T**>(smem_raw + desc);
  for (int i = tid; i < nz * NREC; i += nth) {
    const int k = i / NREC, src = record_source(i - k * NREC);
    rec[i] = src < 0 ? T(0) : g.tab[k * NCOLS + src];
  }
  {
    // Dd[s * p + i] = D[s, i] / delta_a
    const T* Dd = g.tab + (nz + 1) * NCOLS;
    const T* Sd = Dd + pp;       // Sd[i * p + s] = S[i, s] / delta_a
    // ... over the element width along b
    const T* Ddb = CART ? Sd + pp : Dd;
    const T* Sdb = CART ? Sd + 2 * pp : Sd;
    for (int j = tid; j < pp; j += nth) {
      const int i = j / p, s = j - i * p;
      cof[j] = Dd[s * p + i];
      cof[pp + j] = Sd[j];
      cof[2 * pp + j] = Ddb[s * p + i];
      cof[3 * pp + j] = Sdb[j];
    }
  }

  const bool two_base = g.b2[0] != nullptr;
  const int nbase = two_base ? 8 : 4;
  const int i3d = S_B1 + nbase;                      // first 3-D metric slab
  const int itr = i3d + (g.use_sep ? 0 : N3D);       // first tracer slab
  const int pspec = two_base ? 3 : 2;                // slabs per species
  const int slab2 = A * B;
  const long long level = (long long)g.P * slab2;
  // each slab's row of level 0 (U, V two levels up, W and the interface
  // metric one; every row exists at every level but U's and V's near the
  // top, which the copies test)
  for (int s = tid; s < ns; s += nth) {
    const T* ptr;
    int shift = 0;
    if (s < S_B1) {
      const T* const ev[5] = {g.u, g.v, g.w, g.rt, g.rho};
      ptr = ev[s];
      shift = s <= S_V ? 2 : (s == S_W ? 1 : 0);
    } else if (s < i3d) {
      ptr = s < S_B1 + 4 ? g.b1[s - S_B1] : g.b2[s - S_B1 - 4];
    } else if (s < itr) {
      ptr = g.m3[s - i3d];
      shift = s - i3d >= 6 ? 1 : 0;
    } else {
      const int sp = (s - itr) / pspec, which = (s - itr) - sp * pspec;
      ptr = (which == 0 ? g.tr : which == 1 ? g.btr1 : g.btr2) +
            (long long)sp * nz * level;
    }
    sptr[s] = ptr + shift * level;
  }

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
  const long long col = active ? (long long)pn * slab2 + a * B + b : 0;
  // position inside the element, and the element's first row / column
  const int ia = ty % p, ea0 = ty - ia;
  const int ib = tx % p, eb0 = tx - ib;
  // this thread's p coefficients (D, S over the element width) along a, b
  const T* cda = cof + ia * p;
  const T* csa = cof + pp + ia * p;
  const T* cdb = cof + 2 * pp + ib * p;
  const T* csb = cof + 3 * pp + ib * p;

  // The copies: a slab of the tile is TA rows of TB / V chunks of V nodes.
  // Thread tid copies chunk tid % per of the slabs tid / per, + V, + 2V, ...
  // (per = nth / V), into the same place of the ring as the thread layout.
  const int per = nth / V;
  const int cq = tid % per;
  const int cr = cq / (TB / V);
  const int ca = tile_a * TA + cr;
  const int cb = tile_b * TB + (cq - cr * (TB / V)) * V;
  const bool cvalid = ca < A && cb < B;
  const long long ccol = (long long)pn * slab2 + (long long)ca * B + cb;
  const int cs0 = tid / per;
  const int cbytes = V * (int)sizeof(T);
  const int k0 = blockIdx.z * g.L;
  const int k1 = min(nz, k0 + g.L);
  const int stage_vals = ns * nth;  // one ring stage
  __syncthreads();  // the table and the slab descriptors
  // the stage of level k into ring slot `slot` (level k0 has slot 0); one
  // group per level, empty past the chunk, so that the group count stays
  // in step
  T* const cdst = ring + cq * V + cs0 * nth;  // this thread's first chunk
  const auto issue = [&](int k, int slot) {
    if (k < k1 && cvalid) {
      T* dst = cdst + slot * stage_vals;
      const long long koff = (long long)k * level + ccol;
      const bool uv = k + 2 < nz;
      if (cbytes == 16)
        copy_slabs<16>(dst, sptr, koff, cs0, ns, V, V * nth, uv);
      else if (cbytes == 8)
        copy_slabs<8>(dst, sptr, koff, cs0, ns, V, V * nth, uv);
      else
        copy_slabs<4>(dst, sptr, koff, cs0, ns, V, V * nth, uv);
    }
    commit_stage();
  };
  for (int j = 0; j < R - 2; ++j) issue(k0 + j, j);

  // the 2-D metric of this node, and the window's first rows, from device
  // memory once per run of levels
  T c2aa = T(0), c2ab = T(0), c2ba = T(0), c2bb = T(0), fj = T(0);
  T Ca = T(0), Cb = T(0), E = T(0), F = T(0), dZa = T(0), dZb = T(0);
  T jacl = T(0);
  T um1 = T(0), u0 = T(0), up1 = T(0), vm1 = T(0), v0 = T(0), vp1 = T(0);
  T w0 = T(0), x0 = T(0);  // W at interface k, |u^xi| at interface k
  if (active) {
    c2aa = g.m2d[col];
    c2ab = g.m2d[level + col];
    c2ba = g.m2d[2 * level + col];
    c2bb = g.m2d[3 * level + col];
    fj = g.m2d[4 * level + col];
    if (g.use_sep) {
      Ca = g.m2d[5 * level + col];
      Cb = g.m2d[6 * level + col];
      E = g.m2d[7 * level + col];
      F = g.m2d[8 * level + col];
      dZa = g.m2d[9 * level + col];
      dZb = g.m2d[10 * level + col];
      jacl = g.m2d[11 * level + col];
    }
    const long long o = (long long)k0 * level + col;
    T um2 = T(0), vm2 = T(0);
    if (k0 >= 2) {
      um2 = g.u[o - 2 * level];
      vm2 = g.v[o - 2 * level];
    }
    if (k0 >= 1) {
      um1 = g.u[o - level];
      vm1 = g.v[o - level];
    }
    u0 = g.u[o];
    v0 = g.v[o];
    if (k0 + 1 < nz) {
      up1 = g.u[o + level];
      vp1 = g.v[o + level];
    }
    w0 = g.w[o];
    if (g.has_pen && k0 > 0) {  // u^xi is zero on the bottom interface
      const T* ri = rec + (k0 - 1) * NREC + R_IN2I;  // interface k0
      const T ui = ri[0] * um2 + ri[1] * um1 + ri[2] * u0 + ri[3] * up1;
      const T vi = ri[0] * vm2 + ri[1] * vm1 + ri[2] * v0 + ri[3] * vp1;
      if (g.use_sep) {
        const T si = ri[R_SINT - R_IN2I];
        x0 = fabs(si * (Ca * ui + Cb * vi) + (E + si * si * F) * w0);
      } else {
        x0 = fabs(g.m3[6][o] * ui + g.m3[7][o] * vi + g.m3[8][o] * w0);
      }
    }
  }
  wait_ring(R - 3);
  __syncthreads();  // the first stage

  int ph = 0;  // barrier phases so far: the tile buffer is ph & 1
  int cur = 0, nxt = R - 2;  // ring slots of level k and of level k + R - 2
  for (int k = k0; k < k1; ++k) {
    issue(k + R - 2, nxt);  // the slot of level k - 2, free since the barrier
    const T* st = ring + cur * stage_vals + tid;  // this node's
    T* tl = tiles + (ph & 1) * nbuf;
    const long long o = (long long)k * level + col;
    T u = T(0), v = T(0), rt = T(1), rho = T(1);
    T du_dxi = T(0), dv_dxi = T(0), pen_u = T(0), pen_v = T(0);
    T con_ua = T(0), con_ub = T(0), con_ux = T(0), jac = T(1);
    T dra = T(0), drb = T(0), base_a = T(0), base_b = T(0), rjac = T(1);
    // species s0 .. s0 + G - 1: flux * tracer into the group's flux tiles;
    // after the barrier, the weak flux divergence, the base combination and
    // the axpy
    const auto fill_tracers = [&](T* t, int s0) {
      T* ft = t + NTILES * nth + tid;
      for (int j = 0; j < G && s0 + j < ntr; ++j) {
        const T q = st[(size_t)(itr + (s0 + j) * pspec) * nth];
        ft[(2 * j) * nth] = base_a * q;
        ft[(2 * j + 1) * nth] = base_b * q;
      }
    };
    const auto store_tracers = [&](const T* t, int s0) {
      const T* ft = t + NTILES * nth;
      for (int j = 0; j < G && s0 + j < ntr; ++j) {
        const T* fa = ft + (2 * j) * nth + ea0 * TB + tx;
        const T* fb = ft + (2 * j + 1) * nth + ty * TB + eb0;
        const T wk = p == 4 ? flux_sum<T, 4>(fa, fb, csa, csb, TB, p)
                            : flux_sum<T, 0>(fa, fb, csa, csb, TB, p);
        const T* q = st + (size_t)(itr + (s0 + j) * pspec + 1) * nth;
        const T base = two_base ? g.cb1 * q[0] + g.cb2 * q[nth] : q[0];
        g.otr[((long long)(s0 + j) * nz + k) * level + col] =
            base + g.dt_s * (wk * rjac);
      }
    };
    if (active) {
      T r[NREC];  // this level's record
#pragma unroll
      for (int j = 0; j < NREC; j += 4) load4(rec + k * NREC + j, r + j);
      // the new rows of the window
      T up2 = T(0), vp2 = T(0);
      if (k + 2 < nz) {
        up2 = st[S_U * nth];
        vp2 = st[S_V * nth];
      }
      const T w1 = st[S_W * nth];
      u = u0;
      v = v0;
      rt = st[S_RT * nth];
      rho = st[S_RHO * nth];
      const T w_n = r[R_II2N] * w0 + r[R_II2N + 1] * w1;
      du_dxi = r[R_DN2N] * um1 + r[R_DN2N + 1] * u0 + r[R_DN2N + 2] * up1;
      dv_dxi = r[R_DN2N] * vm1 + r[R_DN2N + 1] * v0 + r[R_DN2N + 2] * vp1;
      if (g.has_pen) {
        T x1 = T(0);  // |u^xi| at interface k + 1, zero on the top one
        if (k + 1 < nz) {
          const T* ri = r + R_IN2I;
          const T ui = ri[0] * um1 + ri[1] * u0 + ri[2] * up1 + ri[3] * up2;
          const T vi = ri[0] * vm1 + ri[1] * v0 + ri[2] * vp1 + ri[3] * vp2;
          if (g.use_sep) {
            const T si = r[R_SINT];
            x1 = fabs(si * (Ca * ui + Cb * vi) + (E + si * si * F) * w1);
          } else {
            x1 = fabs(st[(i3d + 6) * nth] * ui + st[(i3d + 7) * nth] * vi +
                      st[(i3d + 8) * nth] * w1);
          }
        }
        const T wl = r[R_WL] * x0 + r[R_WL + 1] * x1;
        const T wr = r[R_WR] * x0 + r[R_WR + 1] * x1;
        pen_u = (r[R_PL] * um1 + r[R_PL + 1] * u0 + r[R_PL + 2] * up1) * wl +
                (r[R_PR] * um1 + r[R_PR + 1] * u0 + r[R_PR + 2] * up1) * wr;
        pen_v = (r[R_PL] * vm1 + r[R_PL + 1] * v0 + r[R_PL + 2] * vp1) * wl +
                (r[R_PR] * vm1 + r[R_PR + 1] * v0 + r[R_PR + 2] * vp1) * wr;
        x0 = x1;
      }
      um1 = u0;
      u0 = up1;
      up1 = up2;
      vm1 = v0;
      v0 = vp1;
      vp1 = vp2;
      w0 = w1;
      T caxi, cbxi, cxixi;
      if (g.use_sep) {
        const T s = r[R_SLEV];
        caxi = s * Ca;
        cbxi = s * Cb;
        cxixi = E + (s * s) * F;
        dra = s * dZa;
        drb = s * dZb;
        jac = jacl;
      } else {
        caxi = st[i3d * nth];
        cbxi = st[(i3d + 1) * nth];
        cxixi = st[(i3d + 2) * nth];
        jac = st[(i3d + 3) * nth];
        dra = st[(i3d + 4) * nth];
        drb = st[(i3d + 5) * nth];
      }
      con_ua = c2aa * u + c2ab * v + caxi * w_n;
      con_ub = c2ba * u + c2bb * v + cbxi * w_n;
      con_ux = caxi * u + cbxi * v + cxixi * w_n;
      base_a = jac * con_ua;
      base_b = jac * con_ub;
      rjac = T(1) / jac;
      tl[tid] = v;
      tl[nth + tid] = u;
      tl[2 * nth + tid] = w_n;
      tl[3 * nth + tid] =
          T(0.5) * (con_ua * u + con_ub * v + con_ux * w_n);
      tl[4 * nth + tid] = g.Cp * exp(g.kappa * log(g.rp0 * rt));
      tl[5 * nth + tid] = base_a * rho;  // jac * u^a * rho
      tl[6 * nth + tid] = base_b * rho;  // jac * u^b * rho
      tl[7 * nth + tid] = base_a * rt;   // jac * u^a * rt
      tl[8 * nth + tid] = base_b * rt;   // jac * u^b * rt
      if constexpr (TR) fill_tracers(tl, 0);
    }
    wait_ring(R - 3);  // this thread's copies of level k + 1 have landed
    __syncthreads();   // the tiles of level k, the ring stage of level k + 1
    ++ph;
    if (active) {
      // node s of the element along a, along b
      const T* cola = tl + ea0 * TB + tx;
      const T* rowb = tl + ty * TB + eb0;
      const Sums<T> d =
          p == 4 ? element_sums<T, 4>(cola, rowb, cda, csa, cdb, csb, nth,
                                      TB, p)
                 : element_sums<T, 0>(cola, rowb, cda, csa, cdb, csb, nth,
                                      TB, p);
      const T jzeta_a = d.dwn_db - dv_dxi;
      const T jzeta_b = du_dxi - d.dwn_da;
      const T jzeta_x = d.dv_da - d.du_db;
      const T ucz_a = con_ub * jzeta_x - con_ux * jzeta_b;
      const T ucz_b = con_ux * jzeta_a - con_ua * jzeta_x;
      const T ucz_x = -con_ua * d.dwn_da - con_ub * d.dwn_db;
      const T theta = rt / rho;
      const T dU =
          (CART && g.xz == XZ_U)
              ? pen_u
              : (ucz_a + fj * con_ub -
                 (d.dpi_a * theta + d.dke_a + g.grav * dra)) + pen_u;
      const T dV =
          (CART && g.xz == XZ_V)
              ? pen_v
              : (ucz_b - fj * con_ua -
                 (d.dpi_b * theta + d.dke_b + g.grav * drb)) + pen_v;
      // weak divergence = -(a part + b part); tendency = -divergence / jac
      const T tend[4] = {dU, dV, d.wk_rt * rjac, d.wk_rho * rjac};
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        const T base = two_base ? g.cb1 * st[(S_B1 + f) * nth] +
                                      g.cb2 * st[(S_B1 + 4 + f) * nth]
                                : st[(S_B1 + f) * nth];
        g.out[f][o] = base + g.dt_s * tend[f];
      }
      g.out[4][o] = ucz_x;
      if constexpr (TR) store_tracers(tl, 0);
    }
    if constexpr (TR) {
      for (int s0 = G; s0 < ntr; s0 += G) {  // G >= 1 wherever ntr >= 1
        T* tg = tiles + (ph & 1) * nbuf;
        if (active) fill_tracers(tg, s0);
        __syncthreads();
        ++ph;
        if (active) store_tracers(tg, s0);
      }
    }
    cur = cur + 1 == R ? 0 : cur + 1;
    nxt = nxt + 1 == R ? 0 : nxt + 1;
  }
}

template <typename T, bool TR, bool CART>
int launch_one(const StageArgs<T>& g, dim3 grid, int nthreads, size_t smem,
               cudaStream_t st) {
  // opt in to more than the default 48 KB once per device
  static bool opted[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (smem > 48 * 1024 && dev < 64 && !opted[dev]) {
    const cudaError_t e = cudaFuncSetAttribute(
        fused_stage_kernel<T, TR, CART>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_MAX);
    if (e != cudaSuccess) return (int)e;
    opted[dev] = true;
  }
  fused_stage_kernel<T, TR, CART><<<grid, nthreads, smem, st>>>(g);
  return (int)cudaGetLastError();
}

// ptrs: u v rt rho w | base1 U V Rt Rho | base2 U V Rt Rho (null: single) |
// m2d | caxi cbxi cxixi jac dra drb caxii cbxii cxixii (null: separable) |
// tab | out U V Rt Rho ucz_x | tracers: eval, base1, base2 (null: single),
// out (all null without tracers).  scal: dt_s cb1 cb2 Cp Rd/(Cp-Rd) Rd/P0 g.
// ints: nz P A B p use_sep has_pen ntr xz cart (cart: a Cartesian grid, the
// CART instantiation; xz is read only there) | TA TB L R G V (the launch
// shape: fast/stage_cuda.py stage_launch_shape and copy_width).
// Returns cudaGetLastError(), -1 for shapes or launch shapes the kernel does
// not take (a pointer not aligned to the copy width among them), -2 if the
// ring, tiles and table exceed the 227 KB a block may have.
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
  for (int f = 0; f < N3D; ++f) g.m3[f] = (const T*)ptrs[14 + f];
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
  g.TA = ints[10];
  g.TB = ints[11];
  g.L = ints[12];
  g.R = ints[13];
  g.G = ints[14];
  g.V = ints[15];
  const int p = g.p, TA = g.TA, TB = g.TB, V = g.V;
  const bool two_base = g.b2[0] != nullptr;
  if (g.nz < 1 || g.P < 1 || p < 1 || p > 8 || g.A < p || g.B < p ||
      g.A % p != 0 || g.B % p != 0 || g.ntr < 0 || g.xz < 0 || g.xz > 2 ||
      (g.xz != 0 && !g.cart) ||
      (g.ntr > 0 && (!g.tr || !g.btr1 || !g.otr)) ||
      ((g.btr2 != nullptr) != (g.ntr > 0 && two_base)) ||
      (!g.use_sep && !g.m3[0]))
    return -1;
  if (TA < p || TB < p || TA % p != 0 || TB % p != 0 || TA * TB > 1024 ||
      g.L < 1 || g.R < MIN_RING || g.R > MAX_RING ||
      (g.ntr > 0 ? (g.G < 1 || g.G > g.ntr) : g.G != 0) ||
      (V != 1 && V * sizeof(T) != 8 && V * sizeof(T) != 16) ||
      TB % V != 0 || g.B % V != 0)
    return -1;
  const int nthreads = TA * TB;
  const int nbase = two_base ? 8 : 4;
  g.nslab = 5 + nbase + (g.use_sep ? 0 : N3D) +
            g.ntr * (1 + nbase / 4);
  // every slab's source must be aligned to the copy width
  const size_t align = V * sizeof(T);
  const void* slabs[] = {g.u, g.v, g.w, g.rt, g.rho, g.b1[0], g.b1[1],
                         g.b1[2], g.b1[3], g.b2[0], g.b2[1], g.b2[2],
                         g.b2[3], g.m3[0], g.m3[1], g.m3[2], g.m3[3],
                         g.m3[4], g.m3[5], g.m3[6], g.m3[7], g.m3[8],
                         g.tr, g.btr1, g.btr2};
  for (const void* s : slabs)
    if ((size_t)s % align != 0) return -1;
  const size_t vals = (size_t)g.R * g.nslab * nthreads +
                      2 * (size_t)(NTILES + 2 * g.G) * nthreads;
  const size_t ntab = (size_t)g.nz * NREC + 4 * p * p;
  const size_t smem =
      ((((vals * sizeof(T) + 15) & ~(size_t)15) + ntab * sizeof(T) + 7) &
       ~(size_t)7) + (size_t)g.nslab * sizeof(T*);
  if (smem > SMEM_MAX) return -2;
  const unsigned tiles = (unsigned)(((g.A + TA - 1) / TA) *
                                    ((g.B + TB - 1) / TB));
  const dim3 grid(tiles, (unsigned)g.P, (unsigned)((g.nz + g.L - 1) / g.L));
  const cudaStream_t st = (cudaStream_t)stream;
  if (g.cart)
    return g.ntr > 0 ? launch_one<T, true, true>(g, grid, nthreads, smem, st)
                     : launch_one<T, false, true>(g, grid, nthreads, smem, st);
  return g.ntr > 0 ? launch_one<T, true, false>(g, grid, nthreads, smem, st)
                   : launch_one<T, false, false>(g, grid, nthreads, smem, st);
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
