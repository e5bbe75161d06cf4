// Direct stiffness summation (DSS), one launch per field (or one for U, V and
// W together with the stage's W finish: `dss_uvw`), on the cubed sphere or on
// a periodic Cartesian grid.  Fields are z-first (K, P, A, B).  DSS replaces
// every group of coincident GLL nodes by its mean: element pair sums inside a
// panel (along a, then along b on the a-summed values), plus, on a panel edge,
// the neighbour panel's PAIR-SUMMED value at the coincident node (reversed
// where `flip`; for the covariant (U, V) pair rotated by the 2x2 matrix stored
// per link and per position along the DESTINATION edge; a cube-corner node
// receives two, in the order of the link list), times the inverse
// multiplicity.  A Cartesian grid (the TPU kernels' `wrap=True`,
// `_pair_masks`) is one panel without edge links, A and B free: every kernel
// has an instantiation for it (CART, launched when nlinks == 0) in which the
// edge terms are compiled out and the periodic wrap-sum pairs node 0 with
// node A-1 (B-1) on the axes the `wrap` bits name (1: along a, 2: along b).
// The sphere's instantiations hold no wrap code: with the wrap test in one
// shared instantiation the flagship's DSS launches took 2-6 % longer.
//
// A Cartesian grid with no-flux walls along one axis (the `noflux` bits, 1:
// the walls a = 0 and a = A - 1, 2: b = 0 and b = B - 1) averages each wall
// node's DSS result with its halo, 0.5 (x + h), after the inverse
// multiplicity and before any finish (grid/cartesian.apply_dss_cartesian's
// `halo`: the reference's per-instance halo of the wall node, which lags the
// node by the stage combinations).  The halo of field f is its wall rows
// alone, (levels, 2, L) with L = B (a walls) or A (b walls), side 0 the
// first wall; a null halo pointer is the zero halo (the nu4 working
// state's).  The state mode can write the wall values as they are before
// its Rayleigh finish to `hout`, the halo the next step inherits.  Only the
// CART instantiations hold this code, as only they hold the wrap.
//
// `dss_scalar` replaces the TPU kernel `dss_scalar` (`_scalar_kernel`,
// tempestmodel_tpu/fast/dss_pallas.py:200, called at :474) and `dss_uvw`
// the TPU kernel `dss_uvw` (`_uvw_kernel`, :355, called at :453): the DSS of
// U, V (rotated pair) and W in one launch with the explicit stage's W finish
// folded in (W = base + dt_s * dW on the interior interfaces, base = bw1 or
// cb1 * bw1 + cb2 * bw2; the bottom interface the diagnostic value from
// u^xi(surface) = 0, made from U, V at levels 0 and 1 with the surface metric
// cax0, cbx0, cxx0).  The TPU kernels keep whole z-blocks of panels in VMEM
// and sum there with masked rolls and a flip-matrix dot; the rolls and dots
// are not carried over, the staging is.
//
// Bound on an H100 (3.35 TB/s): bytes.  A scalar must be read once and
// written once: at (30, 6, 120, 120) float32, 2 x 10.4 MB = 20.7 MB, 6.2 us;
// `dss_uvw` reads U, V, bw1[, bw2], dW and writes U, V, W: 64-75 MB at
// (30 | 31, 6, 120, 120) float32, 19-22 us.  The earlier gathers (one thread
// a node, every value loaded from the L2 or device memory where it was used)
// ran at 36-40 % of those bounds; without their edge terms they took a
// quarter (scalar) and 41 % (`dss_uvw`) less: the warps holding a panel-edge
// node waited, level after level, on dependent L2 loads of the neighbour
// panel.
//
// The design (`band_kernel`): a block owns a BAND of TA whole rows of one
// panel (TA a multiple of p dividing A) and walks a run of levels.  At one
// level the band and the halo row on each side (the a-partners of its first
// and last rows) are one contiguous span of (TA + 2) B values; each level's
// span of every field goes into shared memory by ONE 1-D bulk copy (TMA,
// `cp.async.bulk`, completing on an mbarrier) where spans and pointers are
// 16-byte multiples, else by `cp.async` of 8 or 4 bytes completing on the
// same mbarrier; on a Cartesian grid with the wrap along a the halo rows of
// the first and last band are copied alone.  The neighbour panels' edge
// lines that the band needs (the bottom and top edges at the band's rows,
// the left and right edges in the first and last band) are gathered into
// shared memory by `cp.async` with the same mbarrier, so no warp waits on
// the L2 inside its sums.  A ring of `ring` stages keeps the next levels'
// copies in flight while a level is summed; one barrier a level frees a
// stage for its refill.  A thread owns an element-row SEGMENT, p consecutive
// nodes along b of one row: one 16-byte shared load (p = 4, float32) for the
// segment and one for the a-partner row's segment, the b-partners from the
// neighbouring segments' end values, one 16-byte store.  A thread works out
// its segment's rows, partners and edges once; a block stages its band's
// inverse multiplicities (and, for the (U, V) pair, its edge lines'
// rotations) once, and takes the link table by value in its arguments.
// The template has five compile-time modes, each instantiated for the
// cubed sphere and for a Cartesian grid (CART), with p = 4 and any p:
//   scalar  (`dss_scalar`) one field a stage;
//   vector  (`dss_vector`) U and V a stage, the rotation applied to the
//           edge contributions only;
//   uvw     (`dss_uvw`) U, V and three W inputs a stage: raw W is assembled
//           once a node (span and edge lines) into a buffer of its own,
//           then summed like a scalar, and U, V are summed as in the vector
//           mode; its bottom interface is a run of its own;
//   scalar2 (`dss_scalar2`) two scalar fields of one shape a stage (Rt and
//           Rho), each through the scalar mode's path, no rotation;
//   state   (`dss_state`) the five fields of a state a stage (U, V, Rt,
//           Rho, W): U, V through the vector mode's path, Rt, Rho and W
//           through the scalar path; W's top interface is a run of its own;
//           an optional pointwise finish at the stores.
// Every product and sum is rounded as the plain version's tensor operations
// round it (no fused multiply-add), so the results equal the plain
// versions'.
//
// `dss_vector` replaces the TPU kernel `dss_vector` (`_vector_kernel`,
// dss_pallas.py:242, called at :489): the DSS of the covariant (U, V) pair,
// the band kernel's vector mode.  Bound: bytes (U and V read once and
// written once): 41.5 MB at (30, 6, 120, 120) float32, 12.4 us.  No kernel
// here uses atomics or read-modify-write: the result is the same on every
// run.
//
// `dss_scalar2` replaces the TPU kernel `dss_scalar2` (`_scalar2_kernel`,
// dss_pallas.py:231): the DSS of two scalar fields of one shape in one
// launch, the band kernel's scalar2 mode, bit for bit two `dss_scalar`
// launches.  Bound: bytes (both fields read once and written once): 41.5 MB
// at (30, 6, 120, 120) float32, 12.4 us.
//
// `dss_state` replaces the TPU kernel `dss_state` (`_state_kernel`,
// dss_pallas.py:343): the DSS of all five fields of the state (the (U, V)
// pair rotated, Rt, Rho and W as scalars, W with one level more) in one
// launch, the band kernel's state mode.  A block stages the five fields'
// spans and edge lines a level, so one block's set-up (its barriers, its
// inverse multiplicities and edge rotations, its segments) serves five
// fields where the separate launches pay it for one or two.  It can finish
// with the Rayleigh term form x <- fac * x + ref, read from ten more
// fields; they are pointwise and are not staged: each thread reads them at
// its store (16-byte loads where p = 4 and the pointers allow).  That
// product and sum are rounded separately, as two tensor operations would
// round them, so the result equals the separate launches followed by the
// plain finish.  Bound: bytes (each field read once and written once): 104
// MB at (30 | 31, 6, 120, 120) float32, 31 us (209 MB, 62 us with the
// Rayleigh finish).
//
// Plain C interface (no PyTorch header): pointers and the stream arrive as
// integers, the launch goes to the given stream, nothing synchronises or
// allocates, and each entry point returns cudaGetLastError().

#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int EDGE_LEFT = 0, EDGE_RIGHT = 1, EDGE_BOTTOM = 2;  // EDGE_TOP = 3
// Rounded as one tensor operation rounds it (never contracted to an FMA).
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float div_rn(float a, float b) {
  return __fdiv_rn(a, b);
}
__device__ __forceinline__ double div_rn(double a, double b) {
  return __ddiv_rn(a, b);
}

// fac * x + ref with the product and the sum rounded separately (no fused
// multiply-add), as two tensor operations round them.
__device__ __forceinline__ float mul_then_add(float f, float x, float r) {
  return __fadd_rn(__fmul_rn(f, x), r);
}
__device__ __forceinline__ double mul_then_add(double f, double x, double r) {
  return __dadd_rn(__dmul_rn(f, x), r);
}

// Calls f with std::true_type for a grid without edge links (Cartesian: the
// kernels' CART instantiation) and with std::false_type otherwise, so the
// cubed sphere runs kernels without the wrap code.
template <typename F>
void by_grid(int nlinks, F f) {
  if (nlinks == 0) f(std::true_type{});
  else f(std::false_type{});
}

// ---------------------------------------------------------------------------
// dss_scalar, dss_vector, dss_uvw and dss_scalar2: element-row bands staged
// in shared memory
// ---------------------------------------------------------------------------

// Blocks of BAND_THREADS an SM must hold (__launch_bounds__: caps the
// registers a thread): BAND_MIN_BLOCKS for dss_scalar and dss_scalar2,
// BAND_MIN_BLOCKS_UVW for dss_uvw and dss_state, BAND_MIN_BLOCKS_VECTOR for
// dss_vector; kernels/tune_dss.py sweeps them with -D flags.  2 (at most
// 64 registers) made dss_scalar faster at the flagship on an H100; dss_uvw
// spills at 64; dss_state takes 88-128 registers at 1 and spills none.
#ifndef BAND_MIN_BLOCKS
#define BAND_MIN_BLOCKS 2
#endif
#ifndef BAND_MIN_BLOCKS_UVW
#define BAND_MIN_BLOCKS_UVW 1
#endif
#ifndef BAND_MIN_BLOCKS_VECTOR
#define BAND_MIN_BLOCKS_VECTOR 1
#endif
// the modes of the band template: a stage holds x (scalar); U, V (vector);
// U, V and three W inputs (uvw); two scalars (scalar2); U, V, Rt, Rho, W
// (state)
constexpr int M_SCALAR = 0, M_VECTOR = 1, M_UVW = 2, M_SCALAR2 = 3,
              M_STATE = 4;
__host__ __device__ constexpr int band_fields(int mode) {
  return mode == M_UVW || mode == M_STATE ? 5 : (mode == M_SCALAR ? 1 : 2);
}
// the modes that carry the (U, V) pair and its edge rotations
__host__ __device__ constexpr bool band_rotates(int mode) {
  return mode == M_VECTOR || mode == M_UVW || mode == M_STATE;
}
// the modes with a step of their own beyond K levels: dss_uvw's bottom
// interface (the first run), dss_state's top interface of W (the last)
__host__ __device__ constexpr bool band_extra_run(int mode) {
  return mode == M_UVW || mode == M_STATE;
}
constexpr int BAR_BYTES = 64;      // the ring's mbarriers (8 bytes each)
constexpr int MAX_RING = 4;
constexpr int MAX_PANELS = 6;      // of a grid with edge links
constexpr int BAND_THREADS = 512;  // most threads a block
constexpr int MAX_P = 16;          // most nodes a segment (generic p)
constexpr size_t SMEM_MAX = 232448;

// Phase laps: kernels/dss_phases.py compiles a copy of this file with them
// defined; here they are empty.
#ifndef DSS_PHASES
#define DSS_PHASE_BEGIN()
#define DSS_LAP(i) do {} while (0)
#define DSS_PHASE_END()
#endif

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void bar_init(unsigned long long* bar,
                                         unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(
                   smem_addr(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_addr(bar)) : "memory");
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

// p values from `src` (16-byte accesses at p = 4: the caller's offsets keep
// them aligned) and to `dst`.
template <typename T, int PP>
__device__ __forceinline__ void load_seg(const T* src, T* v, int p) {
  if constexpr (PP == 4 && sizeof(T) == 4) {
    const float4 q = *reinterpret_cast<const float4*>(src);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else if constexpr (PP == 4) {
    const double2 q0 = reinterpret_cast<const double2*>(src)[0];
    const double2 q1 = reinterpret_cast<const double2*>(src)[1];
    v[0] = q0.x; v[1] = q0.y; v[2] = q1.x; v[3] = q1.y;
  } else {
    for (int i = 0; i < p; ++i) v[i] = src[i];
  }
}
template <typename T, int PP>
__device__ __forceinline__ void store_seg(T* dst, const T* v, int p) {
  if constexpr (PP == 4 && sizeof(T) == 4) {
    *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (PP == 4) {
    reinterpret_cast<double2*>(dst)[0] = make_double2(v[0], v[1]);
    reinterpret_cast<double2*>(dst)[1] = make_double2(v[2], v[3]);
  } else {
    for (int i = 0; i < p; ++i) dst[i] = v[i];
  }
}

// What the band kernels take.  x: scalar x[0]; vector U, V; uvw U, V, bw1,
// bw2 (null for a single base), dW; scalar2 the two fields; state U, V, Rt,
// Rho, W.  out: scalar out[0]; vector U, V; uvw U, V, W; scalar2 the two
// fields; state U, V, Rt, Rho, W.
template <typename T>
struct BandArgs {
  const T* x[5];
  const T* metric[3];  // dss_uvw: cax0, cbx0, cxx0
  T* out[5];
  // dss_state's Rayleigh finish out = fac * x + ref, per field (null: none)
  const T* fac[5];
  const T* ref[5];
  const T* imult;
  const T* rot;
  // no-flux walls (CART): per output field its halo's wall rows (null: the
  // zero halo) and, in the state mode, where to write the pre-finish wall
  // values (null: nowhere)
  const T* halo[5];
  T* hout[5];
  // the link table by value (cubed sphere): per (panel, edge) neighbour
  // panel, neighbour edge, flip, link index
  int table[4 * MAX_PANELS * 4];
  T dt_s, cb1, cb2, c00, c01;
  int K;               // levels (dss_scalar) or nz (dss_uvw)
  int P, A, B, p, nlinks, wrap;
  int noflux;          // 1: walls along a, 2: along b (CART), 0: none
  int rows, levels, ring, copy;  // band rows, steps a block, stages, bytes
  int ray;             // the finish's loads: 0 none, 1 a value, 2 a segment
  // shared memory layout, in values after the mbarriers: a field's span and
  // its stage slot (span, then the edge lines), then after the ring (and
  // dss_uvw's W buffer) the band's inverse multiplicities and the (U, V)
  // pair's edge rotations (vector and uvw, cubed sphere)
  int span, fs, im_at, rot_at;
};

// The mbarriers: the ring's stages, then the band's constants' (inverse
// multiplicities, rotations).
constexpr int BAR_CONST = MAX_RING;

// Where a band's rows come from.  Local row r + 1 holds band row a0 + r;
// local row 0 the row before the band, local row TA + 1 the row after.
struct Band {
  int a0;
  int lo, rows, llo;   // the contiguous span: first global row, rows, and
                       // the local row it starts at
  int wtop, wbot;      // Cartesian wrap: row copied alone into local row 0 /
                       // TA + 1 (-1: none)
};

template <bool CART>
__device__ __forceinline__ Band make_band(int a0, int TA, int A, int wrap) {
  Band b;
  b.a0 = a0;
  b.lo = a0 > 0 ? a0 - 1 : a0;
  b.llo = a0 > 0 ? 0 : 1;
  b.rows = (a0 + TA < A ? a0 + TA + 1 : a0 + TA) - b.lo;
  const bool wa = CART && (wrap & 1) && TA < A;
  b.wtop = (wa && a0 == 0) ? A - 1 : -1;
  b.wbot = (wa && a0 + TA == A) ? 0 : -1;
  return b;
}

// A thread's segment: p nodes b0 .. b0 + p - 1 of row a.  Offsets are local
// to a field's span (rows of B values).  Edge lines lie at the span's end:
// bottom (b = 0) and top (b = B - 1) lines at the band's rows and their
// halo, TA + 2 values each, then the left (a = 0) and right (a = A - 1)
// lines, A values each.
struct Seg {
  int a, b0, ra;
  int orow, prow;      // own row and a-partner row (-1: none)
  int lcol, rcol;      // column of node 0's / node p-1's b-partner (-1: none)
  int out;             // offset of node b0 inside one level of an output
  int rline;           // row edge (left or right): its line (-1: none)
  bool bot, top;       // node 0 on the bottom edge, node p-1 on the top edge
};

template <bool CART, int PP, typename T>
__device__ __forceinline__ Seg make_seg(const BandArgs<T>& g, int a0, int s) {
  const int p = PP > 0 ? PP : g.p;
  const int A = g.A, B = g.B, TA = g.rows;
  const int nsb = B / p;
  const int r = s / nsb;
  Seg q;
  q.b0 = (s - r * nsb) * p;
  q.a = a0 + r;
  q.ra = q.a % p;
  q.orow = (r + 1) * B;
  int a2 = -1;
  if (q.ra == p - 1 && q.a < A - 1) a2 = q.a + 1;
  else if (q.ra == 0 && q.a > 0) a2 = q.a - 1;
  else if (CART && (g.wrap & 1))
    a2 = q.a == 0 ? A - 1 : (q.a == A - 1 ? 0 : -1);
  if (a2 < 0) q.prow = -1;
  else if (a2 >= a0 && a2 < a0 + TA) q.prow = (a2 - a0 + 1) * B;
  else if (a2 == (a0 == 0 ? A - 1 : a0 - 1)) q.prow = 0;
  else q.prow = (TA + 1) * B;
  const bool wb = CART && (g.wrap & 2);
  q.lcol = q.b0 > 0 ? q.b0 - 1 : (wb ? B - 1 : -1);
  q.rcol = q.b0 + p < B ? q.b0 + p : (wb ? 0 : -1);
  q.out = (blockIdx.y * A + q.a) * B + q.b0;
  q.rline = (CART || (q.a != 0 && q.a != A - 1))
                ? -1 : 2 * (TA + 2) + (q.a == 0 ? 0 : A);
  q.bot = !CART && q.b0 == 0;
  q.top = !CART && q.b0 + p == B;
  return q;
}

// The segment's pair-summed values: along a (the partner row's segment),
// then along b on the a-summed values (the neighbouring segments' ends).
template <typename T, int PP, int NMAX>
__device__ __forceinline__ void pair_sums(const T* F, const Seg& q, int p,
                                          T* s) {
  load_seg<T, PP>(F + q.orow + q.b0, s, p);
  if (q.prow >= 0) {
    T t[NMAX];
    load_seg<T, PP>(F + q.prow + q.b0, t, p);
    for (int i = 0; i < p; ++i) s[i] = add_rn(s[i], t[i]);
  }
  if (q.lcol >= 0) {
    T l = F[q.orow + q.lcol];
    if (q.prow >= 0) l = add_rn(l, F[q.prow + q.lcol]);
    s[0] = add_rn(s[0], l);
  }
  if (q.rcol >= 0) {
    T r = F[q.orow + q.rcol];
    if (q.prow >= 0) r = add_rn(r, F[q.prow + q.rcol]);
    s[p - 1] = add_rn(s[p - 1], r);
  }
}

// The neighbour panel's pair sum at position i of an edge line staged from
// position `first` on: its value plus its element partner's along the line
// (a flip maps element boundaries onto element boundaries, so the partner is
// found from i itself).
template <typename T>
__device__ __forceinline__ T line_at(const T* L, int i, int first, int p,
                                     int A) {
  const int ri = i % p;
  T v = L[i - first];
  if (ri == 0 && i > 0) v = add_rn(v, L[i - 1 - first]);
  else if (ri == p - 1 && i < A - 1) v = add_rn(v, L[i + 1 - first]);
  return v;
}

// The edge terms of a scalar segment, in the order of the link list: the
// row's edge (left or right) on every node, then the bottom edge on node 0
// and the top edge on node p - 1.  E: the staged edge lines.
template <typename T>
__device__ __forceinline__ void edges_scalar(const T* E, const Seg& q, int a0,
                                             int TA, int A, int p, T* s) {
  if (q.rline >= 0)
    for (int i = 0; i < p; ++i)
      s[i] = add_rn(s[i], line_at(E + q.rline, q.b0 + i, 0, p, A));
  if (q.bot) s[0] = add_rn(s[0], line_at(E, q.a, a0 - 1, p, A));
  if (q.top)
    s[p - 1] = add_rn(s[p - 1], line_at(E + TA + 2, q.a, a0 - 1, p, A));
}

// su += r00 lu + r01 lv, sv += r10 lu + r11 lv; r: the link's coefficients
// at the destination position (edge-line index), the four `n` apart.
template <typename T>
__device__ __forceinline__ void rotate_add(const T* r, int n, T lu, T lv,
                                           T& su, T& sv) {
  su = add_rn(su, add_rn(mul_rn(r[0], lu), mul_rn(r[n], lv)));
  sv = add_rn(sv, add_rn(mul_rn(r[2 * n], lu), mul_rn(r[3 * n], lv)));
}

// The edge terms of the (U, V) pair, rotated; R: the staged rotation
// coefficients of the edge lines (4 x nedge).
template <typename T>
__device__ __forceinline__ void edges_vector(const T* EU, const T* EV,
                                             const T* R, int nedge,
                                             const Seg& q, int a0, int TA,
                                             int A, int p, T* su, T* sv) {
  if (q.rline >= 0)
    for (int i = 0; i < p; ++i) {
      const int pos = q.b0 + i;
      rotate_add(R + q.rline + pos, nedge,
                 line_at(EU + q.rline, pos, 0, p, A),
                 line_at(EV + q.rline, pos, 0, p, A), su[i], sv[i]);
    }
  const int ia = q.a - a0 + 1;
  if (q.bot)
    rotate_add(R + ia, nedge, line_at(EU, q.a, a0 - 1, p, A),
               line_at(EV, q.a, a0 - 1, p, A), su[0], sv[0]);
  if (q.top)
    rotate_add(R + TA + 2 + ia, nedge,
               line_at(EU + TA + 2, q.a, a0 - 1, p, A),
               line_at(EV + TA + 2, q.a, a0 - 1, p, A), su[p - 1],
               sv[p - 1]);
}

// cp.async of `bytes` (a multiple of `copy`) in pieces of `copy` bytes,
// shared among the block's threads.
__device__ __forceinline__ void copy_span(int copy, void* dst,
                                          const void* src, int bytes) {
  char* d = static_cast<char*>(dst);
  const char* s = static_cast<const char*>(src);
  if (copy == 8)
    for (int c = threadIdx.x * 8; c < bytes; c += blockDim.x * 8)
      copy_async<8>(d + c, s + c);
  else
    for (int c = threadIdx.x * 4; c < bytes; c += blockDim.x * 4)
      copy_async<4>(d + c, s + c);
}

// A contiguous run of `bytes` into shared memory on the mbarrier `bar`: one
// bulk copy by thread 0 (copy == 16), else cp.async by every thread.  The
// caller accounts for the arrivals (`bulk_bytes` counts the bulk copies).
__device__ __forceinline__ void copy_run(int copy, void* dst, const void* src,
                                         int bytes, unsigned long long* bar) {
  if (copy != 16) copy_span(copy, dst, src, bytes);
  else if (threadIdx.x == 0) bulk_copy(dst, src, bytes, bar);
}

// The level of each field that step k stages (null: none), all panels.
// Field slot f of a stage: dss_scalar x; dss_vector U, V; dss_uvw U, V and
// three W inputs (bw1, bw2, dW, or at the bottom interface cax0, cbx0,
// cxx0); dss_scalar2 its two fields; dss_state U, V, Rt, Rho and W (W alone
// at the top interface k = K); `uv_only`: U and V of level k alone.
template <typename T, int M>
__device__ __forceinline__ void step_fields(const BandArgs<T>& g, int k,
                                            bool uv_only,
                                            const T* (&src)[band_fields(M)]) {
  const long long lvl = (long long)k * g.P * g.A * g.B;
  if constexpr (M == M_UVW) {
    const bool uv = k < g.K;
    src[0] = uv ? g.x[0] + lvl : nullptr;
    src[1] = uv ? g.x[1] + lvl : nullptr;
    if (uv_only) {
      src[2] = src[3] = src[4] = nullptr;
    } else if (k == 0) {
      for (int f = 0; f < 3; ++f) src[2 + f] = g.metric[f];
    } else {
      src[2] = g.x[2] + lvl;
      src[3] = g.x[3] ? g.x[3] + lvl : nullptr;
      src[4] = uv ? g.x[4] + lvl : nullptr;   // dW is masked at the top
    }
  } else if constexpr (M == M_STATE) {
    for (int f = 0; f < 4; ++f) src[f] = k < g.K ? g.x[f] + lvl : nullptr;
    src[4] = g.x[4] + lvl;
  } else {
    for (int f = 0; f < band_fields(M); ++f) src[f] = g.x[f] + lvl;
  }
}

// The spans of step k into stage `st` on its mbarrier `bar`, with thread 0's
// arrival (announcing the bulk copies' bytes).
template <typename T, int M>
__device__ void issue_spans(const BandArgs<T>& g, const Band& bd, int k,
                            T* st, unsigned long long* bar, bool uv_only) {
  constexpr int NF = band_fields(M);
  const int B = g.B, TA = g.rows;
  const long long slab = (long long)g.A * B;
  const T* src[NF];
  step_fields<T, M>(g, k, uv_only, src);
  const int row = B * (int)sizeof(T);
  if (threadIdx.x == 0) {
    unsigned bytes = 0;
    for (int f = 0; f < NF; ++f)
      if (src[f])
        bytes += (bd.rows + (bd.wtop >= 0) + (bd.wbot >= 0)) * row;
    if (g.copy == 16) bar_arrive_expect(bar, bytes);
    else bar_arrive(bar);
  }
  for (int f = 0; f < NF; ++f) {
    if (!src[f]) continue;
    const T* s = src[f] + blockIdx.y * slab;
    T* d = st + f * g.fs;
    copy_run(g.copy, d + bd.llo * B, s + (long long)bd.lo * B, bd.rows * row,
             bar);
    if (bd.wtop >= 0)
      copy_run(g.copy, d, s + (long long)bd.wtop * B, row, bar);
    if (bd.wbot >= 0) copy_run(g.copy, d + (TA + 1) * B, s, row, bar);
  }
}

// Edge item e of a band (cubed sphere): line d of the destination panel and
// the position on it; false where the band needs no such item.  Items: the
// bottom and top lines at the band's rows and their halo, then the left
// line (first band) and the right line (last band).
__device__ __forceinline__ bool edge_item(int e, int a0, int TA, int A,
                                          int& d, int& pos) {
  const int ncol = 2 * (TA + 2);
  if (e < ncol) {
    d = e < TA + 2 ? EDGE_BOTTOM : EDGE_BOTTOM + 1;
    pos = a0 - 1 + (e < TA + 2 ? e : e - (TA + 2));
  } else if (e < ncol + A) {
    d = EDGE_LEFT;
    pos = a0 == 0 ? e - ncol : -1;
  } else {
    d = EDGE_RIGHT;
    pos = a0 + TA == A ? e - ncol - A : -1;
  }
  return pos >= 0 && pos < A;
}

// A block's first copies: the band's inverse multiplicities (on BAR_CONST,
// with thread 0's arrival) and the spans of its first `npro` steps (and of
// U, V of level 1 for the bottom interface).
template <typename T, int M>
__device__ __forceinline__ void stage_first(const BandArgs<T>& g,
                                            const Band& bd, T* ring, T* ims,
                                            unsigned long long* bars, int k0,
                                            int npro, bool extra) {
  constexpr int NF = band_fields(M);
  const int imb = g.rows * g.B * (int)sizeof(T);
  if (threadIdx.x == 0) {
    if (g.copy == 16) bar_arrive_expect(&bars[BAR_CONST], imb);
    else bar_arrive(&bars[BAR_CONST]);
  }
  copy_run(g.copy, ims, g.imult + (blockIdx.y * g.A + bd.a0) * g.B, imb,
           &bars[BAR_CONST]);
  for (int j = 0; j < npro; ++j)
    issue_spans<T, M>(g, bd, k0 + j, ring + j * NF * g.fs, &bars[j], false);
  if (extra) issue_spans<T, M>(g, bd, 1, ring + NF * g.fs, &bars[1], true);
}

// The neighbour panels' edge lines of step k into stage `st` (cubed
// sphere), then every thread's arrival on `bar` once its copies are done.
template <typename T, bool CART, int M>
__device__ void issue_edges(const BandArgs<T>& g, const Band& bd, int k,
                            T* st, unsigned long long* bar, bool uv_only) {
  if constexpr (!CART) {
    constexpr int NF = band_fields(M);
    const int A = g.A, B = g.B, TA = g.rows;
    const T* src[NF];
    step_fields<T, M>(g, k, uv_only, src);
    for (int e = threadIdx.x; e < 2 * (TA + 2) + 2 * A; e += blockDim.x) {
      int d, pos;
      if (!edge_item(e, bd.a0, TA, A, d, pos)) continue;
      const int* link = g.table + (blockIdx.y * 4 + d) * 4;
      const int j = link[2] ? A - 1 - pos : pos;
      const int qe = link[1];
      const int na = qe == EDGE_LEFT ? 0 : (qe == EDGE_RIGHT ? A - 1 : j);
      const int nb = qe < EDGE_BOTTOM ? j : (qe == EDGE_BOTTOM ? 0 : B - 1);
      const long long off = ((long long)link[0] * A + na) * B + nb;
      for (int f = 0; f < NF; ++f)
        if (src[f])
          copy_async<sizeof(T)>(st + f * g.fs + g.span + e, src[f] + off);
    }
  }
  copies_arrive(bar);
}

// dss_uvw: raw W of the staged nodes [i0, i0 + N) of interface k: at the
// bottom from U, V of levels 0 (stage `st`) and 1 (stage `nx`) and the
// surface metric, above from the base W terms and dW.
template <typename T, int N>
__device__ __forceinline__ void raw_w(const BandArgs<T>& g, const T* st,
                                     const T* nx, int k, int i0, T* w) {
  const int fs = g.fs;
  T x1[N], x2[N], x3[N];
  load_seg<T, N>(st + 2 * fs + i0, x1, N);
  load_seg<T, N>(st + 3 * fs + i0, x2, N);
  if (k == 0) {
    T u0[N], u1[N], v0[N], v1[N];
    load_seg<T, N>(st + 4 * fs + i0, x3, N);
    load_seg<T, N>(st + i0, u0, N);
    load_seg<T, N>(nx + i0, u1, N);
    load_seg<T, N>(st + fs + i0, v0, N);
    load_seg<T, N>(nx + fs + i0, v1, N);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const T u = add_rn(mul_rn(g.c00, u0[i]), mul_rn(g.c01, u1[i]));
      const T v = add_rn(mul_rn(g.c00, v0[i]), mul_rn(g.c01, v1[i]));
      w[i] = -div_rn(add_rn(mul_rn(x1[i], u), mul_rn(x2[i], v)), x3[i]);
    }
    return;
  }
  const bool inner = k < g.K;
  if (inner) load_seg<T, N>(st + 4 * fs + i0, x3, N);
#pragma unroll
  for (int i = 0; i < N; ++i) {
    T b = g.x[3] ? add_rn(mul_rn(g.cb1, x1[i]), mul_rn(g.cb2, x2[i])) : x1[i];
    w[i] = inner ? add_rn(b, mul_rn(g.dt_s, x3[i])) : b;
  }
}

// dss_uvw: raw W of interface k, once a node, into `w` (span, then edge
// lines), four values a thread at a time where p = 4 (16-byte shared
// accesses).  Rows and line positions that were not staged give values no
// thread reads.
template <typename T, bool CART, int PP>
__device__ __forceinline__ void assemble_w(const BandArgs<T>& g, const T* st,
                                           const T* nx, int k, T* w) {
  const int n = g.span + (CART ? 0 : 2 * (g.rows + 2) + 2 * g.A);
  int i = threadIdx.x;
  if constexpr (PP == 4) {
    for (int v = threadIdx.x * 4; v < g.span; v += blockDim.x * 4) {
      T out[4];
      raw_w<T, 4>(g, st, nx, k, v, out);
      store_seg<T, 4>(w + v, out, 4);
    }
    i += g.span;
  }
  for (; i < n; i += blockDim.x) raw_w<T, 1>(g, st, nx, k, i, w + i);
}

// dss_state's Rayleigh finish of field f's segment at `o`: s <- fac * s +
// ref, the product and the sum rounded apart, fac and ref read from global
// memory (a 16-byte load a segment where g.ray == 2).
template <typename T, int PP, int NMAX>
__device__ __forceinline__ void ray_finish(const BandArgs<T>& g, int f,
                                           long long o, int p, T* s) {
  T fa[NMAX], re[NMAX];
  if (g.ray == 2) {
    load_seg<T, PP>(g.fac[f] + o, fa, p);
    load_seg<T, PP>(g.ref[f] + o, re, p);
  } else {
    for (int i = 0; i < p; ++i) {
      fa[i] = g.fac[f][o + i];
      re[i] = g.ref[f][o + i];
    }
  }
  for (int i = 0; i < p; ++i) s[i] = mul_then_add(fa[i], s[i], re[i]);
}

// The wall nodes of output field f's segment at level k: s <- 0.5 (s + h)
// with h from the halo's wall rows (zero without a halo), rounded as two
// tensor operations round them; in the state mode the result also goes to
// the field's `hout` where there is one.
template <typename T>
__device__ __forceinline__ void wall_average(const BandArgs<T>& g, int f,
                                             int k, const Seg& q, int p,
                                             T* s) {
  const T* h = g.halo[f];
  T* ho = g.hout[f];
  if (g.noflux == 1) {
    if (q.a != 0 && q.a != g.A - 1) return;
    const long long o = ((long long)k * 2 + (q.a == 0 ? 0 : 1)) * g.B + q.b0;
    for (int i = 0; i < p; ++i) {
      s[i] = mul_rn(T(0.5), add_rn(s[i], h ? h[o + i] : T(0)));
      if (ho) ho[o + i] = s[i];
    }
    return;
  }
  for (int side = 0; side < 2; ++side) {
    if (side == 0 ? q.b0 != 0 : q.b0 + p != g.B) continue;
    const int i = side == 0 ? 0 : p - 1;
    const long long o = ((long long)k * 2 + side) * g.A + q.a;
    s[i] = mul_rn(T(0.5), add_rn(s[i], h ? h[o] : T(0)));
    if (ho) ho[o] = s[i];
  }
}

// One segment of step k: pair sums from the stage `st` (dss_vector: U, V;
// dss_uvw: U, V from the stage, W from the assembled `wbuf`; dss_scalar2:
// each field as dss_scalar sums its one; dss_state: U, V as dss_vector, Rt,
// Rho and W as dss_scalar), edge terms, the inverse multiplicities `ims`,
// the no-flux walls' halo average (CART), dss_state's finish, stores.
template <typename T, bool CART, int PP, int M>
__device__ __forceinline__ void band_work(const BandArgs<T>& g, const Seg& q,
                                          const T* st, const T* wbuf,
                                          const T* ims, const T* rots, int a0,
                                          int k) {
  constexpr int NMAX = PP > 0 ? PP : MAX_P;
  const int p = PP > 0 ? PP : g.p;
  const int A = g.A, B = g.B, TA = g.rows;
  const int nedge = CART ? 0 : 2 * (TA + 2) + 2 * A;
  const long long out = (long long)k * g.P * A * B + q.out;
  const bool ray = M == M_STATE && g.ray != 0;
  T s[NMAX], w[NMAX];
  load_seg<T, PP>(ims + (q.a - a0) * B + q.b0, w, p);
  if constexpr (band_rotates(M)) {
    if (k < g.K) {
      T sv[NMAX];
      pair_sums<T, PP, NMAX>(st, q, p, s);
      pair_sums<T, PP, NMAX>(st + g.fs, q, p, sv);
      if constexpr (!CART)
        edges_vector(st + g.span, st + g.fs + g.span, rots, nedge, q, a0, TA,
                     A, p, s, sv);
      for (int i = 0; i < p; ++i) {
        s[i] = mul_rn(s[i], w[i]);
        sv[i] = mul_rn(sv[i], w[i]);
      }
      if constexpr (CART) {
        if (g.noflux) {
          wall_average(g, 0, k, q, p, s);
          wall_average(g, 1, k, q, p, sv);
        }
      }
      if (ray) {
        ray_finish<T, PP, NMAX>(g, 0, out, p, s);
        ray_finish<T, PP, NMAX>(g, 1, out, p, sv);
      }
      store_seg<T, PP>(g.out[0] + out, s, p);
      store_seg<T, PP>(g.out[1] + out, sv, p);
    }
  }
  if constexpr (M != M_VECTOR) {
    // dss_scalar: its field; dss_uvw: the assembled W; dss_scalar2: both
    // fields, one after the other; dss_state: Rt, Rho (levels only), W
    constexpr int F0 = M == M_STATE ? 2 : 0;
    constexpr int NS = M == M_STATE ? 3 : (M == M_SCALAR2 ? 2 : 1);
    for (int f = F0; f < F0 + NS; ++f) {
      if (M == M_STATE && f < 4 && k >= g.K) continue;
      const T* F = M == M_UVW ? wbuf : st + f * g.fs;
      pair_sums<T, PP, NMAX>(F, q, p, s);
      if constexpr (!CART) edges_scalar(F + g.span, q, a0, TA, A, p, s);
      for (int i = 0; i < p; ++i) s[i] = mul_rn(s[i], w[i]);
      if constexpr (CART) {
        if (g.noflux) wall_average(g, M == M_UVW ? 2 : f, k, q, p, s);
      }
      if (ray) ray_finish<T, PP, NMAX>(g, f, out, p, s);
      store_seg<T, PP>(g.out[M == M_UVW ? 2 : f] + out, s, p);
    }
  }
}

// Grid: (bands of one panel, panel, runs of `levels` steps; dss_uvw's first
// run is the bottom interface alone, whose block also stages U and V of
// level 1 into its second stage; dss_state's last run is W's top interface
// alone).  A block owns TA rows of one panel;
// thread t owns segment t (and t + blockDim, ... where a band has more
// segments than the block threads).  Before its first step a block stages
// its constants once: the link table (cubed sphere), which the edge-line
// gathers need, the band's inverse multiplicities and the (U, V) pair's
// edge rotations.
template <typename T, bool CART, int PP, int M>
__global__ void __launch_bounds__(
    BAND_THREADS, M == M_UVW || M == M_STATE ? BAND_MIN_BLOCKS_UVW
                  : M == M_VECTOR              ? BAND_MIN_BLOCKS_VECTOR
                                               : BAND_MIN_BLOCKS)
    band_kernel(const __grid_constant__ BandArgs<T> g) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  DSS_PHASE_BEGIN();
  constexpr int NF = band_fields(M);
  constexpr bool UVW = M == M_UVW;
  const int p = PP > 0 ? PP : g.p;
  const int A = g.A, B = g.B, TA = g.rows, R = g.ring;
  const int nedge = CART ? 0 : 2 * (TA + 2) + 2 * A;
  const bool top = M == M_STATE && blockIdx.z == gridDim.z - 1;
  const int z = UVW ? (int)blockIdx.z - 1 : (int)blockIdx.z;
  const int k0 = top ? g.K : (z < 0 ? 0 : z * g.levels + (UVW ? 1 : 0));
  const int nk = (z < 0 || top)
                     ? 1 : min(g.levels, (UVW ? g.K + 1 : g.K) - k0);
  unsigned long long* bars = reinterpret_cast<unsigned long long*>(smem_raw);
  T* ring = reinterpret_cast<T*>(smem_raw + BAR_BYTES);
  T* wbuf = ring + R * NF * g.fs;  // dss_uvw: the assembled W
  T* ims = ring + g.im_at;         // the band's inverse multiplicities
  T* rots = ring + g.rot_at;       // the (U, V) edge lines' rotations
  const Band bd = make_band<CART>(blockIdx.x * TA, TA, A, g.wrap);
  const int npro = min(R, nk);
  const bool extra = UVW && k0 == 0;  // the bottom interface reads U, V of
                                      // level 1 into the next stage
  if (threadIdx.x == 0) {
    for (int s = 0; s < R; ++s) bar_init(&bars[s], blockDim.x + 1);
    bar_init(&bars[BAR_CONST], blockDim.x + 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  DSS_LAP(9);
  // with bulk copies thread 0 issues the first copies before the block
  // meets, else every thread after
  const bool bulk = g.copy == 16;
  if (bulk && threadIdx.x == 0)
    stage_first<T, M>(g, bd, ring, ims, bars, k0, npro, extra);
  DSS_LAP(0);
  __syncthreads();
  DSS_LAP(1);
  if (!bulk) stage_first<T, M>(g, bd, ring, ims, bars, k0, npro, extra);
  for (int j = 0; j < npro; ++j)
    issue_edges<T, CART, M>(g, bd, k0 + j, ring + j * NF * g.fs, &bars[j],
                            false);
  if (extra)
    issue_edges<T, CART, M>(g, bd, 1, ring + NF * g.fs, &bars[1], true);
  if (band_rotates(M) && !CART && !top)
    for (int e = threadIdx.x; e < nedge; e += blockDim.x) {
      int d, pos;
      if (!edge_item(e, bd.a0, TA, A, d, pos)) continue;
      const int link = g.table[(blockIdx.y * 4 + d) * 4 + 3];
      for (int c = 0; c < 4; ++c)
        copy_async<sizeof(T)>(
            rots + c * nedge + e,
            g.rot + ((long long)c * g.nlinks + link) * A + pos);
    }
  copies_arrive(&bars[BAR_CONST]);
  DSS_LAP(2);
  const int nseg = TA * (B / p);
  Seg mine;
  if (threadIdx.x < nseg) mine = make_seg<CART, PP>(g, bd.a0, threadIdx.x);
  DSS_LAP(3);

  for (int j = 0; j < nk; ++j) {
    const int k = k0 + j, slot = j % R;
    T* st = ring + slot * NF * g.fs;
    bar_wait(&bars[slot], (j / R) & 1);
    // the bottom interface reads U, V of level 1 from the next stage
    if (UVW && k == 0) bar_wait(&bars[(j + 1) % R], ((j + 1) / R) & 1);
    if (j == 0) bar_wait(&bars[BAR_CONST], 0);
    if (j == 0) DSS_LAP(8);  // the first level's wait apart
    else DSS_LAP(4);
    if constexpr (UVW) {
      assemble_w<T, CART, PP>(g, st, ring + ((j + 1) % R) * NF * g.fs, k,
                              wbuf);
      __syncthreads();
    }
    DSS_LAP(5);
    if (threadIdx.x < nseg)
      band_work<T, CART, PP, M>(g, mine, st, wbuf, ims, rots, bd.a0, k);
    for (int s = threadIdx.x + blockDim.x; s < nseg; s += blockDim.x)
      band_work<T, CART, PP, M>(g, make_seg<CART, PP>(g, bd.a0, s), st,
                                wbuf, ims, rots, bd.a0, k);
    DSS_LAP(6);
    __syncthreads();  // the stage is read: refill it
    if (j + R < nk) {
      issue_spans<T, M>(g, bd, k + R, st, &bars[slot], false);
      issue_edges<T, CART, M>(g, bd, k + R, st, &bars[slot], false);
    }
    DSS_LAP(7);
  }
  DSS_PHASE_END();
}

template <typename T, bool CART, int PP, int M>
int launch_band_one(const BandArgs<T>& g, dim3 grid, int threads, size_t smem,
                    cudaStream_t st) {
  // opt in to more than the default 48 KB once per device
  static bool opted[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (smem > 48 * 1024 && dev < 64 && !opted[dev]) {
    const cudaError_t e = cudaFuncSetAttribute(
        band_kernel<T, CART, PP, M>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_MAX);
    if (e != cudaSuccess) return (int)e;
    opted[dev] = true;
  }
  band_kernel<T, CART, PP, M><<<grid, threads, smem, st>>>(g);
  return (int)cudaGetLastError();
}

inline bool aligned(const void* q, int bytes) {
  return q == nullptr || reinterpret_cast<unsigned long long>(q) % bytes == 0;
}

// Checks the launch shape (fast/dss_cuda.dss_launch_shape) and the copy
// width (dss_cuda.copy_width) and launches; -1 for a shape or a width the
// kernel does not take, -2 for more shared memory than a block has.
template <typename T, int M>
int launch_band(BandArgs<T> g, int threads, void* stream) {
  constexpr int NF = band_fields(M);
  constexpr bool UVW = M == M_UVW;
  constexpr int ES = sizeof(T);
  const int nsteps = band_extra_run(M) ? g.K + 1 : g.K;
  if (UVW && g.K < 2) return -1;  // the bottom row reads levels 0 and 1
  if (nsteps < 1 || g.P < 1 || g.A < 1 || g.B < 1) return 0;
  const int p = g.p, TA = g.rows;
  if (p < 2 || p > MAX_P || g.A % p || g.B % p || TA < p || TA % p ||
      g.A % TA)
    return -1;
  if (g.ring < (UVW ? 2 : 1) || g.ring > MAX_RING || g.levels < 1 ||
      threads < 32 || threads % 32 || threads > BAND_THREADS)
    return -1;
  const void* in[9] = {g.x[0], g.x[1], g.x[2], g.x[3], g.x[4],
                       g.metric[0], g.metric[1], g.metric[2], g.imult};
  if (g.copy == 16 || g.copy == 8) {
    if ((g.B * ES) % g.copy) return -1;
    for (const void* q : in)
      if (!aligned(q, g.copy)) return -1;
  } else if (g.copy != ES) {
    return -1;
  }
  for (int f = 0; f < (UVW ? 3 : NF); ++f)
    if (!aligned(g.out[f], p == 4 ? 16 : ES)) return -1;
  // dss_state's finish: both parts or neither, a segment a load where every
  // pointer allows it
  g.ray = 0;
  if (M == M_STATE && (g.fac[0] || g.ref[0])) {
    g.ray = 2;
    for (int f = 0; f < NF; ++f) {
      if (!g.fac[f] || !g.ref[f]) return -1;
      if (!aligned(g.fac[f], ES) || !aligned(g.ref[f], ES)) return -1;
      if (!aligned(g.fac[f], p == 4 ? 16 : ES) ||
          !aligned(g.ref[f], p == 4 ? 16 : ES))
        g.ray = 1;
    }
  }
  if (g.nlinks && (g.nlinks != 4 * g.P || g.P > MAX_PANELS)) return -1;
  // no-flux walls: a Cartesian grid, one axis, no wrap along it
  if (g.noflux && (g.nlinks || g.P != 1 || g.noflux > 2 ||
                   (g.wrap & g.noflux)))
    return -1;
  for (int f = 0; f < 5; ++f) {
    if (!aligned(g.halo[f], ES) || !aligned(g.hout[f], ES)) return -1;
    if (g.hout[f] && (M != M_STATE || !g.noflux)) return -1;
  }
  // the layout of BandArgs, each part rounded up to 16 bytes
  auto up = [](int n) { return (n + 16 / ES - 1) / (16 / ES) * (16 / ES); };
  const int edge = g.nlinks ? 2 * (TA + 2) + 2 * g.A : 0;
  g.span = up((TA + 2) * g.B);
  g.fs = g.span + up(edge);
  g.im_at = (g.ring * NF + (UVW ? 1 : 0)) * g.fs;
  g.rot_at = g.im_at + up(TA * g.B);
  const size_t smem =
      BAR_BYTES +
      (size_t)(g.rot_at + (band_rotates(M) ? up(4 * edge) : 0)) * ES;
  if (smem > SMEM_MAX) return -2;
  // runs of `levels` steps (dss_uvw: the bottom interface, then K steps;
  // dss_state: K steps, then W's top interface)
  const int runs =
      (g.K + g.levels - 1) / g.levels + (band_extra_run(M) ? 1 : 0);
  if (g.P > 65535 || runs > 65535) return -1;
  const dim3 grid((unsigned)(g.A / TA), (unsigned)g.P, (unsigned)runs);
  const cudaStream_t st = (cudaStream_t)stream;
  int err = 0;
  by_grid(g.nlinks, [&](auto cart) {
    constexpr bool C = decltype(cart)::value;
    err = p == 4 ? launch_band_one<T, C, 4, M>(g, grid, threads, smem, st)
                 : launch_band_one<T, C, 0, M>(g, grid, threads, smem, st);
  });
  return err;
}

// `wrap`'s bits 1 and 2 the periodic wrap (along a, along b), bits 4 and 8
// the no-flux walls (along a, along b); `walls`: null, or the halo wall rows
// of the outputs (5 pointers, null for the zero halo) and, in the state
// mode, the 5 pointers of `hout`.
template <typename T>
void set_walls(BandArgs<T>& g, int wrap, const void* const* walls) {
  g.wrap = wrap & 3;
  g.noflux = (wrap >> 2) & 3;
  for (int f = 0; f < 5; ++f) {
    g.halo[f] = walls ? (const T*)walls[f] : nullptr;
    g.hout[f] = walls ? (T*)walls[5 + f] : nullptr;
  }
}

template <typename T>
int launch_scalar(const void* x, const void* imult, const void* table,
                  void* out, int K, int P, int A, int B, int p, int nlinks,
                  int wrap, int rows, int levels, int threads, int ring,
                  int copy, const void* const* walls, void* stream) {
  BandArgs<T> g = {};
  g.x[0] = (const T*)x;
  g.out[0] = (T*)out;
  g.imult = (const T*)imult;
  if (nlinks > 0 && nlinks <= 4 * MAX_PANELS)
    for (int i = 0; i < 4 * nlinks; ++i) g.table[i] = ((const int*)table)[i];
  g.K = K; g.P = P; g.A = A; g.B = B; g.p = p; g.nlinks = nlinks;
  g.rows = rows; g.levels = levels; g.ring = ring; g.copy = copy;
  set_walls(g, wrap, walls);
  return launch_band<T, M_SCALAR>(g, threads, stream);
}

template <typename T>
int launch_uvw(const void* u, const void* v, const void* bw1, const void* bw2,
               const void* dw, const void* cax0, const void* cbx0,
               const void* cxx0, const void* imult, const void* rot,
               const void* table, void* uo, void* vo, void* wo, double dt_s,
               double cb1, double cb2, double c00, double c01, int nz, int P,
               int A, int B, int p, int nlinks, int wrap, int rows,
               int levels, int threads, int ring, int copy,
               const void* const* walls, void* stream) {
  BandArgs<T> g = {};
  const void* x[5] = {u, v, bw1, bw2, dw};
  for (int f = 0; f < 5; ++f) g.x[f] = (const T*)x[f];
  g.metric[0] = (const T*)cax0;
  g.metric[1] = (const T*)cbx0;
  g.metric[2] = (const T*)cxx0;
  g.out[0] = (T*)uo; g.out[1] = (T*)vo; g.out[2] = (T*)wo;
  g.imult = (const T*)imult;
  g.rot = (const T*)rot;
  if (nlinks > 0 && nlinks <= 4 * MAX_PANELS)
    for (int i = 0; i < 4 * nlinks; ++i) g.table[i] = ((const int*)table)[i];
  g.dt_s = (T)dt_s; g.cb1 = (T)cb1; g.cb2 = (T)cb2; g.c00 = (T)c00;
  g.c01 = (T)c01;
  g.K = nz; g.P = P; g.A = A; g.B = B; g.p = p; g.nlinks = nlinks;
  g.rows = rows; g.levels = levels; g.ring = ring; g.copy = copy;
  set_walls(g, wrap, walls);
  return launch_band<T, M_UVW>(g, threads, stream);
}

template <typename T>
int launch_scalar2(const void* x1, const void* x2, const void* imult,
                   const void* table, void* o1, void* o2, int K, int P, int A,
                   int B, int p, int nlinks, int wrap, int rows, int levels,
                   int threads, int ring, int copy,
                   const void* const* walls, void* stream) {
  BandArgs<T> g = {};
  g.x[0] = (const T*)x1;
  g.x[1] = (const T*)x2;
  g.out[0] = (T*)o1;
  g.out[1] = (T*)o2;
  g.imult = (const T*)imult;
  if (nlinks > 0 && nlinks <= 4 * MAX_PANELS)
    for (int i = 0; i < 4 * nlinks; ++i) g.table[i] = ((const int*)table)[i];
  g.K = K; g.P = P; g.A = A; g.B = B; g.p = p; g.nlinks = nlinks;
  g.rows = rows; g.levels = levels; g.ring = ring; g.copy = copy;
  set_walls(g, wrap, walls);
  return launch_band<T, M_SCALAR2>(g, threads, stream);
}

template <typename T>
int launch_vector(const void* u, const void* v, const void* imult,
                  const void* rot, const void* table, void* uo, void* vo,
                  int K, int P, int A, int B, int p, int nlinks, int wrap,
                  int rows, int levels, int threads, int ring, int copy,
                  const void* const* walls, void* stream) {
  BandArgs<T> g = {};
  g.x[0] = (const T*)u;
  g.x[1] = (const T*)v;
  g.out[0] = (T*)uo;
  g.out[1] = (T*)vo;
  g.imult = (const T*)imult;
  g.rot = (const T*)rot;
  if (nlinks > 0 && nlinks <= 4 * MAX_PANELS)
    for (int i = 0; i < 4 * nlinks; ++i) g.table[i] = ((const int*)table)[i];
  g.K = K; g.P = P; g.A = A; g.B = B; g.p = p; g.nlinks = nlinks;
  g.rows = rows; g.levels = levels; g.ring = ring; g.copy = copy;
  set_walls(g, wrap, walls);
  return launch_band<T, M_VECTOR>(g, threads, stream);
}

// ptrs: x U V Rt Rho W | fac U V Rt Rho W | ref U V Rt Rho W (all null: no
// Rayleigh finish) | out U V Rt Rho W.
template <typename T>
int launch_state(const void* const* ptrs, const void* imult, const void* rot,
                 const void* table, int nz, int P, int A, int B, int p,
                 int nlinks, int wrap, int rows, int levels, int threads,
                 int ring, int copy, const void* const* walls, void* stream) {
  BandArgs<T> g = {};
  for (int f = 0; f < 5; ++f) {
    g.x[f] = (const T*)ptrs[f];
    g.fac[f] = (const T*)ptrs[5 + f];
    g.ref[f] = (const T*)ptrs[10 + f];
    g.out[f] = (T*)ptrs[15 + f];
  }
  g.imult = (const T*)imult;
  g.rot = (const T*)rot;
  if (nlinks > 0 && nlinks <= 4 * MAX_PANELS)
    for (int i = 0; i < 4 * nlinks; ++i) g.table[i] = ((const int*)table)[i];
  g.K = nz; g.P = P; g.A = A; g.B = B; g.p = p; g.nlinks = nlinks;
  g.rows = rows; g.levels = levels; g.ring = ring; g.copy = copy;
  set_walls(g, wrap, walls);
  return launch_band<T, M_STATE>(g, threads, stream);
}

}  // namespace

extern "C" {

// table: the HOST copy of the link table (fast/dss_cuda.py's link_table),
// taken by value; wrap: the periodic wrap (1: along a, 2: along b) and the
// no-flux walls (4: along a, 8: along b); rows, levels, threads, ring: the
// launch shape (dss_launch_shape); copy: 16 (bulk copies), 8 or 4 bytes
// (cp.async); walls: null, or 10 pointers: the halo wall rows of each
// output (null: the zero halo), then (dss_state only) where to write the
// wall values before the finish (null: nowhere).
// Returns cudaGetLastError(), -1 for a shape or copy width the kernel does
// not take, -2 for more shared memory than a block has.
int dss_scalar_f32(const void* x, const void* imult, const void* table,
                   void* out, int K, int P, int A, int B, int p, int nlinks,
                   int wrap, int rows, int levels, int threads, int ring,
                   int copy, const void* const* walls, void* stream) {
  return launch_scalar<float>(x, imult, table, out, K, P, A, B, p, nlinks,
                              wrap, rows, levels, threads, ring, copy,
                              walls, stream);
}

int dss_scalar_f64(const void* x, const void* imult, const void* table,
                   void* out, int K, int P, int A, int B, int p, int nlinks,
                   int wrap, int rows, int levels, int threads, int ring,
                   int copy, const void* const* walls, void* stream) {
  return launch_scalar<double>(x, imult, table, out, K, P, A, B, p, nlinks,
                               wrap, rows, levels, threads, ring, copy,
                               walls, stream);
}

// Launch shape and returns as dss_scalar's; rot: (4, nlinks, A) rotation
// coefficients along each destination edge (unread without links).
int dss_vector_f32(const void* u, const void* v, const void* imult,
                   const void* rot, const void* table, void* uo, void* vo,
                   int K, int P, int A, int B, int p, int nlinks, int wrap,
                   int rows, int levels, int threads, int ring, int copy,
                   const void* const* walls, void* stream) {
  return launch_vector<float>(u, v, imult, rot, table, uo, vo, K, P, A, B, p,
                              nlinks, wrap, rows, levels, threads, ring, copy,
                              walls, stream);
}

int dss_vector_f64(const void* u, const void* v, const void* imult,
                   const void* rot, const void* table, void* uo, void* vo,
                   int K, int P, int A, int B, int p, int nlinks, int wrap,
                   int rows, int levels, int threads, int ring, int copy,
                   const void* const* walls, void* stream) {
  return launch_vector<double>(u, v, imult, rot, table, uo, vo, K, P, A, B,
                               p, nlinks, wrap, rows, levels, threads, ring,
                               copy, walls, stream);
}

// bw2 may be null (single base).  Launch shape and returns as dss_scalar's;
// -1 also when nz < 2.
int dss_uvw_f32(const void* u, const void* v, const void* bw1, const void* bw2,
                const void* dw, const void* cax0, const void* cbx0,
                const void* cxx0, const void* imult, const void* rot,
                const void* table, void* uo, void* vo, void* wo, double dt_s,
                double cb1, double cb2, double c00, double c01, int nz, int P,
                int A, int B, int p, int nlinks, int wrap, int rows,
                int levels, int threads, int ring, int copy,
                const void* const* walls, void* stream) {
  return launch_uvw<float>(u, v, bw1, bw2, dw, cax0, cbx0, cxx0, imult, rot,
                           table, uo, vo, wo, dt_s, cb1, cb2, c00, c01, nz, P,
                           A, B, p, nlinks, wrap, rows, levels, threads, ring,
                           copy, walls, stream);
}

int dss_uvw_f64(const void* u, const void* v, const void* bw1, const void* bw2,
                const void* dw, const void* cax0, const void* cbx0,
                const void* cxx0, const void* imult, const void* rot,
                const void* table, void* uo, void* vo, void* wo, double dt_s,
                double cb1, double cb2, double c00, double c01, int nz, int P,
                int A, int B, int p, int nlinks, int wrap, int rows,
                int levels, int threads, int ring, int copy,
                const void* const* walls, void* stream) {
  return launch_uvw<double>(u, v, bw1, bw2, dw, cax0, cbx0, cxx0, imult, rot,
                            table, uo, vo, wo, dt_s, cb1, cb2, c00, c01, nz,
                            P, A, B, p, nlinks, wrap, rows, levels, threads,
                            ring, copy, walls, stream);
}

// ptrs: the 20 pointers of launch_state (U, V, Rt, Rho have nz levels, W
// nz + 1); table, launch shape and returns as dss_scalar's.
int dss_state_f32(const void* const* ptrs, const void* imult, const void* rot,
                  const void* table, int nz, int P, int A, int B, int p,
                  int nlinks, int wrap, int rows, int levels, int threads,
                  int ring, int copy, const void* const* walls, void* stream) {
  return launch_state<float>(ptrs, imult, rot, table, nz, P, A, B, p, nlinks,
                             wrap, rows, levels, threads, ring, copy,
                             walls, stream);
}

int dss_state_f64(const void* const* ptrs, const void* imult, const void* rot,
                  const void* table, int nz, int P, int A, int B, int p,
                  int nlinks, int wrap, int rows, int levels, int threads,
                  int ring, int copy, const void* const* walls, void* stream) {
  return launch_state<double>(ptrs, imult, rot, table, nz, P, A, B, p,
                              nlinks, wrap, rows, levels, threads, ring, copy,
                              walls, stream);
}

// Two scalar fields of one shape; launch shape and returns as
// dss_scalar's.
int dss_scalar2_f32(const void* x1, const void* x2, const void* imult,
                    const void* table, void* o1, void* o2, int K, int P, int A,
                    int B, int p, int nlinks, int wrap, int rows, int levels,
                    int threads, int ring, int copy,
                    const void* const* walls, void* stream) {
  return launch_scalar2<float>(x1, x2, imult, table, o1, o2, K, P, A, B, p,
                               nlinks, wrap, rows, levels, threads, ring,
                               copy, walls, stream);
}

int dss_scalar2_f64(const void* x1, const void* x2, const void* imult,
                    const void* table, void* o1, void* o2, int K, int P, int A,
                    int B, int p, int nlinks, int wrap, int rows, int levels,
                    int threads, int ring, int copy,
                    const void* const* walls, void* stream) {
  return launch_scalar2<double>(x1, x2, imult, table, o1, o2, K, P, A, B, p,
                                nlinks, wrap, rows, levels, threads, ring,
                                copy, walls, stream);
}

}  // extern "C"
