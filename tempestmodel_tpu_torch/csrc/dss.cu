// Direct stiffness summation (DSS), one launch per field (or one for U, V and
// W together with the stage's W finish: `dss_uvw`), on the cubed sphere or on
// a periodic Cartesian grid.
//
// Replaces the TPU kernels `dss_scalar` (`_scalar_kernel`) and `dss_vector`
// (`_vector_kernel`) of tempestmodel_tpu/fast/dss_pallas.py.  Those are
// shaped by the TPU: masked rolls for the element pair sums, a flip matrix
// and a matrix-unit dot to reverse an edge line, read-modify-write of edge
// rows with a deferred flush of the lane-axis edges, z-blocks resident in
// on-chip memory.  None of that is carried over.  Here the operation is a
// GATHER: one thread per output node (k, panel, a, b), b fastest so the
// loads and the store of a warp are coalesced.  The grid is (blocks over
// one (A, B) slab, panel, blocks of 5 levels): a thread finds its node with
// one 32-bit division, works out ONCE what is the same on every level (its
// element-boundary partners, its edge links, the rotation coefficients) and
// then walks 5 consecutive levels, whose loads are independent of one
// another.  On each level a thread
//   1. forms the pair-summed value s at its own node from at most 4 raw
//      reads (the node plus its coincident copies across an element
//      boundary in a, then the same in b on the a-summed values),
//   2. if the node lies on a panel edge, adds the neighbour panel's
//      PAIR-SUMMED value at the mapped position of the coincident edge
//      (reversed where `flip`); a cube-corner node lies on two edges and
//      receives two contributions; for the covariant (U, V) pair the
//      neighbour values are rotated by the 2x2 matrix stored per link and
//      per position along the DESTINATION edge,
//   3. multiplies by the inverse multiplicity and writes a fresh output.
// No atomics and no read-modify-write: the result is the same on every run.
//
// A Cartesian grid (the TPU kernels' `wrap=True`, `_pair_masks`) is one panel
// without edge links, A and B free.  Every kernel has an instantiation for it
// (CART, launched when nlinks == 0): step 2 is compiled out (the link table is
// never read) and step 1 takes the periodic wrap-sum on the axes the `wrap`
// bits name (1: along a, 2: along b): node 0 and node A-1 (B-1) of such an
// axis are one more coincident pair.  The cubed-sphere instantiation has no
// wrap code in it: with the wrap test in one shared instantiation, the
// flagship's DSS launches took 2-6 % longer.  At the Schar slice's shapes
// ((40 | 41, 1, 4, 400), 1600 nodes a level) a launch has 13 blocks over the
// slab and 8 or 9 level blocks, far too few to fill the card: the launch, not
// the 0.5 MB it moves, sets its time.
//
// Bound on an H100 (3.35 TB/s): bytes.  The function must read each field
// once and write it once (the 2-D tables are negligible); at (30, 6, 120,
// 120) float32 that is 2 x 10.4 MB = 20.7 MB, about 6.2 us for a scalar and
// 12.4 us for the vector pair.  The extra reads of step 1-2 hit lines that
// neighbouring threads load anyway (L1/L2), so the design moves close to
// the minimum through device memory; arithmetic is a handful of adds.
//
// `dss_uvw` replaces the TPU kernel `dss_uvw` (`_uvw_kernel`) of that same
// file, dss_pallas.py: the DSS of U, V (rotated pair) and W in one launch, with the stage's
// W finish folded in.  W is never stored before its DSS: wherever the
// gather reads a raw W value (its own node, an element-boundary partner, an
// edge partner on another panel) it ASSEMBLES that value from the stage's
// outputs — base-W terms plus dt_s * dW on interior interfaces, and at
// interface 0 the diagnostic bottom value from u^xi(surface) = 0, taken from
// the post-stage pre-DSS U, V at levels 0 and 1 OF THE NODE BEING READ with
// that node's surface metric.  Inputs are never overwritten, so the order of
// blocks does not matter.  Bound: bytes (U, V, bw1[, bw2], dW read once; U,
// V, W written once): 6 or 7 fields at (30|31, 6, 120, 120) float32, about
// 64-75 MB, 19-22 us at 3.35 TB/s.
//
// `dss_state` and `dss_scalar2` replace the TPU kernels `dss_state`
// (`_state_kernel`) and `dss_scalar2` (`_scalar2_kernel`) of dss_pallas.py:
// the same gather for all five fields of the state (the (U, V) pair rotated,
// Rt, Rho and W as scalars, W with one level more) or for two scalar fields
// of one shape, in one launch.  What a thread works out once (its partners,
// its links, the rotation, the inverse multiplicity) then serves every field.
// `dss_state` can finish with the Rayleigh term form x <- fac * x + ref, read
// from ten more fields; that product and sum are rounded separately, as two
// tensor operations would round them, so the result equals the separate
// launches followed by the plain finish.  Bound: bytes (each field read once
// and written once): 104 MB at (30 | 31, 6, 120, 120) float32, 31 us (209 MB,
// 62 us with the Rayleigh finish); 41.5 MB, 12.4 us for `dss_scalar2`.
//
// Plain C interface (no PyTorch header): pointers and the stream arrive as
// integers, the launch goes to the given stream, nothing synchronises or
// allocates, and each entry point returns cudaGetLastError().

#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int EDGE_LEFT = 0, EDGE_RIGHT = 1, EDGE_BOTTOM = 2;  // EDGE_TOP = 3
// Block size and levels per thread; kernels/tune_dss.py sweeps them
// with -D flags.  (128, 5) was the fastest pair for float32 at (30, 6, 120,
// 120) on an H100.
#ifndef DSS_THREADS
#define DSS_THREADS 128
#endif
#ifndef DSS_LEVELS
#define DSS_LEVELS 5
#endif
// The same pair for dss_uvw, which holds three fields a level in registers
// and gathers W from up to four operands; kernels/tune_fused.py sweeps it.
// (128, 2) was the fastest pair at (30 | 31, 6, 120, 120) on an H100, in
// float32 and in float64.
#ifndef UVW_THREADS
#define UVW_THREADS 128
#endif
#ifndef UVW_LEVELS
#define UVW_LEVELS 2
#endif
// ... and for dss_state (five fields a level) and dss_scalar2 (two);
// kernels/tune_tail.py sweeps them.  (128, 2) and (128, 4) were the fastest
// of nine pairs in float32 at (30 | 31, 6, 120, 120) on an H100; in float64
// dss_state was 5 % faster at 1 level and dss_scalar2 10 % faster at 3.
#ifndef STATE_THREADS
#define STATE_THREADS 128
#endif
#ifndef STATE_LEVELS
#define STATE_LEVELS 2
#endif
#ifndef S2_THREADS
#define S2_THREADS 128
#endif
#ifndef S2_LEVELS
#define S2_LEVELS 4
#endif
constexpr int THREADS = DSS_THREADS;
constexpr int LEVELS = DSS_LEVELS;  // consecutive levels handled by one thread

// The raw nodes whose sum is the pair-summed value at (a, b) of one (A, B)
// panel slab, as offsets into the slab: the node itself, its coincident
// copy across an element boundary along a (o_a), along b (o_b), and the
// diagonal one (o_ab); -1 where there is none.
struct PairNodes {
  int o, o_a, o_b, o_ab;
};

// `wrap` (CART only): bit 0 pairs a = 0 with a = A-1, bit 1 b = 0 with
// b = B-1.  Without CART the wrap code is not compiled in.
template <bool CART>
__device__ __forceinline__ PairNodes pair_nodes(int a, int b, int A, int B,
                                                int p, int wrap) {
  int a2 = -1, b2 = -1;
  const int ra = a % p, rb = b % p;
  if (ra == p - 1 && a < A - 1) a2 = a + 1;
  else if (ra == 0 && a > 0) a2 = a - 1;
  else if (CART && (wrap & 1)) a2 = (a == 0) ? A - 1 : (a == A - 1) ? 0 : -1;
  if (rb == p - 1 && b < B - 1) b2 = b + 1;
  else if (rb == 0 && b > 0) b2 = b - 1;
  else if (CART && (wrap & 2)) b2 = (b == 0) ? B - 1 : (b == B - 1) ? 0 : -1;
  PairNodes n;
  n.o = a * B + b;
  n.o_a = (a2 >= 0) ? a2 * B + b : -1;
  n.o_b = (b2 >= 0) ? a * B + b2 : -1;
  n.o_ab = (a2 >= 0 && b2 >= 0) ? a2 * B + b2 : -1;
  return n;
}

// Pair-summed value: a first, then b on the a-summed values.
template <typename T>
__device__ __forceinline__ T pair_sum(const T* __restrict__ f,
                                      const PairNodes& n) {
  T s = f[n.o];
  if (n.o_a >= 0) s += f[n.o_a];
  if (n.o_b >= 0) {
    T s2 = f[n.o_b];
    if (n.o_ab >= 0) s2 += f[n.o_ab];
    s += s2;
  }
  return s;
}

// (a, b) of position j along edge `e` of a panel.
__device__ __forceinline__ void edge_node(int e, int j, int A, int B, int& a,
                                          int& b) {
  if (e == EDGE_LEFT) { a = 0; b = j; }
  else if (e == EDGE_RIGHT) { a = A - 1; b = j; }
  else if (e == EDGE_BOTTOM) { a = j; b = 0; }
  else { a = j; b = B - 1; }  // EDGE_TOP
}

// What a node on panel edges receives: at most two neighbour nodes (a cube
// corner lies on two edges), each with its panel, its pair nodes, and the
// link index and position that select the rotation coefficients.  The same
// on every level, so a thread works it out once.
struct EdgeTerms {
  int count;
  int panel[2];
  PairNodes nodes[2];
  int link[2];
  int pos[2];
};

// table[(panel * 4 + edge) * 4 + {0,1,2,3}] = neighbour panel, neighbour
// edge, flip, index of the link (row of the rotation table).  Edges are
// visited in the order of the link list (left, right, bottom, top), which
// is the plain version's order of summation.
__device__ __forceinline__ EdgeTerms edge_terms(const int* __restrict__ table,
                                                int pa, int a, int b, int A,
                                                int B, int p) {
  EdgeTerms t = {};
  const bool on_edge[4] = {a == 0, a == A - 1, b == 0, b == B - 1};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if (!on_edge[e] || t.count == 2) continue;
    const int i = (e < 2) ? b : a;  // position along the destination edge
    const int* row = table + (pa * 4 + e) * 4;
    const int j = row[2] ? (A - 1 - i) : i;
    int na, nb;
    edge_node(row[1], j, A, B, na, nb);
    // constant indices keep the struct in registers
    const int slot = t.count;
    const PairNodes nodes = pair_nodes<false>(na, nb, A, B, p, 0);
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      if (n == slot) {
        t.panel[n] = row[0];
        t.nodes[n] = nodes;
        t.link[n] = row[3];
        t.pos[n] = i;
      }
    }
    ++t.count;
  }
  return t;
}

// Grid: (blocks over one (A, B) slab, panel, blocks of LEVELS levels).
template <typename T, bool CART>
__global__ void dss_scalar_kernel(const T* __restrict__ x,
                                  const T* __restrict__ imult,
                                  const int* __restrict__ table,
                                  T* __restrict__ out, int K, int P, int A,
                                  int B, int p, int nlinks, int wrap) {
  const int node = blockIdx.x * blockDim.x + threadIdx.x;
  if (node >= A * B) return;
  const int a = node / B;
  const int b = node - a * B;
  const int pa = blockIdx.y;
  const long long slab = (long long)A * B;

  const PairNodes own = pair_nodes<CART>(a, b, A, B, p, wrap);
  const EdgeTerms et =
      CART ? EdgeTerms{} : edge_terms(table, pa, a, b, A, B, p);
  const T w = imult[pa * slab + node];

  // all the levels' loads first (a level past the end re-reads the last
  // one), then the stores: the loads of different levels overlap
  const int k0 = blockIdx.z * LEVELS;
  T s[LEVELS];
#pragma unroll
  for (int kk = 0; kk < LEVELS; ++kk) {
    const int k = min(k0 + kk, K - 1);
    const T* level = x + (long long)k * P * slab;
    s[kk] = pair_sum(level + pa * slab, own);
#pragma unroll
    for (int n = 0; n < 2; ++n)
      if (n < et.count)
        s[kk] += pair_sum(level + et.panel[n] * slab, et.nodes[n]);
  }
#pragma unroll
  for (int kk = 0; kk < LEVELS; ++kk) {
    const int k = k0 + kk;
    if (k < K) out[((long long)k * P + pa) * slab + node] = s[kk] * w;
  }
}

template <typename T, bool CART>
__global__ void dss_vector_kernel(const T* __restrict__ u,
                                  const T* __restrict__ v,
                                  const T* __restrict__ imult,
                                  const T* __restrict__ rot,
                                  const int* __restrict__ table,
                                  T* __restrict__ uo, T* __restrict__ vo,
                                  int K, int P, int A, int B, int p,
                                  int nlinks, int wrap) {
  const int node = blockIdx.x * blockDim.x + threadIdx.x;
  if (node >= A * B) return;
  const int a = node / B;
  const int b = node - a * B;
  const int pa = blockIdx.y;
  const long long slab = (long long)A * B;

  const PairNodes own = pair_nodes<CART>(a, b, A, B, p, wrap);
  const EdgeTerms et =
      CART ? EdgeTerms{} : edge_terms(table, pa, a, b, A, B, p);
  const T w = imult[pa * slab + node];
  // rot is (4, nlinks, A): [r00, r01, r10, r11] at the destination position
  T r[2][4] = {};
#pragma unroll
  for (int n = 0; n < 2; ++n) {
    if (n < et.count) {
      const long long base = (long long)et.link[n] * A + et.pos[n];
      const long long stride = (long long)nlinks * A;
#pragma unroll
      for (int c = 0; c < 4; ++c) r[n][c] = rot[base + c * stride];
    }
  }

  const int k0 = blockIdx.z * LEVELS;
  T su[LEVELS], sv[LEVELS];
#pragma unroll
  for (int kk = 0; kk < LEVELS; ++kk) {
    const int k = min(k0 + kk, K - 1);
    const long long off = (long long)k * P * slab;
    su[kk] = pair_sum(u + off + pa * slab, own);
    sv[kk] = pair_sum(v + off + pa * slab, own);
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      if (n < et.count) {
        const T lu = pair_sum(u + off + et.panel[n] * slab, et.nodes[n]);
        const T lv = pair_sum(v + off + et.panel[n] * slab, et.nodes[n]);
        su[kk] += r[n][0] * lu + r[n][1] * lv;
        sv[kk] += r[n][2] * lu + r[n][3] * lv;
      }
    }
  }
#pragma unroll
  for (int kk = 0; kk < LEVELS; ++kk) {
    const int k = k0 + kk;
    if (k < K) {
      const long long o = ((long long)k * P + pa) * slab + node;
      uo[o] = su[kk] * w;
      vo[o] = sv[kk] * w;
    }
  }
}

// The raw (pre-DSS) W of the stage finish, assembled where it is read.
template <typename T>
struct WFinish {
  const T* bw1;
  const T* bw2;  // null for a single base: W base is then bw1, unscaled
  const T* dw;
  const T* u;
  const T* v;
  const T* cax0;
  const T* cbx0;
  const T* cxx0;
  T dt_s, cb1, cb2, c00, c01;
  int nz;
  long long slab;   // A * B
  long long level;  // P * A * B

  // interface k, panel pn, node offset o inside the panel slab.  BOTTOM is
  // k == 0: a level's gathers all take the same branch, chosen once a level.
  template <bool BOTTOM>
  __device__ __forceinline__ T at(int k, int pn, int o) const {
    const long long i = (long long)pn * slab + o;
    if (BOTTOM) {
      const T u0 = c00 * u[i] + c01 * u[level + i];
      const T v0 = c00 * v[i] + c01 * v[level + i];
      return -(cax0[i] * u0 + cbx0[i] * v0) / cxx0[i];
    }
    const long long j = (long long)k * level + i;
    T w = bw2 ? cb1 * bw1[j] + cb2 * bw2[j] : bw1[j];
    if (k < nz) w += dt_s * dw[j];
    return w;
  }

  template <bool BOTTOM>
  __device__ __forceinline__ T pair_sum(int k, int pn,
                                        const PairNodes& n) const {
    T s = at<BOTTOM>(k, pn, n.o);
    if (n.o_a >= 0) s += at<BOTTOM>(k, pn, n.o_a);
    if (n.o_b >= 0) {
      T s2 = at<BOTTOM>(k, pn, n.o_b);
      if (n.o_ab >= 0) s2 += at<BOTTOM>(k, pn, n.o_ab);
      s += s2;
    }
    return s;
  }

  // the pair-summed W at the thread's own node plus its edge partners'
  template <bool BOTTOM>
  __device__ __forceinline__ T gather(int k, int pa, const PairNodes& own,
                                      const EdgeTerms& et) const {
    T s = pair_sum<BOTTOM>(k, pa, own);
#pragma unroll
    for (int n = 0; n < 2; ++n)
      if (n < et.count) s += pair_sum<BOTTOM>(k, et.panel[n], et.nodes[n]);
    return s;
  }
};

// U, V have nz levels, W nz + 1 interfaces; the grid's z blocks cover nz + 1.
template <typename T, bool CART>
__global__ void dss_uvw_kernel(WFinish<T> wf, const T* __restrict__ imult,
                               const T* __restrict__ rot,
                               const int* __restrict__ table,
                               T* __restrict__ uo, T* __restrict__ vo,
                               T* __restrict__ wo, int P, int A, int B, int p,
                               int nlinks, int wrap) {
  const int node = blockIdx.x * blockDim.x + threadIdx.x;
  if (node >= A * B) return;
  const int a = node / B;
  const int b = node - a * B;
  const int pa = blockIdx.y;
  const long long slab = wf.slab;
  const int nz = wf.nz;

  const PairNodes own = pair_nodes<CART>(a, b, A, B, p, wrap);
  const EdgeTerms et =
      CART ? EdgeTerms{} : edge_terms(table, pa, a, b, A, B, p);
  const T w = imult[pa * slab + node];
  T r[2][4] = {};
#pragma unroll
  for (int n = 0; n < 2; ++n) {
    if (n < et.count) {
      const long long base = (long long)et.link[n] * A + et.pos[n];
      const long long stride = (long long)nlinks * A;
#pragma unroll
      for (int c = 0; c < 4; ++c) r[n][c] = rot[base + c * stride];
    }
  }

  constexpr int LEVELS = UVW_LEVELS;
  const int k0 = blockIdx.z * LEVELS;
  T su[LEVELS], sv[LEVELS], sw[LEVELS];
#pragma unroll
  for (int kk = 0; kk < LEVELS; ++kk) {
    const int kw = min(k0 + kk, nz);       // interface of W
    const int k = min(k0 + kk, nz - 1);    // level of U, V
    const long long off = (long long)k * wf.level;
    su[kk] = pair_sum(wf.u + off + pa * slab, own);
    sv[kk] = pair_sum(wf.v + off + pa * slab, own);
    // only the first level of the first block can be the bottom interface
    sw[kk] = (kk == 0 && kw == 0) ? wf.template gather<true>(kw, pa, own, et)
                                  : wf.template gather<false>(kw, pa, own, et);
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      if (n < et.count) {
        const T lu = pair_sum(wf.u + off + et.panel[n] * slab, et.nodes[n]);
        const T lv = pair_sum(wf.v + off + et.panel[n] * slab, et.nodes[n]);
        su[kk] += r[n][0] * lu + r[n][1] * lv;
        sv[kk] += r[n][2] * lu + r[n][3] * lv;
      }
    }
  }
#pragma unroll
  for (int kk = 0; kk < LEVELS; ++kk) {
    const int k = k0 + kk;
    const long long o = (long long)k * wf.level + pa * slab + node;
    if (k < nz) {
      uo[o] = su[kk] * w;
      vo[o] = sv[kk] * w;
    }
    if (k <= nz) wo[o] = sw[kk] * w;
  }
}

// The pair-summed value at the thread's own node plus its edge partners'.
template <typename T>
__device__ __forceinline__ T gather_scalar(const T* __restrict__ level,
                                           long long slab, int pa,
                                           const PairNodes& own,
                                           const EdgeTerms& et) {
  T s = pair_sum(level + pa * slab, own);
#pragma unroll
  for (int n = 0; n < 2; ++n)
    if (n < et.count) s += pair_sum(level + et.panel[n] * slab, et.nodes[n]);
  return s;
}

// fac * x + ref with the product and the sum rounded separately (no fused
// multiply-add), as two tensor operations round them.
__device__ __forceinline__ float mul_then_add(float f, float x, float r) {
  return __fadd_rn(__fmul_rn(f, x), r);
}
__device__ __forceinline__ double mul_then_add(double f, double x, double r) {
  return __dadd_rn(__dmul_rn(f, x), r);
}

template <typename T>
struct StateArgs {
  const T* x[5];    // U, V, Rt, Rho, W
  const T* fac[5];  // Rayleigh factors and reference terms (RAY only)
  const T* ref[5];
  T* out[5];
};

// U, V, Rt, Rho have nz levels, W nz + 1; the grid's z blocks cover nz + 1.
template <typename T, bool RAY, bool CART>
__global__ void dss_state_kernel(StateArgs<T> g, const T* __restrict__ imult,
                                 const T* __restrict__ rot,
                                 const int* __restrict__ table, int nz, int P,
                                 int A, int B, int p, int nlinks, int wrap) {
  const int node = blockIdx.x * blockDim.x + threadIdx.x;
  if (node >= A * B) return;
  const int a = node / B;
  const int b = node - a * B;
  const int pa = blockIdx.y;
  const long long slab = (long long)A * B;
  const long long lvl = (long long)P * slab;

  const PairNodes own = pair_nodes<CART>(a, b, A, B, p, wrap);
  const EdgeTerms et =
      CART ? EdgeTerms{} : edge_terms(table, pa, a, b, A, B, p);
  const T w = imult[pa * slab + node];
  T r[2][4] = {};
#pragma unroll
  for (int n = 0; n < 2; ++n) {
    if (n < et.count) {
      const long long base = (long long)et.link[n] * A + et.pos[n];
      const long long stride = (long long)nlinks * A;
#pragma unroll
      for (int c = 0; c < 4; ++c) r[n][c] = rot[base + c * stride];
    }
  }

  constexpr int LEVELS = STATE_LEVELS;
  const int k0 = blockIdx.z * LEVELS;
  T s[5][LEVELS];
#pragma unroll
  for (int kk = 0; kk < LEVELS; ++kk) {
    const int kw = min(k0 + kk, nz);     // interface of W
    const int k = min(k0 + kk, nz - 1);  // level of the other fields
    const long long off = (long long)k * lvl;
    s[0][kk] = pair_sum(g.x[0] + off + pa * slab, own);
    s[1][kk] = pair_sum(g.x[1] + off + pa * slab, own);
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      if (n < et.count) {
        const T lu = pair_sum(g.x[0] + off + et.panel[n] * slab, et.nodes[n]);
        const T lv = pair_sum(g.x[1] + off + et.panel[n] * slab, et.nodes[n]);
        s[0][kk] += r[n][0] * lu + r[n][1] * lv;
        s[1][kk] += r[n][2] * lu + r[n][3] * lv;
      }
    }
    s[2][kk] = gather_scalar(g.x[2] + off, slab, pa, own, et);
    s[3][kk] = gather_scalar(g.x[3] + off, slab, pa, own, et);
    s[4][kk] = gather_scalar(g.x[4] + (long long)kw * lvl, slab, pa, own, et);
  }
#pragma unroll
  for (int kk = 0; kk < LEVELS; ++kk) {
    const int k = k0 + kk;
    const long long o = (long long)k * lvl + pa * slab + node;
#pragma unroll
    for (int f = 0; f < 5; ++f) {
      if (k < nz || (f == 4 && k == nz)) {
        const T x = s[f][kk] * w;
        g.out[f][o] = RAY ? mul_then_add(g.fac[f][o], x, g.ref[f][o]) : x;
      }
    }
  }
}

template <typename T, bool CART>
__global__ void dss_scalar2_kernel(const T* __restrict__ x1,
                                   const T* __restrict__ x2,
                                   const T* __restrict__ imult,
                                   const int* __restrict__ table,
                                   T* __restrict__ o1, T* __restrict__ o2,
                                   int K, int P, int A, int B, int p,
                                   int nlinks, int wrap) {
  const int node = blockIdx.x * blockDim.x + threadIdx.x;
  if (node >= A * B) return;
  const int a = node / B;
  const int b = node - a * B;
  const int pa = blockIdx.y;
  const long long slab = (long long)A * B;

  const PairNodes own = pair_nodes<CART>(a, b, A, B, p, wrap);
  const EdgeTerms et =
      CART ? EdgeTerms{} : edge_terms(table, pa, a, b, A, B, p);
  const T w = imult[pa * slab + node];

  constexpr int LEVELS = S2_LEVELS;
  const int k0 = blockIdx.z * LEVELS;
  T s1[LEVELS], s2[LEVELS];
#pragma unroll
  for (int kk = 0; kk < LEVELS; ++kk) {
    const long long off = (long long)min(k0 + kk, K - 1) * P * slab;
    s1[kk] = gather_scalar(x1 + off, slab, pa, own, et);
    s2[kk] = gather_scalar(x2 + off, slab, pa, own, et);
  }
#pragma unroll
  for (int kk = 0; kk < LEVELS; ++kk) {
    const int k = k0 + kk;
    if (k < K) {
      const long long o = ((long long)k * P + pa) * slab + node;
      o1[o] = s1[kk] * w;
      o2[o] = s2[kk] * w;
    }
  }
}

// Calls f with std::true_type for a grid without edge links (Cartesian: the
// kernels' CART instantiation) and with std::false_type otherwise, so the
// cubed sphere runs kernels without the wrap code.
template <typename F>
void by_grid(int nlinks, F f) {
  if (nlinks == 0) f(std::true_type{});
  else f(std::false_type{});
}

// ptrs: x U V Rt Rho W | fac U V Rt Rho W | ref U V Rt Rho W (both null:
// no Rayleigh finish) | out U V Rt Rho W.
template <typename T>
int launch_state(const void* const* ptrs, const void* imult, const void* rot,
                 const void* table, int nz, int P, int A, int B, int p,
                 int nlinks, int wrap, void* stream) {
  if (nz < 1) return -1;
  if (P > 0 && A > 0 && B > 0) {
    StateArgs<T> g;
    for (int f = 0; f < 5; ++f) {
      g.x[f] = (const T*)ptrs[f];
      g.fac[f] = (const T*)ptrs[5 + f];
      g.ref[f] = (const T*)ptrs[10 + f];
      g.out[f] = (T*)ptrs[15 + f];
    }
    const dim3 grid((unsigned)((A * B + STATE_THREADS - 1) / STATE_THREADS),
                    (unsigned)P,
                    (unsigned)((nz + 1 + STATE_LEVELS - 1) / STATE_LEVELS));
    const bool ray = g.fac[0] != nullptr;
    by_grid(nlinks, [&](auto cart) {
      constexpr bool C = decltype(cart)::value;
      if (ray)
        dss_state_kernel<T, true, C><<<grid, STATE_THREADS, 0,
                                       (cudaStream_t)stream>>>(
            g, (const T*)imult, (const T*)rot, (const int*)table, nz, P, A,
            B, p, nlinks, wrap);
      else
        dss_state_kernel<T, false, C><<<grid, STATE_THREADS, 0,
                                        (cudaStream_t)stream>>>(
            g, (const T*)imult, (const T*)rot, (const int*)table, nz, P, A,
            B, p, nlinks, wrap);
    });
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_scalar2(const void* x1, const void* x2, const void* imult,
                   const void* table, void* o1, void* o2, int K, int P, int A,
                   int B, int p, int nlinks, int wrap, void* stream) {
  if (K > 0 && P > 0 && A > 0 && B > 0) {
    const dim3 grid((unsigned)((A * B + S2_THREADS - 1) / S2_THREADS),
                    (unsigned)P, (unsigned)((K + S2_LEVELS - 1) / S2_LEVELS));
    by_grid(nlinks, [&](auto cart) {
      dss_scalar2_kernel<T, decltype(cart)::value>
          <<<grid, S2_THREADS, 0, (cudaStream_t)stream>>>(
              (const T*)x1, (const T*)x2, (const T*)imult, (const int*)table,
              (T*)o1, (T*)o2, K, P, A, B, p, nlinks, wrap);
    });
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_uvw(const void* u, const void* v, const void* bw1, const void* bw2,
               const void* dw, const void* cax0, const void* cbx0,
               const void* cxx0, const void* imult, const void* rot,
               const void* table, void* uo, void* vo, void* wo, double dt_s,
               double cb1, double cb2, double c00, double c01, int nz, int P,
               int A, int B, int p, int nlinks, int wrap, void* stream) {
  if (nz < 2) return -1;  // the bottom row reads levels 0 and 1
  if (P > 0 && A > 0 && B > 0) {
    WFinish<T> wf;
    wf.bw1 = (const T*)bw1;
    wf.bw2 = (const T*)bw2;
    wf.dw = (const T*)dw;
    wf.u = (const T*)u;
    wf.v = (const T*)v;
    wf.cax0 = (const T*)cax0;
    wf.cbx0 = (const T*)cbx0;
    wf.cxx0 = (const T*)cxx0;
    wf.dt_s = (T)dt_s;
    wf.cb1 = (T)cb1;
    wf.cb2 = (T)cb2;
    wf.c00 = (T)c00;
    wf.c01 = (T)c01;
    wf.nz = nz;
    wf.slab = (long long)A * B;
    wf.level = (long long)P * A * B;
    const dim3 grid((unsigned)((A * B + UVW_THREADS - 1) / UVW_THREADS),
                    (unsigned)P,
                    (unsigned)((nz + 1 + UVW_LEVELS - 1) / UVW_LEVELS));
    by_grid(nlinks, [&](auto cart) {
      dss_uvw_kernel<T, decltype(cart)::value>
          <<<grid, UVW_THREADS, 0, (cudaStream_t)stream>>>(
              wf, (const T*)imult, (const T*)rot, (const int*)table, (T*)uo,
              (T*)vo, (T*)wo, P, A, B, p, nlinks, wrap);
    });
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_scalar(const void* x, const void* imult, const void* table,
                  void* out, int K, int P, int A, int B, int p, int nlinks,
                  int wrap, void* stream) {
  if (K > 0 && P > 0 && A > 0 && B > 0) {
    const dim3 grid((unsigned)((A * B + THREADS - 1) / THREADS), (unsigned)P,
                    (unsigned)((K + LEVELS - 1) / LEVELS));
    by_grid(nlinks, [&](auto cart) {
      dss_scalar_kernel<T, decltype(cart)::value>
          <<<grid, THREADS, 0, (cudaStream_t)stream>>>(
              (const T*)x, (const T*)imult, (const int*)table, (T*)out, K, P,
              A, B, p, nlinks, wrap);
    });
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_vector(const void* u, const void* v, const void* imult,
                  const void* rot, const void* table, void* uo, void* vo,
                  int K, int P, int A, int B, int p, int nlinks, int wrap,
                  void* stream) {
  if (K > 0 && P > 0 && A > 0 && B > 0) {
    const dim3 grid((unsigned)((A * B + THREADS - 1) / THREADS), (unsigned)P,
                    (unsigned)((K + LEVELS - 1) / LEVELS));
    by_grid(nlinks, [&](auto cart) {
      dss_vector_kernel<T, decltype(cart)::value>
          <<<grid, THREADS, 0, (cudaStream_t)stream>>>(
              (const T*)u, (const T*)v, (const T*)imult, (const T*)rot,
              (const int*)table, (T*)uo, (T*)vo, K, P, A, B, p, nlinks, wrap);
    });
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int dss_scalar_f32(const void* x, const void* imult, const void* table,
                   void* out, int K, int P, int A, int B, int p, int nlinks,
                   int wrap, void* stream) {
  return launch_scalar<float>(x, imult, table, out, K, P, A, B, p, nlinks, wrap,
                           stream);
}

int dss_scalar_f64(const void* x, const void* imult, const void* table,
                   void* out, int K, int P, int A, int B, int p, int nlinks,
                   int wrap, void* stream) {
  return launch_scalar<double>(x, imult, table, out, K, P, A, B, p, nlinks, wrap,
                           stream);
}

int dss_vector_f32(const void* u, const void* v, const void* imult,
                   const void* rot, const void* table, void* uo, void* vo,
                   int K, int P, int A, int B, int p, int nlinks, int wrap,
                   void* stream) {
  return launch_vector<float>(u, v, imult, rot, table, uo, vo, K, P, A, B, p,
                              nlinks, wrap, stream);
}

int dss_vector_f64(const void* u, const void* v, const void* imult,
                   const void* rot, const void* table, void* uo, void* vo,
                   int K, int P, int A, int B, int p, int nlinks, int wrap,
                   void* stream) {
  return launch_vector<double>(u, v, imult, rot, table, uo, vo, K, P, A, B, p,
                               nlinks, wrap, stream);
}

// bw2 may be null (single base).  Returns cudaGetLastError(), or -1 when
// nz < 2.
int dss_uvw_f32(const void* u, const void* v, const void* bw1, const void* bw2,
                const void* dw, const void* cax0, const void* cbx0,
                const void* cxx0, const void* imult, const void* rot,
                const void* table, void* uo, void* vo, void* wo, double dt_s,
                double cb1, double cb2, double c00, double c01, int nz, int P,
                int A, int B, int p, int nlinks, int wrap, void* stream) {
  return launch_uvw<float>(u, v, bw1, bw2, dw, cax0, cbx0, cxx0, imult, rot,
                           table, uo, vo, wo, dt_s, cb1, cb2, c00, c01, nz, P,
                           A, B, p, nlinks, wrap, stream);
}

int dss_uvw_f64(const void* u, const void* v, const void* bw1, const void* bw2,
                const void* dw, const void* cax0, const void* cbx0,
                const void* cxx0, const void* imult, const void* rot,
                const void* table, void* uo, void* vo, void* wo, double dt_s,
                double cb1, double cb2, double c00, double c01, int nz, int P,
                int A, int B, int p, int nlinks, int wrap, void* stream) {
  return launch_uvw<double>(u, v, bw1, bw2, dw, cax0, cbx0, cxx0, imult, rot,
                            table, uo, vo, wo, dt_s, cb1, cb2, c00, c01, nz, P,
                            A, B, p, nlinks, wrap, stream);
}

// Returns cudaGetLastError(), or -1 when nz < 1.
int dss_state_f32(const void* const* ptrs, const void* imult, const void* rot,
                  const void* table, int nz, int P, int A, int B, int p,
                  int nlinks, int wrap, void* stream) {
  return launch_state<float>(ptrs, imult, rot, table, nz, P, A, B, p, nlinks,
                             wrap, stream);
}

int dss_state_f64(const void* const* ptrs, const void* imult, const void* rot,
                  const void* table, int nz, int P, int A, int B, int p,
                  int nlinks, int wrap, void* stream) {
  return launch_state<double>(ptrs, imult, rot, table, nz, P, A, B, p, nlinks,
                              wrap, stream);
}

int dss_scalar2_f32(const void* x1, const void* x2, const void* imult,
                    const void* table, void* o1, void* o2, int K, int P, int A,
                    int B, int p, int nlinks, int wrap, void* stream) {
  return launch_scalar2<float>(x1, x2, imult, table, o1, o2, K, P, A, B, p,
                               nlinks, wrap, stream);
}

int dss_scalar2_f64(const void* x1, const void* x2, const void* imult,
                    const void* table, void* o1, void* o2, int K, int P, int A,
                    int B, int p, int nlinks, int wrap, void* stream) {
  return launch_scalar2<double>(x1, x2, imult, table, o1, o2, K, P, A, B, p,
                                nlinks, wrap, stream);
}

}  // extern "C"
