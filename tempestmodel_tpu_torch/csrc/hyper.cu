// The two Laplacian passes of the nu4 hyperdiffusion tail, one launch each.
//
// Replaces the TPU kernels `nu4_pass1` and `nu4_pass2` (`_pass1_kernel`,
// tempestmodel_tpu/fast/hyper_pallas.py:85, and `_pass2_kernel`, :113; both
// reach `pl.pallas_call` at :162, through :177 and :192).  Those work on a
// (panel, 8-row A-chunk) tile with every level resident in on-chip memory,
// unroll the a-derivative as scaled adds of row slices and take the
// b-derivative as a matrix-unit product against a full (B, B) block-diagonal
// matrix.  Only the staging of whole bands on chip is carried over.
//
// A Laplacian is two derivative layers: differentiate, combine pointwise
// with the 2-D metric, take the weak derivative of the combination.  Both
// derivative matrices are element-local (no halo), and the metric is
// constant in z.  The vector part uses the 2-D Jacobian j2, the scalars (Rt,
// Rho, W) the z-constant 3-D Jacobian jl.  Pass 2 differs from pass 1 only in
// what it differentiates (the DSSed work fields), in the viscosities and in
// the store (the axpy onto the state): one kernel template with a
// compile-time flag.
//
// Bound on an H100 (3.35 TB/s): bytes.  Pass 1 reads five fields and writes
// five (151 level slabs of 6 x 120 x 120 float32 each way, 104 MB, 31 us);
// pass 2 reads ten and writes five (157 MB, 47 us); the 2-D metric adds
// 2.8 MB.  Arithmetic is about 220 flops a node and level (0.6 GFLOP, 9 us
// at the float32 rate).
//
// The one-thread-a-node kernel this one replaced ran at 39-44 % of those
// bounds.  Its phase split on the card (kernels/hyper_phases.py, float32
// flagship) found synchronous loads that only other blocks could hide (a
// level's loads and the barrier after them: 30 % of a block's cycles), pass
// 2's second dependent trip to device memory (the base fields read at the
// store: 48 % of its cycles) and the two layers' p-point sums (58 % of pass
// 1's), each term reading a tile value and a coefficient from shared
// memory: 105 shared-memory instructions a node and level in its SASS.  It
// also read the metric again for every chunk of 4 levels (from the L2: runs
// of 4 and of 16 levels here take the same time) and ran partial 32-column
// tiles.  The design here:
//   - a block owns a BAND: `rows` whole element rows (a multiple of p) and
//     `cols` columns (a multiple of p dividing B; all of B where the threads
//     allow) of one panel, and walks a RUN of `levels` levels.  In (K, P, A,
//     B) a band of full rows is one contiguous span a level.  The runs
//     split the nz + 1 steps evenly, so no run is left with a level or two;
//   - each level's spans of every input field (pass 2: the five work fields
//     and the five base fields) go into a ring of `ring` shared-memory
//     stages: one 1-D bulk copy a span (TMA, `cp.async.bulk`) on the stage's
//     mbarrier where addresses and lengths are 16-byte multiples, else
//     `cp.async` of 8 or 4 bytes completing on the same mbarrier.  A stage
//     is refilled with the level `ring` steps ahead as soon as the level
//     before it is done, so `ring` - 1 levels stay in flight;
//   - a thread owns one element-row SEGMENT: p consecutive nodes along b of
//     one row (one 16-byte shared load at p = 4 in float32).  Every
//     b-derivative and weak b-sum is a p x p product inside the thread's
//     registers, with the element matrices read as constants from the
//     kernel's arguments.  An a-derivative reads the p rows of the element
//     from shared memory, one segment load a row; the raw fields come from
//     the ring stage itself, and only J u^a (first layer) and div, curl and
//     the three scalar fluxes along a (second layer) go through tiles;
//   - the thread's p nodes of metric (8 x p values) and its column of the
//     element matrices along a stay in registers for the whole run: the
//     metric is read once a run.  A level issues about a quarter of the
//     earlier kernel's shared-memory instructions a node;
//   - two barriers a level: one publishes J u^a (and frees the previous
//     level's stage for its refill), one publishes the second layer's
//     tiles.  A tile is written only after the barrier that follows the
//     last read of its previous contents, so one set of tiles serves;
//   - the outputs go straight from registers, one 16-byte store a segment
//     at p = 4 in float32; pass 2's axpy reads the base from the stage.
// p = 4 has a compile-time instantiation; a generic one takes p up to
// MAX_P.  No atomics: the result is the same on every run.
//
// Plain C interface (no PyTorch header): the launch goes to the given
// stream, nothing synchronises or allocates, and the entry point returns
// cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int MAX_P = 8;           // nodes an element edge (generic p)
constexpr int MAX_RING = 4;
constexpr int BAR_BYTES = 64;      // the ring's mbarriers (8 bytes each)
constexpr int NT2 = 5;             // second-layer tiles: div, curl, 3 fluxes
constexpr size_t SMEM_MAX = 232448;
// Threads a block at most, and blocks of HYPER_THREADS an SM the compiler
// must allow (__launch_bounds__: caps the registers a thread) in float32
// and in float64; kernels/tune_tail.py sweeps them with -D flags.  At 2
// (128 registers) the float64 instantiations spilled.
constexpr int HYPER_THREADS = 256;
#ifndef HYPER_MIN_BLOCKS
#define HYPER_MIN_BLOCKS 2
#endif
#ifndef HYPER_MIN_BLOCKS_F64
#define HYPER_MIN_BLOCKS_F64 1
#endif

// Phase laps: kernels/hyper_phases.py compiles a copy of this file with
// them defined; here they are empty.
#ifndef HYPER_PHASES
#define HYPER_PHASE_BEGIN()
#define HYPER_LAP(i)
#define HYPER_PHASE_END()
#endif

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

template <typename T>
struct HyperArgs {
  const T* x[5];     // differentiated fields U, V, Rt, Rho, W (pass 2: work)
  const T* base[5];  // pass 2: the state the update is added to
  const T* m2d;      // (8, P, A, B): c2aa c2ab c2ba c2bb j2 1/j2 jl 1/jl
  T* out[5];
  // the element matrices, mat[m][s][i] (MAX_P x MAX_P each, zero past p):
  // out_i = sum_s mat[m][s][i] x_s is the strong (m = 0) and the weak (1)
  // derivative along a, then along b (2, 3): D[s, i] / delta, S[i, s] / delta
  T mat[4 * MAX_P * MAX_P];
  T nu_d, nu_v, dt, dtnu;  // dtnu = dt * nu_scalar
  int nz, P, A, B, p;
  int rows, cols, levels, ring, copy;  // the launch shape, the copy width
  int tile;                            // values a tile (and a stage field)
};

// p values from `src` into `v` (16-byte accesses at p = 4: the caller's
// offsets keep them aligned); zeros past p.
template <typename T, int N>
__device__ __forceinline__ void load_seg(const T* src, T (&v)[N], int p) {
  if constexpr (N == 4 && sizeof(T) == 4) {
    const float4 q = *reinterpret_cast<const float4*>(src);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else if constexpr (N == 4) {
    const double2 q0 = reinterpret_cast<const double2*>(src)[0];
    const double2 q1 = reinterpret_cast<const double2*>(src)[1];
    v[0] = q0.x; v[1] = q0.y; v[2] = q1.x; v[3] = q1.y;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = i < p ? src[i] : T(0);
  }
}
template <typename T, int N>
__device__ __forceinline__ void store_seg(T* dst, const T (&v)[N], int p) {
  if constexpr (N == 4 && sizeof(T) == 4) {
    *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (N == 4) {
    reinterpret_cast<double2*>(dst)[0] = make_double2(v[0], v[1]);
    reinterpret_cast<double2*>(dst)[1] = make_double2(v[2], v[3]);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i)
      if (i < p) dst[i] = v[i];
  }
}

// Along b, inside the segment: out_i = sum_s mat[M][s][i] x_s.
template <int M, typename T, int N>
__device__ __forceinline__ void sum_b(const HyperArgs<T>& g, const T (&x)[N],
                                      int p, T (&out)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    T acc = T(0);
#pragma unroll
    for (int s = 0; s < N; ++s)
      if (s < p) acc += g.mat[(M * MAX_P + s) * MAX_P + i] * x[s];
    out[i] = acc;
  }
}

// Along a, across the element's rows: out_i = sum_s c[s] F[s * stride + i],
// F the segment of the element's first row, c the thread's column of the
// matrix.
template <typename T, int N>
__device__ __forceinline__ void sum_a(const T* F, int stride, const T (&c)[N],
                                      int p, T (&out)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) out[i] = T(0);
#pragma unroll
  for (int s = 0; s < N; ++s) {
    if (s < p) {
      T x[N];
      load_seg<T, N>(F + s * stride, x, p);
#pragma unroll
      for (int i = 0; i < N; ++i) out[i] += c[s] * x[i];
    }
  }
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

// The band's spans of level k of every input field into stage `st` on its
// mbarrier `bar`: with bulk copies (copy == 16) lane f of the first warp
// issues field f's, lane 0 having announced the bytes; else cp.async by
// every thread and one arrival each.  Above the top level (k == nz) only W
// (and its base) exist.
template <typename T, bool PASS2>
__device__ void issue_level(const HyperArgs<T>& g, int k, int a0, int c0,
                            T* st, unsigned long long* bar) {
  constexpr int NF = PASS2 ? 10 : 5;
  const bool lev = k < g.nz;
  const long long off =
      (((long long)k * g.P + blockIdx.y) * g.A + a0) * g.B + c0;
  const bool whole = g.cols == g.B;  // the band is one contiguous span
  const int pieces = whole ? 1 : g.rows;
  const int bytes = (whole ? g.rows * g.B : g.cols) * (int)sizeof(T);
  if (g.copy == 16) {
    if (threadIdx.x == 0)
      bar_arrive_expect(bar,
                        (PASS2 ? 2 : 1) * (lev ? 5 : 1) * pieces * bytes);
    for (int f = threadIdx.x; f < NF; f += blockDim.x) {
      if (!lev && f % 5 != 4) continue;
      const T* src = (f < 5 ? g.x[f] : g.base[f - 5]) + off;
      T* dst = st + f * g.tile;
      for (int q = 0; q < pieces; ++q)
        bulk_copy(dst + q * g.cols, src + (long long)q * g.B, bytes, bar);
    }
    return;
  }
  for (int f = 0; f < NF; ++f) {
    if (!lev && f % 5 != 4) continue;
    const T* src = (f < 5 ? g.x[f] : g.base[f - 5]) + off;
    T* dst = st + f * g.tile;
    for (int q = 0; q < pieces; ++q)
      copy_span(g.copy, dst + q * g.cols, src + (long long)q * g.B, bytes);
  }
  copies_arrive(bar);
}

// Grid: (bands of one panel, panel, runs: nz + 1 steps split evenly into
// runs of at most `levels`);
// block: rows * cols / p threads, thread t owning segment t of the band;
// dynamic shared memory: the mbarriers, `ring` stages of 5 (pass 2: 10)
// field slots, the J u^a tile, the NT2 second-layer tiles.
template <typename T, int PP, bool PASS2>
__global__ void __launch_bounds__(HYPER_THREADS,
                                  sizeof(T) == 4 ? HYPER_MIN_BLOCKS
                                                 : HYPER_MIN_BLOCKS_F64)
    nu4_kernel(const __grid_constant__ HyperArgs<T> g) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  HYPER_PHASE_BEGIN();
  constexpr int N = PP > 0 ? PP : MAX_P;
  constexpr int NF = PASS2 ? 10 : 5;
  const int p = PP > 0 ? PP : g.p;
  const int TB = g.cols, R = g.ring, tile = g.tile;
  const int nsb = TB / p;                       // segments a band row
  const int r = threadIdx.x / nsb;              // the thread's band row
  const int c = (threadIdx.x - r * nsb) * p;    // its first column
  const int ia = r % p;                         // its row in the element
  const int bands_b = g.B / TB;
  const int a0 = (blockIdx.x / bands_b) * g.rows;
  const int c0 = (blockIdx.x % bands_b) * TB;
  // the runs split the nz + 1 steps evenly (at most `levels` each)
  const int steps = g.nz + 1;
  const int k0 = (int)((long long)blockIdx.z * steps / gridDim.z);
  const int nk = (int)((long long)(blockIdx.z + 1) * steps / gridDim.z) - k0;
  unsigned long long* bars = reinterpret_cast<unsigned long long*>(smem_raw);
  T* ring = reinterpret_cast<T*>(smem_raw + BAR_BYTES);
  T* t1 = ring + R * NF * tile;                 // J u^a
  T* t2 = t1 + tile;                            // div, curl, 3 fluxes
  const int own = r * TB + c;                   // the segment in a tile
  const int erow = (r - ia) * TB + c;           // the element's first row

  if (threadIdx.x == 0) {
    for (int s = 0; s < R; ++s)
      bar_init(&bars[s], g.copy == 16 ? 1 : blockDim.x);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // the segment's metric and the thread's columns of the a-matrices, once
  // a run
  T m[8][N];
  {
    const long long slab = (long long)g.A * g.B;
    const T* mp = g.m2d + (blockIdx.y * slab + (long long)(a0 + r) * g.B
                           + c0 + c);
#pragma unroll
    for (int q = 0; q < 8; ++q)
      load_seg<T, N>(mp + q * g.P * slab, m[q], p);
  }
  T da[N], wa[N];
#pragma unroll
  for (int s = 0; s < N; ++s) {
    da[s] = g.mat[(0 * MAX_P + s) * MAX_P + ia];
    wa[s] = g.mat[(1 * MAX_P + s) * MAX_P + ia];
  }
  HYPER_LAP(0);
  __syncthreads();  // the mbarriers are ready: the first levels' copies
  HYPER_LAP(1);
  for (int j = 0; j < min(R, nk); ++j)
    issue_level<T, PASS2>(g, k0 + j, a0, c0, ring + j * NF * tile,
                          &bars[j]);
  const T(&c2aa)[N] = m[0];
  const T(&c2ab)[N] = m[1];
  const T(&c2ba)[N] = m[2];
  const T(&c2bb)[N] = m[3];
  const T(&j2)[N] = m[4];
  const T(&j2inv)[N] = m[5];
  const T(&jl)[N] = m[6];
  const T(&jlinv)[N] = m[7];

  for (int j = 0; j < nk; ++j) {
    const int k = k0 + j, slot = j % R;
    const T* st = ring + slot * NF * tile;
    const bool lev = k < g.nz;  // the level fields exist (not only W)
    bar_wait(&bars[slot], (j / R) & 1);
    HYPER_LAP(2);
    // first layer, vector part: J u^a into its tile; the b-sums of J u^b
    // and u, the a-sum of v, the curl
    T djv[N], curl[N];
    if (lev) {
      T u[N], v[N], t[N], s2[N];
#pragma unroll
      for (int i = 0; i < N; ++i) u[i] = v[i] = T(0);
      load_seg<T, N>(st + own, u, p);
      load_seg<T, N>(st + tile + own, v, p);
#pragma unroll
      for (int i = 0; i < N; ++i)
        t[i] = j2[i] * (c2aa[i] * u[i] + c2ab[i] * v[i]);
      store_seg<T, N>(t1 + own, t, p);
#pragma unroll
      for (int i = 0; i < N; ++i)
        t[i] = j2[i] * (c2ba[i] * u[i] + c2bb[i] * v[i]);
      sum_b<2>(g, t, p, djv);
      sum_b<2>(g, u, p, s2);                    // du/db
      sum_a<T, N>(st + tile + erow, TB, da, p, t);  // dv/da
#pragma unroll
      for (int i = 0; i < N; ++i) curl[i] = (t[i] - s2[i]) * j2inv[i];
    }
    HYPER_LAP(3);
    __syncthreads();  // J u^a published; the previous level's stage is free
    if (j >= 1 && j - 1 + R < nk)
      issue_level<T, PASS2>(g, k - 1 + R, a0, c0,
                            ring + ((j - 1) % R) * NF * tile,
                            &bars[(j - 1) % R]);
    HYPER_LAP(4);
    // first layer, the rest: div; each scalar's gradient and its fluxes
    // (the flux along a into its tile, the weak b-sum of the flux along b
    // kept); then div and curl into their tiles with their weak b-sums
    T wdb_div[N], wdb_curl[N], wk[3][N];
#pragma unroll
    for (int f = 0; f < 3; ++f) {  // unrolled: wk stays in registers
      if (!lev && f < 2) continue;
      T x[N], ga[N], gb[N], dxa[N], dxb[N];
      const T* F = st + (2 + f) * tile;
      load_seg<T, N>(F + own, x, p);
      sum_a<T, N>(F + erow, TB, da, p, dxa);
      sum_b<2>(g, x, p, dxb);
#pragma unroll
      for (int i = 0; i < N; ++i) {
        ga[i] = jl[i] * (c2aa[i] * dxa[i] + c2ab[i] * dxb[i]);
        gb[i] = jl[i] * (c2ba[i] * dxa[i] + c2bb[i] * dxb[i]);
      }
      store_seg<T, N>(t2 + (2 + f) * tile + own, ga, p);
      sum_b<3>(g, gb, p, wk[f]);
    }
    if (lev) {
      T dju[N], dv[N];
      sum_a<T, N>(t1 + erow, TB, da, p, dju);
#pragma unroll
      for (int i = 0; i < N; ++i) dv[i] = (dju[i] + djv[i]) * j2inv[i];
      store_seg<T, N>(t2 + own, dv, p);
      store_seg<T, N>(t2 + tile + own, curl, p);
      sum_b<3>(g, dv, p, wdb_div);
      sum_b<3>(g, curl, p, wdb_curl);
    }
    HYPER_LAP(5);
    __syncthreads();  // the second layer's tiles published
    HYPER_LAP(6);
    // second layer: the weak a-sums, the update, the stores
    const long long o = (((long long)k * g.P + blockIdx.y) * g.A + a0 + r) *
                            g.B + c0 + c;
    if (lev) {
      T wda_div[N], wda_curl[N], du[N], dv[N];
      sum_a<T, N>(t2 + erow, TB, wa, p, wda_div);
      sum_a<T, N>(t2 + tile + erow, TB, wa, p, wda_curl);
      // the weak gradients carry a minus: w?_x = -(sum)
#pragma unroll
      for (int i = 0; i < N; ++i) {
        du[i] = -g.nu_d * wda_div[i] +
                g.nu_v * j2[i] * (c2ba[i] * wda_curl[i] +
                                  c2bb[i] * wdb_curl[i]);
        dv[i] = -g.nu_d * wdb_div[i] -
                g.nu_v * j2[i] * (c2aa[i] * wda_curl[i] +
                                  c2ab[i] * wdb_curl[i]);
      }
      if (PASS2) {
        T b0[N], b1[N];
        load_seg<T, N>(st + 5 * tile + own, b0, p);
        load_seg<T, N>(st + 6 * tile + own, b1, p);
#pragma unroll
        for (int i = 0; i < N; ++i) {
          du[i] = b0[i] + g.dt * du[i];
          dv[i] = b1[i] + g.dt * dv[i];
        }
      } else {
#pragma unroll
        for (int i = 0; i < N; ++i) {
          du[i] = -du[i];
          dv[i] = -dv[i];
        }
      }
      store_seg<T, N>(g.out[0] + o, du, p);
      store_seg<T, N>(g.out[1] + o, dv, p);
    }
#pragma unroll
    for (int f = 0; f < 3; ++f) {
      if (!lev && f < 2) continue;
      T w[N];
      sum_a<T, N>(t2 + (2 + f) * tile + erow, TB, wa, p, w);
#pragma unroll
      for (int i = 0; i < N; ++i)
        w[i] = -(w[i] + wk[f][i]) * jlinv[i];  // the minus of the weak div
      if (PASS2) {
        T b[N];
        load_seg<T, N>(st + (7 + f) * tile + own, b, p);
#pragma unroll
        for (int i = 0; i < N; ++i) w[i] = b[i] - g.dtnu * w[i];
      }
      store_seg<T, N>(g.out[2 + f] + o, w, p);
    }
    HYPER_LAP(7);
  }
  HYPER_PHASE_END();
}

template <typename T, int PP, bool PASS2>
int launch_one(const HyperArgs<T>& g, dim3 grid, int threads, size_t smem,
               cudaStream_t st) {
  // opt in to more than the default 48 KB once per device
  static bool opted[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (smem > 48 * 1024 && dev < 64 && !opted[dev]) {
    const cudaError_t e = cudaFuncSetAttribute(
        nu4_kernel<T, PP, PASS2>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)SMEM_MAX);
    if (e != cudaSuccess) return (int)e;
    opted[dev] = true;
  }
  nu4_kernel<T, PP, PASS2><<<grid, threads, smem, st>>>(g);
  return (int)cudaGetLastError();
}

inline bool aligned(const void* q, int bytes) {
  return q == nullptr || reinterpret_cast<unsigned long long>(q) % bytes == 0;
}

// ptrs: x U V Rt Rho W | base U V Rt Rho W (null in pass 1) | m2d |
// out U V Rt Rho W.  scal: nu_d nu_v dt dt*nu_s, then the element matrices
// as hyper_cuda.hyper_statics lays them out (4 p x p: D[s, i] / delta, then
// S[i, s] / delta, along a, then along b).  ints: nz P A B p pass2 rows
// cols levels ring copy (fast/hyper_cuda.hyper_launch_shape, copy_width).
// Returns cudaGetLastError(), -1 for a shape or a copy width the kernel
// does not take, -2 for more shared memory than a block has.
template <typename T>
int launch_nu4(const void* const* ptrs, const double* scal, const int* ints,
               void* stream) {
  constexpr int ES = sizeof(T);
  HyperArgs<T> g = {};
  for (int f = 0; f < 5; ++f) {
    g.x[f] = (const T*)ptrs[f];
    g.base[f] = (const T*)ptrs[5 + f];
    g.out[f] = (T*)ptrs[11 + f];
  }
  g.m2d = (const T*)ptrs[10];
  g.nu_d = (T)scal[0];
  g.nu_v = (T)scal[1];
  g.dt = (T)scal[2];
  g.dtnu = (T)scal[3];
  g.nz = ints[0]; g.P = ints[1]; g.A = ints[2]; g.B = ints[3]; g.p = ints[4];
  const bool pass2 = ints[5] != 0;
  g.rows = ints[6]; g.cols = ints[7]; g.levels = ints[8]; g.ring = ints[9];
  g.copy = ints[10];
  const int p = g.p, TA = g.rows, TB = g.cols;
  if (g.nz < 1 || g.P < 1 || p < 1 || p > MAX_P || g.A % p || g.B % p ||
      TA < p || TA % p || g.A % TA || TB < p || TB % p || g.B % TB)
    return -1;
  const int threads = TA * (TB / p);
  // a stage is refilled once the level before it is done: runs of two
  // levels or more need two stages
  if (threads > HYPER_THREADS || g.levels < 1 || g.ring < 1 ||
      g.ring > MAX_RING || (g.levels > 1 && g.ring < 2))
    return -1;
  for (int f = 0; f < 5; ++f)
    if (!g.x[f] || !g.out[f] || (pass2 != (g.base[f] != nullptr))) return -1;
  if (!g.m2d) return -1;
  const void* in[10] = {g.x[0], g.x[1], g.x[2], g.x[3], g.x[4],
                        g.base[0], g.base[1], g.base[2], g.base[3],
                        g.base[4]};
  if (g.copy == 16 || g.copy == 8) {
    if ((g.B * ES) % g.copy || (TB * ES) % g.copy) return -1;
    for (const void* q : in)
      if (!aligned(q, g.copy)) return -1;
  } else if (g.copy != ES) {
    return -1;
  }
  // segment accesses: 16 bytes at p = 4 (the metric and the outputs)
  const int seg = p == 4 ? 16 : ES;
  if (!aligned(g.m2d, seg)) return -1;
  for (int f = 0; f < 5; ++f)
    if (!aligned(g.out[f], seg)) return -1;
  for (int m = 0; m < 4; ++m)
    for (int s = 0; s < p; ++s)
      for (int i = 0; i < p; ++i) {
        const double* q = scal + 4 + m * p * p;
        // mat[m][s][i]: D[s, i] as stored, S[i, s] transposed
        g.mat[(m * MAX_P + s) * MAX_P + i] =
            (T)(m % 2 == 0 ? q[s * p + i] : q[i * p + s]);
      }
  // a tile (and a stage's field slot) rounded up to 16 bytes
  g.tile = (TA * TB + 16 / ES - 1) / (16 / ES) * (16 / ES);
  const size_t smem =
      BAR_BYTES +
      (size_t)((pass2 ? 10 : 5) * g.ring + 1 + NT2) * g.tile * ES;
  if (smem > SMEM_MAX) return -2;
  const long long bands = (long long)(g.A / TA) * (g.B / TB);
  const int runs = (g.nz + 1 + g.levels - 1) / g.levels;
  if (bands > 0x7fffffffLL || g.P > 65535 || runs > 65535) return -1;
  const dim3 grid((unsigned)bands, (unsigned)g.P, (unsigned)runs);
  const cudaStream_t st = (cudaStream_t)stream;
  if (p == 4)
    return pass2 ? launch_one<T, 4, true>(g, grid, threads, smem, st)
                 : launch_one<T, 4, false>(g, grid, threads, smem, st);
  return pass2 ? launch_one<T, 0, true>(g, grid, threads, smem, st)
               : launch_one<T, 0, false>(g, grid, threads, smem, st);
}

}  // namespace

extern "C" {

int nu4_f32(const void* const* ptrs, const double* scal, const int* ints,
            void* stream) {
  return launch_nu4<float>(ptrs, scal, ints, stream);
}

int nu4_f64(const void* const* ptrs, const double* scal, const int* ints,
            void* stream) {
  return launch_nu4<double>(ptrs, scal, ints, stream);
}

}  // extern "C"
