// The two Laplacian passes of the nu4 hyperdiffusion tail, one launch each.
//
// Replaces the TPU kernels `nu4_pass1` and `nu4_pass2` (`_pass1_kernel`,
// `_pass2_kernel`) of tempestmodel_tpu/fast/hyper_pallas.py.  Those work on a
// (panel, 8-row A-chunk) tile with every level resident in on-chip memory,
// unroll the a-derivative as scaled adds of row slices and take the
// b-derivative as a matrix-unit product against a full (B, B) block-diagonal
// matrix.  None of that is carried over.  The operation is purely horizontal
// and both derivative matrices are element-local, so here:
//   - a block owns a tile of whole elements (TA x TB nodes, b fastest, a warp
//     on one row of the tile so loads and stores are coalesced) and a chunk
//     of HYPER_LEVELS levels; a thread owns one node, keeps that node's eight
//     2-D metric values in registers and walks the chunk's levels;
//   - a Laplacian is two derivative layers (differentiate, combine pointwise,
//     take the weak derivative of the combination), and the second layer
//     needs the first layer's results of the whole element.  All five fields
//     go through the layers together, so a level costs two barriers: every
//     thread writes its 7 pointwise inputs (J*u^a, J*u^b, v, u, Rt, Rho, W)
//     into shared-memory tiles; barrier; it takes the p-point sums along a
//     and b from the tiles (D and S over the element width sit in shared
//     memory too), forms div, curl and the three flux pairs and writes those
//     8 values into a second set of tiles; barrier; it takes the weak p-point
//     sums of those and stores its five outputs.  The two tile sets alternate,
//     so no third barrier is needed before the next level;
//   - the b-derivative is the same element-local p-point sum as the
//     a-derivative, read along the tile's row, with the element matrices
//     over the element width along b (it differs from the one along a on a
//     Cartesian grid);
//   - W has one level more than the other fields: the chunks cover nz + 1
//     levels and the four level fields are skipped on the last (the test is
//     uniform over the block);
//   - pass 2 differs from pass 1 only in what it differentiates (the DSSed
//     work fields), in the viscosities and in the store (the axpy onto the
//     state, whose five fields it reads at the store): one kernel template
//     with a compile-time flag.
// The vector part uses the 2-D Jacobian j2, the scalars the z-constant 3-D
// Jacobian jl.
//
// Bound on an H100 (3.35 TB/s): bytes.  Pass 1 reads five fields and writes
// five (151 level slabs of 6 x 120 x 120 float32 each way, 104 MB, 31 us);
// pass 2 reads ten and writes five (157 MB, 47 us); the 2-D metric adds
// 2.8 MB.  Arithmetic is about 220 flops a node and level (0.6 GFLOP, 9 us
// at the float32 rate).
//
// Plain C interface (no PyTorch header): the launch goes to the given
// stream, nothing synchronises or allocates, and the entry point returns
// cudaGetLastError().

#include <cuda_runtime.h>

#include <algorithm>

namespace {

// Levels walked by one block and the tile's target extents along a and b
// (whole elements: the launch rounds them to multiples of p);
// kernels/tune_tail.py sweeps them with -D flags.  (4, 4, 32) was the fastest
// of nine at (30 | 31, 6, 120, 120), p = 4, on an H100 in float32 and in
// float64; 8 levels cost 4-8 % more, 8 rows along a or 64 columns 10-20 %.
#ifndef HYPER_LEVELS
#define HYPER_LEVELS 4
#endif
#ifndef HYPER_TILE_A
#define HYPER_TILE_A 4
#endif
#ifndef HYPER_TILE_B
#define HYPER_TILE_B 32
#endif
constexpr int NIN = 7;     // tiles of the first layer's inputs
constexpr int NMID = 8;    // tiles of the second layer's inputs

template <typename T>
struct HyperArgs {
  const T* x[5];     // differentiated fields U, V, Rt, Rho, W (pass 2: work)
  const T* base[5];  // pass 2: the state the update is added to
  const T* m2d;      // (8, P, A, B): c2aa c2ab c2ba c2bb j2 1/j2 jl 1/jl
  const T* ds;       // D[s, i] / delta, then S[i, s] / delta: along a, then b
  T* out[5];
  T nu_d, nu_v, dt, dtnu;  // dtnu = dt * nu_scalar
  int nz, P, A, B, p, TA, TB;
};

// Grid: (tiles of one panel, panel, chunks of HYPER_LEVELS levels); block:
// TA * TB threads; dynamic shared memory: D, S along a and along b, then
// NIN + NMID tiles.
template <typename T, bool PASS2>
__global__ void nu4_kernel(const HyperArgs<T> g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Dd = reinterpret_cast<T*>(smem_raw);  // Dd[s * p + i] = D[s, i] / delta
  const int nz = g.nz, p = g.p, A = g.A, B = g.B, TA = g.TA, TB = g.TB;
  T* Sd = Dd + p * p;                      // Sd[i * p + s] = S[i, s] / delta
  T* Ddb = Sd + p * p;                     // the same over the width along b
  T* Sdb = Ddb + p * p;
  const int nthreads = TA * TB;
  const int tid = threadIdx.x;
  for (int i = tid; i < 4 * p * p; i += nthreads) Dd[i] = g.ds[i];
  T* tile = Sdb + p * p;
  // first layer's inputs
  T* s_ju = tile;                  // j2 * u^a
  T* s_jv = tile + nthreads;       // j2 * u^b
  T* s_v = tile + 2 * nthreads;
  T* s_u = tile + 3 * nthreads;
  T* s_f = tile + 4 * nthreads;    // Rt, Rho, W: 3 tiles
  // second layer's inputs
  T* s_div = tile + NIN * nthreads;
  T* s_curl = s_div + nthreads;
  T* s_ga = s_div + 2 * nthreads;  // 3 tiles
  T* s_gb = s_div + 5 * nthreads;  // 3 tiles

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

  const T c2aa = g.m2d[col], c2ab = g.m2d[level + col];
  const T c2ba = g.m2d[2 * level + col], c2bb = g.m2d[3 * level + col];
  const T j2 = g.m2d[4 * level + col], j2inv = g.m2d[5 * level + col];
  const T jl = g.m2d[6 * level + col], jlinv = g.m2d[7 * level + col];
  __syncthreads();

  const int k0 = blockIdx.z * HYPER_LEVELS;
  const int k1 = min(nz + 1, k0 + HYPER_LEVELS);
  for (int k = k0; k < k1; ++k) {
    const bool lev = k < nz;  // the level fields exist here (not only W)
    const int f0 = lev ? 0 : 2;  // first scalar handled on this level
    const long long o = (long long)k * level + col;
    if (active) {
      if (lev) {
        const T u = g.x[0][o], v = g.x[1][o];
        s_ju[tid] = j2 * (c2aa * u + c2ab * v);
        s_jv[tid] = j2 * (c2ba * u + c2bb * v);
        s_v[tid] = v;
        s_u[tid] = u;
        s_f[tid] = g.x[2][o];
        s_f[nthreads + tid] = g.x[3][o];
      }
      s_f[2 * nthreads + tid] = g.x[4][o];
    }
    __syncthreads();
    if (active) {
      T dju = T(0), djv = T(0), dv_da = T(0), du_db = T(0);
      T fa[3] = {T(0), T(0), T(0)}, fb[3] = {T(0), T(0), T(0)};
      for (int s = 0; s < p; ++s) {
        const int na = (ea0 + s) * TB + tx;  // node s of the element along a
        const int nb = ty * TB + eb0 + s;    // ... along b
        const T da = Dd[s * p + ia], db = Ddb[s * p + ib];
        if (lev) {
          dju += da * s_ju[na];
          djv += db * s_jv[nb];
          dv_da += da * s_v[na];
          du_db += db * s_u[nb];
        }
#pragma unroll
        for (int f = 0; f < 3; ++f) {
          if (f >= f0) {
            fa[f] += da * s_f[f * nthreads + na];
            fb[f] += db * s_f[f * nthreads + nb];
          }
        }
      }
      if (lev) {
        s_div[tid] = (dju + djv) * j2inv;
        s_curl[tid] = (dv_da - du_db) * j2inv;
      }
#pragma unroll
      for (int f = 0; f < 3; ++f) {
        if (f >= f0) {
          s_ga[f * nthreads + tid] = jl * (c2aa * fa[f] + c2ab * fb[f]);
          s_gb[f * nthreads + tid] = jl * (c2ba * fa[f] + c2bb * fb[f]);
        }
      }
    }
    __syncthreads();
    if (active) {
      T wda_div = T(0), wdb_div = T(0), wda_curl = T(0), wdb_curl = T(0);
      T wk[3] = {T(0), T(0), T(0)};
      for (int s = 0; s < p; ++s) {
        const int na = (ea0 + s) * TB + tx;
        const int nb = ty * TB + eb0 + s;
        const T sa = Sd[ia * p + s], sb = Sdb[ib * p + s];
        if (lev) {
          wda_div += sa * s_div[na];
          wdb_div += sb * s_div[nb];
          wda_curl += sa * s_curl[na];
          wdb_curl += sb * s_curl[nb];
        }
#pragma unroll
        for (int f = 0; f < 3; ++f)
          if (f >= f0)
            wk[f] += sa * s_ga[f * nthreads + na] + sb * s_gb[f * nthreads + nb];
      }
      if (lev) {
        // the weak gradients carry a minus: w?_x = -(sum)
        const T du = -g.nu_d * wda_div +
                     g.nu_v * j2 * (c2ba * wda_curl + c2bb * wdb_curl);
        const T dv = -g.nu_d * wdb_div -
                     g.nu_v * j2 * (c2aa * wda_curl + c2ab * wdb_curl);
        if (PASS2) {
          g.out[0][o] = g.base[0][o] + g.dt * du;
          g.out[1][o] = g.base[1][o] + g.dt * dv;
        } else {
          g.out[0][o] = -du;
          g.out[1][o] = -dv;
        }
      }
#pragma unroll
      for (int f = 0; f < 3; ++f) {
        if (f >= f0) {
          const T lap = -wk[f] * jlinv;  // the minus of the weak divergence
          if (PASS2) g.out[2 + f][o] = g.base[2 + f][o] - g.dtnu * lap;
          else g.out[2 + f][o] = lap;
        }
      }
    }
  }
}

// ptrs: x U V Rt Rho W | base U V Rt Rho W (null in pass 1) | m2d | ds |
// out U V Rt Rho W.  scal: nu_d nu_v dt dt*nu_s.  ints: nz P A B p pass2.
// Returns cudaGetLastError(), -1 for shapes the kernel does not take, -2 if
// the tiles exceed the default shared-memory limit.
template <typename T>
int launch_nu4(const void* const* ptrs, const double* scal, const int* ints,
               void* stream) {
  HyperArgs<T> g;
  for (int f = 0; f < 5; ++f) {
    g.x[f] = (const T*)ptrs[f];
    g.base[f] = (const T*)ptrs[5 + f];
    g.out[f] = (T*)ptrs[12 + f];
  }
  g.m2d = (const T*)ptrs[10];
  g.ds = (const T*)ptrs[11];
  g.nu_d = (T)scal[0];
  g.nu_v = (T)scal[1];
  g.dt = (T)scal[2];
  g.dtnu = (T)scal[3];
  g.nz = ints[0];
  g.P = ints[1];
  g.A = ints[2];
  g.B = ints[3];
  g.p = ints[4];
  const bool pass2 = ints[5] != 0;
  const int p = g.p;
  if (g.nz < 1 || g.P < 1 || p < 1 || p > 8 || g.A < p || g.B < p ||
      g.A % p != 0 || g.B % p != 0)
    return -1;
  g.TB = std::min(g.B, std::max(1, HYPER_TILE_B / p) * p);
  g.TA = std::min(g.A, std::max(1, HYPER_TILE_A / p) * p);
  const int nthreads = g.TA * g.TB;
  const size_t smem =
      sizeof(T) * (4 * p * p + (size_t)(NIN + NMID) * nthreads);
  if (nthreads > 1024 || smem > 48 * 1024) return -2;
  const unsigned tiles = (unsigned)(((g.A + g.TA - 1) / g.TA) *
                                    ((g.B + g.TB - 1) / g.TB));
  const dim3 grid(tiles, (unsigned)g.P,
                  (unsigned)((g.nz + 1 + HYPER_LEVELS - 1) / HYPER_LEVELS));
  if (pass2)
    nu4_kernel<T, true><<<grid, nthreads, smem, (cudaStream_t)stream>>>(g);
  else
    nu4_kernel<T, false><<<grid, nthreads, smem, (cudaStream_t)stream>>>(g);
  return (int)cudaGetLastError();
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
