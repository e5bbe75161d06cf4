// Batched no-pivot banded LU solve with R right-hand sides that share the
// band matrix of their column: one elimination per column, R substitutions.
//
// Replaces the TPU kernel `banded_solve_multi_pallas` (`_banded_multi_kernel`)
// of tempestmodel_tpu/ops/pallas_banded.py (the implicit vertical tracer
// update: every species of a column has the same matrix).  That kernel holds
// a 512-column tile with its U-factor and the forward solutions in on-chip
// memory and pads the column count to the tile.  Here, as in banded.cu: ONE
// THREAD PER COLUMN, the column axis minor in `bands (n, 2q+1, ncol)`,
// `rhs (n, R, ncol)` and `out (n, R, ncol)`, so every access of a warp is
// coalesced; the half-bandwidth Q is a template parameter (1..8); the ragged
// last block is masked and nothing is padded.
//
// Row i is eliminated once: its Q multipliers are formed, the U row goes to
// the scratch tensor `ufac (n, q+1, ncol)`, and then each right-hand side is
// updated with the same multipliers.  The forward solutions are parked in
// `out`, which the back substitution overwrites row by row from the bottom,
// so `ufac` is the only scratch.
//
// R is a run-time size.  The sliding windows of the last Q forward solutions
// and of the next Q solutions hold Q x R values, which registers can hold
// only for an R known at compile time.  Two forms, chosen at the launch:
//   RT > 0  (R == RT, instantiated for R = 1..4 at Q <= 4): both windows
//           slide through registers, as in banded.cu;
//   RT == 0 (any R): the windows are read back from `out`, where this very
//           thread wrote them a few rows ago (at most Q * R values a column
//           behind the front, which the L2 holds at any realistic width).
// Both forms do the same arithmetic in the same order.
//
// Bound on an H100 (3.35 TB/s): bytes.  The function must read bands and rhs
// once and write out once: at n = 30, q = 1, R = 3, ncol = 86 400, float32
// that is 3 x 31.1 MB = 93.3 MB, about 0.028 ms; this design adds a write and
// a read of the U-factor (2 x 20.7 MB) and a second pass over `out`
// (31.1 MB read, 31.1 MB written again), about 0.03 ms more.  Arithmetic is
// about 30 flops per row and column (0.08 GFLOP, microseconds).
//
// Plain C interface (no PyTorch header): the launch goes to the given
// stream, nothing synchronises or allocates, and the entry point returns
// cudaGetLastError().

#include <cuda_runtime.h>

namespace {

// threads a block; kernels/tune_fused.py sweeps it with a -D flag
#ifndef BANDED_MULTI_THREADS
#define BANDED_MULTI_THREADS 128
#endif
constexpr int THREADS = BANDED_MULTI_THREADS;
constexpr int MAX_WINDOW_Q = 4;  // register windows are instantiated for
constexpr int MAX_WINDOW_R = 4;  // Q and R up to these

template <typename T, int Q, int RT>
__global__ void banded_multi_kernel(const T* __restrict__ bands,
                                    const T* __restrict__ rhs, T* out,
                                    T* __restrict__ ufac, int n, int R,
                                    long long ncol) {
  const long long col = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= ncol) return;
  constexpr int NB = 2 * Q + 1;
  constexpr int RW = RT > 0 ? RT : 1;  // extent of the register windows
  const long long rstride = (long long)R * ncol;  // one row of rhs / out

  // the last Q U-rows (u_prev[Q-1] is the newest); before row 0 stand
  // identity rows, whose multipliers are zero band entries
  T u_prev[Q][Q + 1];
  T y_prev[Q][RW];
#pragma unroll
  for (int t = 0; t < Q; ++t) {
    u_prev[t][0] = T(1);
#pragma unroll
    for (int j = 1; j <= Q; ++j) u_prev[t][j] = T(0);
#pragma unroll
    for (int r = 0; r < RW; ++r) y_prev[t][r] = T(0);
  }

  for (int i = 0; i < n; ++i) {
    T w[NB];
    const T* row = bands + (long long)i * NB * ncol + col;
#pragma unroll
    for (int d = 0; d < NB; ++d) w[d] = row[(long long)d * ncol];
    T f[Q];
#pragma unroll
    for (int t = 0; t < Q; ++t) {
      // eliminate column i-Q+t with U row i-Q+t
      f[t] = w[t] / u_prev[t][0];
#pragma unroll
      for (int j = 1; j <= Q; ++j) w[t + j] -= f[t] * u_prev[t][j];
    }
    T* urow = ufac + (long long)i * (Q + 1) * ncol + col;
#pragma unroll
    for (int j = 0; j <= Q; ++j) urow[(long long)j * ncol] = w[Q + j];
#pragma unroll
    for (int t = 0; t + 1 < Q; ++t) {
#pragma unroll
      for (int j = 0; j <= Q; ++j) u_prev[t][j] = u_prev[t + 1][j];
    }
#pragma unroll
    for (int j = 0; j <= Q; ++j) u_prev[Q - 1][j] = w[Q + j];

    // the same multipliers for every right-hand side
    const T* rin = rhs + (long long)i * rstride + col;
    T* yout = out + (long long)i * rstride + col;
    if constexpr (RT > 0) {
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        T y = rin[(long long)r * ncol];
#pragma unroll
        for (int t = 0; t < Q; ++t) y -= f[t] * y_prev[t][r];
        yout[(long long)r * ncol] = y;
#pragma unroll
        for (int t = 0; t + 1 < Q; ++t) y_prev[t][r] = y_prev[t + 1][r];
        y_prev[Q - 1][r] = y;
      }
    } else {
      for (int r = 0; r < R; ++r) {
        T y = rin[(long long)r * ncol];
#pragma unroll
        for (int t = 0; t < Q; ++t) {
          const int ip = i - Q + t;  // f[t] is zero for a row before row 0
          if (ip >= 0)
            y -= f[t] * out[(long long)ip * rstride + (long long)r * ncol + col];
        }
        yout[(long long)r * ncol] = y;
      }
    }
  }

  // back substitution, in place on `out`; x_next[d] = x[i + 1 + d], zero
  // beyond the last row
  T x_next[Q][RW];
#pragma unroll
  for (int d = 0; d < Q; ++d) {
#pragma unroll
    for (int r = 0; r < RW; ++r) x_next[d][r] = T(0);
  }
  for (int i = n - 1; i >= 0; --i) {
    const T* urow = ufac + (long long)i * (Q + 1) * ncol + col;
    T u[Q + 1];
#pragma unroll
    for (int j = 0; j <= Q; ++j) u[j] = urow[(long long)j * ncol];
    T* xrow = out + (long long)i * rstride + col;
    if constexpr (RT > 0) {
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        T acc = xrow[(long long)r * ncol];
#pragma unroll
        for (int d = 0; d < Q; ++d) acc -= u[d + 1] * x_next[d][r];
        const T xi = acc / u[0];
        xrow[(long long)r * ncol] = xi;
#pragma unroll
        for (int d = Q - 1; d > 0; --d) x_next[d][r] = x_next[d - 1][r];
        x_next[0][r] = xi;
      }
    } else {
      for (int r = 0; r < R; ++r) {
        T acc = xrow[(long long)r * ncol];
#pragma unroll
        for (int d = 0; d < Q; ++d) {
          const int in = i + 1 + d;  // u[d + 1] is zero beyond the last row
          if (in < n)
            acc -= u[d + 1] *
                   out[(long long)in * rstride + (long long)r * ncol + col];
        }
        xrow[(long long)r * ncol] = acc / u[0];
      }
    }
  }
}

template <typename T, int Q, int RT>
void launch_qr(const void* bands, const void* rhs, void* out, void* ufac,
               int n, int R, long long ncol, cudaStream_t stream) {
  const unsigned blocks = (unsigned)((ncol + THREADS - 1) / THREADS);
  banded_multi_kernel<T, Q, RT><<<blocks, THREADS, 0, stream>>>(
      (const T*)bands, (const T*)rhs, (T*)out, (T*)ufac, n, R, ncol);
}

// the register-window form where it is instantiated and asked for, else
// the read-back form
template <typename T, int Q>
void launch_q(const void* bands, const void* rhs, void* out, void* ufac,
              int n, int R, long long ncol, bool window,
              cudaStream_t stream) {
  if constexpr (Q <= MAX_WINDOW_Q) {
    if (window && R <= MAX_WINDOW_R) {
      switch (R) {
        case 1: launch_qr<T, Q, 1>(bands, rhs, out, ufac, n, R, ncol, stream); return;
        case 2: launch_qr<T, Q, 2>(bands, rhs, out, ufac, n, R, ncol, stream); return;
        case 3: launch_qr<T, Q, 3>(bands, rhs, out, ufac, n, R, ncol, stream); return;
        case 4: launch_qr<T, Q, 4>(bands, rhs, out, ufac, n, R, ncol, stream); return;
      }
    }
  }
  launch_qr<T, Q, 0>(bands, rhs, out, ufac, n, R, ncol, stream);
}

// Returns cudaGetLastError(), or -1 for a bandwidth outside 1..8 or R < 1.
// `window`: 0 forces the read-back form (kernels/tune_fused.py times both).
template <typename T>
int launch(const void* bands, const void* rhs, void* out, void* ufac, int n,
           int R, long long ncol, int q, int window, void* stream_) {
  cudaStream_t stream = (cudaStream_t)stream_;
  if (R < 1) return -1;
  const bool win = window != 0;
  if (n > 0 && ncol > 0) {
    switch (q) {
      case 1: launch_q<T, 1>(bands, rhs, out, ufac, n, R, ncol, win, stream); break;
      case 2: launch_q<T, 2>(bands, rhs, out, ufac, n, R, ncol, win, stream); break;
      case 3: launch_q<T, 3>(bands, rhs, out, ufac, n, R, ncol, win, stream); break;
      case 4: launch_q<T, 4>(bands, rhs, out, ufac, n, R, ncol, win, stream); break;
      case 5: launch_q<T, 5>(bands, rhs, out, ufac, n, R, ncol, win, stream); break;
      case 6: launch_q<T, 6>(bands, rhs, out, ufac, n, R, ncol, win, stream); break;
      case 7: launch_q<T, 7>(bands, rhs, out, ufac, n, R, ncol, win, stream); break;
      case 8: launch_q<T, 8>(bands, rhs, out, ufac, n, R, ncol, win, stream); break;
      default: return -1;
    }
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int banded_solve_multi_f32(const void* bands, const void* rhs, void* out,
                           void* ufac, int n, int R, long long ncol, int q,
                           int window, void* stream) {
  return launch<float>(bands, rhs, out, ufac, n, R, ncol, q, window, stream);
}

int banded_solve_multi_f64(const void* bands, const void* rhs, void* out,
                           void* ufac, int n, int R, long long ncol, int q,
                           int window, void* stream) {
  return launch<double>(bands, rhs, out, ufac, n, R, ncol, q, window, stream);
}

}  // extern "C"
