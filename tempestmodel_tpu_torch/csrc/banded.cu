// Batched no-pivot banded LU solve, one system per column.
//
// Replaces the TPU kernel `banded_solve_pallas` (`_banded_kernel`) of
// tempestmodel_tpu/ops/pallas_banded.py.  That kernel holds a column tile
// and its U-factor in on-chip memory and walks the rows in a sequential
// loop.  Here: ONE THREAD PER COLUMN.  The column axis is the minor axis of
// `bands (n, 2q+1, ncol)` and `rhs (n, ncol)`, so every row read and write
// of a warp is coalesced.  The half-bandwidth q is a template parameter
// (1..8), so the elimination loops unroll and the last q U-rows and y
// values slide through registers.  The U-factor `(n, q+1, ncol)` and the
// forward solution `(n, ncol)` go to scratch tensors that the caller
// allocates; the back substitution reads them back in reverse row order.
// The ragged last block is masked; nothing is padded.
//
// Layout contract: band[i, d] = A[i, i+d-q]; out-of-range band entries are
// zero, so the rows before row 0 act as identity rows with zero multipliers
// and no boundary masking is needed.  No pivoting: the systems carry a
// strong I/dt diagonal (Newton of backward Euler).
//
// Bound on an H100 (3.35 TB/s): bytes.  The function must read bands and
// rhs once and write x once: at n = 91, q = 4, ncol = 86 400, float32 that
// is 283 MB + 31 MB + 31 MB = 346 MB, about 0.10 ms; this design adds a
// write and a read of the scratch (2 x (157 + 31) MB), about 0.11 ms more.
// Arithmetic is ~53 flops per row and column (0.4 GFLOP, microseconds).
//
// Plain C interface (no PyTorch header): the launch goes to the given
// stream, nothing synchronises or allocates, and the entry point returns
// cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;

template <typename T, int Q>
__global__ void banded_kernel(const T* __restrict__ bands,
                              const T* __restrict__ rhs, T* __restrict__ x,
                              T* __restrict__ ufac, T* __restrict__ yfwd,
                              int n, long long ncol) {
  const long long col = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= ncol) return;
  constexpr int NB = 2 * Q + 1;

  // the last Q U-rows (u_prev[Q-1] is the newest) and y values
  T u_prev[Q][Q + 1];
  T y_prev[Q];
#pragma unroll
  for (int t = 0; t < Q; ++t) {
    u_prev[t][0] = T(1);
#pragma unroll
    for (int j = 1; j <= Q; ++j) u_prev[t][j] = T(0);
    y_prev[t] = T(0);
  }

  for (int i = 0; i < n; ++i) {
    T w[NB];
    const T* row = bands + (long long)i * NB * ncol + col;
#pragma unroll
    for (int d = 0; d < NB; ++d) w[d] = row[(long long)d * ncol];
    T y = rhs[(long long)i * ncol + col];
#pragma unroll
    for (int t = 0; t < Q; ++t) {
      // eliminate column i-Q+t with U row i-Q+t
      const T f = w[t] / u_prev[t][0];
#pragma unroll
      for (int j = 1; j <= Q; ++j) w[t + j] -= f * u_prev[t][j];
      y -= f * y_prev[t];
    }
    T* urow = ufac + (long long)i * (Q + 1) * ncol + col;
#pragma unroll
    for (int j = 0; j <= Q; ++j) urow[(long long)j * ncol] = w[Q + j];
    yfwd[(long long)i * ncol + col] = y;
#pragma unroll
    for (int t = 0; t + 1 < Q; ++t) {
#pragma unroll
      for (int j = 0; j <= Q; ++j) u_prev[t][j] = u_prev[t + 1][j];
      y_prev[t] = y_prev[t + 1];
    }
#pragma unroll
    for (int j = 0; j <= Q; ++j) u_prev[Q - 1][j] = w[Q + j];
    y_prev[Q - 1] = y;
  }

  // back substitution; x_next[d] = x[i + 1 + d], zero beyond the last row
  T x_next[Q];
#pragma unroll
  for (int d = 0; d < Q; ++d) x_next[d] = T(0);
  for (int i = n - 1; i >= 0; --i) {
    const T* urow = ufac + (long long)i * (Q + 1) * ncol + col;
    T acc = yfwd[(long long)i * ncol + col];
#pragma unroll
    for (int d = 0; d < Q; ++d)
      acc -= urow[(long long)(d + 1) * ncol] * x_next[d];
    const T xi = acc / urow[0];
    x[(long long)i * ncol + col] = xi;
#pragma unroll
    for (int d = Q - 1; d > 0; --d) x_next[d] = x_next[d - 1];
    x_next[0] = xi;
  }
}

template <typename T, int Q>
void launch_q(const void* bands, const void* rhs, void* x, void* ufac,
              void* yfwd, int n, long long ncol, cudaStream_t stream) {
  const unsigned blocks = (unsigned)((ncol + THREADS - 1) / THREADS);
  banded_kernel<T, Q><<<blocks, THREADS, 0, stream>>>(
      (const T*)bands, (const T*)rhs, (T*)x, (T*)ufac, (T*)yfwd, n, ncol);
}

// Returns cudaGetLastError(), or -1 for a bandwidth outside 1..8.
template <typename T>
int launch(const void* bands, const void* rhs, void* x, void* ufac,
           void* yfwd, int n, long long ncol, int q, void* stream_) {
  cudaStream_t stream = (cudaStream_t)stream_;
  if (n > 0 && ncol > 0) {
    switch (q) {
      case 1: launch_q<T, 1>(bands, rhs, x, ufac, yfwd, n, ncol, stream); break;
      case 2: launch_q<T, 2>(bands, rhs, x, ufac, yfwd, n, ncol, stream); break;
      case 3: launch_q<T, 3>(bands, rhs, x, ufac, yfwd, n, ncol, stream); break;
      case 4: launch_q<T, 4>(bands, rhs, x, ufac, yfwd, n, ncol, stream); break;
      case 5: launch_q<T, 5>(bands, rhs, x, ufac, yfwd, n, ncol, stream); break;
      case 6: launch_q<T, 6>(bands, rhs, x, ufac, yfwd, n, ncol, stream); break;
      case 7: launch_q<T, 7>(bands, rhs, x, ufac, yfwd, n, ncol, stream); break;
      case 8: launch_q<T, 8>(bands, rhs, x, ufac, yfwd, n, ncol, stream); break;
      default: return -1;
    }
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int banded_solve_f32(const void* bands, const void* rhs, void* x, void* ufac,
                     void* yfwd, int n, long long ncol, int q, void* stream) {
  return launch<float>(bands, rhs, x, ufac, yfwd, n, ncol, q, stream);
}

int banded_solve_f64(const void* bands, const void* rhs, void* x, void* ufac,
                     void* yfwd, int n, long long ncol, int q, void* stream) {
  return launch<double>(bands, rhs, x, ufac, yfwd, n, ncol, q, stream);
}

}  // extern "C"
