// Fused hinge block-subgradient for Hopper (sm_90a), batched over K workers.
//
//   out[k] = w[k] − (C/n)·Σᵢ 1{1 − y[k,i]·⟨x[k,i], w[k]⟩ > 0}·y[k,i]·x[k,i]
//
// Replaces repro/kernels/hinge/kernel.py::_hinge_kernel (launched there by
// hinge_block_grad_padded). It computes the same function; it is not that
// kernel carried over. The TPU kernel walks row blocks in grid order and
// keeps one accumulator in fast memory across the grid; on Hopper the CTAs
// run in parallel and in no order, so the reduction over rows is split in
// two fixed-order stages:
//
//   hinge_partial   one CTA per (row tile, worker). Each warp takes one row:
//                   the margin dot product (lane-strided, then a fixed xor
//                   shuffle tree), the hinge test, and the row's coefficient
//                   y·viol into shared memory. Then each thread owns columns
//                   and sums coefficient·x over the tile's rows in row order,
//                   writing partial[k, tile, :]. The second read of the tile
//                   comes from L2 (a tile is ROWS·d·4 bytes, 64 KB at d = 2000
//                   and 8 rows, against 50 MB of L2): no shared-memory copy of
//                   the tile, so any d fits.
//   hinge_finish    one thread per (column, worker) sums the tiles in tile
//                   order and writes w − (C·Σ)/n.
//
// No float atomics: every sum is taken in a fixed order, so two launches on
// the same inputs give the same bits. No padded copy of X: the ragged row tile
// and the column tail are bounds-checked loads.
//
// Bound: two GEMVs over X, 4·K·n·d flops against K·n·d·4 bytes, about one
// flop a byte, so the kernel is memory-bound: at best X read once from HBM,
// K·n·d·4 bytes / 3.35 TB/s (H100 SXM). At K=32, n=64, d=2000 that is
// 16.4 MB, about 4.9 µs. The (K, tiles, d) partials add 2·K·tiles·d·4 bytes of
// L2 traffic; the wrapper allocates them.
//
// Layout: rows of x are contiguous (row stride d, unit column stride); the
// worker strides of x, y and w are free, and a w worker stride of 0 shares one
// w across the workers.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
hinge_partial(const float* __restrict__ x, long long x_wstride,
              const float* __restrict__ y, long long y_wstride,
              const float* __restrict__ w, long long w_wstride,
              float* __restrict__ partial, int n, int d, int rows_per_tile) {
  extern __shared__ float coef[];  // rows_per_tile
  const int tile = blockIdx.x;
  const int tiles = gridDim.x;
  const int k = blockIdx.y;
  const int row0 = tile * rows_per_tile;
  const int rows = min(rows_per_tile, n - row0);
  const float* xk = x + k * x_wstride + static_cast<long long>(row0) * d;
  const float* yk = y + k * y_wstride + row0;
  const float* wk = w + k * w_wstride;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  for (int r = warp; r < rows; r += kWarps) {
    const float* xr = xk + static_cast<long long>(r) * d;
    float s = 0.0f;
    for (int j = lane; j < d; j += 32) s += xr[j] * wk[j];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) {
      const float yi = yk[r];
      coef[r] = (1.0f - yi * s > 0.0f) ? yi : 0.0f;
    }
  }
  __syncthreads();

  float* out = partial + (static_cast<long long>(k) * tiles + tile) * d;
  for (int j = threadIdx.x; j < d; j += kThreads) {
    float acc = 0.0f;
    for (int r = 0; r < rows; ++r)
      acc += coef[r] * xk[static_cast<long long>(r) * d + j];
    out[j] = acc;
  }
}

__global__ void __launch_bounds__(kThreads)
hinge_finish(const float* __restrict__ partial,
             const float* __restrict__ w, long long w_wstride,
             float* __restrict__ out, int tiles, int n, int d, float c) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  const int k = blockIdx.y;
  if (j >= d) return;
  const float* p = partial + static_cast<long long>(k) * tiles * d + j;
  float s = 0.0f;
  for (int t = 0; t < tiles; ++t) s += p[static_cast<long long>(t) * d];
  out[static_cast<long long>(k) * d + j] =
      w[k * w_wstride + j] - (c * s) / static_cast<float>(n);
}

}  // namespace

// Launches both stages on `stream` and returns cudaGetLastError(): 0 when
// both launches were accepted. `partial` holds k·ceil(n/rows_per_tile)·d
// floats and `out` k·d; neither is read before it is written.
extern "C" int hinge_block_grad_f32(const float* x, long long x_wstride,
                                    const float* y, long long y_wstride,
                                    const float* w, long long w_wstride,
                                    float* partial, float* out, int k, int n,
                                    int d, int rows_per_tile, float c,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = (n + rows_per_tile - 1) / rows_per_tile;
  hinge_partial<<<dim3(tiles, k), kThreads,
                  rows_per_tile * sizeof(float), s>>>(
      x, x_wstride, y, y_wstride, w, w_wstride, partial, n, d, rows_per_tile);
  hinge_finish<<<dim3((d + kThreads - 1) / kThreads, k), kThreads, 0, s>>>(
      partial, w, w_wstride, out, tiles, n, d, c);
  return static_cast<int>(cudaGetLastError());
}
