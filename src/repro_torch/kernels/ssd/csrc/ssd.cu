// Mamba2 SSD chunk scan, forward, for Hopper (sm_90a), from a zero state.
//
// Per batch b and head h, over chunks of Q steps (diagonal A, one B/C group
// shared by all heads):
//
//   cum_t  = Σ_{s≤t} Δ_s·A                               (in-chunk log-decay)
//   y_t    = Σ_{s≤t} (C_t·B_s) e^{cum_t − cum_s} Δ_s x_s  +  e^{cum_t} C_t·S
//   S     ← e^{cum_Q} S + Σ_s B_s (Δ_s e^{cum_Q − cum_s}) x_sᵀ
//
// y (B, L, H, P) in x's type and the final state (B, H, N, P) in f32.
//
// Replaces repro/kernels/ssd/kernel.py::_ssd_kernel (launched there by
// ssd_scan_padded, through ops.py::ssd_scan, which pads L with Δ = 0 steps).
// It computes the same function; it is not that kernel carried over:
//
//   * The TPU kernel walks the chunks as its last, sequential grid dimension
//     and carries the (N, P) state in VMEM. Here one CTA owns one (head,
//     batch) and loops over the chunks itself, with the state in shared
//     memory (N·P f32: 32 KB at N = 128, P = 64).
//   * The (Q, Q) score-and-decay tile does not fit (256 KB in f32 at
//     Q = 256), so each chunk is computed in row tiles of 64, each row tile
//     looping over the source tiles s ≤ t: the 64 × 64 tile of
//     (C Bᵀ) ∘ L ∘ Δ goes through shared memory into the product with x.
//     C Bᵀ does not depend on the head; this kernel computes it again for
//     every head (80 times at mamba2-2.7b, 64 at zamba2-1.2b).
//   * The in-chunk cumsum of Δ·A is a fixed-order block scan (a warp scan
//     by shuffles, then the warp totals in order). There are no atomics: two
//     launches on the same inputs give the same bits.
//   * cum_t − cum_s is masked to −60 before exp for s > t and the product
//     zeroed there, as _ssd_kernel does.
//   * x (B, L, H, P), B and C (B, L, N) and Δ (B, L, H) are read in place
//     through their strides (x is the model's (B, L, H·P) conv output viewed
//     per head): no padded copies. Rows at or beyond L inside the last chunk
//     are Δ = 0 steps, as the wrapper's padding makes them: their x, B, C
//     read as 0, the state passes them unchanged, and no y is written.
//   * All arithmetic is f32 (f32 and bf16 x/B/C are converted as they are
//     loaded), as _ssd_kernel casts to f32; f32 Δ and A.
//
// Threads: 256 as 16 × 16. Thread (ty, tx) owns rows 4ty..4ty+3 and columns
// tx + 16j of the output tile and of the score tile, and state rows
// ty + 16i, columns tx + 16j. Shared memory: the state, cum/Δ/weights of
// the chunk, a C tile and a B tile (64 × (NT + 1), padded so the column
// reads of 16 rows fall on distinct banks), an x tile and the score tile:
// 132 KB at N = 128, P ≤ 64 (one CTA an SM), 84 KB at N ≤ 64.
//
// Bound on the H100 SXM at the mamba2-2.7b prefill (B = 4, L = 1,920,
// H = 80, P = 64, N = 128, Q = 256, bf16 x/B/C/y): x and y 78.6 MB each,
// B and C 3.9 MB, Δ 2.5 MB, state 10.5 MB: 174.2 MB, 52.0 µs at 3.35 TB/s.
// The chunked algorithm's products (the causal triangle of each chunk's
// scores, C Bᵀ once per (batch, chunk), the inter-chunk C·S and the state's
// Bᵀ·x) are 30.1 GFLOP, 30.5 µs at 989 TFLOP/s on the bf16 tensor cores
// (81.4 µs if every (Q, Q) product is counted whole, per head). So the bound
// is the bytes. This first kernel computes in f32 on the CUDA cores, about
// 60 GFLOP with its whole diagonal tiles and C Bᵀ per head; bf16 mma/wgmma
// on the tiles, C Bᵀ shared across heads and TMA loads are the steps toward
// the bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;
constexpr int kMaxChunk = 256;
constexpr float kMaskArg = -60.0f;

struct Args {
  const void* x;
  long long x_sb, x_sl, x_sh;
  const float* dt;
  long long dt_sb, dt_sl, dt_sh;
  const float* a;
  const void* bm;
  long long b_sb, b_sl;
  const void* cm;
  long long c_sb, c_sl;
  void* y;
  float* state;
  int b, l, h, p, n, chunk;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even, as a dtype cast does
}

// Rows 0..63 of a tile into dst[64][ld] as f32, from src (the tile's first
// row) with the given row stride; zero at rows ≥ rows and columns ≥ cols.
template <typename T, int W>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src,
                                          long long row_stride, int rows,
                                          int cols) {
  for (int idx = threadIdx.x; idx < kTile * W; idx += kThreads) {
    const int r = idx / W;
    const int k = idx % W;
    float v = 0.0f;
    if (r < rows && k < cols) v = to_f32(src[r * row_stride + k]);
    dst[r * ld + k] = v;
  }
}

template <typename T, int NT, int PT>
__global__ void __launch_bounds__(kThreads) ssd_fwd(Args a) {
  constexpr int LDN = NT + 1;
  constexpr int LDG = kTile + 1;
  constexpr int PJ = PT / 16;  // output / state columns a thread owns
  constexpr int NI = NT / 16;  // state rows a thread owns
  extern __shared__ __align__(16) float smem[];
  float* st = smem;                 // [NT][PT] the carried state
  float* cum = st + NT * PT;        // [kMaxChunk] inclusive cumsum of Δ·A
  float* dts = cum + kMaxChunk;     // [kMaxChunk] Δ
  float* wts = dts + kMaxChunk;     // [kMaxChunk] Δ_s e^{cum_Q − cum_s}
  float* cs = wts + kMaxChunk;      // [kTile][LDN] C rows of a row tile
  float* bs = cs + kTile * LDN;     // [kTile][LDN] B rows of a source tile
  float* xs = bs + kTile * LDN;     // [kTile][PT] x rows of a source tile
  float* gs = xs + kTile * PT;      // [kTile][LDG] the masked score tile
  __shared__ float warp_sums[kThreads / 32];

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const T* xp = static_cast<const T*>(a.x) + b * a.x_sb + h * a.x_sh;
  const float* dtp = a.dt + b * a.dt_sb + h * a.dt_sh;
  const T* bp = static_cast<const T*>(a.bm) + b * a.b_sb;
  const T* cp = static_cast<const T*>(a.cm) + b * a.c_sb;
  const long long y_sl = static_cast<long long>(a.h) * a.p;
  T* yp = static_cast<T*>(a.y) + static_cast<long long>(b) * a.l * y_sl +
          static_cast<long long>(h) * a.p;
  const float ah = a.a[h];
  const int q = a.chunk;

  for (int i = threadIdx.x; i < NT * PT; i += kThreads) st[i] = 0.0f;

  const int n_chunks = (a.l + q - 1) / q;
  const int n_tiles = (q + kTile - 1) / kTile;
  for (int c = 0; c < n_chunks; ++c) {
    const long long c0 = static_cast<long long>(c) * q;
    const int valid = min(q, static_cast<int>(a.l - c0));  // rows < L

    // Δ·A and its inclusive cumsum: thread t holds row t of the chunk
    __syncthreads();  // the last chunk's readers of cum, dts, warp_sums
    {
      const int t = threadIdx.x;
      const float d = t < valid ? dtp[(c0 + t) * a.dt_sl] : 0.0f;
      float v = d * ah;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, v, off);
        if ((t & 31) >= off) v += u;
      }
      if ((t & 31) == 31) warp_sums[t >> 5] = v;
      __syncthreads();
      float base = 0.0f;
      for (int w = 0; w < (t >> 5); ++w) base += warp_sums[w];
      v += base;
      if (t < q) {
        cum[t] = v;
        dts[t] = d;
      }
    }
    __syncthreads();
    const float total = cum[q - 1];

    for (int rt = 0; rt < n_tiles; ++rt) {
      const int t0 = rt * kTile;
      __syncthreads();  // the last row tile's readers of cs
      load_tile<T, NT>(cs, LDN, cp + (c0 + t0) * a.c_sl, a.c_sl, valid - t0,
                       a.n);
      __syncthreads();

      // the carried state's part: e^{cum_t} C_t·S
      float acc[4][PJ];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < PJ; ++j) acc[i][j] = 0.0f;
      for (int k = 0; k < a.n; ++k) {
        float cv[4], sv[PJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = cs[(4 * ty + i) * LDN + k];
#pragma unroll
        for (int j = 0; j < PJ; ++j) sv[j] = st[k * PT + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < PJ; ++j) acc[i][j] = fmaf(cv[i], sv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = t0 + 4 * ty + i;
        const float e = t < q ? expf(cum[t]) : 0.0f;
#pragma unroll
        for (int j = 0; j < PJ; ++j) acc[i][j] *= e;
      }

      // the chunk's part: ((C Bᵀ) ∘ L ∘ Δ) x over the source tiles s ≤ t
      for (int s0 = 0; s0 <= t0; s0 += kTile) {
        __syncthreads();  // the last source tile's readers of bs, xs, gs
        load_tile<T, NT>(bs, LDN, bp + (c0 + s0) * a.b_sl, a.b_sl,
                         valid - s0, a.n);
        load_tile<T, PT>(xs, PT, xp + (c0 + s0) * a.x_sl, a.x_sl, valid - s0,
                         a.p);
        __syncthreads();
        float g[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) g[i][j] = 0.0f;
        for (int k = 0; k < a.n; ++k) {
          float cv[4], bv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) cv[i] = cs[(4 * ty + i) * LDN + k];
#pragma unroll
          for (int j = 0; j < 4; ++j) bv[j] = bs[(tx + 16 * j) * LDN + k];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) g[i][j] = fmaf(cv[i], bv[j], g[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = t0 + 4 * ty + i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int s = s0 + tx + 16 * j;
            const bool tri = s <= t && t < q;
            const float arg = tri ? cum[t] - cum[s] : kMaskArg;
            gs[(4 * ty + i) * LDG + tx + 16 * j] =
                tri ? g[i][j] * expf(arg) * dts[s] : 0.0f;
          }
        }
        __syncthreads();
        const int s_end = min(kTile, q - s0);
        for (int s = 0; s < s_end; ++s) {
          float gv[4], xv[PJ];
#pragma unroll
          for (int i = 0; i < 4; ++i) gv[i] = gs[(4 * ty + i) * LDG + s];
#pragma unroll
          for (int j = 0; j < PJ; ++j) xv[j] = xs[s * PT + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < PJ; ++j)
              acc[i][j] = fmaf(gv[i], xv[j], acc[i][j]);
        }
      }

#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = t0 + 4 * ty + i;
        if (t >= valid) continue;
        T* row = yp + (c0 + t) * y_sl;
#pragma unroll
        for (int j = 0; j < PJ; ++j) {
          const int col = tx + 16 * j;
          if (col < a.p) store(row + col, acc[i][j]);
        }
      }
    }

    // the state: S ← e^{cum_Q} S + Σ_s (B_s Δ_s e^{cum_Q − cum_s}) x_sᵀ
    if (threadIdx.x < q)
      wts[threadIdx.x] = dts[threadIdx.x] * expf(total - cum[threadIdx.x]);
    float sn[NI][PJ];
#pragma unroll
    for (int i = 0; i < NI; ++i)
#pragma unroll
      for (int j = 0; j < PJ; ++j) sn[i][j] = 0.0f;
    for (int s0 = 0; s0 < q; s0 += kTile) {
      __syncthreads();  // wts written; the last readers of bs, xs are done
      load_tile<T, NT>(bs, LDN, bp + (c0 + s0) * a.b_sl, a.b_sl, valid - s0,
                       a.n);
      load_tile<T, PT>(xs, PT, xp + (c0 + s0) * a.x_sl, a.x_sl, valid - s0,
                       a.p);
      __syncthreads();
      const int s_end = min(kTile, q - s0);
      for (int s = 0; s < s_end; ++s) {
        const float w = wts[s0 + s];
        float bv[NI], xv[PJ];
#pragma unroll
        for (int i = 0; i < NI; ++i) bv[i] = bs[s * LDN + ty + 16 * i] * w;
#pragma unroll
        for (int j = 0; j < PJ; ++j) xv[j] = xs[s * PT + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < NI; ++i)
#pragma unroll
          for (int j = 0; j < PJ; ++j) sn[i][j] = fmaf(bv[i], xv[j], sn[i][j]);
      }
    }
    const float decay = expf(total);
#pragma unroll
    for (int i = 0; i < NI; ++i)
#pragma unroll
      for (int j = 0; j < PJ; ++j) {
        float* sp = &st[(ty + 16 * i) * PT + tx + 16 * j];
        *sp = decay * *sp + sn[i][j];
      }
  }

  __syncthreads();
  float* out = a.state + (static_cast<long long>(b) * a.h + h) * a.n * a.p;
  for (int idx = threadIdx.x; idx < a.n * a.p; idx += kThreads)
    out[idx] = st[(idx / a.p) * PT + idx % a.p];
}

template <typename T, int NT, int PT>
int launch(const Args& a, cudaStream_t stream) {
  const int smem = static_cast<int>(
      sizeof(float) * (NT * PT + 3 * kMaxChunk + 2 * kTile * (NT + 1) +
                       kTile * PT + kTile * (kTile + 1)));
  cudaError_t err = cudaFuncSetAttribute(
      ssd_fwd<T, NT, PT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(a.h, a.b);
  ssd_fwd<T, NT, PT><<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const Args& a, cudaStream_t stream) {
  if (a.n <= 64)
    return a.p <= 64 ? launch<T, 64, 64>(a, stream)
                     : launch<T, 64, 128>(a, stream);
  return a.p <= 64 ? launch<T, 128, 64>(a, stream)
                   : launch<T, 128, 128>(a, stream);
}

}  // namespace

// Launches the kernel on `stream` and returns the CUDA error of the launch
// (0 when it was accepted). x (B, L, H, P) and B/C (B, L, N) with a unit last
// stride and the given strides (in elements), dt (B, L, H) f32 with the given
// strides, a (H,) f32; y (B, L, H, P) contiguous in x's type, state
// (B, H, N, P) contiguous f32. dtype 0 is float32, 1 bfloat16, for x, B, C
// and y. P ≤ 128, N ≤ 128, 1 ≤ chunk ≤ 256, L ≥ 1; the wrapper checks them.
extern "C" int ssd_scan_fwd(
    const void* x, long long x_sb, long long x_sl, long long x_sh,
    const void* dt, long long dt_sb, long long dt_sl, long long dt_sh,
    const void* a, const void* bm, long long b_sb, long long b_sl,
    const void* cm, long long c_sb, long long c_sl, void* y, void* state,
    int b, int l, int h, int p, int n, int chunk, int dtype, void* stream) {
  const Args args{x, x_sb, x_sl, x_sh,
                  static_cast<const float*>(dt), dt_sb, dt_sl, dt_sh,
                  static_cast<const float*>(a), bm, b_sb, b_sl, cm, c_sb,
                  c_sl, y, static_cast<float*>(state), b, l, h, p, n, chunk};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? dispatch<__nv_bfloat16>(args, st)
                    : dispatch<float>(args, st);
}
