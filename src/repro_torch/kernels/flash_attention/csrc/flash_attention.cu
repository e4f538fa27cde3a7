// Flash attention, forward, for Hopper (sm_90a): grouped-query attention
// with an online softmax and causal / prefix masks.
//
//   o[b, i, h] = Σ_j softmax_j(⟨q[b, i, h], k[b, j, h / group]⟩ / √dh) · v[b, j, h / group]
//
// over the visible keys j of row i:
//   causal                     j ≤ i  or  j < prefix_len
//   not causal, prefix_len > 0 j < prefix_len
//   not causal, prefix_len = 0 every j < T
//
// Replaces repro/kernels/flash_attention/kernel.py::_fa_kernel (launched
// there by flash_attention_padded, through ops.py::flash_attention). It
// computes the same function; it is not that kernel carried over:
//
//   * The TPU kernel's grid walks the KV blocks as its last, sequential
//     dimension and keeps acc/m/l in VMEM across grid steps. Here one CTA
//     owns one (q tile of 64 rows, query head, batch) and loops over the KV
//     tiles itself. The loop ends at the last tile that holds a visible key
//     for some row of the q tile, which is the TPU kernel's skip of fully
//     masked blocks. The q tiles are issued longest first (the last rows of
//     a causal sequence see the most keys), so the short tiles fill the
//     tail of the grid.
//   * q (B, S, H, dh) and k/v (B, T, KV, dh) are read in place through their
//     strides, the KV head as h / group: no transposed copies, no repeated
//     KV, no zero-padded copies (the JAX wrapper builds all three). The
//     ragged S, T and dh edges are masked loads and stores.
//   * m and l are one f32 value per row (the TPU kernel keeps a (bq, 128)
//     lane broadcast). Each thread keeps its own partial l over its columns
//     and the 16 partials of a row are summed once, at the end.
//   * All arithmetic is f32, as _fa_kernel casts to f32; f32 and bf16 inputs
//     are converted as they are loaded and the output is written in the
//     input's type. Masked scores take the -1e30 sentinel, and the output is
//     acc / max(l, 1e-30), as in _fa_kernel.
//   * Deterministic: every sum is taken in a fixed order (the dot products
//     in d order, the softmax sums in a fixed shuffle tree), with no atomics,
//     so two launches on the same inputs give the same bits.
//
// Tiles: 64 q rows × 64 keys, 256 threads as 16 × 16; thread (ty, tx) owns
// score rows 4ty..4ty+3 and key columns tx + 16j (j < 4), and output columns
// 64g + 4tx..4tx+3 of the same rows. Shared memory holds the q, k and v tiles
// as f32 (rows padded by 4 floats so the float4 reads of 8 rows fall on
// distinct banks) and the 64 × 64 probability tile that the P·V product
// reads: 68.6 KB at dh ≤ 64, 216 KB at dh ≤ 256.
//
// Bound: attention is compute-bound. At the serving path's prefill
// (B = 4, S = T = 1920, H = 15, KV = 5, dh = 64, bf16, causal) the visible
// (row, key) pairs need 4·dh flops each, 28.3 GFLOP, against 39.3 MB of
// q, k, v and o: 28.6 µs at 989 TFLOP/s on the bf16 tensor cores against
// 11.7 µs at 3.35 TB/s. This first kernel computes in f32 on the CUDA cores
// (67 TFLOP/s, so at least 0.42 ms for the same flops) and computes whole
// 64 × 64 tiles on the causal diagonal; wgmma on bf16 tiles with TMA loads
// is the step to the tensor-core bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;

struct Args {
  const void* q;
  long long q_sb, q_ss, q_sh;
  const void* k;
  long long k_sb, k_ss, k_sh;
  const void* v;
  long long v_sb, v_ss, v_sh;
  void* o;
  int b, s, t, h, kvh, dh, causal, prefix_len;
  float scale;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even, as a dtype cast does
}

// Rows row0..row0+63 of one head into a [64][ld] f32 tile; zero at rows
// ≥ rows and columns ≥ dh.
template <typename T, int DHP>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src,
                                          long long row_stride, int row0,
                                          int rows, int dh) {
  for (int idx = threadIdx.x; idx < 64 * DHP; idx += kThreads) {
    const int r = idx / DHP;
    const int d = idx % DHP;
    float x = 0.0f;
    if (row0 + r < rows && d < dh)
      x = to_f32(src[static_cast<long long>(row0 + r) * row_stride + d]);
    dst[r * ld + d] = x;
  }
}

template <typename T, int DHP>
__global__ void __launch_bounds__(kThreads) fa_fwd(Args a) {
  constexpr int LDQ = DHP + 4;
  constexpr int LDV = DHP;
  constexpr int LDP = kBK + 4;
  constexpr int G = DHP / 64;  // float4 column groups of the output
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* ks = qs + kBQ * LDQ;
  float* vs = ks + kBK * LDQ;
  float* ps = vs + kBK * LDV;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBQ;
  const int kv_head = h / (a.h / a.kvh);
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  const T* qp = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* kp = static_cast<const T*>(a.k) + b * a.k_sb + kv_head * a.k_sh;
  const T* vp = static_cast<const T*>(a.v) + b * a.v_sb + kv_head * a.v_sh;

  // one past the last key any row of this tile sees
  int kv_end = a.t;
  if (a.causal)
    kv_end = min(a.t, max(min(q0 + kBQ, a.s), a.prefix_len));
  else if (a.prefix_len > 0)
    kv_end = min(a.t, a.prefix_len);
  const int n_kt = (kv_end + kBK - 1) / kBK;

  load_tile<T, DHP>(qs, LDQ, qp, a.q_ss, q0, a.s, a.dh);

  float o[4][4 * G];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < 4 * G; ++c) o[i][c] = 0.0f;
  }

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the last tile's readers are done; q is loaded
    load_tile<T, DHP>(ks, LDQ, kp, a.k_ss, k0, a.t, a.dh);
    load_tile<T, DHP>(vs, LDV, vp, a.v_ss, k0, a.t, a.dh);
    __syncthreads();

    // scores of rows 4ty+i against keys tx+16j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < DHP; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(&qs[(4 * ty + i) * LDQ + d]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(&ks[(tx + 16 * j) * LDQ + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float acc = s[i][j];
          acc = fmaf(qv[i].x, kv[j].x, acc);
          acc = fmaf(qv[i].y, kv[j].y, acc);
          acc = fmaf(qv[i].z, kv[j].z, acc);
          acc = fmaf(qv[i].w, kv[j].w, acc);
          s[i][j] = acc;
        }
    }

    // mask, running max, rescale, probabilities into shared memory
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + 4 * ty + i;
      float mt = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        bool vis = col < a.t;
        if (a.causal)
          vis = vis && (col <= row || col < a.prefix_len);
        else if (a.prefix_len > 0)
          vis = vis && col < a.prefix_len;
        s[i][j] = vis ? s[i][j] * a.scale : kNegInf;
        mt = fmaxf(mt, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float m_new = fmaxf(m[i], mt);
      const float corr = expf(m[i] - m_new);
      m[i] = m_new;
      l[i] *= corr;
#pragma unroll
      for (int c = 0; c < 4 * G; ++c) o[i][c] *= corr;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        l[i] += p;
        ps[(4 * ty + i) * LDP + tx + 16 * j] = p;
      }
    }
    __syncthreads();

    // o += P · V over the tile's keys, in key order
#pragma unroll 2
    for (int kk = 0; kk < kBK; kk += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(&ps[(4 * ty + i) * LDP + kk]);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float* vcol = &vs[kk * LDV + 64 * g + 4 * tx];
        const float4 v0 = *reinterpret_cast<const float4*>(vcol);
        const float4 v1 = *reinterpret_cast<const float4*>(vcol + LDV);
        const float4 v2 = *reinterpret_cast<const float4*>(vcol + 2 * LDV);
        const float4 v3 = *reinterpret_cast<const float4*>(vcol + 3 * LDV);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float* oc = &o[i][4 * g];
          oc[0] = fmaf(pv[i].w, v3.x, fmaf(pv[i].z, v2.x,
                  fmaf(pv[i].y, v1.x, fmaf(pv[i].x, v0.x, oc[0]))));
          oc[1] = fmaf(pv[i].w, v3.y, fmaf(pv[i].z, v2.y,
                  fmaf(pv[i].y, v1.y, fmaf(pv[i].x, v0.y, oc[1]))));
          oc[2] = fmaf(pv[i].w, v3.z, fmaf(pv[i].z, v2.z,
                  fmaf(pv[i].y, v1.z, fmaf(pv[i].x, v0.z, oc[2]))));
          oc[3] = fmaf(pv[i].w, v3.w, fmaf(pv[i].z, v2.w,
                  fmaf(pv[i].y, v1.w, fmaf(pv[i].x, v0.w, oc[3]))));
        }
      }
    }
  }

  // the row sums of l, then o / max(l, 1e-30) in the input's type
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float lt = l[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      lt += __shfl_xor_sync(0xffffffffu, lt, off);
    const int row = q0 + 4 * ty + i;
    if (row >= a.s) continue;
    T* op = static_cast<T*>(a.o) +
            ((static_cast<long long>(b) * a.s + row) * a.h + h) * a.dh;
    const float denom = fmaxf(lt, 1e-30f);
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 64 * g + 4 * tx + e;
        if (col < a.dh) store(op + col, o[i][4 * g + e] / denom);
      }
  }
}

template <typename T, int DHP>
int launch(const Args& a, cudaStream_t stream) {
  const int smem = static_cast<int>(
      sizeof(float) * (kBQ * (DHP + 4) + kBK * (DHP + 4) + kBK * DHP +
                       kBQ * (kBK + 4)));
  cudaError_t err = cudaFuncSetAttribute(
      fa_fwd<T, DHP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(a.h, a.b, (a.s + kBQ - 1) / kBQ);
  fa_fwd<T, DHP><<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const Args& a, cudaStream_t stream) {
  if (a.dh <= 64) return launch<T, 64>(a, stream);
  if (a.dh <= 128) return launch<T, 128>(a, stream);
  return launch<T, 256>(a, stream);
}

}  // namespace

// Launches the kernel on `stream` and returns the CUDA error of the launch
// (0 when it was accepted). q (B, S, H, dh), k and v (B, T, KV, dh) with a
// unit last stride and the given batch, sequence and head strides (in
// elements); o is (B, S, H, dh), contiguous. dtype 0 is float32, 1 bfloat16,
// for all four. dh ≤ 256, H a multiple of KV; the wrapper checks both.
extern "C" int flash_attention_fwd(
    const void* q, long long q_sb, long long q_ss, long long q_sh,
    const void* k, long long k_sb, long long k_ss, long long k_sh,
    const void* v, long long v_sb, long long v_ss, long long v_sh, void* o,
    int b, int s, int t, int h, int kvh, int dh, int causal, int prefix_len,
    int dtype, float scale, void* stream) {
  const Args a{q, q_sb, q_ss, q_sh, k, k_sb, k_ss, k_sh, v, v_sb, v_ss, v_sh,
               o, b, s, t, h, kvh, dh, causal, prefix_len, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? dispatch<__nv_bfloat16>(a, st) : dispatch<float>(a, st);
}
