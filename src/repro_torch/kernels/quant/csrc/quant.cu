// Symmetric int8 quantization for Hopper (sm_90a), batched over R rows.
//
//   scale[r] = max(max_j |x[r, j]|, 1e-12) / 127
//   q[r, j]  = clip(round_half_even(x[r, j] / scale[r]), −127, 127)  (int8)
//   res[r, j] = x[r, j] − q[r, j]·scale[r]        (optional, error feedback)
//   out[r, j] = q[r, j]·scale[r]                  (dequantize)
//
// A row holding a NaN gets a NaN scale and one holding ±inf an infinite
// one; either way every q of the row is 0 (a NaN quotient packs to 0) and
// the row dequantizes to NaN, as in the oracle. The maxes keep a NaN
// (nan_max), where fmaxf would drop it.
//
// Replaces repro/kernels/quant/kernel.py::_quant_kernel (quantize_padded) and
// ::_dequant_kernel (dequantize_padded), with the amax and scale that
// repro/kernels/quant/ops.py computes in jnp beside them. The TPU kernels tile
// a padded (m, 128) copy and take one per-tensor scale as a (1, 1) operand.
// Here a row is one (replica, leaf) pair of the compressed sync: each row gets
// its own scale, rows are read in place through a row stride (their elements
// contiguous), and the ragged tail is a scalar loop, so there is no padded
// copy.
//
// The oracle (repro/core/compression.py, repro/kernels/quant/ref.py) divides
// by the scale; the Pallas kernel multiplies by its inverse. This kernel
// divides, as the oracle does, with an IEEE divide (__fdiv_rn; the build has
// no fast-math) and rintf (round half to even, as jnp.round), so its int8
// payload is bitwise the oracle's. The residual is x − f32(q)·scale with an
// explicit round-to-nearest multiply, bitwise the oracle's v − dequantize(q).
//
//   quant_amax_partial  grid (blocks, R): each CTA takes a grid-strided share
//                       of one row, float4 loads where the row is 16-byte
//                       aligned, |x| max per thread, then a warp xor-shuffle
//                       max and a max over the CTA's warps in shared memory:
//                       partial[r, block].
//   quant_scale         one CTA per row: the max over its partials, then
//                       scale[r] (or, amax-only, the max itself). Max is
//                       exact, so the result does not depend on the order:
//                       two launches give the same bits.
//   quant_int8          grid (blocks, R): q (char4 stores) and, if asked, the
//                       residual (float4 stores).
//   dequant_int8        grid (blocks, R): out = f32(q)·scale (char4 loads,
//                       float4 stores).
//
// A leaf that one process holds only a shard of (the trainer on a model mesh)
// is packed with the whole leaf's scale: quant_amax_f32 gives the shard's
// amax (the partials and their max, no floor), the caller takes the max over
// the ranks that hold the other shards (exact), and quant_int8_given_amax_f32
// packs with that amax: quant_scale over one partial a row (the amax itself)
// and quant_int8. The payloads put back together are bitwise the whole
// leaf's, since every step is the whole-leaf path's own arithmetic.
//
// Bound: bytes. Quantize reads x twice (amax, then q) where the bound counts it
// once: 4 bytes read and 1 written an element (plus 4 for the residual);
// dequantize reads 1 and writes 4. At the trainer's largest leaf (mlp.w_up of
// smollm-360m, 32·960·2,560 = 78.6 M elements, R = 4 replicas) that is 1.57 GB
// a call, about 470 µs at 3.35 TB/s (H100 SXM). The second read of x is the
// cost of not fusing the amax; the residual makes it 9 bytes an element
// against the bound's 4 + 1 + 4.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// max that keeps a NaN from either side (fmaxf drops it): a leaf holding a
// NaN gets a NaN amax and scale, as the oracle's jnp.max / jnp.maximum give
__device__ __forceinline__ float nan_max(float v, float u) {
  return (u != u || u > v) ? u : v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = nan_max(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// max over the CTA; every thread gets it
__device__ __forceinline__ float block_max(float v) {
  __shared__ float warp_vals[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  v = warp_max(v);
  if (lane == 0) warp_vals[warp] = v;
  __syncthreads();
  v = lane < kWarps ? warp_vals[lane] : 0.0f;
  return warp_max(v);
}

// a NaN quotient (a NaN x, or any x over a NaN or an infinite scale) packs
// to 0, as the oracle's cast does; the clamp would make it −127
__device__ __forceinline__ int8_t quant_one(float x, float s) {
  const float r = rintf(__fdiv_rn(x, s));
  if (r != r) return 0;
  return static_cast<int8_t>(static_cast<int>(fminf(fmaxf(r, -127.0f),
                                                    127.0f)));
}

__device__ __forceinline__ float dequant_one(int8_t q, float s) {
  return __fmul_rn(static_cast<float>(q), s);
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
quant_amax_partial(const float* __restrict__ x, long long x_rs,
                   float* __restrict__ partial, long long n) {
  const int r = blockIdx.y;
  const float* xr = x + r * x_rs;
  const long long start = static_cast<long long>(blockIdx.x) * kThreads +
                          threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  float m = 0.0f;
  long long done = 0;
  if (kVec) {
    const long long n4 = n / 4;
    const float4* x4 = reinterpret_cast<const float4*>(xr);
    for (long long i = start; i < n4; i += stride) {
      const float4 v = x4[i];
      m = nan_max(m, nan_max(nan_max(fabsf(v.x), fabsf(v.y)),
                             nan_max(fabsf(v.z), fabsf(v.w))));
    }
    done = n4 * 4;
  }
  for (long long i = done + start; i < n; i += stride)
    m = nan_max(m, fabsf(xr[i]));
  m = block_max(m);
  if (threadIdx.x == 0) partial[static_cast<long long>(r) * gridDim.x +
                                blockIdx.x] = m;
}

// kScale: scale[r] from the row's max; else the max itself (amax-only)
template <bool kScale>
__global__ void __launch_bounds__(kThreads)
quant_scale(const float* __restrict__ partial, int blocks,
            float* __restrict__ scale) {
  const int r = blockIdx.x;
  float m = 0.0f;
  for (int i = threadIdx.x; i < blocks; i += kThreads)
    m = nan_max(m, partial[static_cast<long long>(r) * blocks + i]);
  m = block_max(m);
  // the 1e-12 floor keeps a NaN amax NaN (fmaxf would give 1e-12)
  if (threadIdx.x == 0)
    scale[r] = kScale ? __fdiv_rn(m != m ? m : fmaxf(m, 1e-12f), 127.0f) : m;
}

template <bool kVec, bool kRes>
__global__ void __launch_bounds__(kThreads)
quant_int8(const float* __restrict__ x, long long x_rs,
           int8_t* __restrict__ q, long long q_rs,
           float* __restrict__ res, long long res_rs,
           const float* __restrict__ scale, long long n) {
  const int r = blockIdx.y;
  const float s = scale[r];
  const float* xr = x + r * x_rs;
  int8_t* qr = q + r * q_rs;
  float* rr = kRes ? res + r * res_rs : nullptr;
  const long long start = static_cast<long long>(blockIdx.x) * kThreads +
                          threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  long long done = 0;
  if (kVec) {
    const long long n4 = n / 4;
    const float4* x4 = reinterpret_cast<const float4*>(xr);
    char4* q4 = reinterpret_cast<char4*>(qr);
    float4* r4 = reinterpret_cast<float4*>(rr);
    for (long long i = start; i < n4; i += stride) {
      const float4 v = x4[i];
      char4 c;
      c.x = quant_one(v.x, s);
      c.y = quant_one(v.y, s);
      c.z = quant_one(v.z, s);
      c.w = quant_one(v.w, s);
      q4[i] = c;
      if (kRes) {
        float4 e;
        e.x = __fsub_rn(v.x, dequant_one(c.x, s));
        e.y = __fsub_rn(v.y, dequant_one(c.y, s));
        e.z = __fsub_rn(v.z, dequant_one(c.z, s));
        e.w = __fsub_rn(v.w, dequant_one(c.w, s));
        r4[i] = e;
      }
    }
    done = n4 * 4;
  }
  for (long long i = done + start; i < n; i += stride) {
    const int8_t c = quant_one(xr[i], s);
    qr[i] = c;
    if (kRes) rr[i] = __fsub_rn(xr[i], dequant_one(c, s));
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
dequant_int8(const int8_t* __restrict__ q, long long q_rs,
             const float* __restrict__ scale, float* __restrict__ out,
             long long out_rs, long long n) {
  const int r = blockIdx.y;
  const float s = scale[r];
  const int8_t* qr = q + r * q_rs;
  float* orow = out + r * out_rs;
  const long long start = static_cast<long long>(blockIdx.x) * kThreads +
                          threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  long long done = 0;
  if (kVec) {
    const long long n4 = n / 4;
    const char4* q4 = reinterpret_cast<const char4*>(qr);
    float4* o4 = reinterpret_cast<float4*>(orow);
    for (long long i = start; i < n4; i += stride) {
      const char4 c = q4[i];
      float4 v;
      v.x = dequant_one(c.x, s);
      v.y = dequant_one(c.y, s);
      v.z = dequant_one(c.z, s);
      v.w = dequant_one(c.w, s);
      o4[i] = v;
    }
    done = n4 * 4;
  }
  for (long long i = done + start; i < n; i += stride)
    orow[i] = dequant_one(qr[i], s);
}

// every row start is `align`-byte aligned: the base pointer is, and a row
// stride of `stride` elements of `size` bytes keeps it so (one row needs no
// stride)
bool rows_aligned(const void* p, long long stride, int size, int rows,
                  int align) {
  if (p == nullptr) return true;
  if (reinterpret_cast<uintptr_t>(p) % align) return false;
  return rows == 1 || (stride * size) % align == 0;
}

int grid_blocks(long long n, int rows, int cap) {
  const long long want = (n / 4 + kThreads - 1) / kThreads;
  long long per_row = cap / rows;
  if (per_row < 1) per_row = 1;
  long long b = want < per_row ? want : per_row;
  return static_cast<int>(b < 1 ? 1 : b);
}

constexpr int kGridCap = 8192;  // CTAs over all rows: ~62 per SM on 132 SMs

bool quant_vec(const float* x, long long x_rs, const int8_t* q,
               long long q_rs, const float* res, long long res_rs, int rows) {
  return rows_aligned(x, x_rs, 4, rows, 16) &&
         rows_aligned(q, q_rs, 1, rows, 4) &&
         rows_aligned(res, res_rs, 4, rows, 16);
}

void launch_amax_partial(const float* x, long long x_rs, float* partial,
                         int rows, long long n, int blocks, cudaStream_t st) {
  if (rows_aligned(x, x_rs, 4, rows, 16))
    quant_amax_partial<true><<<dim3(blocks, rows), kThreads, 0, st>>>(
        x, x_rs, partial, n);
  else
    quant_amax_partial<false><<<dim3(blocks, rows), kThreads, 0, st>>>(
        x, x_rs, partial, n);
}

void launch_pack(const float* x, long long x_rs, int8_t* q, long long q_rs,
                 float* res, long long res_rs, const float* scale, int rows,
                 long long n, cudaStream_t st) {
  const bool vec = quant_vec(x, x_rs, q, q_rs, res, res_rs, rows);
  const dim3 grid(grid_blocks(n, rows, kGridCap), rows);
  if (vec && res)
    quant_int8<true, true><<<grid, kThreads, 0, st>>>(x, x_rs, q, q_rs, res,
                                                      res_rs, scale, n);
  else if (vec)
    quant_int8<true, false><<<grid, kThreads, 0, st>>>(x, x_rs, q, q_rs, res,
                                                       res_rs, scale, n);
  else if (res)
    quant_int8<false, true><<<grid, kThreads, 0, st>>>(x, x_rs, q, q_rs, res,
                                                       res_rs, scale, n);
  else
    quant_int8<false, false><<<grid, kThreads, 0, st>>>(x, x_rs, q, q_rs, res,
                                                        res_rs, scale, n);
}

}  // namespace

// Blocks the amax stage uses a row: the wrapper allocates rows·blocks floats
// of scratch for its partials.
extern "C" int quant_amax_blocks(long long n, int rows) {
  return grid_blocks(n, rows, 1024);
}

// Quantizes `rows` rows of n floats (row r at x + r·x_rs) into q (row stride
// q_rs) and their scales, and, if `res` is not null, writes the residual
// x − q·scale (row stride res_rs). `partial` holds rows·quant_amax_blocks(n,
// rows) floats of scratch. Launches three kernels on `stream` and returns
// cudaGetLastError(): 0 when every launch was accepted.
extern "C" int quant_int8_f32(const float* x, long long x_rs, int8_t* q,
                              long long q_rs, float* res, long long res_rs,
                              float* scale, float* partial, int rows,
                              long long n, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int ab = quant_amax_blocks(n, rows);
  launch_amax_partial(x, x_rs, partial, rows, n, ab, st);
  quant_scale<true><<<rows, kThreads, 0, st>>>(partial, ab, scale);
  launch_pack(x, x_rs, q, q_rs, res, res_rs, scale, rows, n, st);
  return static_cast<int>(cudaGetLastError());
}

// amax[r] = max_j |x[r, j]| (NaN kept, no floor) of `rows` rows of n floats;
// `partial` holds rows·quant_amax_blocks(n, rows) floats of scratch. Two
// launches on `stream`; returns cudaGetLastError().
extern "C" int quant_amax_f32(const float* x, long long x_rs, float* amax,
                              float* partial, int rows, long long n,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int ab = quant_amax_blocks(n, rows);
  launch_amax_partial(x, x_rs, partial, rows, n, ab, st);
  quant_scale<false><<<rows, kThreads, 0, st>>>(partial, ab, amax);
  return static_cast<int>(cudaGetLastError());
}

// quant_int8_f32 with each row's amax given (amax[r], e.g. the max over the
// shards of a leaf): scale[r] from it as quant_int8_f32 takes it from its own
// partials, then the pack (and the residual if `res` is not null). Two
// launches on `stream`; returns cudaGetLastError().
extern "C" int quant_int8_given_amax_f32(const float* x, long long x_rs,
                                         int8_t* q, long long q_rs,
                                         float* res, long long res_rs,
                                         const float* amax, float* scale,
                                         int rows, long long n,
                                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  quant_scale<true><<<rows, kThreads, 0, st>>>(amax, 1, scale);
  launch_pack(x, x_rs, q, q_rs, res, res_rs, scale, rows, n, st);
  return static_cast<int>(cudaGetLastError());
}

// out = f32(q)·scale, row by row (row r of q at q + r·q_rs, of out at
// out + r·out_rs). One launch on `stream`; returns cudaGetLastError().
extern "C" int dequant_int8_f32(const int8_t* q, long long q_rs,
                                const float* scale, float* out,
                                long long out_rs, int rows, long long n,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = rows_aligned(q, q_rs, 1, rows, 4) &&
                   rows_aligned(out, out_rs, 4, rows, 16);
  const dim3 grid(grid_blocks(n, rows, kGridCap), rows);
  if (vec)
    dequant_int8<true><<<grid, kThreads, 0, st>>>(q, q_rs, scale, out, out_rs,
                                                  n);
  else
    dequant_int8<false><<<grid, kThreads, 0, st>>>(q, q_rs, scale, out,
                                                   out_rs, n);
  return static_cast<int>(cudaGetLastError());
}
