// Hinge block-subgradient for Hopper (sm_90a): one launch a call, one thread
// block cluster a worker, X streamed once through shared memory.
//
//   out[k] = w[k] − (C/n)·Σᵢ 1{1 − y[k,i]·⟨x[k,i], w[k]⟩ > 0}·y[k,i]·x[k,i]
//
// Replaces repro/kernels/hinge/kernel.py::_hinge_kernel (launched there by
// hinge_block_grad_padded). The TPU kernel reads X from HBM once because
// VMEM holds a 512-row block and the sequential grid carries the sum; this
// kernel gets the same property from the card's own means:
//
//   * Worker k is one cluster of G CTAs (G ≤ 8, the portable limit); CTA
//     rank r owns the contiguous rows [r·rows, (r+1)·rows) ∩ [0, n).
//   * The rows stream into a ring of `slots` shared-memory stages of
//     `stage_rows` rows. A stage's rows are contiguous in X, so thread 0
//     moves them as one 1-D bulk async copy (no tensor map, no registers
//     spent on the copy); the threads below stage_rows copy the stage's y
//     with 4-byte cp.async. Every copy completes on the slot's mbarrier.
//   * Thread t owns the float4 columns q = t + 256·j (j < kMaxQuads). It
//     reads its columns of a stage's rows from shared memory once, into
//     registers, for both products. The margin of a row: the thread's
//     share of ⟨x, w⟩ (w in registers), a fixed xor-shuffle tree in the
//     warp, then, after the stage's one __syncthreads, the 8 warps' sums in
//     warp order; the hinge test gives the row's coefficient y·viol, and
//     coef·x is added to the thread's column sums in registers. The slot is
//     refilled as soon as the barrier has passed.
//   * The sum over the worker's rows, in distributed shared memory: each
//     CTA stores its sums of rank g's columns into rank g's shared memory
//     (slot `rank`); a cluster barrier makes them visible; rank r adds its
//     G slots in rank order and writes w − (C·Σ)/n. The barrier's first
//     phase (every CTA has started, so its shared memory may be written)
//     is arrived at on entry and waited for only before the stores, and no
//     CTA touches another's memory after the second, so none waits again
//     before it leaves.
//
// No partial buffer in device memory and no float atomics: every sum is
// taken in a fixed order, so two launches on the same inputs give the same
// bits. No padded copy of X: a short last stage and a short last run are
// sized in the kernel. Bulk copies need 16-byte aligned addresses and
// sizes, so the wrapper sends only d % 4 == 0, 16-byte aligned bases and
// 16-byte worker strides of x and w here; other rows take hinge.cu.
//
// Bound: two GEMVs over X, 4·K·n·d flops against K·n·d·4 bytes, about one
// flop a byte, so the kernel is memory-bound: X read once from HBM,
// K·n·d·4 bytes / 3.35 TB/s (H100 SXM); 16.4 MB, about 4.9 µs, at the
// epsilon main path's K=32, n=64, d=2000. There the wrapper's plan makes 8
// CTAs of 8 rows a worker (256 CTAs, all resident: 3 an SM fit by shared
// memory and registers, 45 clusters, where 2 an SM would fit only 30), in 2
// stages of 4 rows (32 KB) through a ring of one: fewer stages cost fewer
// barrier rounds, and more bytes in flight a CTA measured slower
// (scripts/hinge_variants.py).
//
// Columns: d ≤ kThreads·4·kMaxQuads = 2048 (a thread's columns of a stage,
// of w and of the sums live in registers); wider rows take hinge.cu.
// Launch: cudaLaunchKernelEx with the cluster-dimension attribute, which a
// CUDA graph captures.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 4;         // slots the ring may have
constexpr int kMaxQuads = 2;       // float4 columns a thread owns
constexpr int kMaxStageRows = 4;   // rows a stage holds
constexpr int kMaxCluster = 8;
// CTAs an SM must hold at once, so that the registers (at most 85 a thread)
// leave room for 3: at 2 an SM only 30 clusters of 8 fit on the card, and
// the main path's 32 would run in two waves
constexpr int kMinBlocks = 3;

struct Args {
  const float* x;
  long long x_ws;
  const float* y;
  long long y_ws;
  const float* w;
  long long w_ws;
  float* out;
  int n, d;            // rows, columns (a multiple of 4)
  int g, rows;         // CTAs a cluster, rows a CTA
  int stage_rows;      // rows a stage, at most kMaxStageRows
  int slots;           // stages in the ring, at most kStages
  float c;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// returns once the phase of parity `parity` has completed. A wait longer
// than kWatchdogNs (a copy never lands) traps, so that the launch fails with
// an error instead of hanging the card.
constexpr uint64_t kWatchdogNs = 4000000000ull;
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint64_t since = 0;
  for (;;) {
    uint32_t done;
    asm volatile("{\n.reg .pred p;\n"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 "selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    const uint64_t now = global_ns();
    if (since == 0)
      since = now;
    else if (now - since > kWatchdogNs)
      __trap();
  }
}

// `bytes` (a multiple of 16) from 16-byte aligned global `src` to shared
// `dst`, completing on `bar`'s transaction count
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

__device__ __forceinline__ void copy4(uint32_t dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(dst), "l"(src) : "memory");
}

// arrives on `bar` once this thread's earlier cp.async copies have landed
__device__ __forceinline__ void copy4_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
               :: "r"(bar) : "memory");
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float s) {
  s = fmaf(a.x, b.x, s);
  s = fmaf(a.y, b.y, s);
  s = fmaf(a.z, b.z, s);
  return fmaf(a.w, b.w, s);
}

__device__ __forceinline__ void axpy4(float c, float4 a, float4& s) {
  s.x = fmaf(c, a.x, s.x);
  s.y = fmaf(c, a.y, s.y);
  s.z = fmaf(c, a.z, s.z);
  s.w = fmaf(c, a.w, s.w);
}

// Shared memory: kStages mbarriers; the warps' row sums of two stages
// (2 × kMaxStageRows × kWarps); each slot's y (kStages × kMaxStageRows); the
// column sums received from every rank of the cluster (g slots of `per`
// float4 columns); then the ring's rows (slots × stage_rows × d floats).
constexpr int kRedFloats = 2 * kMaxStageRows * kWarps;
constexpr int kYFloats = kStages * kMaxStageRows;

__global__ void __launch_bounds__(kThreads, kMinBlocks)
hinge_cluster(const Args a) {
  cg::cluster_group cluster = cg::this_cluster();
  // phase 1 of the cluster barrier: this CTA has started
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  extern __shared__ __align__(16) unsigned char smem[];
  const int d4 = a.d / 4;
  const int per = (d4 + a.g - 1) / a.g;  // float4 columns a rank writes
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  float* red = reinterpret_cast<float*>(smem + 8 * kStages);
  float* ys = red + kRedFloats;
  float4* recv = reinterpret_cast<float4*>(ys + kYFloats);
  float* ring = reinterpret_cast<float*>(recv + a.g * per);
  const int rank = blockIdx.x;
  const int k = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int slot = a.stage_rows * a.d;
  const int row0 = rank * a.rows;
  const int nrows = min(a.rows, a.n - row0);
  const int nstages = (nrows + a.stage_rows - 1) / a.stage_rows;
  const float* xk = a.x + k * a.x_ws + static_cast<long long>(row0) * a.d;
  const float* yk = a.y + k * a.y_ws + row0;
  const float4* wk = reinterpret_cast<const float4*>(a.w + k * a.w_ws);

  // stage i into slot i % slots, completing on the slot's mbarrier, which
  // expects 1 + stage_rows arrivals: thread 0's with the rows' bytes
  // (bulk_rows) and one from each thread below stage_rows once its y has
  // landed (copy_y)
  auto bulk_rows = [&](int i) {
    const int r0 = i * a.stage_rows;
    const uint32_t bytes = 4u * min(a.stage_rows, nrows - r0) * a.d;
    const uint32_t bar = smem_u32(bars + i % a.slots);
    mbar_expect_tx(bar, bytes);
    if (bytes)
      bulk_copy(smem_u32(ring + (i % a.slots) * slot),
                xk + static_cast<long long>(r0) * a.d, bytes, bar);
  };
  auto copy_y = [&](int i) {
    const int s = i % a.slots;
    const int r0 = i * a.stage_rows;
    if (tid < min(a.stage_rows, nrows - r0))
      copy4(smem_u32(ys + s * kMaxStageRows + tid), yk + r0 + tid);
    if (tid < a.stage_rows) copy4_arrive(smem_u32(bars + s));
  };
  const int first = min(a.slots, nstages);
  if (tid == 0) {
    for (int s = 0; s < a.slots; ++s)
      mbar_init(smem_u32(bars + s), 1 + a.stage_rows);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int i = 0; i < first; ++i) bulk_rows(i);
  }
  __syncthreads();
  for (int i = 0; i < first; ++i) copy_y(i);

  // w at this thread's columns, loaded while the first stages land
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 wr[kMaxQuads], acc[kMaxQuads];
#pragma unroll
  for (int j = 0; j < kMaxQuads; ++j) {
    const int q = tid + j * kThreads;
    wr[j] = q < d4 ? __ldg(wk + q) : zero;
    acc[j] = zero;
  }

  for (int i = 0; i < nstages; ++i) {
    const int s = i % a.slots;
    const int rn = min(a.stage_rows, nrows - i * a.stage_rows);
    mbar_wait(smem_u32(bars + s), (i / a.slots) & 1);
    const float4* xs = reinterpret_cast<const float4*>(ring + s * slot);
    const float* yst = ys + s * kMaxStageRows;
    float* redi = red + (i & 1) * kMaxStageRows * kWarps;

    // the stage's y and this thread's columns of its rows into registers,
    // read from shared memory once; each row's margin: this thread's share
    // of ⟨x, w⟩, then the warp's by a fixed xor tree
    float4 xr[kMaxStageRows][kMaxQuads];
    float yr[kMaxStageRows];
#pragma unroll
    for (int r = 0; r < kMaxStageRows; ++r) {
      if (r >= rn) break;
      yr[r] = yst[r];
      float p = 0.0f;
#pragma unroll
      for (int j = 0; j < kMaxQuads; ++j) {
        const int q = tid + j * kThreads;
        xr[r][j] = q < d4 ? xs[r * d4 + q] : zero;
        p = dot4(xr[r][j], wr[j], p);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        p += __shfl_xor_sync(0xffffffffu, p, off);
      if (lane == 0) redi[r * kWarps + warp] = p;
    }
    // the row sums are written; the slot is free (its rows and y are in
    // registers): refill it with the stage `slots` on
    __syncthreads();
    if (i + a.slots < nstages) {
      if (tid == 0) bulk_rows(i + a.slots);
      copy_y(i + a.slots);
    }

    // each row's coefficient y·viol (the warps' sums in warp order), then
    // coef·x into this thread's columns, rows in order. These row sums are
    // not overwritten before the next stage's barrier.
#pragma unroll
    for (int r = 0; r < kMaxStageRows; ++r) {
      if (r >= rn) break;
      float m = redi[r * kWarps];
#pragma unroll
      for (int v = 1; v < kWarps; ++v) m += redi[r * kWarps + v];
      const float coef = (1.0f - yr[r] * m > 0.0f) ? yr[r] : 0.0f;
#pragma unroll
      for (int j = 0; j < kMaxQuads; ++j) axpy4(coef, xr[r][j], acc[j]);
    }
  }

  // every CTA of the cluster has started (phase 1): store this CTA's sums of
  // rank g's columns into rank g's slot `rank`; phase 2 makes them visible
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
#pragma unroll
  for (int j = 0; j < kMaxQuads; ++j) {
    const int q = tid + j * kThreads;
    if (q < d4) {
      const int g = q / per;
      cluster.map_shared_rank(recv, g)[rank * per + q - g * per] = acc[j];
    }
  }
  // w at the columns of rank r's output this thread writes, loaded while
  // the cluster meets
  const int q0 = rank * per;
  const int q1 = min(d4, q0 + per);
  float4 wo[kMaxQuads];
#pragma unroll
  for (int j = 0; j < kMaxQuads; ++j) {
    const int q = q0 + tid + j * kThreads;
    wo[j] = q < q1 ? __ldg(wk + q) : zero;
  }
  cluster.sync();

  // rank r's columns: the ranks' sums in rank order, then w − (C·Σ)/n
  const float n = static_cast<float>(a.n);
  float4* outk =
      reinterpret_cast<float4*>(a.out + static_cast<long long>(k) * a.d);
#pragma unroll
  for (int j = 0; j < kMaxQuads; ++j) {
    const int q = tid + j * kThreads;  // this rank's column q0 + q
    if (q0 + q >= q1) continue;
    float4 sum = recv[q];
    for (int g = 1; g < a.g; ++g) {
      const float4 v = recv[g * per + q];
      sum.x += v.x;
      sum.y += v.y;
      sum.z += v.z;
      sum.w += v.w;
    }
    outk[q0 + q] = make_float4(wo[j].x - (a.c * sum.x) / n,
                               wo[j].y - (a.c * sum.y) / n,
                               wo[j].z - (a.c * sum.z) / n,
                               wo[j].w - (a.c * sum.w) / n);
  }
}

size_t smem_bytes(int d, int g, int stage_rows, int slots) {
  const int per = (d / 4 + g - 1) / g;
  return 8 * kStages +
         4 * (kRedFloats + kYFloats + 4 * g * per +
              static_cast<size_t>(slots) * stage_rows * d);
}

cudaLaunchConfig_t config(int g, int k, size_t smem, cudaStream_t stream,
                          cudaLaunchAttribute* attr) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = g;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(g, k, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

// One launch on `stream`: K clusters of `g` CTAs, `rows` rows a CTA in
// stages of `stage_rows` through a ring of `slots`. The caller has checked
// d % 4 == 0 and 16-byte aligned bases and worker strides of x and w.
// `out` holds k·d floats (16-byte aligned), written once. Returns
// cudaLaunchKernelEx's error, else cudaGetLastError(): 0 when the launch
// was accepted.
extern "C" int hinge_cluster_f32(const float* x, long long x_wstride,
                                 const float* y, long long y_wstride,
                                 const float* w, long long w_wstride,
                                 float* out, int k, int n, int d, int g,
                                 int rows, int stage_rows, int slots, float c,
                                 void* stream) {
  if (d % 4 || d > 4 * kThreads * kMaxQuads || g < 1 || g > kMaxCluster ||
      stage_rows < 1 || stage_rows > kMaxStageRows || slots < 1 ||
      slots > kStages)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{x, x_wstride, y, y_wstride, w, w_wstride, out, n, d, g, rows,
               stage_rows, slots, c};
  const size_t smem = smem_bytes(d, g, stage_rows, slots);
  cudaError_t e = cudaFuncSetAttribute(
      hinge_cluster, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      config(g, k, smem, static_cast<cudaStream_t>(stream), &attr);
  e = cudaLaunchKernelEx(&cfg, hinge_cluster, a);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// Dynamic shared memory a CTA of this plan takes, in bytes.
extern "C" int hinge_cluster_smem_bytes(int d, int g, int stage_rows,
                                        int slots) {
  return static_cast<int>(smem_bytes(d, g, stage_rows, slots));
}

// Clusters of `g` CTAs that the card can hold at once with this plan's
// shared memory (cudaOccupancyMaxActiveClusters), or a negative CUDA error.
extern "C" int hinge_cluster_max_active(int d, int g, int stage_rows,
                                        int slots) {
  const size_t smem = smem_bytes(d, g, stage_rows, slots);
  cudaError_t e = cudaFuncSetAttribute(
      hinge_cluster, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return -static_cast<int>(e);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = config(g, 1, smem, nullptr, &attr);
  int clusters = 0;
  e = cudaOccupancyMaxActiveClusters(
      &clusters, reinterpret_cast<const void*>(hinge_cluster), &cfg);
  return e == cudaSuccess ? clusters : -static_cast<int>(e);
}
