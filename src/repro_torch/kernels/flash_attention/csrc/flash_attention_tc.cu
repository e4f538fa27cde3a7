// Flash attention, forward, bf16, on Hopper's tensor cores (sm_90a):
// grouped-query attention with an online softmax and causal / prefix masks.
//
//   o[b, i, h] = Σ_j softmax_j(⟨q[b, i, h], k[b, j, h / group]⟩ / √dh) · v[b, j, h / group]
//
// over the visible keys j of row i:
//   causal                     j ≤ i  or  j < prefix_len
//   not causal, prefix_len > 0 j < prefix_len
//   not causal, prefix_len = 0 every j < T
//
// Replaces repro/kernels/flash_attention/kernel.py::_fa_kernel for bf16
// inputs (launched there by flash_attention_padded, through
// ops.py::flash_attention); flash_attention.cu keeps serving f32 inputs and
// the bf16 inputs whose strides TMA cannot describe (ops.py::kernel_for).
//
// Bound: at the serving path's prefill (B = 4, S = T = 1920, H = 15, KV = 5,
// dh = 64, causal) the visible (row, key) pairs need 4·dh flops each, 28.3
// GFLOP, 28.6 µs at 989 TFLOP/s on the bf16 tensor cores, against 39.3 MB of
// q, k, v and o, 11.7 µs at 3.35 TB/s: operations bind. This kernel does
// 6·dh flops a pair (the split probabilities below), a 43 µs floor, and
// about 118 M exp2 on the SFUs.
//
// What the design does about each limit of flash_attention.cu:
//
//   * Both products on the tensor cores, by wgmma. S = Q·Kᵀ is m64 × n(BK)
//     × k16 with both operands K-major in shared memory; O += P·V takes P
//     from registers (the S accumulator fragment converted in place) and V
//     MN-major in shared memory through the transpose bit: no transposed
//     copy of V, no trip of P through shared memory.
//   * The f32 limit with bf16 operands. A kernel that rounds P to bf16 is
//     ~2⁻⁹ off the f32 softmax and fails the bf16 limit (one bf16 ulp of the
//     output). So P = P_hi + P_lo, P_hi = bf16(p), P_lo = bf16(p − P_hi), and
//     O += P_hi·V + P_lo·V: p is kept to ~2⁻¹⁷ relative. Q·Kᵀ needs no split:
//     products of bf16 values are exact in the f32 accumulators.
//   * Asynchronous loads. One producer warp issues TMA copies: Q once, then
//     K and V tiles into a ring of two stages, each completing on its own
//     mbarrier, so S of a tile starts before its V has landed and the next
//     tile's loads overlap this tile's math. The consumers free a stage on
//     an "empty" mbarrier. 128-byte swizzle: a 64-wide bf16 row chunk is
//     exactly 128 bytes, and wgmma reads the swizzled tiles conflict-free.
//     TMA's zero fill beyond the tensor's edge stands in for masked loads at
//     ragged S, T and dh; q, k and v are read in place through their strides
//     (4-D maps, dh × heads × rows × batch; the KV head is h / group).
//   * Tiles in bf16. One CTA owns 128 q rows of one (batch, query head): two
//     consumer warpgroups of 64 rows (wgmma's M) and the producer warp, 288
//     threads. At dh ≤ 64, KV tiles of 64 keys and two CTAs an SM (96
//     registers a thread, 49 KB of shared memory a CTA): the CTAs' phases
//     drift apart, so one's softmax hides the other's products (PERF.md
//     has the times against one CTA an SM with 128-key tiles). At dh ≤ 128,
//     128 keys and one CTA (160 KB); at dh ≤ 256, 64 keys and one CTA (O
//     is 64·dh/128 f32 a thread; 193 KB).
//
// Kept from flash_attention.cu: q tiles issued longest first, a KV loop that
// ends at the last tile holding a visible key (each warpgroup stops
// computing at its own), masks applied only on the tiles that straddle
// them, the −1e30 sentinel and o / max(l, 1e-30). Scale and log₂e are
// folded into one multiply and exponentials are exp2f. The row max and
// sum come from the accumulator fragment's quad shuffles in a fixed order,
// with no atomics, so two launches on the same inputs give the same bits.
//
// Fragments (wgmma's f32 accumulator, per warpgroup): thread t, warp w =
// t / 32, lane l holds rows 16w + l/4 and 16w + l/4 + 8 of the 64; register
// 4j + e holds column 8j + 2(l % 4) + (e & 1) of row 16w + l/4 + 8(e >> 1).
// Registers 8k..8k+7 of S are then exactly the bf16 A fragment of P's k-th
// 16-key slice.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 128;          // q rows a CTA: two warpgroups of 64
constexpr int kConsumers = 256;   // the two consumer warpgroups
constexpr int kThreads = kConsumers + 32;  // and the producer warp
constexpr int kStages = 2;        // K/V ring
constexpr int kRow = 128;         // bytes of one 64-wide bf16 row chunk
constexpr int kChunk = 64;        // head-dim elements of one chunk
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// DC chunks of 64 along dh (dh ≤ 64 · DC). At dh ≤ 64 two CTAs share an
// SM (64-key tiles keep a consumer thread under 128 registers): one CTA's
// softmax then runs beside the other's products, which a CTA's own two
// warpgroups, waiting on the same tiles, rarely do.
template <int DC>
struct Tile {
  static constexpr int CTAS = DC == 1 ? 2 : 1;        // CTAs an SM
  static constexpr int BK = DC == 2 ? 128 : 64;       // keys a KV tile
  static constexpr int Q_BYTES = kBQ * kRow * DC;
  static constexpr int KV_BYTES = BK * kRow * DC;     // one K or V stage
  static constexpr int BAR_BYTES = 8 * (1 + 3 * kStages);
  // + 1024: the swizzled tiles start at a 1024-byte boundary
  static constexpr int SMEM =
      1024 + Q_BYTES + 2 * kStages * KV_BYTES + BAR_BYTES;
};

struct Params {
  __nv_bfloat16* o;
  int s, t, h, kvh, dh, causal, prefix_len;
  float scale_log2;  // softmax scale · log2(e)
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

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("{\n.reg .b64 state;\n"
               "mbarrier.arrive.shared::cta.b64 state, [%0];\n}\n"
               :: "r"(bar) : "memory");
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// returns once the phase of parity `parity` has completed. A wait longer
// than kWatchdogNs (a copy never lands: a bad map) traps, so that the
// launch fails with an error instead of hanging the card.
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

// one (64 × 1 × rows × 1) box of a 4-D map at (d0, head, row0, batch)
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int d0, int head,
                                         int row0, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
         "r"(d0), "r"(head), "r"(row0), "r"(batch)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled tile at `addr`
// (1024-byte aligned up to the 32-byte k-step offsets of a K-major
// operand): 8-row groups 1024 bytes apart. For a K-major operand that is
// the stride byte offset and the leading one is unused; for the MN-major V
// at n = 64 one swizzle atom spans all of n, and 1024 is the stride between
// its 8-key groups. Both offsets are set to it.
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1024 >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// pins registers that a wgmma writes or reads asynchronously to this point
// of the program: no read is hoisted above it, no register reused below it
template <int N>
__device__ __forceinline__ void pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t (&d)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(d[i][j]) :: "memory");
}

// d (+)= A·B, A (64 × 16) and B (16 × 128) both K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (+)= A·B, A (64 × 16) and B (16 × 64) both K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += A·B, A (64 × 16 bf16) in registers, B (16 × 64) MN-major in
// shared memory (the transpose bit)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo_col, float hi_col) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo_col, hi_col);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ bool visible(const Params& a, int row, int col) {
  if (col >= a.t) return false;
  if (a.causal) return col <= row || col < a.prefix_len;
  return a.prefix_len == 0 || col < a.prefix_len;
}

// one past the last key that some row below `row_end` sees
__device__ __forceinline__ int keys_seen(const Params& a, int row_end) {
  if (a.causal) return min(a.t, max(min(row_end, a.s), a.prefix_len));
  if (a.prefix_len > 0) return min(a.t, a.prefix_len);
  return a.t;
}

template <int DC>
__global__ void __launch_bounds__(kThreads, Tile<DC>::CTAS)
    fa_tc_fwd(const __grid_constant__ CUtensorMap tm_q,
              const __grid_constant__ CUtensorMap tm_k,
              const __grid_constant__ CUtensorMap tm_v, const Params a) {
  using T = Tile<DC>;
  constexpr int BK = T::BK;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t q_s = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t k_s = q_s + T::Q_BYTES;             // + stage · KV_BYTES
  const uint32_t v_s = k_s + kStages * T::KV_BYTES;  // + stage · KV_BYTES
  const uint32_t bar_q = v_s + kStages * T::KV_BYTES;
  auto full_k = [&](int st) { return bar_q + 8u * (1 + st); };
  auto full_v = [&](int st) { return bar_q + 8u * (1 + kStages + st); };
  auto empty = [&](int st) { return bar_q + 8u * (1 + 2 * kStages + st); };

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBQ;  // longest tiles first
  const int n_kt = (keys_seen(a, q0 + kBQ) + BK - 1) / BK;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full_k(st), 1);
      mbar_init(full_v(st), 1);
      mbar_init(empty(st), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // the producer warp: one thread issues every copy
    if (threadIdx.x == kConsumers) {
      const int kv_head = h / (a.h / a.kvh);
      mbar_expect_tx(bar_q, T::Q_BYTES);
#pragma unroll
      for (int c = 0; c < DC; ++c)
        tma_load(q_s + c * kBQ * kRow, &tm_q, bar_q, c * kChunk, h, q0, b);
      for (int kt = 0; kt < n_kt; ++kt) {
        const int st = kt % kStages;
        mbar_wait(empty(st), ((kt / kStages) & 1) ^ 1);
        const uint32_t ks = k_s + st * T::KV_BYTES;
        const uint32_t vs = v_s + st * T::KV_BYTES;
        mbar_expect_tx(full_k(st), T::KV_BYTES);
#pragma unroll
        for (int c = 0; c < DC; ++c)
          tma_load(ks + c * BK * kRow, &tm_k, full_k(st), c * kChunk, kv_head,
                   kt * BK, b);
        mbar_expect_tx(full_v(st), T::KV_BYTES);
#pragma unroll
        for (int c = 0; c < DC; ++c)
          tma_load(vs + c * BK * kRow, &tm_v, full_v(st), c * kChunk, kv_head,
                   kt * BK, b);
      }
    }
    return;
  }

  // a consumer warpgroup: rows row_lo..row_lo+63 of the CTA's tile
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  const int row_lo = q0 + 64 * wg;
  const int r0 = row_lo + 16 * warp + lane / 4;  // and r0 + 8
  const int cq = 2 * (lane % 4);
  const int n_wg = (keys_seen(a, row_lo + 64) + BK - 1) / BK;
  const uint32_t q_wg = q_s + wg * 64 * kRow;

  float o[DC][32];
#pragma unroll
  for (int c = 0; c < DC; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[c][i] = 0.0f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.0f, 0.0f};

  mbar_wait(bar_q, 0);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int st = kt % kStages;
    const uint32_t parity = (kt / kStages) & 1;
    const uint32_t ks = k_s + st * T::KV_BYTES;
    const uint32_t vs = v_s + st * T::KV_BYTES;
    if (kt >= n_wg) {
      // no row of this warpgroup sees the tile: free the stage in turn
      mbar_wait(full_k(st), parity);
      mbar_wait(full_v(st), parity);
      mbar_arrive(empty(st));
      continue;
    }
    const int k0 = kt * BK;

    // S = Q · Kᵀ over dh in k-steps of 16
    float s[BK / 2];
    mbar_wait(full_k(st), parity);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4 * DC; ++kk) {
      const uint64_t da = desc(q_wg + (kk / 4) * kBQ * kRow + (kk % 4) * 32);
      const uint64_t db = desc(ks + (kk / 4) * BK * kRow + (kk % 4) * 32);
      if constexpr (BK == 128)
        wgmma_ss_n128(s, da, db, kk > 0);
      else
        wgmma_ss_n64(s, da, db, kk > 0);
    }
    wg_commit();
    wg_wait_all();
    pin(s);

    // scale into the log2 domain; mask only a tile that straddles a mask
    const int k1 = k0 + BK;
    bool whole = k1 <= a.t;
    if (a.causal)
      whole = whole && (k1 - 1 <= row_lo || k1 <= a.prefix_len);
    else if (a.prefix_len > 0)
      whole = whole && k1 <= a.prefix_len;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      float x = s[i] * a.scale_log2;
      if (!whole) {
        const int row = r0 + 8 * ((i >> 1) & 1);
        const int col = k0 + 8 * (i / 4) + cq + (i & 1);
        x = visible(a, row, col) ? x : kNegInf;
      }
      s[i] = x;
    }

    // running max (the quad's four lanes hold a row), rescale l and o
    float mn[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < BK / 2; ++i)
      mn[(i >> 1) & 1] = fmaxf(mn[(i >> 1) & 1], s[i]);
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mn[r] = fmaxf(mn[r], __shfl_xor_sync(0xffffffffu, mn[r], 1));
      mn[r] = fmaxf(mn[r], __shfl_xor_sync(0xffffffffu, mn[r], 2));
      corr[r] = exp2f(m[r] - mn[r]);
      m[r] = mn[r];
      l[r] *= corr[r];
    }
#pragma unroll
    for (int c = 0; c < DC; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[c][i] *= corr[(i >> 1) & 1];

    // p = exp2(s − m), summed into l in f32, split into the bf16 A
    // fragments of P_hi and P_lo
    uint32_t p_hi[BK / 16][4], p_lo[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = j & 1;
        const float p0 = exp2f(s[8 * kk + 2 * j] - m[r]);
        const float p1 = exp2f(s[8 * kk + 2 * j + 1] - m[r]);
        l[r] += p0;
        l[r] += p1;
        const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
        const float2 hf = __bfloat1622float2(hi);
        p_hi[kk][j] = *reinterpret_cast<const uint32_t*>(&hi);
        p_lo[kk][j] = pack_bf16(p0 - hf.x, p1 - hf.y);
      }

    // O += P_hi · V + P_lo · V, 16 keys a step, one 64-wide chunk of dh at
    // a time
    mbar_wait(full_v(st), parity);
#pragma unroll
    for (int c = 0; c < DC; ++c) pin(o[c]);
    wg_fence();
#pragma unroll
    for (int c = 0; c < DC; ++c)
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t dv = desc(vs + c * BK * kRow + kk * 16 * kRow);
        wgmma_rs_n64(o[c], p_hi[kk], dv);
        wgmma_rs_n64(o[c], p_lo[kk], dv);
      }
    wg_commit();
    wg_wait_all();
#pragma unroll
    for (int c = 0; c < DC; ++c) pin(o[c]);
    pin(p_hi);
    pin(p_lo);
    mbar_arrive(empty(st));
  }

  // the row sums of l over the quad, then o / max(l, 1e-30) in bf16
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    if (row >= a.s) continue;
    __nv_bfloat16* op = a.o + (static_cast<long long>(b) * a.s + row) *
                                  a.h * a.dh + static_cast<long long>(h) * a.dh;
    const float denom = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int c = 0; c < DC; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = c * kChunk + 8 * j + cq;
        const float x0 = o[c][4 * j + 2 * r] / denom;
        const float x1 = o[c][4 * j + 2 * r + 1] / denom;
        if (col + 1 < a.dh && (a.dh & 1) == 0) {
          *reinterpret_cast<__nv_bfloat162*>(op + col) =
              __floats2bfloat162_rn(x0, x1);
        } else {
          if (col < a.dh) op[col] = __float2bfloat16(x0);
          if (col + 1 < a.dh) op[col + 1] = __float2bfloat16(x1);
        }
      }
  }
}

// cuTensorMapEncodeTiled, taken from the driver through the runtime, so the
// library links no libcuda
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// error codes beside CUDA's own
constexpr int kNoEncoder = 90000;   // the driver has no cuTensorMapEncodeTiled
constexpr int kEncodeFailed = 91000;  // + the CUresult of the encode

// the 4-D map (dh, heads, rows, batch) of a bf16 (B, rows, heads, dh) tensor
// with a unit last stride, in boxes of 64 × 1 × box_rows × 1, 128-byte
// swizzled, zero beyond every edge
int make_map(CUtensorMap* map, const void* ptr, long long sb, long long ss,
             long long sh, int batch, int rows, int heads, int dh,
             int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return kNoEncoder;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(dh),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(ss) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {kChunk, 1, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeFailed + static_cast<int>(r);
}

template <int DC>
int launch(const void* q, long long q_sb, long long q_ss, long long q_sh,
           const void* k, long long k_sb, long long k_ss, long long k_sh,
           const void* v, long long v_sb, long long v_ss, long long v_sh,
           int b, const Params& p, cudaStream_t stream) {
  using T = Tile<DC>;
  CUtensorMap mq, mk, mv;
  int err = make_map(&mq, q, q_sb, q_ss, q_sh, b, p.s, p.h, p.dh, kBQ);
  if (err == 0)
    err = make_map(&mk, k, k_sb, k_ss, k_sh, b, p.t, p.kvh, p.dh, T::BK);
  if (err == 0)
    err = make_map(&mv, v, v_sb, v_ss, v_sh, b, p.t, p.kvh, p.dh, T::BK);
  if (err != 0) return err;
  const cudaError_t attr = cudaFuncSetAttribute(
      fa_tc_fwd<DC>, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(p.h, b, (p.s + kBQ - 1) / kBQ);
  fa_tc_fwd<DC><<<grid, kThreads, T::SMEM, stream>>>(mq, mk, mv, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches the kernel on `stream` and returns the CUDA error of the launch
// (0 when it was accepted; 90000 when the driver has no tensor-map encoder,
// 91000 + its CUresult when it refused a map). q (B, S, H, dh), k and v
// (B, T, KV, dh), all bfloat16 with a unit last stride and the given batch,
// sequence and head strides (in elements), each a multiple of 8 (16 bytes),
// on 16-byte aligned bases; o is (B, S, H, dh), contiguous. dh ≤ 256, H a
// multiple of KV; the wrapper checks all of it (ops.py::kernel_for).
extern "C" int flash_attention_tc_fwd(
    const void* q, long long q_sb, long long q_ss, long long q_sh,
    const void* k, long long k_sb, long long k_ss, long long k_sh,
    const void* v, long long v_sb, long long v_ss, long long v_sh, void* o,
    int b, int s, int t, int h, int kvh, int dh, int causal, int prefix_len,
    float scale, void* stream) {
  const Params p{static_cast<__nv_bfloat16*>(o), s, t, h, kvh, dh, causal,
                 prefix_len, scale * kLog2e};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dh <= 64)
    return launch<1>(q, q_sb, q_ss, q_sh, k, k_sb, k_ss, k_sh, v, v_sb, v_ss,
                     v_sh, b, p, st);
  if (dh <= 128)
    return launch<2>(q, q_sb, q_ss, q_sh, k, k_sb, k_ss, k_sh, v, v_sb, v_ss,
                     v_sh, b, p, st);
  return launch<4>(q, q_sb, q_ss, q_sh, k, k_sb, k_ss, k_sh, v, v_sb, v_ss,
                   v_sh, b, p, st);
}
