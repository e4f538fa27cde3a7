// Mamba2 SSD chunk scan, forward, bf16, on Hopper's tensor cores (sm_90a),
// from a zero state. Per batch b and head h, over chunks of Q steps
// (diagonal A, one B/C group shared by all heads):
//
//   cum_t  = Σ_{s≤t} Δ_s·A                               (in-chunk log-decay)
//   y_t    = Σ_{s≤t} (C_t·B_s) e^{cum_t − cum_s} Δ_s x_s  +  e^{cum_t} C_t·S_in
//   S_in  ← e^{cum_Q} S_in + Σ_s B_s (Δ_s e^{cum_Q − cum_s}) x_sᵀ
//
// y (B, L, H, P) in bf16 and the final state (B, H, N, P) in f32.
//
// Replaces repro/kernels/ssd/kernel.py::_ssd_kernel (kernel.py:32, launched
// there by ssd_scan_padded, through ops.py::ssd_scan) for bf16 x, B and C
// whose strides and bases a TMA map can describe; ssd.cu keeps serving f32
// and the other bf16 layouts (ops.py::kernel_for).
//
// Bound on the H100 SXM at the mamba2-2.7b prefill (B = 4, L = 1,920,
// H = 80, P = 64, N = 128, Q = 256): x and y 78.6 MB each, B and C 3.9 MB,
// Δ 2.5 MB, the state 10.5 MB: 174.2 MB, 52.0 µs at 3.35 TB/s. The chunked
// algorithm's products are 30.1 GFLOP, 30.5 µs at 989 TFLOP/s: bytes bind.
//
// ssd.cu walks the chunks in turn, one CTA per (head, batch), with f32 FMAs
// on the CUDA cores and C Bᵀ computed again for every head. This design is
// Mamba2's own chunk-state / state-passing / chunk-scan split, three
// launches on one stream:
//
//   1. ssd_tc_state, grid (chunk, head, batch): cum (fixed-order scan) to
//      scratch, and the chunk's own end state S_c = (B ∘ w)ᵀ X with
//      w_s = Δ_s e^{cum_Q − cum_s}, an (N × Q)·(Q × P) product on wgmma
//      (A from registers, X MN-major through the transpose bit).
//   2. ssd_tc_pass, grid (N·P tiles, head, batch): the chunks in order,
//      S_in[c] = e^{cum_Q[c−1]} S_in[c−1] + S_c[c−1], elementwise and in a
//      fixed order; S_in goes to scratch as bf16 hi + lo planes (what the
//      third launch's wgmma reads), the last one to the final state.
//   3. ssd_tc_scan, grid (row tile of 64 × chunk, head group, batch): C Bᵀ
//      once for the tile's source tiles s ≤ t, kept in shared memory, and
//      reused for every head of the group (8 heads at P ≤ 64, 4 above):
//      G_h = (C Bᵀ) ∘ L_h ∘ Δ_h from registers into G_h X_h, after
//      e^{cum_t} (C S_in,h), all on wgmma. The decay is exp2 of cum · log2 e
//      differences (one SFU op), masked only on the diagonal tile.
//
// Work: 2,560 (batch, chunk, head) items at mamba2's shape in place of 320
// serial walks. The cost of the split is the chunk states' round trip
// through device memory: S_c (84 MB in f32 at mamba2's shape) is written,
// read, written again as S_in and read by every row tile of its chunk
// (ordered next to each other, so mostly from L2): about 336 MB of
// traffic, about 100 µs at 3.35 TB/s, twice the function's bound.
//
// The f32 limit with bf16 operands. x, B and C are bf16, so C Bᵀ and the
// products with x are exact term by term. Three operands are f32: G, the
// weighted B ∘ w and S_in. One bf16 rounding of any of them fails the
// bounds the kernel is held to (tests/test_torch_ssd_tc.py shows it), so
// each is split into hi = bf16(v) and lo = bf16(v − hi) and goes through
// two products: v is kept to ~2⁻¹⁶ relative.
//
// Overlap. Each warpgroup builds the next tile's bf16 A fragments (B ∘ w in
// launch 1, G in launch 3) while the current tile's products run, and
// launch 3 builds the first G while C S_in runs. X tiles come through a
// ring of two stages, loaded one ahead of their use (four stages measured
// no faster); the first one, the first head's S_in and every head's cum
// and Δ land while C Bᵀ is computed. The outputs (S_c in f32, y in bf16)
// go through shared memory, so that their rows leave in 16-byte stores.
// Launch 3 holds one CTA an SM (216 KB of shared memory at N = 128,
// P = 64: C, C Bᵀ of 4 source tiles, and per warpgroup S_in hi + lo, the
// X ring and y's staging tile), so its two warpgroups' serial chains (wait, products, wait)
// bound it, not the tensor cores: PERF.md has the times of each launch and
// of variants with parts cut out (scripts/ssd_tc_variants.py).
//
// Loads are TMA copies (128-byte swizzle for wgmma operands, none for the
// B tile that kernel 1 reads element by element), completing on mbarriers
// whose wait traps after 4 s; TMA's zero fill beyond the tensors' edges
// stands in for masked loads at ragged L, N and P. Rows at or beyond L are
// Δ = 0 steps; rows of a 64-row tile past the chunk (chunk < 64) get
// weight 0 and are not written. No atomics: two launches on the same inputs
// give the same bits.
//
// Fragments (wgmma's f32 accumulator, per warpgroup): thread t, warp w =
// t / 32, lane l holds rows 16w + l/4 and 16w + l/4 + 8 of the 64;
// register 4j + e holds column 8j + 2(l % 4) + (e & 1) of row
// 16w + l/4 + 8(e >> 1). A bf16 A fragment register j (0..3) of a k16
// slice holds row 16w + l/4 + 8(j & 1), columns 8(j >> 1) + 2(l % 4) + 0/1.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;       // rows of a tile: wgmma's M
constexpr int kRow = 128;       // bytes of one 64-wide bf16 row chunk
constexpr int kChunkBytes = kTile * kRow;  // one 64 × 64 bf16 box: 8 KB
constexpr int kMaxChunk = 256;
constexpr int kPassThreads = 256;
constexpr int kHeadsPerWg = 4;  // heads one warpgroup takes in turn
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const float* dt;
  long long dt_sb, dt_sl, dt_sh;
  const float* a;
  __nv_bfloat16* y;     // (B, L, H, P) contiguous
  float* state;         // (B, H, N, P) contiguous
  float* cum;           // (B, nc, H, Q) scratch
  float* sc;            // (B, nc, H, N, P) scratch: chunk states
  __nv_bfloat16* sin;   // (B, nc, H, 2, N, PP) scratch: S_in hi, lo
  int b, l, h, p, n, q, nc, pp, rtn, group;
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

// one box of a 3-D map at (c0, c1, c2)
__device__ __forceinline__ void tma_load3(uint32_t dst, const CUtensorMap* map,
                                          uint32_t bar, int c0, int c1,
                                          int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
         "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// one box of a 4-D map at (c0, c1, c2, c3)
__device__ __forceinline__ void tma_load4(uint32_t dst, const CUtensorMap* map,
                                          uint32_t bar, int c0, int c1, int c2,
                                          int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
         "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled tile at `addr`
// (1024-byte aligned up to the 32-byte k-step offsets of a K-major
// operand): 8-row groups 1024 bytes apart. For a K-major operand that is
// the stride byte offset and the leading one is unused; for an MN-major
// operand of n = 64 one swizzle atom spans all of n, and 1024 is the stride
// between its 8-row groups along K. Both offsets are set to it.
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

// the 128 threads of warpgroup `wg` (named barrier 1 + wg; 0 is
// __syncthreads)
__device__ __forceinline__ void wg_bar(int wg) {
  asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");
}

// pins registers that a wgmma writes or reads asynchronously to this point
// of the program: no read is hoisted above it, no register reused below it
template <int N>
__device__ __forceinline__ void pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}
template <int M, int N>
__device__ __forceinline__ void pin(float (&d)[M][N]) {
#pragma unroll
  for (int i = 0; i < M; ++i) pin(d[i]);
}
template <int N>
__device__ __forceinline__ void pin(uint32_t (&d)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(d[i][j]) :: "memory");
}

#define SSD_D32                                                              \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),           \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),       \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),       \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),       \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),       \
      "+f"(d[31])
#define SSD_D32_LIST                                                         \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "   \
  "%30, %31}, "

// d (+)= A·B, A (64 × 16) and B (16 × 64) both K-major in shared memory
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SSD_D32_LIST
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : SSD_D32
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += A·B, A (64 × 16) K-major and B (16 × 64) MN-major (the transpose
// bit) in shared memory
__device__ __forceinline__ void wgmma_ss_tb(float (&d)[32], uint64_t da,
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SSD_D32_LIST
      "%32, %33, p, 1, 1, 0, 1;\n}\n"
      : SSD_D32
      : "l"(da), "l"(db), "r"(1));
}

// d += A·B, A (64 × 16 bf16) in registers, B (16 × 64) MN-major in shared
// memory (the transpose bit)
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SSD_D32_LIST
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : SSD_D32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// (v0, v1) split into the bf16 pairs hi = bf16(v) and lo = bf16(v − hi),
// v0 in the low half (the lower column)
__device__ __forceinline__ void split2(float v0, float v1, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(v0 - hf.x, v1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// ---------------------------------------------------------------------------
// 1. chunk states
// ---------------------------------------------------------------------------

// Kernel 1's shared memory: two stages of (B tile 64 × NT bf16, unswizzled |
// X tile, PT/64 swizzled 64 × 64 boxes), which at the end stage S_c for
// 16-byte stores, then Δ, cum and w of the chunk and two mbarriers.
template <int NT, int PT>
struct StateTile {
  static constexpr int B_BYTES = NT * kRow;
  static constexpr int X_BYTES = (PT / 64) * kChunkBytes;
  static constexpr int STAGE = B_BYTES + X_BYTES;
  static constexpr int LDS = PT + 4;  // floats a row of S_c's staging tile
  // the two stages, which hold S_c (NT × LDS f32) once every tile is read
  static constexpr int REGION =
      2 * STAGE > NT * LDS * 4 ? 2 * STAGE : NT * LDS * 4;
  static constexpr int SMEM = 1024 + REGION + 3 * kMaxChunk * 4 + 16;
};

// One CTA per (chunk, head, batch), NT/64 warpgroups, each one m64 tile of
// the N rows of S_c. Writes cum (the chunk's inclusive cumsum of Δ·A, Q
// values, constant past L) and S_c = (B ∘ w)ᵀ X in f32.
template <int NT, int PT>
__global__ void __launch_bounds__(NT * 2)
    ssd_tc_state(const __grid_constant__ CUtensorMap tm_bn,
                 const __grid_constant__ CUtensorMap tm_x, const Params a) {
  using T = StateTile<NT, PT>;
  constexpr int PC = PT / 64;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* gbase = smem_raw + (base - raw);
  float* d_s = reinterpret_cast<float*>(gbase + T::REGION);
  float* cum_s = d_s + kMaxChunk;
  float* w_s = cum_s + kMaxChunk;
  const uint32_t bar = base + T::REGION + 3 * kMaxChunk * 4;

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int q = a.q;
  const int c0 = c * q;
  const int valid = min(q, a.l - c0);
  const int n_tiles = (q + kTile - 1) / kTile;

  auto issue = [&](int j) {
    const int st = j & 1;
    const uint32_t dst = base + st * T::STAGE;
    mbar_expect_tx(bar + 8 * st, T::STAGE);
    tma_load3(dst, &tm_bn, bar + 8 * st, 0, c0 + kTile * j, b);
#pragma unroll
    for (int pc = 0; pc < PC; ++pc)
      tma_load4(dst + T::B_BYTES + pc * kChunkBytes, &tm_x, bar + 8 * st,
                pc * 64, h, c0 + kTile * j, b);
  };

  if (tid == 0) {
    mbar_init(bar, 1);
    mbar_init(bar + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0)
    for (int j = 0; j < min(2, n_tiles); ++j) issue(j);

  // Δ·A and its inclusive cumsum, in a fixed order: lane i sums rows
  // 8i..8i+7 in turn, then an exclusive scan of the lane totals
  if (tid < 32) {
    const float ah = a.a[h];
    const float* dtp = a.dt + b * a.dt_sb + h * a.dt_sh;
    float v[8];
    float run = 0.0f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int t = 8 * tid + i;
      const float d =
          t < valid ? dtp[static_cast<long long>(c0 + t) * a.dt_sl] : 0.0f;
      d_s[t] = d;
      run += d * ah;
      v[i] = run;
    }
    float tot = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, tot, off);
      if (tid >= off) tot += u;
    }
    float excl = __shfl_up_sync(0xffffffffu, tot, 1);
    if (tid == 0) excl = 0.0f;
#pragma unroll
    for (int i = 0; i < 8; ++i) cum_s[8 * tid + i] = excl + v[i];
  }
  __syncthreads();
  const float total = cum_s[q - 1];
  float* cum_out =
      a.cum + ((static_cast<long long>(b) * a.nc + c) * a.h + h) * q;
  for (int t = tid; t < kMaxChunk; t += blockDim.x) {
    w_s[t] = t < q ? d_s[t] * expf(total - cum_s[t]) : 0.0f;
    if (t < q) cum_out[t] = cum_s[t];
  }
  __syncthreads();

  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int m0 = 64 * wg + 16 * warp + lane / 4;  // S_c rows m0 and m0 + 8
  const int cq = 2 * (lane % 4);
  float acc[PC][32];
#pragma unroll
  for (int pc = 0; pc < PC; ++pc)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[pc][i] = 0.0f;

  // A = (B ∘ w)ᵀ of tile j (rows are N, columns the tile's 64 steps), as
  // bf16 hi + lo fragments, once its stage has landed
  auto frags = [&](int j, uint32_t (&hi)[4][4], uint32_t (&lo)[4][4]) {
    const int st = j & 1;
    mbar_wait(bar + 8 * st, (j >> 1) & 1);
    const __nv_bfloat16* bt =
        reinterpret_cast<const __nv_bfloat16*>(gbase + st * T::STAGE);
    const float* w = w_s + kTile * j;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int m = m0 + 8 * (r & 1);
        const int s = 16 * kk + 8 * (r >> 1) + cq;
        const float v0 = __bfloat162float(bt[s * NT + m]) * w[s];
        const float v1 = __bfloat162float(bt[(s + 1) * NT + m]) * w[s + 1];
        split2(v0, v1, hi[kk][r], lo[kk][r]);
      }
  };
  // the products of tile j; the next tile's fragments are built while
  // they run
  auto step = [&](int j, uint32_t (&hi)[4][4], uint32_t (&lo)[4][4],
                  uint32_t (&nhi)[4][4], uint32_t (&nlo)[4][4]) {
    pin(acc);
    wg_fence();
    const uint32_t xs = base + (j & 1) * T::STAGE + T::B_BYTES;
#pragma unroll
    for (int pc = 0; pc < PC; ++pc)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t dx = desc(xs + pc * kChunkBytes + kk * 16 * kRow);
        wgmma_rs(acc[pc], hi[kk], dx);
        wgmma_rs(acc[pc], lo[kk], dx);
      }
    wg_commit();
    if (j + 1 < n_tiles) frags(j + 1, nhi, nlo);
    wg_wait_all();
    pin(acc);
    pin(hi);
    pin(lo);
    __syncthreads();  // every warpgroup is done with stage j & 1
    if (tid == 0 && j + 2 < n_tiles) issue(j + 2);
  };
  uint32_t ahi[4][4], alo[4][4], bhi[4][4], blo[4][4];
  frags(0, ahi, alo);
  for (int j = 0; j < n_tiles; j += 2) {
    step(j, ahi, alo, bhi, blo);
    if (j + 1 < n_tiles) step(j + 1, bhi, blo, ahi, alo);
  }

  // S_c through shared memory (every stage is read), so that each row goes
  // out in 16-byte stores
  float* stg = reinterpret_cast<float*>(gbase);
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int pc = 0; pc < PC; ++pc)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
        *reinterpret_cast<float2*>(stg + (m0 + 8 * r) * T::LDS + 64 * pc +
                                   8 * jj + cq) =
            make_float2(acc[pc][4 * jj + 2 * r], acc[pc][4 * jj + 2 * r + 1]);
  __syncthreads();
  float* out = a.sc + ((static_cast<long long>(b) * a.nc + c) * a.h + h) *
                          a.n * a.p;
  if ((a.p & 3) == 0) {
    const int per_row = a.p / 4;
    for (int idx = tid; idx < a.n * per_row; idx += blockDim.x) {
      const int m = idx / per_row, k = idx % per_row;
      *reinterpret_cast<float4*>(out + m * a.p + 4 * k) =
          *reinterpret_cast<const float4*>(stg + m * T::LDS + 4 * k);
    }
  } else {
    for (int idx = tid; idx < a.n * a.p; idx += blockDim.x)
      out[idx] = stg[(idx / a.p) * T::LDS + idx % a.p];
  }
}

// ---------------------------------------------------------------------------
// 2. state passing
// ---------------------------------------------------------------------------

// One thread per element of the (N, P) state of one (head, batch): the
// chunks in order, S_in[c] written as bf16 hi + lo for c ≥ 1, the last
// state in f32.
__global__ void __launch_bounds__(kPassThreads) ssd_tc_pass(const Params a) {
  const int h = blockIdx.y, b = blockIdx.z;
  const int i = blockIdx.x * kPassThreads + threadIdx.x;
  const int np = a.n * a.p;
  if (i >= np) return;
  const int n = i / a.p, p = i % a.p;
  const int plane = a.n * a.pp;
  float s = 0.0f;
  for (int c = 0; c < a.nc; ++c) {
    const long long bch = (static_cast<long long>(b) * a.nc + c) * a.h + h;
    if (c > 0) {
      __nv_bfloat16* dst = a.sin + bch * 2 * plane + n * a.pp + p;
      const __nv_bfloat16 hi = __float2bfloat16(s);
      dst[0] = hi;
      dst[plane] = __float2bfloat16(s - __bfloat162float(hi));
    }
    const float total = a.cum[bch * a.q + a.q - 1];
    s = expf(total) * s + a.sc[bch * np + i];
  }
  a.state[(static_cast<long long>(b) * a.h + h) * np + i] = s;
}

// ---------------------------------------------------------------------------
// 3. chunk scan
// ---------------------------------------------------------------------------

// Kernel 3's shared memory, from a 1024-byte aligned base: the C tile (NT/64
// boxes of 64 × 64), one area per warpgroup (S_in hi | S_in lo, NT × PT
// each, a ring of XS X tiles, and y's 64-row staging tile), C Bᵀ of up to rtn source tiles (64 × 64
// f32 each, every thread's own fragment; each slot first holds its B tile),
// then per warpgroup cum · log2 e and Δ of each of its heads, and the
// mbarriers: C, then per warpgroup B, S and the XS X stages.
template <int NT, int PT>
struct ScanTile {
  static constexpr int PC = PT / 64;
  static constexpr int WGS = PT == 64 ? 2 : 1;   // consumer warpgroups
  static constexpr int C_BYTES = NT * kRow;
  static constexpr int S_BYTES = PC * NT * kRow;  // one of hi, lo
  static constexpr int X_BYTES = PC * kChunkBytes;
  static constexpr int XS = 2;                   // stages of the X ring
  static constexpr int LDY = PT + 8;  // bf16 a row of y's staging tile
  static constexpr int Y_BYTES = kTile * LDY * 2;
  static constexpr int AREA = 2 * S_BYTES + XS * X_BYTES + Y_BYTES;
  static constexpr int CB_BYTES = kTile * kTile * 4;
  static_assert(NT * kRow <= CB_BYTES, "a B tile fits a C Bᵀ slot");
  static constexpr int HEAD_FLOATS = 2 * kMaxChunk;  // cum · log2 e, Δ
  static int smem(int rtn) {
    return 1024 + C_BYTES + WGS * AREA + rtn * CB_BYTES +
           WGS * kHeadsPerWg * HEAD_FLOATS * 4 + 8 * (1 + (2 + XS) * WGS);
  }
};

template <int NT, int PT>
__global__ void __launch_bounds__(128 * ScanTile<NT, PT>::WGS, 1)
    ssd_tc_scan(const __grid_constant__ CUtensorMap tm_b,
                const __grid_constant__ CUtensorMap tm_c,
                const __grid_constant__ CUtensorMap tm_x,
                const __grid_constant__ CUtensorMap tm_s, const Params a) {
  using T = ScanTile<NT, PT>;
  constexpr int PC = T::PC;
  constexpr int WGS = T::WGS;
  const int rtn = a.rtn;
  const int rt = rtn - 1 - static_cast<int>(blockIdx.x) % rtn;  // longest first
  const int c = blockIdx.x / rtn;
  const int hg = blockIdx.y, b = blockIdx.z;
  const int q = a.q;
  const int c0 = c * q;
  const int t0 = kTile * rt;
  const int valid = min(q, a.l - c0);
  if (t0 >= valid) return;  // a row tile past L: nothing to write

  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* gbase = smem_raw + (base - raw);
  const uint32_t c_s = base;
  const uint32_t areas = c_s + T::C_BYTES;
  const uint32_t cb_off = T::C_BYTES + WGS * T::AREA;
  float* cb_s = reinterpret_cast<float*>(gbase + cb_off);
  float* small = reinterpret_cast<float*>(gbase + cb_off + rtn * T::CB_BYTES);
  const uint32_t bars =
      smem_u32(small + WGS * kHeadsPerWg * T::HEAD_FLOATS);
  const uint32_t bar_c = bars;

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int tw = tid % 128;
  const int warp = tw / 32;
  const int lane = tw % 32;
  const bool leader = tw == 0;
  const uint32_t area = areas + wg * T::AREA;
  const uint32_t s_hi = area, s_lo = area + T::S_BYTES;
  const uint32_t x_s = area + 2 * T::S_BYTES;  // + stage · X_BYTES
  __nv_bfloat16* y_stg = reinterpret_cast<__nv_bfloat16*>(
      gbase + (x_s + T::XS * T::X_BYTES - base));
  constexpr int XS = T::XS;
  const uint32_t bar_b = bars + 8 * (1 + (2 + XS) * wg);
  const uint32_t bar_s = bar_b + 8;
  const uint32_t bar_x = bar_b + 16;            // + 8 · stage
  constexpr int KS = NT / 16;                   // k-steps of 16 along N

  if (tid == 0) {
    for (int i = 0; i < 1 + (2 + XS) * WGS; ++i) mbar_init(bars + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar_c, T::C_BYTES);
#pragma unroll
    for (int kc = 0; kc < NT / 64; ++kc)
      tma_load3(c_s + kc * kChunkBytes, &tm_c, bar_c, kc * 64, c0 + t0, b);
  }

  // this warpgroup's heads of the group, and their cum · log2 e and Δ for
  // rows 0..t0+63 of the chunk (0 past it; Δ 0 past L), loaded while C Bᵀ
  // is computed
  int heads[kHeadsPerWg];
  int nh = 0;
  for (int hh = wg; hh < a.group && nh < kHeadsPerWg; hh += WGS) {
    const int h = hg * a.group + hh;
    if (h < a.h) heads[nh++] = h;
  }
  float* cum_wg = small + wg * kHeadsPerWg * T::HEAD_FLOATS;
  for (int i = 0; i < nh; ++i) {
    const float* cum_in =
        a.cum + ((static_cast<long long>(b) * a.nc + c) * a.h + heads[i]) * q;
    const float* dtp = a.dt + b * a.dt_sb + heads[i] * a.dt_sh;
    float* cw = cum_wg + i * T::HEAD_FLOATS;
    for (int t = tw; t < t0 + kTile; t += 128) {
      cw[t] = t < q ? cum_in[t] * kLog2e : 0.0f;
      cw[kMaxChunk + t] =
          t < valid ? dtp[static_cast<long long>(c0 + t) * a.dt_sl] : 0.0f;
    }
  }

  auto plane = [&](int h) {
    return ((b * a.nc + c) * a.h + h) * 2;
  };
  auto issue_s = [&](int h) {
    mbar_expect_tx(bar_s, 2 * T::S_BYTES);
#pragma unroll
    for (int pc = 0; pc < PC; ++pc) {
      tma_load3(s_hi + pc * NT * kRow, &tm_s, bar_s, pc * 64, 0, plane(h));
      tma_load3(s_lo + pc * NT * kRow, &tm_s, bar_s, pc * 64, 0,
                plane(h) + 1);
    }
  };
  // the warpgroup's X tiles in the order they are used, tile j of head i
  // the k-th with k = i (rt + 1) + j, into stage k mod XS: issue_xk(k)
  // loads it, XS − 1 ahead of its use
  auto issue_xk = [&](int k) {
    if (k >= nh * (rt + 1)) return;
    const int st = k % XS;
    const uint32_t bx = bar_x + 8 * st;
    mbar_expect_tx(bx, T::X_BYTES);
#pragma unroll
    for (int pc = 0; pc < PC; ++pc)
      tma_load4(x_s + st * T::X_BYTES + pc * kChunkBytes, &tm_x, bx, pc * 64,
                heads[k / (rt + 1)], c0 + kTile * (k % (rt + 1)), b);
  };


  // C Bᵀ of the source tiles 0..rt, the warpgroups taking them in turn.
  // Each B tile lands in the C Bᵀ slot of its tile, where C Bᵀ then
  // replaces it; the first head's S_in and X tile land meanwhile.
  const uint32_t cb_u = base + cb_off;
  if (leader) {
    int nb = 0;
    for (int j = wg; j <= rt; j += WGS) ++nb;
    if (nb > 0) mbar_expect_tx(bar_b, nb * NT * kRow);
    for (int j = wg; j <= rt; j += WGS)
#pragma unroll
      for (int kc = 0; kc < NT / 64; ++kc)
        tma_load3(cb_u + j * T::CB_BYTES + kc * kChunkBytes, &tm_b, bar_b,
                  kc * 64, c0 + kTile * j, b);
    if (nh > 0 && c > 0) issue_s(heads[0]);
    for (int k = 0; k < XS - 1; ++k) issue_xk(k);
  }
  for (int j = wg; j <= rt; j += WGS) {
    mbar_wait(bar_c, 0);
    mbar_wait(bar_b, 0);
    float cb[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) cb[i] = 0.0f;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const uint32_t off = (kk / 4) * kChunkBytes + (kk % 4) * 32;
      wgmma_ss(cb, desc(c_s + off), desc(cb_u + j * T::CB_BYTES + off),
               kk > 0);
    }
    wg_commit();
    wg_wait_all();
    pin(cb);
    wg_bar(wg);  // the B tile in slot j is read
#pragma unroll
    for (int i = 0; i < 32; ++i) cb_s[(j * 32 + i) * 128 + tw] = cb[i];
  }
  __syncthreads();  // every C Bᵀ tile, cum and Δ are in
  mbar_wait(bar_c, 0);

  const int rl = 16 * warp + lane / 4;  // rows rl and rl + 8 of the tile
  const int cq = 2 * (lane % 4);
  int kx = 0, ks = 0;
  for (int i = 0; i < nh; ++i) {
    const int h = heads[i];
    const float* cum2 = cum_wg + i * T::HEAD_FLOATS;  // cum · log2 e
    const float* dts = cum2 + kMaxChunk;
    const float ct0 = cum2[t0 + rl], ct1 = cum2[t0 + rl + 8];

    // G = (C Bᵀ) ∘ L ∘ Δ of source tile j as bf16 hi + lo A fragments; the
    // mask s ≤ t only on the diagonal tile
    auto gfrag = [&](int j, uint32_t (&hi)[4][4], uint32_t (&lo)[4][4]) {
      const float* cbj = cb_s + j * 32 * 128 + tw;
      const bool diag = j == rt;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int s = kTile * j + 16 * kk + 8 * half + cq;
          const float cs0 = cum2[s], cs1 = cum2[s + 1];
          const float d0 = dts[s], d1 = dts[s + 1];
#pragma unroll
          for (int row = 0; row < 2; ++row) {
            const int r = 2 * half + row;  // A register: row +8, col +8
            const int e = 8 * kk + 2 * r;  // accumulator registers e, e + 1
            const int t = t0 + rl + 8 * row;
            const float ct = row ? ct1 : ct0;
            float g0 = cbj[e * 128] * exp2f(ct - cs0) * d0;
            float g1 = cbj[(e + 1) * 128] * exp2f(ct - cs1) * d1;
            if (diag) {
              g0 = s <= t ? g0 : 0.0f;
              g1 = s + 1 <= t ? g1 : 0.0f;
            }
            split2(g0, g1, hi[kk][r], lo[kk][r]);
          }
        }
    };

    float acc[PC][32];
#pragma unroll
    for (int pc = 0; pc < PC; ++pc)
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[pc][e] = 0.0f;
    uint32_t ahi[4][4], alo[4][4], bhi[4][4], blo[4][4];
    if (c > 0) {
      // C S_in: S_in as hi + lo, MN-major (P contiguous); G of tile 0 is
      // built while it runs, then the rows are scaled by e^{cum_t}
      mbar_wait(bar_s, ks & 1);
      ++ks;
      pin(acc);
      wg_fence();
#pragma unroll
      for (int pc = 0; pc < PC; ++pc)
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          const uint64_t dc =
              desc(c_s + (kk / 4) * kChunkBytes + (kk % 4) * 32);
          const uint32_t so = pc * NT * kRow + kk * 16 * kRow;
          wgmma_ss_tb(acc[pc], dc, desc(s_hi + so));
          wgmma_ss_tb(acc[pc], dc, desc(s_lo + so));
        }
      wg_commit();
      gfrag(0, ahi, alo);
      wg_wait_all();
      pin(acc);
      wg_bar(wg);  // the S tiles are read
      if (leader && i + 1 < nh) issue_s(heads[i + 1]);
      const float e0 = exp2f(ct0), e1 = exp2f(ct1);
#pragma unroll
      for (int pc = 0; pc < PC; ++pc)
#pragma unroll
        for (int e = 0; e < 32; ++e) acc[pc][e] *= (e & 2) ? e1 : e0;
    } else {
      gfrag(0, ahi, alo);
    }

    // Σ over the source tiles s ≤ t of G X; the next tile's G is built
    // while a tile's products run
    auto step = [&](int j, uint32_t (&hi)[4][4], uint32_t (&lo)[4][4],
                    uint32_t (&nhi)[4][4], uint32_t (&nlo)[4][4]) {
      if (leader) issue_xk(kx + XS - 1);  // into the stage freed last
      const int st = kx % XS;
      mbar_wait(bar_x + 8 * st, (kx / XS) & 1);
      pin(acc);
      wg_fence();
#pragma unroll
      for (int pc = 0; pc < PC; ++pc)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t dx = desc(x_s + st * T::X_BYTES + pc * kChunkBytes +
                                   kk * 16 * kRow);
          wgmma_rs(acc[pc], hi[kk], dx);
          wgmma_rs(acc[pc], lo[kk], dx);
        }
      wg_commit();
      if (j < rt) gfrag(j + 1, nhi, nlo);
      wg_wait_all();
      pin(acc);
      pin(hi);
      pin(lo);
      wg_bar(wg);  // stage st is read
      ++kx;
    };
    for (int j = 0; j <= rt; j += 2) {
      step(j, ahi, alo, bhi, blo);
      if (j + 1 <= rt) step(j + 1, bhi, blo, ahi, alo);
    }

    // y in bf16 through shared memory, so that each row goes out in
    // 16-byte stores; rows t < valid only
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int pc = 0; pc < PC; ++pc)
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
          *reinterpret_cast<__nv_bfloat162*>(
              y_stg + (rl + 8 * r) * T::LDY + 64 * pc + 8 * jj + cq) =
              __floats2bfloat162_rn(acc[pc][4 * jj + 2 * r],
                                    acc[pc][4 * jj + 2 * r + 1]);
    wg_bar(wg);
    const int rows = min(kTile, valid - t0);
    __nv_bfloat16* yp =
        a.y + ((static_cast<long long>(b) * a.l + c0 + t0) * a.h + h) * a.p;
    const long long y_sl = static_cast<long long>(a.h) * a.p;
    if ((a.p & 7) == 0) {
      const int per_row = a.p / 8;
      for (int idx = tw; idx < rows * per_row; idx += 128) {
        const int row = idx / per_row, k = idx % per_row;
        *reinterpret_cast<uint4*>(yp + row * y_sl + 8 * k) =
            *reinterpret_cast<const uint4*>(y_stg + row * T::LDY + 8 * k);
      }
    } else {
      for (int idx = tw; idx < rows * a.p; idx += 128)
        yp[(idx / a.p) * y_sl + idx % a.p] =
            y_stg[(idx / a.p) * T::LDY + idx % a.p];
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

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
constexpr int kNoEncoder = 90000;     // the driver has no cuTensorMapEncodeTiled
constexpr int kEncodeFailed = 91000;  // + the CUresult of the encode

// a bf16 map of `rank` dims (innermost first; strides in elements for dims
// 1..rank−1), zero beyond every edge
int make_map(CUtensorMap* map, const void* ptr, int rank,
             const long long* dims, const long long* strides,
             const int* box, bool swizzle) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return kNoEncoder;
  cuuint64_t d[5], st[4];
  cuuint32_t bx[5], unit[5];
  for (int i = 0; i < rank; ++i) {
    d[i] = static_cast<cuuint64_t>(dims[i]);
    bx[i] = static_cast<cuuint32_t>(box[i]);
    unit[i] = 1;
    if (i > 0) st[i - 1] = static_cast<cuuint64_t>(strides[i - 1]) * 2;
  }
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(ptr), d,
      st, bx, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeFailed + static_cast<int>(r);
}

template <int NT, int PT>
int launch(const void* x, long long x_sb, long long x_sl, long long x_sh,
           const void* bm, long long b_sb, long long b_sl, const void* cm,
           long long c_sb, long long c_sl, const Params& p,
           cudaStream_t stream) {
  using S = StateTile<NT, PT>;
  using C = ScanTile<NT, PT>;
  CUtensorMap m_bn, m_b, m_c, m_x, m_s;
  const long long bdims[3] = {p.n, p.l, p.b};
  const long long bstr[2] = {b_sl, b_sb};
  const long long cstr[2] = {c_sl, c_sb};
  const int box_bn[3] = {NT, kTile, 1};
  const int box_bc[3] = {64, kTile, 1};
  const long long xdims[4] = {p.p, p.h, p.l, p.b};
  const long long xstr[3] = {x_sh, x_sl, x_sb};
  const int box_x[4] = {64, 1, kTile, 1};
  const long long sdims[3] = {p.pp, p.n,
                              static_cast<long long>(p.b) * p.nc * p.h * 2};
  const long long sstr[2] = {p.pp, static_cast<long long>(p.n) * p.pp};
  const int box_s[3] = {64, NT, 1};
  int err = make_map(&m_bn, bm, 3, bdims, bstr, box_bn, false);
  if (err == 0) err = make_map(&m_b, bm, 3, bdims, bstr, box_bc, true);
  if (err == 0) err = make_map(&m_c, cm, 3, bdims, cstr, box_bc, true);
  if (err == 0) err = make_map(&m_x, x, 4, xdims, xstr, box_x, true);
  if (err == 0) err = make_map(&m_s, p.sin, 3, sdims, sstr, box_s, true);
  if (err != 0) return err;

  cudaError_t e = cudaFuncSetAttribute(
      ssd_tc_state<NT, PT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      S::SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int scan_smem = C::smem(p.rtn);
  e = cudaFuncSetAttribute(ssd_tc_scan<NT, PT>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           scan_smem);
  if (e != cudaSuccess) return static_cast<int>(e);

  ssd_tc_state<NT, PT><<<dim3(p.nc, p.h, p.b), NT * 2, S::SMEM, stream>>>(
      m_bn, m_x, p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 pass_grid((p.n * p.p + kPassThreads - 1) / kPassThreads, p.h,
                       p.b);
  ssd_tc_pass<<<pass_grid, kPassThreads, 0, stream>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 scan_grid(p.nc * p.rtn, (p.h + p.group - 1) / p.group, p.b);
  ssd_tc_scan<NT, PT><<<scan_grid, 128 * C::WGS, scan_smem, stream>>>(
      m_b, m_c, m_x, m_s, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches the three kernels on `stream` and returns the first error (0
// when every launch was accepted; 90000 when the driver has no tensor-map
// encoder, 91000 + its CUresult when it refused a map). x (B, L, H, P), B
// and C (B, L, N), all bfloat16 with a unit last stride and the given
// strides (in elements), each a multiple of 8 (16 bytes), on 16-byte
// aligned bases; dt (B, L, H) f32 with the given strides, a (H,) f32; y
// (B, L, H, P) contiguous bf16, state (B, H, N, P) contiguous f32. Scratch
// the wrapper allocates, contiguous, nc = ⌈L / chunk⌉: cum (B, nc, H,
// chunk) f32, sc (B, nc, H, N, P) f32 and sin (B, nc, H, 2, N, PP) bf16,
// PP = P rounded up to a multiple of 8. P ≤ 128, N ≤ 128, 1 ≤ chunk ≤ 256, L ≥ 1; the
// wrapper checks all of it (ops.py::kernel_for, ops.py::_check).
extern "C" int ssd_tc_fwd(
    const void* x, long long x_sb, long long x_sl, long long x_sh,
    const void* dt, long long dt_sb, long long dt_sl, long long dt_sh,
    const void* a, const void* bm, long long b_sb, long long b_sl,
    const void* cm, long long c_sb, long long c_sl, void* y, void* state,
    void* cum, void* sc, void* sin, int b, int l, int h, int p, int n,
    int chunk, void* stream) {
  Params pr;
  pr.dt = static_cast<const float*>(dt);
  pr.dt_sb = dt_sb;
  pr.dt_sl = dt_sl;
  pr.dt_sh = dt_sh;
  pr.a = static_cast<const float*>(a);
  pr.y = static_cast<__nv_bfloat16*>(y);
  pr.state = static_cast<float*>(state);
  pr.cum = static_cast<float*>(cum);
  pr.sc = static_cast<float*>(sc);
  pr.sin = static_cast<__nv_bfloat16*>(sin);
  pr.b = b;
  pr.l = l;
  pr.h = h;
  pr.p = p;
  pr.n = n;
  pr.q = chunk;
  pr.nc = (l + chunk - 1) / chunk;
  pr.pp = (p + 7) / 8 * 8;
  pr.rtn = (chunk + kTile - 1) / kTile;
  const int wgs = p <= 64 ? 2 : 1;
  pr.group = h < kHeadsPerWg * wgs ? h : kHeadsPerWg * wgs;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 64)
    return p <= 64 ? launch<64, 64>(x, x_sb, x_sl, x_sh, bm, b_sb, b_sl, cm,
                                    c_sb, c_sl, pr, st)
                   : launch<64, 128>(x, x_sb, x_sl, x_sh, bm, b_sb, b_sl, cm,
                                     c_sb, c_sl, pr, st);
  return p <= 64 ? launch<128, 64>(x, x_sb, x_sl, x_sh, bm, b_sb, b_sl, cm,
                                   c_sb, c_sl, pr, st)
                 : launch<128, 128>(x, x_sb, x_sl, x_sh, bm, b_sb, b_sl, cm,
                                    c_sb, c_sl, pr, st);
}
