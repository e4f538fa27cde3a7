// Flash attention, forward, f32, on Hopper's tensor cores (sm_90a):
// grouped-query attention with an online softmax and causal / prefix masks.
//
//   o[b, i, h] = Σ_j softmax_j(⟨q[b, i, h], k[b, j, h / group]⟩ / √dh) · v[b, j, h / group]
//
// over the visible keys j of row i:
//   causal                     j ≤ i  or  j < prefix_len
//   not causal, prefix_len > 0 j < prefix_len
//   not causal, prefix_len = 0 every j < T
//
// Replaces repro/kernels/flash_attention/kernel.py::_fa_kernel for f32
// inputs that TMA can describe with dh ≤ 128 (launched there by
// flash_attention_padded, through ops.py::flash_attention);
// flash_attention_tc.cu takes such bf16 inputs, and flash_attention.cu every
// input TMA cannot describe and dh > 128 (ops.py::kernel_for).
//
// Bound: at zamba2-1.2b's f32 prefill (B = 4, S = T = 1920, H = KV = 32,
// dh = 64, causal) the visible (row, key) pairs need 4·dh flops each, 60.4
// GFLOP: 902 µs at 67 TFLOP/s on the CUDA cores, 122 µs at 494.7 TFLOP/s
// on the TF32 tensor cores, against 252 MB of q, k, v and o, 75.1 µs at
// 3.35 TB/s: operations bind, and 122 µs is the bound. This kernel does
// each product three times (below), so its own floor is 366 µs.
//
// The design:
//
//   * Split TF32 on wgmma (m64nNk8, f32 accumulators). A TF32 operand keeps
//     11 of f32's 24 significant bits, ~2⁻¹¹ relative, and one TF32 pass
//     fails the f32 limit (rtol 1e-4 / atol 2e-5). So each f32 operand is
//     x = hi + lo with hi = x & ~0x1fff (the bits TF32 keeps, exact) and
//     lo = x − hi (exact in f32), and
//       S = Q_hi·K_hi + Q_hi·K_lo + Q_lo·K_hi
//       O += P_hi·V_hi + P_hi·V_lo + P_lo·V_hi
//     keeps ~21 bits of each product (the lo·lo term is 2⁻²² relative).
//     Softmax, m, l, the −1e30 sentinel and o / max(l, 1e-30) stay in f32.
//   * The hardware drops bits. A .tf32 operand's low 13 mantissa bits are
//     TRUNCATED, whether it is read from shared memory or from registers
//     (scripts/flash_tc32_variants.py's probe, on an H100: A·1 with
//     A = 1 + 2⁻¹⁰ − 2⁻²³, 1 + 2⁻¹¹ and 1 + 2⁻¹⁰ + 2⁻¹¹ gave 1, 1 and
//     1 + 2⁻¹⁰). So the raw f32 tile that TMA delivers IS the hi part of
//     Q and K: only lo needs a pass, one extra tile for each. The kernel
//     relies on it; a card that rounded instead would read hi wrongly and
//     fail the f32 limit, which chip_smoke.py holds it to. P's hi, made in
//     registers, is masked explicitly.
//   * TF32 wgmma takes K-major operands only (no transpose bit). Q·Kᵀ fits
//     as it stands: q and k rows are dh-contiguous. For P·V, P is the A
//     operand from registers, split in registers, and V must sit in shared
//     memory as Vᵀ, keys contiguous. The S accumulator gives a thread
//     columns (2t, 2t+1) of each 8-key slice where the TF32 A fragment wants
//     (t, t+4): rather than shuffle P, the keys of each slice are permuted
//     in Vᵀ (slot t holds key 2t, slot t+4 key 2t+1), which the product
//     does not see.
//   * Warp specialisation. A producer warp issues TMA (Q once; K into a
//     ring of prepared stages, raw V into a ring of two buffers), three
//     "prep" warps turn each landed tile into its operands (K_lo beside K;
//     Vᵀ_hi and Vᵀ_lo from raw V: a transpose and a split), and the
//     consumer warpgroups run the products and the softmax. mbarriers
//     only, no __syncthreads in the KV loop: full (TMA landed), prepared
//     (prep done), empty (consumers done), raw_empty (a raw V buffer read).
//     TMA's zero fill covers the ragged S, T and dh edges; S's k-steps stop
//     at dh rounded up to 8.
//   * One GQA group a CTA. A CTA owns one (KV head, batch) and a run of
//     "units" — 64 q rows of one query head of that KV head — one unit a
//     consumer warpgroup, so each K/V tile, with its split and transpose,
//     is loaded and prepared once for all of them: three warpgroups cover a
//     group of 3 at 32 < dh ≤ 64 (smollm-360m's 15/5), two cover a group of
//     2, or one head's 128 rows (zamba2-1.2b's 32/32); at dh 128 (two
//     warpgroups: registers) a group of 3 is covered two units a CTA.
//   * Tiles: Q 64 rows a unit; KV tiles of 32 keys (64 at dh ≤ 32); a
//     stage holds K, K_lo, Vᵀ_hi and Vᵀ_lo; four stages at dh ≤ 64, two at
//     dh 128 (shared memory: 177 KB at dh 64 with two warpgroups, 193 KB
//     with three, 225 KB at dh 128). The ring's depth sets the loads'
//     rate: with two stages and one raw V buffer the loads alone took half
//     the kernel's time (scripts/flash_tc32_variants.py, loads_only).
//     setmaxnreg gives the consumers the registers (Q_lo's A fragments
//     live in registers for the whole KV loop).
//   * Why no KV tile is as wide as D: a ptxas fault (CUDA 12.9,
//     V12.9.86). With 64-key tiles at dh 64 (the variants script's bk64)
//     ptxas runs out of registers (it allocates 168 a thread at two
//     consumer warpgroups, 128 at three, whatever setmaxnreg grants),
//     waits for every wgmma alone (its C7512), and gives the registers of
//     three of the eight Q_lo fragments, which the KV loop reads on every
//     trip, to the softmax's temporaries later in the same trip, with no
//     reload: every KV tile after the first reads P's lo parts there in
//     place of Q_lo. The PTX is right (each fragment is one register,
//     defined before the loop and read only by its wgmma inside it); the
//     machine code is not (flash_tc32_variants.py --sass, loop_clobbers),
//     and the numbers follow it: 2,783 of 32,768 elements over the f32
//     limit at
//     (1, 128, 4/2 heads, dh 64, causal), none in the rows that see one KV
//     tile; a commit and wait after S's register-operand wgmma, which moves
//     ptxas's allocation, removes both. No operand is touched while its
//     wgmma is in flight in any of these builds. 32-key tiles leave ptxas
//     room; tests/test_torch_flash_cuda.py scans this kernel's machine
//     code for both faults on the card, and holds the scan to the bk64
//     build's numbers. The A fragments are pinned at the fences and
//     waits, as the accumulators are; that moves a few instructions, not
//     the fault (bk64 and bk64+unpinned fail alike).
//
// Kept from flash_attention_tc.cu: units issued longest first, a KV loop
// that ends at the last tile holding a visible key (each warpgroup stops
// computing at its own), masks applied only on the tiles that straddle
// them, exp2 with scale·log₂e folded into one multiply, and fixed-order
// quad shuffles for the row max and sum, with no atomics: two launches on
// the same inputs give the same bits.
//
// Fragments (wgmma's f32 accumulator, per warpgroup): thread t, warp w =
// t / 32, lane l holds rows 16w + l/4 and 16w + l/4 + 8 of the 64; register
// 4j + e holds column 8j + 2(l % 4) + (e & 1) of row 16w + l/4 + 8(e >> 1).
// The TF32 A fragment of an 8-wide k slice: a0 (row l/4, k l%4), a1 (row
// l/4 + 8, k l%4), a2 (row l/4, k l%4 + 4), a3 (row l/4 + 8, k l%4 + 4).

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;         // q rows of a unit: wgmma's M
constexpr int kWG = 128;          // threads of a warpgroup
constexpr int kPrep = 96;         // prep threads: warps 1–3 of the last WG
constexpr int kRow = 128;         // bytes of one 32-wide f32 row chunk
constexpr int kChunk = 32;        // f32 elements of one chunk
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
// the bits a TF32 operand keeps: sign, exponent, 10 of the mantissa's 23
constexpr uint32_t kHiMask = 0xffffe000u;
// D: dh rounded up to 32, 64 or 128; NWG consumer warpgroups. KV tiles
// of 32 keys, 64 at D 32, never as wide as D (the header says why;
// ops.py::tc32_tiles states the same rule).
template <int D, int NWG>
struct Tile {
  static constexpr int BK = D == 32 ? 64 : 32;  // keys a tile
  // the ring: prepared stages (K, K_lo, Vᵀ_hi, Vᵀ_lo) and raw V buffers
  static constexpr int STAGES = D == 128 ? 2 : 4;
  static constexpr int RAW = 2;
  static constexpr int THREADS = kWG * (NWG + 1);
  static constexpr int PREP_REGS = 56;
  static constexpr int MMA_REGS = NWG == 2 ? 224 : 152;
  static constexpr int Q_BYTES = NWG * kRows * D * 4;
  static constexpr int TILE_BYTES = BK * D * 4;     // K, K_lo, Vᵀ, raw V
  static constexpr int STAGE_BYTES = 4 * TILE_BYTES;
  static constexpr int BAR_BYTES = 8 * (1 + RAW + 3 * STAGES);
  // + 1024: the swizzled tiles start at a 1024-byte boundary
  static constexpr int SMEM = 1024 + Q_BYTES + STAGES * STAGE_BYTES +
                              RAW * TILE_BYTES + BAR_BYTES;
  static_assert(NWG * 128 * MMA_REGS + 128 * PREP_REGS <= 65536,
                "setmaxnreg over the register file");
  static_assert(SMEM <= 232448, "over the shared memory of a CTA");
};

struct Params {
  float* o;
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

// one (32 × 1 × rows × 1) box of a 4-D map at (d0, head, row0, batch)
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

// generic-proxy stores to shared memory made visible to wgmma's reads
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ float4 lds4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "r"(addr)
               : "memory");
  return v;
}

__device__ __forceinline__ float lds(uint32_t addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ void sts4(uint32_t addr, float a, float b, float c,
                                     float d) {
  asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n"
               :: "r"(addr), "f"(a), "f"(b), "f"(c), "f"(d) : "memory");
}

__device__ __forceinline__ float hi_part(float x) {
  return __uint_as_float(__float_as_uint(x) & kHiMask);
}
__device__ __forceinline__ float lo_part(float x) { return x - hi_part(x); }

// byte offset of element (row, col) of a tile stored as 32-wide column
// chunks of `rows` rows, 128-byte swizzled as TMA writes it (the 16-byte
// unit within a 128-byte row XOR row % 8)
__device__ __forceinline__ uint32_t swz(int rows, int row, int col) {
  return static_cast<uint32_t>((col / kChunk) * rows * kRow + row * kRow +
                               ((((col % kChunk) >> 2) ^ (row & 7)) << 4) +
                               (col & 3) * 4);
}

// wgmma shared-memory descriptor of a 128-byte-swizzled K-major tile at
// `addr` (1024-byte aligned up to the 32-byte k-step offsets): 8-row groups
// 1024 bytes apart (the stride byte offset; the leading one is unused)
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

// d (+)= A·B, A (64 × 8) and B (8 × 32) both K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (+)= A·B, A (64 × 8) and B (8 × 64) both K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += A·B, A (64 × 8) in registers, B (8 × 32) K-major in shared memory
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += A·B, A (64 × 8) in registers, B (8 × 64) K-major in shared memory
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += A·B, A (64 × 8) in registers, B (8 × 128) K-major in shared memory
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void mma_ss(float (&d)[N / 2], uint64_t da,
                                       uint64_t db, int accumulate) {
  static_assert(N == 32 || N == 64, "no such tile");
  if constexpr (N == 32)
    wgmma_ss_n32(d, da, db, accumulate);
  else
    wgmma_ss_n64(d, da, db, accumulate);
}

template <int N>
__device__ __forceinline__ void mma_rs(float (&d)[N / 2],
                                       const uint32_t (&a)[4], uint64_t db) {
  static_assert(N == 32 || N == 64 || N == 128, "no such tile");
  if constexpr (N == 32)
    wgmma_rs_n32(d, a, db);
  else if constexpr (N == 64)
    wgmma_rs_n64(d, a, db);
  else
    wgmma_rs_n128(d, a, db);
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

// unit u of a (KV head, batch): 64 rows of one query head, the last rows
// first (they see the most keys)
struct Unit {
  int head, row_lo;
};
__device__ __forceinline__ Unit unit(int u, int group, int n_rb, int kvh) {
  return {kvh * group + u % group, (n_rb - 1 - u / group) * kRows};
}

template <int D, int NWG>
__global__ void __launch_bounds__(Tile<D, NWG>::THREADS, 1)
    fa_tc32_fwd(const __grid_constant__ CUtensorMap tm_q,
                const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v, const Params a) {
  using T = Tile<D, NWG>;
  constexpr int BK = T::BK;
  constexpr int TB = T::TILE_BYTES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t q_s = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t st_s = q_s + T::Q_BYTES;  // + stage · STAGE_BYTES
  constexpr int kStages = T::STAGES, kRaw = T::RAW;
  const uint32_t rawv_s = st_s + kStages * T::STAGE_BYTES;  // + slot · TB
  const uint32_t bar_q = rawv_s + kRaw * TB;
  auto raw_empty = [&](int slot) { return bar_q + 8u * (1 + slot); };
  auto full = [&](int st) { return bar_q + 8u * (1 + kRaw + st); };
  auto prepared = [&](int st) {
    return bar_q + 8u * (1 + kRaw + kStages + st);
  };
  auto empty = [&](int st) {
    return bar_q + 8u * (1 + kRaw + 2 * kStages + st);
  };

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int group = a.h / a.kvh;
  const int n_rb = (a.s + kRows - 1) / kRows;
  const int units = group * n_rb;
  const int u0 = blockIdx.z * NWG;
  const int n_ch = (a.dh + kChunk - 1) / kChunk;  // chunks holding data
  int n_kt = 0;
#pragma unroll
  for (int w = 0; w < NWG; ++w)
    if (u0 + w < units) {
      const Unit un = unit(u0 + w, group, n_rb, kvh);
      n_kt = max(n_kt, (keys_seen(a, un.row_lo + kRows) + BK - 1) / BK);
    }

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int slot = 0; slot < kRaw; ++slot) mbar_init(raw_empty(slot), kPrep);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full(st), 1);
      mbar_init(prepared(st), kPrep);
      mbar_init(empty(st), kWG * NWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / kWG;
  if (wg == NWG) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(T::PREP_REGS));
    const int pt = threadIdx.x % kWG - 32;  // prep thread, or < 0
    if (pt < -31) {
      // the producer: one thread issues every copy
      uint32_t q_bytes = 0;
#pragma unroll
      for (int w = 0; w < NWG; ++w)
        q_bytes += u0 + w < units ? n_ch * kRows * kRow : 0;
      mbar_expect_tx(bar_q, q_bytes);
#pragma unroll
      for (int w = 0; w < NWG; ++w) {
        if (u0 + w >= units) continue;
        const Unit un = unit(u0 + w, group, n_rb, kvh);
        for (int c = 0; c < n_ch; ++c)
          tma_load(q_s + w * kRows * D * 4 + c * kRows * kRow, &tm_q, bar_q,
                   c * kChunk, un.head, un.row_lo, b);
      }
      for (int kt = 0; kt < n_kt; ++kt) {
        const int st = kt % kStages;
        mbar_wait(empty(st), ((kt / kStages) & 1) ^ 1);
        mbar_wait(raw_empty(kt % kRaw), ((kt / kRaw) & 1) ^ 1);
        const uint32_t ks = st_s + st * T::STAGE_BYTES;
        mbar_expect_tx(full(st), 2 * n_ch * BK * kRow);
        for (int c = 0; c < n_ch; ++c) {
          tma_load(ks + c * BK * kRow, &tm_k, full(st), c * kChunk, kvh,
                   kt * BK, b);
          tma_load(rawv_s + (kt % kRaw) * TB + c * BK * kRow, &tm_v, full(st),
                   c * kChunk, kvh, kt * BK, b);
        }
      }
    } else if (pt >= 0) {
      // prep: K_lo beside K; Vᵀ_hi and Vᵀ_lo from raw V. A V unit is 8
      // keys × 4 dh columns: 8 float4 reads along dh, 4 × 2 float4 writes
      // along the (permuted) keys of each of Vᵀ's two parts
      const int n_dq = n_ch * (kChunk / 4);
      for (int kt = 0; kt < n_kt; ++kt) {
        const int st = kt % kStages;
        mbar_wait(full(st), (kt / kStages) & 1);
        const uint32_t ks = st_s + st * T::STAGE_BYTES;
        const uint32_t vt_hi = ks + 2 * TB, vt_lo = ks + 3 * TB;
        const uint32_t raw = rawv_s + (kt % kRaw) * TB;
        for (int i = pt; i < n_dq * (BK / 8); i += kPrep) {
          const int d0 = 4 * (i % n_dq), j0 = 8 * (i / n_dq);
          float4 r[8];
#pragma unroll
          for (int jj = 0; jj < 8; ++jj)
            r[jj] = lds4(raw + swz(BK, j0 + jj, d0));
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float x[8];
#pragma unroll
            for (int jj = 0; jj < 8; ++jj)
              x[jj] = e == 0 ? r[jj].x : e == 1 ? r[jj].y
                    : e == 2 ? r[jj].z : r[jj].w;
            const int d = d0 + e;
            // slots j0..j0+3 hold keys j0 + 0, 2, 4, 6; j0+4.. keys 1, 3, 5, 7
            const uint32_t at0 = swz(D, d, j0), at1 = swz(D, d, j0 + 4);
            sts4(vt_hi + at0, hi_part(x[0]), hi_part(x[2]), hi_part(x[4]),
                 hi_part(x[6]));
            sts4(vt_hi + at1, hi_part(x[1]), hi_part(x[3]), hi_part(x[5]),
                 hi_part(x[7]));
            sts4(vt_lo + at0, lo_part(x[0]), lo_part(x[2]), lo_part(x[4]),
                 lo_part(x[6]));
            sts4(vt_lo + at1, lo_part(x[1]), lo_part(x[3]), lo_part(x[5]),
                 lo_part(x[7]));
          }
        }
        mbar_arrive(raw_empty(kt % kRaw));
        // K_lo: the same swizzled layout as K, element by element
        for (int i = pt; i < n_ch * BK * kRow / 16; i += kPrep) {
          const float4 x = lds4(ks + 16 * i);
          sts4(ks + TB + 16 * i, lo_part(x.x), lo_part(x.y), lo_part(x.z),
               lo_part(x.w));
        }
        fence_async_smem();
        mbar_arrive(prepared(st));
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(T::MMA_REGS));
  // a consumer warpgroup: unit u0 + wg, or none
  const int warp = (threadIdx.x % kWG) / 32;
  const int lane = threadIdx.x % 32;
  const bool live = u0 + wg < units;
  const Unit un = unit(live ? u0 + wg : u0, group, n_rb, kvh);
  const int r0 = un.row_lo + 16 * warp + lane / 4;  // and r0 + 8
  const int cq = 2 * (lane % 4);
  const int n_wg =
      live ? (keys_seen(a, un.row_lo + kRows) + BK - 1) / BK : 0;
  const int n_k8 = (a.dh + 7) / 8;  // S's k-steps: dh rounded up to 8
  const uint32_t q_wg = q_s + wg * kRows * D * 4;

  // Q_lo as TF32 A fragments, one for each 8-wide k slice of dh
  uint32_t q_lo[D / 8][4];
  if (live) {
    mbar_wait(bar_q, 0);
    const int rr = 16 * warp + lane / 4;
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      const int c = 8 * kk + lane % 4;
      q_lo[kk][0] = __float_as_uint(lo_part(lds(q_wg + swz(kRows, rr, c))));
      q_lo[kk][1] =
          __float_as_uint(lo_part(lds(q_wg + swz(kRows, rr + 8, c))));
      q_lo[kk][2] =
          __float_as_uint(lo_part(lds(q_wg + swz(kRows, rr, c + 4))));
      q_lo[kk][3] =
          __float_as_uint(lo_part(lds(q_wg + swz(kRows, rr + 8, c + 4))));
    }
  }

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.0f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.0f, 0.0f};

  for (int kt = 0; kt < n_kt; ++kt) {
    const int st = kt % kStages;
    mbar_wait(prepared(st), (kt / kStages) & 1);
    if (kt >= n_wg) {
      // no row of this warpgroup sees the tile: free the stage in turn
      mbar_arrive(empty(st));
      continue;
    }
    const uint32_t ks = st_s + st * T::STAGE_BYTES;
    const uint32_t k_lo = ks + TB, vt_hi = ks + 2 * TB, vt_lo = ks + 3 * TB;
    const int k0 = kt * BK;

    // S = Q_hi·K_hi + Q_hi·K_lo + Q_lo·K_hi over dh in k-steps of 8
    float s[BK / 2];
    pin(q_lo);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      if (kk >= n_k8) break;
      const uint64_t dq = desc(q_wg + (kk / 4) * kRows * kRow + (kk % 4) * 32);
      const uint64_t dk = desc(ks + (kk / 4) * BK * kRow + (kk % 4) * 32);
      const uint64_t dkl = desc(k_lo + (kk / 4) * BK * kRow + (kk % 4) * 32);
      mma_ss<BK>(s, dq, dk, kk > 0);
      mma_ss<BK>(s, dq, dkl, 1);
      mma_rs<BK>(s, q_lo[kk], dk);
    }
    wg_commit();
    wg_wait_all();
    pin(s);
    pin(q_lo);

    // scale into the log2 domain; mask only a tile that straddles a mask
    const int k1 = k0 + BK;
    bool whole = k1 <= a.t;
    if (a.causal)
      whole = whole && (k1 - 1 <= un.row_lo || k1 <= a.prefix_len);
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
    for (int i = 0; i < D / 2; ++i) o[i] *= corr[(i >> 1) & 1];

    // p = exp2(s − m), summed into l in f32, split into the TF32 A
    // fragments of P_hi and P_lo: k slot t takes key 2t, slot t + 4 key
    // 2t + 1 (Vᵀ's keys are permuted to match)
    uint32_t p_hi[BK / 8][4], p_lo[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = exp2f(s[4 * j + e] - m[e >> 1]);
        l[e >> 1] += p[e];
      }
      // a0 (row, 2t), a1 (row + 8, 2t), a2 (row, 2t + 1), a3 (row + 8, 2t + 1)
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        const float x = p[f == 1 ? 2 : f == 2 ? 1 : f];
        p_hi[j][f] = __float_as_uint(x) & kHiMask;
        p_lo[j][f] = __float_as_uint(lo_part(x));
      }
    }

    // O += P_hi·Vᵀ_hi + P_hi·Vᵀ_lo + P_lo·Vᵀ_hi, 8 keys a step, all of D
    pin(o);
    pin(p_hi);
    pin(p_lo);
    wg_fence();
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      const uint32_t off = (j / 4) * D * kRow + (j % 4) * 32;
      mma_rs<D>(o, p_hi[j], desc(vt_hi + off));
      mma_rs<D>(o, p_hi[j], desc(vt_lo + off));
      mma_rs<D>(o, p_lo[j], desc(vt_hi + off));
    }
    wg_commit();
    wg_wait_all();
    pin(o);
    pin(p_hi);
    pin(p_lo);
    mbar_arrive(empty(st));
  }
  if (!live) return;

  // the row sums of l over the quad, then o / max(l, 1e-30)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    if (row >= a.s) continue;
    float* op = a.o + (static_cast<long long>(b) * a.s + row) * a.h * a.dh +
                static_cast<long long>(un.head) * a.dh;
    const float denom = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = 8 * j + cq;
      const float x0 = o[4 * j + 2 * r] / denom;
      const float x1 = o[4 * j + 2 * r + 1] / denom;
      if (col + 1 < a.dh && (a.dh & 1) == 0) {
        *reinterpret_cast<float2*>(op + col) = make_float2(x0, x1);
      } else {
        if (col < a.dh) op[col] = x0;
        if (col + 1 < a.dh) op[col + 1] = x1;
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
constexpr int kGridTooLong = 92000;   // more q units than a grid dimension

// the 4-D map (dh, heads, rows, batch) of an f32 (B, rows, heads, dh) tensor
// with a unit last stride, in boxes of 32 × 1 × box_rows × 1, 128-byte
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
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sh) * 4,
                                 static_cast<cuuint64_t>(ss) * 4,
                                 static_cast<cuuint64_t>(sb) * 4};
  const cuuint32_t box[4] = {kChunk, 1, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<void*>(ptr), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeFailed + static_cast<int>(r);
}

// the dynamic shared memory limit of one instantiation, raised once a device
template <int D, int NWG>
cudaError_t allow_smem() {
  constexpr int kDevices = 64;
  static cudaError_t done[kDevices] = {};
  static bool set[kDevices] = {};
  int dev = 0;
  const cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kDevices)
    return cudaFuncSetAttribute(fa_tc32_fwd<D, NWG>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                Tile<D, NWG>::SMEM);
  if (!set[dev]) {
    done[dev] = cudaFuncSetAttribute(
        fa_tc32_fwd<D, NWG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        Tile<D, NWG>::SMEM);
    set[dev] = true;
  }
  return done[dev];
}

template <int D, int NWG>
int launch(const void* q, long long q_sb, long long q_ss, long long q_sh,
           const void* k, long long k_sb, long long k_ss, long long k_sh,
           const void* v, long long v_sb, long long v_ss, long long v_sh,
           int b, const Params& p, cudaStream_t stream) {
  using T = Tile<D, NWG>;
  const long long units =
      static_cast<long long>(p.h / p.kvh) * ((p.s + kRows - 1) / kRows);
  const long long ctas = (units + NWG - 1) / NWG;
  if (ctas > 65535) return kGridTooLong;
  CUtensorMap mq, mk, mv;
  int err = make_map(&mq, q, q_sb, q_ss, q_sh, b, p.s, p.h, p.dh, kRows);
  if (err == 0)
    err = make_map(&mk, k, k_sb, k_ss, k_sh, b, p.t, p.kvh, p.dh, T::BK);
  if (err == 0)
    err = make_map(&mv, v, v_sb, v_ss, v_sh, b, p.t, p.kvh, p.dh, T::BK);
  if (err != 0) return err;
  const cudaError_t attr = allow_smem<D, NWG>();
  if (attr != cudaSuccess) return static_cast<int>(attr);
  // KV heads fastest, the longest units first
  const dim3 grid(p.kvh, b, static_cast<unsigned>(ctas));
  fa_tc32_fwd<D, NWG><<<grid, T::THREADS, T::SMEM, stream>>>(mq, mk, mv, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches the kernel on `stream` and returns the CUDA error of the launch
// (0 when it was accepted; 90000 when the driver has no tensor-map encoder,
// 91000 + its CUresult when it refused a map, 92000 when S needs more than
// 65,535 CTAs a (KV head, batch)). q (B, S, H, dh), k and v (B, T, KV, dh),
// all float32 with a unit last stride and the given batch, sequence and
// head strides (in elements), each a multiple of 4 (16 bytes), on 16-byte
// aligned bases; o is (B, S, H, dh), contiguous. dh ≤ 128, H a multiple of
// KV; the wrapper checks all of it (ops.py::kernel_for).
extern "C" int flash_attention_tc32_fwd(
    const void* q, long long q_sb, long long q_ss, long long q_sh,
    const void* k, long long k_sb, long long k_ss, long long k_sh,
    const void* v, long long v_sb, long long v_ss, long long v_sh, void* o,
    int b, int s, int t, int h, int kvh, int dh, int causal, int prefix_len,
    float scale, void* stream) {
  const Params p{static_cast<float*>(o), s, t, h, kvh, dh, causal,
                 prefix_len, scale * kLog2e};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // three warpgroups for a GQA group of 3 (or 6, 9, ...) at 32 < dh ≤ 64,
  // else two
  const bool three = (h / kvh) % 3 == 0;
#define FA_TC32_LAUNCH(D, NWG)                                              \
  launch<D, NWG>(q, q_sb, q_ss, q_sh, k, k_sb, k_ss, k_sh, v, v_sb, v_ss, \
                 v_sh, b, p, st)
  if (dh <= 32) return FA_TC32_LAUNCH(32, 2);
  if (dh <= 64) return three ? FA_TC32_LAUNCH(64, 3) : FA_TC32_LAUNCH(64, 2);
  return FA_TC32_LAUNCH(128, 2);
#undef FA_TC32_LAUNCH
}
