// Hopper (sm_90a) building blocks for the port's hand-written kernels:
// mbarriers, bulk copies into shared memory (the TMA engine's 1-D form),
// proxy fences, named barriers, warpgroup register reallocation and the
// wgmma tensor-core product with its shared-memory descriptors and fences
// (bf16 operands, and TF32 with A from registers and the split of an f32
// value into two TF32 halves); then the two layer routines that
// csrc/fused_mlp.cu (the fused forward) and csrc/fused_igr.cu (the eikonal
// kernels) share, bf16 and split TF32: the ring of bulk-copied weight
// stages, the 64-column chunk product with its in-place hazard handling, and
// the softplus and sigmoid epilogues.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarrier ----------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(arrivals) : "memory");
}

// makes initialised barriers visible to the async proxy (bulk copies)
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// one arrival, and `bytes` more to come from bulk copies before the phase ends
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

// spin until the phase with the given parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// ---- bulk copy (TMA, 1-D) ------------------------------------------------------

// copy `bytes` (a multiple of 16; both addresses 16-byte aligned) from global
// to shared memory; completion is counted on `bar` as transaction bytes
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// asks for `bytes` (a multiple of 16) from src to be brought into L2 ahead
// of the loads that will read them; a hint, with no completion to wait for
__device__ __forceinline__ void prefetch_l2(const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(src), "r"(bytes) : "memory");
}

// orders this thread's ordinary shared-memory writes before later reads of
// the async proxy (wgmma operands, bulk copies)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---- named barriers and register reallocation -----------------------------------

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

template <int kRegs>
__device__ __forceinline__ void regs_increase() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

template <int kRegs>
__device__ __forceinline__ void regs_decrease() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

// ---- wgmma ------------------------------------------------------------------------

// Descriptor of a K-major operand in the 128-byte swizzled layout: rows of
// 64 bf16 (128 bytes), 16-byte groups of row r stored at group ^ (r % 8),
// 8-row groups 1024 bytes apart, the tile 1024-byte aligned. Advancing the
// start address by 32 bytes steps K by 16 within the 64-column block.
__device__ __forceinline__ uint64_t desc_k_sw128(const void* p) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4)         // start address
         | (uint64_t(1) << 16)           // leading byte offset (unused when swizzled)
         | (uint64_t(1024 >> 4) << 32)   // stride byte offset: next 8 rows
         | (uint64_t(1) << 62);          // 128-byte swizzle
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}

// keeps the compiler from moving accesses of accumulator registers across
// the wgmma fences and waits
template <int N>
__device__ __forceinline__ void fence_registers(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Descriptor of an MN-major operand in the 128-byte swizzle: each 128-byte
// row holds 64 consecutive M (or N) indices of one K index, 16-byte groups
// of row k stored at group ^ (k % 8), 8-row K groups 1024 bytes apart and
// consecutive 64-wide M (N) blocks `mn_block_bytes` apart; the tile 1024-byte
// aligned. It is the activation image of act_offset read with rows as K:
// the products over points of csrc/fused_igr.cu's dW pass. Advancing the
// start address by 2048 bytes steps K by 16.
__device__ __forceinline__ uint64_t desc_mn_sw128(const void* p, uint32_t mn_block_bytes) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4)                      // start address
         | (uint64_t(mn_block_bytes >> 4) << 16)      // leading byte offset: next 64 M (N)
         | (uint64_t(1024 >> 4) << 32)                // stride byte offset: next 8 K rows
         | (uint64_t(1) << 62);                       // 128-byte swizzle
}

// D(64 x N, f32) = A(64 x 16, bf16, shared) * B(16 x N, bf16, shared)
// + (scale_d ? D : 0); A and B K-major, or MN-major where kTransA / kTransB
// is 1. Thread t of the warpgroup holds
// D[16 w + t/4 % 8 + 8 (i/2 % 2)][8 (i/4) + 2 (t % 4) + i % 2] in d[i], w = t / 32.
template <int kTransA = 0, int kTransB = 0>
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d), "n"(kTransA), "n"(kTransB));
}

__device__ __forceinline__ void wgmma_m64n8k16(float (&d)[4], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, %4, %5, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(a), "l"(b), "r"(scale_d));
}

// ---- TF32 -------------------------------------------------------------------------

// v rounded to TF32 (10 mantissa bits) to nearest, ties away from zero: the
// bits of an f32 whose low 13 mantissa bits are zero. Integer arithmetic on
// the bits gives cvt.rna.tf32.f32's result for every finite v, and the f32
// fused forward takes 9% less time with it (tools/tf32_time_study.py)
__device__ __forceinline__ uint32_t tf32_rna(float v) { return (__float_as_uint(v) + 0x1000u) & 0xFFFFE000u; }

// v = hi + lo + e with hi = rna(v), lo = rna(v - hi) (v - hi is exact in
// f32) and |e| <= 2^-22 |v| for normal v: the two halves of a split-TF32
// product, whose three passes hi.hi + hi.lo + lo.hi drop only lo.lo
// (ops/fused_mlp.py split_tf32 is the same arithmetic on int32 views)
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(v);
  lo = tf32_rna(__fsub_rn(v, __uint_as_float(hi)));
}

// D(64 x N, f32) = A(64 x 8, tf32, registers) * B(8 x N, tf32, shared,
// K-major: TF32 operands take no transpose) + (scale_d ? D : 0). Warp w of
// the warpgroup holds rows 16 w .. 16 w + 15 of A; lane l holds a[0] at
// (16 w + l/4, l % 4), a[1] at row + 8, a[2] and a[3] at column + 4. D is
// laid out as in wgmma_m64n64k16. A shared-memory row of B (one output
// column) holds 32 f32 of K in the 128-byte swizzle: the start address
// advances 32 bytes per K step of 8.
__device__ __forceinline__ void wgmma_m64n64k8_tf32(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                                    int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n8k8_tf32(float (&d)[4], const uint32_t (&a)[4], uint64_t b,
                                                   int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// The same with N = 128: d[i] at row 16 w + t/4 % 8 + 8 (i/2 % 2), column
// 8 (i/4) + 2 (t % 4) + i % 2, as for m64n64
__device__ __forceinline__ void wgmma_m64n128k8_tf32(float (&d)[64], const uint32_t (&a)[4], uint64_t b,
                                                     int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <int N>
__device__ __forceinline__ void wgmma_tile_tf32(float (&acc)[N], const uint32_t (&a)[4], uint64_t db, int scale_d) {
  if constexpr (N == 64) {
    wgmma_m64n128k8_tf32(acc, a, db, scale_d);
  } else if constexpr (N == 32) {
    wgmma_m64n64k8_tf32(acc, a, db, scale_d);
  } else {
    wgmma_m64n8k8_tf32(acc, a, db, scale_d);
  }
}

// ==================================================================================
// The bf16 tensor-core layer routine
// ==================================================================================
//
// A consumer warpgroup holds a tile of kRows rows x up to kHMax columns of
// bf16 activations in shared memory (H), in the 128-byte swizzled K-major
// image of act_offset: kHMax / 64 K blocks of 64 rows x 128 bytes. That is
// the A operand of the next product as it stands. The weights stream through
// a ring of kStages stages, each kChunkN rows (output columns) x kKBlock K
// columns in the same image, filled by bulk copies from a producer
// warpgroup in the order the consumers take them (FusedNet.tiles,
// FusedNet.igr_tiles); each stage's full barrier takes the copy's bytes, its
// empty barrier one arrival per consumer warpgroup.

constexpr int kRows = 64;                       // rows of a warpgroup's tile (an m64 product)
constexpr int kHMax = 512;                      // widest padded layer a tile holds
constexpr int kWgThreads = 128;                 // a warpgroup
constexpr int kProducerRegs = 24;               // setmaxnreg: 128 x 24 + 256 x 240 <= 65,536
constexpr int kConsumerRegs = 240;
constexpr int kStages = 5;                      // weight stages in flight
constexpr int kChunkN = 64;                     // output columns per product (m64n64k16)
constexpr int kKBlock = 64;                     // K per stage: one 128-byte swizzled row
constexpr int kSumK = 32;                       // K per tensor-core sum; the sums are added in f32
constexpr int kLastRows = 8;                    // columns of a one-output layer's product (m64n8k16)
constexpr int kAcc = kChunkN / 2;               // accumulator registers of a chunk's product
constexpr int kBlockBytes = kRows * kKBlock * 2;           // one 64-row K block of activations: 8 KB
constexpr int kStageBytes = kChunkN * kKBlock * 2;         // 8 KB
constexpr int kHBytes = (kHMax / kKBlock) * kBlockBytes;   // a warpgroup's activations: 64 KB

// byte of element (row, col) in an activation image
__device__ __forceinline__ int act_offset(int row, int col) {
  return (col >> 6) * kBlockBytes + row * 128 + ((((col & 63) >> 3) ^ (row & 7)) << 4) + ((col & 7) << 1);
}

__device__ __forceinline__ uint8_t* aligned_smem(uint8_t* raw) {
  return raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
}

// round to the nearest bf16 (ties to even) on the integer pipe; the
// values are finite
__device__ __forceinline__ float bf16_rne(float v) {
  uint32_t u = __float_as_uint(v);
  u += 0x7fffu + ((u >> 16) & 1u);
  return __uint_as_float(u & 0xffff0000u);
}

// two bf16 values (held in f32) as one packed pair, lo at the lower address
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}
__device__ __forceinline__ float bf16_lo(uint32_t pair) { return __uint_as_float(pair << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t pair) { return __uint_as_float(pair & 0xffff0000u); }

__device__ __forceinline__ float ex2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float lg2_ftz(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float rcp_ftz(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

constexpr float kLog2E = 1.44269504088896341f;
constexpr float kLn2 = 0.69314718055994531f;

// softplus(beta v) / beta, with no branch, in the cheaper form
// (max(t,0) + ln2 lg2(1 + ex2(-|t| log2 e))) * RN(1/beta) on the hardware's
// approximate ex2/lg2: within ~2e-7 absolute of the exact form, against
// bf16 steps of 2^-8 relative
__device__ __forceinline__ float softplus_fast(float v, float beta, float rb) {
  const float t = __fmul_rn(beta, v);
  const float e = ex2_ftz(__fmul_rn(-fabsf(t), kLog2E));
  const float s = __fadd_rn(fmaxf(t, 0.f), __fmul_rn(lg2_ftz(__fadd_rn(1.f, e)), kLn2));
  return __fmul_rn(s, rb);
}

// The eikonal kernels (csrc/fused_igr.cu) recover sigmoid(beta z) from the
// stashed activation, s = 1 - exp(-beta h), so a small h must be right to
// its own precision, not only to ~2e-7: softplus_fast's ln2 lg2(1 + e)
// loses e's digits when e is small (relative error 1e-4 .. 1e-1 below
// t = -5). These forms keep every result to ~5e-6 of itself with a few
// FMAs: below 1/8 the series, above it the approximate ex2/lg2.

// log(1 + e) for e in [0, 1]
__device__ __forceinline__ float log1p_unit(float e) {
  const float series =
      __fmul_rn(e, __fmaf_rn(-e, __fmaf_rn(-e, __fmaf_rn(-e, __fmaf_rn(-e, 0.2f, 0.25f), 1.f / 3.f), 0.5f), 1.f));
  return e < 0.125f ? series : __fmul_rn(lg2_ftz(__fadd_rn(1.f, e)), kLn2);
}

// 1 - exp(-x) for x >= 0
__device__ __forceinline__ float one_minus_exp_neg(float x) {
  const float series = __fmul_rn(
      x, __fmaf_rn(-x, __fmaf_rn(-x, __fmaf_rn(-x, __fmaf_rn(-x, 1.f / 120.f, 1.f / 24.f), 1.f / 6.f), 0.5f), 1.f));
  return x < 0.125f ? series : __fsub_rn(1.f, ex2_ftz(__fmul_rn(-x, kLog2E)));
}

// softplus(beta v) / beta = (max(t, 0) + log1p(exp(-|t|))) * RN(1/beta)
__device__ __forceinline__ float softplus_rel(float v, float beta, float rb) {
  const float t = __fmul_rn(beta, v);
  return __fmul_rn(__fadd_rn(fmaxf(t, 0.f), log1p_unit(ex2_ftz(__fmul_rn(-fabsf(t), kLog2E)))), rb);
}

// sigmoid(beta v) = 1 / (1 + ex2(-beta v log2 e)) on the approximate ex2 and
// reciprocal (relative error ~1e-7); 0 and 1 at the ends
__device__ __forceinline__ float sigmoid_fast(float v, float beta) {
  return rcp_ftz(__fadd_rn(1.f, ex2_ftz(__fmul_rn(__fmul_rn(-beta, v), kLog2E))));
}

// sigmoid(beta z) recovered from h = softplus(beta z) / beta >= 0
__device__ __forceinline__ float sigmoid_from_softplus(float h, float beta) {
  return one_minus_exp_neg(__fmul_rn(beta, h));
}

// The activation of a bf16-rounded pre-activation, rounded to bf16, with
// no branch (a chunk's elements interleave): softplus_fast, or ReLU.
// Against exact sums the exact softplus (expf, log1pf, division by beta)
// reads the same max and a mean 0.4% lower, and takes 1.84x the time of the
// fused forward (PERF.md).
template <bool kSoftplus>
__device__ __forceinline__ float activate_bf16(float v, float beta, float rb) {
  v = bf16_rne(v);
  if constexpr (kSoftplus) {
    v = softplus_fast(v, beta, rb);
  } else {
    v = fmaxf(v, 0.f);
  }
  return bf16_rne(v);
}

// kN stage slots of kBytes each; the bf16 routines' ring is Ring
template <int kN, int kBytes>
struct StageRing {
  static constexpr int kSlots = kN;
  uint8_t* stages;
  uint64_t* full;
  uint64_t* empty;
  int s = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ uint8_t* stage() const { return stages + s * kBytes; }
  __device__ __forceinline__ void advance() {
    if (++s == kN) {
      s = 0;
      phase ^= 1;
    }
  }
};
using Ring = StageRing<kStages, kStageBytes>;

// one thread: barriers of a ring at `bars` (2 kN) over stages at `stages`,
// with `consumers` arrivals per empty phase
template <class R = Ring>
__device__ __forceinline__ R ring_init(uint8_t* stages, uint64_t* bars, int consumers, bool init) {
  R ring;
  ring.stages = stages;
  ring.full = bars;
  ring.empty = bars + R::kSlots;
  if (init) {
    for (int s = 0; s < R::kSlots; ++s) {
      mbar_init(&ring.full[s], 1);
      mbar_init(&ring.empty[s], consumers);
    }
    fence_barrier_init();
  }
  return ring;
}

// producer: `count` stages of `bytes` each (<= the slot) from src into the
// ring, in order; returns the source address past them
template <int kN, int kBytes>
__device__ __forceinline__ const uint8_t* produce(StageRing<kN, kBytes>& ring, const uint8_t* src, uint32_t bytes,
                                                  int count) {
  for (int t = 0; t < count; ++t) {
    mbar_wait(&ring.empty[ring.s], ring.phase ^ 1);
    mbar_arrive_expect_tx(&ring.full[ring.s], bytes);
    bulk_load(ring.stage(), src, bytes, &ring.full[ring.s]);
    src += bytes;
    ring.advance();
  }
  return src;
}

template <int N>
__device__ __forceinline__ void wgmma_tile(float (&acc)[N], uint64_t da, uint64_t db, int scale_d) {
  if constexpr (N == 32) {
    wgmma_m64n64k16(acc, da, db, scale_d);
  } else {
    wgmma_m64n8k16(acc, da, db, scale_d);
  }
}

// The issue schedule. A product is acc = A(64 x 64 kbs, the warpgroup's
// activations H) * B(the next kbs stages of the ring); each stage is two
// groups of kSumK-deep tensor-core sums, each summed into registers of its
// own (a part) and added to acc in f32, in order: acc = ((0 + p0) + p1) + ...
// Two groups are in flight: a stage's group 1 is issued before its group
// 0's sum is added, and the next stage's group 0 before its group 1's sum
// is, so the adds and the ring's barriers run under the tensor cores' work.
// Nothing of the arithmetic moves: every sum is the same 32-deep
// tensor-core sum of the same operands, and the adds are the same f32 adds
// in the same order, so no result depends on the schedule, to the bit.
// A stage goes back to the producer once both its groups have completed.
// The group that crosses a loop edge (the next stage's, the next chunk's)
// is read only after a full wait: ptxas serialises every wgmma of a kernel
// in which such a group is read after a partial wait (C7514). The stages
// stay a loop: unrolled, they left too few registers for the pipeline
// (C7511, and spills).
static_assert(kKBlock == 2 * kSumK, "a stage holds two groups");

// group g (0 or 1) of the ring's current stage: H's K block kb times the
// stage's K columns kSumK g .. kSumK g + kSumK - 1, into part, as one
// committed wgmma group
template <int N>
__device__ __forceinline__ void issue_group(float (&part)[N], const uint8_t* H, int kb, const Ring& ring, int g) {
  const uint8_t* a = H + kb * kBlockBytes;
  const uint8_t* b = ring.stage();
  wgmma_fence();  // part was last read by an add
#pragma unroll
  for (int u = 0; u < kSumK / 16; ++u) {
    const int off = 2 * (g * kSumK + 16 * u);  // bytes along the 128-byte row
    wgmma_tile(part, desc_k_sw128(a + off), desc_k_sw128(b + off), u > 0);
  }
  wgmma_commit();
}

// acc += part, once the caller has waited for part's group
template <int N>
__device__ __forceinline__ void add_group(float (&acc)[N], float (&part)[N]) {
  fence_registers(part);
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] = __fadd_rn(acc[i], part[i]);
}

// a product's first group: waits for the ring's current stage and issues its
// group 0 into p[0], where stream() takes it up
template <int N>
__device__ __forceinline__ void stream_open(float (&p)[2][N], const uint8_t* H, Ring& ring) {
  mbar_wait(&ring.full[ring.s], ring.phase);
  issue_group(p[0], H, 0, ring, 0);
}

// one stage of stream(), whose group 0 is in flight in p[0]: its group 1
// goes out, group 0 is added, then (kOpen) the ring's next stage's group 0
// goes out into p[0] (of stage kb_next) before group 1 is added
template <bool kOpen, int N>
__device__ __forceinline__ void stream_stage(float (&acc)[N], float (&p)[2][N], const uint8_t* H, int kb,
                                             int kb_next, Ring& ring, bool signal) {
  wgmma_wait<0>();
  issue_group(p[1], H, kb, ring, 1);
  add_group(acc, p[0]);
  uint64_t* read = &ring.empty[ring.s];
  ring.advance();
  if constexpr (kOpen) {
    mbar_wait(&ring.full[ring.s], ring.phase);
    issue_group(p[0], H, kb_next, ring, 0);
    wgmma_wait<1>();
  } else {
    wgmma_wait<0>();
  }
  add_group(acc, p[1]);
  if (signal) mbar_arrive(read);  // both groups of stage kb have completed
}

// acc = the product over kbs >= 1 stages whose first group stream_open
// issued. With kNext the next product over the same H (the layer's next
// chunk) is opened before the last group is added, and its first group is
// in flight on return; else every group has completed.
template <bool kNext, int N>
__device__ __forceinline__ void stream(float (&acc)[N], float (&p)[2][N], const uint8_t* H, int kbs, Ring& ring,
                                       bool signal) {
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] = 0.f;
  for (int kb = 0; kb < kbs - 1; ++kb) stream_stage<true>(acc, p, H, kb, kb + 1, ring, signal);
  stream_stage<kNext>(acc, p, H, kbs - 1, 0, ring, signal);
}

// acc = A(64 x 64 kbs, H) * B(the next kbs stages of the ring), a product
// by itself (a one-output layer); zero for kbs = 0
template <int N>
__device__ __forceinline__ void mma_stream(float (&acc)[N], const uint8_t* H, int kbs, Ring& ring, bool signal) {
  if (kbs == 0) {
#pragma unroll
    for (int i = 0; i < N; ++i) acc[i] = 0.f;
    return;
  }
  float p[2][N];
  stream_open(p, H, ring);
  stream<false>(acc, p, H, kbs, ring, signal);
}

// Finished chunks that a consumer keeps in registers beside the two groups
// in flight, and the chunks of a layer of `chunks` that wait in shared
// memory instead (chunked_layer's kParked): a kernel sizes its park from its
// widest layer's chunk count.
constexpr int kHeldMax = 4;
__host__ __device__ constexpr int parked_chunks(int chunks) {
  return chunks - 1 > kHeldMax ? chunks - 1 - kHeldMax : 0;
}
constexpr int kParkBytes = kChunkN / 4 * kWgThreads * 4;  // a parked chunk of a warpgroup: 8 KB

// One layer over a warpgroup's tile: kChunks products of 64 output columns,
// each H (64 x 64 kbs) times the next kbs stages of the ring, whose outputs
// replace H (kbs = 0: no hidden input, the first layer). A 64 x 512 f32
// accumulator does not fit the registers, so the layer runs chunk by
// chunk; finished chunks wait as packed bf16 until the last chunk's
// products have completed, then all are written back (the in-place
// hazard): the first kPark in shared memory at `park` (kPark x kChunkN / 4
// x 128 words, each thread its own), the others in registers. epilogue(c,
// acc, sink) turns chunk c's sums into packed bf16 pairs, sink(j, h, pair)
// taking columns kChunkN c + 8 j + cq, + 1 of row r0 + 8 h (r0 = 16 warp +
// lane / 4, cq = 2 (lane % 4)); before(c) issues loads chunk c's epilogue
// needs, ahead of it. Returns after a barrier of the warpgroup (`bar`): H
// holds the outputs, visible to the next product.
//
// The chunk boundary is no barrier: where the registers allow it (fewer
// than kHeldMax chunks held), chunk c + 1's first group is issued before
// chunk c's epilogue, which runs under it (before(c + 1) follows the epilogue,
// whose loads it would overwrite). Only a layer's last chunk completes
// before its outputs overwrite H. The chunk loop is not unrolled: each
// epilogue is one copy of code, which the instruction cache holds (unrolled
// over 8 chunks, the kernels were 2.2x longer and an epilogue took 2.5x as
// long as at 4 chunks). Its outputs go to the top row of `held`, which
// moves down a row before a held chunk's epilogue, so that held[k] ends as
// chunk kPark + k.
template <int kChunks, int kParked = 0, class Before, class Epilogue>
__device__ __forceinline__ void chunked_layer(uint8_t* H, int kbs, Ring& ring, int bar, int lt, Before before,
                                              Epilogue epilogue, uint32_t* park = nullptr) {
  constexpr int kPark = kParked < kChunks - 1 ? kParked : kChunks - 1;
  constexpr int kHeld = kChunks - 1 - kPark;
  constexpr int kTop = kHeld > 0 ? kHeld - 1 : 0;
  constexpr bool kAhead = kHeld < kHeldMax;  // the next chunk's first group under the epilogue
  constexpr int kPairs = kChunkN / 4;
  const int warp = lt >> 5, lane = lt & 31;
  const int r0 = 16 * warp + (lane >> 2), cq = 2 * (lane & 3);
  auto store = [&](int c, int j, int h, uint32_t pair) {
    *reinterpret_cast<uint32_t*>(H + act_offset(r0 + 8 * h, kChunkN * c + 8 * j + cq)) = pair;
  };
  float acc[kAcc];
  if (kbs == 0) {  // no hidden input: no product reads H, the outputs go straight to it
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
    named_barrier(bar, kWgThreads);
#pragma unroll 1
    for (int c = 0; c < kChunks; ++c) {
      before(c);
      epilogue(c, acc, [&](int j, int h, uint32_t pair) { store(c, j, h, pair); });
    }
    fence_proxy_async();
    named_barrier(bar, kWgThreads);
    return;
  }
  uint32_t held[kTop + 1][kPairs];  // finished chunks, packed bf16
  float p[2][kAcc];
  before(0);
  stream_open(p, H, ring);
#pragma unroll 1
  for (int c = 0; c < kChunks - 1; ++c) {
    stream<kAhead>(acc, p, H, kbs, ring, lt == 0);
    if (c > kPark) {
#pragma unroll
      for (int k = 0; k < kTop; ++k)
#pragma unroll
        for (int i = 0; i < kPairs; ++i) held[k][i] = held[k + 1][i];
    }
    epilogue(c, acc, [&](int j, int h, uint32_t pair) { held[kTop][2 * j + h] = pair; });
    if (c < kPark) {
#pragma unroll
      for (int i = 0; i < kPairs; ++i) park[(c * kPairs + i) * kWgThreads + lt] = held[kTop][i];
    }
    before(c + 1);
    if (!kAhead) stream_open(p, H, ring);
  }
  stream<false>(acc, p, H, kbs, ring, lt == 0);
  // every product of this layer has read H: overwrite it
  named_barrier(bar, kWgThreads);
#pragma unroll
  for (int cc = 0; cc < kPark; ++cc)
#pragma unroll
    for (int i = 0; i < kPairs; ++i) store(cc, i >> 1, i & 1, park[(cc * kPairs + i) * kWgThreads + lt]);
#pragma unroll
  for (int cc = kPark; cc < kChunks - 1; ++cc)
#pragma unroll
    for (int i = 0; i < kPairs; ++i) store(cc, i >> 1, i & 1, held[cc - kPark][i]);
  epilogue(kChunks - 1, acc, [&](int j, int h, uint32_t pair) { store(kChunks - 1, j, h, pair); });
  fence_proxy_async();  // the next layer's wgmma reads what was just written
  named_barrier(bar, kWgThreads);
}

// chunked_layer for a caller that writes each layer's outputs to device
// memory anyway (the eikonal backward's workspace): finished chunks go
// straight to `image` (global, the same swizzled image as H, block c at byte
// c kBlockBytes), and once the last chunk's products have completed H is
// read back from it, so nothing waits in registers or shared memory and
// the next chunk's first group always runs under the epilogue. On return
// the image holds the whole layer too.
template <int kChunks, class Before, class Epilogue>
__device__ __forceinline__ void image_layer(uint8_t* H, int kbs, Ring& ring, int bar, int lt, Before before,
                                            Epilogue epilogue, uint8_t* image) {
  const int warp = lt >> 5, lane = lt & 31;
  const int r0 = 16 * warp + (lane >> 2), cq = 2 * (lane & 3);
  auto at = [&](uint8_t* base, int c, int j, int h) {
    return reinterpret_cast<uint32_t*>(base + act_offset(r0 + 8 * h, kChunkN * c + 8 * j + cq));
  };
  float acc[kAcc];
  if (kbs == 0) {  // no hidden input: no product reads H, the outputs go straight to it
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
    named_barrier(bar, kWgThreads);
#pragma unroll 1
    for (int c = 0; c < kChunks; ++c) {
      before(c);
      epilogue(c, acc, [&](int j, int h, uint32_t pair) { *at(H, c, j, h) = *at(image, c, j, h) = pair; });
    }
    fence_proxy_async();
    named_barrier(bar, kWgThreads);
    return;
  }
  float p[2][kAcc];
  before(0);
  stream_open(p, H, ring);
#pragma unroll 1
  for (int c = 0; c < kChunks - 1; ++c) {
    stream<true>(acc, p, H, kbs, ring, lt == 0);
    epilogue(c, acc, [&](int j, int h, uint32_t pair) { *at(image, c, j, h) = pair; });
    before(c + 1);
  }
  stream<false>(acc, p, H, kbs, ring, lt == 0);
  // every product of this layer has read H, and the image holds chunks 0 .. kChunks - 2
  named_barrier(bar, kWgThreads);
  const uint4* src = reinterpret_cast<const uint4*>(image);
  uint4* dst = reinterpret_cast<uint4*>(H);
  for (int i = lt; i < (kChunks - 1) * kBlockBytes / 16; i += kWgThreads) dst[i] = src[i];
  epilogue(kChunks - 1, acc,
           [&](int j, int h, uint32_t pair) { *at(H, kChunks - 1, j, h) = *at(image, kChunks - 1, j, h) = pair; });
  fence_proxy_async();  // the next layer's wgmma reads what was just written
  named_barrier(bar, kWgThreads);
}

// x . w over the d_in coordinates, the products exact in f32
__device__ __forceinline__ float coord_dot(const float (&x)[4], const float (&w)[4], int d_in) {
  float t = __fmul_rn(x[0], w[0]);
#pragma unroll
  for (int r = 1; r < 4; ++r)
    if (r < d_in) t = __fmaf_rn(x[r], w[r], t);
  return t;
}

constexpr float kInvSqrt2 = 0.70710678118654752440f;

// T: the type of the weight buffer (bf16, or f32 for the f32 routines)
template <class T>
struct LayerArgsT {
  int k, n, d_in;
  bool skip;
  float beta, rb;               // beta and RN(1 / beta)
  const float* bias;            // this layer's biases
  const T* wx;                  // coordinate rows (d_in x n), or null
};
using LayerArgs = LayerArgsT<__nv_bfloat16>;

// layer l of a descriptor (int64 x 6 per layer: k, n, skip, bias offset,
// hidden-input offset, coordinate-input offset or -1; FusedNet.layout)
template <class T>
__device__ __forceinline__ LayerArgsT<T> layer_args(const long long* desc, int l, int d_in, float beta, float rb,
                                                    const T* W, const float* B) {
  const long long* d = desc + 6 * l;
  LayerArgsT<T> L;
  L.k = static_cast<int>(d[0]);
  L.n = static_cast<int>(d[1]);
  L.d_in = d_in;
  L.skip = d[2] != 0;
  L.beta = beta;
  L.rb = rb;
  L.bias = B + d[3];
  L.wx = d[5] >= 0 ? W + d[5] : nullptr;
  return L;
}

// two neighbouring weights as f32
__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  const __nv_bfloat162 w = *reinterpret_cast<const __nv_bfloat162*>(p);
  return make_float2(__low2float(w), __high2float(w));
}
__device__ __forceinline__ float2 load_pair(const float* p) { return *reinterpret_cast<const float2*>(p); }

// coordinate term, scale and bias of output columns col and col + 1 for the
// thread's rows r0 (h = 0) and r0 + 8 (h = 1), applied to their sums; with
// kTangentRow the row h = 1 is a tangent, which takes no bias
template <bool kTangentRow = false, class T>
__device__ __forceinline__ void column_pair(const LayerArgsT<T>& L, int col, const float (&x)[2][4],
                                            float (&v)[2][2]) {
  const float2 bias = __ldg(reinterpret_cast<const float2*>(L.bias + col));
  float w0[4] = {0.f, 0.f, 0.f, 0.f}, w1[4] = {0.f, 0.f, 0.f, 0.f};
  if (L.wx != nullptr) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      if (r < L.d_in) {
        const float2 w = load_pair(L.wx + r * L.n + col);
        w0[r] = w.x;
        w1[r] = w.y;
      }
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float a = v[h][0], b = v[h][1];
    if (L.wx != nullptr) {
      a = __fadd_rn(a, coord_dot(x[h], w0, L.d_in));
      b = __fadd_rn(b, coord_dot(x[h], w1, L.d_in));
    }
    if (L.skip) {
      a = __fmul_rn(a, kInvSqrt2);
      b = __fmul_rn(b, kInvSqrt2);
    }
    if (kTangentRow && h == 1) {
      v[h][0] = a;
      v[h][1] = b;
    } else {
      v[h][0] = __fadd_rn(a, bias.x);
      v[h][1] = __fadd_rn(b, bias.y);
    }
  }
}


// ==================================================================================
// The split-TF32 layer routine (f32 products)
// ==================================================================================
//
// A TF32 operand keeps 10 mantissa bits, so each f32 operand v is split into
// hi = rna(v) and lo = rna(v - hi) (split_tf32) and every product is issued
// three times, hi.hi + hi.lo + lo.hi (lo.lo, ~2^-22 of it, is dropped).
// A CTA holds one tile of kRows rows x up to kHMax columns of f32 in shared
// memory (128 KB) as float4 H4[g][t]: column group g (columns 8 g .. 8 g +
// 7) of thread slot t (warp w = t / 32, lane l; rows r0 = 16 w + l / 4 and
// r0 + 8; q = l % 4) holds (r0, 8 g + 2 q), (r0 + 8, 8 g + 2 q), (r0, 8 g +
// 2 q + 1), (r0 + 8, 8 g + 2 q + 1): the four values of K step g of a TF32 A
// fragment if the K slots q and q + 4 of the step stand for columns 2 q and
// 2 q + 1, and the four values thread t of either consumer finds in its
// accumulator for group g. A thread reads and writes only its slot, which
// the same thread of the other consumer shares, 16 bytes at a time: a warp
// 512 contiguous bytes. Two consumer warpgroups split each layer's output
// columns; each takes the weight stages of its columns from its own ring:
// 64 output columns x 32 K, the hi image, then the lo image (16 KB), the K
// axis permuted within each 8 as above, in the 128-byte swizzle
// (FusedNet.tf32_tiles, FusedNet.igr_tf32_tiles).

constexpr int kTf32KBlock = 32;                               // K per stage: one 128-byte row of f32
constexpr int kTf32Steps = kTf32KBlock / 8;                   // K steps (m64nNk8) per stage
constexpr int kTf32ImageBytes = kChunkN * kTf32KBlock * 4;    // one image of a stage: 8 KB
constexpr int kTf32StageBytes = 2 * kTf32ImageBytes;          // the hi image, then the lo image
constexpr int kTf32LastImage = kLastRows * kTf32KBlock * 4;   // a one-output layer's images: 1 KB
constexpr size_t kTf32HBytes = size_t(kRows) * kHMax * 4;     // a tile's f32 rows: 128 KB

// the hi and lo A fragments of K step s from the thread's slot of H
__device__ __forceinline__ void a_fragments(const float4* H4, int s, int lt, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  const float4 a = H4[s * kWgThreads + lt];
  split_tf32(a.x, hi[0], lo[0]);
  split_tf32(a.y, hi[1], lo[1]);
  split_tf32(a.z, hi[2], lo[2]);
  split_tf32(a.w, hi[3], lo[3]);
}

// acc = A(64 x 32 kbs, the tile) * B(the next kbs stages of the ring,
// `lo_off` bytes from the hi image to the lo image), every K step as its
// kPasses products (3, or 1: hi.hi only), summed on the tensor cores in
// groups kSumK deep that are added to acc in f32; the stages are handed back
// once read. The tensor cores truncate inside a sum, so a group sums its
// correction products first, at their own scale (~2^-11 of the main
// products), then the hi.hi products onto them: every truncation at the
// main sum's scale is one the hi.hi sum alone would make.
template <int kSumK, int kPasses, int N, class R>
__device__ __forceinline__ void tf32_stream(float (&acc)[N], const float4* H4, int kbs, R& ring, int lt,
                                            int lo_off) {
  static_assert(kSumK % 8 == 0 && kTf32KBlock % kSumK == 0, "group depth");
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] = 0.f;
  for (int kb = 0; kb < kbs; ++kb) {
    mbar_wait(&ring.full[ring.s], ring.phase);
    const uint8_t* b = ring.stage();
    constexpr int kG = kSumK / 8;  // K steps per group
#pragma unroll
    for (int g = 0; g < kTf32Steps / kG; ++g) {
      uint32_t hi[kG][4], lo[kG][4];
#pragma unroll
      for (int u = 0; u < kG; ++u) a_fragments(H4, kb * kTf32Steps + g * kG + u, lt, hi[u], lo[u]);
      float part[N];
      wgmma_fence();
      if constexpr (kPasses == 3) {
#pragma unroll
        for (int u = 0; u < kG; ++u) {
          const int off = 32 * (g * kG + u);
          wgmma_tile_tf32(part, hi[u], desc_k_sw128(b + lo_off + off), u > 0);
          wgmma_tile_tf32(part, lo[u], desc_k_sw128(b + off), 1);
        }
      }
#pragma unroll
      for (int u = 0; u < kG; ++u)
        wgmma_tile_tf32(part, hi[u], desc_k_sw128(b + 32 * (g * kG + u)), kPasses == 3 || u > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_registers(part);
#pragma unroll
      for (int i = 0; i < N; ++i) acc[i] = __fadd_rn(acc[i], part[i]);
    }
    if (lt == 0) mbar_arrive(&ring.empty[ring.s]);
    ring.advance();
  }
}

// chunk cc's values (a 64-column accumulator) into the thread's slot of H
// (groups 8 cc .. 8 cc + 7)
__device__ __forceinline__ void store_chunk(float4* H4, int cc, int lt, const float (&v)[kAcc]) {
#pragma unroll
  for (int j = 0; j < kChunkN / 8; ++j)
    H4[(8 * cc + j) * kWgThreads + lt] = make_float4(v[4 * j], v[4 * j + 2], v[4 * j + 1], v[4 * j + 3]);
}

// One layer of n = 128 NQ outputs over the tile, whose outputs replace H:
// consumer c computes chunks c NQ .. c NQ + NQ - 1, each H times the next
// kbs stages of its ring, and epilogue(chunk, acc) turns the chunk's sums
// into its outputs in place. Finished chunks wait in registers until both
// consumers' products have read H (named barrier 1 over both), then all are
// written back; the second barrier makes the whole layer visible to both.
template <int NQ, int kSumK, int kPasses, class R, class Epilogue>
__device__ __forceinline__ void tf32_layer(float4* H4, int kbs, R& ring, int c, int lt, Epilogue epilogue) {
  float held[NQ][kAcc];  // held[NQ - 1] is never used
  float acc[kAcc];
#pragma unroll
  for (int j = 0; j < NQ; ++j) {
    tf32_stream<kSumK, kPasses>(acc, H4, kbs, ring, lt, kTf32ImageBytes);
    epilogue(c * NQ + j, acc);
    if (j < NQ - 1) {
#pragma unroll
      for (int i = 0; i < kAcc; ++i) held[j][i] = acc[i];
    }
  }
  named_barrier(1, 2 * kWgThreads);
#pragma unroll
  for (int j = 0; j < NQ - 1; ++j) store_chunk(H4, c * NQ + j, lt, held[j]);
  store_chunk(H4, c * NQ + NQ - 1, lt, acc);
  named_barrier(1, 2 * kWgThreads);
}

// softplus(beta v) / beta = (max(t, 0) + log1p(exp(-|t|))) * RN(1 / beta),
// t = beta v, on the f32 library functions (within an ulp of the division
// by beta, whose slow path spilled registers and made the f32 fused forward
// 31% slower); or ReLU
template <bool kSoftplus>
__device__ __forceinline__ float activate_f32(float v, float beta, float rb) {
  if constexpr (kSoftplus) {
    const float t = __fmul_rn(beta, v);
    return __fmul_rn(__fadd_rn(fmaxf(t, 0.f), log1pf(expf(-fabsf(t)))), rb);
  } else {
    return fmaxf(v, 0.f);
  }
}

}  // namespace hopper
