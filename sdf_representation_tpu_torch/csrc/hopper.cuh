// Hopper (sm_90a) building blocks for the port's hand-written kernels:
// mbarriers, bulk copies into shared memory (the TMA engine's 1-D form),
// proxy fences, named barriers, warpgroup register reallocation and the
// wgmma tensor-core product with its shared-memory descriptors and fences;
// then the bf16 tensor-core layer routine that csrc/fused_mlp.cu (the fused
// forward) and csrc/fused_igr.cu (the eikonal kernels) share: the ring of
// bulk-copied weight stages, the 64-column chunk product with its in-place
// hazard handling, and the softplus and sigmoid epilogues.

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

struct Ring {
  uint8_t* stages;
  uint64_t* full;
  uint64_t* empty;
  int s = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ void advance() {
    if (++s == kStages) {
      s = 0;
      phase ^= 1;
    }
  }
};

// one thread: barriers of a ring at `bars` (2 kStages) over stages at
// `stages`, with `consumers` arrivals per empty phase
__device__ __forceinline__ Ring ring_init(uint8_t* stages, uint64_t* bars, int consumers, bool init) {
  Ring ring;
  ring.stages = stages;
  ring.full = bars;
  ring.empty = bars + kStages;
  if (init) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&ring.full[s], 1);
      mbar_init(&ring.empty[s], consumers);
    }
    fence_barrier_init();
  }
  return ring;
}

// producer: `count` stages of `bytes` each from src into the ring, in order;
// returns the source address past them
__device__ __forceinline__ const uint8_t* produce(Ring& ring, const uint8_t* src, uint32_t bytes, int count) {
  for (int t = 0; t < count; ++t) {
    mbar_wait(&ring.empty[ring.s], ring.phase ^ 1);
    mbar_arrive_expect_tx(&ring.full[ring.s], bytes);
    bulk_load(ring.stages + ring.s * kStageBytes, src, bytes, &ring.full[ring.s]);
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

// acc = A(64 x 64 kbs, the warpgroup's activations) * B(the next kbs stages
// of the ring), as kSumK-deep tensor-core sums added in order in f32; each
// stage is handed back to the producer once its products have completed.
template <int N>
__device__ __forceinline__ void mma_stream(float (&acc)[N], const uint8_t* H, int kbs, Ring& ring, bool signal) {
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] = 0.f;
  for (int kb = 0; kb < kbs; ++kb) {
    mbar_wait(&ring.full[ring.s], ring.phase);
    const uint8_t* a = H + kb * kBlockBytes;
    const uint8_t* b = ring.stages + ring.s * kStageBytes;
#pragma unroll
    for (int g = 0; g < kKBlock / kSumK; ++g) {
      float part[N];
      wgmma_fence();
#pragma unroll
      for (int u = 0; u < kSumK / 16; ++u) {
        const int off = 2 * (g * kSumK + 16 * u);  // bytes along the 128-byte row
        wgmma_tile(part, desc_k_sw128(a + off), desc_k_sw128(b + off), u > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_registers(part);
#pragma unroll
      for (int i = 0; i < N; ++i) acc[i] = __fadd_rn(acc[i], part[i]);
    }
    if (signal) mbar_arrive(&ring.empty[ring.s]);
    ring.advance();
  }
}

// One layer over a warpgroup's tile: kChunks products of 64 output columns,
// each H (64 x 64 kbs) times the next kbs stages of the ring, whose outputs
// replace H. A 64 x 512 f32 accumulator does not fit the registers, so the
// layer runs chunk by chunk; finished chunks wait as packed bf16 until the
// last chunk's products have completed, then all are written back (the
// in-place hazard): the first kParked chunks in shared memory at `park`
// (kParked x kChunkN / 4 x 128 words, each thread its own), the others in
// registers. before(c) runs before chunk c's products (to issue loads its
// epilogue needs); epilogue(c, acc, sink) turns chunk c's sums into packed
// bf16 pairs, sink(j, h, pair) taking columns kChunkN c + 8 j + cq, + 1 of
// row r0 + 8 h (r0 = 16 warp + lane / 4, cq = 2 (lane % 4)). Returns after
// a barrier of the warpgroup (`bar`): H holds the outputs, visible to the
// next product.
template <int kChunks, int kParked = 0, class Before, class Epilogue>
__device__ __forceinline__ void chunked_layer(uint8_t* H, int kbs, Ring& ring, int bar, int lt, Before before,
                                              Epilogue epilogue, uint32_t* park = nullptr) {
  constexpr int kPark = kParked < kChunks - 1 ? kParked : kChunks - 1;
  constexpr int kHeld = kChunks - 1 - kPark;
  const int warp = lt >> 5, lane = lt & 31;
  const int r0 = 16 * warp + (lane >> 2), cq = 2 * (lane & 3);
  uint32_t held[kHeld > 0 ? kHeld : 1][kChunkN / 4];  // finished chunks, packed bf16
  auto store = [&](int c, int j, int h, uint32_t pair) {
    *reinterpret_cast<uint32_t*>(H + act_offset(r0 + 8 * h, kChunkN * c + 8 * j + cq)) = pair;
  };
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    before(c);
    float acc[kAcc];
    mma_stream(acc, H, kbs, ring, lt == 0);
    if (c < kPark) {
      epilogue(c, acc, [&](int j, int h, uint32_t pair) { park[((c * kChunkN / 4) + 2 * j + h) * kWgThreads + lt] = pair; });
    } else if (c < kChunks - 1) {
      epilogue(c, acc, [&](int j, int h, uint32_t pair) { held[c - kPark][2 * j + h] = pair; });
    } else {
      // every product of this layer has read H: overwrite it
      named_barrier(bar, kWgThreads);
#pragma unroll
      for (int cc = 0; cc < kPark; ++cc)
#pragma unroll
        for (int i = 0; i < kChunkN / 4; ++i) store(cc, i >> 1, i & 1, park[(cc * kChunkN / 4 + i) * kWgThreads + lt]);
#pragma unroll
      for (int cc = kPark; cc < kChunks - 1; ++cc)
#pragma unroll
        for (int i = 0; i < kChunkN / 4; ++i) store(cc, i >> 1, i & 1, held[cc - kPark][i]);
      epilogue(c, acc, [&](int j, int h, uint32_t pair) { store(c, j, h, pair); });
      fence_proxy_async();  // the next layer's wgmma reads what was just written
      named_barrier(bar, kWgThreads);
    }
  }
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

struct LayerArgs {
  int k, n, d_in;
  bool skip;
  float beta, rb;               // beta and RN(1 / beta)
  const float* bias;            // this layer's biases
  const __nv_bfloat16* wx;      // coordinate rows (d_in x n), or null
};

// layer l of a descriptor (int64 x 6 per layer: k, n, skip, bias offset,
// hidden-input offset, coordinate-input offset or -1; FusedNet.layout)
__device__ __forceinline__ LayerArgs layer_args(const long long* desc, int l, int d_in, float beta, float rb,
                                                const __nv_bfloat16* W, const float* B) {
  const long long* d = desc + 6 * l;
  LayerArgs L;
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

// coordinate term, scale and bias of output columns col and col + 1 for the
// thread's rows r0 (h = 0) and r0 + 8 (h = 1), applied to their sums; with
// kTangentRow the row h = 1 is a tangent, which takes no bias
template <bool kTangentRow = false>
__device__ __forceinline__ void column_pair(const LayerArgs& L, int col, const float (&x)[2][4], float (&v)[2][2]) {
  const float2 bias = __ldg(reinterpret_cast<const float2*>(L.bias + col));
  float w0[4] = {0.f, 0.f, 0.f, 0.f}, w1[4] = {0.f, 0.f, 0.f, 0.f};
  if (L.wx != nullptr) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      if (r < L.d_in) {
        const __nv_bfloat162 w = *reinterpret_cast<const __nv_bfloat162*>(L.wx + r * L.n + col);
        w0[r] = __low2float(w);
        w1[r] = __high2float(w);
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

}  // namespace hopper
