// Fused ImplicitNet forward for Hopper (sm_90a), with a plain C interface
// for ctypes (sdf_representation_tpu_torch/ops/fused_mlp.py binds it).
//
// Replaces three TPU kernels of the JAX package, which share one body
// (ops/pallas_mlp.py _make_body):
//   * points mode     ops/pallas_mlp.py _make_kernel, pallas_call in _fused_apply_padded
//   * dense grid mode ops/pallas_mlp.py _make_kernel, pallas_call in _fused_grid_slab
//   * sparse blocks   ops/sparse_grid.py _make_block_kernel, pallas_call in refine_blocks
// and the two per-device kernels of ops/sharded_eval.py built from the same
// bodies: _local_sweep_pallas (the grid entry from a shard's base tile) and
// the pallas_call of _sparse_sharded_device (the blocks entry over a shard's
// slice of the active list), launched once per shard by the port's
// ops/sharded_eval.py.
// Three __global__ entries per working type differ only in where a tile's
// coordinates come from and where its results go; in each type one
// __device__ routine runs the whole network on the tensor cores (wgmma):
// bf16 products in bf16, f32 ones as three TF32 products of split
// operands. The C interface counts in tiles of 64 points.
//
// bf16: tensor cores (wgmma_forward). At 8x512 a point costs ~1.84 M
// multiply-adds against 12-16 bytes of input and output, so the bound is
// the tensor cores' operations: 62 ms for a 256^3 sweep at 989 TFLOP/s.
// What the design does about each cost beside the products:
//   * the weights (4 MB) are read from L2 once per CTA and layer. A CTA
//     takes 128 points (two 64-point tiles, one per consumer warpgroup), and
//     both warpgroups multiply by each weight stage, so a 256^3 sweep reads
//     ~0.5 TB from L2 (1.0 TB with 64 points). A producer warpgroup keeps a
//     ring of kStages stages in flight with bulk copies (TMA) on mbarriers;
//     setmaxnreg moves its registers to the consumers. The weights are laid
//     out on the host in the order and the 128-byte swizzled K-major image
//     the stages need (FusedNet.tiles), so one 1-D copy fills a stage. No
//     cluster multicast: L2 is not what bounds this design (below).
//   * the in-place hazard: a layer's outputs replace its inputs in shared
//     memory. A warpgroup's 64 x 512 f32 accumulator does not fit its
//     registers, so a layer runs as 64-column chunks (m64n64k16); finished
//     chunks wait as packed bf16 in registers (the values are bf16 anyway)
//     until the last chunk's products have completed, then all are written
//     back.
//   * the summation: the tensor cores truncate inside a sum, and one
//     activation rounded the other way moves the 8x512 field by up to
//     ~4e-3, so each 32-deep tensor-core sum is added to the f32
//     accumulator on its own: against exact sums (the bf16 plain version,
//     fused_mlp.forward_plain) this reads about 2.4x closer on average than
//     one f32 sum over all of K, and closer than 16-deep sums (PERF.md).
//   * the softplus epilogue (~6e10 activations in a 256^3 sweep) runs on
//     the CUDA cores without a branch, in the cheaper form of activate_bf16
//     (approximate ex2/lg2, a product by RN(1/beta)); phase 3 of
//     chip_smoke.py holds it to the unchanged bf16 limits.
// Measured on an H100 (chip_smoke.py, PERF.md): the sweep is bound by
// neither the tensor cores nor L2 but by the consumers' issue: the
// epilogue's dependent chains run on two warps per scheduler. Each 32-deep
// sum is added while the next group's products run (hopper.cuh's
// pipelined schedule, the same sums in the same order), and each epilogue
// is one copy of code in a chunk loop that is not unrolled.
// The ring, the chunk routine (chunked_layer) and the epilogue functions
// are csrc/hopper.cuh's, shared with the eikonal kernels (csrc/fused_igr.cu).
// Activations stay in shared memory as bf16 in the same swizzled K-major
// image, so they are the A operand as they stand. The coordinate rows (W_0,
// and W_bot of the skip layer; d_in <= 4) are added in the epilogue with
// d_in FMAs per output; the skip layer's scale and bias come after both
// sums. The last layer (one output) is an m64n8k16 product.
//
// f32: split-TF32 products (tf32_forward). A TF32 operand keeps 10 mantissa
// bits, so one TF32 pass moves the f32 field by far more than 2e-5; each
// operand v is split into hi = rna(v) and lo = rna(v - hi), so that
// |v - hi - lo| <= 2^-22 |v|, and every product is issued three times,
// hi.hi + hi.lo + lo.hi (lo.lo, ~2^-22 of it, is dropped). At 8x512 a point
// costs 3 x 1.84 M multiply-adds, so the bound is the tensor cores' TF32
// rate: 373 ms for a 256^3 sweep at 495 TFLOP/s (the FP32 pipes' 919 ms).
//   * shared memory: a 64-point tile's f32 activations take 128 KB, so a CTA
//     holds one tile. Its two consumer warpgroups split each layer's output
//     columns (256 each at 512); each has a ring of kF32Stages weight
//     stages of 64 output columns x 32 K (the hi image, then the lo image:
//     16 KB), filled by its own thread of the producer warpgroup.
//   * operands: the weights are split once on the host (FusedNet.tf32_tiles,
//     W^T rows in the 128-byte swizzle, 32 f32 a row), the activations on
//     the fly: A comes from registers, one 16-byte shared-memory load per K
//     step and two roundings per value on the integer pipe (hopper::tf32_rna:
//     the sweep takes 9% less than with cvt.rna.tf32). The activations stay
//     f32 in the order the A fragments take them (H below, conflict-free),
//     which is the order the accumulators hold them in; the weight images'
//     K axis is permuted within each 8 to match, so no value moves between
//     threads.
//   * accumulation: the tensor cores truncate inside a sum, so the products
//     are summed in groups kF32SumK deep and each group's sum is added to
//     the f32 accumulator with round-to-nearest. A group sums its
//     correction products first, at their own scale (~2^-11 of the main
//     products), then the hi.hi products onto them, so every truncation at
//     the main sum's scale is one that the hi.hi sum alone would make.
//     One chained sum over all of K read up to 3.9e-5 against the plain
//     version (over F32_TOL = 2e-5); groups 8, 16 and 32 deep at most
//     3.1e-6, and 32 is the fastest (tools/tf32_sum_study.py, PERF.md).
//   * the in-place hazard: a consumer holds its finished 64-column chunks in
//     registers (up to 3 x 32 a thread) until both consumers' products have
//     read the layer's inputs, then writes them back.
//   * L2: each CTA reads every stage once, 14.7 MB per 64-point tile at
//     8x512: 3.86 TB for a 256^3 sweep (the bf16 routine ~0.5 TB). Neither
//     a 2-CTA cluster multicast nor an on-chip split of one f32 stage, which
//     would each halve it, is taken: a build that copies only the hi images
//     (half the bytes) is 2% faster, and a third ring stage 0.5%
//     (tools/tf32_time_study.py, PERF.md).
//     Measured on an H100, the sweep takes 2.1x the bound: each consumer
//     waits for its group's products before it adds them, and the
//     epilogue's softplus (12% of the time) runs with the tensor cores idle
//     for that consumer.
//   * the epilogue's softplus is the f32 library's expf and log1pf, scaled
//     by RN(1 / beta): within an ulp of the division by beta, whose slow
//     path spilled registers and made the sweep 31% slower.
//
// Numerics kept from the JAX kernel:
//   * f32 mode: everything f32.
//   * bf16 mode: the input coordinates, each layer's f32 accumulator (before
//     the activation) and the activation's output are rounded to bf16;
//     weights are bf16, biases f32, the last layer's result stays f32.
//   * skip layer: (h W_top + x W_bot) * (1/sqrt 2) + b.
//   * softplus(beta*v)/beta = (max(t,0) + log1p(exp(-|t|)))/beta, t = beta*v.
// A point's result does not depend on its tile, its row or its entry: every
// row runs the same sequence of products and epilogue instructions, and
// grid coordinates are computed by one routine with explicit
// round-to-nearest intrinsics (-1 + step*i, no FMA contraction), so the
// sparse entry matches the dense one bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "hopper.cuh"

namespace {

using hopper::kAcc;
using hopper::kBlockBytes;
using hopper::kChunkN;
using hopper::kHBytes;
using hopper::kHMax;            // widest padded layer a tile holds
using hopper::kInvSqrt2;
using hopper::kKBlock;
using hopper::kLastRows;
using hopper::kStageBytes;
using hopper::kStages;
using hopper::kWgThreads;
using hopper::LayerArgs;
using hopper::Ring;

constexpr int kTileP = hopper::kRows;  // points per tile (the C interface's unit)
constexpr int kDesc = 6;               // int64 fields per layer descriptor

// layer descriptor (int64 x kDesc, device memory), see FusedNet.pack():
//   [0] k     rows of the hidden-input matrix (0 for the first layer)
//   [1] n     padded output width, a multiple of 128, <= kHMax
//   [2] skip  1: scale (h W_top + x W_bot) by 1/sqrt(2) before the bias
//   [3] b     element offset of the bias in the f32 bias buffer
//   [4] w     element offset of the hidden-input matrix (k x n, row-major)
//   [5] wx    element offset of the coordinate-input matrix (d_in x n), -1 if none

// the one place grid coordinates are made: -1 + step * i, rounded as f32
__device__ __forceinline__ float grid_coord(long long i, float step) {
  return __fadd_rn(-1.0f, __fmul_rn(step, static_cast<float>(i)));
}


template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
}

// =============================================================================
// f32: the split-TF32 wgmma routine
// =============================================================================

constexpr int kF32KBlock = hopper::kTf32KBlock;           // K per stage: one 128-byte row of f32
constexpr int kF32Stages = 3;                             // stages in each consumer's ring
constexpr int kF32StageBytes = hopper::kTf32StageBytes;   // the hi image, then the lo image
constexpr int kF32LastImage = hopper::kTf32LastImage;     // the last layer's images: 1 KB
// K per tensor-core group sum (8, 16 or 32) and products per K step (3:
// hi.hi + hi.lo + lo.hi; 1: hi.hi only, a single TF32 pass);
// tools/tf32_sum_study.py builds the variants
constexpr int kF32SumK = 32;
constexpr int kF32Passes = 3;
constexpr int kF32Threads = 3 * kWgThreads;               // producer + two consumers
// setmaxnreg: the launch gives each thread 168 registers (384 threads); the
// producers' warpgroup hands 128 of its 168 to the consumers (a consumer
// holds up to 3 finished chunks, its chunk's sums and the group's fragments)
constexpr int kF32ProducerRegs = 40;
constexpr int kF32ConsumerRegs = 232;
static_assert(kWgThreads * (168 - kF32ProducerRegs) >= 2 * kWgThreads * (kF32ConsumerRegs - 168), "registers");
constexpr size_t kF32OffRing = hopper::kTf32HBytes;       // after the tile's f32 activations (128 KB)
constexpr size_t kF32OffX = kF32OffRing + 2 * size_t(kF32Stages) * kF32StageBytes;
constexpr size_t kF32OffBar = kF32OffX + size_t(kTileP) * 4 * sizeof(float);
constexpr size_t kF32Smem = kF32OffBar + 4 * kF32Stages * sizeof(uint64_t) + 1024;  // + alignment slack
static_assert(kF32Smem <= 232448, "the f32 routine's shared memory");

using F32Ring = hopper::StageRing<kF32Stages, kF32StageBytes>;
using F32Layer = hopper::LayerArgsT<float>;

// Shared memory (from a 1024-byte aligned base):
//   H        the tile's 64 x kHMax f32 activations as float4 H[g][t], in
//            csrc/hopper.cuh's slot order (the order the A fragments and the
//            accumulators both take)
//   rings    two rings (one per consumer) of kF32Stages stages: the hi and
//            the lo image of 64 W^T rows x 32 K, K permuted within each 8 as
//            above, in the 128-byte swizzle (FusedNet.tf32_tiles)
//   xs       64 x 4 f32 coordinates
//   full, empty  the rings' mbarriers

// the thread's 32 values of a 64-column chunk's accumulator, whose first
// column is col0, with their coordinate term, scale, bias and activation
template <bool kSoftplus>
__device__ __forceinline__ void f32_epilogue(float (&acc)[kAcc], int col0, int q, const F32Layer& L,
                                             const float (&x)[2][4]) {
#pragma unroll
  for (int j = 0; j < kChunkN / 8; ++j) {
    float v[2][2] = {{acc[4 * j], acc[4 * j + 1]}, {acc[4 * j + 2], acc[4 * j + 3]}};
    hopper::column_pair(L, col0 + 8 * j + 2 * q, x, v);
    acc[4 * j] = hopper::activate_f32<kSoftplus>(v[0][0], L.beta, L.rb);
    acc[4 * j + 1] = hopper::activate_f32<kSoftplus>(v[0][1], L.beta, L.rb);
    acc[4 * j + 2] = hopper::activate_f32<kSoftplus>(v[1][0], L.beta, L.rb);
    acc[4 * j + 3] = hopper::activate_f32<kSoftplus>(v[1][1], L.beta, L.rb);
  }
}

// One hidden layer (n = 128 NQ outputs): hopper::tf32_layer, consumer c
// computing chunks c NQ .. c NQ + NQ - 1
template <int NQ, bool kSoftplus>
__device__ __forceinline__ void f32_hidden_layer(const F32Layer& L, float4* H4, F32Ring& ring, int c, int lt,
                                                 const float (&x)[2][4]) {
  const int q = lt & 3;
  hopper::tf32_layer<NQ, kF32SumK, kF32Passes>(H4, L.k / kF32KBlock, ring, c, lt, [&](int ch, float (&acc)[kAcc]) {
    f32_epilogue<kSoftplus>(acc, kChunkN * ch, q, L, x);
  });
}

// The last layer (one output, consumer 0): column 0 of an m64n8k8 product;
// emit(row, v) for the tile's rows
template <class Emit>
__device__ __forceinline__ void f32_last_layer(const F32Layer& L, const float4* H4, F32Ring& ring, int lt,
                                               const float (&x)[2][4], Emit emit) {
  const int warp = lt >> 5, lane = lt & 31;
  const int r0 = 16 * warp + (lane >> 2);
  float acc[4];
  hopper::tf32_stream<kF32SumK, kF32Passes>(acc, H4, L.k / kF32KBlock, ring, lt, kF32LastImage);
  if ((lane & 3) == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v = acc[2 * h];
      if (L.wx != nullptr) {
        float w[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int r = 0; r < 4; ++r)
          if (r < L.d_in) w[r] = L.wx[r * L.n];
        v = __fadd_rn(v, hopper::coord_dot(x[h], w, L.d_in));
      }
      if (L.skip) v = __fmul_rn(v, kInvSqrt2);
      v = __fadd_rn(v, __ldg(L.bias));
      emit(r0 + 8 * h, L.beta > 0.f ? v : tanhf(v));
    }
  }
}

// The whole network over the CTA's 64 points, whose coordinates the entry
// has written to xs (4 per row, zeros past d_in) before the call;
// emit(row, value) takes each row's result.
template <int NQ, class Emit>
__device__ __forceinline__ void tf32_forward(const long long* __restrict__ desc, int n_lin, int d_in, float beta,
                                             const float* __restrict__ W, const float* __restrict__ B,
                                             const uint8_t* __restrict__ tiles, uint8_t* smem, Emit emit) {
  const int wg = threadIdx.x / kWgThreads, lt = threadIdx.x % kWgThreads;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + kF32OffBar);
  // ring r feeds consumer r; its producer is warp r of the producer warpgroup
  const int r = wg > 0 ? wg - 1 : (lt >> 5) & 1;
  auto ring_of = [&](int i, bool init) {
    return hopper::ring_init<F32Ring>(smem + kF32OffRing + size_t(i) * kF32Stages * kF32StageBytes,
                                      bars + 2 * kF32Stages * i, 1, init);
  };
  if (threadIdx.x == 0) {
    ring_of(0, true);
    ring_of(1, true);
  }
  F32Ring ring = ring_of(r, false);
  __syncthreads();  // barriers and coordinates ready

  if (wg == 0) {
    // producers: ring r gets consumer r's weight stages of every layer in
    // the order it multiplies by them (FusedNet.tf32_tiles: per layer the
    // chunks in order, so consumer r's NQ chunks are one run of stages)
    hopper::regs_decrease<kF32ProducerRegs>();
    if ((lt & 31) == 0 && lt < 64) {
      const uint8_t* src = tiles;
      for (int l = 0; l < n_lin; ++l) {
        const int k = static_cast<int>(desc[kDesc * l]);
        if (k == 0) continue;
        const int kbs = k / kF32KBlock;
        if (l == n_lin - 1) {
          if (r == 0) hopper::produce(ring, src, 2 * kF32LastImage, kbs);
        } else {
          hopper::produce(ring, src + size_t(r) * NQ * kbs * kF32StageBytes, kF32StageBytes, NQ * kbs);
          src += size_t(2) * NQ * kbs * kF32StageBytes;
        }
      }
    }
    return;
  }

  hopper::regs_increase<kF32ConsumerRegs>();
  const int c = wg - 1;
  const int r0 = 16 * (lt >> 5) + ((lt & 31) >> 2);
  float4* H4 = reinterpret_cast<float4*>(smem);
  const float* xs = reinterpret_cast<const float*>(smem + kF32OffX);
  float x[2][4];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < 4; ++i) x[h][i] = xs[(r0 + 8 * h) * 4 + i];

  const float rb = beta > 0.f ? __frcp_rn(beta) : 0.f;
  for (int l = 0; l < n_lin; ++l) {
    const F32Layer L = hopper::layer_args(desc, l, d_in, beta, rb, W, B);
    if (l == n_lin - 1) {
      if (c == 0) f32_last_layer(L, H4, ring, lt, x, emit);
    } else if (beta > 0.f) {
      f32_hidden_layer<NQ, true>(L, H4, ring, c, lt, x);
    } else {
      f32_hidden_layer<NQ, false>(L, H4, ring, c, lt, x);
    }
  }
}

template <int NQ>
__global__ void __launch_bounds__(kF32Threads, 1)
tf32_points_kernel(const float* __restrict__ x, long long n_pts, int d_in, const long long* __restrict__ desc,
                   int n_lin, float beta, const float* __restrict__ W, const float* __restrict__ B,
                   const uint8_t* __restrict__ tiles, float* __restrict__ out) {
  extern __shared__ uint8_t f32_smem_raw[];
  uint8_t* smem = hopper::aligned_smem(f32_smem_raw);
  float* xs = reinterpret_cast<float*>(smem + kF32OffX);
  const long long p0 = static_cast<long long>(blockIdx.x) * kTileP;
  for (int e = threadIdx.x; e < kTileP * 4; e += kF32Threads) {
    const int p = e >> 2, r = e & 3;
    float v = 0.f;
    if (r < d_in && p0 + p < n_pts) v = x[(p0 + p) * d_in + r];
    xs[e] = v;
  }
  tf32_forward<NQ>(desc, n_lin, d_in, beta, W, B, tiles, smem, [&](int row, float v) {
    if (p0 + row < n_pts) out[p0 + row] = v;
  });
}

// dense n^3 grid over linspace(-1, 1, n), flat = x*n^2 + y*n + z; CTA b
// is tile t = base_tile + b, the flat indices [64 t, 64 t + 64). out holds
// the launch's own tiles from base_tile on (a shard's slab: the TPU kernel
// 10, sharded_eval.py _local_sweep_pallas, takes its base from SMEM), so a
// whole-volume launch has base_tile 0. Points past n^3 are not written.
template <int NQ>
__global__ void __launch_bounds__(kF32Threads, 1)
tf32_grid_kernel(long long base_tile, int n, float step, const long long* __restrict__ desc, int n_lin, float beta,
                 const float* __restrict__ W, const float* __restrict__ B, const uint8_t* __restrict__ tiles,
                 float* __restrict__ out) {
  extern __shared__ uint8_t f32_smem_raw[];
  uint8_t* smem = hopper::aligned_smem(f32_smem_raw);
  float* xs = reinterpret_cast<float*>(smem + kF32OffX);
  const long long nn = static_cast<long long>(n) * n;
  const long long total = nn * n;
  const long long p0 = (base_tile + blockIdx.x) * kTileP;
  for (int e = threadIdx.x; e < kTileP * 4; e += kF32Threads) {
    const int p = e >> 2, r = e & 3;
    const long long flat = p0 + p;
    float v = 0.f;
    if (r < 3 && flat < total) {
      const long long i = r == 0 ? flat / nn : r == 1 ? (flat / n) % n : flat % n;
      v = grid_coord(i, step);
    }
    xs[e] = v;
  }
  tf32_forward<NQ>(desc, n_lin, 3, beta, W, B, tiles, smem, [&](int row, float v) {
    if (p0 + row < total) out[p0 + row - base_tile * kTileP] = v;
  });
}

// the block^3 points of each active block: CTA b is sub-tile b % tpb of
// block b / tpb, which is ids[b / tpb] (flat over the nb^3 blocks); blocks
// at or past *count exit at once
template <int NQ>
__global__ void __launch_bounds__(kF32Threads, 1)
tf32_blocks_kernel(const int* __restrict__ ids, const int* __restrict__ count, int nb, int block, float step,
                   const long long* __restrict__ desc, int n_lin, float beta, const float* __restrict__ W,
                   const float* __restrict__ B, const uint8_t* __restrict__ tiles, float* __restrict__ out) {
  const int pts = block * block * block;
  const int tpb = pts / kTileP;
  const int b = blockIdx.x / tpb;
  if (b >= *count) return;
  extern __shared__ uint8_t f32_smem_raw[];
  uint8_t* smem = hopper::aligned_smem(f32_smem_raw);
  float* xs = reinterpret_cast<float*>(smem + kF32OffX);
  const int sub = blockIdx.x % tpb;
  const int id = ids[b];
  const int bz = id % nb, by = (id / nb) % nb, bx = id / (nb * nb);
  for (int e = threadIdx.x; e < kTileP * 4; e += kF32Threads) {
    const int p = e >> 2, r = e & 3;
    const int local = sub * kTileP + p;
    float v = 0.f;
    if (r < 3) {
      const int i = r == 0 ? bx * block + local / (block * block)
                  : r == 1 ? by * block + (local / block) % block
                           : bz * block + local % block;
      v = grid_coord(i, step);
    }
    xs[e] = v;
  }
  tf32_forward<NQ>(desc, n_lin, 3, beta, W, B, tiles, smem, [&](int row, float v) {
    out[static_cast<long long>(b) * pts + sub * kTileP + row] = v;
  });
}

// =============================================================================
// bf16: the wgmma routine
// =============================================================================

constexpr int kCtaTiles = 2;                    // 64-point tiles per CTA, one per consumer warpgroup
constexpr int kCtaRows = kCtaTiles * kTileP;    // 128 points
constexpr int kWgmmaThreads = 3 * kWgThreads;   // producer + two consumers
constexpr int kPark = hopper::parked_chunks(kHMax / kChunkN);  // finished chunks parked per warpgroup
constexpr size_t kOffRing = size_t(kCtaTiles) * kHBytes;
constexpr size_t kOffX = kOffRing + size_t(kStages) * kStageBytes;
constexpr size_t kOffPark = kOffX + size_t(kCtaRows) * 4 * sizeof(float);
constexpr size_t kOffBar = kOffPark + size_t(kCtaTiles) * kPark * hopper::kParkBytes;
constexpr size_t kWgmmaSmem = kOffBar + 2 * kStages * sizeof(uint64_t) + 1024;  // + alignment slack
static_assert(kWgmmaSmem <= 232448, "shared memory of a block");

// Shared memory (from a 1024-byte aligned base):
//   H[2]     each consumer warpgroup's 64 x kHMax bf16 activations, as
//            kHMax/64 K blocks of 64 rows x 128 bytes in the 128-byte
//            swizzle (byte of (row, col) in act_offset)
//   ring     kStages weight stages of kChunkN rows x 64 K columns, the
//            same image, filled by bulk copies from FusedNet.tiles
//   xs       128 x 4 f32 coordinates (bf16 values)
//   park     per consumer the kPark finished chunks of a layer that wait in
//            shared memory rather than registers (hopper::chunked_layer)
//   full, empty  the ring's mbarriers

using hopper::activate_bf16;
using hopper::bf16_rne;
using hopper::column_pair;
using hopper::pack_bf16x2;

// chunk c of a hidden layer's outputs: scale, bias, activation, packed as
// bf16 pairs; sink(j, h, pair) takes column kChunkN c + 8 j + cq and row
// r0 + 8 h
template <bool kSoftplus, class Sink>
__device__ __forceinline__ void hidden_epilogue(const float (&acc)[kAcc], int c, int cq, const LayerArgs& L,
                                                const float (&x)[2][4], Sink sink) {
#pragma unroll
  for (int j = 0; j < kChunkN / 8; ++j) {
    float v[2][2] = {{acc[4 * j], acc[4 * j + 1]}, {acc[4 * j + 2], acc[4 * j + 3]}};
    column_pair(L, kChunkN * c + 8 * j + cq, x, v);
#pragma unroll
    for (int h = 0; h < 2; ++h)
      sink(j, h, pack_bf16x2(activate_bf16<kSoftplus>(v[h][0], L.beta, L.rb),
                             activate_bf16<kSoftplus>(v[h][1], L.beta, L.rb)));
  }
}

// One hidden layer (n = 128 NQ outputs) over a warpgroup's 64 rows.
template <int NQ, bool kSoftplus>
__device__ __forceinline__ void hidden_layer(const LayerArgs& L, uint8_t* H, Ring& ring, int wg, int lt,
                                             const float (&x)[2][4], uint32_t* park) {
  const int cq = 2 * (lt & 3);
  hopper::chunked_layer<NQ * 128 / kChunkN, kPark>(
      H, L.k / kKBlock, ring, 1 + wg, lt, [](int) {},
      [&](int c, const float (&acc)[kAcc], auto sink) { hidden_epilogue<kSoftplus>(acc, c, cq, L, x, sink); },
      park);
}

// The last layer: one output, column 0 of an m64n8k16 product; emit(row, v)
// for the warpgroup's rows.
template <class Emit>
__device__ __forceinline__ void last_layer(const LayerArgs& L, const uint8_t* H, Ring& ring, int lt,
                                           const float (&x)[2][4], Emit emit) {
  const int warp = lt >> 5, lane = lt & 31;
  const int r0 = 16 * warp + (lane >> 2);
  float acc[4];
  hopper::mma_stream(acc, H, L.k / kKBlock, ring, lt == 0);
  if ((lane & 3) == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v = acc[2 * h];
      if (L.wx != nullptr) {
        float w[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int r = 0; r < 4; ++r)
          if (r < L.d_in) w[r] = __bfloat162float(L.wx[r * L.n]);
        v = __fadd_rn(v, hopper::coord_dot(x[h], w, L.d_in));
      }
      if (L.skip) v = __fmul_rn(v, kInvSqrt2);
      v = __fadd_rn(v, __ldg(L.bias));
      emit(r0 + 8 * h, L.beta > 0.f ? v : tanhf(v));
    }
  }
}

// The whole network over the CTA's 128 points, whose coordinates the entry
// has written to xs (bf16 values, 4 per row, zeros past d_in) before the
// call; emit(row, value) takes each row's result (row < 128).
template <int NQ, class Emit>
__device__ __forceinline__ void wgmma_forward(const long long* __restrict__ desc, int n_lin, int d_in, float beta,
                                              const __nv_bfloat16* __restrict__ W, const float* __restrict__ B,
                                              const __nv_bfloat16* __restrict__ tiles, uint8_t* smem, Emit emit) {
  Ring ring = hopper::ring_init(smem + kOffRing, reinterpret_cast<uint64_t*>(smem + kOffBar),
                               kCtaTiles,  // one arrival per consumer warpgroup
                               threadIdx.x == 0);
  __syncthreads();  // barriers and coordinates ready

  const int wg = threadIdx.x / kWgThreads;
  if (wg == 0) {
    // producer: the weight stages of every layer, in the order the
    // consumers multiply by them (FusedNet.tiles is laid out in that order)
    hopper::regs_decrease<hopper::kProducerRegs>();
    if (threadIdx.x == 0) {
      const uint8_t* src = reinterpret_cast<const uint8_t*>(tiles);
      for (int l = 0; l < n_lin; ++l) {
        const int k = static_cast<int>(desc[kDesc * l]);
        if (k == 0) continue;
        const bool last = l == n_lin - 1;
        const uint32_t bytes = (last ? kLastRows : kChunkN) * kKBlock * 2;
        const int count = (last ? 1 : static_cast<int>(desc[kDesc * l + 1]) / kChunkN) * (k / kKBlock);
        src = hopper::produce(ring, src, bytes, count);
      }
    }
    return;
  }

  hopper::regs_increase<hopper::kConsumerRegs>();
  const int c = wg - 1;               // consumer 0 or 1: rows 64 c .. 64 c + 63
  const int lt = threadIdx.x - wg * kWgThreads;
  const int r0 = 16 * (lt >> 5) + ((lt & 31) >> 2);
  uint8_t* H = smem + c * kHBytes;
  uint32_t* park = reinterpret_cast<uint32_t*>(smem + kOffPark + c * kPark * hopper::kParkBytes);
  const float* xs = reinterpret_cast<const float*>(smem + kOffX) + kTileP * c * 4;
  float x[2][4];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int r = 0; r < 4; ++r) x[h][r] = xs[(r0 + 8 * h) * 4 + r];

  const float rb = beta > 0.f ? __frcp_rn(beta) : 0.f;
  for (int l = 0; l < n_lin; ++l) {
    const LayerArgs L = hopper::layer_args(desc, l, d_in, beta, rb, W, B);
    if (l == n_lin - 1) {
      last_layer(L, H, ring, lt, x, [&](int row, float v) { emit(kTileP * c + row, v); });
    } else if (beta > 0.f) {
      hidden_layer<NQ, true>(L, H, ring, c, lt, x, park);
    } else {
      hidden_layer<NQ, false>(L, H, ring, c, lt, x, park);
    }
  }
}

using hopper::aligned_smem;

template <int NQ>
__global__ void __launch_bounds__(kWgmmaThreads, 1)
wgmma_points_kernel(const float* __restrict__ x, long long n_pts, int d_in,
                    const long long* __restrict__ desc, int n_lin, float beta,
                    const __nv_bfloat16* __restrict__ W, const float* __restrict__ B,
                    const __nv_bfloat16* __restrict__ tiles, float* __restrict__ out) {
  extern __shared__ uint8_t wgmma_smem_raw[];
  uint8_t* smem = aligned_smem(wgmma_smem_raw);
  float* xs = reinterpret_cast<float*>(smem + kOffX);
  const long long p0 = static_cast<long long>(blockIdx.x) * kCtaRows;
  for (int e = threadIdx.x; e < kCtaRows * 4; e += kWgmmaThreads) {
    const int p = e >> 2, r = e & 3;
    float v = 0.f;
    if (r < d_in && p0 + p < n_pts) v = x[(p0 + p) * d_in + r];
    xs[e] = bf16_rne(v);
  }
  wgmma_forward<NQ>(desc, n_lin, d_in, beta, W, B, tiles, smem, [&](int row, float v) {
    if (p0 + row < n_pts) out[p0 + row] = v;
  });
}

// the grid entry over tiles [base_tile, base_tile + n_tiles); CTA b takes
// tiles base_tile + 2b and + 2b + 1 (out as for tf32_grid_kernel)
template <int NQ>
__global__ void __launch_bounds__(kWgmmaThreads, 1)
wgmma_grid_kernel(long long base_tile, long long n_tiles, int n, float step,
                  const long long* __restrict__ desc, int n_lin, float beta,
                  const __nv_bfloat16* __restrict__ W, const float* __restrict__ B,
                  const __nv_bfloat16* __restrict__ tiles, float* __restrict__ out) {
  extern __shared__ uint8_t wgmma_smem_raw[];
  uint8_t* smem = aligned_smem(wgmma_smem_raw);
  float* xs = reinterpret_cast<float*>(smem + kOffX);
  const long long nn = static_cast<long long>(n) * n;
  const long long total = nn * n;
  const long long local0 = static_cast<long long>(blockIdx.x) * kCtaRows;  // from base_tile * 64
  const long long live = n_tiles * kTileP;
  const long long flat0 = base_tile * kTileP + local0;
  for (int e = threadIdx.x; e < kCtaRows * 4; e += kWgmmaThreads) {
    const int p = e >> 2, r = e & 3;
    const long long flat = flat0 + p;
    float v = 0.f;
    if (r < 3 && local0 + p < live && flat < total) {
      const long long i = r == 0 ? flat / nn : r == 1 ? (flat / n) % n : flat % n;
      v = grid_coord(i, step);
    }
    xs[e] = bf16_rne(v);
  }
  wgmma_forward<NQ>(desc, n_lin, 3, beta, W, B, tiles, smem, [&](int row, float v) {
    if (local0 + row < live && flat0 + row < total) out[local0 + row] = v;
  });
}

// the blocks entry: tile t (of k_max * block^3 / 64) is sub-tile t % tpb of
// block t / tpb, which is ids[t / tpb]; blocks at or past *count are not
// evaluated, and a CTA whose tiles are all past it exits at once
template <int NQ>
__global__ void __launch_bounds__(kWgmmaThreads, 1)
wgmma_blocks_kernel(const int* __restrict__ ids, const int* __restrict__ count, int k_max, int nb, int block,
                    float step, const long long* __restrict__ desc, int n_lin, float beta,
                    const __nv_bfloat16* __restrict__ W, const float* __restrict__ B,
                    const __nv_bfloat16* __restrict__ tiles, float* __restrict__ out) {
  const int pts = block * block * block;
  const int tpb = pts / kTileP;
  const int live = min(*count, k_max);
  const int t0 = blockIdx.x * kCtaTiles;
  if (t0 / tpb >= live) return;
  extern __shared__ uint8_t wgmma_smem_raw[];
  uint8_t* smem = aligned_smem(wgmma_smem_raw);
  float* xs = reinterpret_cast<float*>(smem + kOffX);
  for (int e = threadIdx.x; e < kCtaRows * 4; e += kWgmmaThreads) {
    const int p = e >> 2, r = e & 3;
    const int t = t0 + p / kTileP, b = t / tpb;
    float v = 0.f;
    if (r < 3 && b < live) {
      const int id = ids[b];
      const int local = (t % tpb) * kTileP + p % kTileP;
      const int bz = id % nb, by = (id / nb) % nb, bx = id / (nb * nb);
      const int i = r == 0 ? bx * block + local / (block * block)
                  : r == 1 ? by * block + (local / block) % block
                           : bz * block + local % block;
      v = grid_coord(i, step);
    }
    xs[e] = bf16_rne(v);
  }
  wgmma_forward<NQ>(desc, n_lin, 3, beta, W, B, tiles, smem, [&](int row, float v) {
    const int t = t0 + row / kTileP, b = t / tpb;
    if (b < live) out[static_cast<long long>(b) * pts + (t % tpb) * kTileP + row % kTileP] = v;
  });
}

// ---- launches ------------------------------------------------------------------

template <class F>
cudaError_t by_width(int width, F f) {
  switch (width) {
    case 128: return f(std::integral_constant<int, 1>{});
    case 256: return f(std::integral_constant<int, 2>{});
    case 384: return f(std::integral_constant<int, 3>{});
    case 512: return f(std::integral_constant<int, 4>{});
    default: return cudaErrorInvalidValue;
  }
}

template <typename K, typename... Args>
cudaError_t launch(K kernel, long long ctas, int threads, size_t smem, cudaStream_t stream, Args... args) {
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  if (ctas == 0) return cudaSuccess;
  kernel<<<static_cast<unsigned>(ctas), threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

long long wgmma_ctas(long long tiles) { return (tiles + kCtaTiles - 1) / kCtaTiles; }

}  // namespace

// ---- C interface (ctypes); each returns the cudaError_t of its launch --------
// w and b are FusedNet.packed's buffers, width the padded hidden width (128,
// 256, 384 or 512); tiles is FusedNet.tiles (bf16) or FusedNet.tf32_tiles
// (f32).

extern "C" {

int sdf_mlp_tile_points() { return kTileP; }
int sdf_mlp_max_width() { return kHMax; }
int sdf_mlp_f32_k_block() { return kF32KBlock; }
const char* sdf_mlp_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

int sdf_mlp_points(const float* x, long long n_pts, int d_in, const long long* desc, int n_lin, float beta,
                   int bf16, const void* w, const float* b, const void* tiles, int width, float* out,
                   void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const long long n_tiles = (n_pts + kTileP - 1) / kTileP;
  if (!bf16)
    return by_width(width, [&](auto q) {
      return launch(tf32_points_kernel<decltype(q)::value>, n_tiles, kF32Threads, kF32Smem, s, x, n_pts, d_in,
                    desc, n_lin, beta, static_cast<const float*>(w), b, static_cast<const uint8_t*>(tiles), out);
    });
  auto wb = static_cast<const __nv_bfloat16*>(w);
  auto tb = static_cast<const __nv_bfloat16*>(tiles);
  return by_width(width, [&](auto q) {
    return launch(wgmma_points_kernel<decltype(q)::value>, wgmma_ctas(n_tiles), kWgmmaThreads, kWgmmaSmem, s,
                  x, n_pts, d_in, desc, n_lin, beta, wb, b, tb, out);
  });
}

int sdf_mlp_grid(long long base_tile, long long n_tiles, int n, float step, const long long* desc, int n_lin,
                 float beta, int bf16, const void* w, const float* b, const void* tiles, int width, float* out,
                 void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (!bf16)
    return by_width(width, [&](auto q) {
      return launch(tf32_grid_kernel<decltype(q)::value>, n_tiles, kF32Threads, kF32Smem, s, base_tile, n, step,
                    desc, n_lin, beta, static_cast<const float*>(w), b, static_cast<const uint8_t*>(tiles), out);
    });
  auto wb = static_cast<const __nv_bfloat16*>(w);
  auto tb = static_cast<const __nv_bfloat16*>(tiles);
  return by_width(width, [&](auto q) {
    return launch(wgmma_grid_kernel<decltype(q)::value>, wgmma_ctas(n_tiles), kWgmmaThreads, kWgmmaSmem, s,
                  base_tile, n_tiles, n, step, desc, n_lin, beta, wb, b, tb, out);
  });
}

int sdf_mlp_blocks(const int* ids, const int* count, int k_max, int nb, int block, float step,
                   const long long* desc, int n_lin, float beta, int bf16, const void* w, const float* b,
                   const void* tiles, int width, float* out, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const long long n_tiles = static_cast<long long>(k_max) * (block * block * block / kTileP);
  if (!bf16)
    return by_width(width, [&](auto q) {
      return launch(tf32_blocks_kernel<decltype(q)::value>, n_tiles, kF32Threads, kF32Smem, s, ids, count, nb,
                    block, step, desc, n_lin, beta, static_cast<const float*>(w), b,
                    static_cast<const uint8_t*>(tiles), out);
    });
  auto wb = static_cast<const __nv_bfloat16*>(w);
  auto tb = static_cast<const __nv_bfloat16*>(tiles);
  return by_width(width, [&](auto q) {
    return launch(wgmma_blocks_kernel<decltype(q)::value>, wgmma_ctas(n_tiles), kWgmmaThreads, kWgmmaSmem, s,
                  ids, count, k_max, nb, block, step, desc, n_lin, beta, wb, b, tb, out);
  });
}

}  // extern "C"
