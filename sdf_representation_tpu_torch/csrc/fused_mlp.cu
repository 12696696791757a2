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
// __device__ routine runs the whole network. The C interface counts in
// tiles of 64 points.
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
// neither the tensor cores nor L2 but by latency on the consumers' side:
// each 32-deep sum is waited for before it is added, and the epilogue's
// dependent chains run on two warps per scheduler; without the epilogue's
// arithmetic the sweep takes about half the time.
// Activations stay in shared memory as bf16 in the same swizzled K-major
// image, so they are the A operand as they stand. The coordinate rows (W_0,
// and W_bot of the skip layer; d_in <= 4) are added in the epilogue with
// d_in FMAs per output; the skip layer's scale and bias come after both
// sums. The last layer (one output) is an m64n8k16 product.
//
// f32: the SIMT routine (simt_tile_forward), a design choice for this
// type, not a fallback: a TF32 tensor-core pass would not hold the f32
// results to 2e-5 of the plain version. Activations never leave shared
// memory (64 points x 512 f32 = 128 KB, updated in place: a layer's outputs
// are held in registers until every warp has read its inputs); weights are
// streamed per layer in 16-row stages through a cp.async double buffer;
// each thread accumulates an 8-point x (4*NQ)-output register tile with f32
// FMA. It is bound by the FP32 pipes (67 TFLOP/s).
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

constexpr int kTileP = 64;     // points per tile (the C interface's unit)
constexpr int kHMax = 512;     // widest padded layer a tile holds
constexpr int kDesc = 6;       // int64 fields per layer descriptor
constexpr float kInvSqrt2 = 0.70710678118654752440f;

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
// f32: the SIMT routine
// =============================================================================

constexpr int kSimtThreads = 256;  // 8 warps; warp w owns points 8w .. 8w+7
constexpr int kPts = 8;            // points per thread
constexpr int kKT = 16;            // weight rows per shared-memory stage

__host__ __device__ constexpr size_t simt_smem_floats() {
  return size_t(kTileP) * kHMax + kTileP * 4 + kTileP;  // H, coords, results
}
constexpr size_t kSimtSmem = simt_smem_floats() * sizeof(float) + 2 * size_t(kKT) * kHMax * sizeof(float);

__device__ __forceinline__ void load4(const float* p, float* w) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// One linear layer (+ activation) over the tile. NQ = n / 128: each lane
// owns outputs 128*q + 4*lane + c (q < NQ, c < 4), so a warp's shared-memory
// reads and writes of a row are contiguous.
template <int NQ>
__device__ __forceinline__ void simt_layer_forward(
    const long long* __restrict__ d, int d_in, float beta, bool last,
    const float* __restrict__ W, const float* __restrict__ B,
    float* H, const float* xs, float* res, float* Ws) {
  const int k = static_cast<int>(d[0]);
  const int n = static_cast<int>(d[1]);
  const bool skip = d[2] != 0;
  const long long b_off = d[3], w_off = d[4], wx_off = d[5];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  float acc[kPts][4 * NQ];
#pragma unroll
  for (int i = 0; i < kPts; ++i)
#pragma unroll
    for (int j = 0; j < 4 * NQ; ++j) acc[i][j] = 0.f;

  // coordinate rows: W_0 (first layer) or W_bot (skip layer)
  if (wx_off >= 0) {
    for (int r = 0; r < d_in; ++r) {
      float w[4 * NQ];
      const float* row = W + wx_off + static_cast<long long>(r) * n + 4 * lane;
#pragma unroll
      for (int q = 0; q < NQ; ++q) load4(row + 128 * q, &w[4 * q]);
#pragma unroll
      for (int i = 0; i < kPts; ++i) {
        const float a = xs[(warp * kPts + i) * 4 + r];
#pragma unroll
        for (int j = 0; j < 4 * NQ; ++j) acc[i][j] = fmaf(a, w[j], acc[i][j]);
      }
    }
  }

  // hidden rows, kKT at a time through the shared-memory double buffer
  if (k > 0) {
    const int nk = k / kKT;
    const int stage_bytes = kKT * n * static_cast<int>(sizeof(float));
    const char* src = reinterpret_cast<const char*>(W + w_off);
    auto stage = [&](int t) {
      char* dst = reinterpret_cast<char*>(Ws + (t & 1) * kKT * kHMax);
      const char* s = src + static_cast<long long>(t) * stage_bytes;
      for (int off = tid * 16; off < stage_bytes; off += kSimtThreads * 16) cp_async16(dst + off, s + off);
      cp_async_commit();
    };
    stage(0);
    for (int t = 0; t < nk; ++t) {
      if (t + 1 < nk) {
        stage(t + 1);  // its buffer was last read in step t-1, before the barrier
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const float* ws = Ws + (t & 1) * kKT * kHMax + 4 * lane;
      const float* hrow = H + (warp * kPts) * kHMax + t * kKT;
#pragma unroll
      for (int kk = 0; kk < kKT; kk += 4) {
        float4 a4[kPts];
#pragma unroll
        for (int i = 0; i < kPts; ++i) a4[i] = *reinterpret_cast<const float4*>(hrow + i * kHMax + kk);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          float w[4 * NQ];
#pragma unroll
          for (int q = 0; q < NQ; ++q) load4(ws + (kk + u) * n + 128 * q, &w[4 * q]);
#pragma unroll
          for (int i = 0; i < kPts; ++i) {
            const float a = u == 0 ? a4[i].x : u == 1 ? a4[i].y : u == 2 ? a4[i].z : a4[i].w;
#pragma unroll
            for (int j = 0; j < 4 * NQ; ++j) acc[i][j] = fmaf(a, w[j], acc[i][j]);
          }
        }
      }
      __syncthreads();  // every warp is done with H and with this buffer
    }
  }

  // epilogue: scale, bias, activation; H is overwritten in place
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    const int o = 128 * q + 4 * lane;
    const float4 bias = *reinterpret_cast<const float4*>(B + b_off + o);
    const float bv[4] = {bias.x, bias.y, bias.z, bias.w};
#pragma unroll
    for (int i = 0; i < kPts; ++i) {
      const int p = warp * kPts + i;
      float v[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float s = acc[i][4 * q + c];
        if (skip) s = __fmul_rn(s, kInvSqrt2);
        v[c] = __fadd_rn(s, bv[c]);
      }
      if (last) {
        if (q == 0 && lane == 0) res[p] = beta > 0.f ? v[0] : tanhf(v[0]);
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (beta > 0.f) {
            const float t = __fmul_rn(beta, v[c]);
            v[c] = __fdiv_rn(__fadd_rn(fmaxf(t, 0.f), log1pf(expf(-fabsf(t)))), beta);
          } else {
            v[c] = fmaxf(v[c], 0.f);
          }
        }
        *reinterpret_cast<float4*>(H + p * kHMax + o) = make_float4(v[0], v[1], v[2], v[3]);
      }
    }
  }
  __syncthreads();
}

// The whole network over the tile whose coordinates are in xs (64 x 4);
// leaves the 64 results in res.
__device__ void simt_tile_forward(const long long* __restrict__ desc, int n_lin, int d_in, float beta,
                                  const float* __restrict__ W, const float* __restrict__ B, float* smem) {
  float* H = smem;
  float* xs = H + kTileP * kHMax;
  float* res = xs + kTileP * 4;
  float* Ws = smem + simt_smem_floats();
  for (int l = 0; l < n_lin; ++l) {
    const long long* d = desc + kDesc * l;
    const bool last = l == n_lin - 1;
    switch (static_cast<int>(d[1]) / 128) {
      case 1: simt_layer_forward<1>(d, d_in, beta, last, W, B, H, xs, res, Ws); break;
      case 2: simt_layer_forward<2>(d, d_in, beta, last, W, B, H, xs, res, Ws); break;
      case 3: simt_layer_forward<3>(d, d_in, beta, last, W, B, H, xs, res, Ws); break;
      default: simt_layer_forward<4>(d, d_in, beta, last, W, B, H, xs, res, Ws); break;
    }
  }
}

__global__ void __launch_bounds__(kSimtThreads, 1)
simt_points_kernel(const float* __restrict__ x, long long n_pts, int d_in,
                   const long long* __restrict__ desc, int n_lin, float beta,
                   const float* __restrict__ W, const float* __restrict__ B, float* __restrict__ out) {
  extern __shared__ float4 simt_smem4[];
  float* smem = reinterpret_cast<float*>(simt_smem4);
  float* xs = smem + kTileP * kHMax;
  float* res = xs + kTileP * 4;
  const long long p0 = static_cast<long long>(blockIdx.x) * kTileP;
  for (int e = threadIdx.x; e < kTileP * 4; e += kSimtThreads) {
    const int p = e >> 2, r = e & 3;
    float v = 0.f;
    if (r < d_in && p0 + p < n_pts) v = x[(p0 + p) * d_in + r];
    xs[e] = v;
  }
  __syncthreads();
  simt_tile_forward(desc, n_lin, d_in, beta, W, B, smem);
  const long long p = p0 + threadIdx.x;
  if (threadIdx.x < kTileP && p < n_pts) out[p] = res[threadIdx.x];
}

// dense n^3 grid over linspace(-1, 1, n), flat = x*n^2 + y*n + z; block b
// is tile t = base_tile + b, the flat indices [64 t, 64 t + 64). out holds
// the launch's own tiles from base_tile on (a shard's slab: the TPU kernel
// 10, sharded_eval.py _local_sweep_pallas, takes its base from SMEM), so a
// whole-volume launch has base_tile 0. Points past n^3 are not written.
__global__ void __launch_bounds__(kSimtThreads, 1)
simt_grid_kernel(long long base_tile, int n, float step,
                 const long long* __restrict__ desc, int n_lin, float beta,
                 const float* __restrict__ W, const float* __restrict__ B, float* __restrict__ out) {
  extern __shared__ float4 simt_smem4[];
  float* smem = reinterpret_cast<float*>(simt_smem4);
  float* xs = smem + kTileP * kHMax;
  float* res = xs + kTileP * 4;
  const long long nn = static_cast<long long>(n) * n;
  const long long total = nn * n;
  const long long p0 = (base_tile + blockIdx.x) * kTileP;
  for (int e = threadIdx.x; e < kTileP * 4; e += kSimtThreads) {
    const int p = e >> 2, r = e & 3;
    const long long flat = p0 + p;
    float v = 0.f;
    if (r < 3 && flat < total) {
      const long long i = r == 0 ? flat / nn : r == 1 ? (flat / n) % n : flat % n;
      v = grid_coord(i, step);
    }
    xs[e] = v;
  }
  __syncthreads();
  simt_tile_forward(desc, n_lin, 3, beta, W, B, smem);
  const long long flat = p0 + threadIdx.x;
  if (threadIdx.x < kTileP && flat < total) out[flat - base_tile * kTileP] = res[threadIdx.x];
}

// the block^3 points of each active block: block b = blockIdx.x / tiles is
// ids[b] (flat over the nb^3 blocks); blocks at or past *count exit at once
__global__ void __launch_bounds__(kSimtThreads, 1)
simt_blocks_kernel(const int* __restrict__ ids, const int* __restrict__ count, int nb, int block, float step,
                   const long long* __restrict__ desc, int n_lin, float beta,
                   const float* __restrict__ W, const float* __restrict__ B, float* __restrict__ out) {
  extern __shared__ float4 simt_smem4[];
  const int pts = block * block * block;
  const int tiles = pts / kTileP;
  const int b = blockIdx.x / tiles;
  if (b >= *count) return;
  float* smem = reinterpret_cast<float*>(simt_smem4);
  float* xs = smem + kTileP * kHMax;
  float* res = xs + kTileP * 4;
  const int sub = blockIdx.x % tiles;
  const int id = ids[b];
  const int bz = id % nb, by = (id / nb) % nb, bx = id / (nb * nb);
  for (int e = threadIdx.x; e < kTileP * 4; e += kSimtThreads) {
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
  __syncthreads();
  simt_tile_forward(desc, n_lin, 3, beta, W, B, smem);
  if (threadIdx.x < kTileP) out[static_cast<long long>(b) * pts + sub * kTileP + threadIdx.x] = res[threadIdx.x];
}

// =============================================================================
// bf16: the wgmma routine
// =============================================================================

constexpr int kCtaTiles = 2;                    // 64-point tiles per CTA, one per consumer warpgroup
constexpr int kCtaRows = kCtaTiles * kTileP;    // 128 points
constexpr int kWgThreads = 128;                 // a warpgroup
constexpr int kWgmmaThreads = 3 * kWgThreads;   // producer + two consumers
constexpr int kProducerRegs = 24;               // setmaxnreg: 128 x 24 + 256 x 240 <= 65,536
constexpr int kConsumerRegs = 240;
constexpr int kStages = 5;                      // weight stages in flight
constexpr int kChunkN = 64;                     // output columns per product (m64n64k16)
constexpr int kKBlock = 64;                     // K per stage: one 128-byte swizzled row
constexpr int kSumK = 32;                       // K per tensor-core sum; the sums are added in f32
constexpr int kLastRows = 8;                    // columns of the last layer's product (m64n8k16)
constexpr int kBlockBytes = kTileP * kKBlock * 2;          // one 64-row K block of activations: 8 KB
constexpr int kStageBytes = kChunkN * kKBlock * 2;         // 8 KB
constexpr int kHBytes = (kHMax / kKBlock) * kBlockBytes;   // a warpgroup's activations: 64 KB
constexpr size_t kOffRing = size_t(kCtaTiles) * kHBytes;
constexpr size_t kOffX = kOffRing + size_t(kStages) * kStageBytes;
constexpr size_t kOffBar = kOffX + size_t(kCtaRows) * 4 * sizeof(float);
constexpr size_t kWgmmaSmem = kOffBar + 2 * kStages * sizeof(uint64_t) + 1024;  // + alignment slack

// Shared memory (from a 1024-byte aligned base):
//   H[2]     each consumer warpgroup's 64 x kHMax bf16 activations, as
//            kHMax/64 K blocks of 64 rows x 128 bytes in the 128-byte
//            swizzle (byte of (row, col) in act_offset)
//   ring     kStages weight stages of kChunkN rows x 64 K columns, the
//            same image, filled by bulk copies from FusedNet.tiles
//   xs       128 x 4 f32 coordinates (bf16 values)
//   full, empty  the ring's mbarriers

__device__ __forceinline__ int act_offset(int row, int col) {
  return (col >> 6) * kBlockBytes + row * 128 + ((((col & 63) >> 3) ^ (row & 7)) << 4) + ((col & 7) << 1);
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

// The activation of a bf16-rounded pre-activation, rounded to bf16, with
// no branch (a chunk's elements interleave). Softplus in the cheaper form
// (max(t,0) + ln2 lg2(1 + ex2(-|t| log2 e))) * RN(1/beta) on the hardware's
// approximate ex2/lg2: its f32 result is within ~2e-7 absolute of the
// exact form's, against bf16 steps of 2^-8 relative. Against exact sums
// the exact form (expf, log1pf, division by beta) reads the same max and
// a mean 0.4% lower, and takes 1.84x the time (PERF.md).
template <bool kSoftplus>
__device__ __forceinline__ float activate_bf16(float v, float beta, float rb) {
  v = bf16_rne(v);
  if constexpr (kSoftplus) {
    const float t = __fmul_rn(beta, v);
    const float e = ex2_ftz(__fmul_rn(-fabsf(t), 1.44269504088896341f));
    const float s = __fadd_rn(fmaxf(t, 0.f), __fmul_rn(lg2_ftz(__fadd_rn(1.f, e)), 0.69314718055994531f));
    v = __fmul_rn(s, rb);
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

template <int N>
__device__ __forceinline__ void wgmma_tile(float (&acc)[N], uint64_t da, uint64_t db, int scale_d) {
  if constexpr (N == 32) {
    hopper::wgmma_m64n64k16(acc, da, db, scale_d);
  } else {
    hopper::wgmma_m64n8k16(acc, da, db, scale_d);
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
    hopper::mbar_wait(&ring.full[ring.s], ring.phase);
    const uint8_t* a = H + kb * kBlockBytes;
    const uint8_t* b = ring.stages + ring.s * kStageBytes;
#pragma unroll
    for (int g = 0; g < kKBlock / kSumK; ++g) {
      float part[N];
      hopper::wgmma_fence();
#pragma unroll
      for (int u = 0; u < kSumK / 16; ++u) {
        const int off = 2 * (g * kSumK + 16 * u);  // bytes along the 128-byte row
        wgmma_tile(part, hopper::desc_k_sw128(a + off), hopper::desc_k_sw128(b + off), u > 0);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_registers(part);
#pragma unroll
      for (int i = 0; i < N; ++i) acc[i] = __fadd_rn(acc[i], part[i]);
    }
    if (signal) hopper::mbar_arrive(&ring.empty[ring.s]);
    ring.advance();
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

struct LayerArgs {
  int k, n, d_in;
  bool skip;
  float beta, rb;               // beta and RN(1 / beta)
  const float* bias;            // this layer's biases
  const __nv_bfloat16* wx;      // coordinate rows (d_in x n), or null
};

// bias, coordinate term and scale of output columns col and col + 1 for
// the thread's rows r0 (h = 0) and r0 + 8 (h = 1), applied to their sums
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
    v[h][0] = __fadd_rn(a, bias.x);
    v[h][1] = __fadd_rn(b, bias.y);
  }
}

constexpr int kAcc = kChunkN / 2;  // accumulator registers of a chunk's product

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
                                             const float (&x)[2][4]) {
  constexpr int kChunks = NQ * 128 / kChunkN;
  const int warp = lt >> 5, lane = lt & 31;
  const int r0 = 16 * warp + (lane >> 2), cq = 2 * (lane & 3);
  const int kbs = L.k / kKBlock;
  uint32_t held[kChunks - 1][kChunkN / 4];  // finished chunks, packed bf16
  auto store = [&](int c, int j, int h, uint32_t pair) {
    *reinterpret_cast<uint32_t*>(H + act_offset(r0 + 8 * h, kChunkN * c + 8 * j + cq)) = pair;
  };
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    float acc[kAcc];
    mma_stream(acc, H, kbs, ring, lt == 0);
    if (c < kChunks - 1) {
      hidden_epilogue<kSoftplus>(acc, c, cq, L, x, [&](int j, int h, uint32_t pair) { held[c][2 * j + h] = pair; });
    } else {
      // every product of this layer has read H: overwrite it
      hopper::named_barrier(1 + wg, kWgThreads);
#pragma unroll
      for (int cc = 0; cc < kChunks - 1; ++cc)
#pragma unroll
        for (int i = 0; i < kChunkN / 4; ++i) store(cc, i >> 1, i & 1, held[cc][i]);
      hidden_epilogue<kSoftplus>(acc, c, cq, L, x, [&](int j, int h, uint32_t pair) { store(c, j, h, pair); });
      hopper::fence_proxy_async();  // the next layer's wgmma reads what was just written
      hopper::named_barrier(1 + wg, kWgThreads);
    }
  }
}

// The last layer: one output, column 0 of an m64n8k16 product; emit(row, v)
// for the warpgroup's rows.
template <class Emit>
__device__ __forceinline__ void last_layer(const LayerArgs& L, const uint8_t* H, Ring& ring, int lt,
                                           const float (&x)[2][4], Emit emit) {
  const int warp = lt >> 5, lane = lt & 31;
  const int r0 = 16 * warp + (lane >> 2);
  float acc[4];
  mma_stream(acc, H, L.k / kKBlock, ring, lt == 0);
  if ((lane & 3) == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v = acc[2 * h];
      if (L.wx != nullptr) {
        float w[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int r = 0; r < 4; ++r)
          if (r < L.d_in) w[r] = __bfloat162float(L.wx[r * L.n]);
        v = __fadd_rn(v, coord_dot(x[h], w, L.d_in));
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
  Ring ring;
  ring.stages = smem + kOffRing;
  ring.full = reinterpret_cast<uint64_t*>(smem + kOffBar);
  ring.empty = ring.full + kStages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&ring.full[s], 1);
      hopper::mbar_init(&ring.empty[s], kCtaTiles);  // one arrival per consumer warpgroup
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();  // barriers and coordinates ready

  const int wg = threadIdx.x / kWgThreads;
  if (wg == 0) {
    // producer: the weight stages of every layer, in the order the
    // consumers multiply by them (FusedNet.tiles is laid out in that order)
    hopper::regs_decrease<kProducerRegs>();
    if (threadIdx.x == 0) {
      const uint8_t* src = reinterpret_cast<const uint8_t*>(tiles);
      for (int l = 0; l < n_lin; ++l) {
        const int k = static_cast<int>(desc[kDesc * l]);
        if (k == 0) continue;
        const bool last = l == n_lin - 1;
        const uint32_t bytes = (last ? kLastRows : kChunkN) * kKBlock * 2;
        const int count = (last ? 1 : static_cast<int>(desc[kDesc * l + 1]) / kChunkN) * (k / kKBlock);
        for (int t = 0; t < count; ++t) {
          hopper::mbar_wait(&ring.empty[ring.s], ring.phase ^ 1);
          hopper::mbar_arrive_expect_tx(&ring.full[ring.s], bytes);
          hopper::bulk_load(ring.stages + ring.s * kStageBytes, src, bytes, &ring.full[ring.s]);
          src += bytes;
          ring.advance();
        }
      }
    }
    return;
  }

  hopper::regs_increase<kConsumerRegs>();
  const int c = wg - 1;               // consumer 0 or 1: rows 64 c .. 64 c + 63
  const int lt = threadIdx.x - wg * kWgThreads;
  const int r0 = 16 * (lt >> 5) + ((lt & 31) >> 2);
  uint8_t* H = smem + c * kHBytes;
  const float* xs = reinterpret_cast<const float*>(smem + kOffX) + kTileP * c * 4;
  float x[2][4];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int r = 0; r < 4; ++r) x[h][r] = xs[(r0 + 8 * h) * 4 + r];

  const float rb = beta > 0.f ? __frcp_rn(beta) : 0.f;
  for (int l = 0; l < n_lin; ++l) {
    const long long* d = desc + kDesc * l;
    LayerArgs L;
    L.k = static_cast<int>(d[0]);
    L.n = static_cast<int>(d[1]);
    L.d_in = d_in;
    L.skip = d[2] != 0;
    L.beta = beta;
    L.rb = rb;
    L.bias = B + d[3];
    L.wx = d[5] >= 0 ? W + d[5] : nullptr;
    if (l == n_lin - 1) {
      last_layer(L, H, ring, lt, x, [&](int row, float v) { emit(kTileP * c + row, v); });
    } else if (beta > 0.f) {
      hidden_layer<NQ, true>(L, H, ring, c, lt, x);
    } else {
      hidden_layer<NQ, false>(L, H, ring, c, lt, x);
    }
  }
}

__device__ __forceinline__ uint8_t* aligned_smem(uint8_t* raw) {
  return raw + ((1024 - (hopper::smem_u32(raw) & 1023)) & 1023);
}

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
// tiles base_tile + 2b and + 2b + 1 (out as for simt_grid_kernel)
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
// bf16: w and b are FusedNet.packed's buffers, tiles FusedNet.tiles, width
// the padded hidden width (128, 256, 384 or 512). f32: tiles is unused.

extern "C" {

int sdf_mlp_tile_points() { return kTileP; }
int sdf_mlp_max_width() { return kHMax; }
const char* sdf_mlp_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

int sdf_mlp_points(const float* x, long long n_pts, int d_in, const long long* desc, int n_lin, float beta,
                   int bf16, const void* w, const float* b, const void* tiles, int width, float* out,
                   void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const long long n_tiles = (n_pts + kTileP - 1) / kTileP;
  if (!bf16)
    return launch(simt_points_kernel, n_tiles, kSimtThreads, kSimtSmem, s, x, n_pts, d_in, desc, n_lin, beta,
                  static_cast<const float*>(w), b, out);
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
    return launch(simt_grid_kernel, n_tiles, kSimtThreads, kSimtSmem, s, base_tile, n, step, desc, n_lin, beta,
                  static_cast<const float*>(w), b, out);
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
    return launch(simt_blocks_kernel, n_tiles, kSimtThreads, kSimtSmem, s, ids, count, nb, block, step, desc,
                  n_lin, beta, static_cast<const float*>(w), b, out);
  auto wb = static_cast<const __nv_bfloat16*>(w);
  auto tb = static_cast<const __nv_bfloat16*>(tiles);
  return by_width(width, [&](auto q) {
    return launch(wgmma_blocks_kernel<decltype(q)::value>, wgmma_ctas(n_tiles), kWgmmaThreads, kWgmmaSmem, s,
                  ids, count, k_max, nb, block, step, desc, n_lin, beta, wb, b, tb, out);
  });
}

}  // extern "C"
