// Fused ImplicitNet forward for Hopper (sm_90a), with a plain C interface
// for ctypes (sdf_representation_tpu_torch/ops/fused_mlp.py binds it).
//
// Replaces three TPU kernels of the JAX package, which share one body
// (ops/pallas_mlp.py _make_body):
//   * points mode     ops/pallas_mlp.py _make_kernel, pallas_call in _fused_apply_padded
//   * dense grid mode ops/pallas_mlp.py _make_kernel, pallas_call in _fused_grid_slab
//   * sparse blocks   ops/sparse_grid.py _make_block_kernel, pallas_call in refine_blocks
// Here too one __device__ routine (tile_forward) runs the whole network over
// a tile of 64 points, and three __global__ entries differ only in where the
// tile's coordinates come from and where its 64 results go.
//
// What bounds it: operations. At 8x512 a point costs ~1.84 M multiply-adds
// against 12-16 bytes of input and output, and the weights (4 MB bf16,
// 8 MB f32) stay in the 50 MB L2. Design: activations never leave shared
// memory (64 points x 512 f32 = 128 KB, updated in place: a layer's outputs
// are held in registers until every warp has read its inputs); weights are
// streamed per layer in 16-row stages through a cp.async double buffer; each
// thread accumulates an 8-point x (4*NQ)-output register tile with f32 FMA.
// Tensor cores (wgmma) and TMA are not used yet.
//
// Numerics kept from the JAX kernel:
//   * f32 mode: everything f32.
//   * bf16 mode: the input coordinates, each layer's f32 accumulator (before
//     the activation) and the activation's output are rounded to bf16;
//     weights are bf16, biases f32, the last layer's result stays f32.
//   * skip layer: (h W_top + x W_bot) * (1/sqrt 2) + b.
//   * softplus(beta*v)/beta = (max(t,0) + log1p(exp(-|t|)))/beta, t = beta*v.
// A point's result does not depend on its tile or entry: every point runs
// the same instruction sequence, and grid coordinates are computed by one
// routine with explicit round-to-nearest intrinsics (-1 + step*i, no FMA
// contraction), so the sparse entry matches the dense one bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int kTileP = 64;     // points per block
constexpr int kThreads = 256;  // 8 warps; warp w owns points 8w .. 8w+7
constexpr int kPts = 8;        // points per thread
constexpr int kKT = 16;        // weight rows per shared-memory stage
constexpr int kHMax = 512;     // widest padded layer the tile holds
constexpr int kDesc = 6;       // int64 fields per layer descriptor
constexpr float kInvSqrt2 = 0.70710678118654752440f;

// layer descriptor (int64 x kDesc, device memory), see FusedNet.pack():
//   [0] k     rows of the hidden-input matrix (0 for the first layer)
//   [1] n     padded output width, a multiple of 128, <= kHMax
//   [2] skip  1: scale (h W_top + x W_bot) by 1/sqrt(2) before the bias
//   [3] b     element offset of the bias in the f32 bias buffer
//   [4] w     element offset of the hidden-input matrix (k x n, row-major)
//   [5] wx    element offset of the coordinate-input matrix (d_in x n), -1 if none

__host__ __device__ constexpr size_t smem_floats() {
  return size_t(kTileP) * kHMax + kTileP * 4 + kTileP;  // H, coords, results
}
template <typename WT>
__host__ __device__ constexpr size_t smem_bytes() {
  return smem_floats() * sizeof(float) + 2 * size_t(kKT) * kHMax * sizeof(WT);
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// the one place grid coordinates are made: -1 + step * i, rounded as f32
__device__ __forceinline__ float grid_coord(long long i, float step) {
  return __fadd_rn(-1.0f, __fmul_rn(step, static_cast<float>(i)));
}

template <typename WT>
__device__ __forceinline__ void load4(const WT* p, float* w);
template <>
__device__ __forceinline__ void load4<float>(const float* p, float* w) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
}
template <>
__device__ __forceinline__ void load4<__nv_bfloat16>(const __nv_bfloat16* p, float* w) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  w[0] = __uint_as_float(v.x << 16);
  w[1] = __uint_as_float(v.x & 0xffff0000u);
  w[2] = __uint_as_float(v.y << 16);
  w[3] = __uint_as_float(v.y & 0xffff0000u);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

template <bool BF16>
__device__ __forceinline__ float activate(float v, float beta) {
  if (BF16) v = bf16_round(v);
  if (beta > 0.f) {
    const float t = __fmul_rn(beta, v);
    v = __fdiv_rn(__fadd_rn(fmaxf(t, 0.f), log1pf(expf(-fabsf(t)))), beta);
  } else {
    v = fmaxf(v, 0.f);
  }
  if (BF16) v = bf16_round(v);
  return v;
}

// One linear layer (+ activation) over the tile. NQ = n / 128: each lane
// owns outputs 128*q + 4*lane + c (q < NQ, c < 4), so a warp's shared-memory
// reads and writes of a row are contiguous.
template <typename WT, int NQ>
__device__ __forceinline__ void layer_forward(
    const long long* __restrict__ d, int d_in, float beta, bool last,
    const WT* __restrict__ W, const float* __restrict__ B,
    float* H, const float* xs, float* res, WT* Ws) {
  constexpr bool kBF16 = std::is_same<WT, __nv_bfloat16>::value;
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
      const WT* row = W + wx_off + static_cast<long long>(r) * n + 4 * lane;
#pragma unroll
      for (int q = 0; q < NQ; ++q) load4<WT>(row + 128 * q, &w[4 * q]);
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
    const int stage_bytes = kKT * n * static_cast<int>(sizeof(WT));
    const char* src = reinterpret_cast<const char*>(W + w_off);
    auto stage = [&](int t) {
      char* dst = reinterpret_cast<char*>(Ws + (t & 1) * kKT * kHMax);
      const char* s = src + static_cast<long long>(t) * stage_bytes;
      for (int off = tid * 16; off < stage_bytes; off += kThreads * 16) cp_async16(dst + off, s + off);
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
      const WT* ws = Ws + (t & 1) * kKT * kHMax + 4 * lane;
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
          for (int q = 0; q < NQ; ++q) load4<WT>(ws + (kk + u) * n + 128 * q, &w[4 * q]);
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
        for (int c = 0; c < 4; ++c) v[c] = activate<kBF16>(v[c], beta);
        *reinterpret_cast<float4*>(H + p * kHMax + o) = make_float4(v[0], v[1], v[2], v[3]);
      }
    }
  }
  __syncthreads();
}

// The whole network over the tile whose coordinates are in xs (64 x 4,
// rounded to the working type); leaves the 64 results in res.
template <typename WT>
__device__ void tile_forward(const long long* __restrict__ desc, int n_lin, int d_in, float beta,
                             const WT* __restrict__ W, const float* __restrict__ B, float* smem) {
  float* H = smem;
  float* xs = H + kTileP * kHMax;
  float* res = xs + kTileP * 4;
  WT* Ws = reinterpret_cast<WT*>(smem + smem_floats());
  for (int l = 0; l < n_lin; ++l) {
    const long long* d = desc + kDesc * l;
    const bool last = l == n_lin - 1;
    switch (static_cast<int>(d[1]) / 128) {
      case 1: layer_forward<WT, 1>(d, d_in, beta, last, W, B, H, xs, res, Ws); break;
      case 2: layer_forward<WT, 2>(d, d_in, beta, last, W, B, H, xs, res, Ws); break;
      case 3: layer_forward<WT, 3>(d, d_in, beta, last, W, B, H, xs, res, Ws); break;
      default: layer_forward<WT, 4>(d, d_in, beta, last, W, B, H, xs, res, Ws); break;
    }
  }
}

template <typename WT>
__device__ __forceinline__ float to_working(float v) {
  return std::is_same<WT, __nv_bfloat16>::value ? bf16_round(v) : v;
}

// ---- entries ----------------------------------------------------------------

template <typename WT>
__global__ void __launch_bounds__(kThreads, 1)
points_kernel(const float* __restrict__ x, long long n_pts, int d_in,
              const long long* __restrict__ desc, int n_lin, float beta,
              const WT* __restrict__ W, const float* __restrict__ B, float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* xs = smem + kTileP * kHMax;
  float* res = xs + kTileP * 4;
  const long long p0 = static_cast<long long>(blockIdx.x) * kTileP;
  for (int e = threadIdx.x; e < kTileP * 4; e += kThreads) {
    const int p = e >> 2, r = e & 3;
    float v = 0.f;
    if (r < d_in && p0 + p < n_pts) v = x[(p0 + p) * d_in + r];
    xs[e] = to_working<WT>(v);
  }
  __syncthreads();
  tile_forward<WT>(desc, n_lin, d_in, beta, W, B, smem);
  const long long p = p0 + threadIdx.x;
  if (threadIdx.x < kTileP && p < n_pts) out[p] = res[threadIdx.x];
}

// dense n^3 grid over linspace(-1, 1, n), flat = x*n^2 + y*n + z; tile t
// covers flat indices [64 t, 64 t + 64); out holds the whole volume
template <typename WT>
__global__ void __launch_bounds__(kThreads, 1)
grid_kernel(long long base_tile, int n, float step,
            const long long* __restrict__ desc, int n_lin, float beta,
            const WT* __restrict__ W, const float* __restrict__ B, float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* xs = smem + kTileP * kHMax;
  float* res = xs + kTileP * 4;
  const long long nn = static_cast<long long>(n) * n;
  const long long total = nn * n;
  const long long p0 = (base_tile + blockIdx.x) * kTileP;
  for (int e = threadIdx.x; e < kTileP * 4; e += kThreads) {
    const int p = e >> 2, r = e & 3;
    const long long flat = p0 + p;
    float v = 0.f;
    if (r < 3 && flat < total) {
      const long long i = r == 0 ? flat / nn : r == 1 ? (flat / n) % n : flat % n;
      v = grid_coord(i, step);
    }
    xs[e] = to_working<WT>(v);
  }
  __syncthreads();
  tile_forward<WT>(desc, n_lin, 3, beta, W, B, smem);
  const long long flat = p0 + threadIdx.x;
  if (threadIdx.x < kTileP && flat < total) out[flat] = res[threadIdx.x];
}

// the block^3 points of each active block: block b = blockIdx.x / tiles is
// ids[b] (flat over the nb^3 blocks); blocks at or past *count exit at once
template <typename WT>
__global__ void __launch_bounds__(kThreads, 1)
blocks_kernel(const int* __restrict__ ids, const int* __restrict__ count, int nb, int block, float step,
              const long long* __restrict__ desc, int n_lin, float beta,
              const WT* __restrict__ W, const float* __restrict__ B, float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  const int pts = block * block * block;
  const int tiles = pts / kTileP;
  const int b = blockIdx.x / tiles;
  if (b >= *count) return;
  float* smem = reinterpret_cast<float*>(smem4);
  float* xs = smem + kTileP * kHMax;
  float* res = xs + kTileP * 4;
  const int sub = blockIdx.x % tiles;
  const int id = ids[b];
  const int bz = id % nb, by = (id / nb) % nb, bx = id / (nb * nb);
  for (int e = threadIdx.x; e < kTileP * 4; e += kThreads) {
    const int p = e >> 2, r = e & 3;
    const int local = sub * kTileP + p;
    float v = 0.f;
    if (r < 3) {
      const int i = r == 0 ? bx * block + local / (block * block)
                  : r == 1 ? by * block + (local / block) % block
                           : bz * block + local % block;
      v = grid_coord(i, step);
    }
    xs[e] = to_working<WT>(v);
  }
  __syncthreads();
  tile_forward<WT>(desc, n_lin, 3, beta, W, B, smem);
  if (threadIdx.x < kTileP) out[static_cast<long long>(b) * pts + sub * kTileP + threadIdx.x] = res[threadIdx.x];
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
}

template <typename WT>
cudaError_t launch_points(const float* x, long long n_pts, int d_in, const long long* desc, int n_lin,
                          float beta, const void* w, const float* b, float* out, cudaStream_t stream) {
  const size_t smem = smem_bytes<WT>();
  cudaError_t err = allow_smem(points_kernel<WT>, smem);
  if (err != cudaSuccess) return err;
  const long long tiles = (n_pts + kTileP - 1) / kTileP;
  if (tiles == 0) return cudaSuccess;
  points_kernel<WT><<<static_cast<unsigned>(tiles), kThreads, smem, stream>>>(
      x, n_pts, d_in, desc, n_lin, beta, static_cast<const WT*>(w), b, out);
  return cudaGetLastError();
}

template <typename WT>
cudaError_t launch_grid(long long base_tile, long long n_tiles, int n, float step, const long long* desc,
                        int n_lin, float beta, const void* w, const float* b, float* out, cudaStream_t stream) {
  const size_t smem = smem_bytes<WT>();
  cudaError_t err = allow_smem(grid_kernel<WT>, smem);
  if (err != cudaSuccess) return err;
  if (n_tiles == 0) return cudaSuccess;
  grid_kernel<WT><<<static_cast<unsigned>(n_tiles), kThreads, smem, stream>>>(
      base_tile, n, step, desc, n_lin, beta, static_cast<const WT*>(w), b, out);
  return cudaGetLastError();
}

template <typename WT>
cudaError_t launch_blocks(const int* ids, const int* count, int k_max, int nb, int block, float step,
                          const long long* desc, int n_lin, float beta, const void* w, const float* b,
                          float* out, cudaStream_t stream) {
  const size_t smem = smem_bytes<WT>();
  cudaError_t err = allow_smem(blocks_kernel<WT>, smem);
  if (err != cudaSuccess) return err;
  const long long grid = static_cast<long long>(k_max) * (block * block * block / kTileP);
  if (grid == 0) return cudaSuccess;
  blocks_kernel<WT><<<static_cast<unsigned>(grid), kThreads, smem, stream>>>(
      ids, count, nb, block, step, desc, n_lin, beta, static_cast<const WT*>(w), b, out);
  return cudaGetLastError();
}

}  // namespace

// ---- C interface (ctypes); each returns the cudaError_t of its launch --------

extern "C" {

int sdf_mlp_tile_points() { return kTileP; }
int sdf_mlp_max_width() { return kHMax; }
const char* sdf_mlp_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

int sdf_mlp_points(const float* x, long long n_pts, int d_in, const long long* desc, int n_lin, float beta,
                   int bf16, const void* w, const float* b, float* out, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_points<__nv_bfloat16>(x, n_pts, d_in, desc, n_lin, beta, w, b, out, s)
              : launch_points<float>(x, n_pts, d_in, desc, n_lin, beta, w, b, out, s);
}

int sdf_mlp_grid(long long base_tile, long long n_tiles, int n, float step, const long long* desc, int n_lin,
                 float beta, int bf16, const void* w, const float* b, float* out, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_grid<__nv_bfloat16>(base_tile, n_tiles, n, step, desc, n_lin, beta, w, b, out, s)
              : launch_grid<float>(base_tile, n_tiles, n, step, desc, n_lin, beta, w, b, out, s);
}

int sdf_mlp_blocks(const int* ids, const int* count, int k_max, int nb, int block, float step,
                   const long long* desc, int n_lin, float beta, int bf16, const void* w, const float* b,
                   float* out, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_blocks<__nv_bfloat16>(ids, count, k_max, nb, block, step, desc, n_lin, beta, w, b, out, s)
              : launch_blocks<float>(ids, count, k_max, nb, block, step, desc, n_lin, beta, w, b, out, s);
}

}  // extern "C"
