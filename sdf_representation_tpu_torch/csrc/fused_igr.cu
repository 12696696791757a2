// Fused (f, grad_x f) forward and its params-only backward for the eikonal
// (IGR) losses on Hopper (sm_90a), with a plain C interface for ctypes
// (sdf_representation_tpu_torch/ops/fused_igr.py binds it).
//
// Replaces two TPU kernels of the JAX package:
//   * igr_fwd  ops/pallas_igr.py _make_fwd_kernel, pallas_call in _fused_vag_fwd:
//     the primal forward, then ONE reverse sweep of a single cotangent from
//     the scalar head, which is grad_x f.
//   * igr_bwd  ops/pallas_igr.py _make_bwd_kernel, pallas_call in _fused_vag_bwd:
//     grad_theta sum_b [a_b f_b + c_b . grad_x f(x_b)] for cotangents a, c.
//     It rematerialises the primal chain h and the c-tangent chain tc, runs
//     their reverse sweep and accumulates dW = h^T dz + tc^T dtcz, db = sum dz.
//     x is data: no cotangent for x is produced.
//
// What bounds them: operations (about 2 and 6 hidden-layer products per
// point against a few bytes of input and output). Design, and what the TPU
// kernels did differently:
//   * A block owns a tile of 64 rows x up to 512 columns of f32 in shared
//     memory, updated in place; weights stream through a cp.async double
//     buffer in 16-row stages; a thread accumulates 8 rows x (4*NQ) columns
//     with f32 FMA (both working types; no tensor cores yet). Forward: the 64
//     rows are 64 points. Backward: 32 points, each with its primal and its
//     tangent row, laid out so that one thread owns both rows of a point (rows
//     8w+i and 8w+i+4 of warp w), which makes every epilogue thread-local.
//   * The per-layer stash (sigma'(z) forward; [act(z); tcz*s] backward) does
//     not fit an SM. It goes to a workspace in device memory, f32, one row
//     per tile row, written and read back by the same block.
//   * The reverse products need W^T: the wrapper hands over a transposed copy
//     of every hidden-to-hidden matrix, so every large product in here is the
//     same rows-of-B-streamed form.
//   * dW and db are sums over all points. Blocks run concurrently, so each
//     block adds its tile's share with f32 atomicAdd into accumulators that
//     the wrapper zeroes before the launch. The order of those additions is
//     not fixed: two launches agree to rounding, not bit for bit.
//   * The head (one live output column) is a dot product per row, and f and
//     grad f are stored directly.
//   * Rows past the last point are masked: their seeds are zero, so they add
//     nothing to dW or db.
//
// Numerics kept from the JAX kernels. f32: everything f32. bf16: weights bf16;
// x and c are rounded on load; the stashed sigma'(z), act(z) and tcz*s are
// rounded; every cotangent is rounded before a product with W^T or into dW;
// the tanh head's stashed (z, Tcz) is rounded; accumulators, biases, a, the
// seeds, db and all elementwise backward arithmetic stay f32. The backward
// recovers sigma from the stashed activation, s = 1 - exp(-beta * h).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int kRows = 64;      // tile rows per block
constexpr int kBwdPts = 32;    // points per block in the backward (two rows each)
constexpr int kThreads = 256;  // 8 warps; warp w owns rows 8w .. 8w+7
constexpr int kPts = 8;        // rows per thread
constexpr int kKT = 16;        // weight rows per shared-memory stage
constexpr int kHMax = 512;     // widest padded layer the tile holds
constexpr int kDesc = 6;       // int64 fields per layer descriptor
constexpr int kChunk = 64;     // dW rows per pass of dw_product
constexpr float kInvSqrt2 = 0.70710678118654752440f;

// layer descriptor (int64 x kDesc), the layout of FusedNet.packed:
//   [0] k     rows of the hidden-input matrix (0 for the first layer)
//   [1] n     padded output width (the hidden width; 128 for the last layer)
//   [2] skip  1: scale (h W_top + x W_bot) by 1/sqrt(2) before the bias
//   [3] b     element offset of the bias in the f32 bias buffer
//   [4] w     element offset of the hidden-input matrix (k x n, row-major), -1 if none
//   [5] wx    element offset of the coordinate-input matrix (d_in x n), -1 if none
// wt_off[l]: element offset of layer l's transposed hidden-input matrix
// (n x k) in the transposed buffer, -1 where the layer has none.

__host__ __device__ constexpr size_t smem_floats() {
  return size_t(kRows) * kHMax + kRows * 4 + kRows * 2;  // H, coords, seeds
}
template <typename WT>
__host__ __device__ constexpr size_t smem_bytes() {
  return smem_floats() * sizeof(float) + 2 * size_t(kKT) * kHMax * sizeof(WT);
}
static_assert(2 * size_t(kKT) * kHMax * sizeof(__nv_bfloat16) >= 2 * size_t(kRows) * kChunk * sizeof(float),
              "the weight stages also hold dw_product's two stash chunks");

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
template <typename WT>
__device__ __forceinline__ float to_working(float v) {
  return std::is_same<WT, __nv_bfloat16>::value ? bf16_round(v) : v;
}
__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// act(z): softplus(beta z)/beta, or ReLU for beta <= 0
__device__ __forceinline__ float act(float z, float beta) {
  if (beta > 0.f) {
    const float t = beta * z;
    return (fmaxf(t, 0.f) + log1pf(expf(-fabsf(t)))) / beta;
  }
  return fmaxf(z, 0.f);
}
// act'(z): sigmoid(beta z), or the step for beta <= 0
__device__ __forceinline__ float sigma(float z, float beta) {
  if (beta > 0.f) return 1.f / (1.f + expf(-beta * z));
  return z > 0.f ? 1.f : 0.f;
}

template <int NQ>
__device__ __forceinline__ void zero(float (&acc)[kPts][4 * NQ]) {
#pragma unroll
  for (int i = 0; i < kPts; ++i)
#pragma unroll
    for (int j = 0; j < 4 * NQ; ++j) acc[i][j] = 0.f;
}

// acc[i][.] += sum_r xs[row i][r] * Wx[r][.]: the coordinate rows of a first
// or skip layer. Lane owns columns 128 q + 4 lane + c.
template <typename WT, int NQ>
__device__ __forceinline__ void coord_rows(float (&acc)[kPts][4 * NQ], const float* xs,
                                           const WT* __restrict__ Wx, int d_in) {
  constexpr int n = 128 * NQ;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = 0; r < d_in; ++r) {
    float w[4 * NQ];
#pragma unroll
    for (int q = 0; q < NQ; ++q) load4<WT>(Wx + r * n + 128 * q + 4 * lane, &w[4 * q]);
#pragma unroll
    for (int i = 0; i < kPts; ++i) {
      const float a = xs[(warp * kPts + i) * 4 + r];
#pragma unroll
      for (int j = 0; j < 4 * NQ; ++j) acc[i][j] = fmaf(a, w[j], acc[i][j]);
    }
  }
}

// acc += H (64 x k, shared) @ W (k x n, device memory, row-major, n = 128 NQ),
// W streamed kKT rows at a time through the double buffer Ws. Returns after a
// barrier: every warp is done reading H.
template <typename WT, int NQ>
__device__ __forceinline__ void tile_gemm(float (&acc)[kPts][4 * NQ], const float* H,
                                          const WT* __restrict__ W, int k, WT* Ws) {
  constexpr int n = 128 * NQ;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nk = k / kKT;
  constexpr int stage_bytes = kKT * n * static_cast<int>(sizeof(WT));
  const char* src = reinterpret_cast<const char*>(W);
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

// dx[i][r] += scale * sum_n H[row i][n] * Wx[r][n]  (the cotangent's product
// with the coordinate rows, transposed); every lane ends with the full sums.
template <typename WT, int NQ>
__device__ __forceinline__ void coord_back(float (&dx)[kPts][4], const float* H,
                                           const WT* __restrict__ Wx, int d_in, float scale) {
  constexpr int n = 128 * NQ;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = 0; r < d_in; ++r) {
    float w[4 * NQ];
#pragma unroll
    for (int q = 0; q < NQ; ++q) load4<WT>(Wx + r * n + 128 * q + 4 * lane, &w[4 * q]);
#pragma unroll
    for (int i = 0; i < kPts; ++i) {
      const float* hrow = H + (warp * kPts + i) * kHMax + 4 * lane;
      float s = 0.f;
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        const float4 h = *reinterpret_cast<const float4*>(hrow + 128 * q);
        s = fmaf(h.x, w[4 * q], s);
        s = fmaf(h.y, w[4 * q + 1], s);
        s = fmaf(h.z, w[4 * q + 2], s);
        s = fmaf(h.w, w[4 * q + 3], s);
      }
      dx[i][r] += scale * warp_sum(s);
    }
  }
}

// The last layer's live column as f32 in wv[0 .. k).
template <typename WT>
__device__ __forceinline__ void load_head(float* wv, const WT* __restrict__ Wl, int k) {
  for (int j = threadIdx.x; j < k; j += kThreads) wv[j] = to_float(Wl[static_cast<long long>(j) * 128]);
}

__device__ __forceinline__ float row_dot(const float* hrow, const float* wv, int k) {
  float s = 0.f;
  for (int j = threadIdx.x & 31; j < k; j += 32) s = fmaf(hrow[j], wv[j], s);
  return warp_sum(s);
}

// ---- forward: f and grad_x f ---------------------------------------------------

template <typename WT, int NQ>
__global__ void __launch_bounds__(kThreads, 1)
igr_fwd_kernel(const float* __restrict__ x, long long n_pts, int d_in,
               const long long* __restrict__ desc, const long long* __restrict__ wt_off, int n_lin,
               float beta, const WT* __restrict__ W, const WT* __restrict__ Wt,
               const float* __restrict__ B, float* __restrict__ stash, long long stash_rows,
               float* __restrict__ f_out, float* __restrict__ g_out) {
  constexpr int n = 128 * NQ;
  extern __shared__ float4 smem4[];
  float* H = reinterpret_cast<float*>(smem4);
  float* xs = H + kRows * kHMax;
  WT* Ws = reinterpret_cast<WT*>(H + smem_floats());
  float* wv = reinterpret_cast<float*>(Ws);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long row0 = static_cast<long long>(blockIdx.x) * kRows;
  const long long layer_stride = stash_rows * n;

  for (int e = tid; e < kRows * 4; e += kThreads) {
    const int p = e >> 2, r = e & 3;
    float v = 0.f;
    if (r < d_in && row0 + p < n_pts) v = x[(row0 + p) * d_in + r];
    xs[e] = to_working<WT>(v);
  }
  __syncthreads();

  float acc[kPts][4 * NQ];
  // primal forward over the hidden layers, stashing sigma'(z)
  for (int l = 0; l < n_lin - 1; ++l) {
    const long long* d = desc + kDesc * l;
    zero<NQ>(acc);
    if (d[5] >= 0) coord_rows<WT, NQ>(acc, xs, W + d[5], d_in);
    if (d[0] > 0) tile_gemm<WT, NQ>(acc, H, W + d[4], static_cast<int>(d[0]), Ws);
    const float scale = d[2] != 0 ? kInvSqrt2 : 1.f;
    float* S = stash + l * layer_stride;
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const int o = 128 * q + 4 * lane;
      const float4 bias = *reinterpret_cast<const float4*>(B + d[3] + o);
      const float bv[4] = {bias.x, bias.y, bias.z, bias.w};
#pragma unroll
      for (int i = 0; i < kPts; ++i) {
        const int p = warp * kPts + i;
        float s[4], h[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float z = acc[i][4 * q + c] * scale + bv[c];
          s[c] = to_working<WT>(sigma(z, beta));
          h[c] = to_working<WT>(act(z, beta));
        }
        *reinterpret_cast<float4*>(S + (row0 + p) * n + o) = make_float4(s[0], s[1], s[2], s[3]);
        *reinterpret_cast<float4*>(H + p * kHMax + o) = make_float4(h[0], h[1], h[2], h[3]);
      }
    }
    __syncthreads();
  }

  // head: z = h . w + b; f = z or tanh z; the cotangent seed; then the last
  // layer's reverse step, dz = (seed * w) * sigma'(z of the last hidden layer)
  const long long* dl = desc + kDesc * (n_lin - 1);
  const int hk = static_cast<int>(dl[0]);
  load_head<WT>(wv, W + dl[4], hk);
  __syncthreads();
  {
    const float* S = stash + (n_lin - 2) * layer_stride;
    const float bl = B[dl[3]];
    for (int i = 0; i < kPts; ++i) {
      const int p = warp * kPts + i;
      float* hrow = H + p * kHMax;
      const float z = row_dot(hrow, wv, hk) + bl;
      float f = z, seed = 1.f;
      if (!(beta > 0.f)) {
        f = tanhf(z);
        seed = 1.f - f * f;
      }
      if (lane == 0 && row0 + p < n_pts) f_out[row0 + p] = f;
      seed = to_working<WT>(seed);
      const float* srow = S + (row0 + p) * n;
      // each lane rewrites only the columns it read in row_dot
      for (int j = lane; j < hk; j += 32) hrow[j] = to_working<WT>(seed * wv[j] * srow[j]);
    }
  }
  __syncthreads();

  // reverse sweep: H holds the (rounded) cotangent dz of layer l's output
  float dx[kPts][4];
#pragma unroll
  for (int i = 0; i < kPts; ++i)
#pragma unroll
    for (int r = 0; r < 4; ++r) dx[i][r] = 0.f;
  for (int l = n_lin - 2; l >= 1; --l) {
    const long long* d = desc + kDesc * l;
    const float scale = d[2] != 0 ? kInvSqrt2 : 1.f;
    if (d[5] >= 0) coord_back<WT, NQ>(dx, H, W + d[5], d_in, scale);
    zero<NQ>(acc);
    tile_gemm<WT, NQ>(acc, H, Wt + wt_off[l], n, Ws);
    const float* S = stash + (l - 1) * layer_stride;
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const int o = 128 * q + 4 * lane;
#pragma unroll
      for (int i = 0; i < kPts; ++i) {
        const int p = warp * kPts + i;
        const float4 s = *reinterpret_cast<const float4*>(S + (row0 + p) * n + o);
        *reinterpret_cast<float4*>(H + p * kHMax + o) = make_float4(
            to_working<WT>(acc[i][4 * q] * scale * s.x), to_working<WT>(acc[i][4 * q + 1] * scale * s.y),
            to_working<WT>(acc[i][4 * q + 2] * scale * s.z), to_working<WT>(acc[i][4 * q + 3] * scale * s.w));
      }
    }
    __syncthreads();
  }
  coord_back<WT, NQ>(dx, H, W + desc[5], d_in, 1.f);
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < kPts; ++i) {
      const long long p = row0 + warp * kPts + i;
      if (p < n_pts)
        for (int r = 0; r < d_in; ++r) g_out[p * d_in + r] = dx[i][r];
    }
  }
}

// ---- backward: parameter gradients -----------------------------------------------

// gW[k][.] += scale * sum_r A[r][k] * H[r][.] over the tile's 64 rows: A is
// the stash of the layer below (device memory, row stride n), H the rounded
// cotangents in shared memory. kChunk rows of dW at a time: thread rows are
// k = kc*64 + 8 warp + i, columns as everywhere. The stash chunk (64 x 64
// f32) is staged through the weight buffers.
template <int NQ>
__device__ __forceinline__ void dw_product(const float* A, const float* H,
                                           float* __restrict__ gW, float scale, float* As) {
  constexpr int n = 128 * NQ;
  constexpr int n_chunks = n / kChunk;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  auto stage = [&](int kc) {
    float* dst = As + (kc & 1) * kRows * kChunk;
    for (int e = tid; e < kRows * (kChunk / 4); e += kThreads) {
      const int r = e / (kChunk / 4), seg = e % (kChunk / 4);
      cp_async16(dst + r * kChunk + 4 * seg, A + static_cast<long long>(r) * n + kc * kChunk + 4 * seg);
    }
    cp_async_commit();
  };
  stage(0);
  for (int kc = 0; kc < n_chunks; ++kc) {
    if (kc + 1 < n_chunks) {
      stage(kc + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    float acc[kPts][4 * NQ];
    zero<NQ>(acc);
    const float* as = As + (kc & 1) * kRows * kChunk + warp * kPts;
    const float* hcol = H + 4 * lane;
#pragma unroll 2
    for (int r = 0; r < kRows; ++r) {
      const float4 a0 = *reinterpret_cast<const float4*>(as + r * kChunk);
      const float4 a1 = *reinterpret_cast<const float4*>(as + r * kChunk + 4);
      const float a[kPts] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      float b[4 * NQ];
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        const float4 v = *reinterpret_cast<const float4*>(hcol + r * kHMax + 128 * q);
        b[4 * q] = v.x; b[4 * q + 1] = v.y; b[4 * q + 2] = v.z; b[4 * q + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < kPts; ++i)
#pragma unroll
        for (int j = 0; j < 4 * NQ; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < kPts; ++i) {
      float* dst = gW + static_cast<long long>(kc * kChunk + warp * kPts + i) * n + 4 * lane;
#pragma unroll
      for (int q = 0; q < NQ; ++q)
#pragma unroll
        for (int c = 0; c < 4; ++c) atomicAdd(dst + 128 * q + c, acc[i][4 * q + c] * scale);
    }
    __syncthreads();  // this buffer is restaged two chunks on
  }
}

// gWx[r][.] += scale * sum_rows xs[row][r] * H[row][.]  (d_in x n)
__device__ __forceinline__ void dwx_product(const float* xs, const float* H, float* __restrict__ gWx,
                                            int d_in, int n, float scale) {
  for (int col = threadIdx.x; col < n; col += kThreads) {
    float s[4] = {0.f, 0.f, 0.f, 0.f};
    for (int r = 0; r < kRows; ++r) {
      const float h = H[r * kHMax + col];
#pragma unroll
      for (int k = 0; k < 4; ++k) s[k] = fmaf(xs[r * 4 + k], h, s[k]);
    }
    for (int k = 0; k < d_in; ++k) atomicAdd(gWx + k * n + col, s[k] * scale);
  }
}

// One reverse step's epilogue. acc rows i < 4 hold dh, rows i + 4 hold dtc of
// the same points (already W^T products, unscaled). With the stash of the
// layer below (h = act(z), tc = tcz * s):
//   s = 1 - exp(-beta h)         (step(h) for ReLU)
//   dz = dh s + dtc tc beta (1 - s),  dtcz = dtc s
// db of that layer takes the unrounded dz; H gets both, rounded. (A and the
// stash chunks of dw_product were written by this kernel: no __restrict__ on
// them, so their loads stay on the coherent path.)
template <typename WT, int NQ>
__device__ __forceinline__ void reverse_epilogue(const float (&acc)[kPts][4 * NQ], float scale, float beta,
                                                 const float* A, float* H, float* __restrict__ gb) {
  constexpr int n = 128 * NQ;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    const int o = 128 * q + 4 * lane;
    float db[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int i = 0; i < kPts / 2; ++i) {
      const int rp = warp * kPts + i, rt = rp + kPts / 2;
      const float4 h4 = *reinterpret_cast<const float4*>(A + static_cast<long long>(rp) * n + o);
      const float4 t4 = *reinterpret_cast<const float4*>(A + static_cast<long long>(rt) * n + o);
      const float hp[4] = {h4.x, h4.y, h4.z, h4.w}, tc[4] = {t4.x, t4.y, t4.z, t4.w};
      float dz[4], dt[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float dh = acc[i][4 * q + c] * scale, dtc = acc[i + kPts / 2][4 * q + c] * scale;
        if (beta > 0.f) {
          const float s = 1.f - expf(-beta * hp[c]);
          dz[c] = dh * s + (dtc * tc[c]) * (beta * (1.f - s));
          dt[c] = dtc * s;
        } else {
          const float s = hp[c] > 0.f ? 1.f : 0.f;
          dz[c] = dh * s;
          dt[c] = dtc * s;
        }
        db[c] += dz[c];
      }
      *reinterpret_cast<float4*>(H + rp * kHMax + o) = make_float4(
          to_working<WT>(dz[0]), to_working<WT>(dz[1]), to_working<WT>(dz[2]), to_working<WT>(dz[3]));
      *reinterpret_cast<float4*>(H + rt * kHMax + o) = make_float4(
          to_working<WT>(dt[0]), to_working<WT>(dt[1]), to_working<WT>(dt[2]), to_working<WT>(dt[3]));
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) atomicAdd(gb + o + c, db[c]);
  }
}

template <typename WT, int NQ>
__global__ void __launch_bounds__(kThreads, 1)
igr_bwd_kernel(const float* __restrict__ x, const float* __restrict__ a, const float* __restrict__ cvec,
               long long n_pts, int d_in, const long long* __restrict__ desc,
               const long long* __restrict__ wt_off, int n_lin, float beta,
               const WT* __restrict__ W, const WT* __restrict__ Wt, const float* __restrict__ B,
               float* __restrict__ stash, long long stash_rows,
               float* __restrict__ gW, float* __restrict__ gB) {
  constexpr int n = 128 * NQ;
  constexpr int kHalf = kPts / 2;
  extern __shared__ float4 smem4[];
  float* H = reinterpret_cast<float*>(smem4);
  float* xs = H + kRows * kHMax;
  float* seed = xs + kRows * 4;  // rounded seeds per tile row
  WT* Ws = reinterpret_cast<WT*>(H + smem_floats());
  float* wv = reinterpret_cast<float*>(Ws);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long pt0 = static_cast<long long>(blockIdx.x) * kBwdPts;
  const long long row0 = static_cast<long long>(blockIdx.x) * kRows;
  const long long layer_stride = stash_rows * n;

  // tile row r = 8 w + i: point 4 w + (i & 3); rows i < 4 carry x (primal),
  // rows i >= 4 carry c (tangent)
  for (int e = tid; e < kRows * 4; e += kThreads) {
    const int r = e >> 2, k = e & 3;
    const long long p = pt0 + 4 * (r >> 3) + (r & 3);
    const float* src = (r & 7) >= kHalf ? cvec : x;
    float v = 0.f;
    if (k < d_in && p < n_pts) v = src[p * d_in + k];
    xs[e] = to_working<WT>(v);
  }
  __syncthreads();

  float acc[kPts][4 * NQ];
  // rematerialise both chains, stashing [act(z); tcz * s] per hidden layer
  for (int l = 0; l < n_lin - 1; ++l) {
    const long long* d = desc + kDesc * l;
    zero<NQ>(acc);
    if (d[5] >= 0) coord_rows<WT, NQ>(acc, xs, W + d[5], d_in);
    if (d[0] > 0) tile_gemm<WT, NQ>(acc, H, W + d[4], static_cast<int>(d[0]), Ws);
    const float scale = d[2] != 0 ? kInvSqrt2 : 1.f;
    float* A = stash + l * layer_stride + row0 * n;
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const int o = 128 * q + 4 * lane;
      const float4 bias = *reinterpret_cast<const float4*>(B + d[3] + o);
      const float bv[4] = {bias.x, bias.y, bias.z, bias.w};
#pragma unroll
      for (int i = 0; i < kHalf; ++i) {
        const int rp = warp * kPts + i, rt = rp + kHalf;
        float h[4], tc[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float z = acc[i][4 * q + c] * scale + bv[c];  // the bias is the primal row's only
          const float tcz = acc[i + kHalf][4 * q + c] * scale;
          h[c] = to_working<WT>(act(z, beta));
          tc[c] = to_working<WT>(tcz * sigma(z, beta));
        }
        const float4 h4 = make_float4(h[0], h[1], h[2], h[3]), t4 = make_float4(tc[0], tc[1], tc[2], tc[3]);
        *reinterpret_cast<float4*>(H + rp * kHMax + o) = h4;
        *reinterpret_cast<float4*>(H + rt * kHMax + o) = t4;
        *reinterpret_cast<float4*>(A + static_cast<long long>(rp) * n + o) = h4;
        *reinterpret_cast<float4*>(A + static_cast<long long>(rt) * n + o) = t4;
      }
    }
    __syncthreads();
  }

  // head: (z, Tcz) of the last layer and the seeds on them
  const long long* dl = desc + kDesc * (n_lin - 1);
  const int hk = static_cast<int>(dl[0]);
  load_head<WT>(wv, W + dl[4], hk);
  __syncthreads();
  {
    const float bl = B[dl[3]];
    float db_last = 0.f;
    for (int i = 0; i < kHalf; ++i) {
      const int rp = warp * kPts + i, rt = rp + kHalf;
      const long long p = pt0 + 4 * warp + i;
      float z = row_dot(H + rp * kHMax, wv, hk) + bl;
      float tz = row_dot(H + rt * kHMax, wv, hk);
      float dz = 0.f, dt = 0.f;
      if (p < n_pts) {
        const float ap = a[p];
        if (beta > 0.f) {
          dz = ap;
          dt = 1.f;
        } else {  // f = tanh z, g = Tcz (1 - f^2); the TPU kernel stashes (z, Tcz) rounded
          z = to_working<WT>(z);
          tz = to_working<WT>(tz);
          const float t = tanhf(z), fp = 1.f - t * t;
          dz = ap * fp - 2.f * t * fp * tz;
          dt = fp;
        }
      }
      db_last += dz;
      if (lane == 0) {
        seed[rp] = to_working<WT>(dz);
        seed[rt] = to_working<WT>(dt);
      }
    }
    if (lane == 0) atomicAdd(gB + dl[3], db_last);
  }
  __syncthreads();
  // dW of the last layer's live column: sum over rows of [h; tc] * seeds
  for (int j = tid; j < hk; j += kThreads) {
    float s = 0.f;
    for (int r = 0; r < kRows; ++r) s = fmaf(H[r * kHMax + j], seed[r], s);
    atomicAdd(gW + dl[4] + static_cast<long long>(j) * 128, s);
  }
  // the last layer's reverse step: [dh; dtc] = seeds (outer) w
#pragma unroll
  for (int q = 0; q < NQ; ++q)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int col = 128 * q + 4 * lane + c;
      const float w = col < hk ? wv[col] : 0.f;
#pragma unroll
      for (int i = 0; i < kPts; ++i) acc[i][4 * q + c] = seed[warp * kPts + i] * w;
    }
  __syncthreads();  // every read of H and wv is done
  reverse_epilogue<WT, NQ>(acc, 1.f, beta, stash + (n_lin - 2) * layer_stride + row0 * n, H,
                           gB + desc[kDesc * (n_lin - 2) + 3]);
  __syncthreads();

  // reverse sweep: H holds the rounded [dz; dtcz] of layer l
  for (int l = n_lin - 2; l >= 1; --l) {
    const long long* d = desc + kDesc * l;
    const float scale = d[2] != 0 ? kInvSqrt2 : 1.f;
    const float* A = stash + (l - 1) * layer_stride + row0 * n;
    dw_product<NQ>(A, H, gW + d[4], scale, reinterpret_cast<float*>(Ws));
    if (d[5] >= 0) dwx_product(xs, H, gW + d[5], d_in, n, scale);
    zero<NQ>(acc);
    tile_gemm<WT, NQ>(acc, H, Wt + wt_off[l], n, Ws);
    reverse_epilogue<WT, NQ>(acc, scale, beta, A, H, gB + desc[kDesc * (l - 1) + 3]);
    __syncthreads();
  }
  dwx_product(xs, H, gW + desc[5], d_in, n, 1.f);
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
}

template <typename WT, int NQ>
cudaError_t launch_fwd(const float* x, long long n_pts, int d_in, const long long* desc, const long long* wt_off,
                       int n_lin, float beta, const void* w, const void* wt, const float* b, float* stash,
                       long long stash_rows, float* f, float* g, cudaStream_t stream) {
  const size_t smem = smem_bytes<WT>();
  cudaError_t err = allow_smem(igr_fwd_kernel<WT, NQ>, smem);
  if (err != cudaSuccess) return err;
  const long long tiles = (n_pts + kRows - 1) / kRows;
  if (tiles == 0) return cudaSuccess;
  igr_fwd_kernel<WT, NQ><<<static_cast<unsigned>(tiles), kThreads, smem, stream>>>(
      x, n_pts, d_in, desc, wt_off, n_lin, beta, static_cast<const WT*>(w), static_cast<const WT*>(wt), b,
      stash, stash_rows, f, g);
  return cudaGetLastError();
}

template <typename WT, int NQ>
cudaError_t launch_bwd(const float* x, const float* a, const float* c, long long n_pts, int d_in,
                       const long long* desc, const long long* wt_off, int n_lin, float beta, const void* w,
                       const void* wt, const float* b, float* stash, long long stash_rows, float* gw, float* gb,
                       cudaStream_t stream) {
  const size_t smem = smem_bytes<WT>();
  cudaError_t err = allow_smem(igr_bwd_kernel<WT, NQ>, smem);
  if (err != cudaSuccess) return err;
  const long long tiles = (n_pts + kBwdPts - 1) / kBwdPts;
  if (tiles == 0) return cudaSuccess;
  igr_bwd_kernel<WT, NQ><<<static_cast<unsigned>(tiles), kThreads, smem, stream>>>(
      x, a, c, n_pts, d_in, desc, wt_off, n_lin, beta, static_cast<const WT*>(w), static_cast<const WT*>(wt), b,
      stash, stash_rows, gw, gb);
  return cudaGetLastError();
}

}  // namespace

// ---- C interface (ctypes); each returns the cudaError_t of its launch --------
// h_pad is the padded hidden width, one of 128, 256, 384, 512 (the wrapper
// checks); stash has (n_lin - 1) x stash_rows x h_pad floats with stash_rows
// >= 64 * tiles.

#define IGR_DISPATCH(CALL)                                   \
  switch (h_pad / 128) {                                     \
    case 1: return bf16 ? CALL(__nv_bfloat16, 1) : CALL(float, 1); \
    case 2: return bf16 ? CALL(__nv_bfloat16, 2) : CALL(float, 2); \
    case 3: return bf16 ? CALL(__nv_bfloat16, 3) : CALL(float, 3); \
    case 4: return bf16 ? CALL(__nv_bfloat16, 4) : CALL(float, 4); \
    default: return static_cast<int>(cudaErrorInvalidValue);  \
  }

extern "C" {

int sdf_igr_fwd_points() { return kRows; }
int sdf_igr_bwd_points() { return kBwdPts; }
int sdf_igr_max_width() { return kHMax; }
const char* sdf_igr_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

int sdf_igr_fwd(const float* x, long long n_pts, int d_in, const long long* desc, const long long* wt_off,
                int n_lin, int h_pad, float beta, int bf16, const void* w, const void* wt, const float* b,
                float* stash, long long stash_rows, float* f, float* g, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
#define IGR_FWD(T, Q) \
  launch_fwd<T, Q>(x, n_pts, d_in, desc, wt_off, n_lin, beta, w, wt, b, stash, stash_rows, f, g, s)
  IGR_DISPATCH(IGR_FWD)
#undef IGR_FWD
}

int sdf_igr_bwd(const float* x, const float* a, const float* c, long long n_pts, int d_in, const long long* desc,
                const long long* wt_off, int n_lin, int h_pad, float beta, int bf16, const void* w,
                const void* wt, const float* b, float* stash, long long stash_rows, float* gw, float* gb,
                void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
#define IGR_BWD(T, Q) \
  launch_bwd<T, Q>(x, a, c, n_pts, d_in, desc, wt_off, n_lin, beta, w, wt, b, stash, stash_rows, gw, gb, s)
  IGR_DISPATCH(IGR_BWD)
#undef IGR_BWD
}

}  // extern "C"
