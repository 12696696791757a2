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
//     their reverse sweep and sums dW = h^T dz + tc^T dtcz, db = sum dz over
//     the points. x is data: no cotangent for x is produced.
//
// What bounds them: operations. At 8x512 a point costs 2 (forward) and 4
// plus 2 for dW (backward) hidden-layer products of 512 x 512 against a few
// bytes of input and output: 0.12 and 0.36 ms at 989 TFLOP/s for 16,384
// points.
//
// bf16: tensor cores, on the layer routine of csrc/hopper.cuh that the
// fused forward (csrc/fused_mlp.cu) runs: a producer warpgroup streams
// 64 x 64 weight stages by bulk copy (TMA) through an mbarrier ring, two
// consumer warpgroups each hold a 64-row tile of bf16 activations in shared
// memory in the 128-byte swizzled K-major image (the A operand as it
// stands), each layer runs as 64-column chunks of m64n64k16 products whose
// 32-deep sums are added in f32, and finished chunks wait in registers
// until the layer's last products have read the tile (the in-place hazard).
//   * The reverse products dz W^T need B = W itself, K-major over the
//     layer's outputs, where the forward products need W^T. The host lays out
//     a second staged image (FusedNet.igr_tiles: the forward stages, then
//     the reverse stages of layers n_lin - 2 .. 1, in the order both kernels
//     take them) rather than reading the forward image through wgmma's
//     transpose bit: the reverse stages are then the same K-major 64 x 64
//     blocks, one bulk copy each, through the same descriptor and ring code,
//     and the whole image is one gather from the packed weights per call.
//   * igr_fwd: 128 points per CTA, 64 per consumer. The primal sweep stashes
//     the rounded sigma(z) per hidden layer as bf16 in device memory (the
//     stash of 8 x 128 x 512 x 2 B per CTA does not fit an SM), in each
//     thread's own accumulator order, so the reverse sweep reads back, as
//     coalesced 4-byte words issued before each chunk's products, exactly
//     the values it multiplies. The head (one output) is an m64n8k16 product;
//     its reverse step seed * w * sigma is elementwise. The coordinate rows
//     (W_0, W_bot of the skip layer; d_in <= 4) are FMAs in the epilogues:
//     z += x W_x forward, dx += dz W_x^T backward (a quad shuffle sums each
//     row's columns).
//   * igr_bwd: a 64-row tile holds 32 points, each with its primal row
//     (16 w + q) and its tangent row (16 w + q + 8) in warp w's 16 rows, so
//     that the thread that holds a point's primal value at a column also
//     holds its tangent value there (the rows r0 and r0 + 8 of its
//     accumulator fragment). The couplings of the two chains (tcz sigma(z)
//     forward, dtc tc beta (1 - s) backward) are then register-local: no
//     exchange through shared memory and no second pass. Two consumers, 64
//     points per CTA. Each layer's [act(z); tcz s] and rounded [dz; dtcz]
//     tiles are copied from shared memory to a device workspace in the same
//     swizzled image (16-byte stores), and db of each layer is summed per
//     tile in a fixed order (shuffles over the tile's points, then its four
//     warps) into a (tiles x biases) buffer.
//   * dW without atomics (igr_dw, launched by the same C function after
//     igr_bwd): dW_l = [h; tc]^T [dz; dtcz] over all 2N rows, a (k x 2N) x
//     (2N x n) product per layer. A CTA owns a 64 x 128 tile of one dW or
//     dW_x matrix (a job of FusedNet's plan, fused_igr.py _dw_plan) and
//     loops over the tiles of rows in order: consumer 0 takes the even
//     tiles, consumer 1 the odd, each sum of 64 rows a tensor-core sum added
//     in f32, and the two are added at the end. The workspace image read
//     with rows as K is wgmma's MN-major layout, so both operands go in as
//     they were written (transpose bits set). The last CTAs sum the db
//     partials over the tiles in order. Two launches give the same dW and
//     db bit for bit.
//   * Rows past the last point have zero seeds, so their cotangents are
//     zero and they add nothing to dW or db.
//
// f32: the SIMT routine, a design choice for this type, not a fallback: a
// TF32 tensor-core pass would not hold the f32 results to 2e-5 of the plain
// version. A block owns 64 rows x up to 512 columns of f32 in shared memory,
// updated in place; weights stream through a cp.async double buffer in
// 16-row stages; a thread accumulates 8 rows x (4 NQ) columns with FMA.
// Forward: 64 points. Backward: 32 points, each with its primal and its
// tangent row, one thread owning both (rows 8w+i and 8w+i+4 of warp w). The
// per-layer stash goes to an f32 workspace; the reverse products read a
// transposed copy of the weights (FusedNet.transposed); dW and db are added
// with f32 atomicAdd into zeroed accumulators, so two launches agree to
// rounding, not bit for bit.
//
// Numerics kept from the JAX kernels. f32: everything f32. bf16: weights bf16;
// x and c are rounded on load; the stashed sigma'(z), act(z) and tcz*s are
// rounded; every cotangent is rounded before a product with W^T or into dW;
// the tanh head's stashed (z, Tcz) is rounded; accumulators, biases, a, the
// seeds, db and all elementwise backward arithmetic stay f32. The backward
// recovers sigma from the stashed activation, s = 1 - exp(-beta * h). The
// bf16 epilogues run softplus and 1 - exp(-beta h) in forms that keep a
// small value to ~5e-6 of itself (softplus_rel, one_minus_exp_neg: a
// series below 1/8, the hardware's approximate ex2/lg2 above) and sigmoid
// on the approximate ex2/rcp. The fused forward's cheaper softplus, whose
// small values are off by up to 1e-1 of themselves, reads 9-15% farther
// from the exact (f64) plain gradients and is 4-6% faster here (PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int kDesc = 6;  // int64 fields per layer descriptor

// layer descriptor (int64 x kDesc), the layout of FusedNet.packed:
//   [0] k     rows of the hidden-input matrix (0 for the first layer)
//   [1] n     padded output width (the hidden width; 128 for the last layer)
//   [2] skip  1: scale (h W_top + x W_bot) by 1/sqrt(2) before the bias
//   [3] b     element offset of the bias in the f32 bias buffer
//   [4] w     element offset of the hidden-input matrix (k x n, row-major), -1 if none
//   [5] wx    element offset of the coordinate-input matrix (d_in x n), -1 if none

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
}

template <typename K, typename... Args>
cudaError_t launch(K kernel, long long ctas, int threads, size_t smem, cudaStream_t stream, Args... args) {
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  if (ctas == 0) return cudaSuccess;
  kernel<<<static_cast<unsigned>(ctas), threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

// =============================================================================
// f32: the SIMT routine
// =============================================================================

namespace simt {

constexpr int kRows = 64;      // tile rows per block
constexpr int kBwdPts = 32;    // points per block in the backward (two rows each)
constexpr int kThreads = 256;  // 8 warps; warp w owns rows 8w .. 8w+7
constexpr int kPts = 8;        // rows per thread
constexpr int kKT = 16;        // weight rows per shared-memory stage
constexpr int kHMax = 512;     // widest padded layer the tile holds
constexpr int kChunk = 64;     // dW rows per pass of dw_product
constexpr float kInvSqrt2 = 0.70710678118654752440f;

// wt_off[l]: element offset of layer l's transposed hidden-input matrix
// (n x k) in the transposed buffer, -1 where the layer has none.

__host__ __device__ constexpr size_t smem_floats() {
  return size_t(kRows) * kHMax + kRows * 4 + kRows * 2;  // H, coords, seeds
}
constexpr size_t kSmem = smem_floats() * sizeof(float) + 2 * size_t(kKT) * kHMax * sizeof(float);
static_assert(2 * size_t(kKT) * kHMax >= 2 * size_t(kRows) * kChunk,
              "the weight stages also hold dw_product's two stash chunks");
static_assert(kHMax == hopper::kHMax, "both routines take the same widths");

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
template <int NQ>
__device__ __forceinline__ void coord_rows(float (&acc)[kPts][4 * NQ], const float* xs,
                                           const float* __restrict__ Wx, int d_in) {
  constexpr int n = 128 * NQ;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = 0; r < d_in; ++r) {
    float w[4 * NQ];
#pragma unroll
    for (int q = 0; q < NQ; ++q) load4(Wx + r * n + 128 * q + 4 * lane, &w[4 * q]);
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
template <int NQ>
__device__ __forceinline__ void tile_gemm(float (&acc)[kPts][4 * NQ], const float* H,
                                          const float* __restrict__ W, int k, float* Ws) {
  constexpr int n = 128 * NQ;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nk = k / kKT;
  constexpr int stage_bytes = kKT * n * static_cast<int>(sizeof(float));
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

// dx[i][r] += scale * sum_n H[row i][n] * Wx[r][n]  (the cotangent's product
// with the coordinate rows, transposed); every lane ends with the full sums.
template <int NQ>
__device__ __forceinline__ void coord_back(float (&dx)[kPts][4], const float* H,
                                           const float* __restrict__ Wx, int d_in, float scale) {
  constexpr int n = 128 * NQ;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = 0; r < d_in; ++r) {
    float w[4 * NQ];
#pragma unroll
    for (int q = 0; q < NQ; ++q) load4(Wx + r * n + 128 * q + 4 * lane, &w[4 * q]);
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
__device__ __forceinline__ void load_head(float* wv, const float* __restrict__ Wl, int k) {
  for (int j = threadIdx.x; j < k; j += kThreads) wv[j] = Wl[static_cast<long long>(j) * 128];
}

__device__ __forceinline__ float row_dot(const float* hrow, const float* wv, int k) {
  float s = 0.f;
  for (int j = threadIdx.x & 31; j < k; j += 32) s = fmaf(hrow[j], wv[j], s);
  return warp_sum(s);
}

// ---- forward: f and grad_x f ---------------------------------------------------

template <int NQ>
__global__ void __launch_bounds__(kThreads, 1)
igr_fwd_kernel(const float* __restrict__ x, long long n_pts, int d_in,
               const long long* __restrict__ desc, const long long* __restrict__ wt_off, int n_lin,
               float beta, const float* __restrict__ W, const float* __restrict__ Wt,
               const float* __restrict__ B, float* __restrict__ stash, long long stash_rows,
               float* __restrict__ f_out, float* __restrict__ g_out) {
  constexpr int n = 128 * NQ;
  extern __shared__ float4 smem4[];
  float* H = reinterpret_cast<float*>(smem4);
  float* xs = H + kRows * kHMax;
  float* Ws = H + smem_floats();
  float* wv = Ws;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long row0 = static_cast<long long>(blockIdx.x) * kRows;
  const long long layer_stride = stash_rows * n;

  for (int e = tid; e < kRows * 4; e += kThreads) {
    const int p = e >> 2, r = e & 3;
    float v = 0.f;
    if (r < d_in && row0 + p < n_pts) v = x[(row0 + p) * d_in + r];
    xs[e] = v;
  }
  __syncthreads();

  float acc[kPts][4 * NQ];
  // primal forward over the hidden layers, stashing sigma'(z)
  for (int l = 0; l < n_lin - 1; ++l) {
    const long long* d = desc + kDesc * l;
    zero<NQ>(acc);
    if (d[5] >= 0) coord_rows<NQ>(acc, xs, W + d[5], d_in);
    if (d[0] > 0) tile_gemm<NQ>(acc, H, W + d[4], static_cast<int>(d[0]), Ws);
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
          s[c] = sigma(z, beta);
          h[c] = act(z, beta);
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
  load_head(wv, W + dl[4], hk);
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
      const float* srow = S + (row0 + p) * n;
      // each lane rewrites only the columns it read in row_dot
      for (int j = lane; j < hk; j += 32) hrow[j] = seed * wv[j] * srow[j];
    }
  }
  __syncthreads();

  // reverse sweep: H holds the cotangent dz of layer l's output
  float dx[kPts][4];
#pragma unroll
  for (int i = 0; i < kPts; ++i)
#pragma unroll
    for (int r = 0; r < 4; ++r) dx[i][r] = 0.f;
  for (int l = n_lin - 2; l >= 1; --l) {
    const long long* d = desc + kDesc * l;
    const float scale = d[2] != 0 ? kInvSqrt2 : 1.f;
    if (d[5] >= 0) coord_back<NQ>(dx, H, W + d[5], d_in, scale);
    zero<NQ>(acc);
    tile_gemm<NQ>(acc, H, Wt + wt_off[l], n, Ws);
    const float* S = stash + (l - 1) * layer_stride;
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const int o = 128 * q + 4 * lane;
#pragma unroll
      for (int i = 0; i < kPts; ++i) {
        const int p = warp * kPts + i;
        const float4 s = *reinterpret_cast<const float4*>(S + (row0 + p) * n + o);
        *reinterpret_cast<float4*>(H + p * kHMax + o) = make_float4(
            acc[i][4 * q] * scale * s.x, acc[i][4 * q + 1] * scale * s.y,
            acc[i][4 * q + 2] * scale * s.z, acc[i][4 * q + 3] * scale * s.w);
      }
    }
    __syncthreads();
  }
  coord_back<NQ>(dx, H, W + desc[5], d_in, 1.f);
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
// the stash of the layer below (device memory, row stride n), H the
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
// db of that layer takes dz; H gets both. (A and the
// stash chunks of dw_product were written by this kernel: no __restrict__ on
// them, so their loads stay on the coherent path.)
template <int NQ>
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
          dz[0], dz[1], dz[2], dz[3]);
      *reinterpret_cast<float4*>(H + rt * kHMax + o) = make_float4(
          dt[0], dt[1], dt[2], dt[3]);
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) atomicAdd(gb + o + c, db[c]);
  }
}

template <int NQ>
__global__ void __launch_bounds__(kThreads, 1)
igr_bwd_kernel(const float* __restrict__ x, const float* __restrict__ a, const float* __restrict__ cvec,
               long long n_pts, int d_in, const long long* __restrict__ desc,
               const long long* __restrict__ wt_off, int n_lin, float beta,
               const float* __restrict__ W, const float* __restrict__ Wt, const float* __restrict__ B,
               float* __restrict__ stash, long long stash_rows,
               float* __restrict__ gW, float* __restrict__ gB) {
  constexpr int n = 128 * NQ;
  constexpr int kHalf = kPts / 2;
  extern __shared__ float4 smem4[];
  float* H = reinterpret_cast<float*>(smem4);
  float* xs = H + kRows * kHMax;
  float* seed = xs + kRows * 4;  // seeds per tile row
  float* Ws = H + smem_floats();
  float* wv = Ws;
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
    xs[e] = v;
  }
  __syncthreads();

  float acc[kPts][4 * NQ];
  // rematerialise both chains, stashing [act(z); tcz * s] per hidden layer
  for (int l = 0; l < n_lin - 1; ++l) {
    const long long* d = desc + kDesc * l;
    zero<NQ>(acc);
    if (d[5] >= 0) coord_rows<NQ>(acc, xs, W + d[5], d_in);
    if (d[0] > 0) tile_gemm<NQ>(acc, H, W + d[4], static_cast<int>(d[0]), Ws);
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
          h[c] = act(z, beta);
          tc[c] = tcz * sigma(z, beta);
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
  load_head(wv, W + dl[4], hk);
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
        } else {  // f = tanh z, g = Tcz (1 - f^2)
          const float t = tanhf(z), fp = 1.f - t * t;
          dz = ap * fp - 2.f * t * fp * tz;
          dt = fp;
        }
      }
      db_last += dz;
      if (lane == 0) {
        seed[rp] = dz;
        seed[rt] = dt;
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
  reverse_epilogue<NQ>(acc, 1.f, beta, stash + (n_lin - 2) * layer_stride + row0 * n, H,
                           gB + desc[kDesc * (n_lin - 2) + 3]);
  __syncthreads();

  // reverse sweep: H holds [dz; dtcz] of layer l
  for (int l = n_lin - 2; l >= 1; --l) {
    const long long* d = desc + kDesc * l;
    const float scale = d[2] != 0 ? kInvSqrt2 : 1.f;
    const float* A = stash + (l - 1) * layer_stride + row0 * n;
    dw_product<NQ>(A, H, gW + d[4], scale, Ws);
    if (d[5] >= 0) dwx_product(xs, H, gW + d[5], d_in, n, scale);
    zero<NQ>(acc);
    tile_gemm<NQ>(acc, H, Wt + wt_off[l], n, Ws);
    reverse_epilogue<NQ>(acc, scale, beta, A, H, gB + desc[kDesc * (l - 1) + 3]);
    __syncthreads();
  }
  dwx_product(xs, H, gW + desc[5], d_in, n, 1.f);
}

}  // namespace simt

// =============================================================================
// bf16: the tensor-core routine
// =============================================================================

namespace tc {

using namespace hopper;

constexpr int kCtaTiles = 2;                          // 64-row tiles per CTA, one per consumer warpgroup
constexpr int kThreads = 3 * kWgThreads;              // producer + two consumers
constexpr int kFwdCtaPts = kCtaTiles * kRows;         // forward: 128 points per CTA
constexpr int kTilePts = kRows / 2;                   // backward: 32 points per tile, two rows each
constexpr int kBwdCtaPts = kCtaTiles * kTilePts;      // 64
constexpr int kPairs = kChunkN / 4;                   // packed pairs a thread holds of a chunk
constexpr long long kImgBlock = kRows * kKBlock;      // elements of one 64 x 64 image block

// Shared memory of igr_fwd and igr_bwd (from a 1024-byte aligned base):
//   H[2]   each consumer's 64 x kHMax bf16 tile (act_offset's image)
//   ring   kStages weight stages from FusedNet.igr_tiles
//   xs     128 x 4 f32 coordinates (bf16 values): a row's x, or c for a
//          tangent row of the backward; igr_fwd then keeps dx there
//   dbs    igr_bwd: per consumer 4 warps x kHMax column sums of dz
//   seeds  igr_bwd: per consumer the 64 rows' rounded seeds
//   park   per consumer the finished chunks of a layer that wait in shared
//          memory rather than registers (chunked_layer): kFwdPark / kBwdPark
//          of them, what the registers cannot hold beside the epilogue's
//   full, empty  the ring's mbarriers
constexpr int kFwdPark = 3;
constexpr int kBwdPark = 2;
constexpr size_t kParkBytes = size_t(kChunkN / 4) * kWgThreads * sizeof(uint32_t);  // a chunk: 8 KB
constexpr size_t kOffRing = size_t(kCtaTiles) * kHBytes;
constexpr size_t kOffX = kOffRing + size_t(kStages) * kStageBytes;
constexpr size_t kOffTail = kOffX + size_t(kCtaTiles) * kRows * 4 * sizeof(float);
constexpr size_t kFwdOffPark = kOffTail;
constexpr size_t kFwdOffBar = kFwdOffPark + size_t(kCtaTiles) * kFwdPark * kParkBytes;
constexpr size_t kFwdSmem = kFwdOffBar + 2 * kStages * sizeof(uint64_t) + 1024;  // + alignment slack
constexpr size_t kOffDb = kOffTail;
constexpr size_t kOffSeed = kOffDb + size_t(kCtaTiles) * 4 * kHMax * sizeof(float);
constexpr size_t kBwdOffPark = kOffSeed + size_t(kCtaTiles) * kRows * sizeof(float);
constexpr size_t kBwdOffBar = kBwdOffPark + size_t(kCtaTiles) * kBwdPark * kParkBytes;
constexpr size_t kBwdSmem = kBwdOffBar + 2 * kStages * sizeof(uint64_t) + 1024;
static_assert(kFwdSmem <= 232448 && kBwdSmem <= 232448, "shared memory of a block");

// the backward's workspace: per tile T (64 rows) and image set, blocks of
// 64 rows x 64 columns in act_offset's image. Sets, each (tiles x blocks):
// [act(z); tcz s] of hidden layers 0 .. n_lin - 2 (hb = h_pad / 64 blocks
// each), [x; c] (1 block: columns 0 .. d_in - 1), the rounded [dz; dtcz] of
// layers 0 .. n_lin - 2 (hb blocks) and of the last layer (2 blocks:
// column 0). Block fb of tile T of a set that starts at `base` blocks per
// tile and has `blocks` per tile: element (base tiles + T blocks + fb) *
// kImgBlock. fused_igr.py _workspace_sets computes the same.
struct Sets {
  int hb, n_lin;
  __device__ __forceinline__ int stash(int l) const { return l * hb; }
  __device__ __forceinline__ int coords() const { return (n_lin - 1) * hb; }
  __device__ __forceinline__ int cot(int l) const { return (n_lin - 1) * hb + 1 + l * hb; }
};

__device__ __forceinline__ __nv_bfloat16* tile_image(__nv_bfloat16* ws, long long tiles, int base, int blocks,
                                                     long long T) {
  return ws + (static_cast<long long>(base) * tiles + T * blocks) * kImgBlock;
}

// producer (one thread): the stages of FusedNet.igr_tiles in the order both
// kernels take them: the forward products of layers 1 .. n_lin - 1 (the
// last one kLastRows rows), then the reverse products of layers n_lin - 2
// .. 1 (k / 64 chunks of n / 64 stages each)
__device__ __forceinline__ void produce_igr(const long long* desc, int n_lin, Ring& ring,
                                            const __nv_bfloat16* tiles) {
  const uint8_t* src = reinterpret_cast<const uint8_t*>(tiles);
  for (int l = 1; l < n_lin; ++l) {
    const int k = static_cast<int>(desc[kDesc * l]), n = static_cast<int>(desc[kDesc * l + 1]);
    const bool last = l == n_lin - 1;
    src = produce(ring, src, (last ? kLastRows : kChunkN) * kKBlock * 2,
                  (last ? 1 : n / kChunkN) * (k / kKBlock));
  }
  for (int l = n_lin - 2; l >= 1; --l) {
    const int k = static_cast<int>(desc[kDesc * l]), n = static_cast<int>(desc[kDesc * l + 1]);
    src = produce(ring, src, kStageBytes, (k / kChunkN) * (n / kKBlock));
  }
}

// the CTA's ring; a kernel then sends warpgroup 0 to produce_warpgroup and
// raises the consumers' registers right after that branch, so that every
// consumer instruction lies under setmaxnreg's increase
__device__ __forceinline__ Ring setup_ring(uint8_t* smem, size_t bars) {
  Ring ring = ring_init(smem + kOffRing, reinterpret_cast<uint64_t*>(smem + bars), kCtaTiles, threadIdx.x == 0);
  __syncthreads();  // barriers and coordinates ready
  return ring;
}

__device__ __forceinline__ void produce_warpgroup(const long long* desc, int n_lin, Ring& ring,
                                                  const __nv_bfloat16* tiles) {
  regs_decrease<kProducerRegs>();
  if (threadIdx.x == 0) produce_igr(desc, n_lin, ring, tiles);
}

template <bool kSoftplus>
__device__ __forceinline__ float act(float z, float beta, float rb) {
  if constexpr (kSoftplus) {
    return softplus_rel(z, beta, rb);
  } else {
    return fmaxf(z, 0.f);
  }
}
template <bool kSoftplus>
__device__ __forceinline__ float act_grad(float z, float beta) {
  if constexpr (kSoftplus) {
    return sigmoid_fast(z, beta);
  } else {
    return z > 0.f ? 1.f : 0.f;
  }
}

// dz W_x^T of one layer, the thread's share: dxp[h][r] += d0 W_x[r][col] +
// d1 W_x[r][col + 1] for row r0 + 8 h; dx_finish sums a row's columns over
// the quad and adds the layer's term, dx += (sum) * scale, in f32
__device__ __forceinline__ void dx_partial(float (&dxp)[2][4], const LayerArgs& L, int col, int h, float d0,
                                           float d1) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    if (r < L.d_in) {
      const __nv_bfloat162 w = *reinterpret_cast<const __nv_bfloat162*>(L.wx + r * L.n + col);
      dxp[h][r] = __fmaf_rn(d0, __low2float(w), dxp[h][r]);
      dxp[h][r] = __fmaf_rn(d1, __high2float(w), dxp[h][r]);
    }
  }
}
// dx (rows r0, r0 + 8 at dx[0], dx[32]) is kept in shared memory, by
// the quad's first thread
__device__ __forceinline__ void dx_finish(float (&dxp)[2][4], float* dx, const LayerArgs& L, bool first) {
  const float scale = L.skip ? kInvSqrt2 : 1.f;
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float v = dxp[h][r];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      if (first) dx[32 * h + r] = __fadd_rn(dx[32 * h + r], __fmul_rn(v, scale));
      dxp[h][r] = 0.f;
    }
}

// ---- igr_fwd: f and grad_x f ---------------------------------------------------

// stash: (n_lin - 1) layers x (CTAs x 2) tiles x kChunks chunks x kPairs x
// 128 threads of packed bf16 pairs of sigma(z), each thread's own
template <int NQ, bool kSoftplus>
__global__ void __launch_bounds__(kThreads, 1)
igr_fwd_kernel(const float* __restrict__ x, long long n_pts, int d_in, const long long* __restrict__ desc,
               int n_lin, float beta, const __nv_bfloat16* __restrict__ W, const float* __restrict__ B,
               const __nv_bfloat16* __restrict__ tiles, uint32_t* __restrict__ stash,
               float* __restrict__ f_out, float* __restrict__ g_out) {
  constexpr int kChunks = NQ * 128 / kChunkN;
  extern __shared__ uint8_t igr_smem_raw[];
  uint8_t* smem = aligned_smem(igr_smem_raw);
  float* xs = reinterpret_cast<float*>(smem + kOffX);
  const long long p0 = static_cast<long long>(blockIdx.x) * kFwdCtaPts;
  for (int e = threadIdx.x; e < kFwdCtaPts * 4; e += kThreads) {
    const int p = e >> 2, r = e & 3;
    float v = 0.f;
    if (r < d_in && p0 + p < n_pts) v = x[(p0 + p) * d_in + r];
    xs[e] = bf16_rne(v);
  }
  Ring ring = setup_ring(smem, kFwdOffBar);
  if (threadIdx.x < kWgThreads) {
    produce_warpgroup(desc, n_lin, ring, tiles);
    return;
  }
  regs_increase<kConsumerRegs>();
  const int c = threadIdx.x / kWgThreads - 1;  // consumer 0 or 1: rows 64 c .. 64 c + 63
  uint32_t* park = reinterpret_cast<uint32_t*>(smem + kFwdOffPark + c * kFwdPark * kParkBytes);
  const int lt = threadIdx.x - (c + 1) * kWgThreads;
  const int lane = lt & 31;
  const int r0 = 16 * (lt >> 5) + (lane >> 2), cq = 2 * (lane & 3);
  uint8_t* H = smem + c * kHBytes;
  float xy[2][4];  // the coordinates of rows r0 and r0 + 8
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int r = 0; r < 4; ++r) xy[h][r] = xs[(kRows * c + r0 + 8 * h) * 4 + r];
  const long long tiles_all = static_cast<long long>(gridDim.x) * kCtaTiles;
  const long long tile = static_cast<long long>(blockIdx.x) * kCtaTiles + c;
  auto sigma_at = [&](int l, int ch, int i) {
    return stash + (((l * tiles_all + tile) * kChunks + ch) * kPairs + i) * kWgThreads + lt;
  };
  const float rb = beta > 0.f ? __frcp_rn(beta) : 0.f;

  // primal forward over the hidden layers, stashing sigma(z)
  for (int l = 0; l < n_lin - 1; ++l) {
    const LayerArgs L = layer_args(desc, l, d_in, beta, rb, W, B);
    chunked_layer<kChunks, kFwdPark>(H, L.k / kKBlock, ring, 1 + c, lt, [](int) {},
                           [&](int ch, const float (&acc)[kAcc], auto sink) {
#pragma unroll
      for (int j = 0; j < kChunkN / 8; ++j) {
        float v[2][2] = {{acc[4 * j], acc[4 * j + 1]}, {acc[4 * j + 2], acc[4 * j + 3]}};
        column_pair(L, kChunkN * ch + 8 * j + cq, xy, v);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          sink(j, h, pack_bf16x2(bf16_rne(act<kSoftplus>(v[h][0], beta, rb)),
                                 bf16_rne(act<kSoftplus>(v[h][1], beta, rb))));
          *sigma_at(l, ch, 2 * j + h) = pack_bf16x2(bf16_rne(act_grad<kSoftplus>(v[h][0], beta)),
                                                    bf16_rne(act_grad<kSoftplus>(v[h][1], beta)));
        }
      }
    }, park);
  }

  // head: z = h . w + b (column 0 of an m64n8k16 product); f = z or tanh z;
  // the rounded seed of the reverse sweep, broadcast over the quad
  const LayerArgs Lh = layer_args(desc, n_lin - 1, d_in, beta, rb, W, B);
  float acc4[4];
  mma_stream(acc4, H, Lh.k / kKBlock, ring, lt == 0);
  float seed[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float z = __fadd_rn(acc4[2 * h], __ldg(Lh.bias));
    const float f = kSoftplus ? z : tanhf(z);
    const long long p = p0 + kRows * c + r0 + 8 * h;
    if ((lane & 3) == 0 && p < n_pts) f_out[p] = f;
    const float s = kSoftplus ? 1.f : __fsub_rn(1.f, __fmul_rn(f, f));
    seed[h] = __shfl_sync(0xffffffffu, bf16_rne(s), lane & ~3);
  }

  // the head's reverse step: dz = seed * w * sigma(z) of the last hidden
  // layer, elementwise, into H. dx of the tile's rows takes the place of
  // their coordinates in xs (already in registers)
  float* dx = xs + (kRows * c + r0) * 4;
  if ((lane & 3) == 0) {
#pragma unroll
    for (int r = 0; r < 4; ++r) dx[r] = dx[32 + r] = 0.f;
  }
  float dxp[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
  {
    const LayerArgs Lp = layer_args(desc, n_lin - 2, d_in, beta, rb, W, B);
    const __nv_bfloat16* wl = W + desc[kDesc * (n_lin - 1) + 4];  // k x 128, column 0 live
    named_barrier(1 + c, kWgThreads);  // the head's products have read H
#pragma unroll 1
    for (int ch = 0; ch < kChunks; ++ch) {
#pragma unroll
      for (int j = 0; j < kChunkN / 8; ++j) {
        const int col = kChunkN * ch + 8 * j + cq;
        const float w0 = __bfloat162float(wl[col * 128]), w1 = __bfloat162float(wl[(col + 1) * 128]);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint32_t s = *sigma_at(n_lin - 2, ch, 2 * j + h);
          const float d0 = bf16_rne(__fmul_rn(__fmul_rn(seed[h], w0), bf16_lo(s)));
          const float d1 = bf16_rne(__fmul_rn(__fmul_rn(seed[h], w1), bf16_hi(s)));
          if (Lp.wx != nullptr) dx_partial(dxp, Lp, col, h, d0, d1);
          *reinterpret_cast<uint32_t*>(H + act_offset(r0 + 8 * h, col)) = pack_bf16x2(d0, d1);
        }
      }
    }
    if (Lp.wx != nullptr) dx_finish(dxp, dx, Lp, (lane & 3) == 0);
    fence_proxy_async();
    named_barrier(1 + c, kWgThreads);
  }

  // reverse sweep: H holds the rounded dz of layer l; dz of layer l - 1 =
  // (dz W_l^T) * scale * sigma(z of layer l - 1)
  for (int l = n_lin - 2; l >= 1; --l) {
    const long long* d = desc + kDesc * l;
    const float scale = d[2] != 0 ? kInvSqrt2 : 1.f;
    const LayerArgs Lp = layer_args(desc, l - 1, d_in, beta, rb, W, B);
    uint32_t sg[kPairs];
    chunked_layer<kChunks, kFwdPark>(
        H, static_cast<int>(d[1]) / kKBlock, ring, 1 + c, lt,
        [&](int ch) {
#pragma unroll
          for (int i = 0; i < kPairs; ++i) sg[i] = *sigma_at(l - 1, ch, i);
        },
        [&](int ch, const float (&acc)[kAcc], auto sink) {
#pragma unroll
          for (int j = 0; j < kChunkN / 8; ++j) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const uint32_t s = sg[2 * j + h];
              const float d0 = bf16_rne(__fmul_rn(__fmul_rn(acc[4 * j + 2 * h], scale), bf16_lo(s)));
              const float d1 = bf16_rne(__fmul_rn(__fmul_rn(acc[4 * j + 2 * h + 1], scale), bf16_hi(s)));
              if (Lp.wx != nullptr) dx_partial(dxp, Lp, kChunkN * ch + 8 * j + cq, h, d0, d1);
              sink(j, h, pack_bf16x2(d0, d1));
            }
          }
        }, park);
    if (Lp.wx != nullptr) dx_finish(dxp, dx, Lp, (lane & 3) == 0);
  }
  if ((lane & 3) == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long p = p0 + kRows * c + r0 + 8 * h;
#pragma unroll
      for (int r = 0; r < 4; ++r)
        if (r < d_in && p < n_pts) g_out[p * d_in + r] = dx[32 * h + r];
    }
  }
}

// ---- igr_bwd: both chains, their reverse sweep, the workspace for dW ------------

// s = 1 - exp(-beta h) (the step of h for ReLU); dz = dh s + (dtc tc) beta
// (1 - s), dtcz = dtc s: one reverse step's coupling of the two chains
template <bool kSoftplus>
__device__ __forceinline__ void couple(float dh, float dtc, float hp, float tcp, float beta, float& dz,
                                       float& dt) {
  if constexpr (kSoftplus) {
    const float s = sigmoid_from_softplus(hp, beta);
    dz = __fadd_rn(__fmul_rn(dh, s), __fmul_rn(__fmul_rn(dtc, tcp), __fmul_rn(beta, __fsub_rn(1.f, s))));
    dt = __fmul_rn(dtc, s);
  } else {
    const float s = hp > 0.f ? 1.f : 0.f;
    dz = __fmul_rn(dh, s);
    dt = __fmul_rn(dtc, s);
  }
}

// the warpgroup's tile (n / 64 blocks of H) to its workspace image, 16 bytes a thread
__device__ __forceinline__ void copy_out(const uint8_t* H, __nv_bfloat16* dst, int n, int lt) {
  const uint4* src = reinterpret_cast<const uint4*>(H);
  uint4* out = reinterpret_cast<uint4*>(dst);
  const int count = n / kKBlock * kBlockBytes / 16;
  for (int i = lt; i < count; i += kWgThreads) out[i] = src[i];
}

// ws: the workspace (Sets); partial: (tiles x n_bias) f32, per tile and
// bias column the sum of dz over the tile's points
template <int NQ, bool kSoftplus>
__global__ void __launch_bounds__(kThreads, 1)
igr_bwd_kernel(const float* __restrict__ x, const float* __restrict__ a, const float* __restrict__ cvec,
               long long n_pts, int d_in, const long long* __restrict__ desc, int n_lin, float beta,
               const __nv_bfloat16* __restrict__ W, const float* __restrict__ B,
               const __nv_bfloat16* __restrict__ tiles, __nv_bfloat16* ws, float* __restrict__ partial,
               int n_bias) {
  constexpr int kChunks = NQ * 128 / kChunkN;
  constexpr int n = NQ * 128;
  extern __shared__ uint8_t igr_smem_raw[];
  uint8_t* smem = aligned_smem(igr_smem_raw);
  float* xs = reinterpret_cast<float*>(smem + kOffX);
  // row r of tile c: point 32 T + 8 (r / 16) + r % 8, its x for r % 16 < 8,
  // its c otherwise
  for (int e = threadIdx.x; e < kCtaTiles * kRows * 4; e += kThreads) {
    const int row = e >> 2, k = e & 3, r = row % kRows;
    const long long p = (static_cast<long long>(blockIdx.x) * kCtaTiles + row / kRows) * kTilePts +
                        8 * (r >> 4) + (r & 7);
    const float* src = (r & 8) ? cvec : x;
    float v = 0.f;
    if (k < d_in && p < n_pts) v = src[p * d_in + k];
    xs[e] = bf16_rne(v);
  }
  Ring ring = setup_ring(smem, kBwdOffBar);
  if (threadIdx.x < kWgThreads) {
    produce_warpgroup(desc, n_lin, ring, tiles);
    return;
  }
  regs_increase<kConsumerRegs>();
  const int c = threadIdx.x / kWgThreads - 1;  // consumer 0 or 1: tile 2 blockIdx.x + c
  uint32_t* park = reinterpret_cast<uint32_t*>(smem + kBwdOffPark + c * kBwdPark * kParkBytes);
  const int lt = threadIdx.x - (c + 1) * kWgThreads;
  const int warp = lt >> 5, lane = lt & 31;
  const int r0 = 16 * warp + (lane >> 2), cq = 2 * (lane & 3);
  uint8_t* H = smem + c * kHBytes;
  const float* xsc = xs + kRows * c * 4;
  float xy[2][4];  // the point's x (primal row r0) and c (tangent row r0 + 8)
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int r = 0; r < 4; ++r) xy[h][r] = xsc[(r0 + 8 * h) * 4 + r];
  const long long tiles_all = static_cast<long long>(gridDim.x) * kCtaTiles;
  const long long T = static_cast<long long>(blockIdx.x) * kCtaTiles + c;
  const long long point = T * kTilePts + 8 * warp + (lane >> 2);
  const Sets sets{kChunks, n_lin};
  const float rb = beta > 0.f ? __frcp_rn(beta) : 0.f;
  float* dbs = reinterpret_cast<float*>(smem + kOffDb) + c * 4 * kHMax;
  float* seeds = reinterpret_cast<float*>(smem + kOffSeed) + c * kRows;
  float* part = partial + T * n_bias;

  // db: the tile's sum of dz at the thread's column, over its 32 points
  // (shuffles over the 8 row groups of the warp, then the 4 warps in order)
  auto db_add = [&](int col, float v) {
    v += __shfl_xor_sync(0xffffffffu, v, 4);
    v += __shfl_xor_sync(0xffffffffu, v, 8);
    v += __shfl_xor_sync(0xffffffffu, v, 16);
    if (lane < 4) dbs[warp * kHMax + col] = v;
  };
  auto db_finish = [&](int b_off, int width) {  // after a barrier of the warpgroup
    for (int col = lt; col < width; col += kWgThreads) {
      const float s = __fadd_rn(__fadd_rn(__fadd_rn(dbs[col], dbs[kHMax + col]), dbs[2 * kHMax + col]),
                                dbs[3 * kHMax + col]);
      part[b_off + col] = s;
    }
    named_barrier(1 + c, kWgThreads);  // dbs is written again by the next layer
  };

  // the [x; c] image: 64 rows x 64 columns, the coordinates in columns 0 .. 3
  {
    uint4* X = reinterpret_cast<uint4*>(tile_image(ws, tiles_all, sets.coords(), 1, T));
    for (int i = lt; i < kRows * 8; i += kWgThreads) {
      const int row = i >> 3, g = i & 7;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if ((g ^ (row & 7)) == 0) {
        const float* xr = xsc + row * 4;
        v.x = pack_bf16x2(xr[0], xr[1]);
        v.y = pack_bf16x2(xr[2], xr[3]);
      }
      X[i] = v;
    }
  }

  // rematerialise both chains: [act(z); tcz sigma(z)] per hidden layer
  for (int l = 0; l < n_lin - 1; ++l) {
    const LayerArgs L = layer_args(desc, l, d_in, beta, rb, W, B);
    chunked_layer<kChunks, kBwdPark>(H, L.k / kKBlock, ring, 1 + c, lt, [](int) {},
                           [&](int ch, const float (&acc)[kAcc], auto sink) {
#pragma unroll
      for (int j = 0; j < kChunkN / 8; ++j) {
        float v[2][2] = {{acc[4 * j], acc[4 * j + 1]}, {acc[4 * j + 2], acc[4 * j + 3]}};
        column_pair<true>(L, kChunkN * ch + 8 * j + cq, xy, v);  // v[0] = z, v[1] = tcz
        float hv[2], tv[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          hv[e] = bf16_rne(act<kSoftplus>(v[0][e], beta, rb));
          tv[e] = bf16_rne(__fmul_rn(v[1][e], act_grad<kSoftplus>(v[0][e], beta)));
        }
        sink(j, 0, pack_bf16x2(hv[0], hv[1]));
        sink(j, 1, pack_bf16x2(tv[0], tv[1]));
      }
    }, park);
    copy_out(H, tile_image(ws, tiles_all, sets.stash(l), kChunks, T), n, lt);
  }

  // head: (z, Tcz) of the last layer and the seeds on them
  const LayerArgs Lh = layer_args(desc, n_lin - 1, d_in, beta, rb, W, B);
  float acc4[4];
  mma_stream(acc4, H, Lh.k / kKBlock, ring, lt == 0);
  float dz = 0.f, dt = 0.f;
  if (point < n_pts) {
    const float ap = __ldg(a + point);
    if constexpr (kSoftplus) {
      dz = ap;
      dt = 1.f;
    } else {  // f = tanh z, g = Tcz (1 - f^2), (z, Tcz) rounded as the TPU kernel stashes them
      const float z = bf16_rne(__fadd_rn(acc4[0], __ldg(Lh.bias))), tz = bf16_rne(acc4[2]);
      const float t = tanhf(z), fp = __fsub_rn(1.f, __fmul_rn(t, t));
      dz = __fsub_rn(__fmul_rn(ap, fp), __fmul_rn(__fmul_rn(__fmul_rn(2.f, t), fp), tz));
      dt = fp;
    }
  }
  dz = __shfl_sync(0xffffffffu, dz, lane & ~3);  // column 0 is the quad leader's
  dt = __shfl_sync(0xffffffffu, dt, lane & ~3);
  db_add(0, dz);
  const float sd = bf16_rne(dz), st = bf16_rne(dt);
  if ((lane & 3) == 0) {
    seeds[r0] = sd;
    seeds[r0 + 8] = st;
  }
  named_barrier(1 + c, kWgThreads);  // the head's products have read H; dbs, seeds written
  {
    const int b_last = static_cast<int>(desc[kDesc * (n_lin - 1) + 3]);
    for (int col = lt; col < 128; col += kWgThreads)
      part[b_last + col] =
          col == 0 ? __fadd_rn(__fadd_rn(__fadd_rn(dbs[0], dbs[kHMax]), dbs[2 * kHMax]), dbs[3 * kHMax]) : 0.f;
    // the last layer's [dz; dtcz] image: the rounded seeds in column 0
    uint4* C = reinterpret_cast<uint4*>(tile_image(ws, tiles_all, sets.cot(n_lin - 1), 2, T));
    for (int i = lt; i < 2 * kRows * 8; i += kWgThreads) {
      const int row = (i >> 3) % kRows, g = i & 7;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (i < kRows * 8 && g == (row & 7)) v.x = pack_bf16x2(seeds[row], 0.f);
      C[i] = v;
    }
  }
  named_barrier(1 + c, kWgThreads);  // dbs is written again below

  // the head's reverse step: [dh; dtc] = seeds (outer) w, into the last
  // hidden layer's cotangents, in place of its [h; tc] in H
  {
    const __nv_bfloat16* wl = W + desc[kDesc * (n_lin - 1) + 4];  // k x 128, column 0 live
#pragma unroll 1
    for (int ch = 0; ch < kChunks; ++ch) {
#pragma unroll
      for (int j = 0; j < kChunkN / 8; ++j) {
        const int col = kChunkN * ch + 8 * j + cq;
        const float w[2] = {__bfloat162float(wl[col * 128]), __bfloat162float(wl[(col + 1) * 128])};
        uint32_t* hp = reinterpret_cast<uint32_t*>(H + act_offset(r0, col));
        uint32_t* tp = reinterpret_cast<uint32_t*>(H + act_offset(r0 + 8, col));
        const float hv[2] = {bf16_lo(*hp), bf16_hi(*hp)}, tv[2] = {bf16_lo(*tp), bf16_hi(*tp)};
        float z[2], t[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          couple<kSoftplus>(__fmul_rn(sd, w[e]), __fmul_rn(st, w[e]), hv[e], tv[e], beta, z[e], t[e]);
          db_add(col + e, z[e]);
        }
        *hp = pack_bf16x2(bf16_rne(z[0]), bf16_rne(z[1]));
        *tp = pack_bf16x2(bf16_rne(t[0]), bf16_rne(t[1]));
      }
    }
    fence_proxy_async();
    named_barrier(1 + c, kWgThreads);
    db_finish(static_cast<int>(desc[kDesc * (n_lin - 2) + 3]), n);
    copy_out(H, tile_image(ws, tiles_all, sets.cot(n_lin - 2), kChunks, T), n, lt);
  }

  // reverse sweep: H holds the rounded [dz; dtcz] of layer l; the stashed
  // [h; tc] of layer l - 1 is read back from the workspace
  for (int l = n_lin - 2; l >= 1; --l) {
    const long long* d = desc + kDesc * l;
    const float scale = d[2] != 0 ? kInvSqrt2 : 1.f;
    const uint8_t* S = reinterpret_cast<const uint8_t*>(tile_image(ws, tiles_all, sets.stash(l - 1), kChunks, T));
    uint32_t hs[kChunkN / 8], ts[kChunkN / 8];
    chunked_layer<kChunks, kBwdPark>(
        H, static_cast<int>(d[1]) / kKBlock, ring, 1 + c, lt,
        [&](int ch) {
#pragma unroll
          for (int j = 0; j < kChunkN / 8; ++j) {
            hs[j] = *reinterpret_cast<const uint32_t*>(S + act_offset(r0, kChunkN * ch + 8 * j + cq));
            ts[j] = *reinterpret_cast<const uint32_t*>(S + act_offset(r0 + 8, kChunkN * ch + 8 * j + cq));
          }
        },
        [&](int ch, const float (&acc)[kAcc], auto sink) {
#pragma unroll
          for (int j = 0; j < kChunkN / 8; ++j) {
            const float hv[2] = {bf16_lo(hs[j]), bf16_hi(hs[j])}, tv[2] = {bf16_lo(ts[j]), bf16_hi(ts[j])};
            float z[2], t[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              couple<kSoftplus>(__fmul_rn(acc[4 * j + e], scale), __fmul_rn(acc[4 * j + 2 + e], scale), hv[e],
                                tv[e], beta, z[e], t[e]);
              db_add(kChunkN * ch + 8 * j + cq + e, z[e]);
            }
            sink(j, 0, pack_bf16x2(bf16_rne(z[0]), bf16_rne(z[1])));
            sink(j, 1, pack_bf16x2(bf16_rne(t[0]), bf16_rne(t[1])));
          }
        }, park);
    db_finish(static_cast<int>(desc[kDesc * (l - 1) + 3]), n);
    copy_out(H, tile_image(ws, tiles_all, sets.cot(l - 1), kChunks, T), n, lt);
  }
}

// ---- igr_dw: dW and db from the workspace, in a fixed order -------------------

constexpr int kPlan = 10;  // int64 per job (fused_igr.py _dw_plan):
// [0] A set base, [1] A blocks per tile, [2] A block (the 64 rows of dW),
// [3] B set base, [4] B blocks per tile, [5] B block (first of the two: the
// 128 columns), [6] element offset of the tile's first output, [7] output
// row stride, [8] output rows written (<= 64), [9] skip: scale by 1/sqrt 2
constexpr int kDwStages = 6;                        // even: consumer c takes stages c, c + 2, ...
constexpr int kDwStageBytes = 3 * kBlockBytes;      // A block + two B blocks of one row tile: 24 KB
constexpr size_t kDwOffX = size_t(kDwStages) * kDwStageBytes;
constexpr size_t kDwOffBar = kDwOffX + size_t(kRows) * 2 * kChunkN * sizeof(float);
constexpr size_t kDwSmem = kDwOffBar + 2 * kDwStages * sizeof(uint64_t) + 1024;
static_assert(kDwSmem <= 232448, "shared memory of a block");

// CTAs below n_jobs: one job each; the rest: db columns, kThreads each
__global__ void __launch_bounds__(kThreads, 1)
igr_dw_kernel(const long long* __restrict__ plan, int n_jobs, const __nv_bfloat16* __restrict__ ws,
              long long tiles_all, float* __restrict__ gw, const float* __restrict__ partial, int n_bias,
              float* __restrict__ gb) {
  if (static_cast<int>(blockIdx.x) >= n_jobs) {
    const int col = (static_cast<int>(blockIdx.x) - n_jobs) * kThreads + threadIdx.x;
    if (col < n_bias) {
      float s = 0.f;
      for (long long t = 0; t < tiles_all; ++t) s = __fadd_rn(s, partial[t * n_bias + col]);
      gb[col] = s;
    }
    return;
  }
  extern __shared__ uint8_t igr_smem_raw[];
  uint8_t* smem = aligned_smem(igr_smem_raw);
  const long long* J = plan + kPlan * blockIdx.x;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kDwOffBar);
  uint64_t* empty = full + kDwStages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kDwStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 1);
    }
    fence_barrier_init();
  }
  __syncthreads();
  const int wg = threadIdx.x / kWgThreads;
  if (wg == 0) {
    regs_decrease<kProducerRegs>();
    if (threadIdx.x == 0) {
      const __nv_bfloat16* A = ws + (J[0] * tiles_all + J[2]) * kImgBlock;
      const __nv_bfloat16* Bm = ws + (J[3] * tiles_all + J[5]) * kImgBlock;
      for (long long T = 0; T < tiles_all; ++T) {
        const int s = static_cast<int>(T % kDwStages);
        mbar_wait(&empty[s], static_cast<uint32_t>((T / kDwStages) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[s], kDwStageBytes);
        uint8_t* st = smem + s * kDwStageBytes;
        bulk_load(st, A + T * J[1] * kImgBlock, kBlockBytes, &full[s]);
        bulk_load(st + kBlockBytes, Bm + T * J[4] * kImgBlock, 2 * kBlockBytes, &full[s]);
      }
    }
    return;
  }
  regs_increase<kConsumerRegs>();
  const int c = wg - 1, lt = threadIdx.x - wg * kWgThreads;
  float acc[2][kAcc];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[h][i] = 0.f;
  for (long long T = c; T < tiles_all; T += kCtaTiles) {
    const int s = static_cast<int>(T % kDwStages);
    mbar_wait(&full[s], static_cast<uint32_t>((T / kDwStages) & 1));
    const uint8_t* st = smem + s * kDwStageBytes;
    float part[2][kAcc];
    wgmma_fence();
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int kk = 0; kk < kRows / 16; ++kk)  // the tile's 64 rows, 16 at a time
        wgmma_m64n64k16<1, 1>(part[h], desc_mn_sw128(st + 2048 * kk, kBlockBytes),
                              desc_mn_sw128(st + (1 + h) * kBlockBytes + 2048 * kk, kBlockBytes), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_registers(part[0]);
    fence_registers(part[1]);
    if (lt == 0) mbar_arrive(&empty[s]);
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < kAcc; ++i) acc[h][i] = __fadd_rn(acc[h][i], part[h][i]);
  }
  // the odd tiles' sums join the even ones' in shared memory, then out
  float* xch = reinterpret_cast<float*>(smem + kDwOffX);
  if (c == 1) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < kAcc; ++i) xch[(h * kAcc + i) * kWgThreads + lt] = acc[h][i];
  }
  named_barrier(1, 2 * kWgThreads);
  if (c == 1) return;
  const float scale = J[9] != 0 ? kInvSqrt2 : 1.f;
  const int rows = static_cast<int>(J[8]);
  float* out = gw + J[6];
  const long long stride = J[7];
  const int warp = lt >> 5, lane = lt & 31;
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < kAcc; i += 2) {
      const int m = 16 * warp + (lane >> 2) + 8 * ((i >> 1) & 1);
      const int col = kChunkN * h + 8 * (i >> 2) + 2 * (lane & 3);
      if (m < rows) {
        const float v0 = __fmul_rn(__fadd_rn(acc[h][i], xch[(h * kAcc + i) * kWgThreads + lt]), scale);
        const float v1 = __fmul_rn(__fadd_rn(acc[h][i + 1], xch[(h * kAcc + i + 1) * kWgThreads + lt]), scale);
        *reinterpret_cast<float2*>(out + m * stride + col) = make_float2(v0, v1);
      }
    }
}

template <class F>
cudaError_t by_width(int width, float beta, F f) {
  const bool sp = beta > 0.f;
  switch (width) {
    case 128: return sp ? f(std::integral_constant<int, 1>{}, std::true_type{}) : f(std::integral_constant<int, 1>{}, std::false_type{});
    case 256: return sp ? f(std::integral_constant<int, 2>{}, std::true_type{}) : f(std::integral_constant<int, 2>{}, std::false_type{});
    case 384: return sp ? f(std::integral_constant<int, 3>{}, std::true_type{}) : f(std::integral_constant<int, 3>{}, std::false_type{});
    case 512: return sp ? f(std::integral_constant<int, 4>{}, std::true_type{}) : f(std::integral_constant<int, 4>{}, std::false_type{});
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace tc

// ---- f32 launches -------------------------------------------------------------------

template <int NQ>
cudaError_t launch_fwd(const float* x, long long n_pts, int d_in, const long long* desc, const long long* wt_off,
                       int n_lin, float beta, const void* w, const void* wt, const float* b, float* stash,
                       long long stash_rows, float* f, float* g, cudaStream_t stream) {
  return launch(simt::igr_fwd_kernel<NQ>, (n_pts + simt::kRows - 1) / simt::kRows, simt::kThreads, simt::kSmem,
                stream, x, n_pts, d_in, desc, wt_off, n_lin, beta, static_cast<const float*>(w),
                static_cast<const float*>(wt), b, stash, stash_rows, f, g);
}

template <int NQ>
cudaError_t launch_bwd(const float* x, const float* a, const float* c, long long n_pts, int d_in,
                       const long long* desc, const long long* wt_off, int n_lin, float beta, const void* w,
                       const void* wt, const float* b, float* stash, long long stash_rows, float* gw, float* gb,
                       cudaStream_t stream) {
  return launch(simt::igr_bwd_kernel<NQ>, (n_pts + simt::kBwdPts - 1) / simt::kBwdPts, simt::kThreads,
                simt::kSmem, stream, x, a, c, n_pts, d_in, desc, wt_off, n_lin, beta, static_cast<const float*>(w),
                static_cast<const float*>(wt), b, stash, stash_rows, gw, gb);
}

}  // namespace

// ---- C interface (ctypes); each returns the cudaError_t of its launches --------
// h_pad is the padded hidden width, one of 128, 256, 384, 512 (the wrapper
// checks). f32: stash has (n_lin - 1) x stash_rows x h_pad floats with
// stash_rows >= 64 * blocks; gw and gb are zeroed by the caller. bf16: w, b
// are FusedNet.packed's buffers, tiles FusedNet.igr_tiles; the forward's
// stash holds (n_lin - 1) x CTAs x 128 x h_pad bf16; the backward's ws and
// partial are sized by fused_igr.py _workspace_sets, and gw, gb are written
// whole (no zeroing).

#define IGR_F32_DISPATCH(CALL)                                  \
  switch (h_pad / 128) {                                        \
    case 1: return CALL(1);                                     \
    case 2: return CALL(2);                                     \
    case 3: return CALL(3);                                     \
    case 4: return CALL(4);                                     \
    default: return static_cast<int>(cudaErrorInvalidValue);    \
  }

extern "C" {

// points per CTA: forward / backward, f32 / bf16
int sdf_igr_cta_points(int bf16, int backward) {
  if (bf16) return backward ? tc::kBwdCtaPts : tc::kFwdCtaPts;
  return backward ? simt::kBwdPts : simt::kRows;
}
int sdf_igr_max_width() { return hopper::kHMax; }
int sdf_igr_plan_fields() { return tc::kPlan; }
const char* sdf_igr_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

int sdf_igr_fwd_f32(const float* x, long long n_pts, int d_in, const long long* desc, const long long* wt_off,
                    int n_lin, int h_pad, float beta, const float* w, const float* wt, const float* b,
                    float* stash, long long stash_rows, float* f, float* g, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
#define IGR_FWD(Q) launch_fwd<Q>(x, n_pts, d_in, desc, wt_off, n_lin, beta, w, wt, b, stash, stash_rows, f, g, s)
  IGR_F32_DISPATCH(IGR_FWD)
#undef IGR_FWD
}

int sdf_igr_bwd_f32(const float* x, const float* a, const float* c, long long n_pts, int d_in,
                    const long long* desc, const long long* wt_off, int n_lin, int h_pad, float beta,
                    const float* w, const float* wt, const float* b, float* stash, long long stash_rows,
                    float* gw, float* gb, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
#define IGR_BWD(Q) \
  launch_bwd<Q>(x, a, c, n_pts, d_in, desc, wt_off, n_lin, beta, w, wt, b, stash, stash_rows, gw, gb, s)
  IGR_F32_DISPATCH(IGR_BWD)
#undef IGR_BWD
}

int sdf_igr_fwd_bf16(const float* x, long long n_pts, int d_in, const long long* desc, int n_lin, int h_pad,
                     float beta, const void* w, const float* b, const void* tiles, void* stash, float* f,
                     float* g, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto wb = static_cast<const __nv_bfloat16*>(w);
  auto tb = static_cast<const __nv_bfloat16*>(tiles);
  const long long ctas = (n_pts + tc::kFwdCtaPts - 1) / tc::kFwdCtaPts;
  return tc::by_width(h_pad, beta, [&](auto q, auto sp) {
    return launch(tc::igr_fwd_kernel<decltype(q)::value, decltype(sp)::value>, ctas, tc::kThreads, tc::kFwdSmem, s,
                  x, n_pts, d_in, desc, n_lin, beta, wb, b, tb, static_cast<uint32_t*>(stash), f, g);
  });
}

int sdf_igr_dw_bf16(const long long* plan, int n_jobs, const void* ws, long long tiles, float* gw,
                    const float* partial, int n_bias, float* gb, void* stream);

// igr_bwd, then igr_dw over the plan's n_jobs jobs and the db columns
int sdf_igr_bwd_bf16(const float* x, const float* a, const float* c, long long n_pts, int d_in,
                     const long long* desc, int n_lin, int h_pad, float beta, const void* w, const float* b,
                     const void* tiles, void* ws, float* partial, int n_bias, const long long* plan, int n_jobs,
                     float* gw, float* gb, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto wb = static_cast<const __nv_bfloat16*>(w);
  auto tb = static_cast<const __nv_bfloat16*>(tiles);
  auto wsb = static_cast<__nv_bfloat16*>(ws);
  const long long ctas = (n_pts + tc::kBwdCtaPts - 1) / tc::kBwdCtaPts;
  cudaError_t err = tc::by_width(h_pad, beta, [&](auto q, auto sp) {
    return launch(tc::igr_bwd_kernel<decltype(q)::value, decltype(sp)::value>, ctas, tc::kThreads, tc::kBwdSmem, s,
                  x, a, c, n_pts, d_in, desc, n_lin, beta, wb, b, tb, wsb, partial, n_bias);
  });
  if (err != cudaSuccess || ctas == 0) return static_cast<int>(err);
  return sdf_igr_dw_bf16(plan, n_jobs, ws, ctas * tc::kCtaTiles, gw, partial, n_bias, gb, stream);
}

// igr_dw alone, on a workspace the backward has written
int sdf_igr_dw_bf16(const long long* plan, int n_jobs, const void* ws, long long tiles, float* gw,
                    const float* partial, int n_bias, float* gb, void* stream) {
  const long long db_ctas = (n_bias + tc::kThreads - 1) / tc::kThreads;
  return static_cast<int>(launch(tc::igr_dw_kernel, n_jobs + db_ctas, tc::kThreads, tc::kDwSmem,
                                 static_cast<cudaStream_t>(stream), plan, n_jobs,
                                 static_cast<const __nv_bfloat16*>(ws), tiles, gw, partial, n_bias, gb));
}

}  // extern "C"
