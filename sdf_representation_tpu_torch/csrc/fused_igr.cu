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
// points in bf16.
//
// bf16: tensor cores, on the layer routine of csrc/hopper.cuh that the
// fused forward (csrc/fused_mlp.cu) runs: a producer warpgroup streams
// 64 x 64 weight stages by bulk copy (TMA) through an mbarrier ring, two
// consumer warpgroups each hold a 64-row tile of bf16 activations in shared
// memory in the 128-byte swizzled K-major image (the A operand as it
// stands), each layer runs as 64-column chunks of m64n64k16 products whose
// 32-deep sums are added in f32, and finished chunks wait until the layer's
// last products have read the tile (the in-place hazard): igr_fwd's in
// registers and shared memory (chunked_layer), igr_bwd's in the workspace
// it writes anyway (image_layer), from which the tile is read back.
//   * The routine's schedule is a pipeline (hopper.cuh, stream): two 32-deep
//     groups in flight, each group's f32 add under the next group's
//     products, a stage handed back once both its groups have completed,
//     and where the registers allow it (igr_bwd; igr_fwd below 512 columns)
//     the next chunk's first group under each chunk's epilogue. It moves no
//     arithmetic: every tensor-core sum has the same operands and depth,
//     the adds are the same f32 adds in the same order and the epilogues
//     are unchanged, so no output depends on the schedule, to the bit
//     (tests/test_torch_cuda_kernels.py holds them to recorded digests). The
//     chunk loop is not unrolled: unrolled, the kernels were twice as long
//     and an epilogue took 2.5x as long (PERF.md).
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
// f32: split-TF32 tensor-core products (csrc/hopper.cuh's tf32_layer, the
// routine of the f32 fused forward): every product with W is issued as hi.hi
// + hi.lo + lo.hi of split operands, summed in 32-deep tensor-core groups
// added in f32, which holds the f32 results to 2e-5 of the plain version
// where one TF32 pass would not. At 8x512 that is 3 x 2 and 3 x 6 passes of
// 512 x 512 products a point: 0.73 and 2.19 ms for 16,384 points at 495
// TF32 TFLOP/s (1.80 and 5.39 ms of f32 work on the FP32 pipes).
//   * One 64-row tile per CTA (its f32 rows take 128 KB); the two consumer
//     warpgroups split each layer's output columns and take their weight
//     stages from a ring each (FusedNet.igr_tf32_tiles: the forward stages
//     of FusedNet.tf32_tiles, then the reverse stages of layers n_lin - 2 ..
//     1, W itself K-major over the layer's outputs, each stage's hi and lo
//     images, K permuted within each 8 so that A comes from the threads' own
//     accumulator values, split on the fly).
//   * igr_fwd: 64 points per CTA. The primal sweep stashes sigma(z) as f32
//     in device memory in each thread's own order (the slot order), so the
//     reverse sweep's epilogue reads back, 16 bytes a load, the values it
//     multiplies. The head's reverse step seed * w * sigma is elementwise;
//     grad_x f is each consumer's quad sums of dz W_x^T, consumer 1's added
//     to consumer 0's through shared memory.
//   * igr_bwd: a tile holds 32 points, each point's primal and tangent rows
//     eight apart in one warp (rows r0 and r0 + 8 of a thread's A fragment
//     and accumulator), so the couplings of the two chains are
//     register-local, as in bf16. Each layer's [act(z); tcz s] goes to the
//     workspace in the slot order from the epilogue's registers; each
//     layer's [dz; dtcz] is copied from shared memory to the workspace
//     transposed, points contiguous, split into hi and lo images (the dW
//     pass's B operand, which TF32 wgmma takes K-major only); db is summed
//     per warp over its 8 points in a fixed order.
//   * dW without atomics (igr_dw, launched by the same C function): a CTA
//     owns a 128 x 128 tile of one dW or dW_x matrix (FusedNet's f32 plan,
//     fused_igr.py _dw_jobs_f32) and loops over the workspace tiles in
//     order: a producer brings each tile's [h; tc] blocks and [dz; dtcz]
//     images by bulk copy, consumer c takes rows 64 c .. 64 c + 63 of the
//     tile with A from registers (split there), 32 workspace rows at a time
//     summed on the tensor cores and added in f32. Where the plan has fewer
//     jobs than the card has SMs, each job's rows are cut into `splits`
//     parts whose tiles a last kernel sums in order. The last CTAs sum db
//     over the tiles and warps in order. Two launches give the same dW and
//     db bit for bit.
//   * The workspace at 8x512, N = 16,384: 0.54 GB of [h; tc], 1.07 GB of
//     [dz; dtcz] images (fused_igr.py _workspace_sets_f32).

// Numerics kept from the JAX kernels. f32: everything f32, the products of
// hidden activations and cotangents with W and of the dW sums as three TF32
// products of split operands (fused_igr.py fused_value_and_grad_tf32_model
// and fused_param_grads_tf32_model emulate them), sigma(z) on the
// approximate ex2/rcp. bf16: weights bf16;
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

// the kernel of a padded hidden width (NQ = width / 128) and activation
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

// =============================================================================
// f32: the split-TF32 routines
// =============================================================================

namespace tf32 {

using namespace hopper;

constexpr int kThreads = 3 * kWgThreads;  // producer + two consumers
constexpr int kFwdPts = kRows;            // igr_fwd: 64 points per CTA, a row each
constexpr int kBwdPts = kRows / 2;        // igr_bwd: 32 points per CTA, a primal and a tangent row each
constexpr int kStages = 3;                // weight stages in each consumer's ring
constexpr int kSumK = 32;                 // K per tensor-core group sum
constexpr int kPasses = 3;                // hi.hi + hi.lo + lo.hi
// setmaxnreg: 168 registers a thread at launch (384 threads); the
// producers' warpgroup hands 128 of its 168 to the consumers
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
static_assert(kWgThreads * (168 - kProducerRegs) >= 2 * kWgThreads * (kConsumerRegs - 168), "registers");
using Ring = StageRing<kStages, kTf32StageBytes>;
using Layer = LayerArgsT<float>;

// Shared memory of igr_fwd and igr_bwd (from a 1024-byte aligned base):
//   H4     the tile's 64 rows of f32 in hopper.cuh's slot order (128 KB)
//   rings  one ring per consumer of kStages stages from FusedNet.igr_tf32_tiles
//   xs     64 x 4 f32: a row's coordinates (igr_bwd: x for a primal row, c
//          for a tangent row); at the end of igr_fwd consumer 1's grad_x f
//   seeds  the head's cotangent seed of each row
//   full, empty  the rings' mbarriers
constexpr size_t kOffRing = kTf32HBytes;
constexpr size_t kOffX = kOffRing + 2 * size_t(kStages) * kTf32StageBytes;
constexpr size_t kOffSeed = kOffX + size_t(kRows) * 4 * sizeof(float);
constexpr size_t kOffBar = kOffSeed + size_t(kRows) * sizeof(float);
constexpr size_t kSmem = kOffBar + 4 * kStages * sizeof(uint64_t) + 1024;  // + alignment slack
static_assert(kSmem <= 232448, "shared memory of a block");

// The f32 backward's workspace, per 64-row tile T (fused_igr.py
// _workspace_sets_f32 computes the same): sets in this order, each (tiles x
// its floats per tile):
//   stash l   [act(z); tcz s] of hidden layer l (l < n_lin - 1), 64 x h_pad
//             in the slot order: the dW pass's A operand, and what the
//             reverse sweep couples with
//   coords    [x; c], 64 x 64 in the slot order (columns 0 .. 3 live)
//   cot l     [dz; dtcz] of layer l (l < n_lin), the dW pass's B operand:
//             per 128 columns, per K block of 32 rows, the hi then the lo
//             image of 128 rows (the columns) x 32 K in the 128-byte
//             swizzle. K slot 8 u + j of K block kb is point 16 kb + 4 u +
//             j % 4 of the tile, its primal row for j < 4, its tangent row
//             otherwise: the rows the dW pass's A fragments take for K step
//             4 kb + u.
struct Sets {
  long long tiles;
  int h_pad, n_lin;
  __device__ __forceinline__ long long stash_floats() const { return 64LL * h_pad; }
  __device__ __forceinline__ float* stash(float* ws, int l, long long T) const {
    return ws + (l * tiles + T) * stash_floats();
  }
  __device__ __forceinline__ float* coords(float* ws, long long T) const {
    return ws + (n_lin - 1) * tiles * stash_floats() + T * 4096;
  }
  // the hidden layers' images (128 h_pad floats a tile), then the last layer's (128 x 128)
  __device__ __forceinline__ float* cot(float* ws, int l, long long T) const {
    const long long base = (n_lin - 1) * tiles * stash_floats() + tiles * 4096;
    return ws + base + l * tiles * 128LL * h_pad + T * (l < n_lin - 1 ? 128LL * h_pad : 128LL * 128);
  }
};

// the CTA's two rings: warp r of the producer warpgroup feeds ring r,
// consumer r takes it
__device__ __forceinline__ Ring setup_rings(uint8_t* smem) {
  const int wg = threadIdx.x / kWgThreads, lt = threadIdx.x % kWgThreads;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + kOffBar);
  const int r = wg > 0 ? wg - 1 : (lt >> 5) & 1;
  auto ring_of = [&](int i, bool init) {
    return ring_init<Ring>(smem + kOffRing + size_t(i) * kStages * kTf32StageBytes, bars + 2 * kStages * i, 1,
                           init);
  };
  if (threadIdx.x == 0) {
    ring_of(0, true);
    ring_of(1, true);
  }
  Ring ring = ring_of(r, false);
  __syncthreads();  // barriers and coordinates ready
  return ring;
}

// the producer warpgroup: lane 0 of warp r sends consumer r its stages of
// FusedNet.igr_tf32_tiles in the order both kernels take them: the forward
// products of layers 1 .. n_lin - 1 (the last one, one output, to ring 0
// only, and only where the kernel multiplies by it: `head`), then the
// reverse products of layers n_lin - 2 .. 1; per layer the chunks in order,
// so consumer r's NQ chunks are one run of stages
template <int NQ>
__device__ __forceinline__ void produce_warpgroup(const long long* desc, int n_lin, Ring& ring,
                                                  const uint8_t* tiles, bool head) {
  regs_decrease<kProducerRegs>();
  const int lt = threadIdx.x;
  if ((lt & 31) != 0 || lt >= 64) return;
  const int r = lt >> 5;
  const uint8_t* src = tiles;
  auto layer = [&](int kbs) {
    produce(ring, src + size_t(r) * NQ * kbs * kTf32StageBytes, kTf32StageBytes, NQ * kbs);
    src += size_t(2) * NQ * kbs * kTf32StageBytes;
  };
  for (int l = 1; l < n_lin - 1; ++l) layer(static_cast<int>(desc[kDesc * l]) / kTf32KBlock);
  const int last = static_cast<int>(desc[kDesc * (n_lin - 1)]) / kTf32KBlock;
  if (r == 0 && head) produce(ring, src, 2 * kTf32LastImage, last);
  src += size_t(2) * kTf32LastImage * last;
  for (int l = n_lin - 2; l >= 1; --l) layer(static_cast<int>(desc[kDesc * l + 1]) / kTf32KBlock);
}

// act(z) (hopper::activate_f32) and act'(z): sigmoid(beta z) from the
// softplus's own e = exp(-|beta z|), (z >= 0 ? 1 : e) / (1 + e) on the
// approximate reciprocal (relative error ~1e-7, no division); or the step
template <bool kSoftplus>
__device__ __forceinline__ void activate(float z, float beta, float rb, float& act, float& grad) {
  act = activate_f32<kSoftplus>(z, beta, rb);
  if constexpr (kSoftplus) {
    const float t = __fmul_rn(beta, z);
    const float e = expf(-fabsf(t));
    grad = __fmul_rn(t >= 0.f ? 1.f : e, rcp_ftz(__fadd_rn(1.f, e)));
  } else {
    grad = z > 0.f ? 1.f : 0.f;
  }
}

// s = 1 - exp(-beta h) (the step of h for ReLU); dz = dh s + (dtc tc) beta
// (1 - s), dtcz = dtc s: one reverse step's coupling of the two chains, in
// the plain version's f32 arithmetic
template <bool kSoftplus>
__device__ __forceinline__ void couple(float dh, float dtc, float hp, float tcp, float beta, float& dz, float& dt) {
  if constexpr (kSoftplus) {
    const float s = __fsub_rn(1.f, expf(-__fmul_rn(beta, hp)));
    dz = __fadd_rn(__fmul_rn(dh, s), __fmul_rn(__fmul_rn(dtc, tcp), __fmul_rn(beta, __fsub_rn(1.f, s))));
    dt = __fmul_rn(dtc, s);
  } else {
    const float s = hp > 0.f ? 1.f : 0.f;
    dz = __fmul_rn(dh, s);
    dt = __fmul_rn(dtc, s);
  }
}

// dx += (dz W_x^T) * scale for a layer with coordinate inputs, whose
// cotangents dz are in H: the thread's share over its consumer's columns
// (NQ chunks from its slot) for rows r0 and r0 + 8, summed over the quad
// (every lane of the quad then holds the rows' dx). Run after the layer,
// outside the products, so that no partial sums stay live across them.
template <int NQ>
__device__ __forceinline__ void dx_add(float (&dx)[2][4], const float4* H4, const Layer& L, int c, int lt) {
  float dxp[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll 1
  for (int j = 0; j < NQ; ++j) {
#pragma unroll
    for (int jj = 0; jj < kChunkN / 8; ++jj) {
      const int g = 8 * (c * NQ + j) + jj, col = 8 * g + 2 * (lt & 3);
      const float4 d = H4[g * kWgThreads + lt];  // (r0, col), (r0 + 8, col), (r0, col + 1), (r0 + 8, col + 1)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        if (r < L.d_in) {
          const float2 w = load_pair(L.wx + r * L.n + col);
          dxp[0][r] = __fmaf_rn(d.z, w.y, __fmaf_rn(d.x, w.x, dxp[0][r]));
          dxp[1][r] = __fmaf_rn(d.w, w.y, __fmaf_rn(d.y, w.x, dxp[1][r]));
        }
      }
    }
  }
  const float scale = L.skip ? kInvSqrt2 : 1.f;
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float v = dxp[h][r];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      dx[h][r] = __fadd_rn(dx[h][r], __fmul_rn(v, scale));
    }
}

// ---- igr_fwd: f and grad_x f ---------------------------------------------------

// stash: (n_lin - 1) hidden layers x CTAs x (h_pad / 8) groups x 128 slots
// of float4: sigma(z) of each layer in the slot order, each thread's own
template <int NQ, bool kSoftplus>
__global__ void __launch_bounds__(kThreads, 1)
igr_fwd_kernel(const float* __restrict__ x, long long n_pts, int d_in, const long long* __restrict__ desc,
               int n_lin, float beta, const float* __restrict__ W, const float* __restrict__ B,
               const uint8_t* __restrict__ tiles, float4* stash, float* __restrict__ f_out,
               float* __restrict__ g_out) {
  constexpr int kGroups = 16 * NQ;  // 8-column groups of a hidden layer
  extern __shared__ uint8_t igr_smem_raw[];
  uint8_t* smem = aligned_smem(igr_smem_raw);
  float* xs = reinterpret_cast<float*>(smem + kOffX);
  const long long p0 = static_cast<long long>(blockIdx.x) * kFwdPts;
  for (int e = threadIdx.x; e < kFwdPts * 4; e += kThreads) {
    const int p = e >> 2, r = e & 3;
    float v = 0.f;
    if (r < d_in && p0 + p < n_pts) v = x[(p0 + p) * d_in + r];
    xs[e] = v;
  }
  Ring ring = setup_rings(smem);
  if (threadIdx.x < kWgThreads) {
    produce_warpgroup<NQ>(desc, n_lin, ring, tiles, true);
    return;
  }
  regs_increase<kConsumerRegs>();
  const int c = threadIdx.x / kWgThreads - 1, lt = threadIdx.x % kWgThreads;
  const int lane = lt & 31, q = lane & 3;
  const int r0 = 16 * (lt >> 5) + (lane >> 2);
  float4* H4 = reinterpret_cast<float4*>(smem);
  float* seeds = reinterpret_cast<float*>(smem + kOffSeed);
  float xy[2][4];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int r = 0; r < 4; ++r) xy[h][r] = xs[(r0 + 8 * h) * 4 + r];
  const float rb = beta > 0.f ? __frcp_rn(beta) : 0.f;
  // sigma(z) of hidden layer l: the tile's groups, the thread's slot
  auto stash_of = [&](int l) {
    return stash + (static_cast<long long>(l) * gridDim.x + blockIdx.x) * kGroups * kWgThreads + lt;
  };

  // primal forward over the hidden layers, stashing sigma(z)
  for (int l = 0; l < n_lin - 1; ++l) {
    const Layer L = layer_args(desc, l, d_in, beta, rb, W, B);
    float4* S = stash_of(l);
    tf32_layer<NQ, kSumK, kPasses>(H4, L.k / kTf32KBlock, ring, c, lt, [&](int ch, float (&acc)[kAcc]) {
#pragma unroll
      for (int j = 0; j < kChunkN / 8; ++j) {
        float v[2][2] = {{acc[4 * j], acc[4 * j + 1]}, {acc[4 * j + 2], acc[4 * j + 3]}};
        column_pair(L, kChunkN * ch + 8 * j + 2 * q, xy, v);
        float sg[2][2];
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) activate<kSoftplus>(v[h][e], beta, rb, acc[4 * j + 2 * h + e], sg[h][e]);
        S[(8 * ch + j) * kWgThreads] = make_float4(sg[0][0], sg[1][0], sg[0][1], sg[1][1]);
      }
    });
  }

  // head (consumer 0; one output, no coordinate input, no skip): z = h . w
  // + b, column 0 of an m64n8k8 product; f = z or tanh z; the seed of the
  // reverse sweep, 1 or 1 - f^2, per row in shared memory
  if (c == 0) {
    const Layer Lh = layer_args(desc, n_lin - 1, d_in, beta, rb, W, B);
    float acc4[4];
    tf32_stream<kSumK, kPasses>(acc4, H4, Lh.k / kTf32KBlock, ring, lt, kTf32LastImage);
    if (q == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float z = __fadd_rn(acc4[2 * h], __ldg(Lh.bias));
        const float f = kSoftplus ? z : tanhf(z);
        const long long p = p0 + r0 + 8 * h;
        if (p < n_pts) f_out[p] = f;
        seeds[r0 + 8 * h] = kSoftplus ? 1.f : __fsub_rn(1.f, __fmul_rn(f, f));
      }
    }
  }
  named_barrier(1, 2 * kWgThreads);  // the head's products have read H; the seeds are in place

  // the head's reverse step, elementwise into H in place of the last hidden
  // layer's activations: dz = (seed * w) * sigma(z); each thread rewrites
  // only its own values
  float dx[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
  {
    const Layer Lp = layer_args(desc, n_lin - 2, d_in, beta, rb, W, B);
    const float* wl = W + desc[kDesc * (n_lin - 1) + 4];  // k x 128, column 0 live
    const float sd[2] = {seeds[r0], seeds[r0 + 8]};
#pragma unroll 1
    for (int j = 0; j < NQ; ++j) {
      const int ch = c * NQ + j;
#pragma unroll
      for (int jj = 0; jj < kChunkN / 8; ++jj) {
        const int col = kChunkN * ch + 8 * jj + 2 * q;
        const float w0 = wl[col * 128], w1 = wl[(col + 1) * 128];
        const float4 s = stash_of(n_lin - 2)[(8 * ch + jj) * kWgThreads];
        const float d00 = __fmul_rn(__fmul_rn(sd[0], w0), s.x), d10 = __fmul_rn(__fmul_rn(sd[1], w0), s.y);
        const float d01 = __fmul_rn(__fmul_rn(sd[0], w1), s.z), d11 = __fmul_rn(__fmul_rn(sd[1], w1), s.w);
        H4[(8 * ch + jj) * kWgThreads + lt] = make_float4(d00, d10, d01, d11);
      }
    }
    if (Lp.wx != nullptr) dx_add<NQ>(dx, H4, Lp, c, lt);
    named_barrier(1, 2 * kWgThreads);  // the cotangents are in H for both consumers
  }

  // reverse sweep: H holds dz of layer l; dz of layer l - 1 = (dz W_l^T) *
  // scale * sigma(z of layer l - 1); dx += (dz W_x^T) * scale where layer
  // l - 1 has coordinate inputs
  for (int l = n_lin - 2; l >= 1; --l) {
    const long long* d = desc + kDesc * l;
    const float scale = d[2] != 0 ? kInvSqrt2 : 1.f;
    const Layer Lp = layer_args(desc, l - 1, d_in, beta, rb, W, B);
    const float4* S = stash_of(l - 1);
    if (lt == 0) prefetch_l2(S + 8 * NQ * c * kWgThreads, 8 * NQ * kWgThreads * sizeof(float4));
    tf32_layer<NQ, kSumK, kPasses>(H4, static_cast<int>(d[1]) / kTf32KBlock, ring, c, lt,
                                   [&](int ch, float (&acc)[kAcc]) {
#pragma unroll
      for (int jj = 0; jj < kChunkN / 8; ++jj) {
        const float4 s = S[(8 * ch + jj) * kWgThreads];
        const float d00 = __fmul_rn(__fmul_rn(acc[4 * jj], scale), s.x);
        const float d01 = __fmul_rn(__fmul_rn(acc[4 * jj + 1], scale), s.z);
        const float d10 = __fmul_rn(__fmul_rn(acc[4 * jj + 2], scale), s.y);
        const float d11 = __fmul_rn(__fmul_rn(acc[4 * jj + 3], scale), s.w);
        acc[4 * jj] = d00;
        acc[4 * jj + 1] = d01;
        acc[4 * jj + 2] = d10;
        acc[4 * jj + 3] = d11;
      }
    });
    if (Lp.wx != nullptr) dx_add<NQ>(dx, H4, Lp, c, lt);
  }

  // grad_x f: consumer 1's share of each row through shared memory (xs is
  // free: the coordinates are in registers), added to consumer 0's
  if (c == 1 && q == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int r = 0; r < 4; ++r) xs[(r0 + 8 * h) * 4 + r] = dx[h][r];
  }
  named_barrier(1, 2 * kWgThreads);
  if (c == 0 && q == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long p = p0 + r0 + 8 * h;
#pragma unroll
      for (int r = 0; r < 4; ++r)
        if (r < d_in && p < n_pts) g_out[p * d_in + r] = __fadd_rn(dx[h][r], xs[(r0 + 8 * h) * 4 + r]);
    }
  }
}

// ---- igr_bwd: both chains, their reverse sweep, the workspace for dW ------------

// The image of [dz; dtcz] of a layer (n_cols columns) for the dW pass (cot
// in Sets), written by the 256 consumer threads (t256), 16 bytes a thread
// and store; value(point, tangent, col) gives each f32 value, split here
// into its hi and lo halves.
template <class Value>
__device__ __forceinline__ void cot_image(float* dst, int n_cols, int t256, Value value) {
  const int items = n_cols / 128 * 2 * 128 * 8;  // (128-column block, K block, row, 16-byte group)
  for (int i = t256; i < items; i += 2 * kWgThreads) {
    const int pg = i & 7, row = (i >> 3) & 127, kb = (i >> 10) & 1, nb = i >> 11;
    const int lg = pg ^ (row & 7), u = lg >> 1, tangent = lg & 1;  // the group's K slots 4 lg .. 4 lg + 3
    const int col = 128 * nb + row;
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) split_tf32(value(16 * kb + 4 * u + j, tangent, col), hi[j], lo[j]);
    float* out = dst + ((nb * 2 + kb) * 2) * 4096 + row * 32 + pg * 4;
    *reinterpret_cast<uint4*>(out) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    *reinterpret_cast<uint4*>(out + 4096) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
  }
}

// the value of H at a tile point's primal (tangent = 0) or tangent row and a column
__device__ __forceinline__ float h_value(const float* Hf, int point, int tangent, int col) {
  const int t = 32 * (point >> 3) + 4 * (point & 7) + ((col & 7) >> 1);
  return Hf[((col >> 3) * kWgThreads + t) * 4 + 2 * (col & 1) + tangent];
}

// ws: the workspace (Sets); partial: (CTAs x 4 warps x n_bias) f32, each
// consumer warp's sums of dz over its 8 points, per bias column
template <int NQ, bool kSoftplus>
__global__ void __launch_bounds__(kThreads, 1)
igr_bwd_kernel(const float* __restrict__ x, const float* __restrict__ a, const float* __restrict__ cvec,
               long long n_pts, int d_in, const long long* __restrict__ desc, int n_lin, float beta,
               const float* __restrict__ W, const float* __restrict__ B, const uint8_t* __restrict__ tiles,
               float* ws, float* __restrict__ partial, int n_bias) {
  constexpr int n = 128 * NQ;
  extern __shared__ uint8_t igr_smem_raw[];
  uint8_t* smem = aligned_smem(igr_smem_raw);
  float* xs = reinterpret_cast<float*>(smem + kOffX);
  const long long T = blockIdx.x;
  // row r: point 32 T + 8 (r / 16) + r % 8, its x for r % 16 < 8, its c otherwise
  for (int e = threadIdx.x; e < kRows * 4; e += kThreads) {
    const int r = e >> 2, k = e & 3;
    const long long p = T * kBwdPts + 8 * (r >> 4) + (r & 7);
    const float* src = (r & 8) ? cvec : x;
    float v = 0.f;
    if (k < d_in && p < n_pts) v = src[p * d_in + k];
    xs[e] = v;
  }
  Ring ring = setup_rings(smem);
  if (threadIdx.x < kWgThreads) {
    produce_warpgroup<NQ>(desc, n_lin, ring, tiles, !kSoftplus);  // softplus' seeds need no head product
    return;
  }
  regs_increase<kConsumerRegs>();
  const int c = threadIdx.x / kWgThreads - 1, lt = threadIdx.x % kWgThreads, t256 = threadIdx.x - kWgThreads;
  const int warp = lt >> 5, lane = lt & 31, q = lane & 3;
  const int r0 = 16 * warp + (lane >> 2);
  float4* H4 = reinterpret_cast<float4*>(smem);
  const float* Hf = reinterpret_cast<const float*>(smem);
  float* seeds = reinterpret_cast<float*>(smem + kOffSeed);
  float xy[2][4];  // the point's x (primal row r0) and c (tangent row r0 + 8)
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int r = 0; r < 4; ++r) xy[h][r] = xs[(r0 + 8 * h) * 4 + r];
  const Sets sets{static_cast<long long>(gridDim.x), n, n_lin};
  const long long point = T * kBwdPts + 8 * warp + (lane >> 2);
  const float rb = beta > 0.f ? __frcp_rn(beta) : 0.f;
  float* part = partial + (T * 4 + warp) * n_bias;

  // db: the warp's sum of dz at a column over its 8 points (shuffles over
  // the row groups, in a fixed order), written by the lane of the column's q
  auto db_add = [&](int col, float v) {
    v += __shfl_xor_sync(0xffffffffu, v, 4);
    v += __shfl_xor_sync(0xffffffffu, v, 8);
    v += __shfl_xor_sync(0xffffffffu, v, 16);
    if (lane < 4) part[col] = v;
  };
  auto h_at = [&](int p, int tangent, int col) { return h_value(Hf, p, tangent, col); };

  // the [x; c] image: groups 4 c .. 4 c + 3 of the thread's slot (group 0:
  // columns 0 .. 7, of which 0 .. d_in - 1 are nonzero)
  {
    float4* X = reinterpret_cast<float4*>(sets.coords(ws, T)) + lt;
#pragma unroll
    for (int g = 4 * c; g < 4 * c + 4; ++g) {
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (g == 0 && q == 0) v = make_float4(xy[0][0], xy[1][0], xy[0][1], xy[1][1]);
      if (g == 0 && q == 1) v = make_float4(xy[0][2], xy[1][2], xy[0][3], xy[1][3]);
      X[g * kWgThreads] = v;
    }
  }

  // rematerialise both chains: [act(z); tcz sigma(z)] per hidden layer, in
  // H and in the workspace
  for (int l = 0; l < n_lin - 1; ++l) {
    const Layer L = layer_args(desc, l, d_in, beta, rb, W, B);
    float4* S = reinterpret_cast<float4*>(sets.stash(ws, l, T)) + lt;
    tf32_layer<NQ, kSumK, kPasses>(H4, L.k / kTf32KBlock, ring, c, lt, [&](int ch, float (&acc)[kAcc]) {
#pragma unroll
      for (int j = 0; j < kChunkN / 8; ++j) {
        float v[2][2] = {{acc[4 * j], acc[4 * j + 1]}, {acc[4 * j + 2], acc[4 * j + 3]}};
        column_pair<true>(L, kChunkN * ch + 8 * j + 2 * q, xy, v);  // v[0] = z, v[1] = tcz
        float hv[2], tv[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float sg;
          activate<kSoftplus>(v[0][e], beta, rb, hv[e], sg);
          tv[e] = __fmul_rn(v[1][e], sg);
        }
        acc[4 * j] = hv[0];
        acc[4 * j + 1] = hv[1];
        acc[4 * j + 2] = tv[0];
        acc[4 * j + 3] = tv[1];
        S[(8 * ch + j) * kWgThreads] = make_float4(hv[0], tv[0], hv[1], tv[1]);
      }
    });
  }

  // head (consumer 0): the seeds on the last layer's (z, Tcz); softplus:
  // (a, 1), tanh: from (z, Tcz), column 0 of an m64n8k8 product; db of the
  // last layer (its other 127 columns are zero)
  const int b_last = static_cast<int>(desc[kDesc * (n_lin - 1) + 3]);
  if (c == 0) {
    float acc4[4] = {0.f, 0.f, 0.f, 0.f};
    const Layer Lh = layer_args(desc, n_lin - 1, d_in, beta, rb, W, B);
    if constexpr (!kSoftplus) tf32_stream<kSumK, kPasses>(acc4, H4, Lh.k / kTf32KBlock, ring, lt, kTf32LastImage);
    float dz = 0.f, dt = 0.f;
    if (point < n_pts) {
      const float ap = __ldg(a + point);
      if constexpr (kSoftplus) {
        dz = ap;
        dt = 1.f;
      } else {  // f = tanh z, g = Tcz (1 - f^2)
        const float z = __fadd_rn(acc4[0], __ldg(Lh.bias)), tz = acc4[2];
        const float t = tanhf(z), fp = __fsub_rn(1.f, __fmul_rn(t, t));
        dz = __fsub_rn(__fmul_rn(ap, fp), __fmul_rn(__fmul_rn(__fmul_rn(2.f, t), fp), tz));
        dt = fp;
      }
    }
    dz = __shfl_sync(0xffffffffu, dz, lane & ~3);  // column 0 is the quad leader's
    dt = __shfl_sync(0xffffffffu, dt, lane & ~3);
    float sum = dz;
    sum += __shfl_xor_sync(0xffffffffu, sum, 4);
    sum += __shfl_xor_sync(0xffffffffu, sum, 8);
    sum += __shfl_xor_sync(0xffffffffu, sum, 16);
    if (lane == 0) part[b_last] = sum;
    if (q == 0) {
      seeds[r0] = dz;
      seeds[r0 + 8] = dt;
    }
  } else {
    for (int col = 1 + lane; col < 128; col += 32) part[b_last + col] = 0.f;
  }
  named_barrier(1, 2 * kWgThreads);  // the head's products have read H; the seeds are in place

  // the last layer's [dz; dtcz] image: the seeds in column 0
  cot_image(sets.cot(ws, n_lin - 1, T), 128, t256, [&](int p, int tangent, int col) {
    return col == 0 ? seeds[16 * (p >> 3) + (p & 7) + 8 * tangent] : 0.f;
  });

  // the head's reverse step: [dh; dtc] = seeds (outer) w, coupled with the
  // last hidden layer's [h; tc] in H, into its cotangents in their place;
  // each thread rewrites only its own values
  {
    const int b_off = static_cast<int>(desc[kDesc * (n_lin - 2) + 3]);
    const float* wl = W + desc[kDesc * (n_lin - 1) + 4];  // k x 128, column 0 live
    const float sd = seeds[r0], st = seeds[r0 + 8];
#pragma unroll 1
    for (int j = 0; j < NQ; ++j) {
      const int ch = c * NQ + j;
#pragma unroll
      for (int jj = 0; jj < kChunkN / 8; ++jj) {
        const int col = kChunkN * ch + 8 * jj + 2 * q;
        const float w0 = wl[col * 128], w1 = wl[(col + 1) * 128];
        float4* hp = H4 + (8 * ch + jj) * kWgThreads + lt;  // (h, tc) at col, then at col + 1
        const float4 v = *hp;
        float z0, t0, z1, t1;
        couple<kSoftplus>(__fmul_rn(sd, w0), __fmul_rn(st, w0), v.x, v.y, beta, z0, t0);
        couple<kSoftplus>(__fmul_rn(sd, w1), __fmul_rn(st, w1), v.z, v.w, beta, z1, t1);
        db_add(b_off + col, z0);
        db_add(b_off + col + 1, z1);
        *hp = make_float4(z0, t0, z1, t1);
      }
    }
    named_barrier(1, 2 * kWgThreads);  // the cotangents are in H for both consumers
    cot_image(sets.cot(ws, n_lin - 2, T), n, t256, h_at);
  }

  // reverse sweep: H holds [dz; dtcz] of layer l; [dh; dtc] = [dz; dtcz]
  // W_l^T * scale, coupled with the stashed [h; tc] of layer l - 1 (the
  // thread's own values, written by it in the forward chains)
  for (int l = n_lin - 2; l >= 1; --l) {
    const long long* d = desc + kDesc * l;
    const float scale = d[2] != 0 ? kInvSqrt2 : 1.f;
    const float4* S = reinterpret_cast<const float4*>(sets.stash(ws, l - 1, T)) + lt;
    const int b_off = static_cast<int>(desc[kDesc * (l - 1) + 3]);
    if (lt == 0) prefetch_l2(S + 8 * NQ * c * kWgThreads, 8 * NQ * kWgThreads * sizeof(float4));
    tf32_layer<NQ, kSumK, kPasses>(H4, static_cast<int>(d[1]) / kTf32KBlock, ring, c, lt,
                                   [&](int ch, float (&acc)[kAcc]) {
#pragma unroll
      for (int jj = 0; jj < kChunkN / 8; ++jj) {
        const float4 v = S[(8 * ch + jj) * kWgThreads];  // (h, tc) at col, then at col + 1
        const int col = kChunkN * ch + 8 * jj + 2 * q;
        float z0, t0, z1, t1;
        couple<kSoftplus>(__fmul_rn(acc[4 * jj], scale), __fmul_rn(acc[4 * jj + 2], scale), v.x, v.y, beta, z0, t0);
        couple<kSoftplus>(__fmul_rn(acc[4 * jj + 1], scale), __fmul_rn(acc[4 * jj + 3], scale), v.z, v.w, beta, z1,
                          t1);
        db_add(b_off + col, z0);
        db_add(b_off + col + 1, z1);
        acc[4 * jj] = z0;
        acc[4 * jj + 1] = z1;
        acc[4 * jj + 2] = t0;
        acc[4 * jj + 3] = t1;
      }
    });
    cot_image(sets.cot(ws, l - 1, T), n, t256, h_at);
  }
}

// ---- igr_dw: dW and db from the workspace, in a fixed order -------------------

constexpr int kPlan = 11;  // int64 per job (fused_igr.py _dw_jobs_f32):
// [0] A set base (floats per tile before the set: at J[0] * tiles), [1] A
// floats per tile, [2] A offset in the tile (the 64-
// column blocks of the job's dW rows), [3] A blocks (1 or 2: one per
// consumer), [4] B set base (as [0]), [5] B floats per tile, [6] B offset in the tile
// (the job's 128 columns), [7] element offset of the job's first output,
// [8] output row stride, [9] output rows written (<= 128), [10] skip: scale
// by 1/sqrt 2
constexpr int kDwStages = 2;
constexpr int kDwBlockBytes = 64 * 64 * 4;                             // a 64-column block of a tile's [h; tc]
constexpr int kDwImageBytes = 128 * 32 * 4;                            // an image of a K block of [dz; dtcz]
constexpr int kDwStageBytes = 2 * kDwBlockBytes + 4 * kDwImageBytes;   // A blocks, then 2 K blocks x hi / lo: 96 KB
constexpr size_t kDwOffBar = size_t(kDwStages) * kDwStageBytes;
constexpr size_t kDwSmem = kDwOffBar + 2 * kDwStages * sizeof(uint64_t) + 1024;
static_assert(kDwSmem <= 232448, "shared memory of a block");

// CTA b < n_jobs * splits: job b / splits over the tiles of split s = b %
// splits (tiles * s / splits .. tiles * (s + 1) / splits), in order; its
// 128 x 128 tile of dW (one split's part of it) goes to out + s *
// out_split. A producer thread brings each tile's A blocks and B images by
// bulk copy through a ring of kDwStages; consumer c multiplies A block c
// (the job's rows 64 c .. 64 c + 63, A from registers) by the same 128 B
// columns, 32 rows at a time on the tensor cores (the corrections first),
// each sum added to its f32 accumulator. The CTAs past them sum db
// columns, kThreads each, over the tiles and warps in order.
__global__ void __launch_bounds__(kThreads, 1)
igr_dw_kernel(const long long* __restrict__ plan, int n_jobs, int splits, const float* __restrict__ ws,
              long long tiles, float* __restrict__ out, long long out_split, const float* __restrict__ partial,
              int n_bias, float* __restrict__ gb) {
  const int cta = static_cast<int>(blockIdx.x);
  if (cta >= n_jobs * splits) {
    const int col = (cta - n_jobs * splits) * kThreads + threadIdx.x;
    if (col < n_bias) {
      float s = 0.f;
      for (long long t = 0; t < tiles * 4; ++t) s = __fadd_rn(s, partial[t * n_bias + col]);
      gb[col] = s;
    }
    return;
  }
  extern __shared__ uint8_t igr_smem_raw[];
  uint8_t* smem = aligned_smem(igr_smem_raw);
  const long long* J = plan + kPlan * (cta / splits);
  const int split = cta % splits;
  const long long t0 = tiles * split / splits, t1 = tiles * (split + 1) / splits;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kDwOffBar);
  uint64_t* empty = full + kDwStages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kDwStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);  // one arrival per consumer
    }
    fence_barrier_init();
  }
  __syncthreads();
  const int wg = threadIdx.x / kWgThreads;
  if (wg == 0) {
    regs_decrease<kProducerRegs>();
    if (threadIdx.x == 0) {
      const float* A = ws + J[0] * tiles + J[2];
      const float* Bm = ws + J[4] * tiles + J[6];
      const uint32_t a_bytes = static_cast<uint32_t>(J[3]) * kDwBlockBytes;
      for (long long T = t0; T < t1; ++T) {
        const long long i = T - t0;
        const int s = static_cast<int>(i % kDwStages);
        mbar_wait(&empty[s], static_cast<uint32_t>((i / kDwStages) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[s], a_bytes + 4 * kDwImageBytes);
        uint8_t* st = smem + s * kDwStageBytes;
        bulk_load(st, A + T * J[1], a_bytes, &full[s]);
        bulk_load(st + 2 * kDwBlockBytes, Bm + T * J[5], 4 * kDwImageBytes, &full[s]);
      }
    }
    return;
  }
  regs_increase<kConsumerRegs>();
  const int c = wg - 1, lt = threadIdx.x - wg * kWgThreads;
  const int warp = lt >> 5, lane = lt & 31, q = lane & 3;
  const bool active = c < J[3];
  // the thread's A fragment of K step s: its M rows 16 warp + lane / 4 and
  // + 8 stand for columns 2 cp and 2 cp + 1 (cp = 8 warp + lane / 4) of A
  // block c, its K slots q and q + 4 for the primal and the tangent row of
  // point 4 s + q: one float4 of the slot order
  const int cp = 8 * warp + (lane >> 2);
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  for (long long T = t0; T < t1; ++T) {
    const long long i = T - t0;
    const int s = static_cast<int>(i % kDwStages);
    mbar_wait(&full[s], static_cast<uint32_t>((i / kDwStages) & 1));
    const uint8_t* st = smem + s * kDwStageBytes;
    if (active) {
      const float4* As = reinterpret_cast<const float4*>(st + c * kDwBlockBytes);
#pragma unroll
      for (int kb = 0; kb < 2; ++kb) {
        const uint8_t* bhi = st + 2 * kDwBlockBytes + 2 * kb * kDwImageBytes;
        const uint8_t* blo = bhi + kDwImageBytes;
        uint32_t hi[4][4], lo[4][4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int p = 16 * kb + 4 * u + q;
          const float4 v = As[(cp >> 2) * kWgThreads + 32 * (p >> 3) + 4 * (p & 7) + (cp & 3)];
          split_tf32(v.x, hi[u][0], lo[u][0]);  // (column 2 cp, primal)
          split_tf32(v.z, hi[u][1], lo[u][1]);  // (column 2 cp + 1, primal)
          split_tf32(v.y, hi[u][2], lo[u][2]);  // (column 2 cp, tangent)
          split_tf32(v.w, hi[u][3], lo[u][3]);  // (column 2 cp + 1, tangent)
        }
        float part[64];
        wgmma_fence();
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          wgmma_m64n128k8_tf32(part, hi[u], desc_k_sw128(blo + 32 * u), u > 0);
          wgmma_m64n128k8_tf32(part, lo[u], desc_k_sw128(bhi + 32 * u), 1);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) wgmma_m64n128k8_tf32(part, hi[u], desc_k_sw128(bhi + 32 * u), 1);
        wgmma_commit();
        wgmma_wait<0>();
        fence_registers(part);
#pragma unroll
        for (int k = 0; k < 64; ++k) acc[k] = __fadd_rn(acc[k], part[k]);
      }
    }
    if (lt == 0) mbar_arrive(&empty[s]);
  }
  if (!active) return;
  const float scale = J[10] != 0 ? kInvSqrt2 : 1.f;
  const int rows = static_cast<int>(J[9]);
  float* o = out + split * out_split + J[7];
  const long long stride = J[8];
#pragma unroll
  for (int i = 0; i < 64; i += 2) {
    // accumulator row 16 warp + lane / 4 + 8 ((i / 2) % 2): column 2 cp +
    // (i / 2) % 2 of A block c
    const int row = 64 * c + 2 * cp + ((i >> 1) & 1);
    const int col = 8 * (i >> 2) + 2 * q;
    if (row < rows)
      *reinterpret_cast<float2*>(o + row * stride + col) =
          make_float2(__fmul_rn(acc[i], scale), __fmul_rn(acc[i + 1], scale));
  }
}

// gw = the dW pass's splits summed in order
__global__ void split_sum_kernel(const float* __restrict__ buf, int splits, long long size, float* __restrict__ gw) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= size) return;
  float s = buf[i];
  for (int k = 1; k < splits; ++k) s = __fadd_rn(s, buf[k * size + i]);
  gw[i] = s;
}

}  // namespace tf32

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
//   park   igr_fwd: per consumer the finished chunks of a layer that wait
//          in shared memory rather than registers (chunked_layer): kFwdPark
//          of them, what the registers cannot hold beside the pipeline's.
//          igr_bwd parks none: its layers' outputs go to the workspace as
//          each chunk finishes (image_layer)
//   full, empty  the ring's mbarriers
constexpr int kFwdPark = parked_chunks(kHMax / kChunkN);
constexpr size_t kOffRing = size_t(kCtaTiles) * kHBytes;
constexpr size_t kOffX = kOffRing + size_t(kStages) * kStageBytes;
constexpr size_t kOffTail = kOffX + size_t(kCtaTiles) * kRows * 4 * sizeof(float);
constexpr size_t kFwdOffPark = kOffTail;
constexpr size_t kFwdOffBar = kFwdOffPark + size_t(kCtaTiles) * kFwdPark * kParkBytes;
constexpr size_t kFwdSmem = kFwdOffBar + 2 * kStages * sizeof(uint64_t) + 1024;  // + alignment slack
constexpr size_t kOffDb = kOffTail;
constexpr size_t kOffSeed = kOffDb + size_t(kCtaTiles) * 4 * kHMax * sizeof(float);
constexpr size_t kBwdOffBar = kOffSeed + size_t(kCtaTiles) * kRows * sizeof(float);
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
    image_layer<kChunks>(H, L.k / kKBlock, ring, 1 + c, lt, [](int) {},
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
    }, reinterpret_cast<uint8_t*>(tile_image(ws, tiles_all, sets.stash(l), kChunks, T)));
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
    image_layer<kChunks>(
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
        }, reinterpret_cast<uint8_t*>(tile_image(ws, tiles_all, sets.cot(l - 1), kChunks, T)));
    db_finish(static_cast<int>(desc[kDesc * (l - 1) + 3]), n);
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

}  // namespace tc

}  // namespace

// ---- C interface (ctypes); each returns the cudaError_t of its launches --------
// h_pad is the padded hidden width, one of 128, 256, 384, 512 (the wrapper
// checks); w, b are FusedNet.packed's buffers. f32: tiles is
// FusedNet.igr_tf32_tiles; the forward's stash holds (n_lin - 1) x CTAs x 64
// x h_pad floats; the backward's ws and partial are sized by fused_igr.py
// _workspace_sets_f32, split_buf holds splits x the packed weights' count
// (unused with one split). bf16: tiles is FusedNet.igr_tiles; the forward's
// stash holds (n_lin - 1) x CTAs x 128 x h_pad bf16; the backward's ws and
// partial are sized by fused_igr.py _workspace_sets. Both backwards write
// gw and gb whole (no zeroing).

extern "C" {

// points per CTA: forward / backward, f32 / bf16
int sdf_igr_cta_points(int bf16, int backward) {
  if (bf16) return backward ? tc::kBwdCtaPts : tc::kFwdCtaPts;
  return backward ? tf32::kBwdPts : tf32::kFwdPts;
}
int sdf_igr_max_width() { return hopper::kHMax; }
int sdf_igr_plan_fields(int bf16) { return bf16 ? tc::kPlan : tf32::kPlan; }
const char* sdf_igr_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

int sdf_igr_fwd_f32(const float* x, long long n_pts, int d_in, const long long* desc, int n_lin, int h_pad,
                    float beta, const float* w, const float* b, const void* tiles, float* stash, float* f,
                    float* g, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto tb = static_cast<const uint8_t*>(tiles);
  const long long ctas = (n_pts + tf32::kFwdPts - 1) / tf32::kFwdPts;
  return by_width(h_pad, beta, [&](auto q, auto sp) {
    return launch(tf32::igr_fwd_kernel<decltype(q)::value, decltype(sp)::value>, ctas, tf32::kThreads, tf32::kSmem,
                  s, x, n_pts, d_in, desc, n_lin, beta, w, b, tb, reinterpret_cast<float4*>(stash), f, g);
  });
}

int sdf_igr_dw_f32(const long long* plan, int n_jobs, int splits, const float* ws, long long tiles,
                   float* split_buf, float* gw, long long w_size, const float* partial, int n_bias, float* gb,
                   void* stream);

// igr_bwd, then the dW pass over the plan's n_jobs jobs in `splits` parts
// each and the db columns, then (splits > 1) the parts' sum
int sdf_igr_bwd_f32(const float* x, const float* a, const float* c, long long n_pts, int d_in,
                    const long long* desc, int n_lin, int h_pad, float beta, const float* w, const float* b,
                    const void* tiles, float* ws, float* partial, int n_bias, const long long* plan, int n_jobs,
                    int splits, float* split_buf, float* gw, long long w_size, float* gb, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto tb = static_cast<const uint8_t*>(tiles);
  const long long ctas = (n_pts + tf32::kBwdPts - 1) / tf32::kBwdPts;
  cudaError_t err = by_width(h_pad, beta, [&](auto q, auto sp) {
    return launch(tf32::igr_bwd_kernel<decltype(q)::value, decltype(sp)::value>, ctas, tf32::kThreads, tf32::kSmem,
                  s, x, a, c, n_pts, d_in, desc, n_lin, beta, w, b, tb, ws, partial, n_bias);
  });
  if (err != cudaSuccess || ctas == 0) return static_cast<int>(err);
  return sdf_igr_dw_f32(plan, n_jobs, splits, ws, ctas, split_buf, gw, w_size, partial, n_bias, gb, stream);
}

// the f32 dW pass alone, on a workspace the backward has written
int sdf_igr_dw_f32(const long long* plan, int n_jobs, int splits, const float* ws, long long tiles,
                   float* split_buf, float* gw, long long w_size, const float* partial, int n_bias, float* gb,
                   void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const long long db_ctas = (n_bias + tf32::kThreads - 1) / tf32::kThreads;
  float* out = splits > 1 ? split_buf : gw;
  cudaError_t err = launch(tf32::igr_dw_kernel, static_cast<long long>(n_jobs) * splits + db_ctas, tf32::kThreads,
                           tf32::kDwSmem, s, plan, n_jobs, splits, ws, tiles, out, splits > 1 ? w_size : 0LL,
                           partial, n_bias, gb);
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  return static_cast<int>(launch(tf32::split_sum_kernel, (w_size + 255) / 256, 256, 0, s,
                                 static_cast<const float*>(split_buf), splits, w_size, gw));
}

int sdf_igr_fwd_bf16(const float* x, long long n_pts, int d_in, const long long* desc, int n_lin, int h_pad,
                     float beta, const void* w, const float* b, const void* tiles, void* stash, float* f,
                     float* g, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto wb = static_cast<const __nv_bfloat16*>(w);
  auto tb = static_cast<const __nv_bfloat16*>(tiles);
  const long long ctas = (n_pts + tc::kFwdCtaPts - 1) / tc::kFwdCtaPts;
  return by_width(h_pad, beta, [&](auto q, auto sp) {
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
  cudaError_t err = by_width(h_pad, beta, [&](auto q, auto sp) {
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
