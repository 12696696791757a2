// Instant-NGP's multiresolution hash encoding for Hopper (sm_90a), forward
// and backward, with a plain C interface for ctypes
// (sdf_representation_tpu_torch/ops/hash_grid.py binds it).
//
// Replaces no TPU kernel: the JAX package leaves the encoding to XLA (one
// gather of the B*L*8 corner rows, its backward one scatter-add), and the
// port's plain version (ops/hash_grid.py, encode_plain) does the same in ~25 tensor
// operations a level. At Instant-NGP's sizes (16 levels of 2^19 x 2) that is
// hundreds of small launches a step, with (B, L, 8) int64 rows and weights
// written out and read back; these two kernels compute the corners, weights
// and rows in registers and touch device memory only for the points, the
// table rows and the features (or their gradient).
//
//   * hash_encode_fwd_kernel: one thread per (point, level), the level
//     fastest, so that a warp's writes of F floats each are contiguous. It
//     takes the level's 8 corners from the float32 point with the plain
//     version's arithmetic (x01 = clip((x + 1) * 0.5, 0, 1), pos = x01 * res,
//     p0 = floor(pos), frac = pos - p0, each rounded as written: no FMA), the
//     dense row (cx * (res+1) + cy) * (res+1) + cz where the level's (res+1)^3
//     corners fit its T rows, else the uint32 hash (cx * 1) ^ (cy *
//     2654435761) ^ (cz * 805459861) mod T, the weight ((wx * wy) * wz), and
//     writes sum_c w_c * row_c (FMAs, corners in order) to (B, L*F).
//   * hash_encode_bwd_kernel: the same corners and weights, and one float32
//     atomicAdd of w_c * dL/dfeat into the (L*T, F) gradient for each corner
//     and feature. Two points that share a corner add in an order the card
//     picks, so the gradient's last bits vary from run to run.
//
// What bounds them: device memory latency, not bandwidth or operations. A
// step of 16,384 points reads 2,097,152 corner rows of 8 bytes scattered over
// 64 MiB of tables (fine levels: every corner a different row) and, backward,
// as many atomic read-modify-writes, which the L2 serves; the roofline counts
// each level's rows once (portbench/reference/hashmlp.py). The design keeps
// many independent loads in flight: 8 corners a thread, all rows computed
// before the first load, and at 16,384 x 16 threads two waves of the card's
// 132 SMs.
//
// The level resolutions come in by value (a Levels struct, __grid_constant__
// so that a thread reads its level's entry from the parameter space and no
// copy goes to local memory): a CUDA graph that captures a launch keeps them,
// and a replay needs nothing from the host.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLevels = 32;

struct Levels {
  int res[kMaxLevels];
};

// rows[c] and w[c] of the 8 corners, dx-major (c = 4 dx + 2 dy + dz), of the
// point p at resolution res in a level of T rows (a power of two)
__device__ __forceinline__ void corners(const float p[3], int res, uint32_t T, uint32_t rows[8],
                                        float w[8]) {
  int p0[3];
  float lo[3], hi[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float u = fminf(fmaxf(__fmul_rn(__fadd_rn(p[a], 1.0f), 0.5f), 0.0f), 1.0f);
    const float pos = __fmul_rn(u, static_cast<float>(res));
    const float f = floorf(pos);
    p0[a] = static_cast<int>(f);
    hi[a] = __fsub_rn(pos, f);
    lo[a] = __fsub_rn(1.0f, hi[a]);
  }
  const uint32_t r1 = static_cast<uint32_t>(res) + 1u;
  const bool dense = static_cast<uint64_t>(r1) * r1 * r1 <= T;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int dx = c >> 2, dy = (c >> 1) & 1, dz = c & 1;
    const uint32_t cx = static_cast<uint32_t>(min(p0[0] + dx, res));
    const uint32_t cy = static_cast<uint32_t>(min(p0[1] + dy, res));
    const uint32_t cz = static_cast<uint32_t>(min(p0[2] + dz, res));
    rows[c] = dense ? (cx * r1 + cy) * r1 + cz
                    : ((cx * 1u) ^ (cy * 2654435761u) ^ (cz * 805459861u)) & (T - 1u);
    w[c] = __fmul_rn(__fmul_rn(dx ? hi[0] : lo[0], dy ? hi[1] : lo[1]), dz ? hi[2] : lo[2]);
  }
}

// kF > 0: F fixed at compile time; kF == 0: F = nf
template <int kF>
__global__ void __launch_bounds__(kThreads)
    hash_encode_fwd_kernel(const float* __restrict__ x, const float* __restrict__ tables,
                           long long n, int L, uint32_t T, const __grid_constant__ Levels lv,
                           int nf, float* __restrict__ out) {
  const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= n * L) return;
  const int F = kF ? kF : nf;
  const long long b = t / L;
  const int l = static_cast<int>(t - b * L);
  const float p[3] = {x[3 * b], x[3 * b + 1], x[3 * b + 2]};
  uint32_t rows[8];
  float w[8];
  corners(p, lv.res[l], T, rows, w);
  const float* tab = tables + static_cast<size_t>(l) * T * F;
  float* o = out + t * F;
  for (int f = 0; f < F; ++f) {
    float acc = 0.0f;
#pragma unroll
    for (int c = 0; c < 8; ++c) acc = fmaf(w[c], __ldg(tab + static_cast<size_t>(rows[c]) * F + f), acc);
    o[f] = acc;
  }
}

template <int kF>
__global__ void __launch_bounds__(kThreads)
    hash_encode_bwd_kernel(const float* __restrict__ x, const float* __restrict__ grad_out,
                           long long n, int L, uint32_t T, const __grid_constant__ Levels lv,
                           int nf, float* __restrict__ grad_tables) {
  const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= n * L) return;
  const int F = kF ? kF : nf;
  const long long b = t / L;
  const int l = static_cast<int>(t - b * L);
  const float p[3] = {x[3 * b], x[3 * b + 1], x[3 * b + 2]};
  uint32_t rows[8];
  float w[8];
  corners(p, lv.res[l], T, rows, w);
  float* tab = grad_tables + static_cast<size_t>(l) * T * F;
  const float* g = grad_out + t * F;
  for (int f = 0; f < F; ++f) {
    const float gf = g[f];
#pragma unroll
    for (int c = 0; c < 8; ++c) atomicAdd(tab + static_cast<size_t>(rows[c]) * F + f, __fmul_rn(w[c], gf));
  }
}

int levels(const int* res, int L, Levels* lv) {
  if (L < 1 || L > kMaxLevels) return static_cast<int>(cudaErrorInvalidValue);
  for (int l = 0; l < kMaxLevels; ++l) lv->res[l] = l < L ? res[l] : 0;
  return 0;
}

unsigned int blocks(long long n, int L) {
  return static_cast<unsigned int>((n * L + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

int hash_grid_max_levels() { return kMaxLevels; }

const char* hash_grid_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x (n, 3) f32; tables (L, T, F) f32, T a power of two; res (L) i32 on the
// host, each level's resolution; writes out (n, L*F) f32.
int hash_encode_fwd(const float* x, const float* tables, long long n, int L, unsigned int T,
                    int F, const int* res, float* out, void* stream) {
  Levels lv;
  if (int err = levels(res, L, &lv)) return err;
  if (n <= 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  if (F == 2)
    hash_encode_fwd_kernel<2><<<blocks(n, L), kThreads, 0, s>>>(x, tables, n, L, T, lv, F, out);
  else
    hash_encode_fwd_kernel<0><<<blocks(n, L), kThreads, 0, s>>>(x, tables, n, L, T, lv, F, out);
  return cudaGetLastError();
}

// x (n, 3) f32; grad_out (n, L*F) f32; adds into grad_tables (L, T, F) f32,
// which the caller zeroes.
int hash_encode_bwd(const float* x, const float* grad_out, long long n, int L, unsigned int T,
                    int F, const int* res, float* grad_tables, void* stream) {
  Levels lv;
  if (int err = levels(res, L, &lv)) return err;
  if (n <= 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  if (F == 2)
    hash_encode_bwd_kernel<2><<<blocks(n, L), kThreads, 0, s>>>(x, grad_out, n, L, T, lv, F,
                                                                grad_tables);
  else
    hash_encode_bwd_kernel<0><<<blocks(n, L), kThreads, 0, s>>>(x, grad_out, n, L, T, lv, F,
                                                                grad_tables);
  return cudaGetLastError();
}

}  // extern "C"
