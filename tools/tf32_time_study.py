"""Where the f32 (split-TF32) fused forward's time goes.

Builds csrc/fused_mlp.cu as shipped and in variants that each change one
thing (text substitutions in a copy of csrc/), times each interleaved on the
card at the main path's shapes (kernel 1 over the 256^3 grid, kernel 3 over
the seeded 8x512 net's active 8^3 blocks at 256, kernel 2 over 1 M points),
and gives each variant's largest difference from the shipped build on the
points. Then the TF32 tensor-core rate with A from registers alone: a kernel
that only issues m64nNk8 TF32 products from two warpgroups an SM, waiting
for every batch. Needs a card:

    python3 tools/tf32_time_study.py [--out build/tf32_time_study.json]

Variants:
  hi_only    copies only the hi image of each weight stage: half the bytes
             read from L2 (the results are wrong)
  max_act    softplus replaced by max(t, 0) / beta: the epilogue's cost (the
             results are wrong)
  one_pass   hi.hi only: a single TF32 pass
  stages2    two weight stages in each consumer's ring instead of three
  cvt_rna    TF32 rounding by cvt.rna.tf32.f32 instead of integer arithmetic
             (the same results)
  fdiv       the softplus divided by beta instead of scaled by RN(1 / beta)
"""
import argparse
import ctypes
import json
import pathlib
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
from sdf_representation_tpu_torch import kernels  # noqa: E402
from sdf_representation_tpu_torch.models import ImplicitNet  # noqa: E402
from sdf_representation_tpu_torch.ops import fused_mlp as fm  # noqa: E402
from sdf_representation_tpu_torch.ops import sparse_grid as sg  # noqa: E402

parser = argparse.ArgumentParser()
parser.add_argument("--out", default=str(REPO / "build" / "tf32_time_study.json"))
args = parser.parse_args()
if not torch.cuda.is_available():
    sys.exit("no card: the study runs the CUDA kernels")
torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device("cuda")
HERE = REPO / "build" / "tf32_time_study"
HERE.mkdir(parents=True, exist_ok=True)
NVCC = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"

PRODUCE = "hopper::produce(ring, src + size_t(r) * NQ * kbs * kF32StageBytes, kF32StageBytes, NQ * kbs);"
SOFTPLUS = "return __fmul_rn(__fadd_rn(fmaxf(t, 0.f), log1pf(expf(-fabsf(t)))), rb);"
RNA = "__device__ __forceinline__ uint32_t tf32_rna(float v) { return (__float_as_uint(v) + 0x1000u) & 0xFFFFE000u; }"
VARIANTS = {  # name: [(file, text as shipped, replacement)]
    "shipped": [],
    "hi_only": [("fused_mlp.cu", PRODUCE, PRODUCE.replace(", kF32StageBytes, NQ", ", hopper::kTf32ImageBytes, NQ"))],
    "max_act": [("hopper.cuh", SOFTPLUS, "return __fmul_rn(fmaxf(t, 0.f), rb);")],
    "one_pass": [("fused_mlp.cu", "constexpr int kF32Passes = 3;", "constexpr int kF32Passes = 1;")],
    "stages2": [("fused_mlp.cu", "constexpr int kF32Stages = 3;", "constexpr int kF32Stages = 2;")],
    "cvt_rna": [("hopper.cuh", RNA, "__device__ __forceinline__ uint32_t tf32_rna(float v) {\n  uint32_t r;\n"
                 "  asm(\"cvt.rna.tf32.f32 %0, %1;\" : \"=r\"(r) : \"f\"(v));\n  return r;\n}")],
    "fdiv": [("hopper.cuh", SOFTPLUS,
              "return __fdiv_rn(__fadd_rn(fmaxf(t, 0.f), log1pf(expf(-fabsf(t)))), beta);")],
}

# the tensor-core rate alone: `iters` batches of `batch` products a warpgroup
RATE_SRC = r'''
#include "hopper.cuh"
template <int N> __device__ __forceinline__ void product(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b);
template <> __device__ __forceinline__ void product<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  hopper::wgmma_m64n64k8_tf32(d, a, b, 1);
}
template <> __device__ __forceinline__ void product<8>(float (&d)[4], const uint32_t (&a)[4], uint64_t b) {
  hopper::wgmma_m64n8k8_tf32(d, a, b, 1);
}
template <int N, int kBatch>
__global__ void __launch_bounds__(256, 1) rate_kernel(int iters, float* out, long long* cycles) {
  extern __shared__ uint8_t raw[];
  uint8_t* smem = hopper::aligned_smem(raw);
  for (int i = threadIdx.x; i < 8192; i += blockDim.x) reinterpret_cast<float*>(smem)[i] = 0.f;
  __syncthreads();
  float d[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) d[i] = 0.f;
  const uint32_t a[4] = {0x3f800000u, 0x3f800000u, 0x3f800000u, 0x3f800000u};
  const uint64_t db = hopper::desc_k_sw128(smem);
  const long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
    hopper::wgmma_fence();
#pragma unroll
    for (int u = 0; u < kBatch; ++u) product<N>(d, a, db + ((32 * (u % 4)) >> 4));
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_registers(d);
  }
  const long long t1 = clock64();
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) s += d[i];
  out[blockIdx.x * 256 + threadIdx.x] = s;
  if (threadIdx.x == 0) cycles[blockIdx.x] = t1 - t0;
}
extern "C" int rate(int n, int batch, int iters, float* out, long long* cycles, int ctas) {
  auto go = [&](auto k) {
    cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, 40000);
    k<<<ctas, 256, 40000>>>(iters, out, cycles);
    return static_cast<int>(cudaGetLastError());
  };
  if (n == 64 && batch == 12) return go(rate_kernel<64, 12>);
  if (n == 64 && batch == 4) return go(rate_kernel<64, 4>);
  if (n == 8 && batch == 12) return go(rate_kernel<8, 12>);
  return -1;
}
'''


def build(name):
    d = HERE / f"csrc_{name}"
    if d.exists():
        shutil.rmtree(d)
    shutil.copytree(kernels.CSRC, d)
    for file, old, new in VARIANTS[name]:
        src = (d / file).read_text()
        if old not in src:
            raise RuntimeError(f"{name}: csrc/{file} no longer holds {old!r}")
        (d / file).write_text(src.replace(old, new))
    lib = HERE / f"lib_{name}.so"
    p = subprocess.run([NVCC, *kernels.nvcc_flags("fused_mlp"), "-o", str(lib), str(d / "fused_mlp.cu")],
                       capture_output=True, text=True)
    if p.returncode:
        raise RuntimeError(f"{name}: {p.stdout}{p.stderr}")
    return name, lib


def build_rate():
    src = HERE / "rate.cu"
    src.write_text(RATE_SRC)
    lib = HERE / "librate.so"
    p = subprocess.run([NVCC, *kernels.nvcc_flags("fused_mlp"), "-I", str(kernels.CSRC), "-o", str(lib), str(src)],
                       capture_output=True, text=True)
    if p.returncode:
        raise RuntimeError(f"rate: {p.stdout}{p.stderr}")
    return lib


with ThreadPoolExecutor(len(VARIANTS) + 1) as pool:
    rate_lib = pool.submit(build_rate)
    libs = dict(pool.map(build, VARIANTS))
    rate_lib = rate_lib.result()


def use(name):
    kernels.load = lambda _n, p=libs[name]: ctypes.CDLL(str(p))
    fm._lib.cache_clear()


def timed(fn, reps):
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


report = {"card": subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                                 capture_output=True, text=True).stdout.strip()}
print(report["card"], flush=True)
gen = torch.Generator().manual_seed(0)
model = ImplicitNet(hidden_dims=(512,) * 8, skip_in=(4,), beta=100.0, radius_init=0.5, generator=gen, device=dev)
net = fm.FusedNet(model, torch.float32)
pts = (torch.rand(1 << 20, 3, generator=gen) * 2 - 1).to(dev)
_, mask, _ = sg.coarse_and_certificate(model, 256, 8, 1.5, 0.01)
ids = torch.nonzero(mask).flatten().to(torch.int32)
count = torch.tensor([ids.numel()], dtype=torch.int32, device=dev)
use("shipped")
ref = fm.fused_points(net, pts)
report["max_diff_from_shipped"] = {}
for name in VARIANTS:
    use(name)
    report["max_diff_from_shipped"][name] = (fm.fused_points(net, pts) - ref).abs().max().item()
print("max |variant - shipped| on 1 M points:", json.dumps(report["max_diff_from_shipped"]), flush=True)
report["ms"] = {name: [] for name in VARIANTS}
for rep in range(2):
    for name in VARIANTS:
        use(name)
        row = {"grid256": timed(lambda: fm.fused_grid(net, 256), 2),
               "blocks256": timed(lambda: fm.fused_blocks(net, ids, count, 256, 8), 5),
               "points1M": timed(lambda: fm.fused_points(net, pts), 5)}
        report["ms"][name].append(row)
        print(name, rep, json.dumps(row), flush=True)

lib = ctypes.CDLL(str(rate_lib))
lib.rate.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2 + [ctypes.c_int]
lib.rate.restype = ctypes.c_int
sms = torch.cuda.get_device_properties(0).multi_processor_count
out = torch.empty(sms * 256, device=dev)
cycles = torch.empty(sms, dtype=torch.int64, device=dev)
report["rate"] = {}
for n, batch in ((64, 12), (64, 4), (8, 12)):
    iters = 2000
    if lib.rate(n, batch, iters, out.data_ptr(), cycles.data_ptr(), sms) != 0:
        raise RuntimeError(f"rate kernel n={n} batch={batch} failed")
    torch.cuda.synchronize()
    macs = 2 * iters * batch * 64 * n * 8  # two warpgroups an SM
    row = {"mac_per_clock_per_sm": macs / cycles.double().mean().item()}
    report["rate"][f"m64n{n}k8_batch{batch}"] = row
    print(f"m64n{n}k8 TF32, A from registers, batches of {batch}: {json.dumps(row)}", flush=True)
pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
pathlib.Path(args.out).write_text(json.dumps(report, indent=1))
