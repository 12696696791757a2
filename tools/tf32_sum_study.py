"""How far the f32 fused forward's split-TF32 kernels lie from the f32 plain
version, by the depth of their tensor-core group sums.

Builds csrc/fused_mlp.cu in four variants: group sums 32 (as shipped), 16
and 8 K deep, and a single TF32 pass (hi.hi only, 32 deep); runs each f32 kernel
on seeded 8x512 nets (1 M random points, the 128^3 grid, the active 8^3
blocks at 256; the first seed also a ReLU/tanh net) and compares it with the
f32 plain version (fused_mlp.forward_plain) and the split-TF32 emulation
(fused_mlp.forward_tf32_model, f64 sums, 3 and 1 passes); then each
variant's time at 256^3, interleaved. Needs a card:

    python3 tools/tf32_sum_study.py [--out build/tf32_sum_study.json] [--seeds 0,1,2]
"""
import argparse
import ctypes
import json
import pathlib
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
from sdf_representation_tpu_torch import kernels  # noqa: E402
from sdf_representation_tpu_torch.models import ImplicitNet  # noqa: E402
from sdf_representation_tpu_torch.ops import fused_mlp as fm  # noqa: E402
from sdf_representation_tpu_torch.ops import sparse_grid as sg  # noqa: E402

parser = argparse.ArgumentParser()
parser.add_argument("--out", default=str(REPO / "build" / "tf32_sum_study.json"))
parser.add_argument("--seeds", default="0,1,2")
args = parser.parse_args()
if not torch.cuda.is_available():
    sys.exit("no card: the study runs the CUDA kernels")
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
dev = torch.device("cuda")
HERE = REPO / "build" / "tf32_sum_study"
HERE.mkdir(parents=True, exist_ok=True)
F32_TOL = 2e-5

SUMK, PASSES = "constexpr int kF32SumK = 32;", "constexpr int kF32Passes = 3;"
variants = {"sum32": (32, 3), "sum16": (16, 3), "sum8": (8, 3), "one_pass": (32, 1)}


def make(name, sumk, passes):
    d = HERE / f"csrc_{name}"
    if d.exists():
        shutil.rmtree(d)
    shutil.copytree(kernels.CSRC, d)
    src = (d / "fused_mlp.cu").read_text()
    assert SUMK in src and PASSES in src, "csrc/fused_mlp.cu no longer holds the study's constants"
    src = src.replace(SUMK, f"constexpr int kF32SumK = {sumk};").replace(
        PASSES, f"constexpr int kF32Passes = {passes};")
    (d / "fused_mlp.cu").write_text(src)
    lib = HERE / f"lib_{name}.so"
    t0 = time.perf_counter()
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    p = subprocess.run([nvcc, *kernels.nvcc_flags("fused_mlp"), "-o", str(lib), str(d / "fused_mlp.cu")],
                       capture_output=True, text=True)
    if p.returncode:
        raise RuntimeError(f"{name}: {p.stdout}{p.stderr}")
    return name, lib, time.perf_counter() - t0


with ThreadPoolExecutor(len(variants)) as pool:
    libs = {n: (lib, s) for n, lib, s in pool.map(lambda kv: make(kv[0], *kv[1]), variants.items())}
print("built", {n: round(s, 1) for n, (_, s) in libs.items()}, flush=True)


def use(name):
    kernels.load = lambda _n, p=libs[name][0]: ctypes.CDLL(str(p))
    fm._lib.cache_clear()


def stats(a, b):
    d = (a - b).abs()
    return {"max": d.max().item(), "mean": d.mean().item(), "n_gt_tol": int((d > F32_TOL).sum())}


report = {"card": subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                                 capture_output=True, text=True).stdout.strip(),
          "variants": {n: {"sum_k": k, "passes": p} for n, (k, p) in variants.items()}, "runs": {}}
print(report["card"], flush=True)
t_start = time.perf_counter()
for seed in [int(s) for s in args.seeds.split(",")]:
    gen = torch.Generator().manual_seed(seed)
    model = ImplicitNet(hidden_dims=(512,) * 8, skip_in=(4,), beta=100.0, radius_init=0.5, generator=gen,
                        device=dev)
    relu_model = ImplicitNet(hidden_dims=(512,) * 8, skip_in=(4,), beta=0.0, radius_init=0.5, generator=gen,
                             device=dev)
    pts = (torch.rand(1 << 20, 3, generator=gen) * 2 - 1).to(dev)
    net = fm.FusedNet(model, torch.float32)
    _, mask, _ = sg.coarse_and_certificate(model, 256, 8, 1.5, 0.01)
    ids = torch.nonzero(mask).flatten().to(torch.int32)
    count = torch.tensor([ids.numel()], dtype=torch.int32, device=dev)
    sets = {"points": (pts, lambda n: fm.fused_points(n, pts), net),
            "grid128": (fm.grid_points(128, 0, 128 ** 3, dev), lambda n: fm.fused_grid(n, 128), net),
            "blocks256": (fm.block_points(ids, 256, 8),
                          lambda n: fm.fused_blocks(n, ids, count, 256, 8).reshape(-1), net)}
    if seed == int(args.seeds.split(",")[0]):
        sets["relu_points"] = (pts, lambda n: fm.fused_points(n, pts), fm.FusedNet(relu_model, torch.float32))
    for sname, (x, kern, n_) in sets.items():
        plain = fm.forward_plain(n_, x)
        key = f"seed{seed}/{sname}"
        res = {"n": x.shape[0], "emulated_3_passes": stats(fm.forward_tf32_model(n_, x, 3), plain),
               "emulated_1_pass": stats(fm.forward_tf32_model(n_, x, 1), plain)}
        for v in variants:
            use(v)
            k = kern(n_)
            torch.cuda.synchronize()
            res[v] = stats(k, plain)
        report["runs"][key] = res
        print(key, json.dumps(res), flush=True)
        del plain
    torch.cuda.empty_cache()
    print("elapsed", round(time.perf_counter() - t_start, 1), flush=True)

# times at 256^3 (kernel 1), first seed's net, interleaved
gen = torch.Generator().manual_seed(int(args.seeds.split(",")[0]))
model = ImplicitNet(hidden_dims=(512,) * 8, skip_in=(4,), beta=100.0, radius_init=0.5, generator=gen, device=dev)
net = fm.FusedNet(model, torch.float32)
times = {v: [] for v in variants}
for rep in range(2):
    for v in variants:
        use(v)
        fm.fused_grid(net, 256)
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(2):
            fm.fused_grid(net, 256)
        b.record()
        torch.cuda.synchronize()
        times[v].append(a.elapsed_time(b) / 2)
report["grid256_ms"] = times
print("grid256 ms", json.dumps(times), flush=True)
pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
pathlib.Path(args.out).write_text(json.dumps(report, indent=1))
