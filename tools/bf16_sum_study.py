"""How far the bf16 fused forward's kernel lies from exact sums, beside its
variants and one f32 matmul over all of K.

Builds csrc/fused_mlp.cu four times (the softplus as shipped or in the
exact form expf/log1pf/division; tensor-core sums 32 or 16 deep, added in
f32), runs each bf16 kernel on seeded 8x512 nets (seeds 0-2: 1 M random
points, the 128^3 and 255^3 grids, the active 8^3 blocks at 256; seed 0
also a ReLU net) and compares it with the plain forward summed in f64 and
summed in f32 over all of K. Also the f32 sum against f64, the controls
(one bf16 rounding point left out) against f64, and each variant's time at
256^3. Needs a card:

    python3 tools/bf16_sum_study.py [--out build/bf16_sum_study.json]
"""
import argparse, ctypes, json, math, pathlib, shutil, subprocess, sys, time
from concurrent.futures import ThreadPoolExecutor

import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
from sdf_representation_tpu_torch import kernels
from sdf_representation_tpu_torch.ops import fused_mlp as fm
from sdf_representation_tpu_torch.ops import sparse_grid as sg
from sdf_representation_tpu_torch.models import ImplicitNet

parser = argparse.ArgumentParser()
parser.add_argument("--out", default=str(REPO / "build" / "bf16_sum_study.json"))
args = parser.parse_args()
if not torch.cuda.is_available():
    sys.exit("no card: the study runs the CUDA kernels")
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
dev = torch.device("cuda")
HERE = REPO / "build" / "bf16_sum_study"
HERE.mkdir(parents=True, exist_ok=True)

APPROX = """    const float t = __fmul_rn(beta, v);
    const float e = ex2_ftz(__fmul_rn(-fabsf(t), 1.44269504088896341f));
    const float s = __fadd_rn(fmaxf(t, 0.f), __fmul_rn(lg2_ftz(__fadd_rn(1.f, e)), 0.69314718055994531f));
    v = __fmul_rn(s, rb);"""
EXACT = """    const float t = __fmul_rn(beta, v);
    v = __fdiv_rn(__fadd_rn(fmaxf(t, 0.f), log1pf(expf(-fabsf(t)))), beta);"""
SUMK = "constexpr int kSumK = 32;"

variants = {"approx32": (False, 32), "exact32": (True, 32), "exact16": (True, 16), "approx16": (False, 16)}


def make(name, exact, sumk):
    d = HERE / f"csrc_{name}"
    if d.exists():
        shutil.rmtree(d)
    shutil.copytree(kernels.CSRC, d)
    src = (d / "fused_mlp.cu").read_text()
    assert APPROX in src and SUMK in src
    if exact:
        src = src.replace(APPROX, EXACT)
    src = src.replace(SUMK, f"constexpr int kSumK = {sumk};")
    (d / "fused_mlp.cu").write_text(src)
    lib = HERE / f"lib_{name}.so"
    t0 = time.perf_counter()
    p = subprocess.run(["/usr/local/cuda/bin/nvcc", *kernels.nvcc_flags("fused_mlp"), "-o", str(lib),
                        str(d / "fused_mlp.cu")], capture_output=True, text=True)
    if p.returncode:
        raise RuntimeError(p.stdout + p.stderr)
    return name, lib, time.perf_counter() - t0


with ThreadPoolExecutor(4) as pool:
    libs = {n: (l, s) for n, l, s in pool.map(lambda kv: make(kv[0], *kv[1]), variants.items())}
print("built", {n: round(s, 1) for n, (l, s) in libs.items()}, flush=True)


def use(name):
    kernels.load = lambda _n, p=libs[name][0]: ctypes.CDLL(str(p))
    fm._lib.cache_clear()


def rnd(t):
    return t.float().to(torch.bfloat16).to(t.dtype)


def ref(net, x, mode, drop=()):
    """mode 'f64': every layer in f64, rounded to bf16 (through f32) at the
    three points; 'f32': one f32 matmul over all of K."""
    out = torch.empty(x.shape[0], dtype=torch.float32, device=x.device)
    dt = torch.float64 if mode == "f64" else torch.float32
    n_lin = len(net.plain_layers)
    for s in range(0, x.shape[0], 65536):
        xc = x[s:s + 65536].to(dt)
        if "coords" not in drop:
            xc = rnd(xc)
        h = xc
        for layer, (kind, w_h, w_x, b) in enumerate(net.plain_layers):
            w_x = w_x.to(dt) if w_x is not None else None
            b = b.to(dt)
            if kind == "first":
                acc = xc @ w_x + b
            elif kind == "skip":
                acc = (h @ w_h.to(dt) + xc @ w_x) * fm.INV_SQRT2 + b
            else:
                acc = h @ w_h.to(dt) + b
            if layer < n_lin - 1:
                if "acc" not in drop:
                    acc = rnd(acc)
                if net.beta > 0:
                    t = net.beta * acc
                    acc = (torch.clamp_min(t, 0.0) + torch.log1p(torch.exp(-t.abs()))) / net.beta
                else:
                    acc = torch.clamp_min(acc, 0.0)
                h = acc if "act" in drop else rnd(acc)
            else:
                h = acc
        if net.beta <= 0:
            h = torch.tanh(h)
        out[s:s + xc.shape[0]] = h[:, 0].float()
    return out


def stats(a, b):
    d = (a - b).abs()
    return {"max": d.max().item(), "mean": d.mean().item(), "n_gt2e-3": int((d > 2e-3).sum()),
            "n_gt3e-3": int((d > 3e-3).sum()), "n_ne": int((d > 0).sum())}


report = {"card": subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                                 capture_output=True, text=True).stdout.strip(), "runs": {}}
print(report["card"], flush=True)
t_start = time.perf_counter()
for seed in (0, 1, 2):
    gen = torch.Generator().manual_seed(seed)
    model = ImplicitNet(hidden_dims=(512,) * 8, skip_in=(4,), beta=100.0, radius_init=0.5, generator=gen, device=dev)
    relu_model = ImplicitNet(hidden_dims=(512,) * 8, skip_in=(4,), beta=0.0, radius_init=0.5, generator=gen, device=dev)
    pts = (torch.rand(1 << 20, 3, generator=gen) * 2 - 1).to(dev)
    net = fm.FusedNet(model, torch.bfloat16)
    _, mask, _ = sg.coarse_and_certificate(model, 256, 8, 1.5, 0.01)
    ids = torch.nonzero(mask).flatten().to(torch.int32)
    count = torch.tensor([ids.numel()], dtype=torch.int32, device=dev)
    sets = {"points": (lambda: pts, lambda: fm.fused_points(net, pts), net),
            "grid128": (lambda: fm.grid_points(128, 0, 128 ** 3, dev), lambda: fm.fused_grid(net, 128), net),
            "grid255": (lambda: fm.grid_points(255, 0, 255 ** 3, dev), lambda: fm.fused_grid(net, 255), net),
            "blocks256": (lambda: fm.block_points(ids, 256, 8),
                          lambda: fm.fused_blocks(net, ids, count, 256, 8).reshape(-1), net)}
    if seed == 0:
        rnet = fm.FusedNet(relu_model, torch.bfloat16)
        sets["relu_points"] = (lambda: pts, lambda: fm.fused_points(rnet, pts), rnet)
    for sname, (xs, kern, n_) in sets.items():
        x = xs()
        r64 = ref(n_, x, "f64")
        r32 = ref(n_, x, "f32")
        key = f"seed{seed}/{sname}"
        res = {"f32_vs_f64": stats(r32, r64), "n": x.shape[0]}
        for v in variants:
            use(v)
            k = kern()
            torch.cuda.synchronize()
            res[f"{v}_vs_f64"] = stats(k, r64)
            res[f"{v}_vs_f32"] = stats(k, r32)
        if seed == 0 and sname in ("points", "grid128", "blocks256"):
            for drop in (("coords",), ("acc",), ("act",)):
                res["control_" + drop[0]] = stats(ref(n_, x, "f64", drop), r64)
        report["runs"][key] = res
        print(key, json.dumps(res), flush=True)
        del x, r64, r32
    torch.cuda.empty_cache()
    print("elapsed", time.perf_counter() - t_start, flush=True)

# times at 256^3, seed 0 net, interleaved
gen = torch.Generator().manual_seed(0)
model = ImplicitNet(hidden_dims=(512,) * 8, skip_in=(4,), beta=100.0, radius_init=0.5, generator=gen, device=dev)
net = fm.FusedNet(model, torch.bfloat16)
times = {v: [] for v in variants}
for rep in range(2):
    for v in variants:
        use(v)
        fm.fused_grid(net, 256)
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(3):
            fm.fused_grid(net, 256)
        b.record()
        torch.cuda.synchronize()
        times[v].append(a.elapsed_time(b) / 3)
report["grid256_ms"] = times
print("grid256 ms", times, flush=True)
pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
pathlib.Path(args.out).write_text(json.dumps(report, indent=1))
