"""How far the bf16 eikonal kernels (csrc/fused_igr.cu) lie from exact sums,
beside a variant with the fused forward's cheaper softplus and beside the
f32-summed plain version (the JAX kernels' arithmetic, and the plain
versions' own before they summed exactly).

The plain versions of ops/fused_igr.py sum exactly (f64) in bf16 mode. This
study builds csrc/fused_igr.cu as shipped and with softplus_fast and
1 - ex2(-beta h) in place of softplus_rel and one_minus_exp_neg, and holds
each, and the plain version summed in f32, against the exact sums:
  * softplus nets 8x512 (seeds 0, 1; N = 16,384) and 8x256 (seed 2;
    N = 5,461): f, grad f, the gradients, and each variant's times; the
    shipped kernel also against the f32-summed plain version;
  * ReLU/tanh nets of depth 4 and 8 (width 512, skip at depth / 2, seeds
    0 .. --relu-seeds - 1) on the n of m uniform points whose hidden
    pre-activations stay farthest from zero (chip_smoke.py's "relu_clear"
    pick; n, m: 4,096 of 262,144, and at depth 8 also 1,024 of 16,777,216,
    where the least |z| kept is about twice as large): the same readings,
    every control of chip_smoke.py's phase 3, and whether the kernel and
    the f32 plain version hold phase 3's bf16 limits with every control
    failing ("verdict").
Needs a card:

    python3 tools/igr_sum_study.py [--out build/igr_sum_study.json] [--relu-only] [--relu-seeds 6]
"""
import argparse, ctypes, json, pathlib, shutil, subprocess, sys, time
from concurrent.futures import ThreadPoolExecutor

import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
import chip_smoke as cs
from sdf_representation_tpu_torch import kernels
from sdf_representation_tpu_torch.models import ImplicitNet
from sdf_representation_tpu_torch.ops import fused_igr as fi
from sdf_representation_tpu_torch.ops import fused_mlp as fm

parser = argparse.ArgumentParser()
parser.add_argument("--out", default=str(REPO / "build" / "igr_sum_study.json"))
parser.add_argument("--relu-only", action="store_true", help="leave out the softplus nets and the variant")
parser.add_argument("--relu-seeds", type=int, default=2)
args = parser.parse_args()
if not torch.cuda.is_available():
    sys.exit("no card: the study runs the CUDA kernels")
torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device("cuda")
HERE = REPO / "build" / "igr_sum_study"
HERE.mkdir(parents=True, exist_ok=True)

APPROX = [("hopper.cuh", "  return one_minus_exp_neg(__fmul_rn(beta, h));",
           "  return __fsub_rn(1.f, ex2_ftz(__fmul_rn(__fmul_rn(-beta, h), kLog2E)));"),
          ("fused_igr.cu", "return softplus_rel(z, beta, rb);", "return softplus_fast(z, beta, rb);")]


def make(name, subs):
    d = HERE / f"csrc_{name}"
    if d.exists():
        shutil.rmtree(d)
    shutil.copytree(kernels.CSRC, d)
    for fname, old, new in subs:
        text = (d / fname).read_text()
        assert old in text, old
        (d / fname).write_text(text.replace(old, new))
    lib = HERE / f"lib_{name}.so"
    p = subprocess.run(["/usr/local/cuda/bin/nvcc", *kernels.nvcc_flags("fused_igr"), "-o", str(lib),
                        str(d / "fused_igr.cu")], capture_output=True, text=True)
    if p.returncode:
        raise RuntimeError(p.stdout + p.stderr)
    return name, lib


variants = {"shipped": []} if args.relu_only else {"shipped": [], "approx": APPROX}
with ThreadPoolExecutor(2) as pool:
    libs = dict(pool.map(lambda kv: make(*kv), variants.items()))


def use(name):
    kernels.load = lambda _n, p=libs[name]: ctypes.CDLL(str(p))
    fi._lib.cache_clear()


exact_arith = fi._plain_arith


def f32_arith(net):
    """the plain versions' arithmetic before they summed exactly: f32
    matmuls, rounding f32 to bf16"""
    layers = [(k, *(None if t is None else t.float() for t in ts)) for k, *ts in fi._head_layers(net)]
    return torch.float32, (lambda t: t.to(torch.bfloat16).float()), layers


def plain(net, x, a, c, shapes, arith):
    fi._plain_arith = arith
    try:
        return fi.fused_value_and_grad_plain(net, x), fi.unpack_grads(3, shapes, fi.fused_param_grads_plain(net, x, a, c))
    finally:
        fi._plain_arith = exact_arith


def kernel(net, x, a, c, shapes, name):
    use(name)
    out = fi.fused_value_and_grad(net, x), fi.unpack_grads(3, shapes, fi.fused_param_grads(net, x, a, c))
    torch.cuda.synchronize()
    return out


def readings(got, want):
    (f, g), grads = got
    (pf, pg), pgrads = want
    dg = (g - pg).abs()
    mean, worst = cs.gradient_errors(grads, pgrads)
    return {"f_max": (f - pf).abs().max().item(), "f_mean": (f - pf).abs().mean().item(),
            "grad_f_max": dg.max().item(), "grad_f_mean": dg.mean().item(),
            "grad_f_over_1e-2": (dg.amax(dim=1) > 1e-2).float().mean().item(),
            "grads_mean": mean, "grads_worst": worst}


def show(tag, r):
    print(tag + ": " + " ".join(f"{k} {v:.3e}" for k, v in r.items()), flush=True)


report = {"card": subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                                 capture_output=True, text=True).stdout.strip()}
print(report["card"], flush=True)
for seed, width, n in () if args.relu_only else ((0, 512, 16384), (1, 512, 16384), (2, 256, 5461)):
    gen = torch.Generator().manual_seed(seed)
    model = ImplicitNet(hidden_dims=(width,) * 8, skip_in=(4,), beta=100.0, radius_init=0.5, generator=gen,
                        device=dev)
    x = (torch.rand(n, 3, generator=gen) * 2 - 1).to(dev)
    a, c = (torch.randn(n, generator=gen) / n).to(dev), (torch.randn(n, 3, generator=gen) / n).to(dev)
    net = fm.FusedNet(model, torch.bfloat16)
    shapes = [w.shape for w, _ in model.effective_layers()]
    want = plain(net, x, a, c, shapes, exact_arith)
    f32 = plain(net, x, a, c, shapes, f32_arith)
    tag = f"softplus/8x{width}/seed{seed}/n{n}"
    for name in libs:
        got = kernel(net, x, a, c, shapes, name)
        r = readings(got, want)
        report[f"{tag}/{name}"] = r
        show(f"{tag}/{name}", r)
        if name == "shipped":  # against the plain versions' earlier arithmetic
            r = readings(got, f32)
            report[f"{tag}/{name}_vs_plain_f32"] = r
            show(f"{tag}/{name} against plain_f32", r)
    r = readings(f32, want)
    report[f"{tag}/plain_f32"] = r
    show(f"{tag}/plain_f32", r)
    times = {}
    for name in ("shipped", "approx", "approx", "shipped"):  # in turns
        use(name)
        times.setdefault(name, []).append((cs.timed(lambda: fi.fused_value_and_grad(net, x), 20),
                                           cs.timed(lambda: fi.fused_param_grads(net, x, a, c), 20)))
    for name, t in times.items():
        report[f"{tag}/{name}"]["ms"] = t
        print(f"{tag}/{name} ms (fwd, bwd): {t}", flush=True)

def holds(r):
    """phase 3's bf16 limits for the ReLU/tanh "relu_clear" case"""
    return (r["f_max"] <= cs.IGR_BF16_TOL and r["f_mean"] <= cs.IGR_BF16_F_MEAN_TOL
            and r["grad_f_max"] <= cs.IGR_BF16_TOL and r["grad_f_mean"] <= cs.IGR_BF16_G_MEAN_TOL
            and r["grads_mean"] <= cs.IGR_GRAD_MEAN_TOL and r["grads_worst"] <= cs.IGR_RELU_BF16_GRAD_MAX_TOL)


def controls(net, x, a, c, shapes, want):
    """phase 3's controls: {name: (readings, fails the limits)}"""
    (pf, pg), pgrads = want
    out = {}
    for drop in ("x", "act", "cotangent"):
        cf, cg, _ = cs.igr_fwd_dropping(net, x, (drop,))
        ef, eg = (cf - pf).abs().mean().item(), (cg - pg).abs().mean().item()
        out[f"igr_fwd/without_{drop}"] = ({"f_mean": ef, "grad_f_mean": eg},
                                          not (ef <= cs.IGR_BF16_F_MEAN_TOL and eg <= cs.IGR_BF16_G_MEAN_TOL))
    for drop in ("x", "stash", "cotangent", "head"):
        m, w = cs.gradient_errors(fi.unpack_grads(3, shapes, cs.igr_bwd_dropping(net, x, a, c, (drop,))), pgrads)
        out[f"igr_bwd/without_{drop}"] = ({"grads_mean": m, "grads_worst": w},
                                          not (m <= cs.IGR_GRAD_MEAN_TOL and w <= cs.IGR_RELU_BF16_GRAD_MAX_TOL))
    return out


PICKS = {4: ((4096, 1 << 18),), 8: ((4096, 1 << 18), (1024, 1 << 24))}
for depth, picks in PICKS.items():
    for seed in range(args.relu_seeds):
        gen = torch.Generator().manual_seed(100 + seed)
        model = ImplicitNet(hidden_dims=(512,) * depth, skip_in=(depth // 2,), beta=0.0, radius_init=0.5,
                            generator=gen, device=dev)
        net = fm.FusedNet(model, torch.bfloat16)
        shapes = [w.shape for w, _ in model.effective_layers()]
        cand = (torch.rand(max(m for _, m in picks), 3, generator=gen) * 2 - 1).to(dev)
        margin = torch.cat([cs.igr_fwd_dropping(net, part, ())[2] for part in cand.split(1 << 16)])
        for n, m in picks:  # the first m candidates
            a, c = (torch.randn(n, generator=gen) / n).to(dev), (torch.randn(n, 3, generator=gen) / n).to(dev)
            top = torch.topk(margin[:m], n)
            x = cand[top.indices].contiguous()
            want = plain(net, x, a, c, shapes, exact_arith)
            tag = f"relu_clear/{depth}x512/n{n}_of_{m}/seed{seed}"
            entry = {"margin": top.values.min().item()}
            for name, got in (("shipped", kernel(net, x, a, c, shapes, "shipped")),
                              ("plain_f32", plain(net, x, a, c, shapes, f32_arith))):
                r = readings(got, want)
                entry[name] = dict(r, holds=holds(r))
                show(f"{tag}/{name} (|z| >= {entry['margin']:.2e}) holds {holds(r)}", r)
            ctl = controls(net, x, a, c, shapes, want)
            entry["controls"] = {k: dict(v, fails=f) for k, (v, f) in ctl.items()}
            for k, (v, f) in ctl.items():
                show(f"{tag}/control {k} fails {f}", v)
            entry["verdict"] = {name: entry[name]["holds"] and all(f for _, f in ctl.values())
                                for name in ("shipped", "plain_f32")}
            print(f"{tag}: verdict {entry['verdict']}", flush=True)
            report[tag] = entry

pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
pathlib.Path(args.out).write_text(json.dumps(report, indent=1))
