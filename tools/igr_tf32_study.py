"""The f32 eikonal kernels (csrc/fused_igr.cu, namespace tf32: igr_fwd,
igr_bwd and its dW pass) on the card: their SASS (HGMMA on TF32 operands,
no local memory), f, grad f and every dW / db against the plain f32
versions at the eikonal runs' shapes and at small odd ones, beside the
split-TF32 emulation (fused_igr.fused_value_and_grad_tf32_model,
fused_param_grads_tf32_model) with three passes and with one; two launches
of the backward compared bit for bit; the backward's workspace against
fused_igr.images_plain and its dW pass against dw_pass_plain. Then times
(CUDA events) of both kernels, the dW pass alone and the library's
(f, grad f) and double backward (cuBLAS, autograd) at (8x512, N 16,384) and
(8x256, N 5,461). Needs a card:

    python3 tools/igr_tf32_study.py [--quick | --waves] [--out build/igr_tf32_study.json]

--quick: the checks at the small shapes only, no timing. --waves: only the
times of both kernels at point counts that fill the card's SMs exactly
once and twice (64 points a CTA forward, 32 backward) beside the eikonal
runs' N (16,384 at 8x512: 1.94 forward waves; 5,461 at 8x256: 0.65).
"""
import argparse
import contextlib
import io
import json
import math
import pathlib
import subprocess
import sys
import time

import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
from sdf_representation_tpu_torch import kernels  # noqa: E402
from sdf_representation_tpu_torch.models import ImplicitNet  # noqa: E402
from sdf_representation_tpu_torch.ops import fused_igr as fi  # noqa: E402
from sdf_representation_tpu_torch.ops import fused_mlp as fm  # noqa: E402

parser = argparse.ArgumentParser()
parser.add_argument("--quick", action="store_true")
parser.add_argument("--waves", action="store_true")
parser.add_argument("--out", default=str(REPO / "build" / "igr_tf32_study.json"))
args = parser.parse_args()
if not torch.cuda.is_available():
    sys.exit("no card: the study runs the CUDA kernels")
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
dev = torch.device("cuda")
card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                      capture_output=True, text=True).stdout.strip()
print(f"card: {card}", flush=True)
t0 = time.perf_counter()
with contextlib.redirect_stdout(io.StringIO()) as ptxas:
    build_s = kernels.build_all(["fused_igr", "fused_mlp"], verbose=True)
print(f"build (s): {build_s}, {time.perf_counter() - t0:.1f} s", flush=True)
fn = None
for line in ptxas.getvalue().splitlines():  # ptxas's warnings, and each function's stack and spills
    if "Function properties for" in line:
        fn = line.split("for ")[-1]
    elif "warning" in line or ("stack frame" in line and not line.strip().startswith("0 bytes stack")):
        print(f"ptxas {fn}: {line.strip()}", flush=True)
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402

report = {"card": card}
if args.waves:
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for width, runs in ((512, (16384,)), (256, (5461,))):
        model = ImplicitNet(hidden_dims=(width,) * 8, skip_in=(4,), beta=100.0, radius_init=0.5,
                            generator=torch.Generator().manual_seed(0), device=dev)
        net = fm.FusedNet(model, torch.float32)
        for n in sorted({*runs, 64 * sms, 128 * sms, 32 * sms, 64 * sms // 2}):
            gen = torch.Generator().manual_seed(n)
            x = (torch.rand(n, 3, generator=gen) * 2 - 1).to(dev)
            a = (torch.randn(n, generator=gen) / n).to(dev)
            c = (torch.randn(n, 3, generator=gen) / n).to(dev)
            row = {"points": n, "fwd_waves": n / 64 / sms, "bwd_waves": n / 32 / sms,
                   "igr_fwd_ms": chip_smoke.timed(lambda: fi.fused_value_and_grad(net, x), 10),
                   "igr_bwd_ms": chip_smoke.timed(lambda: fi.fused_param_grads(net, x, a, c), 10)}
            row["igr_fwd_us_per_1k_points"] = row["igr_fwd_ms"] / n * 1e6
            row["igr_bwd_us_per_1k_points"] = row["igr_bwd_ms"] / n * 1e6
            print(f"waves 8x{width}: {json.dumps(row)}", flush=True)
            report.setdefault("waves", []).append({"width": width, **row})
    pathlib.Path(args.out).write_text(json.dumps(report, indent=1))
    sys.exit(0)
try:
    report["sass"] = chip_smoke.check_sass(kernels.library_path("fused_igr"), r"4tf32\d+igr_", 17, tf32=True)
except RuntimeError as err:  # reported, and the checks below still run
    report["sass_error"] = str(err)
    print(f"sass check failed: {err}", flush=True)
sass = subprocess.run(["cuobjdump", "-sass", str(kernels.library_path("fused_igr"))], capture_output=True,
                      text=True).stdout
fn = None
for line in sass.splitlines():
    if "Function :" in line:
        fn = line.split("Function :")[-1].strip()
    elif fn and "4tf32" in fn and "HGMMA" in line and "TF32" not in line:
        print(f"non-TF32 HGMMA line in {fn}: {line.strip()}", flush=True)


def rel_worst(model, got, want):
    """The worst tensor's max |diff| / max |want| over the module's gradients."""
    shapes = [w.shape for w, _ in model.effective_layers()]
    got, want = (fi.unpack_grads(model.d_in, shapes, t) for t in (got, want))
    return max(float((u - v).abs().max()) / max(float(v.abs().max()), 1e-30) for u, v in zip(got, want))


def case(width, depth, skip, beta, n, d_in, seed=0):
    gen = torch.Generator().manual_seed(seed)
    model = ImplicitNet(d_in=d_in, hidden_dims=(width,) * depth, skip_in=skip, beta=beta, radius_init=0.5,
                        generator=gen, device=dev)
    x = (torch.rand(n, d_in, generator=gen) * 2 - 1).to(dev)
    a = (torch.randn(n, generator=gen) / n).to(dev)
    c = (torch.randn(n, d_in, generator=gen) / n).to(dev)
    return model, fm.FusedNet(model, torch.float32), x, a, c


def check(tag, width, depth, skip, beta, n, d_in):
    model, net, x, a, c = case(width, depth, skip, beta, n, d_in)
    f, g = fi.fused_value_and_grad(net, x)
    got = fi.fused_param_grads(net, x, a, c)
    again = fi.fused_param_grads(net, x, a, c)
    torch.cuda.synchronize()
    pf, pg = fi.fused_value_and_grad_plain(net, x)
    want = fi.fused_param_grads_plain(net, x, a, c)
    row = {"f_max": float((f - pf).abs().max()), "grad_f_max": float((g - pg).abs().max()),
           "grads_worst_rel": rel_worst(model, got, want),
           "bit_equal": all(torch.equal(u, v) for p, q in zip(got, again) for u, v in zip(p, q) if u is not None),
           "finite": bool(torch.isfinite(f).all() and torch.isfinite(g).all())}
    for passes in (3, 1):
        ef, eg = fi.fused_value_and_grad_tf32_model(net, x, passes)
        row[f"emulated_{passes}"] = {"f_max": float((ef - pf).abs().max()), "grad_f_max": float((eg - pg).abs().max()),
                                     "grads_worst_rel": rel_worst(
                                         model, fi.fused_param_grads_tf32_model(net, x, a, c, passes), want)}
    # the two passes of the backward on their own
    _, _, (ws, part) = fi._bwd_cuda(net, x, a, c)
    pws, ppart = fi.images_plain(net, x, a, c)
    torch.cuda.synchronize()
    row["workspace_mean_rel"] = float((ws - pws).abs().mean() / pws.abs().mean())
    row["db_partials_mean_rel"] = float((part - ppart).abs().mean() / ppart.abs().max())
    gw, gb = fi.dw_pass(net, pws, ppart)
    qw, qb = fi.dw_pass_plain(net, pws, ppart)
    row["dw_pass_max_rel"] = max(float((gw - qw).abs().max() / qw.abs().max()),
                                 float((gb - qb).abs().max() / qb.abs().max()))
    print(f"check {tag}: {json.dumps(row)}", flush=True)
    report.setdefault("checks", {})[tag] = row
    return model, net, x, a, c


small = [("3x128/d2/n1", 128, 3, (2,), 100.0, 1, 2), ("3x384/n97", 384, 3, (2,), 100.0, 97, 3),
         ("2x256/relu/n64", 256, 2, (), 0.0, 64, 3), ("1x128/d4/n65", 128, 1, (), 100.0, 65, 4),
         ("4x512/relu/n333", 512, 4, (2,), 0.0, 333, 3)]
for spec in small:
    check(*spec)
if not args.quick:
    timed_cases = {}
    for spec in [("8x512/n16384", 512, 8, (4,), 100.0, 16384, 3), ("8x256/n5461", 256, 8, (4,), 100.0, 5461, 3),
                 ("8x512/relu/n16384", 512, 8, (4,), 0.0, 16384, 3)]:
        out = check(*spec)
        if "relu" not in spec[0]:
            timed_cases[spec[0]] = out

    def library_vag(model, x, a, c, backward):
        params = [(w.detach().requires_grad_(backward), b.detach().requires_grad_(backward))
                  for w, b in model.effective_layers()]
        xx = x.clone().requires_grad_(True)
        h = xx
        for i, (w, b) in enumerate(params):
            if i in model.skip_in:
                h = torch.cat([h, xx], -1) * (1 / math.sqrt(2))
            h = torch.addmm(b, h, w.T)
            if i < len(params) - 1:
                h = torch.nn.functional.softplus(h, beta=model.beta)
        (g,) = torch.autograd.grad(h[:, 0].sum(), xx, create_graph=backward)
        if backward:
            torch.autograd.grad((a * h[:, 0]).sum() + (c * g).sum(), [t for pair in params for t in pair])

    for tag, (model, net, x, a, c) in timed_cases.items():
        ws, part = fi.images_plain(net, x, a, c)
        times = {}
        # interleaved: library, kernel, kernel, library
        for _ in range(2):
            times.setdefault("library_fwd", []).append(chip_smoke.timed(lambda: library_vag(model, x, a, c, False), 5))
            times.setdefault("igr_fwd", []).append(chip_smoke.timed(lambda: fi.fused_value_and_grad(net, x), 10))
            times.setdefault("igr_bwd", []).append(chip_smoke.timed(lambda: fi.fused_param_grads(net, x, a, c), 10))
            times.setdefault("dw_pass", []).append(chip_smoke.timed(lambda: fi.dw_pass(net, ws, part), 10))
            times.setdefault("library_bwd", []).append(chip_smoke.timed(lambda: library_vag(model, x, a, c, True), 5))
        row = {k: min(v) for k, v in times.items()}
        row["splits"] = fi.dw_splits(len(fi.dw_plan(net)), part.shape[0], dev)
        row["jobs"] = len(fi.dw_plan(net))
        row["workspace_bytes"] = dict(fi.WORKSPACE_BYTES)
        print(f"time {tag} (ms): {json.dumps(row)}", flush=True)
        report.setdefault("times_ms", {})[tag] = row
pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
pathlib.Path(args.out).write_text(json.dumps(report, indent=1))
print(f"study: {time.perf_counter() - t0:.1f} s", flush=True)
