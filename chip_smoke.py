#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (sdf_representation_tpu_torch) on one card.

    python3 chip_smoke.py

Phases, none of which is allowed to fail quietly:

 1. Card name and power limit (nvidia-smi); TF32 off, checked.
 2. Build csrc/fused_mlp.cu with nvcc for sm_90a.
 3. Kernels against their plain PyTorch versions on the flagship net
    (configs/mesh_sdf.ini: ImplicitNet 8x512, skip at layer 4, beta 100;
    geometric init, radius 0.5, seeded weights), in f32 and bf16: the points
    kernel on 1M random points, the dense grid kernel at n = 128, the
    sparse block kernel on the active blocks at n = 256 — which must also
    equal the dense grid kernel at n = 256 bit for bit — and a ReLU/tanh
    (beta = 0) points case. Controls: the plain bf16 forward with one
    rounding point left out must fail the bf16 limits on the same inputs.
 4. The main path, `python -m sdf_representation_tpu_torch cfg.ini`
    (reconstruct from a checkpoint), once per route, the launch counts
    zeroed just before each run and read just after: cubesize 256 must
    launch the sparse block kernel and nothing else (no dense fallback),
    cubesize 128 the dense grid kernel and nothing else. Checks per run:
    the STL exists, and the 99th percentile of |f| at its vertices under
    the plain f32 forward is under one voxel plus the measured bf16 error.
    The entry point's own stage times (reconstruct.LAST_STAGE_SECONDS) are
    printed.
 5. Times with CUDA events at the main path's shapes: kernel, plain version,
    one library layer chain (torch addmm, never called by the port), and
    the bound: the larger of bytes over 3.35 TB/s and operations over the
    card's peak (989 TFLOP/s bf16 tensor cores for bf16, 67 TFLOP/s FP32
    for f32), published figures at a 700 W limit.
 6. A `kernels` JSON line, then the contract line
    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Details go to build/chip_smoke.json.
"""

import json
import math
import pathlib
import subprocess
import sys
import time

import torch

REPO = pathlib.Path(__file__).resolve().parent
PEAK = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense FLOP/s, H100 SXM
MEM_BW = 3.35e12  # bytes/s
F32_TOL = 2e-5    # kernel vs plain in f32: summation order only (tests/test_pallas_mlp.py)
# bf16: an f32 sum in another order can round to the neighbouring bf16 value,
# so a sound kernel differs from plain at a few points (max up to 1.72e-3,
# mean up to 4.1e-6 on an H100); leaving out one of the three bf16 rounding
# points moves nearly every point (mean 3.3e-4 and more, max from 2.2e-3).
# The mean limit sits between the two and separates them; the max limit
# catches gross errors. PERF.md has the readings; phase 3 shows in every run
# that the limits reject such a kernel.
BF16_TOL = 3e-3
BF16_MEAN_TOL = 3e-5
SEED = 0


def plain_dropping(net, x, drop):
    """The bf16 plain forward (fused_mlp.forward_plain) over (M, 3) points
    with the rounding points named in ``drop`` ("coords", "acc", "act") left
    out: what a kernel that skipped them would compute. The bf16 limits must
    reject it (the control of the bf16 checks)."""
    from sdf_representation_tpu_torch.ops import fused_mlp as fm

    def rnd(t, point):
        return t if point in drop else t.to(torch.bfloat16).float()

    out = torch.empty(x.shape[0], dtype=torch.float32, device=x.device)
    n_lin = len(net.plain_layers)
    for start in range(0, x.shape[0], fm.PLAIN_CHUNK):
        xc = rnd(x[start:start + fm.PLAIN_CHUNK].float(), "coords")
        h = xc
        for layer, (kind, w_h, w_x, b) in enumerate(net.plain_layers):
            if kind == "first":
                acc = xc @ w_x + b
            elif kind == "skip":
                acc = (h @ w_h + xc @ w_x) * fm.INV_SQRT2 + b
            else:
                acc = h @ w_h + b
            if layer < n_lin - 1:
                acc = rnd(acc, "acc")
                if net.beta > 0:
                    t = net.beta * acc
                    acc = (torch.clamp_min(t, 0.0) + torch.log1p(torch.exp(-t.abs()))) / net.beta
                else:
                    acc = torch.clamp_min(acc, 0.0)
                h = rnd(acc, "act")
            else:
                h = acc
        out[start:start + xc.shape[0]] = (torch.tanh(h) if net.beta <= 0 else h)[:, 0]
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    from sdf_representation_tpu_torch import cli, kernels
    from sdf_representation_tpu_torch.configgen import Configuration
    from sdf_representation_tpu_torch.evaluations import reconstruct
    from sdf_representation_tpu_torch.geometry.mesh_io import load_mesh
    from sdf_representation_tpu_torch.models import ImplicitNet
    from sdf_representation_tpu_torch.ops import fused_mlp as fm
    from sdf_representation_tpu_torch.ops import sparse_grid as sg
    from sdf_representation_tpu_torch.training import Trainer
    from sdf_representation_tpu_torch.training.checkpoint import save_checkpoint
    from sdf_representation_tpu_torch.utils.device import resolve_device

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    device = resolve_device()
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise RuntimeError("TF32 is still on")
    report = {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda}

    # ---- 2. build ---------------------------------------------------------
    report["build_s"] = kernels.build("fused_mlp", verbose=True)
    print(f"build: csrc/fused_mlp.cu in {report['build_s']:.1f} s", flush=True)

    # ---- 3. kernels against plain -------------------------------------------
    gen = torch.Generator().manual_seed(SEED)
    model = ImplicitNet(hidden_dims=(512,) * 8, skip_in=(4,), beta=100.0, radius_init=0.5,
                        generator=gen, device=device)
    relu_model = ImplicitNet(hidden_dims=(512,) * 8, skip_in=(4,), beta=0.0,
                             radius_init=0.5, generator=gen, device=device)
    pts = (torch.rand(1 << 20, 3, generator=gen) * 2 - 1).to(device)
    nets = {dt: fm.FusedNet(model, dt) for dt in (torch.bfloat16, torch.float32)}
    checks, means, controls = {}, {}, {}

    def check(name, got, want, dt):
        """Kernel against plain: max |diff| within the type's limit, and in
        bf16 the mean |diff| too."""
        torch.cuda.synchronize()
        if not (torch.isfinite(got).all() and got.shape == want.shape):
            raise RuntimeError(f"{name}: non-finite or misshapen output")
        diff = (got - want).abs()
        err, mean = diff.max().item(), diff.mean().item()
        limit = F32_TOL if dt == torch.float32 else BF16_TOL
        mean_limit = math.inf if dt == torch.float32 else BF16_MEAN_TOL
        print(f"check {name}: max_abs_err {err:.3e} (tolerance {limit:g}), mean_abs_err "
              f"{mean:.3e} (tolerance {mean_limit:g})", flush=True)
        if not (err <= limit and mean <= mean_limit):
            raise RuntimeError(f"{name}: error over the tolerance")
        checks[name], means[name] = err, mean

    def control(name, net, x, want, drops):
        """The bf16 limits against kernels that leave a rounding point out:
        each such forward must fail them."""
        if not torch.equal(plain_dropping(net, x, ()), want.reshape(-1)):
            raise RuntimeError(f"control {name}: the control forward is not the plain one")
        for drop in drops:
            diff = (plain_dropping(net, x, drop) - want.reshape(-1)).abs()
            err, mean = diff.max().item(), diff.mean().item()
            key = f"{name}/without_{'+'.join(drop)}"
            controls[key] = {"max_abs_err": err, "mean_abs_err": mean}
            print(f"control {key}: max_abs_err {err:.3e}, mean_abs_err {mean:.3e}", flush=True)
            if err <= BF16_TOL and mean <= BF16_MEAN_TOL:
                raise RuntimeError(f"control {key}: the bf16 tolerances would pass it")

    _, mask, _ = sg.coarse_and_certificate(model, 256, 8, 1.5, 0.01)
    ids = torch.nonzero(mask).flatten().to(torch.int32)
    count = torch.tensor([ids.numel()], dtype=torch.int32, device=device)
    softplus_drops = (("coords",), ("acc",), ("act",))
    for dt, net in nets.items():
        tag = str(dt).split(".")[1]
        want = fm.fused_points_plain(net, pts)
        check(f"fused_points/{tag}", fm.fused_points(net, pts), want, dt)
        if dt == torch.bfloat16:
            control("fused_points", net, pts, want, softplus_drops)
        want = fm.fused_grid_plain(net, 128)
        check(f"fused_grid/{tag}/n128", fm.fused_grid(net, 128), want, dt)
        if dt == torch.bfloat16:
            control("fused_grid/n128", net, fm.grid_points(128, 0, 128 ** 3, device), want,
                    softplus_drops)
        blocks = fm.fused_blocks(net, ids, count, 256, 8)
        want = fm.fused_blocks_plain(net, ids, count, 256, 8)
        check(f"sparse_blocks/{tag}/n256", blocks, want, dt)
        if dt == torch.bfloat16:
            control("sparse_blocks/n256", net, fm.block_points(ids, 256, 8), want, softplus_drops)
        dense = fm.fused_grid(net, 256).reshape(32, 8, 32, 8, 32, 8).permute(0, 2, 4, 1, 3, 5)
        dense = dense.reshape(-1, 512)[ids.long()]
        if not torch.equal(blocks, dense):
            raise RuntimeError(f"sparse blocks differ from the dense grid kernel ({tag})")
        print(f"check sparse_blocks/{tag}: bitwise equal to fused_grid on {ids.numel()} "
              "active blocks", flush=True)
    for dt in (torch.float32, torch.bfloat16):
        relu_net = fm.FusedNet(relu_model, dt)
        tag = str(dt).split(".")[1]
        want = fm.fused_points_plain(relu_net, pts)
        check(f"fused_points/{tag}/relu", fm.fused_points(relu_net, pts), want, dt)
        if dt == torch.bfloat16:
            # under ReLU, rounding the accumulator and the activation is one rounding
            control("fused_points/relu", relu_net, pts, want, (("coords",), ("acc", "act")))
    del want, blocks, dense

    # ---- 4. the main path, once per route -----------------------------------
    run_root = REPO / "build" / "chip_smoke_run"
    text = (REPO / "configs" / "mesh_sdf.ini").read_text()
    text = (text.replace("directory = ./runs/", f"directory = {run_root}/")
            .replace("ppo = False", "ppo = True").replace("reconstruct = False", "reconstruct = True"))
    # cubesize 256 takes the sparse evaluator (block kernel), 128 the dense one
    route_kernel = {256: "sparse_blocks", 128: "fused_grid"}
    configs, stls = {}, {}
    for cubesize in route_kernel:
        path = run_root / f"mesh_sdf_{cubesize}.ini"
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(text.replace("cubesize = 256", f"cubesize = {cubesize}"))
        configs[cubesize] = str(path)
        trainer = Trainer(Configuration(configs[cubesize]))
        stls[cubesize] = pathlib.Path(trainer.postprocess_save_path) / "reconstructed_epoch0.stl"
    for old in pathlib.Path(trainer.model_save_path).glob("*.ckpt"):
        old.unlink()
    save_checkpoint(str(pathlib.Path(trainer.model_save_path) / "model_epoch0.ckpt"),
                    {"model": {k: v.cpu() for k, v in model.state_dict().items()}, "epoch": 0})

    main_path = {}
    for cubesize, kernel in route_kernel.items():
        stl = stls[cubesize]
        if stl.exists():
            stl.unlink()
        torch.cuda.synchronize()
        fm.reset_launches()
        t0 = time.perf_counter()
        if cli.main([configs[cubesize]]) != 0:
            raise RuntimeError("the entry point failed")
        wall = time.perf_counter() - t0
        launches = dict(fm.LAUNCHES)
        stages = dict(reconstruct.LAST_STAGE_SECONDS)
        stages["other (arguments, config, Trainer)"] = wall - sum(stages.values())
        print(f"main path cubesize {cubesize}: launches {launches}, wall s {wall:.3f}, "
              f"host clock per stage (s) {stages}", flush=True)
        others = [k for k in launches if k != kernel]
        if launches[kernel] < 1 or any(launches[k] for k in others):
            raise RuntimeError(f"cubesize {cubesize} should launch {kernel} and nothing else "
                               f"(a dense fallback launches fused_grid): {launches}")
        if not stl.exists():
            raise RuntimeError(f"cubesize {cubesize}: the entry point wrote no STL")
        mesh = load_mesh(str(stl))
        verts = torch.as_tensor(mesh.vertices, dtype=torch.float32, device=device)
        if len(mesh.faces) < 1000 or not torch.isfinite(verts).all() or verts.abs().max() > 1:
            raise RuntimeError(f"the {cubesize}^3 mesh is too small or has vertices off the grid")
        with torch.no_grad():
            p99 = torch.quantile(model(verts).abs(), 0.99).item()
        bound = 2.0 / (cubesize - 1) + checks["fused_points/bfloat16"]
        print(f"mesh {cubesize}^3: {len(mesh.vertices)} vertices, {len(mesh.faces)} faces; "
              f"p99 |f(vertex)| plain f32 {p99:.3e} (bound {bound:.3e})", flush=True)
        if not p99 < bound:
            raise RuntimeError(f"p99 |f| at the vertices {p99} over {bound}")
        main_path[cubesize] = {"launches": launches, "wall_s": wall, "stages_s": stages,
                               "faces": len(mesh.faces), "p99_abs_f": p99, "p99_bound": bound}
    _, count256 = sg.sparse_grid_eval(model, 256, return_count=True)
    print(f"active blocks at 256: {count256} of {32 ** 3}", flush=True)
    report.update(main_path=main_path, active_blocks=count256, checks=checks,
                  mean_abs_err=means, controls=controls)

    # ---- 5. times -----------------------------------------------------------
    def timed(fn, min_reps=3):
        fn()
        torch.cuda.synchronize()
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(min_reps):
            fn()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / min_reps

    mac = sum(fi * fo for fi, fo in model.layer_shapes())

    def library_chain(x, dt):
        """The layer chain as one addmm per layer in the working type (the
        yardstick: what cuBLAS makes of the same net)."""
        layers = [(w.to(dt), b.to(dt)) for w, b in model.effective_layers()]
        for start in range(0, x.shape[0], 1 << 21):
            inp = x[start:start + (1 << 21)].to(dt)
            h = inp
            for i, (w, b) in enumerate(layers):
                if i in model.skip_in:
                    h = torch.cat([h, inp], -1) * (1 / math.sqrt(2))
                h = torch.addmm(b, h, w.T)
                if i < len(layers) - 1:
                    h = torch.nn.functional.softplus(h, beta=model.beta)

    grid_pts = {n: fm.grid_points(n, 0, n ** 3, device) for n in (256,)}
    kernels_line = []
    for name, replaces in (
        ("fused_grid", "sdf_representation_tpu/ops/pallas_mlp.py:195 _fused_grid_slab"),
        ("fused_points", "sdf_representation_tpu/ops/pallas_mlp.py:270 _fused_apply_padded"),
        ("sparse_blocks", "sdf_representation_tpu/ops/sparse_grid.py:256 refine_blocks"),
    ):
        # launches on the main path: the sum over its two routes, each counted
        # in its own window (the points kernel is on neither: reconstruction
        # never evaluates arbitrary points)
        by_cubesize = {str(n): run["launches"][name] for n, run in main_path.items()}
        entry = {"name": name, "route": "cuda", "source": "sdf_representation_tpu_torch/csrc/fused_mlp.cu",
                 "replaces": replaces, "launches": sum(by_cubesize.values()),
                 "launches_by_cubesize": by_cubesize}
        for dt in (torch.bfloat16, torch.float32):
            net = nets[dt]
            tag = str(dt).split(".")[1]
            if name == "fused_grid":
                npts, x = 256 ** 3, grid_pts[256]
                run, plain = (lambda: fm.fused_grid(net, 256)), (lambda: fm.fused_grid_plain(net, 256))
                key = f"fused_grid/{tag}/n128"
                in_bytes = 0
            elif name == "fused_points":
                npts, x = pts.shape[0], pts
                run, plain = (lambda: fm.fused_points(net, pts)), (lambda: fm.fused_points_plain(net, pts))
                key = f"fused_points/{tag}"
                in_bytes = pts.numel() * 4
            else:
                npts = ids.numel() * 512
                x = fm.block_points(ids, 256, 8)
                run = lambda: fm.fused_blocks(net, ids, count, 256, 8)
                plain = lambda: fm.fused_blocks_plain(net, ids, count, 256, 8)
                key = f"sparse_blocks/{tag}/n256"
                in_bytes = ids.numel() * 4 + 4
            w_bytes = sum(w.numel() * w.element_size() for w in net.weights)
            bytes_ = w_bytes + in_bytes + npts * 4
            flops = 2.0 * mac * npts
            t_bytes, t_ops = bytes_ / MEM_BW * 1e3, flops / PEAK[dt] * 1e3
            ms, plain_ms = timed(run), timed(plain, 1)
            lib_ms = timed(lambda: library_chain(x, dt), 1)
            numbers = {"max_abs_err": checks[key], "mean_abs_err": means[key], "ms": ms, "plain_ms": plain_ms,
                       "bound_ms": max(t_bytes, t_ops),
                       "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                       "library_ms": lib_ms, "points": npts,
                       "tflops": flops / ms / 1e9, "points_per_s": npts / ms * 1e3}
            print(f"time {name}/{tag}: " + json.dumps(numbers), flush=True)
            if dt == torch.bfloat16:
                entry.update(numbers, dtype="bfloat16")
            else:
                entry["float32"] = numbers
        kernels_line.append(entry)
    sparse_ms = {str(dt).split(".")[1]: timed(lambda: sg.sparse_grid_eval(model, 256, compute_dtype=dt))
                 for dt in (torch.bfloat16, torch.float32)}
    print(f"time sparse_grid_eval n=256 (coarse sweep + refine + assembly, ms): {sparse_ms}",
          flush=True)
    report.update(kernels=kernels_line, sparse_grid_eval_ms=sparse_ms)

    (REPO / "build" / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    print(card)
    print(json.dumps({"kernels": kernels_line}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
