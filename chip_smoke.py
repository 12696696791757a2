#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (sdf_representation_tpu_torch) on one card.

    python3 chip_smoke.py

Phases, none of which is allowed to fail quietly:

 1. Card name and power limit (nvidia-smi); TF32 off, checked.
 2. Build csrc/fused_mlp.cu and csrc/sdf_streams.cu with nvcc for sm_90a,
    both at once.
 3. Kernels against their plain PyTorch versions on the flagship net
    (configs/mesh_sdf.ini: ImplicitNet 8x512, skip at layer 4, beta 100;
    geometric init, radius 0.5, seeded weights), in f32 and bf16: the points
    kernel on 1M random points, the dense grid kernel at n = 128, the
    sparse block kernel on the active blocks at n = 256 — which must also
    equal the dense grid kernel at n = 256 bit for bit — and a ReLU/tanh
    (beta = 0) points case. Controls: the plain bf16 forward with one
    rounding point left out must fail the bf16 limits on the same inputs.
    The exact-SDF streams (distance, winding) against their plain versions
    on a rescaled icosphere of 20,480 faces and 262,144 points (uniform,
    on-surface, narrow-band), with the dense schedule and a sparse one
    (~60% of the chunks, one block unvisited): d^2 within rtol 1e-5 / atol
    1e-7, winners equal but for ties the f64 oracle proves, solid angles
    within rtol 1e-4 / atol 1e-3 and the inside/outside sign equal outside
    that margin; signed_distance against the sphere's analytic distance.
    Control: the plain winding with its dots rounded to 10-bit mantissas
    (as TF32 would) must fail the solid-angle limit on the same input.
 4. The main path, `python -m sdf_representation_tpu_torch cfg.ini`
    (reconstruct from a checkpoint), once per route, the launch counts
    zeroed just before each run and read just after: cubesize 256 must
    launch the sparse block kernel and nothing else (no dense fallback),
    cubesize 128 the dense grid kernel and nothing else. Checks per run:
    the STL exists, and the 99th percentile of |f| at its vertices under
    the plain f32 forward is under one voxel plus the measured bf16 error.
    The entry point's own stage times (reconstruct.LAST_STAGE_SECONDS) are
    printed.
 4b. The rest of the main path through the same entry point, at full width
    (8x512, batch 16384, configs/mesh_sdf.ini with only paths, epochs,
    min_epochs, checkpointing, the precision and the mode flags changed):
    samplingonly -> three labelled CSVs; training for 30 epochs in f32 (gated:
    the loss falls, and ends below the all-clipped plateau), in bfloat16_mxu
    and in the config's bfloat16 (both reported, not gated); the audit
    (ppo, no reconstruct) at cubesize 256 and 64; reconstruction from the
    trained checkpoint at 256 and 128. Launch counts are zeroed before each
    run and read after it: labelling and each audit must launch the
    distance and winding streams (the audit the dense grid kernel too), and
    no plain version may run.
 5. Times with CUDA events at the main path's shapes: kernel, plain version,
    one library layer chain (torch addmm, never called by the port), and
    the bound: the larger of bytes over 3.35 TB/s and operations over the
    card's peak (989 TFLOP/s bf16 tensor cores for bf16, 67 TFLOP/s FP32
    for f32), published figures at a 700 W limit. For the streams the
    operations are counted per point-triangle pair from the kernel's code.
 6. A `kernels` JSON line, then the contract line
    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Details go to build/chip_smoke.json.
"""

import contextlib
import json
import math
import pathlib
import shutil
import subprocess
import sys
import time

import numpy as np
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
# streams: the limits of the JAX package's tests/test_pallas_streams.py
D2_RTOL, D2_ATOL = 1e-5, 1e-7
W_RTOL, W_ATOL = 1e-4, 1e-3
# FP32 operations per point-triangle pair, counted from csrc/sdf_streams.cu
# with a multiply and an add as one each (the file is built without FMA
# contraction), a division or a square root as 8 and atan2f as 36 (one
# division, an 11-term polynomial, the quadrant fix-ups). Distance: 10 for
# the two dots, 2 for d and e, 6 for s and t, 8 for the two clamped edge
# minimisers, 5 for the region tests, 15 for the closest point, 5 for d^2,
# 4 for the validity select and the running minimum = 55; the division of
# the region a pair falls in (none, one or two) is left out, so the bound
# stays a lower one. Winding: 20 for the four dots, 36 for the three
# lengths, 9 + 1 for the cross terms and the numerator, 7 for the
# denominator, 36 for atan2f, 3 to scale, mask and add = 112.
DIST_OPS_PER_PAIR = 55
WIND_OPS_PER_PAIR = 112
EPOCHS = 30


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


def round_mantissa_10(t):
    """float32 values rounded to nearest with a 10-bit mantissa, as a TF32
    tensor-core pass would round its operands."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def exceeds(got, want, rtol, atol):
    """How far |got - want| lies over atol + rtol * |want| at its worst
    (<= 0: within the limit), and the largest |got - want|."""
    diff = (got - want).abs()
    return (diff - (atol + rtol * want.abs())).max().item(), diff.max().item()


@contextlib.contextmanager
def counting_plain_calls(modules):
    """Count calls of every ``*_plain`` function of the given modules (the
    wrappers look them up in their module, so a call on the card's path
    would show); restores the functions on exit."""
    counts, saved = {}, []
    for mod in modules:
        for name in [n for n in vars(mod) if n.endswith("_plain") and callable(getattr(mod, n))]:
            fn = getattr(mod, name)
            saved.append((mod, name, fn))
            counts[name] = 0

            def wrapper(*a, _fn=fn, _name=name, **kw):
                counts[_name] += 1
                return _fn(*a, **kw)

            setattr(mod, name, wrapper)
    try:
        yield counts
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def stream_points(mesh, n_total, rng):
    """n_total points: half uniform in the cube, a quarter on the surface
    (area-weighted), a quarter in a 0.1 band around it, as float32."""
    from sdf_representation_tpu_torch.sampling.sampler import sample_surface_points

    quarter = n_total // 4
    uniform = rng.uniform(-1, 1, (n_total - 2 * quarter, 3))
    surface = sample_surface_points(mesh, 1, rng, area_weighted=True, total_points=quarter)
    band = sample_surface_points(mesh, 1, rng, area_weighted=True, total_points=quarter)
    band = band * (1.0 + rng.uniform(-0.1, 0.1, (quarter, 1)) / np.linalg.norm(band, axis=1, keepdims=True))
    return np.concatenate([uniform, surface, band]).astype(np.float32)


def check_streams(device, report):
    """Phase 3, streams: kernels against plain at the main path's shapes,
    the rounded-dots control, signed_distance against the analytic sphere.
    Returns what phase 5 times: (points, dense schedule, tables, tri_chunk,
    per-kernel max errors)."""
    from sdf_representation_tpu_torch.geometry.primitives import make_icosphere
    from sdf_representation_tpu_torch.geometry.rescale import rescale_mesh
    from sdf_representation_tpu_torch.ops import sdf_exact as se
    from sdf_representation_tpu_torch.ops import sdf_streams as ss

    mesh = rescale_mesh(make_icosphere(5, 0.5))
    radius = float(np.linalg.norm(mesh.vertices, axis=1).mean())
    rng = np.random.default_rng(SEED)
    tri_chunk, m = 1024, se.POINT_CHUNK
    pts = stream_points(mesh, 262144, rng)
    n_blocks = len(pts) // m
    tables, n_faces = se._triangle_tables(mesh.vertices, mesh.faces, tri_chunk)
    n_chunks = tables["a"].shape[0]
    P = torch.from_numpy(pts.reshape(n_blocks, m, 3)).to(device)
    print(f"streams: {n_faces} faces (radius {radius:.4f}) in {n_chunks} chunks of {tri_chunk}, "
          f"{len(pts)} points in {n_blocks} blocks of {m}", flush=True)
    tri = mesh.vertices[mesh.faces]
    margin = W_ATOL + W_RTOL * 2 * math.pi
    errors, schedules, plain_w = {}, {}, {}
    for tag, frac in (("dense", 1.0), ("sparse", 0.6)):
        keep = rng.uniform(size=(n_blocks, n_chunks)) < frac
        keep[:, 0] = True
        if frac < 1:
            keep[n_blocks // 2] = False  # a block no step visits
        sb, sc, steps = ss.stream_steps(keep, n_blocks)
        schedules[tag] = (sb, sc)
        d2, best = ss.dist_stream(P, sb, sc, tables, tri_chunk)
        w = ss.wind_stream(P, sb, sc, tables, tri_chunk)
        torch.cuda.synchronize()
        pd2, pbest = ss.dist_stream_plain(P, sb, sc, tables, tri_chunk)
        pw = plain_w[tag] = ss.wind_stream_plain(P, sb, sc, tables, tri_chunk)
        visited = torch.from_numpy(keep.any(axis=1)).to(device)
        if not (torch.isfinite(d2[:n_blocks][visited]).all() and torch.isfinite(w).all()):
            raise RuntimeError(f"streams/{tag}: non-finite output on a visited block")
        if not (torch.isinf(d2[:n_blocks][~visited]).all() and torch.isinf(d2[n_blocks]).all()
                and (w[:n_blocks][~visited] == 0).all() and (w[n_blocks] == 0).all()
                and (best[:n_blocks][~visited] == 0).all()):
            raise RuntimeError(f"streams/{tag}: an unvisited row or the sink row was written")
        finite = torch.isfinite(pd2)
        over_d, err_d = exceeds(d2[finite], pd2[finite], D2_RTOL, D2_ATOL)
        over_w, err_w = exceeds(w, pw, W_RTOL, W_ATOL)
        differ = torch.nonzero((best != pbest).flatten()).flatten().cpu().numpy()
        if len(differ):  # other winners only on ties: equidistant under the f64 oracle
            q = pts[differ].astype(np.float64)
            da = np.linalg.norm(q - se.closest_point_on_triangles(
                q, tri[best.flatten().cpu().numpy()[differ]]), axis=1)
            db = np.linalg.norm(q - se.closest_point_on_triangles(
                q, tri[pbest.flatten().cpu().numpy()[differ]]), axis=1)
            if not np.allclose(da, db, rtol=1e-5, atol=1e-6):
                raise RuntimeError(f"streams/{tag}: {len(differ)} winners differ and are no ties")
        decided = (pw - 2 * math.pi).abs() > margin
        flips = ((w > 2 * math.pi) != (pw > 2 * math.pi))[decided].sum().item()
        print(f"check dist_stream/{tag}: {steps} steps, max |d2 diff| {err_d:.3e} (rtol {D2_RTOL:g}, "
              f"atol {D2_ATOL:g}), winners differing {len(differ)} (all ties)", flush=True)
        print(f"check wind_stream/{tag}: max |omega diff| {err_w:.3e} (rtol {W_RTOL:g}, atol "
              f"{W_ATOL:g}), sign flips outside the margin {flips} of {int(decided.sum())}", flush=True)
        if over_d > 0 or over_w > 0 or flips:
            raise RuntimeError(f"streams/{tag}: kernel and plain version disagree")
        errors[f"dist_stream/{tag}"], errors[f"wind_stream/{tag}"] = err_d, err_w

    # control: dots rounded as a TF32 pass would round them must fail the limit
    sb, sc = schedules["dense"]
    rounded = ss.wind_stream_plain(
        P, sb, sc, tables, tri_chunk,
        dots=lambda pp, vv: ss._dots(round_mantissa_10(pp), round_mantissa_10(vv)))
    over, err = exceeds(rounded, plain_w["dense"], W_RTOL, W_ATOL)
    print(f"control wind_stream/dots_rounded_to_10_bits: max |omega diff| {err:.3e}", flush=True)
    if over <= 0:
        raise RuntimeError("control: the solid-angle limit would pass TF32-rounded dots")
    report["stream_controls"] = {"dots_rounded_to_10_bits_max_abs_err": err}

    # the whole labelling function against the sphere's analytic distance:
    # the faceted sphere lies inside the round one by at most the facets' sag
    sdf, normals = se.signed_distance(pts, mesh)
    analytic = np.linalg.norm(pts.astype(np.float64), axis=1) - radius
    sag = float(np.abs(sdf - analytic).max())
    off = np.abs(sdf) > 1e-4
    unit = float(np.abs(np.linalg.norm(normals[off], axis=1) - 1).max())
    radial = float(np.abs(np.sum(normals[off] * pts[off], axis=1)
                          / np.linalg.norm(pts[off], axis=1)).min())
    print(f"check signed_distance: max |sdf - analytic| {sag:.3e} (facet sag; tolerance 5e-4), "
          f"| |n| - 1 | {unit:.1e}, min |n . r| {radial:.4f}", flush=True)
    if not (sag < 5e-4 and unit < 1e-4 and radial > 0.99 and np.isfinite(sdf).all()):
        raise RuntimeError("signed_distance disagrees with the analytic sphere")
    report["signed_distance_max_abs_err_vs_analytic"] = sag
    return P, schedules["dense"], tables, tri_chunk, errors


def drive_pipeline(device, run_root, report):
    """Phase 4b: sample -> train (three precisions) -> audit -> reconstruct
    through the entry point, counts zeroed before each run. Returns the
    launches per run, {run: {kernel: count}}."""
    from sdf_representation_tpu_torch import cli
    from sdf_representation_tpu_torch.configgen import Configuration
    from sdf_representation_tpu_torch.data.dataset import frame_from_csv
    from sdf_representation_tpu_torch.evaluations import post_process, reconstruct
    from sdf_representation_tpu_torch.geometry.mesh_io import load_mesh, save_mesh
    from sdf_representation_tpu_torch.geometry.primitives import make_icosphere
    from sdf_representation_tpu_torch.ops import fused_mlp as fm
    from sdf_representation_tpu_torch.ops import sdf_streams as ss
    from sdf_representation_tpu_torch.sampling import sampler
    from sdf_representation_tpu_torch.training import Trainer
    from sdf_representation_tpu_torch.training import trainer as trainer_module

    root = run_root / "pipeline"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    save_mesh(make_icosphere(5, 0.5), str(root / "sphere.stl"))
    base = (REPO / "configs" / "mesh_sdf.ini").read_text()
    for old, new in (("geometry = ./bunny.stl", f"geometry = {root}/sphere.stl"),
                     ("name = bunny", "name = sphere"), ("epochs = 2000", f"epochs = {EPOCHS}"),
                     ("min_epochs = 200", f"min_epochs = {EPOCHS}"),
                     ("checkpointing = 200", "checkpointing = 10")):
        if old not in base:
            raise RuntimeError(f"configs/mesh_sdf.ini no longer holds {old!r}")
        base = base.replace(old, new)

    def config(tag, precision="float32", cubesize=256, **flags):
        text = base.replace("directory = ./runs/", f"directory = {root}/{precision}/")
        text = text.replace("train_matmul_precision = bfloat16",
                            "train_matmul_precision = " + ("default" if precision == "float32" else precision))
        text = text.replace("cubesize = 256", f"cubesize = {cubesize}")
        for key, value in flags.items():
            text = text.replace(f"{key} = False", f"{key} = {value}")
        path = root / f"{tag}.ini"
        path.write_text(text)
        return str(path)

    launches, out = {}, {}

    def run(tag, cfg_path):
        torch.cuda.synchronize()
        fm.reset_launches()
        ss.reset_launches()
        with counting_plain_calls((fm, ss)) as plain:
            t0 = time.perf_counter()
            if cli.main([cfg_path]) != 0:
                raise RuntimeError(f"{tag}: the entry point failed")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches[tag] = {**fm.LAUNCHES, **ss.LAUNCHES}
        print(f"main path {tag}: wall s {wall:.3f}, launches {launches[tag]}, plain calls "
              f"{sum(plain.values())}", flush=True)
        if any(plain.values()):
            raise RuntimeError(f"{tag}: a plain version ran on the card's path: {plain}")
        if torch.backends.cuda.matmul.allow_tf32 or torch.get_float32_matmul_precision() != "highest":
            raise RuntimeError(f"{tag}: a global precision switch was left changed")
        return wall

    def need(tag, *names):
        missing = [n for n in names if launches[tag][n] < 1]
        if missing:
            raise RuntimeError(f"{tag} did not launch {missing}: {launches[tag]}")

    # -- sample and label -------------------------------------------------------
    wall = run("sampling", config("sampling", samplingonly=True))
    need("sampling", "dist_stream", "wind_stream")
    trainer = Trainer(Configuration(config("sampling", samplingonly=True)))
    frames = {n: frame_from_csv(str(pathlib.Path(trainer.data_path) / f"{n}.csv"))
              for n in ("uniform", "surface", "narrow")}
    rows = {n: len(f) for n, f in frames.items()}
    if rows != {"uniform": 100000, "surface": 307200, "narrow": 307200}:
        raise RuntimeError(f"sampling wrote {rows}")
    labels = np.concatenate([f.values for f in frames.values()])
    S, nrm = labels[:, 3], np.linalg.norm(labels[:, 4:], axis=1)
    off = np.abs(S) > 1e-4
    if not (np.isfinite(labels).all() and np.abs(S).max() <= 2 * math.sqrt(3)
            and np.abs(nrm[off] - 1).max() < 1e-4 and np.abs(frames["surface"]["S"]).max() < 1e-5
            and np.abs(frames["narrow"]["S"]).max() <= 0.1 + 1e-6):
        raise RuntimeError("the labels are not finite, bounded signed distances with unit normals")
    stages = dict(sampler.LAST_STAGE_SECONDS)
    print(f"labels: {rows}, max |S| {np.abs(S).max():.4f}, on-surface max |S| "
          f"{np.abs(frames['surface']['S']).max():.2e}; stages (s) {stages}", flush=True)
    out["sampling"] = {"wall_s": wall, "stages_s": stages, "rows": rows}

    # the all-clipped plateau of the loss: every prediction at one clamp bound
    delta, wf = 0.1, 0.5
    yc = np.clip(S, -delta, delta)
    weight = 1 + wf * np.exp(-np.abs(yc))
    plateau = min(float(np.mean(weight * (yc - b) ** 2)) for b in (-delta, delta))

    # -- train, once per precision, on the same CSVs ---------------------------
    data_root = pathlib.Path(trainer.main_path)
    out["training"] = {}
    for precision in ("float32", "bfloat16_mxu", "bfloat16"):
        if precision != "float32":
            shutil.copytree(data_root, root / precision / data_root.name,
                            ignore=shutil.ignore_patterns("ImplicitNet*"))
        wall = run(f"train/{precision}", config(f"train_{precision}", precision))
        t = Trainer(Configuration(config(f"train_{precision}", precision)))
        curve = np.loadtxt(pathlib.Path(t.train_path) / "train_loss.txt")
        stats = dict(trainer_module.LAST_RUN)
        print(f"train {precision}: wall {wall:.2f} s, {stats}, plateau {plateau:.3e}, train loss "
              + " ".join(f"{v:.3e}" for v in curve[:, 1]), flush=True)
        if stats["epochs_run"] != EPOCHS or len(curve) != EPOCHS:
            raise RuntimeError(f"training ran {stats['epochs_run']} epochs, not {EPOCHS}")
        if list(launches[f"train/{precision}"].values()) != [0] * 5:
            raise RuntimeError("training launched an evaluation kernel")
        out["training"][precision] = {"wall_s": wall, **stats,
                                      "train_loss": curve[:, 1].tolist(),
                                      "val_loss": curve[:, 2].tolist()}
        if precision == "float32" and not (curve[-1, 1] < curve[0, 1] and curve[-1, 1] < plateau
                                           and np.isfinite(curve).all()):
            raise RuntimeError(f"f32 training did not leave the plateau {plateau}: {curve[:, 1]}")
    out["plateau"] = plateau

    # -- audit the f32 field, then reconstruct from its checkpoint -------------
    t = Trainer(Configuration(config("train_float32")))
    post = pathlib.Path(t.postprocess_save_path)
    out["audit"] = {}
    for cubesize in (256, 64):
        tag = f"audit/{cubesize}"
        wall = run(tag, config(f"audit_{cubesize}", ppo=True, cubesize=cubesize))
        need(tag, "dist_stream", "wind_stream", "fused_grid")
        ax = np.linspace(-1, 1, cubesize)
        r2 = ax[:, None, None] ** 2 + ax[None, :, None] ** 2 + ax[None, None, :] ** 2
        baseline = float(np.mean(r2 > 0.85 ** 2))  # calling every point outside
        row = (post / "results.csv").read_text().splitlines()
        header, last = row[0].split(","), [float(v) for v in row[-1].split(",")]
        result = dict(zip(header, last))
        stages = dict(post_process.LAST_STAGE_SECONDS)
        print(f"audit {cubesize}^3: {result}, outside-fraction baseline {baseline:.4f}, "
              f"stages (s) {stages}", flush=True)
        if not (result["Resolution"] == cubesize and result["Accuracy"] > baseline
                and len(row) == 2 + (cubesize == 64) and np.isfinite(last).all()):
            raise RuntimeError(f"audit {cubesize}: no better than calling every point outside")
        for name in ("mismatching_co-ordinates1.csv", "classification_report2.csv"):
            if not (post / name).exists():
                raise RuntimeError(f"audit {cubesize}: {name} is missing")
        out["audit"][cubesize] = {"wall_s": wall, "stages_s": stages, "result": result,
                                  "baseline": baseline}
    out["reconstruct_trained"] = {}
    for cubesize in (256, 128):
        tag = f"reconstruct_trained/{cubesize}"
        stl = post / f"reconstructed_epoch{EPOCHS - 1}.stl"
        if stl.exists():
            stl.unlink()
        wall = run(tag, config(f"rec_{cubesize}", ppo=True, reconstruct=True, cubesize=cubesize))
        if launches[tag]["sparse_blocks"] + launches[tag]["fused_grid"] < 1:
            raise RuntimeError(f"{tag}: no evaluation kernel was launched")
        mesh = load_mesh(str(stl))
        radii = np.linalg.norm(mesh.vertices, axis=1)
        print(f"mesh from the trained field, {cubesize}^3: {len(mesh.faces)} faces, vertex radius "
              f"median {np.median(radii):.4f} (the labelled sphere: 0.85), within 0.02 of it "
              f"{np.mean(np.abs(radii - 0.85) < 0.02):.3f} of the vertices, stages (s) "
              f"{dict(reconstruct.LAST_STAGE_SECONDS)}", flush=True)
        if len(mesh.faces) < 1000 or not np.isfinite(mesh.vertices).all() \
                or np.abs(mesh.vertices).max() > 1 or abs(np.median(radii) - 0.85) > 0.1:
            raise RuntimeError(f"{tag}: the mesh is not a sphere of radius ~0.85")
        out["reconstruct_trained"][cubesize] = {"wall_s": wall, "faces": len(mesh.faces),
                                                "median_radius": float(np.median(radii))}
    report["pipeline"] = out
    return launches


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
    from sdf_representation_tpu_torch.ops import sdf_streams as ss
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
    t0 = time.perf_counter()
    report["build_s"] = kernels.build_all(["fused_mlp", "sdf_streams"], verbose=True)
    print(f"build: {report['build_s']} s per source, {time.perf_counter() - t0:.1f} s in all "
          "(one nvcc each, started together)", flush=True)

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
    stream_P, (stream_sb, stream_sc), stream_tables, tri_chunk, stream_errors = check_streams(
        device, report)
    checks.update(stream_errors)

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
        ss.reset_launches()
        t0 = time.perf_counter()
        if cli.main([configs[cubesize]]) != 0:
            raise RuntimeError("the entry point failed")
        wall = time.perf_counter() - t0
        launches = {**fm.LAUNCHES, **ss.LAUNCHES}
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

    # ---- 4b. sample -> train -> audit -> reconstruct ---------------------------
    runs = {f"reconstruct/{n}": run["launches"] for n, run in main_path.items()}
    runs.update(drive_pipeline(device, run_root, report))

    # ---- 5. times -----------------------------------------------------------
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
        # launches on the main path: the sum over its runs (reconstruction
        # per route, sampling, training, the audits, reconstruction from the
        # trained field), each counted in its own window. The points kernel
        # is on none of them: no run evaluates arbitrary points.
        by_run = {tag: counts[name] for tag, counts in runs.items() if counts[name]}
        entry = {"name": name, "route": "cuda", "source": "sdf_representation_tpu_torch/csrc/fused_mlp.cu",
                 "replaces": replaces, "launches": sum(by_run.values()), "launches_by_run": by_run}
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
    # the streams at phase 3's shapes, dense schedule; no one PyTorch call
    # computes either function, so there is no library time
    n_blocks, m_pts, _ = stream_P.shape
    n_chunks = stream_tables["a"].shape[0]
    pairs = n_blocks * m_pts * n_chunks * tri_chunk
    schedule_bytes = 4 * (n_blocks + 1 + n_blocks * n_chunks)
    for name, replaces, ops, rows, out_bytes, run, plain in (
        ("dist_stream", "sdf_representation_tpu/ops/pallas_streams.py:284 _dist_slab_call",
         DIST_OPS_PER_PAIR, 16, 8,
         lambda: ss.dist_stream(stream_P, stream_sb, stream_sc, stream_tables, tri_chunk),
         lambda: ss.dist_stream_plain(stream_P, stream_sb, stream_sc, stream_tables, tri_chunk)),
        ("wind_stream", "sdf_representation_tpu/ops/pallas_streams.py:388 _wind_slab_call",
         WIND_OPS_PER_PAIR, 24, 4,
         lambda: ss.wind_stream(stream_P, stream_sb, stream_sc, stream_tables, tri_chunk),
         lambda: ss.wind_stream_plain(stream_P, stream_sb, stream_sc, stream_tables, tri_chunk)),
    ):
        bytes_ = (stream_P.numel() * 4 + n_chunks * tri_chunk * rows * 4 + schedule_bytes
                  + (n_blocks + 1) * m_pts * out_bytes)
        t_bytes, t_ops = bytes_ / MEM_BW * 1e3, pairs * ops / PEAK[torch.float32] * 1e3
        ms, plain_ms = timed(run), timed(plain, 1)
        by_run = {tag: counts[name] for tag, counts in runs.items() if counts[name]}
        entry = {"name": name, "route": "cuda",
                 "source": "sdf_representation_tpu_torch/csrc/sdf_streams.cu", "replaces": replaces,
                 "launches": sum(by_run.values()), "launches_by_run": by_run, "dtype": "float32",
                 "max_abs_err": checks[f"{name}/dense"], "max_abs_err_sparse": checks[f"{name}/sparse"],
                 "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
                 "bound_by": "operations" if t_ops >= t_bytes else "bytes", "library_ms": None,
                 "pairs": pairs, "ops_per_pair": ops, "pairs_per_s": pairs / ms * 1e3}
        print(f"time {name}: " + json.dumps(entry), flush=True)
        if entry["launches"] < 1:
            raise RuntimeError(f"{name} was launched on no run of the main path")
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
