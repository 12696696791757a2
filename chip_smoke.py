#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (sdf_representation_tpu_torch) on one card.

    python3 chip_smoke.py

Phases, none of which is allowed to fail quietly:

 1. Card name and power limit (nvidia-smi); TF32 off, checked.
 2. Build csrc/fused_mlp.cu, csrc/sdf_streams.cu and csrc/fused_igr.cu with
    nvcc for sm_90a, all at once.
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
    The fused (f, grad_x f) kernel and its params-only backward (igr_fwd,
    igr_bwd) against their plain versions at 8x512 and 8x256 (skip 4, beta
    100), N = 16,384 and an odd N, in f32 and bf16: f, grad f, every dW and
    db. ReLU/tanh twice: on uniform points, where step'(z) may flip at a few,
    and on points picked to keep every pre-activation clear of zero, where
    every limit of the softplus cases holds. Controls: the bf16 plain
    versions with one rounding point left out must fail the bf16 limits.
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
 4c. The eikonal path through the same entry point, counts zeroed before
    each run: (a) labelled training with loss_function = IGRLOSS on 4b's
    CSVs at 8x512, batch 16384, train_matmul_precision = bfloat16: igr_fwd
    and igr_bwd launch once per step, the loss falls; (b) the shape of
    configs/pointcloud_igr.ini (8x256, batch 16384, IGRLOSSPCD, lambda 0.1,
    distributed = True; paths, epochs, checkpointing changed and
    train_matmul_precision = bfloat16 added) on a surface.csv of 307,200
    surface points of the rescaled icosphere: launches per step, the loss
    falls, then reconstruction from its checkpoint at cubesize 128 (median
    vertex radius reported against 0.85, not gated); (c) both configs once
    with the default precision: by the rule that decides when the kernels
    run (training/trainer.py use_fused_igr) no kernel is launched.
 5. Times with CUDA events at the main path's shapes: kernel, plain version,
    one library layer chain (torch addmm, never called by the port), and
    the bound: the larger of bytes over 3.35 TB/s and operations over the
    card's peak (989 TFLOP/s bf16 tensor cores for bf16, 67 TFLOP/s FP32
    for f32), published figures at a 700 W limit. For the streams the
    operations are counted per point-triangle pair from the kernel's code.
    For igr_fwd and igr_bwd at (8x512, N 16,384) and (8x256, N 5,461): the
    operations are 2 N times the multiply-adds of the products each kernel
    performs (2 and ~6 passes over the layers), the bytes are the inputs, the
    weights and the outputs (the kernels' stash workspace is reported beside
    the bound, not counted in it), and the library yardstick is the same
    (f, grad f) and parameter gradient through cuBLAS and torch autograd's
    double backward (create_graph=True), timed only.
 6. A `kernels` JSON line with seven entries, then the contract line
    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Details go to build/chip_smoke.json.
"""

import contextlib
import json
import math
import pathlib
import re
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
# igr_fwd / igr_bwd against plain. f32: f and grad f within F32_TOL, every
# dW and db within IGR_F32_GRAD_TOL of its tensor's largest entry (summation
# order; the backward adds with atomics, whose order changes run to run).
# bf16: an f32 sum in another order can round to the neighbouring bf16 value
# and sigma'(beta z) carries that on, so a sound kernel differs from plain at
# a few points; leaving out one rounding point moves nearly every point. The
# mean limits sit between the two (the controls are recomputed in every run
# and must fail them), the max limits catch gross errors.
# Under ReLU, step'(z) flips where the two summation orders leave z on either
# side of zero, and a flipped point moves grad f and its share of dW by a
# whole term. So the ReLU kernels are held twice. "relu_clear": on the 4,096
# points, of 262,144 candidates, whose hidden pre-activations all stay
# farthest from zero (|z| >= 8e-5 on an H100) an f32 step cannot flip, and
# every limit above applies unchanged, with the bf16 controls (the tanh
# head's rounding among them); in bf16 a value that rounds to its neighbour
# moves a later z by ~1e-4 and can still cross that margin at single points,
# so there the worst tensor is held for gross errors only
# (IGR_RELU_BF16_GRAD_MAX_TOL; sound 1.5e-2 to 2.5e-2) while the mean
# separates the sound kernel (7e-4 to 1e-3) from the controls (from 2.9e-3,
# the head's). PERF.md has the readings. "relu": on uniform
# points f keeps its limits, grad f may differ by more than the type's max
# limit at no more than IGR_RELU_FLIPPED of the points (sound: up to 4.3e-4
# of them in f32, 1.8e-4 in bf16), and the gradients are held for gross errors only
# (IGR_RELU_GRAD_MEAN_TOL; sound 4e-4 to 7e-4 in f32, 2.1e-3 to 2.3e-3 in bf16).
IGR_F32_GRAD_TOL = 1e-4
IGR_BF16_TOL = 1e-2
IGR_BF16_F_MEAN_TOL = 5e-5
IGR_BF16_G_MEAN_TOL = 1e-4
IGR_GRAD_MEAN_TOL = 2e-3       # bf16: sum |diff| / sum |plain| over all gradients
IGR_BF16_GRAD_MAX_TOL = 1e-2   # bf16: worst tensor's max |diff| / max |plain|
IGR_RELU_FLIPPED = 2e-3
IGR_RELU_GRAD_MEAN_TOL = 1e-2
IGR_RELU_BF16_GRAD_MAX_TOL = 5e-2
IGR_RELU_CANDIDATES = 1 << 18  # uniform points "relu_clear" picks its points from
IGR_EPOCHS = 5        # labelled IGRLOSS run, bfloat16
PCD_EPOCHS = 31       # point-cloud run, bfloat16; model_epoch30.ckpt holds the last weights
PCD_POINTS = 307200


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


def gradient_errors(got, want):
    """(sum |diff| / sum |want| over all tensors, the worst tensor's
    max |diff| / max |want|) of two lists of gradients."""
    num = sum((u - v).abs().sum().item() for u, v in zip(got, want))
    den = sum(v.abs().sum().item() for v in want)
    worst = max((u - v).abs().max().item() / max(v.abs().max().item(), 1e-30)
                for u, v in zip(got, want))
    return num / den, worst


def igr_fwd_dropping(net, x, drop):
    """fused_igr.fused_value_and_grad_plain with the rounding points named
    in ``drop`` ("x", "stash", "act", "cotangent") left out: what a kernel
    that skipped them would compute (the control of the bf16 checks). Also
    returns, per point, the least |z| over all hidden units (padding apart)."""
    from sdf_representation_tpu_torch.ops import fused_igr as fi
    from sdf_representation_tpu_torch.ops import fused_mlp as fm

    def rnd(t, point):
        return t if point in drop else fm._working(t, net.dtype)

    beta, layers = net.beta, fi._head_layers(net)
    x = rnd(x.float(), "x")
    h, stash = x, []
    margin = torch.full(x.shape[:1], math.inf, device=x.device)
    for layer, (kind, w_h, w_x, b) in enumerate(layers):
        if kind == "first":
            z = x @ w_x + b
        elif kind == "skip":
            z = (h @ w_h + x @ w_x) * fm.INV_SQRT2 + b
        else:
            z = h @ w_h + b
        if layer < len(layers) - 1:
            live = (z != 0).any(dim=0)  # padding columns are zero at every point
            margin = torch.minimum(margin, z[:, live].abs().amin(dim=1))
            stash.append(rnd(fi._sigma(z, beta), "stash"))
            h = rnd(fi._act(z, beta), "act")
    f = z if beta > 0 else torch.tanh(z)
    dz = torch.ones_like(z) if beta > 0 else 1.0 - f * f
    dx = torch.zeros_like(x)
    for layer in range(len(layers) - 1, -1, -1):
        kind, w_h, w_x, _ = layers[layer]
        scale = fm.INV_SQRT2 if kind == "skip" else 1.0
        dz_c = rnd(dz, "cotangent")
        if w_x is not None:
            dx = dx + (dz_c @ w_x.T) * scale
        if layer > 0:
            dz = (dz_c @ w_h.T) * scale * stash[layer - 1]
    return f[:, 0], dx, margin


def igr_bwd_dropping(net, x, a, c, drop):
    """fused_igr.fused_param_grads_plain with the rounding points named in
    ``drop`` ("x", "stash", "cotangent", "head") left out."""
    from sdf_representation_tpu_torch.ops import fused_igr as fi
    from sdf_representation_tpu_torch.ops import fused_mlp as fm

    def rnd(t, point):
        return t if point in drop else fm._working(t, net.dtype)

    beta, layers = net.beta, fi._head_layers(net)
    n_lin = len(layers)
    x, c, a = rnd(x.float(), "x"), rnd(c.float(), "x"), a.float()
    h, tc, stash = x, c, []
    for layer, (kind, w_h, w_x, b) in enumerate(layers):
        if kind == "first":
            z, tcz = x @ w_x, c @ w_x
        elif kind == "skip":
            z, tcz = (h @ w_h + x @ w_x) * fm.INV_SQRT2, (tc @ w_h + c @ w_x) * fm.INV_SQRT2
        else:
            z, tcz = h @ w_h, tc @ w_h
        z = z + b
        if layer < n_lin - 1:
            h, tc = rnd(fi._act(z, beta), "stash"), rnd(tcz * fi._sigma(z, beta), "stash")
            stash.append((h, tc))
    if beta > 0:
        dz, dtcz = a[:, None], torch.ones_like(z)
    else:
        z, tcz = rnd(z, "head"), rnd(tcz, "head")
        t = torch.tanh(z)
        fp = 1.0 - t * t
        dz, dtcz = a[:, None] * fp - 2.0 * t * fp * tcz, fp
    grads = [None] * n_lin
    for layer in range(n_lin - 1, -1, -1):
        kind, w_h, w_x, _ = layers[layer]
        scale = fm.INV_SQRT2 if kind == "skip" else 1.0
        h_prev, tc_prev = (x, c) if layer == 0 else stash[layer - 1]
        dz_c, dtcz_c = rnd(dz, "cotangent"), rnd(dtcz, "cotangent")
        g_h = None if w_h is None else (h_prev.T @ dz_c + tc_prev.T @ dtcz_c) * scale
        g_x = None if w_x is None else (x.T @ dz_c + c.T @ dtcz_c) * scale
        grads[layer] = (g_h, g_x, dz.sum(dim=0))
        if layer > 0:
            dh, dtc = (dz_c @ w_h.T) * scale, (dtcz_c @ w_h.T) * scale
            if beta > 0:
                sg = 1.0 - torch.exp(-beta * h_prev)
                dz = dh * sg + (dtc * tc_prev) * (beta * (1.0 - sg))
            else:
                sg = (h_prev > 0).float()
                dz = dh * sg
            dtcz = dtc * sg
    return grads


def check_igr(device, gen, report):
    """Phase 3, igr_fwd and igr_bwd against their plain versions: f, grad f,
    every dW and db, in f32 and bf16, with the bf16 controls. Returns what
    phase 5 times and the errors at those shapes:
    ({case: (model, x, a, c)}, {(kernel, case, type): max_abs_err})."""
    from sdf_representation_tpu_torch.models import ImplicitNet
    from sdf_representation_tpu_torch.ops import fused_igr as fi
    from sdf_representation_tpu_torch.ops import fused_mlp as fm

    # case: (width, beta, N, points kept clear of the step's flips)
    cases = {"8x512/n16384": (512, 100.0, 16384, False), "8x256/n5461": (256, 100.0, 5461, False),
             "8x256/n16384": (256, 100.0, 16384, False), "8x512/n4999": (512, 100.0, 4999, False),
             "8x512/n16384/relu": (512, 0.0, 16384, False),
             "8x512/n4096/relu_clear": (512, 0.0, 4096, True)}
    timed_cases, errors, controls, readings = {}, {}, {}, {}
    for case, (width, beta, n, clear) in cases.items():
        model = ImplicitNet(hidden_dims=(width,) * 8, skip_in=(4,), beta=beta, radius_init=0.5,
                            generator=gen, device=device)
        x = (torch.rand(IGR_RELU_CANDIDATES if clear else n, 3, generator=gen) * 2 - 1).to(device)
        # cotangents of a mean over the batch: a = dL/df, c = dL/d(grad f)
        a = (torch.randn(n, generator=gen) / n).to(device)
        c = (torch.randn(n, 3, generator=gen) / n).to(device)
        shapes = [w.shape for w, _ in model.effective_layers()]
        flips = beta <= 0 and not clear
        if case in ("8x512/n16384", "8x256/n5461"):
            timed_cases[case] = (model, x, a, c)
        candidates = x
        for dt in (torch.float32, torch.bfloat16):
            tag = f"{case}/{str(dt).split('.')[1]}"
            bf16 = dt == torch.bfloat16
            net = fm.FusedNet(model, dt)
            if clear:  # the n candidates whose pre-activations stay farthest from zero
                margin = torch.cat([igr_fwd_dropping(net, part, ())[2]
                                    for part in candidates.split(1 << 16)])
                top = torch.topk(margin, n)
                x = candidates[top.indices].contiguous()
                print(f"points igr/{tag}: {n} of {len(candidates)} candidates, every hidden |z| >= "
                      f"{top.values.min().item():.3e}", flush=True)
            f, g = fi.fused_value_and_grad(net, x)
            got = fi.unpack_grads(3, shapes, fi.fused_param_grads(net, x, a, c))
            torch.cuda.synchronize()
            pf, pg = fi.fused_value_and_grad_plain(net, x)
            padded = fi.fused_param_grads_plain(net, x, a, c)
            want = fi.unpack_grads(3, shapes, padded)
            if case == "8x512/n16384":  # the atomics' order: one input, two launches
                again = fi.unpack_grads(3, shapes, fi.fused_param_grads(net, x, a, c))
                print(f"check igr_bwd/{tag}: two launches differ by at most "
                      f"{gradient_errors(again, got)[1]:.3e} of a tensor's largest entry", flush=True)
            if not (f.shape == (n,) and g.shape == (n, 3) and torch.isfinite(f).all()
                    and torch.isfinite(g).all() and all(torch.isfinite(t).all() for t in got)):
                raise RuntimeError(f"igr/{tag}: non-finite or misshapen output")
            df, dg = (f - pf).abs(), (g - pg).abs()
            g_mean, g_worst = gradient_errors(got, want)
            max_tol = IGR_BF16_TOL if bf16 else F32_TOL
            worst_tol = IGR_RELU_BF16_GRAD_MAX_TOL if beta <= 0 else IGR_BF16_GRAD_MAX_TOL
            flipped = (dg.amax(dim=1) > max_tol).float().mean().item()
            readings[tag] = {"f_max": df.max().item(), "f_mean": df.mean().item(),
                             "grad_f_max": dg.max().item(), "grad_f_mean": dg.mean().item(),
                             "grad_f_over_max_limit": flipped, "grads_mean": g_mean, "grads_worst": g_worst}
            print(f"check igr_fwd/{tag}: f max {df.max().item():.3e} mean {df.mean().item():.3e}, "
                  f"grad f max {dg.max().item():.3e} mean {dg.mean().item():.3e}, over the max limit "
                  f"at {flipped:.5f} of the points", flush=True)
            print(f"check igr_bwd/{tag}: {len(got)} gradients, sum|diff|/sum|plain| {g_mean:.3e}, "
                  f"worst max|diff|/max|plain| {g_worst:.3e}", flush=True)
            ok = df.max().item() <= max_tol and (not bf16 or df.mean().item() <= IGR_BF16_F_MEAN_TOL)
            ok = ok and dg.mean().item() <= (IGR_BF16_G_MEAN_TOL if bf16 else F32_TOL)
            if flips:
                ok = ok and flipped <= IGR_RELU_FLIPPED and g_mean <= IGR_RELU_GRAD_MEAN_TOL
            elif bf16:
                ok = ok and dg.max().item() <= max_tol
                ok = ok and g_mean <= IGR_GRAD_MEAN_TOL and g_worst <= worst_tol
            else:
                ok = ok and dg.max().item() <= max_tol and g_worst <= IGR_F32_GRAD_TOL
            if not ok:
                raise RuntimeError(f"igr/{tag}: kernel and plain version disagree")
            errors["igr_fwd", case, dt] = max(df.max().item(), dg.max().item())
            errors["igr_bwd", case, dt] = max((u - v).abs().max().item() for u, v in zip(got, want))
            if not bf16 or flips or case not in ("8x512/n16384", "8x256/n5461", "8x512/n4096/relu_clear"):
                continue
            # controls: a kernel that left one bf16 rounding point out must fail
            # the limits. step'(z) is exact in bf16: ReLU has no "stash" control
            # forward; backward its "stash" is the activation and the tangent.
            cf, cg, _ = igr_fwd_dropping(net, x, ())
            same = all(torch.equal(u, v) for pair in zip(igr_bwd_dropping(net, x, a, c, ()), padded)
                       for u, v in zip(pair[0], pair[1]) if u is not None)
            if not (torch.equal(cf, pf) and torch.equal(cg, pg) and same):
                raise RuntimeError(f"control igr/{tag}: the control versions are not the plain ones")
            for drop in ("x", "act", "cotangent") if beta <= 0 else ("x", "stash", "act", "cotangent"):
                cf, cg, _ = igr_fwd_dropping(net, x, (drop,))
                ef, eg = (cf - pf).abs().mean().item(), (cg - pg).abs().mean().item()
                controls[f"igr_fwd/{tag}/without_{drop}"] = {"f_mean": ef, "grad_f_mean": eg}
                print(f"control igr_fwd/{tag}/without_{drop}: f mean {ef:.3e}, grad f mean {eg:.3e}",
                      flush=True)
                if ef <= IGR_BF16_F_MEAN_TOL and eg <= IGR_BF16_G_MEAN_TOL:
                    raise RuntimeError(f"control igr_fwd/{tag}/without_{drop}: the limits would pass it")
            for drop in ("x", "stash", "cotangent") + (("head",) if beta <= 0 else ()):
                cw = fi.unpack_grads(3, shapes, igr_bwd_dropping(net, x, a, c, (drop,)))
                c_mean, c_worst = gradient_errors(cw, want)
                controls[f"igr_bwd/{tag}/without_{drop}"] = {"mean": c_mean, "worst": c_worst}
                print(f"control igr_bwd/{tag}/without_{drop}: sum|diff|/sum|plain| {c_mean:.3e}, "
                      f"worst {c_worst:.3e}", flush=True)
                if c_mean <= IGR_GRAD_MEAN_TOL and c_worst <= worst_tol:
                    raise RuntimeError(f"control igr_bwd/{tag}/without_{drop}: the limits would pass it")
    report.update(igr_readings=readings, igr_controls=controls)
    return timed_cases, errors


def with_keys(text, **values):
    """INI text with the line of each given key replaced by ``key = value``."""
    for key, value in values.items():
        text, n = re.subn(rf"^{re.escape(key)} = .*$", f"{key} = {value}", text, flags=re.M)
        if n != 1:
            raise RuntimeError(f"the config holds {n} lines for {key!r}")
    return text


def drive_pipeline(device, run_root, report):
    """Phases 4b and 4c: sample -> train (three precisions) -> audit ->
    reconstruct, then the eikonal runs (labelled IGRLOSS, the point-cloud
    trainer, both also at the default precision), all through the entry
    point, counts zeroed before each run. Returns the launches per run,
    {run: {kernel: count}}."""
    from sdf_representation_tpu_torch import cli
    from sdf_representation_tpu_torch.configgen import Configuration
    from sdf_representation_tpu_torch.data.dataset import frame_from_csv
    from sdf_representation_tpu_torch.evaluations import post_process, reconstruct
    from sdf_representation_tpu_torch.geometry.mesh_io import load_mesh, save_mesh
    from sdf_representation_tpu_torch.geometry.primitives import make_icosphere
    from sdf_representation_tpu_torch.geometry.rescale import rescale_mesh
    from sdf_representation_tpu_torch.ops import fused_igr as fi
    from sdf_representation_tpu_torch.ops import fused_mlp as fm
    from sdf_representation_tpu_torch.ops import sdf_streams as ss
    from sdf_representation_tpu_torch.sampling import sampler
    from sdf_representation_tpu_torch.training import PointCloudTrainer, Trainer
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
        fi.reset_launches()
        with counting_plain_calls((fm, ss, fi)) as plain:
            t0 = time.perf_counter()
            if cli.main([cfg_path]) != 0:
                raise RuntimeError(f"{tag}: the entry point failed")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches[tag] = {**fm.LAUNCHES, **ss.LAUNCHES, **fi.LAUNCHES}
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
        if any(launches[f"train/{precision}"].values()):
            raise RuntimeError("supervised training launched a kernel")
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

    # -- 4c. the eikonal path: labelled IGRLOSS, then the point-cloud trainer ----
    def only(tag, **expected):
        want = {name: expected.get(name, 0) for name in launches[tag]}
        if launches[tag] != want:
            raise RuntimeError(f"{tag}: launches {launches[tag]}, expected {want}")

    igr_base = with_keys(base.replace("weight_factor = 0.5\n", ""), loss_function="IGRLOSS")
    n_train = sum(rows.values()) - math.ceil(0.1 * sum(rows.values()))
    out["igr"] = {}
    for precision, epochs in (("bfloat16", IGR_EPOCHS), ("default", 2)):
        tag = f"igr_train/{precision}"
        shutil.copytree(data_root, root / f"igr_{precision}" / data_root.name,
                        ignore=shutil.ignore_patterns("ImplicitNet*"))
        text = with_keys(igr_base, directory=f"{root}/igr_{precision}/", epochs=epochs,
                         min_epochs=epochs, checkpointing=epochs, train_matmul_precision=precision)
        path = root / f"igr_{precision}.ini"
        path.write_text(text)
        wall = run(tag, str(path))
        steps = (n_train // 16384) * epochs
        # the rule (training/trainer.py use_fused_igr): the kernels run under
        # bfloat16 on a card, once per step each; under the default precision
        # the fast path is the shared-matmul derivation with torch autograd
        only(tag, **({"igr_fwd": steps, "igr_bwd": steps} if precision == "bfloat16" else {}))
        curve = np.loadtxt(pathlib.Path(Trainer(Configuration(str(path))).train_path) / "train_loss.txt")
        stats = dict(trainer_module.LAST_RUN)
        print(f"igr_train {precision}: {steps} steps, launches per step "
              f"{launches[tag]['igr_fwd'] / steps:g} igr_fwd, {launches[tag]['igr_bwd'] / steps:g} "
              f"igr_bwd, {stats}, train loss " + " ".join(f"{v:.3e}" for v in curve[:, 1])
              + ", val loss " + " ".join(f"{v:.3e}" for v in curve[:, 2]), flush=True)
        if not (len(curve) == epochs and np.isfinite(curve).all() and curve[-1, 1] < curve[0, 1]):
            raise RuntimeError(f"{tag}: the loss did not fall: {curve[:, 1]}")
        out["igr"][precision] = {"wall_s": wall, **stats, "steps": steps,
                                 "train_loss": curve[:, 1].tolist(), "val_loss": curve[:, 2].tolist()}

    cloud_dir = root / "pcd_cloud"
    cloud_dir.mkdir()
    t0 = time.perf_counter()
    cloud = sampler.sample_surface_points(rescale_mesh(make_icosphere(5, 0.5)), 1,
                                          np.random.default_rng(SEED), area_weighted=True,
                                          total_points=PCD_POINTS)
    np.savetxt(cloud_dir / "surface.csv", cloud, delimiter=",", header="x,y,z", comments="",
               fmt="%.9g")
    print(f"point cloud: {len(cloud)} surface points of the rescaled icosphere, sampled and "
          f"written in {time.perf_counter() - t0:.2f} s", flush=True)
    pcd_base = with_keys((REPO / "configs" / "pointcloud_igr.ini").read_text(),
                         geometry=f"{cloud_dir}/")
    out["pcd"] = {}
    for precision, epochs, every in (("bfloat16", PCD_EPOCHS, 10), ("default", 3, 2)):
        tag = f"pcd_train/{precision}"
        text = with_keys(pcd_base, directory=f"{root}/pcd_{precision}/", epochs=epochs,
                         min_epochs=epochs, checkpointing=every)
        if precision != "default":
            text += f"\n[TPU]\ntrain_matmul_precision = {precision}\n"
        path = root / f"pcd_{precision}.ini"
        path.write_text(text)
        wall = run(tag, str(path))
        steps = (PCD_POINTS // 16384) * epochs
        only(tag, **({"igr_fwd": steps, "igr_bwd": steps} if precision == "bfloat16" else {}))
        t = PointCloudTrainer(Configuration(str(path)))
        log = (pathlib.Path(t.train_path) / "train_loss.txt").read_text().splitlines()
        curve = np.array([float(line.rsplit(" ", 1)[1]) for line in log])
        stats = dict(trainer_module.LAST_RUN)
        print(f"pcd_train {precision}: {steps} steps, launches per step "
              f"{launches[tag]['igr_fwd'] / steps:g} igr_fwd, {launches[tag]['igr_bwd'] / steps:g} "
              f"igr_bwd, {stats}, train loss " + " ".join(f"{v:.3e}" for v in curve), flush=True)
        if not (len(curve) == epochs and np.isfinite(curve).all() and curve[-1] < curve[0]):
            raise RuntimeError(f"{tag}: the loss did not fall: {curve}")
        out["pcd"][precision] = {"wall_s": wall, **stats, "steps": steps, "train_loss": curve.tolist()}
        if precision != "bfloat16":
            continue
        # reconstruct from the point-cloud checkpoint (the labelled trainer's
        # modes read it: distributed = False, the same run directory)
        rec = root / "pcd_reconstruct.ini"
        rec.write_text(with_keys(text, distributed=False, ppo=True, reconstruct=True, cubesize=128))
        tag = "pcd_reconstruct/128"
        wall = run(tag, str(rec))
        only(tag, fused_grid=1)
        mesh = load_mesh(str(pathlib.Path(t.postprocess_save_path)
                             / f"reconstructed_epoch{PCD_EPOCHS - 1}.stl"))
        radii = np.linalg.norm(mesh.vertices, axis=1)
        print(f"mesh from the point-cloud field, 128^3: {len(mesh.faces)} faces, vertex radius "
              f"median {np.median(radii):.4f} (the cloud's sphere: 0.85; reported, not gated: "
              f"{PCD_EPOCHS} epochs of IGR do not make a clean surface), within 0.02 of it "
              f"{np.mean(np.abs(radii - 0.85) < 0.02):.3f} of the vertices", flush=True)
        if len(mesh.faces) < 100 or not np.isfinite(mesh.vertices).all():
            raise RuntimeError(f"{tag}: no finite mesh came out")
        out["pcd"]["reconstruct_128"] = {"wall_s": wall, "faces": len(mesh.faces),
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
    from sdf_representation_tpu_torch.ops import fused_igr as fi
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
    report["build_s"] = kernels.build_all(["fused_mlp", "sdf_streams", "fused_igr"], verbose=True)
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
    igr_cases, igr_errors = check_igr(device, gen, report)

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
        fi.reset_launches()
        t0 = time.perf_counter()
        if cli.main([configs[cubesize]]) != 0:
            raise RuntimeError("the entry point failed")
        wall = time.perf_counter() - t0
        launches = {**fm.LAUNCHES, **ss.LAUNCHES, **fi.LAUNCHES}
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
    # igr_fwd and igr_bwd at the eikonal runs' shapes: the labelled step's
    # 16,384 points at 8x512, the point-cloud step's 16,384 // 3 at 8x256
    def library_vag(net_model, x, a, c, dt, backward):
        """The same (f, grad f) — and with ``backward`` the parameter gradients
        of sum(a f + c . grad f) — through cuBLAS and torch autograd's double
        backward (the yardstick; the port never calls it)."""
        params = [(w.detach().to(dt).requires_grad_(backward), b.detach().to(dt).requires_grad_(backward))
                  for w, b in net_model.effective_layers()]
        xx = x.to(dt).requires_grad_(True)
        h = xx
        for i, (w, b) in enumerate(params):
            if i in net_model.skip_in:
                h = torch.cat([h, xx], -1) * (1 / math.sqrt(2))
            h = torch.addmm(b, h, w.T)
            if i < len(params) - 1:
                h = torch.nn.functional.softplus(h, beta=net_model.beta)
        f = h[:, 0]
        (g,) = torch.autograd.grad(f.sum(), xx, create_graph=backward)
        if backward:
            torch.autograd.grad((a.to(dt) * f).sum() + (c.to(dt) * g).sum(),
                                [t for pair in params for t in pair])

    for name, replaces in (
        ("igr_fwd", "sdf_representation_tpu/ops/pallas_igr.py:209 _fused_vag_fwd"),
        ("igr_bwd", "sdf_representation_tpu/ops/pallas_igr.py:412 _fused_vag_bwd"),
    ):
        by_run = {tag: counts[name] for tag, counts in runs.items() if counts[name]}
        entry = {"name": name, "route": "cuda", "source": "sdf_representation_tpu_torch/csrc/fused_igr.cu",
                 "replaces": replaces, "launches": sum(by_run.values()), "launches_by_run": by_run}
        for case, (net_model, x, a, c) in igr_cases.items():
            n, d = x.shape
            shapes = net_model.layer_shapes()
            macs = sum(fi_ * fo for fi_, fo in shapes)
            mac0 = shapes[0][0] * shapes[0][1]
            for dt in (torch.bfloat16, torch.float32):
                net = fm.FusedNet(net_model, dt)
                hidden = len(net.spec) - 1
                wbuf, bbuf, _ = net.packed
                # what the function must move: the weights and biases once in
                # the working type, the inputs, the outputs. The kernel's own
                # traffic (its stash workspace, written and read back, and the
                # transposed weight copies) is reported beside the bound, not in it.
                w_bytes = wbuf.numel() * wbuf.element_size() + bbuf.numel() * bbuf.element_size()
                if name == "igr_fwd":
                    # one pass forward, one transposed pass back (2 per layer)
                    ops = 2.0 * n * 2 * macs
                    rows = -(-n // fi.FWD_TILE_P) * fi.TILE_ROWS
                    bytes_ = n * d * 4 + w_bytes + n * (1 + d) * 4
                    run = lambda: fi.fused_value_and_grad(net, x)
                    plain = lambda: fi.fused_value_and_grad_plain(net, x)
                    lib = lambda: library_vag(net_model, x, a, c, dt, False)
                else:
                    # two chains forward, two back (no W^T pass below the first
                    # layer), two into dW (~6 per layer); out: f32 dW and db
                    ops = 2.0 * n * (2 * macs + 2 * (macs - mac0) + 2 * macs)
                    rows = -(-n // fi.BWD_TILE_P) * fi.TILE_ROWS
                    bytes_ = n * (2 * d + 1) * 4 + w_bytes + (wbuf.numel() + bbuf.numel()) * 4
                    run = lambda: fi.fused_param_grads(net, x, a, c)
                    plain = lambda: fi.fused_param_grads_plain(net, x, a, c)
                    lib = lambda: library_vag(net_model, x, a, c, dt, True)
                stash_bytes = hidden * rows * net.h_pad * 4
                t_bytes, t_ops = bytes_ / MEM_BW * 1e3, ops / PEAK[dt] * 1e3
                ms, plain_ms, lib_ms = timed(run, 5), timed(plain, 2), timed(lib, 3)
                numbers = {"max_abs_err": igr_errors[name, case, dt], "ms": ms, "plain_ms": plain_ms,
                           "bound_ms": max(t_bytes, t_ops),
                           "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                           "library_ms": lib_ms, "points": n, "bound_bytes": bytes_,
                           "stash_bytes": stash_bytes,
                           "tflops": ops / ms / 1e9, "points_per_s": n / ms * 1e3}
                tag = str(dt).split(".")[1]
                print(f"time {name}/{case}/{tag}: " + json.dumps(numbers), flush=True)
                if case == "8x512/n16384" and dt == torch.bfloat16:
                    entry.update(numbers, dtype="bfloat16", shape=case)
                else:
                    entry[f"{case}/{tag}"] = numbers
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
