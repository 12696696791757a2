#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (sdf_representation_tpu_torch) on one card.

    python3 chip_smoke.py

Phases, none of which is allowed to fail quietly:

 1. Card name and power limit (nvidia-smi); TF32 off, checked.
 2. Build csrc/fused_mlp.cu, csrc/sdf_streams.cu and csrc/fused_igr.cu with
    nvcc for sm_90a, all at once, printing ptxas's report; then each bf16
    entry of fused_mlp.cu (the tensor-core routine, at widths 128-512: 12)
    and of fused_igr.cu (igr_fwd and igr_bwd at widths 128-512, softplus and
    ReLU, and the dW pass igr_dw: 17) must issue HGMMA and use no local
    memory (cuobjdump's SASS and resource usage, printed per entry).
 3. Kernels against their plain PyTorch versions on the flagship net
    (configs/mesh_sdf.ini: ImplicitNet 8x512, skip at layer 4, beta 100;
    geometric init, radius 0.5, seeded weights), in f32 and bf16: the points
    kernel on 1M random points, the dense grid kernel at n = 128, the
    sparse block kernel on the active blocks at n = 256 — which must also
    equal the dense grid kernel at n = 256 bit for bit — and a ReLU/tanh
    (beta = 0) points case. Controls: the plain bf16 forward with one
    rounding point left out must fail the bf16 limits on the same inputs.
    The bf16 plain version (and the controls' forward) sums each layer
    exactly, in f64: it follows no kernel's summation order.
    The exact-SDF streams (distance, winding) against their plain versions
    on a rescaled icosphere of 20,480 faces and 262,144 points (uniform,
    on-surface, narrow-band), with the dense schedule and a sparse one
    (~60% of the chunks, one block unvisited): d^2 within rtol 1e-5 / atol
    1e-7, winners equal but for ties the f64 oracle proves, solid angles
    within rtol 1e-4 / atol 1e-3 and the inside/outside sign equal outside
    that margin; signed_distance against the sphere's analytic distance.
    Control: the plain winding with its dots rounded to 10-bit mantissas
    (as TF32 would) must fail the solid-angle limit on the same input.
    The sharded streams (kernels 6 and 7) on the same points with the
    schedule the culled method makes for them (Morton blocks of 2,048, the
    cull against chunks of 512 faces), the card listed 2 and 4 times: d^2,
    winners and solid angles bit-equal to one launch over all blocks, and
    within the stream limits of the plain sharded walk; the points' Morton
    order on the card equals the host's.
    The fused (f, grad_x f) kernel and its params-only backward (igr_fwd,
    igr_bwd) against their plain versions at 8x512 and 8x256 (skip 4, beta
    100), N = 16,384 and an odd N, in f32 and bf16: f, grad f, every dW and
    db. ReLU/tanh on uniform points, where step'(z) may flip at a few, and on
    points picked to keep every pre-activation clear of zero, where every
    limit of the softplus cases holds: at 8x512 in f32 (in bf16 differing
    roundings still flip single steps there), at 4x512 in both types. Controls: the bf16 plain
    versions with one rounding point left out must fail the bf16 limits.
    bf16 igr_bwd sums in a fixed order: two launches must give the same dW
    and db bit for bit; its two passes (the workspace of its first pass, and
    the dW pass over a workspace) are held against their plain versions.
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
    no plain version may run. The 256^3 audit takes the culled method (by
    "auto": 1.7e7 points x 20,480 faces), the 64^3 one the dense sweep; the
    culled stages, sum_kd, sum_kw and their share of the dense pairs are
    printed, and the sign accuracy at 256 must be >= 0.999.
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
 4d. The culled exact signed distance through its entry point,
    signed_distance(method="culled"), on the 256^3 grid, counts zeroed
    before each run: against the rescaled icosphere(5) (20,480 faces) on
    the card, then sharded over the card listed 4 times (only the sharded
    kernels launch; the result is bit-equal); with the coarse bound (on by
    N F >= 1e12) against the rescaled icosphere(6) (81,920 faces) and the
    impeller (444,508 faces, non-convex). Each against method="dense":
    distances within 1e-6, sign disagreements counted and listed with |d|.
 4e. The trained 8x512 net of 4b: sparse blocks equal the dense grid kernel
    bit for bit, bf16 and f32. The sharded evaluators and data-parallel
    training, the card listed several times, counts zeroed before each run
    and read after it:
    sharded_grid_eval (kernel 10: the grid entry once per shard from its
    base tile) at 256^3 in bf16 and f32 over the card listed 1, 2 and 4
    times, bit-equal to one fused_grid launch, and at 255^3 (the padded
    tail) against its plain version: f32 within F32_TOL; bf16 with the mean
    within BF16_MEAN_TOL of the plain version's exact sums and the max
    within BF16_TOL of the kernel's own summation order (plain_kernel_order;
    see BF16_TOL);
    sparse_sharded_grid_eval (kernel 11: the blocks entry once per shard
    over its slice of the active list) at 256^3 on the seeded and the
    trained 8x512 nets, x2 and x4: the count equals the single-device
    sparse evaluator's, every active block equals the dense grid kernel bit
    for bit; the voxels that differ from single-device sparse, the centres
    whose coarse value differs and the active blocks per shard are
    printed; k_max_frac 0.01 overflows the budget once and settles; each
    shard's launch against its plain version. Data-parallel training
    through the trainers the command line builds: labelled IGRLOSS at
    8x512, bfloat16, Trainer(mesh=card x 2), 2 epochs, and the point-cloud
    trainer at 8x256, bfloat16, mesh=card x 4, phase 4c's epochs: igr_fwd
    and igr_bwd launch once per shard and step, the loss falls, the
    point-cloud field's mesh at 128^3 sits on the cloud (median vertex
    radius within 1% of 0.85). One f32 IGRLOSS gradient through
    make_fused_value_and_grad_sharded (x2, x4) against the single-device op:
    rtol 2e-4 / atol 2e-5 (tests/test_sharding.py).
 5. Times with CUDA events at the main path's shapes: kernel, plain version,
    one library layer chain (torch addmm, never called by the port), and
    the bound: the larger of bytes over 3.35 TB/s and operations over the
    card's peak (989 TFLOP/s bf16 tensor cores for bf16, 67 TFLOP/s FP32
    for f32), published figures at a 700 W limit. For the streams the
    operations are counted per point-triangle pair from the kernel's code.
    For igr_fwd and igr_bwd at (8x512, N 16,384) and (8x256, N 5,461): the
    operations are 2 N times the multiply-adds of the products each kernel
    performs (2 and ~6 passes over the layers), the bytes are the inputs, the
    weights and the outputs (the kernels' workspace bytes and the kernel
    launches per wrapper call are reported beside the bound; bf16 igr_bwd
    also times its dW pass alone), and the library yardstick is the same
    (f, grad f) and parameter gradient through cuBLAS and torch autograd's
    double backward (create_graph=True), timed only.
    The sharded streams on phase 3's culled schedule, the card listed 4
    (and 2) times, against the plain sharded walk; the bound counts the
    schedule's pairs; the single-device streams are also timed on it.
    Kernels 10 and 11 at 256^3 and on the seeded net's active list, the
    card listed 1, 2 and 4 times, with kernel 1's and kernel 3's bounds and
    library chain for the same points; the whole sharded evaluators, the
    labelled IGRLOSS step (8x512, 16,384 points) and the point-cloud step
    (8x256, 16,384 + 5,461 points) in bfloat16 at x1, x2, x4, each beside
    kernels 8 and 9 launched once per shard on its rows.
 6. A `kernels` JSON line with eleven entries, then the contract line
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
# bf16: the plain version sums exactly (f64). Any f32 sum differs from it
# by a little, and where that moves an accumulator across a bf16 rounding
# boundary the output moves by up to ~4.2e-3 on this net, so a sound kernel
# differs from plain at a few points: on an H100 the tensor-core kernel
# reads max up to 2.55e-3, mean up to 8.9e-6 on phase 3's sets; leaving out
# one of the three bf16 rounding points moves nearly every point (mean
# 3.9e-4 and more, max from 2.2e-3). The mean limit sits between the two and
# separates them; the max limit catches gross errors and has little room
# (the nets of seeds 1 and 2 read up to 3.2e-3 on 1 M points). Over the
# 16.6 M points of a 255^3 grid such flips reach past the max limit against
# exact sums, for the kernel (4.2e-3) as for one f32 matmul over all of K
# (3.8e-3; 3.3e-3 to 3.9e-3 over seeds 0-2; tools/bf16_sum_study.py), so
# there the max is held against the kernel's own summation order with
# every other step plain (plain_kernel_order), which leaves the epilogue's
# own errors, and the mean against the exact sums. PERF.md has the
# readings; phase 3 shows in every run that the limits reject such a kernel.
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
# order; the f32 backward adds with atomics, whose order changes run to run).
# bf16 (the plain versions sum exactly, in f64): an f32 sum can round to the
# neighbouring bf16 value and sigma'(beta z) carries that on, so a sound
# kernel differs from plain at a few points; leaving out one rounding point
# moves nearly every point. The mean limits sit between the two (the
# controls are recomputed in every run and must fail them), the max limits
# catch gross errors. Against exact sums every f32 summation reads farther
# than against another f32 summation (the f32 plain version, the JAX order,
# reads 1.9e-3 to 2.1e-3 on the gradients of 8x512 softplus nets, the
# tensor-core kernel 1.5e-3 to 1.8e-3; tools/igr_sum_study.py, PERF.md).
# Under ReLU, step'(z) flips where two summations leave z on either side of
# zero, and a flipped point moves grad f and its share of dW by a whole
# term. So the ReLU kernels are held twice. "relu": the flagship 8x512 on
# uniform points: f keeps its limits, grad f may differ by more than the
# type's max limit at no more than IGR_RELU_FLIPPED of the points, and the
# gradients are held for gross errors only (IGR_RELU_GRAD_MEAN_TOL).
# "relu_clear": the 4,096 points, of 262,144 candidates, whose hidden
# pre-activations all stay farthest from zero, where every limit above
# applies, with the bf16 controls (the tanh head's rounding among them); the
# worst tensor is held by IGR_RELU_BF16_GRAD_MAX_TOL. At 8x512 the pick keeps
# |z| >= 8e-5: no f32 step flips, but bf16 roundings that differ upstream
# cross that margin at single points. Against exact sums, over six seeded
# nets, the kernel reads 2.5e-3 to 4.0e-3 on the gradients and the f32
# plain version 2.8e-3 to 4.6e-3, level with the cotangent and head
# controls (3.5e-3 to 5.1e-3); with 1,024 of 16.8 M candidates (|z| >=
# 2e-4) the f32 plain version still fails 2e-3 on three nets of six. So
# there bf16 keeps the limits of f and grad f with their controls, its
# gradients are held as "relu" with the controls that leave out x or the
# stash (5e-2 and more), and the cotangent and head controls are read, not
# gated. At 4x512 (skip at 2; |z| >= 1.6e-4) the kernel (2.2e-5 to 1.8e-4
# on the gradients) and the f32 plain version hold every limit on all six
# nets and every control fails (the gradients' from 3.3e-3): there bf16
# keeps every limit and every control.
# tools/igr_sum_study.py; PERF.md has the readings.
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


def plain_dropping(net, x, drop, product=None):
    """The bf16 plain forward (fused_mlp.forward_plain: every layer in f64)
    over (M, 3) points with the rounding points named in ``drop``
    ("coords", "acc", "act") left out: what a kernel that skipped them
    would compute. The bf16 limits must reject it (the control of the bf16
    checks). Given ``product(h, w_h)``, the forward runs in f32 instead and
    takes each hidden-input product from it (plain_kernel_order)."""
    from sdf_representation_tpu_torch.ops import fused_mlp as fm

    work = torch.float64 if product is None else torch.float32
    product = product or (lambda h, w_h: h @ w_h)

    def rnd(t, point):
        return t if point in drop else fm._rounded(t)

    out = torch.empty(x.shape[0], dtype=torch.float32, device=x.device)
    n_lin = len(net.plain_layers)
    for start in range(0, x.shape[0], fm.PLAIN_CHUNK):
        xc = rnd(x[start:start + fm.PLAIN_CHUNK].to(work), "coords")
        h = xc
        for layer, (kind, w_h, w_x, b) in enumerate(net.plain_layers):
            w_h, w_x, b = (None if t is None else t.to(work) for t in (w_h, w_x, b))
            if kind == "first":
                acc = xc @ w_x + b
            elif kind == "skip":
                acc = (product(h, w_h) + xc @ w_x) * fm.INV_SQRT2 + b
            else:
                acc = product(h, w_h) + b
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
        out[start:start + xc.shape[0]] = (torch.tanh(h) if net.beta <= 0 else h)[:, 0].float()
    return out


def plain_kernel_order(net, x):
    """The bf16 forward over (M, 3) points on the card with each hidden-input
    product summed as the bf16 kernels sum it (the kSumK-deep tensor-core
    sums of csrc/hopper.cuh's mma_stream, each a cuBLAS bf16 product with an f32 result,
    added in order in f32) and every other step the plain version's in f32:
    held against the kernel, it leaves the epilogue's own errors (the
    cheaper softplus, the order of bias and scale). Only the 255^3 max uses
    it (see BF16_TOL)."""
    src = (REPO / "sdf_representation_tpu_torch" / "csrc" / "hopper.cuh").read_text()
    depth = int(re.search(r"constexpr int kSumK = (\d+);", src).group(1))

    def product(h, w_h):
        hb, wb = h.to(torch.bfloat16), w_h.to(torch.bfloat16)
        acc = torch.mm(hb[:, :depth], wb[:depth], out_dtype=torch.float32)
        for k in range(depth, w_h.shape[0], depth):
            acc = acc + torch.mm(hb[:, k:k + depth], wb[k:k + depth], out_dtype=torch.float32)
        return acc

    return plain_dropping(net, x, (), product)


def check_sass(library, entry, expected):
    """Each bf16 entry of a source (the tensor-core kernels: mangled names
    that the regular expression ``entry`` finds) must issue tensor-core products (HGMMA) and use no local
    memory (spills or stack): counts from cuobjdump's SASS and resource
    usage, printed per function; ``expected`` entries."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(library)], capture_output=True, text=True,
                          check=True).stdout
    usage = subprocess.run([tool, "-res-usage", str(library)], capture_output=True, text=True,
                           check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            counts[fn] = {"instructions": 0, "HGMMA": 0}
        elif fn and re.search(r"/\*[0-9a-f]{4,}\*/\s+[@A-Z]", line):
            counts[fn]["instructions"] += 1
            counts[fn]["HGMMA"] += "HGMMA" in line
    for m in re.finditer(r"Function (\S+):\s*REG:(\d+) STACK:(\d+) SHARED:(\d+) LOCAL:(\d+)", usage):
        if m.group(1) in counts:
            counts[m.group(1)].update(registers=int(m.group(2)), stack=int(m.group(3)),
                                      local=int(m.group(5)))
    entries = {name: c for name, c in counts.items() if re.search(entry, name)}
    for name, c in sorted(entries.items()):
        print(f"sass {name}: {c}", flush=True)
    if len(entries) != expected:
        raise RuntimeError(f"expected {expected} bf16 entries in {library.name}'s SASS, found {len(entries)}")
    for name, c in entries.items():
        if c["HGMMA"] == 0:
            raise RuntimeError(f"{name} issues no HGMMA")
        if c.get("local", 1) or c.get("stack", 1):
            raise RuntimeError(f"{name}: local memory (spills or stack) or no resource usage: {c}")
    return counts


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
        n_differ = check_tie_winners(pts, tri, best[:n_blocks].flatten().cpu().numpy(),
                                     pbest[:n_blocks].flatten().cpu().numpy(), f"streams/{tag}")
        decided = (pw - 2 * math.pi).abs() > margin
        flips = ((w > 2 * math.pi) != (pw > 2 * math.pi))[decided].sum().item()
        print(f"check dist_stream/{tag}: {steps} steps, max |d2 diff| {err_d:.3e} (rtol {D2_RTOL:g}, "
              f"atol {D2_ATOL:g}), winners differing {n_differ} (all ties)", flush=True)
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
    return P, schedules["dense"], tables, tri_chunk, errors, mesh, pts


def check_tie_winners(pts, tri, got, want, what):
    """Winners that differ must be ties: equidistant under the f64 oracle."""
    from sdf_representation_tpu_torch.ops import sdf_exact as se

    differ = np.nonzero(got != want)[0]
    if len(differ):
        q = pts[differ].astype(np.float64)
        da = np.linalg.norm(q - se.closest_point_on_triangles(q, tri[got[differ]]), axis=1)
        db = np.linalg.norm(q - se.closest_point_on_triangles(q, tri[want[differ]]), axis=1)
        if not np.allclose(da, db, rtol=1e-5, atol=1e-6):
            raise RuntimeError(f"{what}: {len(differ)} winners differ and are no ties")
    return len(differ)


def check_sharded(device, mesh, pts, report):
    """Phase 3, kernels 6 and 7: the sharded streams on phase 3's points
    with the schedule the culled method makes for them (Morton blocks of
    2,048 points, chunks of 512 faces, as "auto" picks for 20,480 faces),
    the card listed 2 and 4 times: bit-equal to one launch over all blocks,
    and within the stream limits of the plain sharded walk. Returns what
    phase 5 times: (points, dist schedule, wind schedule, tables, tri_chunk,
    errors)."""
    from sdf_representation_tpu_torch.ops import sdf_culled as sc
    from sdf_representation_tpu_torch.ops import sdf_exact as se
    from sdf_representation_tpu_torch.ops import sdf_streams as ss

    tri_chunk, m = 512, 2048
    faces = mesh.faces[sc._morton_order(mesh.vertices[mesh.faces].mean(axis=1))]
    order, P = sc._sorted_blocks(pts, m, device)
    if not np.array_equal(order.cpu().numpy(), sc._morton_order(pts)):
        raise RuntimeError("the Morton order on the card differs from the host's")
    n_blocks = P.shape[0]
    pad = P.reshape(-1, 3).cpu().numpy()
    tables, _ = se._triangle_tables(mesh.vertices, faces, tri_chunk)
    centers, radii, _, cbar = sc._chunk_geometry(mesh.vertices, faces, tri_chunk)
    scale = float(max(np.abs(mesh.vertices).max(), np.abs(pts).max(), 1.0))
    kd, kw = sc._cull(P, np.full((n_blocks, m), np.inf, np.float32), centers, radii, 2.0,
                      cbar=cbar, slack=sc._CULL_SLACK * scale)
    (db, dc, sd), (wb, wc, sw) = ss.stream_steps(kd, n_blocks), ss.stream_steps(kw, n_blocks)
    print(f"sharded: culled schedule on {len(pts)} points in {n_blocks} blocks of {m}, "
          f"{kd.shape[1]} chunks of {tri_chunk}: {sd} distance steps ({sd / kd.size:.3f} of "
          f"dense), {sw} winding steps ({sw / kw.size:.3f})", flush=True)
    d2, best = ss.dist_stream(P, db, dc, tables, tri_chunk)
    w = ss.wind_stream(P, wb, wc, tables, tri_chunk)
    d2, best, w = (t[:n_blocks].cpu().numpy() for t in (d2, best, w))
    for n_dev in (2, 4):
        mesh_devices = (device,) * n_dev
        sd2, sbest = ss.dist_stream_sharded(P, db, dc, tables, tri_chunk, mesh_devices)
        sw_ = ss.wind_stream_sharded(P, wb, wc, tables, tri_chunk, mesh_devices)
        same = (np.array_equal(sd2, d2) and np.array_equal(sbest, best)
                and np.array_equal(sw_, w))
        print(f"check sharded x{n_dev}: d2, winners and solid angles bit-equal to one launch: "
              f"{same}", flush=True)
        if not same:
            raise RuntimeError(f"sharded x{n_dev}: differs from the single-device launch")
    pd2, pbest = ss.dist_stream_sharded_plain(P, db, dc, tables, tri_chunk, mesh_devices)
    pw = ss.wind_stream_sharded_plain(P, wb, wc, tables, tri_chunk, mesh_devices)
    finite = np.isfinite(pd2)
    over_d, err_d = exceeds(torch.from_numpy(sd2[finite]), torch.from_numpy(pd2[finite]),
                            D2_RTOL, D2_ATOL)
    over_w, err_w = exceeds(torch.from_numpy(sw_), torch.from_numpy(pw), W_RTOL, W_ATOL)
    ties = check_tie_winners(pad, mesh.vertices[faces], sbest.reshape(-1), pbest.reshape(-1),
                             "dist_stream_sharded")
    print(f"check dist_stream_sharded x4: max |d2 diff| {err_d:.3e}, winners differing {ties} "
          f"(all ties); wind_stream_sharded x4: max |omega diff| {err_w:.3e}", flush=True)
    if over_d > 0 or over_w > 0 or not np.array_equal(np.isfinite(sd2), finite):
        raise RuntimeError("sharded streams: kernel and plain version disagree")
    report["sharded"] = {"blocks": n_blocks, "chunks": kd.shape[1], "dist_steps": sd,
                         "wind_steps": sw}
    errors = {"dist_stream_sharded": err_d, "wind_stream_sharded": err_w}
    return P, (db, dc), (wb, wc), tables, tri_chunk, errors


def drive_culled(device, report):
    """Phase 4d: signed_distance(method="culled") on the 256^3 grid, counts
    zeroed before each run and read after it, against method="dense": the
    rescaled icosphere(5) (20,480 faces) on one card and sharded over the
    card listed 4 times (bit-equal to one card); with the coarse bound (on
    by N F >= 1e12) the rescaled icosphere(6) (81,920 faces) and the
    impeller (a non-convex part). Distances within 1e-6 of the dense ones;
    sign disagreements counted and listed with their |d| (the dipole's far
    field is approximate: one further than 1e-2 from the surface fails).
    Returns the launches per run."""
    from sdf_representation_tpu_torch.geometry.primitives import make_icosphere, make_impeller
    from sdf_representation_tpu_torch.geometry.rescale import rescale_mesh
    from sdf_representation_tpu_torch.ops import fused_igr as fi
    from sdf_representation_tpu_torch.ops import fused_mlp as fm
    from sdf_representation_tpu_torch.ops import sdf_culled as sc
    from sdf_representation_tpu_torch.ops import sdf_exact as se
    from sdf_representation_tpu_torch.ops import sdf_streams as ss
    from sdf_representation_tpu_torch.ops.grid_eval import grid_coords

    grid = grid_coords(256)
    launches, out = {}, {}

    def run(tag, **kw):
        torch.cuda.synchronize()
        for counters in (fm, ss, fi):
            counters.reset_launches()
        with counting_plain_calls((ss,)) as plain:
            t0 = time.perf_counter()
            sdf, _ = se.signed_distance(grid, mesh, return_normals=False, **kw)
            wall = time.perf_counter() - t0
        launches[tag] = {**fm.LAUNCHES, **ss.LAUNCHES, **fi.LAUNCHES}
        if any(plain.values()) or any({**fm.LAUNCHES, **fi.LAUNCHES}.values()):
            raise RuntimeError(f"{tag}: a plain version or another kernel ran: {plain}, "
                               f"{launches[tag]}")
        if not (sdf.shape == (len(grid),) and np.isfinite(sdf).all()):
            raise RuntimeError(f"{tag}: the distances are not finite")
        return sdf, wall

    for name, mesh in (("icosphere5", rescale_mesh(make_icosphere(5, 0.5))),
                       ("icosphere6", rescale_mesh(make_icosphere(6, 0.5))),
                       ("impeller", make_impeller())):
        sdf, wall = run(f"culled/{name}", method="culled")
        stages, counts = dict(sc.LAST_STAGE_SECONDS), dict(sc.LAST_COUNTS)
        lc = launches[f"culled/{name}"]
        # the coarse bound's node sweep is one more distance launch
        if not (lc["dist_stream"] == 1 + counts["coarse_bound"] and lc["wind_stream"] == 1
                and counts["points"] == len(grid) and counts["shards"] == 1):
            raise RuntimeError(f"culled/{name}: launches {lc}, counts {counts}")
        if name != "icosphere5" and not counts["coarse_bound"]:
            raise RuntimeError(f"culled/{name}: the coarse bound did not run")
        row = {"faces": len(mesh.faces), "wall_s": wall, "stages_s": stages, "counts": counts,
               "kd_share": counts["sum_kd"] / (counts["blocks"] * counts["dist_chunks"]),
               "kw_share": counts["sum_kw"] / (counts["blocks"] * counts["chunks"])}
        if name == "icosphere5":
            sharded, row["sharded_wall_s"] = run("culled/icosphere5/sharded_x4", method="culled",
                                                 devices=(device,) * 4)
            ls = launches["culled/icosphere5/sharded_x4"]
            if not (ls["dist_stream_sharded"] == 4 and ls["wind_stream_sharded"] == 4
                    and ls["dist_stream"] == ls["wind_stream"] == 0):
                raise RuntimeError(f"culled sharded x4: launches {ls}")
            if not np.array_equal(sharded, sdf):
                raise RuntimeError("culled sharded x4: differs from the one-card result")
            row["sharded_stages_s"] = dict(sc.LAST_STAGE_SECONDS)
        dense, row["dense_wall_s"] = run(f"dense/{name}", method="dense")
        dist_err = float(np.abs(np.abs(sdf) - np.abs(dense)).max())
        flips = np.nonzero(np.sign(sdf) != np.sign(dense))[0]
        row.update(max_abs_dist_err=dist_err, sign_disagreements=len(flips),
                   sign_disagreement_abs_d=sorted(np.abs(dense[flips]).tolist())[-20:])
        print(f"culled {name} ({len(mesh.faces)} faces) at 256^3: wall {wall:.3f} s (dense "
              f"{row['dense_wall_s']:.3f} s{', sharded x4 %.3f s' % row['sharded_wall_s'] if 'sharded_wall_s' in row else ''}), "
              f"stages (s) {stages}, sum_kd {counts['sum_kd']} ({row['kd_share']:.4f} of the dense "
              f"pairs), sum_kw {counts['sum_kw']} ({row['kw_share']:.4f}), coarse bound "
              f"{counts['coarse_bound']}; max | |d| - |d dense| | {dist_err:.3e} (tolerance 1e-6); "
              f"sign disagreements {len(flips)}, their |d| {row['sign_disagreement_abs_d']}",
              flush=True)
        if dist_err > 1e-6:
            raise RuntimeError(f"culled/{name}: distances differ from the dense method's")
        if len(flips) and np.abs(dense[flips]).max() > 1e-2:
            raise RuntimeError(f"culled/{name}: a sign differs at a point far from the surface")
        out[name] = row
    report["culled"] = out
    return launches


def drive_sharded(device, run_root, model, report):
    """Phase 4e: the sharded evaluators and data-parallel training, the card
    listed several times, counts zeroed before each run and read after it.
    Returns (launches per run, what phase 5 times)."""
    from sdf_representation_tpu_torch import cli
    from sdf_representation_tpu_torch.configgen import Configuration
    from sdf_representation_tpu_torch.geometry.mesh_io import load_mesh
    from sdf_representation_tpu_torch.losses.losses import IGRLOSS
    from sdf_representation_tpu_torch.ops import fused_igr as fi
    from sdf_representation_tpu_torch.ops import fused_mlp as fm
    from sdf_representation_tpu_torch.ops import sdf_streams as ss
    from sdf_representation_tpu_torch.ops import sharded_eval as se
    from sdf_representation_tpu_torch.ops import sparse_grid as sg
    from sdf_representation_tpu_torch.parallel.mesh import gather
    from sdf_representation_tpu_torch.training import PointCloudTrainer, Trainer
    from sdf_representation_tpu_torch.training import trainer as trainer_module

    launches, out = {}, {}
    root = run_root / "pipeline"

    @contextlib.contextmanager
    def window(tag):
        torch.cuda.synchronize()
        for counters in (fm, ss, fi):
            counters.reset_launches()
        with counting_plain_calls((fm, ss, fi)) as plain:
            yield
            torch.cuda.synchronize()
        launches[tag] = {**fm.LAUNCHES, **ss.LAUNCHES, **fi.LAUNCHES}
        if any(plain.values()):
            raise RuntimeError(f"{tag}: a plain version ran on the card's path: {plain}")

    def only(tag, **expected):
        want = {name: expected.get(name, 0) for name in launches[tag]}
        if launches[tag] != want:
            raise RuntimeError(f"{tag}: launches {launches[tag]}, expected {want}")

    trained = Trainer(Configuration(str(root / "train_float32.ini")))
    trained.load_model()
    nets = {"seeded": model, "trained": trained.model}

    # the trained net of phase 4b: the blocks entry equals the dense grid
    # entry bit for bit on its active blocks (phase 3 checks the seeded net)
    _, mask, _ = sg.coarse_and_certificate(trained.model, 256, 8, 1.5, 0.01)
    t_ids = torch.nonzero(mask).flatten().to(torch.int32)
    t_count = torch.tensor([t_ids.numel()], dtype=torch.int32, device=device)
    for dt in (torch.bfloat16, torch.float32):
        net = fm.FusedNet(trained.model, dt)
        blocks = fm.fused_blocks(net, t_ids, t_count, 256, 8)
        dense = fm.fused_grid(net, 256).reshape(32, 8, 32, 8, 32, 8).permute(0, 2, 4, 1, 3, 5)
        same = torch.equal(blocks, dense.reshape(-1, 512)[t_ids.long()])
        print(f"check sparse_blocks/trained/{str(dt).split('.')[1]}: bitwise equal to fused_grid on "
              f"{t_ids.numel()} active blocks: {same}", flush=True)
        if not same:
            raise RuntimeError(f"trained net: sparse blocks differ from the dense grid kernel ({dt})")

    # -- kernel 10: the dense grid, a slab of tiles per shard -----------------
    out["sharded_grid"] = {}
    for dt in (torch.bfloat16, torch.float32):
        tag = str(dt).split(".")[1]
        one = fm.fused_grid_eval(model, 256, compute_dtype=dt)
        for k in (1, 2, 4):
            with window(f"sharded_grid/{tag}/x{k}"):
                vol = se.sharded_grid_eval(model, 256, (device,) * k, compute_dtype=dt)
            only(f"sharded_grid/{tag}/x{k}", sharded_grid=k)
            same = torch.equal(vol, one)
            print(f"check sharded_grid/{tag}/x{k} n256: bit-equal to one fused_grid launch: {same}",
                  flush=True)
            if not same:
                raise RuntimeError(f"sharded_grid/{tag}/x{k}: differs from one fused_grid launch")
        # n = 255: 255^3 is no multiple of 4 x 1024, the padded tail is dropped
        vol = se.sharded_grid_eval(model, 255, (device,) * 4, compute_dtype=dt)
        want = se.sharded_grid_eval_plain(model, 255, (device,) * 4, compute_dtype=dt)
        torch.cuda.synchronize()
        diff = (vol - want).abs()
        err, mean = diff.max().item(), diff.mean().item()
        row = {"n255_max_abs_err": err, "n255_mean_abs_err": mean}
        if dt == torch.float32:
            held, limit, mean_limit = err, F32_TOL, math.inf
            print(f"check sharded_grid/{tag}/x4 n255 against plain: max_abs_err {err:.3e} (tolerance "
                  f"{limit:g})", flush=True)
        else:
            # the max against the kernel's own summation order (see BF16_TOL)
            order = plain_kernel_order(fm.FusedNet(model, dt), fm.grid_points(255, 0, 255 ** 3, device))
            held = (vol.reshape(-1) - order).abs().max().item()
            limit, mean_limit = BF16_TOL, BF16_MEAN_TOL
            row["n255_max_abs_err_kernel_order"] = held
            print(f"check sharded_grid/{tag}/x4 n255: against plain (exact sums) mean_abs_err "
                  f"{mean:.3e} (tolerance {mean_limit:g}), max_abs_err {err:.3e}; against the "
                  f"kernel's summation order max_abs_err {held:.3e} (tolerance {limit:g})", flush=True)
            del order
        if not (torch.isfinite(vol).all() and vol.shape == (255,) * 3 and held <= limit
                and mean <= mean_limit):
            raise RuntimeError(f"sharded_grid/{tag}/n255: kernel and plain version disagree")
        out["sharded_grid"][tag] = row
    del one, vol, want, diff

    # -- kernel 11: the sparse evaluator, a slice of the active list per shard --
    out["sparse_sharded"] = {}
    for name, net_model in nets.items():
        single, count1 = sg.sparse_grid_eval(net_model, 256, return_count=True)
        dense = fm.fused_grid_eval(net_model, 256).reshape(32, 8, 32, 8, 32, 8).permute(0, 2, 4, 1, 3, 5)
        for k in (2, 4):
            tag = f"sparse_sharded/{name}/x{k}"
            with window(tag):
                vol, count = se.sparse_sharded_grid_eval(net_model, 256, (device,) * k,
                                                         return_count=True)
            coarse = gather(se.coarse_slices(net_model, 256, 8, (device,) * k), device)
            mask = coarse.abs() <= sg.adaptive_threshold(coarse, 256, 8, 1.5, 0.01)
            coarse1, mask1, _ = sg.coarse_and_certificate(net_model, 256, 8, 1.5, 0.01)
            k_max = se._KMAX_CACHE_SHARDED[(net_model.arch, 256, 8, 2, 1.5, 0.01,
                                            str(torch.bfloat16), k)]
            k_loc = k_max // k
            per_shard = [min(max(count - d * k_loc, 0), k_loc) for d in range(k)]
            got = vol.reshape(32, 8, 32, 8, 32, 8).permute(0, 2, 4, 1, 3, 5)
            active = mask.reshape(32, 32, 32)
            bit_equal = torch.equal(got[active], dense[active])
            row = {"count": count, "single_device_count": count1, "k_max": k_max,
                   "active_per_shard": per_shard,
                   "voxels_differing_from_single_device": int((vol != single).sum()),
                   "coarse_centres_differing": int((coarse != coarse1).sum()),
                   "blocks_flipped": int((mask != mask1).sum()),
                   "launches": launches[tag]["sparse_sharded_blocks"]}
            print(f"check {tag} n256: {row}, active blocks bit-equal to the dense grid kernel: "
                  f"{bit_equal}", flush=True)
            # one launch per shard and pass (a pass is repeated when the budget overflows)
            passes = launches[tag]["sparse_sharded_blocks"] // k
            only(tag, sparse_sharded_blocks=k * max(passes, 1))
            if not (bit_equal and count == count1 == int(mask.sum())):
                raise RuntimeError(f"{tag}: count or active blocks differ")
            out["sparse_sharded"][f"{name}/x{k}"] = row
        del dense, single
    # the budget overflows at k_max_frac 0.01 and the pass is retried
    se._KMAX_CACHE_SHARDED.clear()
    tag = "sparse_sharded/seeded/x4/retry"
    with window(tag):
        vol, count = se.sparse_sharded_grid_eval(model, 256, (device,) * 4, k_max_frac=0.01,
                                                 return_count=True)
    first = -(-max(8, int(32 ** 3 * 0.01)) // 8) * 8
    (settled,) = se._KMAX_CACHE_SHARDED.values()
    print(f"check {tag}: first budget {first} blocks, count {count}, settled budget {settled}, "
          f"launches {launches[tag]['sparse_sharded_blocks']} (4 per pass)", flush=True)
    if not (first < count <= settled and launches[tag]["sparse_sharded_blocks"] == 8):
        raise RuntimeError(f"{tag}: the budget did not overflow once and settle")
    out["sparse_sharded"]["retry"] = {"first_k_max": first, "count": count, "settled_k_max": settled}
    # the kernel against its plain version, shard by shard, at the path's ids
    se._KMAX_CACHE_SHARDED.clear()
    se.sparse_sharded_grid_eval(model, 256, (device,) * 4)
    coarse = gather(se.coarse_slices(model, 256, 8, (device,) * 4), device)
    mask = coarse.abs() <= sg.adaptive_threshold(coarse, 256, 8, 1.5, 0.01)
    (k_max,) = se._KMAX_CACHE_SHARDED.values()
    ids, count = sg.first_active(mask, k_max)
    shards = [se.active_slice(ids, count, d, 4) for d in range(4)]
    out["sparse_sharded"]["seeded/x4/k_max"] = k_max
    errors = {}
    for dt in (torch.bfloat16, torch.float32):
        net = fm.FusedNet(model, dt)
        got = torch.cat([fm.fused_blocks(net, i, c, 256, 8, counter="sparse_sharded_blocks")
                         for i, c in shards])[: int(count)]
        want = torch.cat([fm.fused_blocks_plain(net, i, c, 256, 8) for i, c in shards])[: int(count)]
        torch.cuda.synchronize()
        diff = (got - want).abs()
        err, mean = diff.max().item(), diff.mean().item()
        limit, mean_limit = (F32_TOL, math.inf) if dt == torch.float32 else (BF16_TOL, BF16_MEAN_TOL)
        tag = str(dt).split(".")[1]
        print(f"check sparse_sharded_blocks/{tag}/x4 n256 against plain: max_abs_err {err:.3e} "
              f"(tolerance {limit:g}), mean_abs_err {mean:.3e} (tolerance {mean_limit:g})", flush=True)
        if not (torch.isfinite(got).all() and err <= limit and mean <= mean_limit):
            raise RuntimeError(f"sparse_sharded_blocks/{tag}: kernel and plain version disagree")
        errors[dt] = err

    # -- data-parallel training through the trainers the CLI builds -------------
    data_root = root / "float32" / "r_sphere"
    n_rows = sum(report["pipeline"]["sampling"]["rows"].values())
    n_train = n_rows - math.ceil(0.1 * n_rows)
    out["data_parallel"] = {}
    for tag, cfg_name, cls, k, epochs in (
            ("dp_igr_train/bfloat16/x2", "igr_bfloat16.ini", Trainer, 2, 2),
            ("dp_pcd_train/bfloat16/x4", "pcd_bfloat16.ini", PointCloudTrainer, 4, PCD_EPOCHS)):
        work = root / tag.split("/")[0]
        shutil.rmtree(work, ignore_errors=True)
        if cls is Trainer:
            shutil.copytree(data_root, work / data_root.name,
                            ignore=shutil.ignore_patterns("ImplicitNet*"))
        text = with_keys((root / cfg_name).read_text(), directory=f"{work}/", epochs=epochs,
                         min_epochs=epochs)
        path = root / f"{tag.split('/')[0]}.ini"
        path.write_text(text)
        trainer = cls(Configuration(str(path)), mesh=(device,) * k)
        with window(tag):
            result = trainer.train()
        steps = ((n_train if cls is Trainer else PCD_POINTS) // 16384) * epochs
        only(tag, igr_fwd=k * steps, igr_bwd=k * steps)
        curve = result["train_losses"] if cls is Trainer else result["losses"]
        stats = dict(trainer_module.LAST_RUN)
        print(f"{tag}: {steps} steps, launches per step {launches[tag]['igr_fwd'] / steps:g} igr_fwd, "
              f"{launches[tag]['igr_bwd'] / steps:g} igr_bwd, {stats}, train loss "
              + " ".join(f"{v:.3e}" for v in curve), flush=True)
        if not (len(curve) == epochs and np.isfinite(curve).all() and curve[-1] < curve[0]):
            raise RuntimeError(f"{tag}: the loss did not fall: {curve}")
        out["data_parallel"][tag] = {**stats, "steps": steps, "train_loss": list(curve)}
    # mesh the data-parallel point-cloud field through the entry point
    rec = root / "dp_pcd_reconstruct.ini"
    rec.write_text(with_keys(text, distributed=False, ppo=True, reconstruct=True, cubesize=128))
    with window("dp_pcd_reconstruct/128"):
        if cli.main([str(rec)]) != 0:
            raise RuntimeError("dp_pcd_reconstruct: the entry point failed")
    only("dp_pcd_reconstruct/128", fused_grid=1)
    mesh = load_mesh(str(pathlib.Path(trainer.postprocess_save_path)
                         / f"reconstructed_epoch{PCD_EPOCHS - 1}.stl"))
    radius = float(np.median(np.linalg.norm(mesh.vertices, axis=1)))
    print(f"mesh from the data-parallel point-cloud field, 128^3: {len(mesh.faces)} faces, median "
          f"vertex radius {radius:.4f} (the cloud's sphere: 0.85, tolerance 1%)", flush=True)
    if len(mesh.faces) < 100 or abs(radius - 0.85) > 0.0085:
        raise RuntimeError("dp_pcd_reconstruct: the mesh does not sit on the cloud")
    out["data_parallel"]["pcd_reconstruct_128"] = {"faces": len(mesh.faces), "median_radius": radius}

    # one f32 step of the sharded fused op against the single-device one
    gen = torch.Generator().manual_seed(SEED)
    x = (torch.rand(16384, 3, generator=gen) * 2 - 1).to(device)
    r = x.norm(dim=1, keepdim=True)
    y = torch.cat([r - 0.85, x / r], dim=1)
    loss = IGRLOSS()

    def grads_with(vag):
        model.zero_grad(set_to_none=True)
        fn = lambda z: model(z)  # noqa: E731
        fn._implicitnet_fast = vag
        value = loss(fn, x, y, 0)
        value.backward()
        grads = [p.grad.clone() for p in model.parameters()]
        model.zero_grad(set_to_none=True)
        return value.item(), grads

    l1, g1 = grads_with(fi.make_fused_value_and_grad(model, torch.float32))
    for k in (2, 4):
        fi.reset_launches()
        lk, gk = grads_with(fi.make_fused_value_and_grad_sharded(model, (device,) * k, torch.float32))
        over = max((u - v).abs().sub(2e-5 + 2e-4 * v.abs()).max().item() for u, v in zip(gk, g1))
        worst = max((u - v).abs().max().item() for u, v in zip(gk, g1))
        print(f"check sharded igr grads f32 x{k}: loss {lk:.7e} vs {l1:.7e}, max |diff| {worst:.3e}, "
              f"worst excess over rtol 2e-4 / atol 2e-5 {over:.3e}, launches {fi.LAUNCHES}", flush=True)
        if over > 0 or abs(lk - l1) > 1e-5 * abs(l1) or fi.LAUNCHES != {"igr_fwd": k, "igr_bwd": k}:
            raise RuntimeError(f"sharded igr x{k}: gradients differ from the single-device op")
        out.setdefault("sharded_igr_f32", {})[f"x{k}"] = {"max_abs_grad_diff": worst,
                                                          "loss": lk, "single_loss": l1}
    report["sharded_eval"] = out
    return launches, {"ids": ids, "count": count, "errors": errors, "xy": (x, y)}


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
    that skipped them would compute (the control of the bf16 checks), in
    the plain version's arithmetic (bf16: f64 sums). Also returns, per
    point, the least |z| over all hidden units (padding apart)."""
    from sdf_representation_tpu_torch.ops import fused_igr as fi
    from sdf_representation_tpu_torch.ops import fused_mlp as fm

    work, rounded, layers = fi._plain_arith(net)

    def rnd(t, point):
        return t if point in drop else rounded(t)

    beta = net.beta
    x = rnd(x.to(work), "x")
    h, stash = x, []
    margin = torch.full(x.shape[:1], math.inf, dtype=work, device=x.device)
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
    return f[:, 0].float(), dx.float(), margin.float()


def igr_bwd_dropping(net, x, a, c, drop):
    """fused_igr.fused_param_grads_plain with the rounding points named in
    ``drop`` ("x", "stash", "cotangent", "head") left out, in the plain
    version's arithmetic."""
    from sdf_representation_tpu_torch.ops import fused_igr as fi
    from sdf_representation_tpu_torch.ops import fused_mlp as fm

    work, rounded, layers = fi._plain_arith(net)

    def rnd(t, point):
        return t if point in drop else rounded(t)

    beta = net.beta
    n_lin = len(layers)
    x, c, a = rnd(x.to(work), "x"), rnd(c.to(work), "x"), a.to(work)
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
        g_h = None if w_h is None else ((h_prev.T @ dz_c + tc_prev.T @ dtcz_c) * scale).float()
        g_x = None if w_x is None else ((x.T @ dz_c + c.T @ dtcz_c) * scale).float()
        grads[layer] = (g_h, g_x, dz.sum(dim=0).float())
        if layer > 0:
            dh, dtc = (dz_c @ w_h.T) * scale, (dtcz_c @ w_h.T) * scale
            if beta > 0:
                sg = 1.0 - torch.exp(-beta * h_prev)
                dz = dh * sg + (dtc * tc_prev) * (beta * (1.0 - sg))
            else:
                sg = (h_prev > 0).to(work)
                dz = dh * sg
            dtcz = dtc * sg
    return grads


def check_igr_passes(net, x, a, c, tag, readings):
    """The bf16 backward's two passes on their own: the first pass's
    workspace against fused_igr.images_plain (bf16 images, equal but where
    a sum in another order rounds to the neighbouring value, which later
    layers carry on: the mean difference within 1e-2 of the mean value, where
    a misplaced row or column reads ~1; per-tile db sums within 1e-3 of the
    largest on average), and the dW pass on that plain workspace against
    fused_igr.dw_pass_plain (bf16 products, exact sums: within 1e-5 of each
    buffer's largest entry)."""
    from sdf_representation_tpu_torch.ops import fused_igr as fi

    _, _, (found_ws, found_partial) = fi._bwd_bf16(net, x, a, c)
    ws, partial = fi.images_plain(net, x, a, c)
    torch.cuda.synchronize()
    equal = (found_ws == ws).float().mean().item()
    ws_mean = ((found_ws.float() - ws.float()).abs().mean() / ws.float().abs().mean()).item()
    db_mean = ((found_partial - partial).abs().mean() / partial.abs().max()).item()
    gw, gb = fi.dw_pass(net, ws, partial)
    pw, pb = fi.dw_pass_plain(net, ws, partial)
    dw = max(((gw - pw).abs().max() / pw.abs().max()).item(), ((gb - pb).abs().max() / pb.abs().max()).item())
    readings[f"{tag}/passes"] = {"workspace_equal": equal, "workspace_mean_rel": ws_mean,
                                 "db_partials_mean_rel": db_mean, "dw_pass_max_rel": dw}
    print(f"check igr_bwd/{tag} passes: workspace {equal:.5f} equal to images_plain (mean rel "
          f"{ws_mean:.3e}), db partials mean {db_mean:.3e}; dW pass on it max rel {dw:.3e}", flush=True)
    if not (ws_mean <= 1e-2 and db_mean <= 1e-3 and dw <= 1e-5):
        raise RuntimeError(f"igr_bwd/{tag}: a pass of the backward disagrees with its plain version")


def kernels_per_call(fn):
    """{kernel: launches} of csrc/fused_igr.cu's kernels in one call of fn,
    read from torch.profiler's device events (fn has run before: built,
    warmed, its plan on the card)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    found = {}
    for event in prof.events():
        m = re.search(r"igr_(fwd|bwd|dw)_kernel", event.name)
        if m and event.device_type == torch.autograd.DeviceType.CUDA:
            found[m.group(0)] = found.get(m.group(0), 0) + 1
    return found


def check_igr(device, gen, report):
    """Phase 3, igr_fwd and igr_bwd against their plain versions: f, grad f,
    every dW and db, in f32 and bf16, with the bf16 controls. Returns what
    phase 5 times and the errors at those shapes:
    ({case: (model, x, a, c)}, {(kernel, case, type): max_abs_err})."""
    from sdf_representation_tpu_torch.models import ImplicitNet
    from sdf_representation_tpu_torch.ops import fused_igr as fi
    from sdf_representation_tpu_torch.ops import fused_mlp as fm

    # case: (width, depth, beta, N, points kept clear of the step's flips,
    # the working types in which a step may flip); the skip input at depth / 2
    both, none = (torch.float32, torch.bfloat16), ()
    cases = {"8x512/n16384": (512, 8, 100.0, 16384, False, none),
             "8x256/n5461": (256, 8, 100.0, 5461, False, none),
             "8x256/n16384": (256, 8, 100.0, 16384, False, none),
             "8x512/n4999": (512, 8, 100.0, 4999, False, none),
             "8x512/n16384/relu": (512, 8, 0.0, 16384, False, both),
             "8x512/n4096/relu_clear": (512, 8, 0.0, 4096, True, (torch.bfloat16,)),
             "4x512/n4096/relu_clear": (512, 4, 0.0, 4096, True, none)}
    timed_cases, errors, controls, readings = {}, {}, {}, {}
    for case, (width, depth, beta, n, clear, flip_types) in cases.items():
        model = ImplicitNet(hidden_dims=(width,) * depth, skip_in=(depth // 2,), beta=beta,
                            radius_init=0.5, generator=gen, device=device)
        x = (torch.rand(IGR_RELU_CANDIDATES if clear else n, 3, generator=gen) * 2 - 1).to(device)
        # cotangents of a mean over the batch: a = dL/df, c = dL/d(grad f)
        a = (torch.randn(n, generator=gen) / n).to(device)
        c = (torch.randn(n, 3, generator=gen) / n).to(device)
        shapes = [w.shape for w, _ in model.effective_layers()]
        if case in ("8x512/n16384", "8x256/n5461"):
            timed_cases[case] = (model, x, a, c)
        candidates = x
        for dt in (torch.float32, torch.bfloat16):
            tag = f"{case}/{str(dt).split('.')[1]}"
            bf16 = dt == torch.bfloat16
            flips = dt in flip_types
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
            if case == "8x512/n16384":
                # one input, two launches: bf16 sums in a fixed order and must
                # agree bit for bit; f32 adds by atomics, whose order changes
                again = fi.unpack_grads(3, shapes, fi.fused_param_grads(net, x, a, c))
                same = all(torch.equal(u, v) for u, v in zip(again, got))
                print(f"check igr_bwd/{tag}: two launches bit-equal {same}, differ by at most "
                      f"{gradient_errors(again, got)[1]:.3e} of a tensor's largest entry", flush=True)
                readings[f"{tag}/two_launches_bit_equal"] = same
                if bf16 and not same:
                    raise RuntimeError(f"igr_bwd/{tag}: two launches give different gradients")
                if bf16:
                    check_igr_passes(net, x, a, c, tag, readings)
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
            if not bf16 or case not in ("8x512/n16384", "8x256/n5461", "8x512/n4096/relu_clear",
                                        "4x512/n4096/relu_clear"):
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
                # where steps may flip, the gradients are held for gross errors
                # only, which the cotangent and head controls do not reach: read, not gated
                gated = not flips or drop in ("x", "stash")
                controls[f"igr_bwd/{tag}/without_{drop}"] = {"mean": c_mean, "worst": c_worst, "gated": gated}
                print(f"control igr_bwd/{tag}/without_{drop}: sum|diff|/sum|plain| {c_mean:.3e}, "
                      f"worst {c_worst:.3e}" + ("" if gated else " (not gated)"), flush=True)
                if flips:
                    passes = c_mean <= IGR_RELU_GRAD_MEAN_TOL
                else:
                    passes = c_mean <= IGR_GRAD_MEAN_TOL and c_worst <= worst_tol
                if gated and passes:
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
    from sdf_representation_tpu_torch.ops import sdf_culled
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
        sdf_culled.LAST_COUNTS.clear()
        wall = run(tag, config(f"audit_{cubesize}", ppo=True, cubesize=cubesize))
        need(tag, "dist_stream", "wind_stream", "fused_grid")
        # 256^3 x 20,480 faces goes to the culled method by "auto", 64^3 stays dense
        culled = dict(sdf_culled.LAST_COUNTS)
        if bool(culled) != (cubesize == 256) or (culled and culled["points"] != cubesize ** 3):
            raise RuntimeError(f"{tag}: the culled method ran where it should not, or not: {culled}")
        if culled:
            culled.update(stages_s=dict(sdf_culled.LAST_STAGE_SECONDS),
                          kd_share=culled["sum_kd"] / (culled["blocks"] * culled["dist_chunks"]),
                          kw_share=culled["sum_kw"] / (culled["blocks"] * culled["chunks"]))
            print(f"audit {cubesize}^3 exact distances by the culled method: stages (s) "
                  f"{culled['stages_s']}, sum_kd {culled['sum_kd']} ({culled['kd_share']:.4f} of "
                  f"the dense pairs), sum_kw {culled['sum_kw']} ({culled['kw_share']:.4f})",
                  flush=True)
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
        if cubesize == 256 and result["Accuracy"] < 0.999:
            raise RuntimeError(f"audit 256: sign accuracy {result['Accuracy']} under 0.999")
        for name in ("mismatching_co-ordinates1.csv", "classification_report2.csv"):
            if not (post / name).exists():
                raise RuntimeError(f"audit {cubesize}: {name} is missing")
        out["audit"][cubesize] = {"wall_s": wall, "stages_s": stages, "result": result,
                                  "baseline": baseline, "culled": culled}
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
    from sdf_representation_tpu_torch.training import PointCloudTrainer, Trainer
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
    # fused_mlp: points, grid, blocks x widths 128-512; fused_igr (namespace
    # tc): igr_fwd and igr_bwd x widths x softplus / ReLU, and igr_dw
    report["sass"] = {**check_sass(kernels.library_path("fused_mlp"), "wgmma_", 12),
                      **check_sass(kernels.library_path("fused_igr"), r"2tc\d+igr_", 17)}

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
    (stream_P, (stream_sb, stream_sc), stream_tables, tri_chunk, stream_errors, stream_mesh,
     stream_pts) = check_streams(device, report)
    checks.update(stream_errors)
    shard_P, shard_dist, shard_wind, shard_tables, shard_tc, shard_errors = check_sharded(
        device, stream_mesh, stream_pts, report)
    checks.update(shard_errors)
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
    runs.update(drive_culled(device, report))
    sharded_runs, shard_eval = drive_sharded(device, run_root, model, report)
    runs.update(sharded_runs)

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
        # the same kernel on phase 3's culled schedule (what the culled method runs)
        sched = shard_dist if name == "dist_stream" else shard_wind
        c_pairs = int(np.sum(sched[0] < shard_P.shape[0])) * shard_P.shape[1] * shard_tc
        c_ms = timed(lambda: (ss.dist_stream if name == "dist_stream" else ss.wind_stream)(
            shard_P, *sched, shard_tables, shard_tc))
        entry["culled_schedule"] = {"ms": c_ms, "pairs": c_pairs,
                                    "bound_ms": c_pairs * ops / PEAK[torch.float32] * 1e3}
        print(f"time {name}: " + json.dumps(entry), flush=True)
        if entry["launches"] < 1:
            raise RuntimeError(f"{name} was launched on no run of the main path")
        kernels_line.append(entry)
    # kernels 6 and 7: the sharded streams on phase 3's culled schedule, the
    # card listed 4 (and 2) times; the bound counts the schedule's pairs
    n_blocks, m_pts, _ = shard_P.shape
    n_chunks = shard_tables["a"].shape[0]
    for name, replaces, ops, rows, out_bytes, sched, sharded, plain in (
        ("dist_stream_sharded",
         "sdf_representation_tpu/ops/pallas_streams.py:564 dist_stream_pallas_sharded",
         DIST_OPS_PER_PAIR, 16, 8, shard_dist, ss.dist_stream_sharded, ss.dist_stream_sharded_plain),
        ("wind_stream_sharded",
         "sdf_representation_tpu/ops/pallas_streams.py:646 wind_stream_pallas_sharded",
         WIND_OPS_PER_PAIR, 24, 4, shard_wind, ss.wind_stream_sharded, ss.wind_stream_sharded_plain),
    ):
        steps = int(np.sum(sched[0] < n_blocks))
        pairs = steps * m_pts * shard_tc
        bytes_ = (shard_P.numel() * 4 + n_chunks * shard_tc * rows * 4 + 4 * (n_blocks + 1 + steps)
                  + n_blocks * m_pts * out_bytes)
        t_bytes, t_ops = bytes_ / MEM_BW * 1e3, pairs * ops / PEAK[torch.float32] * 1e3
        args = (shard_P, *sched, shard_tables, shard_tc)
        ms = timed(lambda: sharded(*args, (device,) * 4))
        ms2 = timed(lambda: sharded(*args, (device,) * 2))
        plain_ms = timed(lambda: plain(*args, (device,) * 4), 1)
        by_run = {tag: counts[name] for tag, counts in runs.items() if counts[name]}
        entry = {"name": name, "route": "cuda",
                 "source": "sdf_representation_tpu_torch/csrc/sdf_streams.cu", "replaces": replaces,
                 "launches": sum(by_run.values()), "launches_by_run": by_run, "dtype": "float32",
                 "max_abs_err": checks[name], "ms": ms, "plain_ms": plain_ms,
                 "bound_ms": max(t_bytes, t_ops),
                 "bound_by": "operations" if t_ops >= t_bytes else "bytes", "library_ms": None,
                 "shards": 4, "ms_2_shards": ms2, "pairs": pairs, "ops_per_pair": ops,
                 "pairs_per_s": pairs / ms * 1e3}
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
                bf16 = dt == torch.bfloat16
                wbuf, bbuf, _ = net.packed
                # what the function must move: the weights and biases once in
                # the working type, the inputs, the outputs. The kernel's own
                # traffic (its workspace, written and read back, and the staged
                # or transposed weight copies) is reported beside the bound, not in it.
                w_bytes = wbuf.numel() * wbuf.element_size() + bbuf.numel() * bbuf.element_size()
                extra = {}
                if name == "igr_fwd":
                    # one pass forward, one transposed pass back (2 per layer)
                    ops = 2.0 * n * 2 * macs
                    bytes_ = n * d * 4 + w_bytes + n * (1 + d) * 4
                    run = lambda: fi.fused_value_and_grad(net, x)
                    plain = lambda: fi.fused_value_and_grad_plain(net, x)
                    lib = lambda: library_vag(net_model, x, a, c, dt, False)
                    expect = {"igr_fwd_kernel": 1}
                else:
                    # two chains forward, two back (no W^T pass below the first
                    # layer), two into dW (~6 per layer); out: f32 dW and db
                    ops = 2.0 * n * (2 * macs + 2 * (macs - mac0) + 2 * macs)
                    bytes_ = n * (2 * d + 1) * 4 + w_bytes + (wbuf.numel() + bbuf.numel()) * 4
                    run = lambda: fi.fused_param_grads(net, x, a, c)
                    plain = lambda: fi.fused_param_grads_plain(net, x, a, c)
                    lib = lambda: library_vag(net_model, x, a, c, dt, True)
                    # bf16: igr_bwd, then the dW pass (igr_dw) from the same call
                    expect = {"igr_bwd_kernel": 1, "igr_dw_kernel": 1} if bf16 else {"igr_bwd_kernel": 1}
                    if bf16:  # the dW pass alone, on this input's workspace
                        ws, part = fi.images_plain(net, x, a, c)
                        extra["dw_pass_ms"] = timed(lambda: fi.dw_pass(net, ws, part), 5)
                        del ws, part
                t_bytes, t_ops = bytes_ / MEM_BW * 1e3, ops / PEAK[dt] * 1e3
                ms = timed(run, 5)
                workspace = fi.WORKSPACE_BYTES[name]  # what the timed calls allocated
                launched = kernels_per_call(run)
                if launched != expect:
                    raise RuntimeError(f"{name}/{case}: one call ran {launched} on the card, not {expect}")
                plain_ms, lib_ms = timed(plain, 2), timed(lib, 3)
                numbers = {"max_abs_err": igr_errors[name, case, dt], "ms": ms, "plain_ms": plain_ms,
                           "bound_ms": max(t_bytes, t_ops),
                           "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                           "library_ms": lib_ms, "points": n, "bound_bytes": bytes_,
                           "workspace_bytes": workspace,
                           "kernel_launches_per_call": sum(launched.values()), "kernels_per_call": launched,
                           "tflops": ops / ms / 1e9, "points_per_s": n / ms * 1e3, **extra}
                tag = str(dt).split(".")[1]
                print(f"time {name}/{case}/{tag}: " + json.dumps(numbers), flush=True)
                if case == "8x512/n16384" and dt == torch.bfloat16:
                    entry.update(numbers, dtype="bfloat16", shape=case)
                else:
                    entry[f"{case}/{tag}"] = numbers
        if entry["launches"] < 1:
            raise RuntimeError(f"{name} was launched on no run of the main path")
        kernels_line.append(entry)
    # kernels 10 and 11: the grid and blocks entries once per shard at the
    # main path's shapes (256^3; the seeded net's active list at 256), the
    # card listed 1, 2 and 4 times ("ms" is x4); bound, plain and library as
    # for kernels 1 and 3 over the same points
    from sdf_representation_tpu_torch.ops import sharded_eval as se

    ids, count = shard_eval["ids"], shard_eval["count"]
    live = int(count)
    for name, replaces in (
        ("sharded_grid", "sdf_representation_tpu/ops/sharded_eval.py:34 _local_sweep_pallas"),
        ("sparse_sharded_blocks", "sdf_representation_tpu/ops/sharded_eval.py:201 _sparse_sharded_device"),
    ):
        by_run = {tag: counts[name] for tag, counts in runs.items() if counts[name]}
        entry = {"name": name, "route": "cuda", "source": "sdf_representation_tpu_torch/csrc/fused_mlp.cu",
                 "replaces": replaces, "launches": sum(by_run.values()), "launches_by_run": by_run}
        for dt in (torch.bfloat16, torch.float32):
            net = nets[dt]
            tag = str(dt).split(".")[1]
            if name == "sharded_grid":
                npts, x, in_bytes = 256 ** 3, grid_pts[256], 0
                err = report["sharded_eval"]["sharded_grid"][tag]["n255_max_abs_err"]

                def shards_run(k, net=net):
                    local = se.slab_tiles(256, k, 1024)
                    return lambda: [fm.fused_grid_tiles(net, 256, d * local, local) for d in range(k)]

                local4 = se.slab_tiles(256, 4, 1024)
                plain = lambda: [fm.fused_grid_tiles_plain(net, 256, d * local4, local4) for d in range(4)]
            else:
                npts, x, in_bytes = live * 512, fm.block_points(ids[:live], 256, 8), ids.numel() * 4 + 4
                err = shard_eval["errors"][dt]

                def shards_run(k, net=net):
                    parts = [se.active_slice(ids, count, d, k) for d in range(k)]
                    return lambda: [fm.fused_blocks(net, i, c, 256, 8, counter="sparse_sharded_blocks")
                                    for i, c in parts]

                parts4 = [se.active_slice(ids, count, d, 4) for d in range(4)]
                plain = lambda: [fm.fused_blocks_plain(net, i, c, 256, 8) for i, c in parts4]
            w_bytes = sum(w.numel() * w.element_size() for w in net.weights)
            bytes_ = w_bytes + in_bytes + npts * 4
            flops = 2.0 * mac * npts
            t_bytes, t_ops = bytes_ / MEM_BW * 1e3, flops / PEAK[dt] * 1e3
            # a 256^3 sweep takes seconds: one timed launch per shard is enough
            reps = 1 if name == "sharded_grid" else 3
            ms_by = {k: timed(shards_run(k), reps) for k in (1, 2, 4)}
            plain_ms, lib_ms = timed(plain, 1), timed(lambda: library_chain(x, dt), 1)
            numbers = {"max_abs_err": err, "ms": ms_by[4], "plain_ms": plain_ms,
                       "bound_ms": max(t_bytes, t_ops),
                       "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                       "library_ms": lib_ms, "points": npts, "shards": 4,
                       "ms_by_shards": ms_by, "tflops": flops / ms_by[4] / 1e9}
            print(f"time {name}/{tag}: " + json.dumps(numbers), flush=True)
            if dt == torch.bfloat16:
                entry.update(numbers, dtype="bfloat16")
            else:
                entry["float32"] = numbers
        if entry["launches"] < 1:
            raise RuntimeError(f"{name} was launched on no run of the main path")
        kernels_line.append(entry)
    # the whole evaluators and the data-parallel eikonal step, x1 / x2 / x4
    from sdf_representation_tpu_torch.losses.losses import IGRLOSS
    from sdf_representation_tpu_torch.training.trainer import make_train_step

    eval_ms = {}
    for k in (1, 2, 4):
        mesh_k = (device,) * k
        eval_ms[f"sharded_grid_eval/x{k}"] = timed(lambda: se.sharded_grid_eval(model, 256, mesh_k), 1)
        if k > 1:
            eval_ms[f"sparse_sharded_grid_eval/x{k}"] = timed(
                lambda: se.sparse_sharded_grid_eval(model, 256, mesh_k))
    x, y = shard_eval["xy"]
    step_ms = {}
    for k in (1, 2, 4):
        step_model = ImplicitNet(hidden_dims=(512,) * 8, skip_in=(4,), beta=100.0, radius_init=0.5,
                                 generator=torch.Generator().manual_seed(SEED), device=device)
        opt = torch.optim.Adam(step_model.parameters(), lr=1e-4)
        step = make_train_step(step_model, IGRLOSS(), opt, "bfloat16",
                               mesh=None if k == 1 else (device,) * k)
        step_ms[f"igr_step_8x512_n16384_bfloat16/x{k}"] = timed(lambda: step(x, y, 0), 10)
    # the point-cloud step as PointCloudTrainer makes it (8x256, 16,384 cloud
    # points, 5,461 eikonal points), and the kernels' share of each step:
    # kernels 8 and 9 once per shard on its rows (bf16), no host work around
    cloud = torch.randn(PCD_POINTS, 3, generator=torch.Generator().manual_seed(SEED))
    cloud = (0.85 * cloud / cloud.norm(dim=1, keepdim=True))[:16384].to(device)
    pcd_cfg = Configuration(str(run_root / "pipeline" / "pcd_bfloat16.ini"))
    for k in (1, 2, 4):
        pcd = PointCloudTrainer(pcd_cfg, mesh=None if k == 1 else (device,) * k)
        pcd_step = pcd._make_step(torch.optim.Adam(pcd.model.parameters(), lr=1e-4), 16384)
        step_gen = torch.Generator(device=device).manual_seed(SEED)
        step_ms[f"pcd_step_8x256_n16384_bfloat16/x{k}"] = timed(lambda: pcd_step(cloud, step_gen), 10)
    for case, (net_model, xc, ac, cc) in igr_cases.items():
        net = fm.FusedNet(net_model, torch.bfloat16)
        for k in (1, 2, 4):
            parts = list(zip(*(torch.tensor_split(t, k) for t in (xc, ac, cc))))

            def kernels_per_shard(net=net, parts=parts):
                for xs, as_, cs in parts:
                    fi.fused_value_and_grad(net, xs)
                    fi.fused_param_grads(net, xs, as_, cs)

            step_ms[f"igr_kernels_per_shard_{case}_bfloat16/x{k}"] = timed(kernels_per_shard, 5)
    print(f"time (ms) sharded evaluators at 256^3 (bf16), the labelled IGRLOSS and point-cloud "
          f"steps, kernels 8-9 per shard: {json.dumps({**eval_ms, **step_ms})}", flush=True)
    report["sharded_times_ms"] = {**eval_ms, **step_ms}
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
