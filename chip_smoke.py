#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (sdf_representation_tpu_torch) on one card.

    python3 chip_smoke.py

Phases, none of which is allowed to fail quietly:

 1. Card name and power limit (nvidia-smi); TF32 off, checked.
 2. Build csrc/fused_mlp.cu, csrc/sdf_streams.cu and csrc/fused_igr.cu with
    nvcc for sm_90a, all at once, printing ptxas's report; then each bf16
    entry of fused_mlp.cu (the tensor-core routine, at widths 128-512: 12),
    each f32 one (the split-TF32 routine: 12, whose HGMMA must all take
    TF32 operands), each bf16 entry of fused_igr.cu (igr_fwd and igr_bwd
    at widths 128-512, softplus and ReLU, and the dW pass igr_dw: 17) and
    each f32 one (the same 17 on the split-TF32 routine, TF32 operands
    only) must issue HGMMA and use no local memory, and the two FP32
    stream kernels of sdf_streams.cu (dist_kernel,
    wind_kernel) no local memory (cuobjdump's SASS and resource usage,
    printed per entry, with the streams' CTA shape); ptxas may serialise
    the wgmma of no kernel (its report, C7514 / C7511).
 3. Kernels against their plain PyTorch versions on the flagship net
    (configs/mesh_sdf.ini: ImplicitNet 8x512, skip at layer 4, beta 100;
    geometric init, radius 0.5, seeded weights), in f32 and bf16: the points
    kernel on 1M random points, the dense grid kernel at n = 128, the
    sparse block kernel on the active blocks at n = 256 — which must also
    equal the dense grid kernel at n = 256 bit for bit — and a ReLU/tanh
    (beta = 0) points case. Controls: the plain bf16 forward with one
    rounding point left out must fail the bf16 limits on the same inputs;
    in f32 the split-TF32 emulation (the kernels' operand roundings, f64
    sums) is printed beside each kernel and must hold F32_TOL, and its
    one-pass form (a single TF32 pass) must fail it on the same inputs.
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
    versions with one rounding point left out must fail the bf16 limits; in
    f32 the split-TF32 emulation (fused_igr.fused_value_and_grad_tf32_model,
    fused_param_grads_tf32_model: the kernels' operand roundings, f64 sums)
    is printed beside each reading and must hold the same limits, and its
    one-pass form (a single TF32 pass) must fail them on the same inputs.
    igr_bwd sums in a fixed order in both types: two launches must give the
    same dW and db bit for bit; its two passes (the workspace of its first
    pass, and the dW pass over a workspace) are held against their plain
    versions.
 4. The main path, `python -m sdf_representation_tpu_torch cfg.ini`
    (reconstruct from a checkpoint), once per route, the launch counts
    zeroed just before each run and read just after: cubesize 256 must
    launch the sparse block kernel and nothing else (no dense fallback) and
    march on the card (ops/marching_device.py, packed wire: a "decode"
    stage), cubesize 128 the dense grid kernel and nothing else and march on
    the host. Checks per run: the STL exists, and the 99th percentile of |f|
    at its vertices under the plain f32 forward is under one voxel plus the
    measured bf16 error. The entry point's own stage times
    (reconstruct.LAST_STAGE_SECONDS) are printed.
 4b. The rest of the main path through the same entry point, at full width
    (8x512, batch 16384, configs/mesh_sdf.ini with only paths, epochs,
    min_epochs, checkpointing, the precision and the mode flags changed):
    samplingonly -> three labelled CSVs; training for 30 epochs in f32 (gated:
    the loss falls, and ends below the all-clipped plateau), in bfloat16_mxu
    and in the config's bfloat16 (both reported, not gated); the audit
    (ppo, no reconstruct) at cubesize 256 and 64, and at 256 again under
    --compute-dtype float32 (the split-TF32 kernels); reconstruction from
    the trained checkpoint at 256 and 128, and at 256 in float32. Launch
    counts are zeroed before each
    run and read after it: labelling and each audit must launch the
    distance and winding streams (the audit the dense grid kernel too), and
    no plain version may run. The 256^3 audit takes the culled method (by
    "auto": 1.7e7 points x 20,480 faces), the 64^3 one the dense sweep; the
    culled stages, sum_kd, sum_kw and their share of the dense pairs are
    printed, and the sign accuracy at 256 must be >= 0.999 in both types.
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
    run (training/trainer.py use_fused_igr) no kernel is launched. Every
    one of these single-card training runs replays its captured step
    (training/graphs.py): the kernels launch once per step and WARMUP times
    before the capture.
    (d) Each trainer graphed against its eager step (``train(eager=True)``),
    from one seed at full width: supervised bfloat16 8x512 at batch 16384
    and labelled IGRLOSS bfloat16 8x512 on configs/mesh_sdf.ini's sample
    counts of the sphere r = 0.85 (exact labels), and the point-cloud
    trainer at configs/pointcloud_igr.ini's 8x256 on 307,200 points of it,
    GRAPH_EPOCHS epochs each: losses and parameters bit-equal (and the
    supervised run's checkpoint, Adam's steps and rate on the card, resumes
    a graphed run bit-equal to an uninterrupted one and loads into the
    CPU's Adam). Then GRAPH_TRACE_EPOCHS epochs of each graphed run (one
    of each eager run) under torch.profiler, read over the trainer's
    ``training_loop`` range: every replay of the IGR and
    point-cloud steps holds igr_fwd_kernel, igr_bwd_kernel and
    igr_dw_kernel, and the host issues at most GRAPH_HOST_LAUNCHES launches
    a step outside the graphs. Printed for eager and graphed: points/s,
    seconds an epoch, the device's idle share traced and untraced, the
    capture's seconds. The HashMLP, FFN, Siren and KAN configs of phase 4h
    train one short epoch each way (the equality printed).
    (e) The sharded steps, each the same way (eager against graphed,
    GRAPH_EPOCHS, counts zeroed, then traced): Trainer(mesh=card x 2) and
    x 4 on the labelled IGRLOSS run and PointCloudTrainer(mesh=card x 4),
    each whole sharded step one graph whose replays hold k igr_fwd_kernel,
    k igr_bwd_kernel and k igr_dw_kernel (k shards; here and in (d) a
    graphed trace that lost some replays' device events is taken again,
    GRAPH_TRACE_TRIES in all); then a process group
    of one rank over NCCL (phase 4j (a)'s): the labelled IGRLOSS run on the
    group's data axis, the collectives inside the graph (its graphed run
    also bit-equal to (d)'s with no group), and supervised epochs of
    configs/mesh_sdf.ini through the entry point (graphed; eager through
    Trainer.train on the same CSVs). The host's launches a step outside the
    graphs: at most GRAPH_HOST_LAUNCHES in every graphed run.
    ``python3 chip_smoke.py --graphs`` runs this phase alone.
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
    trainer at 8x256, bfloat16, mesh=card x 4, phase 4c's epochs, each step
    a replay of the whole sharded step's graph: igr_fwd and igr_bwd launch
    once per shard and step (and WARMUP steps' worth before the capture),
    the loss falls, the
    point-cloud field's mesh at 128^3 sits on the cloud (median vertex
    radius within 1% of 0.85). One f32 IGRLOSS gradient through
    make_fused_value_and_grad_sharded (x2, x4) against the single-device op:
    rtol 2e-4 / atol 2e-5 (tests/test_sharding.py).
 4f. Marching on the card and the slab-streamed extractor, counts zeroed
    before each run: (a) on the seeded and the trained 8x512 nets' 256^3
    sparse volumes, the device marcher's exact wire gives the host
    marcher's triangle soup, the packed wire the exact wire's vertex ids
    and faces with t within 1/65535; wire bytes against the exact payload,
    and the host march, the device marches (host clock and CUDA events)
    and the packed wire's host decode timed, with the decoder that ran
    (native or numpy); (b) extract_mesh_giga at 512^3, slab 64, seeded net,
    the card listed 1, 2 and 4 times: one sparse_blocks launch per slab and
    nothing else, the merged mesh identical to one pass over the whole
    512^3 sparse volume (tests/test_giga_extract.py's canonical soup);
    (b2) kernel 3 at the 1024^3 giga route's shapes: every slab's active
    blocks by global id at the route's shared budget, as the extractor
    launches the blocks entry, against its plain version (f32 within
    F32_TOL; bf16 the mean against exact sums, the max against the
    kernel's own summation order), and the coarse sweep's peak device
    memory; (b3) extract_mesh_giga at 1024^3 in bf16 over the exact and
    the packed wire: the same faces, vertices within spacing/65535, both
    stage sets printed; (c) the entry point at cubesize 1024 from the seeded checkpoint under
    --compute-dtype float32 and bfloat16: the giga route (4 slabs: 4
    sparse_blocks launches and nothing else), the STL exists, its faces,
    the stages and the peak device memory are printed, and the 99th
    percentile of |f| at the vertices under the plain f32 forward is under
    one voxel plus the kernel's error, plus sqrt(3) * 2^-9 in bf16 (the
    blocks entry rounds grid coordinates to bf16: 2^-9 is half their
    spacing for 0.5 <= |x| < 1). The 1024 STLs are deleted after reading.
 4g. The 2-D mode, the rest of the sampler and the export, counts zeroed
    before each run and read after it: (a) configs/circle_2d.ini (ImplicitNet
    4x64, skip at 2; its own 500 epochs, directory under chiprun_out/)
    through the entry point: circle CSVs, training, the best checkpoint and
    contour_distances.csv, whose median r lies within 0.01 of sqrt(2/pi)
    (tests/test_pcd_and_2d.py's 0.2, tightened after the card read 1.9e-4);
    no kernel launches (supervised training and
    the f32 contour); points/s and the contour's seconds printed; (b)
    generate_occupancy at 64^3 and 128^3 on phase 3's icosphere(5): must
    launch dist_stream and wind_stream, signs equal the analytic sphere's
    0.01 away from it; augment_mismatch_from_postprocess on phase 4b's 64^3
    audit coordinates: launches both, mismatch.csv equals a direct
    signed_distance of those points; (c) phase 4b's trained f32 8x512 net
    through `python -m sdf_representation_tpu_torch.export` with
    --quantize --torchscript --fixtures 4096 (no kernel launches: the
    fixtures are the plain f32 forward, TF32 off), the lint clean; native/'s
    parity_main, deeptrace and libsdfnet_c.so built with g++ (the release
    flags of native/CMakeLists.txt, into build/chip_smoke_native/, started
    at the phase's start): parity_main, onnx_eval, the TorchScript file and
    NativeSDF (.sdfw, .onnx) against the fixtures within rtol 1e-4 / atol
    1e-5 (values) and rtol 1e-3 / atol 1e-4 (gradients), NativeSDF on the
    int8 file against the dequantized forward, deeptrace's leaf values
    against the forward; each stage's seconds printed.
 4h. Every model family through the entry point, counts zeroed before each
    run and read after it: (a) configs/mesh_sdf_hash.ini at its full width
    (HashMLP: 8 levels of 2^15 x 2 tables, 3x64 MLP, batch 16384, bfloat16;
    only paths, epochs and mode flags changed) on phase 4b's icosphere(5,
    0.5): samplingonly (the distance and winding streams launch), training
    (the loss falls), the audit at 256^3 (hash_grid_eval; the streams), the
    reconstruction at 256^3 (hash_grid_eval, marched on the card) and at
    1024^3 (the giga route through the x-slab evaluator), each mesh's
    median vertex radius within 1% of 0.85; no run launches kernels 1-3 or
    any other kernel. Then hash_grid_eval at 256^3 within rtol 2e-5 / atol
    2e-6 of the module's pointwise f32 forward, the first three 1024^3
    x-slabs (three planes each) within the same limits and the plane two
    slabs share bit-equal in both, and 131,072 points' corner indices
    (x 8 corners x 8 levels) equal to numpy's uint32 hash. (b)
    FeedForwardNetwork 8x512, Siren 5x256 (omega_0 30) and KAN (3, 64, 64,
    1) at grid 256 on configs/mesh_sdf.ini (model and widths changed) and
    (a)'s samples: training (finite, falling losses), the audit at 128^3
    (evaluate_points; whether its chunk was quartered is printed) and the
    reconstruction at 128^3 (evaluate_grid on the card). Wall time, points/s
    and peak device memory per run.
 4i. The host tools, counts zeroed before each run and read after it: (a)
    `python -m sdf_representation_tpu_torch.sampling` at configs/mesh_sdf.ini's
    sizes (100000 / 15 / 15 / 0.1) on phase 4b's rescaled icosphere(5), as a
    subprocess on the card's default device and in-process (3 dist_stream and
    3 wind_stream launches, nothing else): the three CSVs have no index
    column, the two runs' files are byte-equal and equal, value for value,
    to generate_signed_distance_data on the card, and the signs are the
    sphere's 0.01 beyond the facets' sag; (b) compute_normal_for_model on
    phase 4b's trained f32 8x512 net at the 64^3 grid's 262,144 points (one
    launch of each stream): the five CSVs, rmse and cos_mean over the grid
    and in the band |S| < 0.1 within NORMAL_* (stated before the first run),
    and the tool's (f, grad f) on the first 16,384 points within F32_TOL of
    kernel 8's f32 mode; (c) compare_octree_dl on phase 4g (c)'s deeptrace
    leaves (no launch): every node within NATIVE_VALUE_TOL, signs equal
    outside that margin, the same nodes as an ASCII VTU and a two-piece PVTU
    give the same numbers; (d) write_signed_distance_distributed over 8
    icosphere(5) .ply shards and a corrupt one (num_points_surface = 1): the
    rows, a second call appends nothing, a shard added later is appended
    alone, hosts 0 and 1 of 2 journal disjoint files that make up the whole;
    (e) generate_signed_distance_2D_msh on a 200-gon as gmsh v2.2 and v4.1
    at configs/circle_2d.ini's sizes: equal frames, surface |S| <= 1e-9,
    narrow |S| <= the width; (f) in a process of its own (after such traces,
    later torch.profiler traces in the same process held no device event),
    utils/profiling.trace around one supervised bfloat16 epoch of the
    flagship net (Trainer.train on (a)'s samples) and around 10 labelled
    IGRLOSS steps (8x512, 16,384 points, bfloat16; 10 launches of kernels 8
    and 9 in a counted run before), each also timed untraced: the Chrome
    trace, read by this script, gives the window, the device-busy time (the
    union of kernel intervals), the idle share, the top 5 kernels and
    kernels 8-9's share (a trace with no kernel event is taken again, three
    tries).
 4j. One process per card (parallel/multihost.py), the ranks spawned by
    this script (`python3 chip_smoke.py --rank R --spec FILE`) with a fixed
    timeout, counts zeroed before each run in each rank: (a) NCCL, one rank
    (initialize_multihost over tcp://127.0.0.1): phase 4c's labelled IGRLOSS
    run (8x512, bfloat16, DP_IGR_EPOCHS epochs) through Trainer on the
    group's data axis and one supervised epoch of configs/mesh_sdf.ini's
    8x512 net through the entry point, losses and parameters bit-equal to
    the same runs with no group (run here first), one igr_fwd and one
    igr_bwd per step, each step a graph replay (and WARMUP steps' worth
    before the capture); (b) gloo, two ranks on the one card (device cuda:0
    and backend gloo asked for; the steps eager, as the gloo rule prints):
    the point-cloud run (8x256, bfloat16,
    MH_PCD_EPOCHS epochs) and the labelled IGRLOSS run, the ranks' parameters
    bit-equal to each other, one igr_fwd and one igr_bwd per rank and step,
    losses within MH_LOSS_RTOL and parameters within MH_PARAM_RATIO (see
    there) of the one-process mesh=(card,) * 2 (phase 4e's labelled run; the
    point cloud's made here), and one supervised epoch through the entry
    point in per-rank directories where only rank 0's gains files; each
    rank's step times (labelled and point-cloud steps), the all-reduce's
    share and kernels 8-9's share on its rows; (c) controls on the CPU: a
    set with a rank that exits and one with a rank that hangs must fail.
 5. Times with CUDA events at the main path's shapes: kernel, plain version,
    one library layer chain (torch addmm, never called by the port), and
    the bound: the larger of bytes over 3.35 TB/s and operations over the
    card's peak (989 TFLOP/s bf16 tensor cores for bf16, 67 TFLOP/s FP32
    for f32), published figures at a 700 W limit. The f32 rows of kernels
    1-3 and 10-11 take three TF32 products per multiply-add at 495 TFLOP/s
    (the split-TF32 kernels), with the FP32-pipe bound and the weight bytes
    the launch reads from L2 (computed from its CTAs) beside it. For the
    streams the
    operations are a fixed count per point-triangle pair (the work of the
    function; each kernel's SASS instruction count, registers, local memory,
    points per thread and stage bytes stand beside its time).
    For igr_fwd and igr_bwd at (8x512, N 16,384) and (8x256, N 5,461): the
    operations are 2 N times the multiply-adds of the products each kernel
    performs (2 and ~6 passes over the layers; in f32 three TF32 products
    each at 495 TFLOP/s, the FP32-pipe bound beside it), the bytes are the
    inputs, the weights and the outputs (the kernels' workspace bytes and
    the kernel launches per wrapper call are reported beside the bound;
    igr_bwd also times its dW pass alone), and the library yardstick is the same
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
    kernels 8 and 9 launched once per shard on its rows. Each IGR call's
    kernels are read from torch.profiler traces: a trace that lacks an
    expected kernel is taken again (three tries), and the kernels found
    must equal the expected ones. Rows 8 and 9 of the kernels line carry
    phase 4j's per-rank step times and its launches.
 6. A `kernels` JSON line with eleven entries, then the contract line
    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Details go to build/chip_smoke.json.
"""

import contextlib
import io
import json
import math
import os
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
# the f32 fused forward (kernels 1-3, 10-11) runs each product as three TF32
# products (split operands: hi.hi + hi.lo + lo.hi) on the tensor cores
PEAK_TF32, TF32_PASSES = 495e12, 3
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
# FP32 operations per point-triangle pair: the work of each function, as it
# was counted from the first design of csrc/sdf_streams.cu and kept since, so
# that the bound reads the same work whatever a kernel now issues (its SASS
# is printed beside it). A multiply and an add count as one each, a
# division or a square root as 8, and atan2 as 36, the count of libdevice's
# atan2f that the first design called. Distance: 10 for the two dots, 2 for d
# and e, 6 for s and t, 8 for the two clamped edge minimisers, 5 for the
# region tests, 15 for the closest point, 5 for d^2, 4 for the validity
# select and the running minimum = 55; the division of the region a pair
# falls in (none, one or two) is left out, so the bound stays a lower one.
# Winding: 20 for the four dots, 36 for the three lengths, 9 + 1 for the
# cross terms and the numerator, 7 for the denominator, 36 for atan2, 3 to
# scale, mask and add = 112. The atan2 that the JAX kernel and wind_kernel
# now compute (pallas_streams._atan2) counts 34 by the same rules: 2 for the
# absolute values, 3 for the minimum and maxima, 8 for the division, 1 for
# q^2, 10 for the 6-coefficient polynomial, 1 for q p, 9 for the three
# quadrant fix-ups (compare, subtract or negate, select); the 2 ops over it
# are kept, so that the bound reads the same work as before the redesign.
DIST_OPS_PER_PAIR = 55
WIND_OPS_PER_PAIR = 112
EPOCHS = 30
# igr_fwd / igr_bwd against plain. f32: f and grad f within F32_TOL, every
# dW and db within IGR_F32_GRAD_TOL of its tensor's largest entry (summation
# order and the split-TF32 products' dropped lo.lo terms).
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
# phase 4c (d), (e): each trainer graphed against its eager step, epochs of
# each untraced run and of each graphed traced run (an eager one is traced
# for one epoch); the launches the host may issue a step
# outside the graphs, over a traced epoch (per step the index row, the loss,
# two generators' seed and offset, the graph; per epoch the permutation, the
# mean, validation's replays and the best-epoch snapshot): 16 before the
# card's first run of the single-device graphs, which read 9.0-10.2; 12
# since the sharded steps' graphs, whose host work a step is the same
GRAPH_EPOCHS = 3
GRAPH_TRACE_EPOCHS = 2
# tries of a graphed trace that lost some replays' device events: the
# point-cloud x4 trace (~41,500 kernels in ~0.3 s) lost some in 2 of its
# first 6 tries (3 whole replays; ~700 kernels)
GRAPH_TRACE_TRIES = 5
GRAPH_HOST_LAUNCHES = 12
GRAPH_FAMILY_BATCHES = 8  # steps of the other families' graphed epoch
PCD_EPOCHS = 31       # point-cloud run, bfloat16; model_epoch30.ckpt holds the last weights
PCD_POINTS = 307200
# phase 4g: configs/circle_2d.ini's own 500 epochs (no cut); occupancy grids
# on phase 3's icosphere(5) (20,480 faces, rescaled); the export's fixtures;
# the native consumers built with native/CMakeLists.txt:14-15's release flags
TWO_DIM_EPOCHS = 500
# |median contour r - sqrt(2/pi)|: the JAX test's 0.2 (tests/test_pcd_and_2d.py),
# tightened to 0.01 after the card's first run read 1.9e-4
TWO_DIM_MEDIAN_TOL = 0.01
OCC_SIZES = (64, 128)
OCC_LEVEL = 5
EXPORT_FIXTURES = 4096
NATIVE_FLAGS = ("-O3", "-march=native", "-fno-trapping-math", "-fno-math-errno", "-std=c++17",
                "-pthread")
# the native runtime against the port's f32 fixtures (tests/test_export_native.py)
NATIVE_VALUE_TOL = (1e-4, 1e-5)   # rtol, atol
NATIVE_GRAD_TOL = (1e-3, 1e-4)
# phase 4h: configs/mesh_sdf_hash.ini at its full width (its own 100 epochs
# cut to HASH_EPOCHS); FFN, Siren and KAN at the JAX defaults on the same
# samples, FAMILY_EPOCHS each; the separable evaluator against the pointwise
# f32 forward at the JAX test's tolerance (tests/test_hash_grid.py)
HASH_EPOCHS = 20
FAMILY_EPOCHS = 4
HASH_N, GIGA_N, FAMILY_N = 256, 1024, 128  # cubesizes: audit and mesh, the giga mesh, (b)
HASH_TOL = (2e-5, 2e-6)   # rtol, atol
HASH_RADIUS_TOL = 0.01    # |median vertex radius / 0.85 - 1|
HASH_INDEX_POINTS = 131072  # x 8 corners: ~1M indices a level against numpy
# phase 4i: the sampler CLI at configs/mesh_sdf.ini's sizes; the normal audit
# on the 64^3 grid. Its limits, stated before the card's first run: the f32
# net of phase 4b was fitted to values clamped to +-0.1 (WeightedSmoothL2Loss),
# so only the band |S| < 0.1 is held tightly (phase 4b's best loss ~1e-6
# gives an error of ~1e-3 there, sign accuracy 0.999 at 256^3); the rest of
# the grid is held for a field that is roughly the distance with radial
# gradients
CLI_SIZES = (100000, 15, 15, 0.1)
NORMAL_GRID = 64
NORMAL_RMSE_MAX, NORMAL_COS_MIN = 0.5, 0.8             # every grid point
NORMAL_BAND_RMSE_MAX, NORMAL_BAND_COS_MIN = 1e-2, 0.99  # |S| < 0.1
NORMAL_KERNEL_POINTS = 16384
SHARDS = 8           # .ply shards of icosphere(5) for the distributed sampler
POLYGON_SIDES = 200  # the 2-D .msh polygon; configs/circle_2d.ini's sizes
IGR_TRACE_STEPS = 10
TRACE_BATCH = 16384  # configs/mesh_sdf.ini's batch_size
DP_IGR_EPOCHS = 2    # phase 4e's labelled IGRLOSS run over the card x2, and phase 4j's
# phase 4j: one process per card (parallel/multihost.py), its ranks spawned by
# this script. The point-cloud run's epochs; a set of ranks that outlives its
# timeout (a hung collective) or a rank that exits non-zero fails the run.
MH_PCD_EPOCHS = 3
MH_TIMEOUT = 300          # seconds for a set of ranks
MH_CONTROL_TIMEOUT = 20   # the control sets: a rank exits, a rank hangs
MH_RESULT = "multihost rank result: "
# Two gloo ranks on the card against the one-process mesh=(card,) * 2: the
# gradient sums round in another order (the in-process shards' bf16
# gradients add in bf16, the ranks' add in f32 in the all-reduce), so their
# trajectories part as phase 4e's sharded and single-device runs part. Their
# readings in an earlier run of this script (NVIDIA H100 80GB HBM3, 700 W):
# labelled IGRLOSS x2 against x1, train loss rel 1.7e-3 and 2.9e-3 after
# epochs 1 and 2; point cloud x4 against x1, rel 5e-6, 2.1e-5 and 3.7e-4
# after epochs 1-3. Losses: rel MH_LOSS_RTOL per
# epoch (3.4x the largest). Parameters: ||P_ranks - P_mesh|| over
# ||P_mesh - P_init|| within MH_PARAM_RATIO times the same measure between
# the single-device run and P_mesh, both read in this run.
MH_LOSS_RTOL = 1e-2
MH_PARAM_RATIO = 2.0


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
    sums of csrc/hopper.cuh's stream, each a cuBLAS bf16 product with an f32 result,
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


def check_sass(library, entry, expected, tensor_cores=True, tf32=False):
    """The entries of a source whose mangled names the regular expression
    ``entry`` finds (``expected`` of them) use no local memory (spills or
    stack), and with ``tensor_cores`` each issues tensor-core products
    (HGMMA), with ``tf32`` (the f32 entries) on TF32 operands only and
    otherwise on none: counts from cuobjdump's SASS and resource usage,
    printed per function."""
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
            counts[fn] = {"instructions": 0, "HGMMA": 0, "HGMMA_TF32": 0}
        elif fn and re.search(r"/\*[0-9a-f]{4,}\*/\s+[@A-Z]", line):
            counts[fn]["instructions"] += 1
            counts[fn]["HGMMA"] += "HGMMA" in line
            counts[fn]["HGMMA_TF32"] += "HGMMA" in line and "TF32" in line
            if "HGMMA" in line and "sample" not in counts[fn]:
                counts[fn]["sample"] = re.sub(r"\s+", " ", line.split("*/", 1)[-1]).strip()[:80]
    for m in re.finditer(r"Function (\S+):\s*REG:(\d+) STACK:(\d+) SHARED:(\d+) LOCAL:(\d+)", usage):
        if m.group(1) in counts:
            counts[m.group(1)].update(registers=int(m.group(2)), stack=int(m.group(3)),
                                      local=int(m.group(5)))
    entries = {name: c for name, c in counts.items() if re.search(entry, name)}
    for name, c in sorted(entries.items()):
        print(f"sass {name}: {c}", flush=True)
    if len(entries) != expected:
        raise RuntimeError(f"expected {expected} entries {entry!r} in {library.name}'s SASS, "
                           f"found {len(entries)}")
    for name, c in entries.items():
        if tensor_cores and c["HGMMA"] == 0:
            raise RuntimeError(f"{name} issues no HGMMA")
        if tensor_cores and c["HGMMA_TF32"] != (c["HGMMA"] if tf32 else 0):
            raise RuntimeError(f"{name}: {c['HGMMA_TF32']} of its {c['HGMMA']} HGMMA take TF32 operands"
                               f" ({'all' if tf32 else 'none'} should)")
        if c.get("local", 1) or c.get("stack", 1):
            raise RuntimeError(f"{name}: local memory (spills or stack) or no resource usage: {c}")
    return counts


def timed(fn, min_reps=3, warmup=True):
    """ms per call of fn over min_reps calls (CUDA events), after one call
    unless ``warmup`` is False (the plain versions and library chains that
    take seconds a call, long after the card and its libraries are warm)."""
    if warmup:
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


def stream_inputs(rng):
    """Phase 3's stream case: the rescaled icosphere(5) (20,480 faces) and
    262,144 points of stream_points drawn from rng."""
    from sdf_representation_tpu_torch.geometry.primitives import make_icosphere
    from sdf_representation_tpu_torch.geometry.rescale import rescale_mesh

    mesh = rescale_mesh(make_icosphere(5, 0.5))
    return mesh, stream_points(mesh, 262144, rng)


def culled_schedule(device, mesh, pts, tri_chunk=512, m=2048):
    """The schedule the culled method makes for pts: Morton blocks of m
    points on the card, the faces in Morton order in chunks of tri_chunk,
    the cull at slack _CULL_SLACK. Returns (Morton order of pts, blocks
    (n_blocks, m, 3), faces in chunk order, triangle tables, distance keep
    matrix, winding keep matrix)."""
    from sdf_representation_tpu_torch.ops import sdf_culled as sc
    from sdf_representation_tpu_torch.ops import sdf_exact as se

    faces = mesh.faces[sc._morton_order(mesh.vertices[mesh.faces].mean(axis=1))]
    order, P = sc._sorted_blocks(pts, m, device)
    tables, _ = se._triangle_tables(mesh.vertices, faces, tri_chunk)
    centers, radii, _, cbar = sc._chunk_geometry(mesh.vertices, faces, tri_chunk)
    scale = float(max(np.abs(mesh.vertices).max(), np.abs(pts).max(), 1.0))
    kd, kw = sc._cull(P, np.full(P.shape[:2], np.inf, np.float32), centers, radii, 2.0,
                      cbar=cbar, slack=sc._CULL_SLACK * scale)
    return order, P, faces, tables, kd, kw


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
    from sdf_representation_tpu_torch.ops import sdf_exact as se
    from sdf_representation_tpu_torch.ops import sdf_streams as ss

    rng = np.random.default_rng(SEED)
    mesh, pts = stream_inputs(rng)
    radius = float(np.linalg.norm(mesh.vertices, axis=1).mean())
    tri_chunk, m = 1024, se.POINT_CHUNK
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
    from sdf_representation_tpu_torch.ops import sdf_streams as ss

    tri_chunk, m = 512, 2048
    order, P, faces, tables, kd, kw = culled_schedule(device, mesh, pts, tri_chunk, m)
    if not np.array_equal(order.cpu().numpy(), sc._morton_order(pts)):
        raise RuntimeError("the Morton order on the card differs from the host's")
    n_blocks = P.shape[0]
    pad = P.reshape(-1, 3).cpu().numpy()
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
    from sdf_representation_tpu_torch.losses.losses import IGRLOSS
    from sdf_representation_tpu_torch.ops import fused_igr as fi
    from sdf_representation_tpu_torch.ops import fused_mlp as fm
    from sdf_representation_tpu_torch.ops import sharded_eval as se
    from sdf_representation_tpu_torch.ops import sparse_grid as sg
    from sdf_representation_tpu_torch.parallel.mesh import gather
    from sdf_representation_tpu_torch.training import PointCloudTrainer, Trainer, graphs
    from sdf_representation_tpu_torch.training import trainer as trainer_module

    launches, out = {}, {}
    root = run_root / "pipeline"

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
            with counted(launches, f"sharded_grid/{tag}/x{k}"):
                vol = se.sharded_grid_eval(model, 256, (device,) * k, compute_dtype=dt)
            only_launched(launches, f"sharded_grid/{tag}/x{k}", sharded_grid=k)
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
            with counted(launches, tag):
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
            only_launched(launches, tag, sparse_sharded_blocks=k * max(passes, 1))
            if not (bit_equal and count == count1 == int(mask.sum())):
                raise RuntimeError(f"{tag}: count or active blocks differ")
            out["sparse_sharded"][f"{name}/x{k}"] = row
        del dense, single
    # the budget overflows at k_max_frac 0.01 and the pass is retried
    se._KMAX_CACHE_SHARDED.clear()
    tag = "sparse_sharded/seeded/x4/retry"
    with counted(launches, tag):
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
            ("dp_igr_train/bfloat16/x2", "igr_bfloat16.ini", Trainer, 2, DP_IGR_EPOCHS),
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
        with counted(launches, tag):
            result = trainer.train()
        steps = ((n_train if cls is Trainer else PCD_POINTS) // 16384) * epochs
        # each step a replay of the whole sharded step's graph (training/graphs.py),
        # which counts k launches of each kernel; the warm-up's eager steps launch too
        only_launched(launches, tag, igr_fwd=k * (steps + graphs.WARMUP),
                      igr_bwd=k * (steps + graphs.WARMUP))
        curve = result["train_losses"] if cls is Trainer else result["losses"]
        stats = dict(trainer_module.LAST_RUN)
        print(f"{tag}: {steps} steps + {graphs.WARMUP} warm-up, launches {launches[tag]['igr_fwd']} "
              f"igr_fwd, {launches[tag]['igr_bwd']} igr_bwd, {stats}, train loss "
              + " ".join(f"{v:.3e}" for v in curve), flush=True)
        if not stats["graphed"]:
            raise RuntimeError(f"{tag}: the sharded steps on one card were not graph replays")
        if not (len(curve) == epochs and np.isfinite(curve).all() and curve[-1] < curve[0]):
            raise RuntimeError(f"{tag}: the loss did not fall: {curve}")
        out["data_parallel"][tag] = {**stats, "steps": steps, "train_loss": list(curve)}
        if cls is Trainer:  # phase 4j's reference for two ranks on the card
            igr_x2 = {"train_loss": list(curve), "state": {
                k: v.detach().cpu().clone() for k, v in trainer.model.state_dict().items()}}
    # mesh the data-parallel point-cloud field through the entry point
    rec = root / "dp_pcd_reconstruct.ini"
    rec.write_text(with_keys(text, distributed=False, ppo=True, reconstruct=True, cubesize=128))
    with counted(launches, "dp_pcd_reconstruct/128"):
        if cli.main([str(rec)]) != 0:
            raise RuntimeError("dp_pcd_reconstruct: the entry point failed")
    only_launched(launches, "dp_pcd_reconstruct/128", fused_grid=1)
    verts, n_faces = stl_vertices(pathlib.Path(trainer.postprocess_save_path)
                                  / f"reconstructed_epoch{PCD_EPOCHS - 1}.stl", device)
    radius = float(np.median(np.linalg.norm(verts, axis=1)))
    print(f"mesh from the data-parallel point-cloud field, 128^3: {n_faces} faces, median "
          f"vertex radius {radius:.4f} (the cloud's sphere: 0.85, tolerance 1%)", flush=True)
    if n_faces < 100 or abs(radius - 0.85) > 0.0085:
        raise RuntimeError("dp_pcd_reconstruct: the mesh does not sit on the cloud")
    out["data_parallel"]["pcd_reconstruct_128"] = {"faces": n_faces, "median_radius": radius}

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
    return launches, {"ids": ids, "count": count, "errors": errors, "xy": (x, y), "igr_x2": igr_x2}


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
    """The backward's two passes on their own: the first pass's workspace
    against fused_igr.images_plain (bf16 images, equal but where a sum in
    another order rounds to the neighbouring value, which later layers carry
    on; f32 values and split images that differ by the summation order: the
    mean difference within 1e-2 of the mean value, where a misplaced row or
    column reads ~1; db partial sums within 1e-3 of the largest on average),
    and the dW pass on that plain workspace against fused_igr.dw_pass_plain
    (bf16 products, or the split-TF32 products of f32, summed in f64:
    within 1e-5 of each buffer's largest entry)."""
    from sdf_representation_tpu_torch.ops import fused_igr as fi

    _, _, (found_ws, found_partial) = fi._bwd_cuda(net, x, a, c)
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


def kernels_per_call(fn, expected, traces=3):
    """{kernel: launches} of csrc/fused_igr.cu's kernels in one call of fn,
    read from torch.profiler's device events (fn has run before: built,
    warmed, its plan on the card). ``expected`` names the kernels the call
    must launch. The profiler's device tracing now and then records only
    part of a call, so a trace that lacks any expected kernel is taken
    again, up to ``traces`` times; if none holds them all, this raises with
    each trace's device-event names. A trace that holds them counts as it
    stands: extra or repeated launches show in what it returns."""
    from torch.profiler import ProfilerActivity, profile

    seen = []
    for trace in range(1, traces + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        device = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        found = {}
        for name in device:
            m = re.search(r"igr_(fwd|bwd|dw)_kernel", name)
            if m:
                found[m.group(0)] = found.get(m.group(0), 0) + 1
        if all(name in found for name in expected):
            return found
        seen.append(device)
        print(f"kernels_per_call: trace {trace} of {traces} lacks "
              f"{sorted(set(expected) - set(found))}; its device events: {sorted(set(device))}",
              flush=True)
    raise RuntimeError(f"no trace of {traces} holds the kernels {sorted(expected)}; device events "
                       f"per trace: {[sorted(set(d)) for d in seen]}")


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
                # one input, two launches: both types sum in a fixed order and
                # must agree bit for bit
                again = fi.unpack_grads(3, shapes, fi.fused_param_grads(net, x, a, c))
                same = all(torch.equal(u, v) for u, v in zip(again, got))
                print(f"check igr_bwd/{tag}: two launches bit-equal {same}, differ by at most "
                      f"{gradient_errors(again, got)[1]:.3e} of a tensor's largest entry", flush=True)
                readings[f"{tag}/two_launches_bit_equal"] = same
                if not same:
                    raise RuntimeError(f"igr_bwd/{tag}: two launches give different gradients")
                check_igr_passes(net, x, a, c, tag, readings)
            if not (f.shape == (n,) and g.shape == (n, 3) and torch.isfinite(f).all()
                    and torch.isfinite(g).all() and all(torch.isfinite(t).all() for t in got)):
                raise RuntimeError(f"igr/{tag}: non-finite or misshapen output")
            max_tol = IGR_BF16_TOL if bf16 else F32_TOL
            worst_tol = IGR_RELU_BF16_GRAD_MAX_TOL if beta <= 0 else IGR_BF16_GRAD_MAX_TOL

            def held(f, g, got):
                """(within the case's limits, the readings) of one (f, grad f,
                gradients) against the plain versions'."""
                df, dg = (f - pf).abs(), (g - pg).abs()
                g_mean, g_worst = gradient_errors(got, want)
                flipped = (dg.amax(dim=1) > max_tol).float().mean().item()
                row = {"f_max": df.max().item(), "f_mean": df.mean().item(),
                       "grad_f_max": dg.max().item(), "grad_f_mean": dg.mean().item(),
                       "grad_f_over_max_limit": flipped, "grads_mean": g_mean, "grads_worst": g_worst}
                ok = df.max().item() <= max_tol and (not bf16 or df.mean().item() <= IGR_BF16_F_MEAN_TOL)
                ok = ok and dg.mean().item() <= (IGR_BF16_G_MEAN_TOL if bf16 else F32_TOL)
                if flips:
                    ok = ok and flipped <= IGR_RELU_FLIPPED and g_mean <= IGR_RELU_GRAD_MEAN_TOL
                elif bf16:
                    ok = ok and dg.max().item() <= max_tol
                    ok = ok and g_mean <= IGR_GRAD_MEAN_TOL and g_worst <= worst_tol
                else:
                    ok = ok and dg.max().item() <= max_tol and g_worst <= IGR_F32_GRAD_TOL
                return ok, row

            ok, readings[tag] = held(f, g, got)
            row = readings[tag]
            print(f"check igr_fwd/{tag}: f max {row['f_max']:.3e} mean {row['f_mean']:.3e}, "
                  f"grad f max {row['grad_f_max']:.3e} mean {row['grad_f_mean']:.3e}, over the max limit "
                  f"at {row['grad_f_over_max_limit']:.5f} of the points", flush=True)
            print(f"check igr_bwd/{tag}: {len(got)} gradients, sum|diff|/sum|plain| {row['grads_mean']:.3e}, "
                  f"worst max|diff|/max|plain| {row['grads_worst']:.3e}", flush=True)
            if not ok:
                raise RuntimeError(f"igr/{tag}: kernel and plain version disagree")
            if not bf16:
                # the split-TF32 emulation beside the kernel: three passes hold
                # the same limits, one pass (a single TF32 pass) must fail them
                for passes in (3, 1):
                    ef, eg = fi.fused_value_and_grad_tf32_model(net, x, passes)
                    eg_ = fi.unpack_grads(3, shapes, fi.fused_param_grads_tf32_model(net, x, a, c, passes))
                    e_ok, controls[f"igr/{tag}/emulated_{passes}_pass"] = held(ef, eg, eg_)
                    print(f"control igr/{tag}/emulated_{passes}_pass (within the limits: {e_ok}): "
                          + json.dumps(controls[f"igr/{tag}/emulated_{passes}_pass"]), flush=True)
                    if e_ok != (passes == 3):
                        raise RuntimeError(f"control igr/{tag}: the {passes}-pass emulation "
                                           + ("fails" if passes == 3 else "holds") + " the f32 limits")
            errors["igr_fwd", case, dt] = max(row["f_max"], row["grad_f_max"])
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


def canon_soup(verts, faces):
    """The mesh as a sorted triangle soup, each face's vertices sorted
    (tests/test_marching.py's _canon_soup): equal for two marchers that
    emit the same triangles in another order."""
    tris = verts[faces].reshape(len(faces), 3, 3)
    order = np.lexsort((tris[:, :, 2], tris[:, :, 1], tris[:, :, 0]), axis=1)
    arr = np.take_along_axis(tris, order[:, :, None], axis=1).reshape(-1, 9)
    return arr[np.lexsort(arr.T[::-1])]


def stl_vertices(path, device):
    """(the welded vertices, float64 numpy, and the face count) of a binary
    STL that the port wrote, as geometry.mesh_io.load_mesh gives them: the
    triangles' corners merged where they agree to 8 decimals. The merge is
    sorted on the card: load_mesh's numpy sort of 66 M corners (the
    HashMLP's 1024^3 mesh) takes minutes of the host."""
    with open(path, "rb") as f:
        f.seek(80)
        n = int(np.frombuffer(f.read(4), dtype="<u4")[0])
        rec = np.frombuffer(f.read(n * 50), dtype=np.uint8).reshape(n, 50)
    corners = torch.from_numpy(rec[:, 12:48].copy().view("<f4").reshape(-1, 3)).to(device,
                                                                                   torch.float64)
    _, inverse = torch.unique(torch.round(corners, decimals=8), dim=0, return_inverse=True)
    first = torch.full((int(inverse.max()) + 1,), len(corners), device=device).scatter_reduce_(
        0, inverse, torch.arange(len(corners), device=device), "amin")
    return corners[first].cpu().numpy(), n


def canon_mesh(verts, faces):
    """The orientation-keeping canonical soup of tests/test_giga_extract.py
    (_canon): each face rotated so that its lexicographically smallest
    vertex comes first, the faces sorted."""
    tri = verts[faces]
    best = tri.reshape(len(tri), -1)
    for r in (1, 2):
        rot = np.roll(tri, -r, axis=1).reshape(len(tri), -1)
        less, decided = np.zeros(len(tri), bool), np.zeros(len(tri), bool)
        for c in range(rot.shape[1]):
            lt, gt = rot[:, c] < best[:, c], rot[:, c] > best[:, c]
            less |= ~decided & lt
            decided |= lt | gt
        best = np.where(less[:, None], rot, best)
    return best[np.lexsort(best.T[::-1])]


@contextlib.contextmanager
def counted(launches, tag):
    """Every launch count zeroed on entry and read into launches[tag] on
    exit, the card synchronized at both ends; fails if a plain version ran."""
    from sdf_representation_tpu_torch.ops import fused_igr as fi
    from sdf_representation_tpu_torch.ops import fused_mlp as fm
    from sdf_representation_tpu_torch.ops import sdf_streams as ss

    torch.cuda.synchronize()
    for counters in (fm, ss, fi):
        counters.reset_launches()
    with counting_plain_calls((fm, ss, fi)) as plain:
        yield
        torch.cuda.synchronize()
    launches[tag] = {**fm.LAUNCHES, **ss.LAUNCHES, **fi.LAUNCHES}
    if any(plain.values()):
        raise RuntimeError(f"{tag}: a plain version ran on the card's path: {plain}")


def only_launched(launches, tag, **expected):
    want = {name: expected.get(name, 0) for name in launches[tag]}
    if launches[tag] != want:
        raise RuntimeError(f"{tag}: launches {launches[tag]}, expected {want}")


def need(launches, tag, *names):
    missing = [n for n in names if launches[tag][n] < 1]
    if missing:
        raise RuntimeError(f"{tag} did not launch {missing}: {launches[tag]}")


def start_native_build(out_dir):
    """g++ on native/src's parity_main, deeptrace and libsdfnet_c.so (one
    process each, started together) into out_dir: {name: Popen}."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: phase 4g builds the native consumers with it")
    src = REPO / "native" / "src"
    jobs = {"parity_main": ["parity_main.cpp"], "deeptrace": ["deeptrace.cpp"],
            "libsdfnet_c.so": ["sdfnet_c.cpp", "wire_decode.cpp"]}
    procs = {}
    for name, sources in jobs.items():
        extra = ["-shared", "-fPIC"] if name.endswith(".so") else []
        cmd = [gxx, *NATIVE_FLAGS, *extra, *(str(src / f) for f in sources), "-o", str(out_dir / name)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return procs


def finish_native_build(procs):
    for name, proc in procs.items():
        log, _ = proc.communicate(timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ {name} failed ({proc.returncode}): {log[-3000:]}")


def within(got, want, tol, what):
    """max |got - want| of two host arrays; raises when an entry lies over
    atol + rtol |want| (tol = (rtol, atol))."""
    got, want = (torch.as_tensor(np.asarray(a, np.float64)) for a in (got, want))
    if got.shape != want.shape or not torch.isfinite(got).all():
        raise RuntimeError(f"{what}: shape {tuple(got.shape)} (want {tuple(want.shape)}) "
                           "or non-finite values")
    over, err = exceeds(got, want, *tol)
    if over > 0:
        raise RuntimeError(f"{what}: max |diff| {err:.3e} over rtol {tol[0]:g} / atol {tol[1]:g}")
    return err


def drive_export_two_dim(device, run_root, report):
    """Phase 4g: (a) the 2-D circle mode through the entry point; (b)
    occupancy grids and the mismatch loop, whose labels launch kernels 4
    and 5; (c) phase 4b's trained f32 flagship net through the export entry
    point, held against the native consumers built here, onnx_eval and
    the TorchScript file. Counts are zeroed before each run and read after
    it. Returns the launches per run."""
    from sdf_representation_tpu_torch import cli
    from sdf_representation_tpu_torch.configgen import Configuration
    from sdf_representation_tpu_torch.data.dataset import frame_from_csv
    from sdf_representation_tpu_torch.evaluations import two_dim
    from sdf_representation_tpu_torch.export import conversion, onnx_eval, quantize
    from sdf_representation_tpu_torch.export import torchscript_export as ts
    from sdf_representation_tpu_torch.export.__main__ import main as export_main
    from sdf_representation_tpu_torch.export.native_runtime import NativeSDF
    from sdf_representation_tpu_torch.export.onnx_lint import lint_onnx
    from sdf_representation_tpu_torch.geometry.mesh_io import load_mesh
    from sdf_representation_tpu_torch.geometry.primitives import make_icosphere
    from sdf_representation_tpu_torch.geometry.rescale import rescale_mesh
    from sdf_representation_tpu_torch.models import ImplicitNet
    from sdf_representation_tpu_torch.ops.sdf_exact import signed_distance
    from sdf_representation_tpu_torch.sampling import sampler
    from sdf_representation_tpu_torch.training import Trainer
    from sdf_representation_tpu_torch.training import trainer as trainer_module

    card = report["card"]
    launches, out = {}, {}
    # a directory of its own: build/libsdfnet_c.so would switch phase 4f's
    # wire decoder from numpy to native
    native_dir = REPO / "build" / "chip_smoke_native"
    shutil.rmtree(native_dir, ignore_errors=True)
    native_dir.mkdir(parents=True)
    t_build = time.perf_counter()
    procs = start_native_build(native_dir)
    try:
        # -- (a) the 2-D circle mode: sample, train, contour -------------------
        root = REPO / "chiprun_out" / "chip_smoke_2d"
        shutil.rmtree(root, ignore_errors=True)
        root.mkdir(parents=True)
        cfg_path = root / "circle_2d.ini"
        cfg_path.write_text(with_keys((REPO / "configs" / "circle_2d.ini").read_text(),
                                      directory=f"{root}/", epochs=TWO_DIM_EPOCHS))
        with counted(launches, "two_dim"):
            t0 = time.perf_counter()
            if cli.main([str(cfg_path)]) != 0:
                raise RuntimeError("two_dim: the entry point failed")
            wall = time.perf_counter() - t0
        # supervised training and the f32 contour run no fused kernel
        only_launched(launches, "two_dim")
        stats = dict(trainer_module.LAST_RUN)
        t = Trainer(Configuration(str(cfg_path)))
        uniform = frame_from_csv(str(pathlib.Path(t.data_path) / "uniform.csv"))
        radius = math.sqrt(2 / math.pi)
        r = np.linalg.norm(uniform.values[:, :3], axis=1)
        if not (len(uniform) == 20000 and np.all(uniform["z"] == 0)
                and np.abs(uniform["S"] - (r - radius)).max() < 1e-12):
            raise RuntimeError("two_dim: uniform.csv is not the circle's labelled points")
        if not (pathlib.Path(t.model_save_path) / "best_model.ckpt").exists():
            raise RuntimeError("two_dim: no best checkpoint")
        contour_csv = pathlib.Path(t.postprocess_save_path) / "contour_distances.csv"
        contour = np.loadtxt(contour_csv, delimiter=",", skiprows=1, ndmin=2)
        median_r = float(np.median(contour[:, 2])) if len(contour) else math.nan
        # the contour once more, alone, for its time
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dists = two_dim.two_dim_contour(t)
        contour_s = time.perf_counter() - t0
        row = {"wall_s": wall, "epochs_run": stats["epochs_run"], "train_s": stats["seconds"],
               "points_per_s": stats["points_per_sec"], "contour_s": contour_s,
               "contour_points": len(contour), "median_r": median_r,
               "median_r_minus_radius": median_r - radius}
        print(f"phase 4g (a) 2-D circle ({card}), configs/circle_2d.ini at 4x64, {TWO_DIM_EPOCHS} "
              "epochs (no cut): " + json.dumps(row), flush=True)
        if not (len(contour) > 10 and abs(median_r - radius) < TWO_DIM_MEDIAN_TOL
                and np.array_equal(dists, contour[:, 2].astype(np.float32))):
            raise RuntimeError(f"two_dim: the contour is not the circle's: {row}")
        out["two_dim"] = row

        # -- (b) occupancy grids and the mismatch loop: kernels 4 and 5 ---------
        mesh = rescale_mesh(make_icosphere(OCC_LEVEL, 0.5))
        sphere_r = float(np.linalg.norm(mesh.vertices, axis=1).mean())
        out["occupancy"] = {}
        for n in OCC_SIZES:
            tag = f"occupancy/{n}"
            with counted(launches, tag):
                t0 = time.perf_counter()
                occ = sampler.generate_occupancy(n, mesh)
                sec = time.perf_counter() - t0
            need(launches, tag, "dist_stream", "wind_stream")
            rr = np.linalg.norm(occ.values[:, :3], axis=1)
            away = np.abs(rr - sphere_r) > 0.01  # well past the facets' sag
            wrong = int(np.sum(occ["occupancy"][away] != np.sign(rr[away] - sphere_r)))
            row = {"seconds": sec, "points": len(occ), "faces": len(mesh.faces),
                   "inside": int(np.sum(occ["occupancy"] < 0)), "checked": int(away.sum()),
                   "wrong_signs": wrong, "launches": {k: v for k, v in launches[tag].items() if v}}
            print(f"phase 4g (b) generate_occupancy {n}^3 ({card}): " + json.dumps(row), flush=True)
            if len(occ) != n ** 3 or wrong:
                raise RuntimeError(f"{tag}: signs disagree with the analytic sphere: {row}")
            out["occupancy"][n] = row

        audit = Trainer(Configuration(str(run_root / "pipeline" / "audit_64.ini")))
        coords = frame_from_csv(str(pathlib.Path(audit.postprocess_save_path)
                                    / "mismatching_co-ordinates1.csv"))
        pts = np.column_stack([coords[c] for c in ("x", "y", "z")])
        # the geometry the audit labelled against
        mesh_path = str(pathlib.Path(audit.main_path) / f"{audit.geometry_name}_rescaled.stl")
        with counted(launches, "mismatch"):
            t0 = time.perf_counter()
            path = sampler.augment_mismatch_from_postprocess(audit, mesh_path=mesh_path)
            sec = time.perf_counter() - t0
        need(launches, "mismatch", "dist_stream", "wind_stream")
        got = frame_from_csv(path)
        S, nrm = signed_distance(pts, load_mesh(mesh_path))
        same = (len(pts) > 0 and np.array_equal(got.values[:, :3], pts)
                and np.array_equal(got["S"], S) and np.array_equal(got.values[:, 4:], nrm))
        row = {"points": len(pts), "seconds": sec, "equal_to_signed_distance": bool(same),
               "launches": {k: v for k, v in launches["mismatch"].items() if v}}
        print(f"phase 4g (b) mismatch loop on the 64^3 audit's coordinates ({card}): "
              + json.dumps(row), flush=True)
        if not same:
            raise RuntimeError(f"mismatch.csv is not signed_distance of the audit's points: {row}")
        out["mismatch"] = row

        # -- (c) the trained flagship net through the export entry point --------
        train_cfg = str(run_root / "pipeline" / "train_float32.ini")
        export_dir = run_root / "export"
        shutil.rmtree(export_dir, ignore_errors=True)
        with counted(launches, "export"):
            t0 = time.perf_counter()
            if export_main([train_cfg, str(export_dir), "--quantize", "--torchscript",
                            "--fixtures", str(EXPORT_FIXTURES)]) != 0:
                raise RuntimeError("export: the entry point failed")
            export_wall = time.perf_counter() - t0
        # the fixtures are the module's own f32 forward: no kernel
        only_launched(launches, "export")
        stages = dict(conversion.LAST_STAGE_SECONDS)
        files = {f: (export_dir / f).stat().st_size for f in (
            "model.sdfw", "model_int8.sdfw", "model.onnx", "model_quant.onnx",
            "implicit_model.pt", "input.csv", "output.csv", "gradient.csv")}
        lint = {f: lint_onnx(str(export_dir / f)) for f in ("model.onnx", "model_quant.onnx")}
        if any(lint.values()):
            raise RuntimeError(f"export: the lint found problems: {lint}")
        pts = np.loadtxt(export_dir / "input.csv", delimiter=",", dtype=np.float32)
        ref_v = np.loadtxt(export_dir / "output.csv", delimiter=",")
        ref_g = np.loadtxt(export_dir / "gradient.csv", delimiter=",")
        trained = Trainer(Configuration(train_cfg))
        trained.load_model(best=True)
        model = trained.model
        with torch.no_grad():
            fwd = model(torch.from_numpy(pts).to(device)).cpu().numpy()
        errors = {"fixtures_vs_forward": within(ref_v, fwd, (1e-5, 1e-6), "fixtures")}

        t0 = time.perf_counter()
        finish_native_build(procs)
        stages["native_build_wait"] = time.perf_counter() - t0
        stages["native_build_since_start"] = time.perf_counter() - t_build
        t0 = time.perf_counter()
        subprocess.run([str(native_dir / "parity_main"), str(export_dir / "model.sdfw"),
                        str(export_dir / "input.csv"), str(export_dir / "cpp_output.csv"),
                        str(export_dir / "cpp_gradient.csv")], check=True, capture_output=True,
                       timeout=600)
        stages["native_parity"] = time.perf_counter() - t0
        errors["parity_main_values"] = within(np.loadtxt(export_dir / "cpp_output.csv", delimiter=","),
                                              ref_v, NATIVE_VALUE_TOL, "parity_main values")
        errors["parity_main_gradients"] = within(
            np.loadtxt(export_dir / "cpp_gradient.csv", delimiter=","), ref_g, NATIVE_GRAD_TOL,
            "parity_main gradients")
        t0 = time.perf_counter()
        onnx_v = onnx_eval.run_onnx(str(export_dir / "model.onnx"), {"points": pts})["sdf"][:, 0]
        stages["onnx_eval"] = time.perf_counter() - t0
        errors["onnx_eval_values"] = within(onnx_v, ref_v, NATIVE_VALUE_TOL, "onnx_eval")
        t0 = time.perf_counter()
        ts_v, ts_g = ts.eval_torchscript(str(export_dir / "implicit_model.pt"), pts, gradients=True)
        stages["eval_torchscript"] = time.perf_counter() - t0
        errors["torchscript_values"] = within(ts_v, ref_v, NATIVE_VALUE_TOL, "torchscript values")
        errors["torchscript_gradients"] = within(ts_g, ref_g, NATIVE_GRAD_TOL, "torchscript gradients")
        lib = str(native_dir / "libsdfnet_c.so")
        for name in ("model.sdfw", "model.onnx"):
            with NativeSDF(str(export_dir / name), lib_path=lib) as net:
                vals, grads = net.evaluate(pts, gradients=True)
            errors[f"NativeSDF_{name}_values"] = within(vals, ref_v, NATIVE_VALUE_TOL, f"NativeSDF {name}")
            errors[f"NativeSDF_{name}_gradients"] = within(grads, ref_g, NATIVE_GRAD_TOL,
                                                           f"NativeSDF {name} gradients")
        arch, sd8 = quantize.load_sdfw_any(str(export_dir / "model_int8.sdfw"))
        deq = ImplicitNet(**arch, device="cpu")
        deq.load_state_dict(sd8)
        with NativeSDF(str(export_dir / "model_int8.sdfw"), lib_path=lib) as net, torch.no_grad():
            errors["NativeSDF_int8_vs_dequantized"] = within(
                net(pts), deq(torch.from_numpy(pts)).numpy(), NATIVE_VALUE_TOL, "NativeSDF int8")
        dt_dir = export_dir / "deeptrace"
        dt_dir.mkdir()
        (dt_dir / "config.txt").write_text(
            "refine_lvl_uni = 2\nrefine_lvl_bd = 4\ncubeDomainMin = [-1.0, -1.0, -1.0]\n"
            f"cubeDomainMax = [1.0, 1.0, 1.0]\nModelFileName = \"{export_dir}/model.onnx\"\n"
            "useDeepLearning = true\n")
        t0 = time.perf_counter()
        res = subprocess.run([str(native_dir / "deeptrace"), str(dt_dir / "config.txt"), str(dt_dir)],
                             check=True, capture_output=True, text=True, timeout=600)
        stages["deeptrace"] = time.perf_counter() - t0
        leaf = np.loadtxt(dt_dir / "points.csv", delimiter=",", ndmin=2)
        with torch.no_grad():
            leaf_f = model(torch.from_numpy(leaf[:, :3].astype(np.float32)).to(device)).cpu().numpy()
        if "leaf cells" not in res.stdout:
            raise RuntimeError(f"deeptrace: {res.stdout[-500:]}")
        errors["deeptrace_leaf_values"] = within(leaf[:, 3], leaf_f, NATIVE_VALUE_TOL, "deeptrace")
        row = {"wall_s": export_wall, "stages_s": stages, "files_bytes": files,
               "fixtures": len(pts), "deeptrace_points": len(leaf), "max_abs_err": errors}
        print(f"phase 4g (c) export of the trained 8x512 net ({card}): " + json.dumps(row), flush=True)
        out["export"] = row
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    report["export_two_dim"] = out
    return launches


def drive_marching(device, run_root, model, checks, report):
    """Phase 4f: the device marcher and the slab-streamed extractor on the
    seeded and the trained 8x512 nets, counts zeroed before each run.
    Returns the launches per run."""
    from sdf_representation_tpu_torch import cli
    from sdf_representation_tpu_torch.configgen import Configuration
    from sdf_representation_tpu_torch.evaluations import reconstruct
    from sdf_representation_tpu_torch.ops import fused_mlp as fm
    from sdf_representation_tpu_torch.ops import giga_extract as ge
    from sdf_representation_tpu_torch.ops import marching_device as md
    from sdf_representation_tpu_torch.ops import sparse_grid as sg
    from sdf_representation_tpu_torch.ops.marching import marching_cubes
    from sdf_representation_tpu_torch.training import Trainer

    launches, out = {}, {"decoder": md.wire_decoder()}
    print(f"phase 4f: the packed wire decodes with the {out['decoder']} decoder", flush=True)
    trained = Trainer(Configuration(str(run_root / "pipeline" / "train_float32.ini")))
    trained.load_model()
    nets = {"seeded": model, "trained": trained.model}
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    # -- (a) the device marcher against the host marcher, 256^3 sparse volume --
    n = 256
    grid = ((2.0 / (n - 1),) * 3, (-1.0,) * 3)
    out["march_256"] = {}
    for name, net in nets.items():
        vol = sg.sparse_grid_eval(net, n)
        md.marching_tets_device(vol)  # first call: the tables go to the card
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        host_vol = vol.cpu().numpy()
        t1 = time.perf_counter()
        vh, fh = marching_cubes(host_vol, 0.0, *grid)
        t2 = time.perf_counter()
        start.record()
        vs_e, t_e, f_e = md.marching_tets_device(vol)
        stop.record()
        t3 = time.perf_counter()
        torch.cuda.synchronize()
        exact_ms = start.elapsed_time(stop)
        start.record()
        words, t_q, bids = md.packed_wire(vol)
        stop.record()
        t4 = time.perf_counter()
        torch.cuda.synchronize()
        packed_ms = start.elapsed_time(stop)
        vs_p, t_p, f_p = md.decode_packed_wire(words, t_q, bids, vol.shape)
        t5 = time.perf_counter()
        ve = md.decode_vertices(vs_e, t_e, vol.shape, *grid)
        same_soup = np.array_equal(canon_soup(vh, fh), canon_soup(ve, md.drop_degenerate(f_e)))
        same_ids = np.array_equal(vs_p, vs_e) and np.array_equal(f_p, f_e)
        t_err = float(np.abs(t_p - t_e).max()) if len(t_e) else 0.0
        wire = words.nbytes + t_q.nbytes + bids.nbytes
        exact_payload = (vs_e.size + t_e.size + f_e.size) * 4
        row = {"faces": len(f_e), "vertices": len(vs_e), "live_blocks": len(bids),
               "wire_bytes": wire, "exact_payload_bytes": exact_payload,
               "volume_to_host_s": t1 - t0, "host_march_s": t2 - t1,
               "device_exact_s": t3 - t2, "device_exact_event_ms": exact_ms,
               "device_packed_s": t4 - t3, "device_packed_event_ms": packed_ms,
               "decode_s": t5 - t4, "soup_equal": same_soup, "packed_ids_equal": same_ids,
               "packed_t_max_err": t_err}
        out["march_256"][name] = row
        print(f"phase 4f (a) {name} 256^3: " + json.dumps(row), flush=True)
        if not (same_soup and same_ids and t_err <= 1.0 / 65535 and len(f_e) > 1000):
            raise RuntimeError(f"phase 4f (a) {name}: the device marcher disagrees: {row}")
        del vol, host_vol

    # -- (b) the slab extractor at 512^3 against one pass over the whole volume --
    n, slab = 512, 64
    s = 2.0 / (n - 1)
    vol = sg.sparse_grid_eval(model, n, on_violation="error")
    one = md.marching_cubes_device(vol, 0.0, (s,) * 3, (-1.0,) * 3, wire="packed")
    del vol
    want = canon_mesh(*one)
    slabs = len(ge._slab_plan(n, slab))
    out["giga_512"] = {"faces": len(one[1]), "slabs": slabs}
    for k in (1, 2, 4):
        tag = f"giga/512/x{k}"
        stages = {}
        with counted(launches, tag):
            t0 = time.perf_counter()
            got = ge.extract_mesh_giga(model, n, slab=slab, wire="packed", on_violation="error",
                                       devices=None if k == 1 else (device,) * k, stages=stages)
            wall = time.perf_counter() - t0
        only_launched(launches, tag, sparse_blocks=slabs)
        same = len(got[1]) == len(one[1]) and np.array_equal(canon_mesh(*got), want)
        out["giga_512"][f"x{k}"] = {"wall_s": wall, "stages_s": stages, "identical": same}
        print(f"phase 4f (b) {tag}, slab {slab}: {slabs} sparse_blocks launches, wall {wall:.3f} s, "
              f"stages (s) {stages}; {len(got[1])} faces, identical to one pass over the 512^3 "
              f"volume: {same}", flush=True)
        if not same:
            raise RuntimeError(f"{tag}: the merged slab mesh differs from one pass")

    # -- (b2) kernel 3 at the giga route's 1024^3 shapes ------------------------
    # every slab's active blocks by global id (ids past 2^20 of 2^21) at the
    # route's shared budget k_max, as _refine_slab launches the blocks entry,
    # against its plain version on the same ids: f32 within F32_TOL; bf16
    # the mean against the exact sums and, over these millions of points (as
    # at 255^3, see BF16_TOL), the max against the kernel's own summation
    # order, the max against the exact sums printed. The coarse sweep's own
    # peak device memory is read on the way.
    n = 1024
    slab = ge.default_slab(n)
    plan = ge._slab_plan(n, slab)
    nxb = slab // 8 + 1
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    _, mask, viol = sg.coarse_and_certificate(model, n, 8, 1.5, 0.01)
    torch.cuda.synchronize()
    row = {"coarse_sweep_peak_bytes": torch.cuda.max_memory_allocated() - base,
           "violations": int(viol)}
    if row["violations"]:
        raise RuntimeError(f"phase 4f (b2): the seeded net's certificate fails at 1024: {row}")
    counts, k_max = ge._slab_budget(mask, plan, n, 8, nxb, 2)  # extract_mesh_giga's tile_blocks
    row.update(slab=slab, active_blocks=counts, k_max=k_max)
    for dt in (torch.bfloat16, torch.float32):
        tag = str(dt).split(".")[1]
        net = fm.FusedNet(model, dt)
        err = order_err = total = points = max_id = 0
        for (x0, _), count in zip(plan, counts):
            if count == 0:
                continue
            ids, count_d = ge._slab_blocks(mask, x0 // 8, nxb, n // 8, k_max)
            got = fm.fused_blocks(net, ids, count_d, n, 8)[:count]
            want = fm.fused_blocks_plain(net, ids, count_d, n, 8)[:count]
            torch.cuda.synchronize()
            if not (int(count_d) == count and torch.isfinite(got).all()):
                raise RuntimeError(f"sparse_blocks/{tag}/n1024: a non-finite output or a wrong count")
            diff = (got - want).abs()
            err, total, points = max(err, diff.max().item()), total + diff.sum().item(), points + diff.numel()
            max_id = max(max_id, int(ids[:count].max()))
            if dt == torch.bfloat16:
                order = plain_kernel_order(net, fm.block_points(ids[:count], n, 8))
                order_err = max(order_err, (got.reshape(-1) - order).abs().max().item())
            del got, want, diff
        mean = total / points
        held, limit, mean_limit = ((order_err, BF16_TOL, BF16_MEAN_TOL) if dt == torch.bfloat16
                                   else (err, F32_TOL, math.inf))
        row[tag] = {"max_abs_err": err, "mean_abs_err": mean, "points": points, "max_block_id": max_id}
        if dt == torch.bfloat16:
            row[tag]["max_abs_err_kernel_order"] = order_err
        print(f"check sparse_blocks/{tag}/n1024 ({len([c for c in counts if c])} slabs of the giga "
              f"route, {points} points, block ids up to {max_id}, k_max {k_max}): against plain "
              f"max_abs_err {err:.3e}, mean_abs_err {mean:.3e} (tolerance {mean_limit:g})"
              + (f"; against the kernel's summation order max_abs_err {order_err:.3e}"
                 if dt == torch.bfloat16 else "") + f"; held max {held:.3e} (tolerance {limit:g})",
              flush=True)
        if not (held <= limit and mean <= mean_limit):
            raise RuntimeError(f"sparse_blocks/{tag}/n1024: kernel and plain version disagree")
        checks[f"sparse_blocks/{tag}/n1024"] = err
    del mask
    out["kernel3_1024"] = row

    # -- (b3) the two wires at 1024^3, bf16: the same faces, vertices within
    # the u16 quantum; their stages side by side
    s = 2.0 / (n - 1)
    meshes = {}
    out["wires_1024"] = {}
    for w in ("exact", "packed"):
        tag, stages = f"giga/1024/{w}", {}
        torch.cuda.reset_peak_memory_stats()
        with counted(launches, tag):
            t0 = time.perf_counter()
            meshes[w] = ge.extract_mesh_giga(model, n, wire=w, on_violation="dense", stages=stages)
            wall = time.perf_counter() - t0
        only_launched(launches, tag, sparse_blocks=len(plan))
        out["wires_1024"][w] = {"wall_s": wall, "stages_s": stages, "faces": len(meshes[w][1]),
                                "max_memory_allocated": torch.cuda.max_memory_allocated()}
        print(f"phase 4f (b3) {tag}: " + json.dumps(out["wires_1024"][w]), flush=True)
    (ve, fe), (vp, fp) = meshes["exact"], meshes["packed"]
    v_err = float(np.abs(ve - vp).max()) if len(ve) == len(vp) and len(ve) else math.inf
    out["wires_1024"]["vertex_max_diff"] = v_err
    print(f"phase 4f (b3): the packed wire's faces equal the exact wire's: "
          f"{np.array_equal(fe, fp)}, vertices within {v_err:.3e} (limit {s / 65535 + 1e-12:.3e})",
          flush=True)
    if not (np.array_equal(fe, fp) and len(fe) > 1000 and v_err <= s / 65535 + 1e-12):
        raise RuntimeError("phase 4f (b3): the two wires disagree at 1024^3")
    del meshes, ve, fe, vp, fp

    # -- (c) the entry point at cubesize 1024: the giga route ------------------
    # f32: p99 |f| at the vertices under the plain f32 forward below one voxel
    # plus the f32 kernel error. bf16: the blocks entry rounds grid
    # coordinates to bf16, whose spacing for 0.5 <= |x| < 1 is 2^-8 (two
    # voxels at n = 1024); a point moves by up to 2^-9 per axis, so for a
    # unit-Lipschitz field the bound grows by sqrt(3) * 2^-9.
    cfg, stl = reconstruct_config(run_root, 1024)
    plan = ge._slab_plan(1024, ge.default_slab(1024))
    out["reconstruct_1024"] = {}
    for dt in ("float32", "bfloat16"):
        tag = f"reconstruct/1024/{dt}"
        if stl.exists():
            stl.unlink()
        torch.cuda.reset_peak_memory_stats()
        with counted(launches, tag):
            t0 = time.perf_counter()
            if cli.main([cfg, "--compute-dtype", dt]) != 0:
                raise RuntimeError(f"{tag}: the entry point failed")
            wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        stages = dict(reconstruct.LAST_STAGE_SECONDS)
        only_launched(launches, tag, sparse_blocks=len(plan))
        if list(stages) != ["load_checkpoint", "evaluate", "march", "decode", "write_stl"]:
            raise RuntimeError(f"{tag}: not the giga route's stages: {stages}")
        if not stl.exists():
            raise RuntimeError(f"{tag}: the entry point wrote no STL")
        vertices, n_faces = stl_vertices(stl, device)
        stl.unlink()
        verts = torch.as_tensor(vertices, dtype=torch.float32, device=device)
        with torch.no_grad():
            f = torch.cat([model(v).abs() for v in verts.split(1 << 20)])
        p99 = float(np.quantile(f.cpu().numpy(), 0.99))
        bound = 2.0 / 1023 + checks[f"fused_points/{dt}"]
        if dt == "bfloat16":
            bound += math.sqrt(3.0) * 2.0 ** -9
        row = {"wall_s": wall, "stages_s": stages, "faces": n_faces,
               "vertices": len(vertices), "slabs": len(plan),
               "max_memory_allocated": peak, "p99_abs_f": p99, "p99_bound": bound}
        out["reconstruct_1024"][dt] = row
        print(f"phase 4f (c) {tag}: " + json.dumps(row), flush=True)
        if not (n_faces > 1000 and torch.isfinite(verts).all() and verts.abs().max() <= 1
                and p99 < bound):
            raise RuntimeError(f"{tag}: the 1024^3 mesh fails its checks: {row}")
    report["phase_4f"] = out
    return launches


def reconstruct_config(run_root, cubesize):
    """(config path, STL path) of a reconstruction of the seeded checkpoint
    at ``cubesize``: configs/mesh_sdf.ini with its directory under
    ``run_root``, ppo and reconstruct on."""
    from sdf_representation_tpu_torch.configgen import Configuration
    from sdf_representation_tpu_torch.training import Trainer

    text = (REPO / "configs" / "mesh_sdf.ini").read_text()
    text = (text.replace("directory = ./runs/", f"directory = {run_root}/")
            .replace("ppo = False", "ppo = True").replace("reconstruct = False", "reconstruct = True")
            .replace("cubesize = 256", f"cubesize = {cubesize}"))
    path = run_root / f"mesh_sdf_{cubesize}.ini"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(text)
    trainer = Trainer(Configuration(str(path)))
    return str(path), pathlib.Path(trainer.postprocess_save_path) / "reconstructed_epoch0.stl"


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
    from sdf_representation_tpu_torch.geometry.mesh_io import save_mesh
    from sdf_representation_tpu_torch.geometry.primitives import make_icosphere
    from sdf_representation_tpu_torch.geometry.rescale import rescale_mesh
    from sdf_representation_tpu_torch.ops import fused_igr as fi
    from sdf_representation_tpu_torch.ops import fused_mlp as fm
    from sdf_representation_tpu_torch.ops import sdf_culled
    from sdf_representation_tpu_torch.ops import sdf_streams as ss
    from sdf_representation_tpu_torch.sampling import sampler
    from sdf_representation_tpu_torch.training import PointCloudTrainer, Trainer, graphs
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

    def run(tag, cfg_path, *options):
        torch.cuda.synchronize()
        fm.reset_launches()
        ss.reset_launches()
        fi.reset_launches()
        with counting_plain_calls((fm, ss, fi)) as plain:
            t0 = time.perf_counter()
            if cli.main([cfg_path, *options]) != 0:
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

    # -- sample and label -------------------------------------------------------
    wall = run("sampling", config("sampling", samplingonly=True))
    need(launches, "sampling", "dist_stream", "wind_stream")
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
    # the kernels' working type: the entry point's default bfloat16, and the
    # 256^3 audit again under --compute-dtype float32 (the split-TF32 kernels)
    for runs_before, (cubesize, dtype) in enumerate(((256, "bfloat16"), (256, "float32"), (64, "bfloat16"))):
        tag = f"audit/{cubesize}" + ("/float32" if dtype == "float32" else "")
        sdf_culled.LAST_COUNTS.clear()
        wall = run(tag, config(f"audit_{cubesize}", ppo=True, cubesize=cubesize), "--compute-dtype", dtype)
        need(launches, tag, "dist_stream", "wind_stream", "fused_grid")
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
        print(f"audit {cubesize}^3 ({dtype}): {result}, outside-fraction baseline {baseline:.4f}, "
              f"stages (s) {stages}", flush=True)
        if not (result["Resolution"] == cubesize and result["Accuracy"] > baseline
                and len(row) == 2 + runs_before and np.isfinite(last).all()):
            raise RuntimeError(f"audit {cubesize}: no better than calling every point outside")
        if cubesize == 256 and result["Accuracy"] < 0.999:
            raise RuntimeError(f"audit 256: sign accuracy {result['Accuracy']} under 0.999")
        for name in ("mismatching_co-ordinates1.csv", "classification_report2.csv"):
            if not (post / name).exists():
                raise RuntimeError(f"audit {cubesize}: {name} is missing")
        out["audit"][tag.split("/", 1)[1]] = {"wall_s": wall, "stages_s": stages, "result": result,
                                              "baseline": baseline, "culled": culled,
                                              "launches": launches[tag]}
    out["reconstruct_trained"] = {}
    for cubesize, dtype in ((256, "bfloat16"), (256, "float32"), (128, "bfloat16")):
        tag = f"reconstruct_trained/{cubesize}" + ("/float32" if dtype == "float32" else "")
        stl = post / f"reconstructed_epoch{EPOCHS - 1}.stl"
        if stl.exists():
            stl.unlink()
        wall = run(tag, config(f"rec_{cubesize}", ppo=True, reconstruct=True, cubesize=cubesize),
                   "--compute-dtype", dtype)
        if launches[tag]["sparse_blocks"] + launches[tag]["fused_grid"] < 1:
            raise RuntimeError(f"{tag}: no evaluation kernel was launched")
        vertices, n_faces = stl_vertices(stl, device)
        radii = np.linalg.norm(vertices, axis=1)
        stages = dict(reconstruct.LAST_STAGE_SECONDS)
        print(f"mesh from the trained field, {cubesize}^3 ({dtype}; launches {launches[tag]}): "
              f"{n_faces} faces, vertex radius "
              f"median {np.median(radii):.4f} (the labelled sphere: 0.85), within 0.02 of it "
              f"{np.mean(np.abs(radii - 0.85) < 0.02):.3f} of the vertices, stages (s) {stages}"
              + ("; with the host marcher (PERF.md §5): evaluate 0.200 s, march 1.657 s"
                 if cubesize == 256 else ""), flush=True)
        if ("decode" in stages) != (cubesize == 256):
            raise RuntimeError(f"{tag}: marched on the wrong side: stages {stages}")
        if n_faces < 1000 or not np.isfinite(vertices).all() \
                or np.abs(vertices).max() > 1 or abs(np.median(radii) - 0.85) > 0.1:
            raise RuntimeError(f"{tag}: the mesh is not a sphere of radius ~0.85")
        out["reconstruct_trained"][tag.split("/", 1)[1]] = {
            "wall_s": wall, "faces": n_faces, "median_radius": float(np.median(radii)),
            "stages_s": stages, "launches": launches[tag]}

    # -- 4c. the eikonal path: labelled IGRLOSS, then the point-cloud trainer ----
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
        # bfloat16 on a card, once per step each (each replay of the step's
        # graph, and the WARMUP eager steps before its capture); under the
        # default precision the fast path is the shared-matmul derivation
        # with torch autograd
        want = steps + graphs.WARMUP
        only_launched(launches, tag, **({"igr_fwd": want, "igr_bwd": want} if precision == "bfloat16" else {}))
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
        want = steps + graphs.WARMUP
        only_launched(launches, tag, **({"igr_fwd": want, "igr_bwd": want} if precision == "bfloat16" else {}))
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
        only_launched(launches, tag, fused_grid=1)
        vertices, n_faces = stl_vertices(pathlib.Path(t.postprocess_save_path)
                                         / f"reconstructed_epoch{PCD_EPOCHS - 1}.stl", device)
        radii = np.linalg.norm(vertices, axis=1)
        print(f"mesh from the point-cloud field, 128^3: {n_faces} faces, vertex radius "
              f"median {np.median(radii):.4f} (the cloud's sphere: 0.85; reported, not gated: "
              f"{PCD_EPOCHS} epochs of IGR do not make a clean surface), within 0.02 of it "
              f"{np.mean(np.abs(radii - 0.85) < 0.02):.3f} of the vertices", flush=True)
        if n_faces < 100 or not np.isfinite(vertices).all():
            raise RuntimeError(f"{tag}: no finite mesh came out")
        out["pcd"]["reconstruct_128"] = {"wall_s": wall, "faces": n_faces,
                                         "median_radius": float(np.median(radii))}
    report["pipeline"] = out
    return launches


def sphere_points(rng):
    """configs/mesh_sdf.ini's sample counts of the sphere r = 0.85 (the
    rescaled icosphere's): 100,000 uniform points and 307,200 + 307,200
    near its surface; and their labels, the exact distance and normal."""
    uniform = rng.uniform(-1, 1, (100000, 3))
    d = rng.normal(size=(614400, 3))
    near = d / np.linalg.norm(d, axis=1, keepdims=True) * (0.85 + rng.normal(0, 0.02, (614400, 1)))
    return uniform, near


def sphere_labels(x):
    r = np.linalg.norm(x, axis=1, keepdims=True)
    return np.concatenate([r - 0.85, x / r], axis=1)


def sphere_samples(rng):
    """sphere_points labelled and split 9:1 as data.dataset.load_data
    splits: an SDFDataset."""
    from sdf_representation_tpu_torch.data.dataset import SDFDataset

    x = rng.permutation(np.concatenate(sphere_points(rng)))
    y = sphere_labels(x)
    n_val = math.ceil(0.1 * len(x))
    x, y = x.astype(np.float32), y.astype(np.float32)
    return SDFDataset(x[n_val:], y[n_val:], x[:n_val], y[:n_val])


def read_loop_trace(log_dir):
    """The trace of one ``train`` call, read over its ``training_loop``
    range (the loop ends with a host read, so its device work lies inside):
    device-busy ms (the union of kernel intervals), the window, the idle
    share, kernel launches by name, the host's launches (runtime calls that
    launch a kernel, a copy, a set or a graph) and its graph launches."""
    (path,) = pathlib.Path(log_dir).glob("*.pt.trace.json")
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X" and "dur" in e]
    (loop,) = [e for e in events if e.get("cat") == "user_annotation" and e["name"] == "training_loop"]
    lo, hi = loop["ts"], loop["ts"] + loop["dur"]
    kernels = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                     if e.get("cat") == "kernel" and lo <= e["ts"] < hi)
    busy, end = 0.0, -math.inf
    for a, b, _ in kernels:
        b = min(b, hi)
        if b > end:
            busy += b - max(a, end)
            end = b
    by_name = {}
    for *_, name in kernels:
        by_name[name[:100]] = by_name.get(name[:100], 0) + 1
    calls = [e["name"] for e in events if str(e.get("cat")).startswith("cuda_")  # the CUDA API
             and lo <= e["ts"] < hi and re.match(r"cu(da)?(LaunchKernel|GraphLaunch|Memcpy|Memset)", e["name"])]
    return {"window_ms": (hi - lo) / 1e3, "device_busy_ms": busy / 1e3,
            "idle_share": 1 - busy / (hi - lo), "kernel_launches": len(kernels),
            "kernels": {k: sum(n for name, n in by_name.items() if k in name)
                        for k in ("igr_fwd_kernel", "igr_bwd_kernel", "igr_dw_kernel")},
            "host_launches": len(calls), "graph_launches": calls.count("cudaGraphLaunch"),
            "top5": sorted(by_name.items(), key=lambda kv: -kv[1])[:5]}


def graphed_resume(trainer_for, data):
    """A checkpoint the card wrote (Adam's steps and rate are device
    tensors) resumes a graphed run on the card, which then ends with the
    parameters of an uninterrupted graphed run, bit for bit; and it loads
    into the CPU's Adam (graphs.load_optimizer_state), which then steps."""
    from sdf_representation_tpu_torch.training import graphs
    from sdf_representation_tpu_torch.training import checkpoint as ckpt

    epochs = GRAPH_EPOCHS + 1
    whole = trainer_for("whole", epochs)
    whole.train(data)
    first = trainer_for("resume", epochs)
    first.config.epochs = GRAPH_EPOCHS  # the run directory names `epochs`
    first.train(data)
    state = ckpt.load_checkpoint(str(pathlib.Path(first.model_save_path) / "best_model.ckpt"))
    again = trainer_for("resume", epochs, **{"continue": "True"})
    result = again.train(data)
    equal = all(torch.equal(v, whole.model.state_dict()[k]) for k, v in again.model.state_dict().items())
    cpu = graphs.make_adam([torch.nn.Parameter(p.detach().cpu()) for p in again.model.parameters()],
                           1.0, "cpu")
    graphs.load_optimizer_state(cpu, state["optimizer"])
    group = cpu.param_groups[0]
    steps = {cpu.state[p]["step"].device.type for p in group["params"]}
    for p in group["params"]:
        p.grad = torch.ones_like(p)
    cpu.step()
    row = {"best_epoch": int(state["epoch"]), "epochs_resumed": result["epochs_run"],
           "bit_equal_params": equal, "cpu_lr": group["lr"], "cpu_steps_on": sorted(steps),
           "card_lr_saved_as": str(state["optimizer"]["param_groups"][0]["lr"].dtype)}
    if not (equal and isinstance(group["lr"], float) and steps == {"cpu"}):
        raise RuntimeError(f"phase 4c (d): resume from a card's checkpoint: {row}")
    return row


def eager_and_graphed(name, run, steps, k, fused, launches, trace_root, card):
    """One training run made eagerly and through its CUDA graphs from one
    seed, GRAPH_EPOCHS epochs: ``run(tag, epochs, eager)`` trains a fresh
    trainer (its run directory named by ``tag``) and returns (its loss
    record, its final parameters). Counts zeroed before each run: kernels
    8-9 (``fused``) launch ``k`` times a step (once per shard, or once on a
    rank's rows: k = 1), the graphed run also WARMUP steps' worth before
    its capture. Then GRAPH_TRACE_EPOCHS epochs of the graphed run (one of
    the eager run) under torch.profiler, read over the trainer's
    ``training_loop`` range: every replay holds k igr_fwd_kernel, k
    igr_bwd_kernel and k igr_dw_kernel (``fused``; a graphed trace that
    lacks some is taken again, GRAPH_TRACE_TRIES in all), and the host
    issues at most GRAPH_HOST_LAUNCHES launches a step outside the graphs.
    Losses and parameters must be bit-equal.
    Returns (the row, the graphed run's loss record and parameters); the
    row holds for both runs points/s, seconds an epoch, the device's busy
    ms an epoch and idle share traced and untraced (the traced busy time
    an epoch over the untraced seconds an epoch), host launches a step and
    the capture's seconds."""
    from sdf_representation_tpu_torch.training import graphs
    from sdf_representation_tpu_torch.training import trainer as trainer_module
    from sdf_representation_tpu_torch.utils import profiling

    row, results, states = {}, {}, {}
    run("warm", 1, True)  # one eager epoch first: neither timed run pays for a first touch
    for mode in ("eager", "graphed"):
        tag = f"graphs/{name}/{mode}"
        with counted(launches, tag):
            results[mode], states[mode] = run(mode, GRAPH_EPOCHS, mode == "eager")
        stats = dict(trainer_module.LAST_RUN)
        if stats["graphed"] != (mode == "graphed"):
            raise RuntimeError(f"{tag}: graphed is {stats['graphed']}")
        want = k * (steps * GRAPH_EPOCHS + (graphs.WARMUP if mode == "graphed" else 0))
        only_launched(launches, tag, **({"igr_fwd": want, "igr_bwd": want} if fused else {}))
        row[mode] = {"points_per_sec": stats["points_per_sec"],
                     "s_per_epoch": stats["seconds"] / GRAPH_EPOCHS,
                     "capture_s": stats["capture_s"], "launches": launches[tag]}
    row["losses"] = results
    row["bit_equal_losses"] = results["eager"] == results["graphed"]
    row["bit_equal_params"] = all(torch.equal(states["eager"][key], states["graphed"][key])
                                  for key in states["eager"])
    row["max_abs_param_diff"] = max((states["eager"][key].float() - states["graphed"][key].float())
                                    .abs().max().item() for key in states["eager"])
    # the eager run traced for one epoch: its 300-1,200 launches a step make a
    # trace whose export and reading cost seconds an epoch
    for mode, epochs in (("eager", 1), ("graphed", GRAPH_TRACE_EPOCHS)):
        log_dir = trace_root / f"trace_{name}_{mode}"
        for attempt in range(1, GRAPH_TRACE_TRIES + 1):
            shutil.rmtree(log_dir, ignore_errors=True)
            torch.cuda.synchronize()
            with profiling.trace(str(log_dir)):
                run(f"{mode}_trace{attempt}", epochs, mode == "eager")
                torch.cuda.synchronize()
            reading = read_loop_trace(log_dir)
            # torch.profiler now and then loses device events of a graph's
            # replays (PERF.md §7): a graphed trace with fewer of kernels 8-9
            # than its replays launched is taken again
            if mode == "eager" or not fused or \
                    all(n >= k * steps * epochs for n in reading["kernels"].values()):
                break
            print(f"phase 4c (d) {name}: graphed trace {attempt} of {GRAPH_TRACE_TRIES} holds "
                  f"{reading['kernels']} of {steps * epochs} replays' kernels 8-9 "
                  f"({reading['kernel_launches']} kernels)", flush=True)
        reading["attempts"] = attempt
        busy_epoch_ms = reading["device_busy_ms"] / epochs
        row[mode].update(trace=reading, idle_share_traced=reading["idle_share"],
                         idle_share_untraced=1 - busy_epoch_ms / (row[mode]["s_per_epoch"] * 1e3),
                         device_busy_ms_per_epoch=busy_epoch_ms,
                         host_launches_per_step=reading["host_launches"] / (steps * epochs))
    print(f"phase 4c (d) {name} ({card}), {steps} steps an epoch, {k} launch(es) of kernels 8-9 a "
          "step: " + json.dumps({key: v for key, v in row.items() if key != "losses"}), flush=True)
    graphed, n_steps = row["graphed"], steps * GRAPH_TRACE_EPOCHS
    if not (row["bit_equal_losses"] and row["bit_equal_params"]):
        raise RuntimeError(f"phase 4c (d) {name}: the graphed run differs from the eager one "
                           f"(max |param diff| {row['max_abs_param_diff']:.3e}): {row['losses']}")
    if fused and any(n != k * n_steps for n in graphed["trace"]["kernels"].values()):
        raise RuntimeError(f"phase 4c (d) {name}: {n_steps} replays hold kernels "
                           f"{graphed['trace']['kernels']}, not {k} of each a replay")
    if graphed["trace"]["graph_launches"] < n_steps or \
            graphed["host_launches_per_step"] > GRAPH_HOST_LAUNCHES:
        raise RuntimeError(f"phase 4c (d) {name}: {graphed['trace']['graph_launches']} graph "
                           f"launches, {graphed['host_launches_per_step']:.2f} host launches a step")
    return row, (results["graphed"], states["graphed"])


def write_sphere_csvs(data_path, rng):
    """sphere_points and their labels as the sampler writes its three CSVs
    (uniform, surface, narrow: x, y, z, S, nx, ny, nz) into data_path, for
    a run through the entry point."""
    from sdf_representation_tpu_torch.sampling.sampler import Frame

    uniform, near = sphere_points(rng)
    for name, x in (("uniform", uniform), ("surface", near[:307200]), ("narrow", near[307200:])):
        Frame(("x", "y", "z", "S", "nx", "ny", "nz"), np.concatenate([x, sphere_labels(x)], axis=1)
              ).to_csv(str(pathlib.Path(data_path) / f"{name}.csv"))


def drive_graphs(device, run_root, report):
    """Phase 4c (d): the main path's trainers at full width, each run
    eagerly (``train(eager=True)``) and through its CUDA graphs
    (training/graphs.py) from one seed (eager_and_graphed): (d) on one
    device, the supervised, labelled IGRLOSS and point-cloud trainers, the
    supervised run's checkpoint resumed (graphed_resume), and one epoch of
    every other model family; (e) the sharded steps: Trainer(mesh=card x 2)
    and x 4 (labelled IGRLOSS) and PointCloudTrainer(mesh=card x 4), each
    whole sharded step one graph, kernels 8-9 once per shard in every
    replay; then, under a process group of one rank over NCCL (phase 4j
    (a)'s), the labelled IGRLOSS run on the group's data axis, which must
    also be bit-equal to (d)'s run with no group, and supervised epochs
    of configs/mesh_sdf.ini through the entry point (graphed; its eager
    run through Trainer.train(eager=True) on the same CSVs).
    Returns the launches per run."""
    from sdf_representation_tpu_torch import cli
    from sdf_representation_tpu_torch.configgen import Configuration
    from sdf_representation_tpu_torch.data.dataset import SDFDataset
    from sdf_representation_tpu_torch.parallel.mesh import process_mesh
    from sdf_representation_tpu_torch.parallel.multihost import initialize_multihost
    from sdf_representation_tpu_torch.training import PointCloudTrainer, Trainer
    from sdf_representation_tpu_torch.training import checkpoint as ckpt
    from sdf_representation_tpu_torch.training import trainer as trainer_module

    card = report["card"]
    root = run_root / "graphs"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    rng = np.random.default_rng(SEED)
    labelled = sphere_samples(rng)
    d = rng.normal(size=(PCD_POINTS, 3))
    cloud = (0.85 * d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    base = (REPO / "configs" / "mesh_sdf.ini").read_text()
    igr_text = with_keys(base.replace("weight_factor = 0.5\n", ""), loss_function="IGRLOSS")
    pcd_text = ((REPO / "configs" / "pointcloud_igr.ini").read_text()
                + "\n[TPU]\ntrain_matmul_precision = bfloat16\n")

    def state_of(model):
        return {key: v.detach().clone() for key, v in model.state_dict().items()}

    def trainer_runs(name, text, cls, data, mesh=None):
        """(trainer_for, run) of eager_and_graphed for ``cls`` on ``data``."""
        keys = ("train_losses", "val_losses") if cls is Trainer else ("losses",)

        def trainer_for(tag, epochs, **changes):
            path = root / f"{name}_{tag}.ini"
            path.write_text(with_keys(text, directory=f"{root}/{name}_{tag}/", epochs=epochs,
                                      min_epochs=epochs, checkpointing=epochs, **changes))
            return cls(Configuration(str(path)), mesh=mesh)

        def run(tag, epochs, eager):
            t = trainer_for(tag, epochs)
            result = t.train(data, eager=eager)
            return {key: result[key] for key in keys}, state_of(t.model)

        return trainer_for, run

    out, launches = {}, {}
    # -- (d) one device -------------------------------------------------------
    for name, text, cls, data in (("supervised", base, Trainer, labelled),
                                  ("igr", igr_text, Trainer, labelled),
                                  ("pcd", pcd_text, PointCloudTrainer, cloud)):
        steps = (data.n_train if cls is Trainer else len(data)) // 16384
        trainer_for, run = trainer_runs(name, text, cls, data)
        out[name], graphed = eager_and_graphed(name, run, steps, 1, name != "supervised", launches,
                                               root, card)
        if name == "supervised":
            out[name]["resume"] = graphed_resume(trainer_for, data)
        if name == "igr":
            single_igr = graphed
    # every other model family captures too (phase 4h trains them through the
    # entry point): one epoch of each on GRAPH_FAMILY_BATCHES batches, eager
    # and graphed, the equality printed
    sub = SDFDataset(labelled.train_x[:GRAPH_FAMILY_BATCHES * 16384],
                     labelled.train_y[:GRAPH_FAMILY_BATCHES * 16384],
                     labelled.val_x[:16384], labelled.val_y[:16384])
    for name, text in (
            ("HashMLP", (REPO / "configs" / "mesh_sdf_hash.ini").read_text()),
            *((model, with_keys(base, model=model, hidden_dim=hidden, num_hidden_layers=layers))
              for model, hidden, layers in (("FeedForwardNetwork", 512, 8), ("Siren", 256, 5),
                                            ("KAN", 64, 2)))):
        row, curves, states = {}, {}, {}
        for mode in ("eager", "graphed"):
            path = root / f"{name}_{mode}.ini"
            path.write_text(with_keys(text, directory=f"{root}/{name}_{mode}/", epochs=1,
                                      min_epochs=1, checkpointing=1))
            t = Trainer(Configuration(str(path)))
            result = t.train(sub, eager=mode == "eager")
            stats = dict(trainer_module.LAST_RUN)
            curves[mode] = result["train_losses"] + result["val_losses"]
            states[mode] = state_of(t.model)
            row[mode] = {"graphed": stats["graphed"], "s_per_epoch": stats["seconds"],
                         "capture_s": stats["capture_s"], "losses": curves[mode]}
            if stats["graphed"] != (mode == "graphed") or not np.isfinite(curves[mode]).all():
                raise RuntimeError(f"phase 4c (d) {name} {mode}: {row[mode]}")
        row["bit_equal_losses"] = curves["eager"] == curves["graphed"]
        row["bit_equal_params"] = all(torch.equal(states["eager"][key], states["graphed"][key])
                                      for key in states["eager"])
        print(f"phase 4c (d) {name}, one epoch of {GRAPH_FAMILY_BATCHES} steps ({card}): "
              + json.dumps(row), flush=True)
        out[name] = row

    # -- (e) the sharded steps: the card listed k times ------------------------
    for name, text, cls, data, k in (("igr_x2", igr_text, Trainer, labelled, 2),
                                     ("igr_x4", igr_text, Trainer, labelled, 4),
                                     ("pcd_x4", pcd_text, PointCloudTrainer, cloud, 4)):
        steps = (data.n_train if cls is Trainer else len(data)) // 16384
        _, run = trainer_runs(name, text, cls, data, mesh=(device,) * k)
        out[name], _ = eager_and_graphed(name, run, steps, k, True, launches, root, card)

    # -- (e) one rank over NCCL: the group's data axis ---------------------------
    initialize_multihost(f"127.0.0.1:{free_port()}", 1, 0)
    try:
        group = process_mesh()
        steps = labelled.n_train // 16384
        _, run = trainer_runs("igr_nccl", igr_text, Trainer, labelled, mesh=group)
        out["igr_nccl"], graphed = eager_and_graphed("igr_nccl", run, steps, 1, True, launches,
                                                     root, card)
        out["igr_nccl"]["bit_equal_to_no_group"] = (
            graphed[0] == single_igr[0]
            and all(torch.equal(graphed[1][key], single_igr[1][key]) for key in single_igr[1]))
        print(f"phase 4c (e) igr_nccl: the rank's graphed run bit-equal to (d)'s graphed run with "
              f"no group: {out['igr_nccl']['bit_equal_to_no_group']}", flush=True)
        if not out["igr_nccl"]["bit_equal_to_no_group"]:
            raise RuntimeError("phase 4c (e) igr_nccl: one rank over NCCL differs from no group")

        # supervised epochs through the entry point on CSVs of the sphere
        csvs = None

        def run_sup(tag, epochs, eager):
            nonlocal csvs
            path = root / f"sup_nccl_{tag}.ini"
            path.write_text(with_keys(base, directory=f"{root}/sup_nccl_{tag}/", epochs=epochs,
                                      min_epochs=epochs, checkpointing=epochs))
            t = Trainer(Configuration(str(path)), mesh=group)
            data_path = pathlib.Path(t.data_path)
            if csvs is None:
                write_sphere_csvs(data_path, np.random.default_rng(SEED))
                csvs = [data_path / f"{n}.csv" for n in ("uniform", "surface", "narrow")]
            elif not (data_path / "uniform.csv").exists():
                for src in csvs:
                    os.link(src, data_path / src.name)
            if eager:
                t.train(eager=True)
            elif cli.main([str(path)]) != 0:
                raise RuntimeError("phase 4c (e) sup_nccl: the entry point failed")
            train_path = pathlib.Path(t.train_path)
            state = ckpt.load_checkpoint(str(train_path / "models" / "best_model.ckpt"))["model"]
            return (train_path / "train_loss.txt").read_text(), state

        n_rows = 714400
        steps = (n_rows - math.ceil(0.1 * n_rows)) // 16384
        out["sup_nccl"], _ = eager_and_graphed("sup_nccl", run_sup, steps, 1, False, launches, root,
                                               card)
    finally:
        torch.distributed.destroy_process_group()
    report["graphs"] = out
    return launches


def numpy_corner_indices(model, x):
    """(B, L, 8) corner rows of the stacked tables from numpy: float32 corner
    positions and weights as the encoder computes them, the hash in uint32
    with wraparound."""
    offs = np.array([[dx, dy, dz] for dx in (0, 1) for dy in (0, 1) for dz in (0, 1)])
    x01 = np.clip((x + np.float32(1)) * np.float32(0.5), np.float32(0), np.float32(1))
    T = model.table_size
    out = []
    for level in range(model.n_levels):
        res = model.level_resolution(level)
        p0 = np.floor(x01 * np.float32(res)).astype(np.int64)
        c = np.clip(p0[:, None, :] + offs[None], 0, res)
        if (res + 1) ** 3 <= T:
            idx = c[..., 0] * (res + 1) ** 2 + c[..., 1] * (res + 1) + c[..., 2]
        else:
            cu = c.astype(np.uint32)
            with np.errstate(over="ignore"):
                h = (cu[..., 0] * np.uint32(1)) ^ (cu[..., 1] * np.uint32(2654435761)) \
                    ^ (cu[..., 2] * np.uint32(805459861))
            idx = (h % np.uint32(T)).astype(np.int64)
        out.append(idx + level * T)
    return np.stack(out, axis=1)


def drive_families(device, run_root, report):
    """Phase 4h: (a) configs/mesh_sdf_hash.ini at its full width through the
    entry point (sample, train, audit at 256^3, reconstruct at 256^3 and on
    the giga route at 1024^3), with the separable evaluator held against the
    pointwise f32 forward, the x-slab seams and the hash against numpy;
    (b) FeedForwardNetwork, Siren and KAN at the JAX defaults on (a)'s
    samples: train, audit and reconstruct at 128^3. Counts are zeroed before
    each run and read after it; labelling and the audits must launch the
    distance and winding streams, and no run may launch kernels 1-3.
    Returns the launches per run."""
    from sdf_representation_tpu_torch import cli
    from sdf_representation_tpu_torch.configgen import Configuration
    from sdf_representation_tpu_torch.evaluations import post_process, reconstruct
    from sdf_representation_tpu_torch.geometry.mesh_io import save_mesh
    from sdf_representation_tpu_torch.geometry.primitives import make_icosphere
    from sdf_representation_tpu_torch.ops import giga_extract
    from sdf_representation_tpu_torch.ops import hash_grid_eval as hge
    from sdf_representation_tpu_torch.ops.grid_eval import evaluate_grid
    from sdf_representation_tpu_torch.sampling import sampler
    from sdf_representation_tpu_torch.training import Trainer
    from sdf_representation_tpu_torch.training import trainer as trainer_module

    card = report["card"]
    root = run_root / "families"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    save_mesh(make_icosphere(5, 0.5), str(root / "sphere.stl"))  # phase 4b's geometry
    base = with_keys((REPO / "configs" / "mesh_sdf_hash.ini").read_text(),
                     geometry=f"{root}/sphere.stl", directory=f"{root}/runs/", epochs=HASH_EPOCHS,
                     min_epochs=HASH_EPOCHS, checkpointing=HASH_EPOCHS)
    launches, out = {}, {}

    def run(tag, text, *streams):
        """The entry point on ``text`` (an INI), counts zeroed; returns
        (wall s, peak device bytes, what it printed)."""
        path = root / (tag.replace("/", "_") + ".ini")
        path.write_text(text)
        torch.cuda.reset_peak_memory_stats()
        printed = io.StringIO()
        with counted(launches, tag), contextlib.redirect_stdout(printed):
            t0 = time.perf_counter()
            if cli.main([str(path)]) != 0:
                raise RuntimeError(f"{tag}: the entry point failed")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        print(printed.getvalue(), end="", flush=True)
        peak = torch.cuda.max_memory_allocated()
        # the streams where the labels need them, and nothing else
        only_launched(launches, tag, **{k: v for k, v in launches[tag].items()
                                        if k in ("dist_stream", "wind_stream")})
        need(launches, tag, *streams)
        return wall, peak, printed.getvalue()

    # -- (a) HashMLP: sample, train, audit, reconstruct --------------------------
    wall, peak, _ = run("hash/sampling", with_keys(base, samplingonly=True),
                        "dist_stream", "wind_stream")
    out["sampling"] = {"wall_s": wall, "peak_bytes": peak,
                       "stages_s": dict(sampler.LAST_STAGE_SECONDS)}
    wall, peak, _ = run("hash/train", base)
    stats = dict(trainer_module.LAST_RUN)
    trainer = Trainer(Configuration(str(root / "hash_train.ini")))
    model = trainer.model
    curve = np.loadtxt(pathlib.Path(trainer.train_path) / "train_loss.txt")
    out["train"] = {"wall_s": wall, "peak_bytes": peak, **stats,
                    "train_loss": curve[:, 1].tolist(), "val_loss": curve[:, 2].tolist()}
    print(f"phase 4h (a) HashMLP train ({card}): 8 levels x 2^15 x 2, 3x64, batch 16384, "
          f"bfloat16, {HASH_EPOCHS} epochs: {json.dumps(out['train'])}", flush=True)
    if not (len(curve) == HASH_EPOCHS and np.isfinite(curve).all() and curve[-1, 1] < curve[0, 1]):
        raise RuntimeError(f"hash/train: the loss did not fall: {curve[:, 1]}")
    if (model.n_levels, model.table_size, model.n_features, model.num_layers, model.hidden_dim) \
            != (8, 1 << 15, 2, 3, 64):
        raise RuntimeError("hash/train: not the shipped width")
    post = pathlib.Path(trainer.postprocess_save_path)

    wall, peak, _ = run(f"hash/audit/{HASH_N}", with_keys(base, ppo=True, cubesize=HASH_N),
                        "dist_stream", "wind_stream")
    header, *rows = (post / "results.csv").read_text().splitlines()
    result = dict(zip(header.split(","), map(float, rows[-1].split(","))))
    out["audit"] = {"cubesize": HASH_N, "wall_s": wall, "peak_bytes": peak, "result": result,
                    "stages_s": dict(post_process.LAST_STAGE_SECONDS)}
    print(f"phase 4h (a) HashMLP audit {HASH_N}^3 ({card}): {json.dumps(out['audit'])}", flush=True)
    if not (result["Resolution"] == HASH_N and np.isfinite(list(result.values())).all()
            and result["Accuracy"] > 0.9):
        raise RuntimeError(f"hash/audit/{HASH_N}: {result}")

    for n in (HASH_N, GIGA_N):
        tag = f"hash/reconstruct/{n}"
        wall, peak, _ = run(tag, with_keys(base, ppo=True, reconstruct=True, cubesize=n))
        stl = post / f"reconstructed_epoch{HASH_EPOCHS - 1}.stl"
        vertices, n_faces = stl_vertices(stl, device)
        radii = np.linalg.norm(vertices, axis=1)
        row = {"wall_s": wall, "peak_bytes": peak, "faces": n_faces,
               "median_radius": float(np.median(radii)),
               "route": reconstruct.model_route(model, n),
               "stages_s": dict(reconstruct.LAST_STAGE_SECONDS)}
        stl.unlink()
        out[f"reconstruct_{n}"] = row
        print(f"phase 4h (a) HashMLP reconstruct {n}^3 ({card}): {json.dumps(row)}", flush=True)
        if row["route"] != ("giga" if n == GIGA_N else "hash") or n_faces < 1000 \
                or abs(row["median_radius"] / 0.85 - 1) > HASH_RADIUS_TOL:
            raise RuntimeError(f"{tag}: not a sphere of radius 0.85 within 1%: {row}")

    # the separable evaluator against the pointwise f32 forward
    trainer.load_model(best=False)
    rtol, atol = HASH_TOL
    with torch.no_grad():
        hge.hash_grid_eval(model, HASH_N)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sep = hge.hash_grid_eval(model, HASH_N)
        torch.cuda.synchronize()
        sep_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        pointwise = evaluate_grid(model, HASH_N)
        torch.cuda.synchronize()
        point_s = time.perf_counter() - t0
        over, err = exceeds(sep, pointwise, rtol, atol)
    out["separable"] = {"cubesize": HASH_N, "max_abs_err": err, "over_tol": over,
                        "separable_s": sep_s, "pointwise_s": point_s}
    print(f"phase 4h (a) hash_grid_eval {HASH_N}^3 against the pointwise f32 forward ({card}): "
          + json.dumps(out["separable"]), flush=True)
    if over > 0:
        raise RuntimeError(f"hash_grid_eval at {HASH_N}^3 is off the pointwise forward: {over}")
    del sep, pointwise

    # the giga route's first three x-slabs as the extractor evaluates them:
    # three planes of each against the pointwise forward, and the plane two
    # adjacent slabs share bit-equal in both
    n = GIGA_N
    plan = giga_extract._slab_plan(n, giga_extract.default_slab(n))[:3]
    planes = {}
    with torch.no_grad():
        step = torch.tensor(2.0 / (n - 1), dtype=torch.float32, device=device)
        ax = -1.0 + step * torch.arange(n, dtype=torch.float32, device=device)
        slabs = [hge.hash_grid_eval_x_slab(model, x0, sx, n) for x0, sx in plan]
        seams = [bool(torch.equal(a[-1], b[0])) for a, b in zip(slabs, slabs[1:])]
        for (x0, sx), vol in zip(plan, slabs):
            for i in (x0, x0 + sx // 2, x0 + sx - 1):
                pts = torch.stack(torch.broadcast_tensors(ax[i], ax[:, None], ax[None, :]),
                                  dim=-1).reshape(-1, 3)
                over, err = exceeds(vol[i - x0], model(pts).reshape(n, n), rtol, atol)
                planes[i] = {"max_abs_err": err, "over_tol": over}
        del slabs
    out["x_slabs"] = {"cubesize": n, "plan": plan, "seams_bit_equal": seams, "planes": planes}
    print(f"phase 4h (a) x-slabs at {n}^3 ({card}): " + json.dumps(out["x_slabs"]), flush=True)
    if len(seams) != 2 or not all(seams) or any(p["over_tol"] > 0 for p in planes.values()):
        raise RuntimeError(f"the {n}^3 x-slabs disagree: {out['x_slabs']}")

    # the corner indices of the card against numpy's uint32 hash
    x = (torch.rand(HASH_INDEX_POINTS, 3, generator=torch.Generator().manual_seed(SEED)) * 2.1
         - 1.05)
    idx, _ = model.corner_indices(x.to(device))
    want = numpy_corner_indices(model, x.numpy())
    hashed = [lv for lv in range(model.n_levels) if not model.is_dense(lv)]
    out["indices"] = {"indices": int(want.size), "hashed_levels": hashed,
                      "differ": int((idx.cpu().numpy() != want).sum())}
    print(f"phase 4h (a) corner indices against numpy's uint32 hash: {json.dumps(out['indices'])}",
          flush=True)
    if out["indices"]["differ"] or not 0 < len(hashed) < model.n_levels:
        raise RuntimeError(f"the corner indices differ from numpy's: {out['indices']}")

    # -- (b) FFN, Siren and KAN at the JAX defaults, on (a)'s samples ------------
    flagship = (REPO / "configs" / "mesh_sdf.ini").read_text()
    for name, hidden, layers in (("FeedForwardNetwork", 512, 8), ("Siren", 256, 5),
                                 ("KAN", 64, 2)):
        text = with_keys(flagship, geometry=f"{root}/sphere.stl", directory=f"{root}/runs/",
                         name="bunny_hash", model=name, hidden_dim=hidden, num_hidden_layers=layers,
                         epochs=FAMILY_EPOCHS, min_epochs=FAMILY_EPOCHS,
                         checkpointing=FAMILY_EPOCHS, cubesize=FAMILY_N)
        row = {}
        wall, peak, _ = run(f"{name}/train", text)
        stats = dict(trainer_module.LAST_RUN)
        t = Trainer(Configuration(str(root / f"{name}_train.ini")))
        curve = np.loadtxt(pathlib.Path(t.train_path) / "train_loss.txt", ndmin=2)
        row["train"] = {"wall_s": wall, "peak_bytes": peak, **stats,
                        "train_loss": curve[:, 1].tolist()}
        if not (len(curve) == FAMILY_EPOCHS and np.isfinite(curve).all()
                and curve[-1, 1] < curve[0, 1]):
            raise RuntimeError(f"{name}/train: the loss did not fall: {curve[:, 1]}")
        wall, peak, said = run(f"{name}/audit/{FAMILY_N}", with_keys(text, ppo=True),
                               "dist_stream", "wind_stream")
        tpost = pathlib.Path(t.postprocess_save_path)
        header, *rows = (tpost / "results.csv").read_text().splitlines()
        result = dict(zip(header.split(","), map(float, rows[-1].split(","))))
        row["audit"] = {"wall_s": wall, "peak_bytes": peak, "result": result,
                            "stages_s": dict(post_process.LAST_STAGE_SECONDS),
                            "quartered": "chunk OOM" in said}
        if not (result["Resolution"] == FAMILY_N and 0 <= result["Accuracy"] <= 1):
            raise RuntimeError(f"{name}/audit/{FAMILY_N}: {result}")
        wall, peak, _ = run(f"{name}/reconstruct/{FAMILY_N}",
                            with_keys(text, ppo=True, reconstruct=True))
        stl = tpost / f"reconstructed_epoch{FAMILY_EPOCHS - 1}.stl"
        faces, median = 0, math.nan
        if stl.exists():
            vertices, faces = stl_vertices(stl, device)
            median = float(np.median(np.linalg.norm(vertices, axis=1)))
        row["reconstruct"] = {"wall_s": wall, "peak_bytes": peak, "faces": faces,
                                  "median_radius": median,
                                  "stages_s": dict(reconstruct.LAST_STAGE_SECONDS)}
        print(f"phase 4h (b) {name} {hidden}x{layers} ({card}): {json.dumps(row)}", flush=True)
        out[name] = row
    report["phase_4h"] = out
    return launches


def write_msh_v41(path, points_2d):
    """A closed polygon's nodes as a gmsh ASCII v4.1 file: two entity blocks,
    the second half of the tags first (the reader sorts by tag), coordinates
    written as write_msh_polygon writes them."""
    pts = np.asarray(points_2d, np.float64)
    n, h = len(pts), len(pts) // 2
    lines = ["$MeshFormat", "4.1 0 8", "$EndMeshFormat", "$Nodes", f"2 {n} 1 {n}"]
    for tags in (range(h + 1, n + 1), range(1, h + 1)):
        lines.append(f"1 {tags[0]} 0 {len(tags)}")
        lines += [str(t) for t in tags]
        lines += [f"{pts[t - 1, 0]:.9g} {pts[t - 1, 1]:.9g} 0" for t in tags]
    lines.append("$EndNodes")
    pathlib.Path(path).write_text("\n".join(lines) + "\n")
    return str(path)


def read_trace(log_dir):
    """The Chrome trace that utils/profiling.trace wrote into log_dir: its
    window (first to last event), the device-busy time (the union of kernel
    intervals), the idle share, every device activity's union (kernels,
    copies, sets), the top 5 kernels by summed time, and the summed time of
    kernels 8-9 (igr_fwd / igr_bwd / igr_dw)."""
    (path,) = pathlib.Path(log_dir).glob("*.pt.trace.json")
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X" and "dur" in e]

    def union(intervals):
        total, end = 0.0, -math.inf
        for a, b in sorted(intervals):
            if b > end:
                total += b - max(a, end)
                end = b
        return total

    kernels = [e for e in events if e.get("cat") == "kernel"]
    device = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    start = min(e["ts"] for e in events)
    window = max(e["ts"] + e["dur"] for e in events) - start
    busy = union((e["ts"], e["ts"] + e["dur"]) for e in kernels)
    by_name = {}
    for e in kernels:
        row = by_name.setdefault(e["name"][:100], [0.0, 0])
        row[0] += e["dur"]
        row[1] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:5]
    igr = sum(e["dur"] for e in kernels if re.search(r"igr_(fwd|bwd|dw)_kernel", e["name"]))
    return {"trace_bytes": path.stat().st_size, "window_ms": window / 1e3,
            "device_busy_ms": busy / 1e3, "idle_share": 1 - busy / window if window else math.nan,
            "device_active_ms": union((e["ts"], e["ts"] + e["dur"]) for e in device) / 1e3,
            "kernel_launches": len(kernels), "distinct_kernels": len(by_name),
            "top5": [{"name": k, "ms": v[0] / 1e3, "launches": v[1],
                      "share_of_busy": v[0] / busy} for k, v in top],
            "igr_kernels_ms": igr / 1e3, "igr_share_of_busy": igr / busy if busy else 0.0,
            "igr_share_of_window": igr / window if window else 0.0}


def traced(log_dir, fn, what):
    """fn() inside utils/profiling.trace, its trace read by read_trace; a
    trace with no kernel event (or that trace refuses: NoDeviceEvents) is
    taken again, up to three times. fn() runs
    once untraced first, timed on the host clock to the card's end (what
    the trace's window costs without the profiler)."""
    from sdf_representation_tpu_torch.utils import profiling

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    untraced_ms = (time.perf_counter() - t0) * 1e3
    for attempt in range(1, 4):
        shutil.rmtree(log_dir, ignore_errors=True)
        torch.cuda.synchronize()
        try:
            with profiling.trace(str(log_dir)):
                fn()
                torch.cuda.synchronize()
        except profiling.NoDeviceEvents as exc:
            print(f"phase 4i (f) {what}: trace {attempt} of 3: {exc}", flush=True)
            continue
        reading = read_trace(log_dir)
        if reading["kernel_launches"]:
            reading.update(attempts=attempt, untraced_ms=untraced_ms)
            return reading
        print(f"phase 4i (f) {what}: trace {attempt} of 3 holds no kernel event", flush=True)
    raise RuntimeError(f"phase 4i (f) {what}: no trace of 3 holds a kernel event")


def trace_steps(run_root, data_dir):
    """Phase 4i (f), run in a process of its own: utils/profiling.trace
    around one supervised bfloat16 epoch of the flagship net
    (Trainer.train on ``data_dir``'s CSVs, phase 4b's samples) and around
    IGR_TRACE_STEPS labelled IGRLOSS steps (8x512, TRACE_BATCH points,
    bfloat16; counted once before: one launch of kernels 8 and 9 a step),
    each trace read by read_trace. Returns (traces, the counted run's
    launches)."""
    from sdf_representation_tpu_torch.configgen import Configuration
    from sdf_representation_tpu_torch.data.dataset import load_data
    from sdf_representation_tpu_torch.losses.losses import IGRLOSS
    from sdf_representation_tpu_torch.models import ImplicitNet
    from sdf_representation_tpu_torch.training import Trainer
    from sdf_representation_tpu_torch.training import trainer as trainer_module
    from sdf_representation_tpu_torch.training.trainer import make_train_step
    from sdf_representation_tpu_torch.utils import profiling
    from sdf_representation_tpu_torch.utils.device import resolve_device

    device = resolve_device()
    root = run_root / "host_tools"
    cfg_path = root / "trace_epoch.ini"
    cfg_path.write_text(with_keys((run_root / "pipeline" / "train_bfloat16.ini").read_text(),
                                  directory=f"{root}/trace_runs/", epochs=1, min_epochs=1))
    cfg = Configuration(str(cfg_path))
    dataset = load_data(data_dir, cfg)
    traces, launches = {}, {}
    epoch_trainer = Trainer(cfg)

    def epoch():  # the eager epoch (phase 4c (d) traces the graphed ones)
        with contextlib.redirect_stdout(io.StringIO()):
            epoch_trainer.train(dataset, eager=True)

    traces["supervised_epoch"] = traced(root / "trace_epoch", epoch, "supervised epoch")
    # the trainer's own clock of its last (traced) epoch: the loop, validation, checkpoint
    traces["supervised_epoch"]["trainer_epoch_s"] = trainer_module.LAST_RUN["seconds"]
    X = torch.from_numpy(dataset.train_x).to(device)
    Y = torch.from_numpy(dataset.train_y).to(device)
    steps = dataset.n_train // TRACE_BATCH  # an epoch's steps
    batches = torch.arange(steps * TRACE_BATCH, device=device).reshape(steps, TRACE_BATCH)

    igr_model = ImplicitNet(hidden_dims=(512,) * 8, skip_in=(4,), beta=100.0, radius_init=0.5,
                            generator=torch.Generator().manual_seed(SEED), device=device)
    igr_step = make_train_step(igr_model, IGRLOSS(), torch.optim.Adam(igr_model.parameters(), 1e-4),
                               "bfloat16")
    for i in range(2):  # warm-up: kernel builds and the first launches
        profiling.force(igr_step(X[batches[i]], Y[batches[i]], 0))

    def igr_steps():
        for i in range(IGR_TRACE_STEPS):
            igr_step(X[batches[i]], Y[batches[i]], 0)

    with counted(launches, "igr"):
        igr_steps()
    only_launched(launches, "igr", igr_fwd=IGR_TRACE_STEPS, igr_bwd=IGR_TRACE_STEPS)
    traces["igr_steps"] = traced(root / "trace_igr", igr_steps, "IGR steps")
    return traces, launches["igr"]


def drive_host_tools(device, run_root, report):
    """Phase 4i: the host tools on the card, counts zeroed before each run
    and read after it. (a) the sampler CLI as a subprocess and in-process;
    (b) the normal audit of phase 4b's trained f32 net on the 64^3 grid,
    tied to kernel 8's f32 mode; (c) the octree comparison on phase 4g's
    deeptrace leaves, as CSV, VTU and PVTU; (d) the multi-file sampler over
    .ply shards; (e) the 2-D .msh sampler; (f) utils/profiling.trace around
    one supervised epoch and 10 labelled IGRLOSS steps (bfloat16) in a
    process of its own (trace_steps), each trace read there by read_trace.
    Returns the launches per run."""
    from sdf_representation_tpu_torch.configgen import Configuration
    from sdf_representation_tpu_torch.evaluations import compare_octree_dl as octree
    from sdf_representation_tpu_torch.evaluations.normal_comparison import compute_normal_for_model
    from sdf_representation_tpu_torch.geometry import msh_io
    from sdf_representation_tpu_torch.geometry.mesh_io import save_mesh
    from sdf_representation_tpu_torch.geometry.primitives import make_icosphere
    from sdf_representation_tpu_torch.geometry.rescale import rescale_mesh
    from sdf_representation_tpu_torch.ops import fused_igr as fi
    from sdf_representation_tpu_torch.ops import fused_mlp as fm
    from sdf_representation_tpu_torch.ops.diffops import sdf_and_gradient
    from sdf_representation_tpu_torch.sampling import distributed, sampler, sampler2d
    from sdf_representation_tpu_torch.sampling.__main__ import main as sampling_main
    from sdf_representation_tpu_torch.training import Trainer
    from sdf_representation_tpu_torch.utils.device import matmul_precision

    card = report["card"]
    torch.cuda.empty_cache()  # the earlier phases' cached blocks: room for (a)'s subprocess
    root = run_root / "host_tools"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    launches, out = {}, {}
    t_phase = time.perf_counter()
    # phase 4b's geometry as its trainer rescales it (configs/mesh_sdf.ini: rescale = True)
    sphere = rescale_mesh(make_icosphere(5, 0.5))
    radius = float(np.median(np.linalg.norm(sphere.vertices, axis=1)))
    stl = root / "sphere.stl"
    save_mesh(sphere, str(stl))

    # -- (a) the sampler CLI ------------------------------------------------------
    n_uni, n_surf, n_narrow, width = CLI_SIZES
    args = [str(stl), "--num_uniform", str(n_uni), "--num_surface", str(n_surf),
            "--num_narrow_band", str(n_narrow), "--dense_width", str(width)]
    sub_dir, own_dir = root / "cli_subprocess", root / "cli_in_process"
    sub_dir.mkdir()
    own_dir.mkdir()
    # the subprocess runs while the same command runs in this process, whose
    # launches are counted
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-m", "sdf_representation_tpu_torch.sampling", *args,
                             "--out", str(sub_dir)], cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        with counted(launches, "host_tools/sampling_cli"), contextlib.redirect_stdout(io.StringIO()):
            t1 = time.perf_counter()
            if sampling_main([*args, "--out", str(own_dir)]) != 0:
                raise RuntimeError("the sampler CLI failed in-process")
            own_wall = time.perf_counter() - t1
        _, err_text = proc.communicate(timeout=600)
        sub_wall = time.perf_counter() - t0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if proc.returncode != 0:
        raise RuntimeError(f"the sampler CLI failed ({proc.returncode}): {err_text[-2000:]}")
    only_launched(launches, "host_tools/sampling_cli", dist_stream=3, wind_stream=3)
    stages = {k: sampler.LAST_STAGE_SECONDS[k] for k in ("sample", "label")}
    frames = sampler.generate_signed_distance_data(str(stl), n_uni, n_surf, n_narrow, width,
                                                   device=device)
    rows = {}
    for name, frame in zip(("uniform", "surface", "narrow"), frames):
        text = (sub_dir / f"{name}.csv").read_text()
        if text != (own_dir / f"{name}.csv").read_text():
            raise RuntimeError(f"sampler CLI: {name}.csv differs between the two runs")
        header = text[:text.index("\n")]
        if header != ",".join(sampler.COLUMNS):
            raise RuntimeError(f"sampler CLI: {name}.csv's header is {header!r} (an index column?)")
        values = np.loadtxt(sub_dir / f"{name}.csv", delimiter=",", skiprows=1, ndmin=2)
        if not np.array_equal(values, frame.values):
            raise RuntimeError(f"sampler CLI: {name}.csv is not generate_signed_distance_data's")
        rows[name] = len(values)
    labels = np.concatenate([f.values for f in frames])
    r = np.linalg.norm(labels[:, :3], axis=1)
    # 0.01 off the sphere (phase 4g (b)), beyond the facets' sag
    sag = radius - np.linalg.norm(sphere.vertices[sphere.faces].mean(axis=1), axis=1).min()
    clear = np.abs(r - radius) > 0.01 + sag
    wrong = int(np.sum(np.sign(labels[clear, 3]) != np.sign(r[clear] - radius)))
    out["sampling_cli"] = {"subprocess_wall_s": sub_wall, "in_process_wall_s": own_wall,
                           "in_process_stages_s": stages, "rows": rows,
                           "signs_checked": int(clear.sum()), "signs_wrong": wrong}
    print(f"phase 4i (a) sampler CLI ({card}): {json.dumps(out['sampling_cli'])}", flush=True)
    n_faces = len(sphere.faces)
    if rows != {"uniform": n_uni, "surface": n_faces * n_surf, "narrow": n_faces * n_narrow} or wrong:
        raise RuntimeError(f"sampler CLI: wrong rows or signs: {out['sampling_cli']}")

    # -- (b) the normal audit of the trained f32 net -------------------------------
    trained = Trainer(Configuration(str(run_root / "pipeline" / "train_float32.ini")))
    trained.load_model(best=True)
    model = trained.model
    normal_dir = root / "normals"
    normal_dir.mkdir()
    save_mesh(sphere, str(normal_dir / "sphere.stl"))
    ax = np.linspace(-1, 1, NORMAL_GRID)
    grid = np.stack(np.meshgrid(ax, ax, ax, indexing="ij"), axis=-1).reshape(-1, 3)
    sampler.Frame(("x", "y", "z"), grid).to_csv(str(normal_dir / "nodes_coordinates.csv"))
    printed = io.StringIO()
    with counted(launches, "host_tools/normal_audit"), contextlib.redirect_stdout(printed):
        t0 = time.perf_counter()
        stats = compute_normal_for_model(model, str(normal_dir))
        wall = time.perf_counter() - t0
    print(printed.getvalue(), end="", flush=True)
    only_launched(launches, "host_tools/normal_audit", dist_stream=1, wind_stream=1)
    files = ("exact_wf.csv", "computed.csv", "error_points.csv", "similarity_points.csv",
             "similarity.csv")
    missing = [f for f in files if not (normal_dir / f).exists()]
    truth = np.loadtxt(normal_dir / "exact_wf.csv", delimiter=",", skiprows=1)
    sim = np.loadtxt(normal_dir / "similarity_points.csv", delimiter=",", skiprows=1)
    err = np.loadtxt(normal_dir / "error_points.csv", delimiter=",", skiprows=1)
    band = np.abs(truth[:, 4]) < 0.1
    band_rmse = float(np.sqrt(np.mean(err[band, 4] ** 2)))
    band_cos = float(np.mean(sim[band, 4]))
    # the tool's (f, grad f) on its first points against kernel 8 in f32
    head = np.loadtxt(normal_dir / "computed.csv", delimiter=",", skiprows=1,
                      max_rows=NORMAL_KERNEL_POINTS)
    x = torch.from_numpy(grid[:NORMAL_KERNEL_POINTS].astype(np.float32)).to(device)
    f_k, g_k = fi.fused_value_and_grad(fm.FusedNet(model, torch.float32), x)
    torch.cuda.synchronize()
    df = float(np.abs(f_k.cpu().numpy() - head[:, 4]).max())
    dg = float(np.abs(g_k.cpu().numpy() - head[:, 5:8]).max())
    with matmul_precision("highest"):  # the tool's call on the same points alone
        f_a, g_a = sdf_and_gradient(model, x)
    df_alone = float((f_a.detach() - f_k).abs().max())
    dg_alone = float((g_a.detach() - g_k).abs().max())
    out["normal_audit"] = {
        "wall_s": wall, "points": len(grid), **stats, "band_points": int(band.sum()),
        "band_rmse": band_rmse, "band_cos_mean": band_cos, "missing_files": missing,
        "kernel8_f32_vs_tool": {"points": NORMAL_KERNEL_POINTS, "f_max_abs_diff": df,
                                "grad_max_abs_diff": dg, "f_vs_autograd_alone": df_alone,
                                "grad_vs_autograd_alone": dg_alone}}
    print(f"phase 4i (b) normal audit of the trained 8x512 net on {NORMAL_GRID}^3 ({card}): "
          f"rmse {stats['rmse']:.4e} (limit {NORMAL_RMSE_MAX}), cos_mean {stats['cos_mean']:.5f} "
          f"(limit {NORMAL_COS_MIN}); |S| < 0.1: rmse {band_rmse:.4e} (limit {NORMAL_BAND_RMSE_MAX}), "
          f"cos_mean {band_cos:.5f} (limit {NORMAL_BAND_COS_MIN}); " + json.dumps(out["normal_audit"]),
          flush=True)
    if missing or not (np.isfinite([stats["rmse"], stats["cos_mean"]]).all()
                       and stats["rmse"] <= NORMAL_RMSE_MAX and stats["cos_mean"] >= NORMAL_COS_MIN
                       and band_rmse <= NORMAL_BAND_RMSE_MAX and band_cos >= NORMAL_BAND_COS_MIN):
        raise RuntimeError(f"normal audit: over its limits or files missing: {out['normal_audit']}")
    if not (df <= F32_TOL and dg <= F32_TOL):
        raise RuntimeError(f"normal audit: kernel 8 (f32) and the tool's autograd disagree: "
                           f"f {df:.3e}, grad f {dg:.3e} (limit {F32_TOL})")

    # -- (c) the octree comparison on deeptrace's leaves ---------------------------
    leaves = run_root / "export" / "deeptrace" / "points.csv"
    octree_dir = root / "octree"
    octree_dir.mkdir()
    with counted(launches, "host_tools/octree_compare"):
        t0 = time.perf_counter()
        got = octree.compare_octree_dl(model, str(leaves), out_csv=str(octree_dir / "csv.csv"))
        wall = time.perf_counter() - t0
    only_launched(launches, "host_tools/octree_compare")
    table = np.loadtxt(octree_dir / "csv.csv", delimiter=",", skiprows=1, ndmin=2)
    header = (octree_dir / "csv.csv").read_text().split("\n", 1)[0]
    if header != "x,y,z,model_sdf,octree_sdf,error":
        raise RuntimeError(f"octree compare: the CSV's header is {header!r}")
    err = within(table[:, 3], table[:, 4], NATIVE_VALUE_TOL, "octree compare")
    margin = NATIVE_VALUE_TOL[1] + NATIVE_VALUE_TOL[0] * np.abs(table[:, 4])
    clear = np.abs(table[:, 4]) > margin
    signs = float(np.mean((table[clear, 3] < 0) == (table[clear, 4] < 0)))
    pts, stored = octree.load_octree_nodes(str(leaves))
    pieces = np.array_split(np.arange(len(pts)), 2)

    def vtu(path, idx):
        body = "\n".join(f"{a:.17g} {b:.17g} {c:.17g}" for a, b, c in pts[idx])
        scal = " ".join(f"{v:.17g}" for v in stored[idx])
        path.write_text(
            f'<VTKFile type="UnstructuredGrid"><UnstructuredGrid><Piece NumberOfPoints="{len(idx)}">'
            f'<Points><DataArray NumberOfComponents="3" format="ascii">\n{body}\n</DataArray></Points>'
            f'<PointData><DataArray Name="sdf" format="ascii">{scal}</DataArray></PointData>'
            "</Piece></UnstructuredGrid></VTKFile>")

    vtu(octree_dir / "all.vtu", np.arange(len(pts)))
    for k, idx in enumerate(pieces):
        vtu(octree_dir / f"piece{k}.vtu", idx)
    (octree_dir / "all.pvtu").write_text(
        '<VTKFile type="PUnstructuredGrid"><PUnstructuredGrid>'
        '<Piece Source="piece0.vtu"/><Piece Source="piece1.vtu"/></PUnstructuredGrid></VTKFile>')
    same = {ext: octree.compare_octree_dl(model, str(octree_dir / f"all.{ext}")) == got
            for ext in ("vtu", "pvtu")}
    out["octree_compare"] = {"wall_s": wall, **got, "max_abs_err_within_tol": err,
                             "sign_agreement_outside_margin": signs, "points_outside_margin":
                             int(clear.sum()), "vtu_pvtu_equal": same}
    print(f"phase 4i (c) octree compare on deeptrace's leaves ({card}): "
          + json.dumps(out["octree_compare"]), flush=True)
    if not (signs == 1.0 and all(same.values()) and got["n_nodes"] == len(table)):
        raise RuntimeError(f"octree compare: {out['octree_compare']}")

    # -- (d) the multi-file sampler ------------------------------------------------
    geo = root / "shards"
    for k in range(SHARDS):
        sub = geo / f"part{k % 3}"
        sub.mkdir(parents=True, exist_ok=True)
        shard = make_icosphere(5, 0.2 + 0.1 * k)
        save_mesh(shard, str(sub / f"sphere{k}.ply"))
    per = len(shard.vertices) + len(shard.faces)  # the vertices, one surface point a triangle
    (geo / "part0" / "corrupt.ply").write_text("ply\nformat ascii 1.0\nelement vertex 9\nend_header\n1\n")
    dist_dir = root / "distributed"
    timings = {}

    def sample(tag, save, **kw):
        printed = io.StringIO()
        with counted(launches, f"host_tools/distributed/{tag}"), contextlib.redirect_stdout(printed):
            t0 = time.perf_counter()
            csv = distributed.write_signed_distance_distributed(str(geo), str(save),
                                                                num_points_surface=1, **kw)
            timings[tag] = time.perf_counter() - t0
        only_launched(launches, f"host_tools/distributed/{tag}")
        return pathlib.Path(csv), printed.getvalue()

    csv, said = sample("first", dist_dir)
    lines = csv.read_text().splitlines()
    if len(lines) != 1 + SHARDS * per or "skipping corrupt mesh" not in said:
        raise RuntimeError(f"distributed: {len(lines) - 1} rows, not {SHARDS * per}")
    size = csv.stat().st_size
    sample("again", dist_dir)
    if csv.stat().st_size != size:
        raise RuntimeError("distributed: a second call appended rows")
    save_mesh(make_icosphere(5, 0.95), str(geo / "part1" / "sphere_new.ply"))
    sample("new_shard", dist_dir)
    added = csv.read_text().splitlines()[len(lines):]
    if len(added) != per or not added[0].startswith("0,") or csv.read_text()[:size] != "\n".join(lines) + "\n":
        raise RuntimeError(f"distributed: the new shard appended {len(added)} rows, not {per}")
    journals = []
    for host in (0, 1):
        sample(f"host{host}_of_2", root / f"distributed_host{host}", host_id=host, num_hosts=2)
        journals.append(set((root / f"distributed_host{host}" / "processed_files.log")
                            .read_text().split()))
    everything = {str(p.relative_to(geo)) for p in geo.rglob("*.ply")}
    out["distributed"] = {"shards": SHARDS + 1, "rows": len(lines) - 1 + len(added),
                          "seconds": timings, "host_files": [len(j) for j in journals],
                          "min_max": distributed.compute_min_max(str(geo))}
    print(f"phase 4i (d) multi-file sampler over {SHARDS} icosphere(5) shards + 1 corrupt + 1 "
          f"added: {json.dumps(out['distributed'])}", flush=True)
    if journals[0] & journals[1] or journals[0] | journals[1] != everything:
        raise RuntimeError(f"distributed: the hosts' journals {journals} do not split {everything}")

    # -- (e) the 2-D .msh sampler ---------------------------------------------------
    th = np.linspace(0, 2 * np.pi, POLYGON_SIDES, endpoint=False)
    rr = 0.6 * (1 + 0.2 * np.sin(5 * th))
    poly = np.column_stack([rr * np.cos(th), rr * np.sin(th)])
    v22 = msh_io.write_msh_polygon(str(root / "poly_v22.msh"), poly)
    v41 = write_msh_v41(root / "poly_v41.msh", poly)
    two_d = {}
    for tag, path in (("v22", v22), ("v41", v41)):
        save = root / f"two_d_{tag}"
        save.mkdir()
        t0 = time.perf_counter()
        two_d[tag] = sampler2d.generate_signed_distance_2D_msh(20000, 5000, 5000, 0.1, path,
                                                               save_path=str(save))
        timings[f"2d_{tag}"] = time.perf_counter() - t0
    uni, narrow, surf = two_d["v22"]
    equal = all(np.array_equal(a.values, b.values) for a, b in zip(two_d["v22"], two_d["v41"]))
    out["msh_2d"] = {"seconds": {k: v for k, v in timings.items() if k.startswith("2d")},
                     "frames_equal": equal, "surface_max_abs_S": float(np.abs(surf["S"]).max()),
                     "narrow_max_abs_S": float(np.abs(narrow["S"]).max()),
                     "uniform_inside": float(np.mean(uni["S"] < 0))}
    print(f"phase 4i (e) 2-D .msh sampler, a {POLYGON_SIDES}-gon: {json.dumps(out['msh_2d'])}",
          flush=True)
    if not (equal and out["msh_2d"]["surface_max_abs_S"] <= 1e-9
            and out["msh_2d"]["narrow_max_abs_S"] <= 0.1 + 1e-12):
        raise RuntimeError(f"2-D .msh sampler: {out['msh_2d']}")

    # -- (f) traces: one supervised epoch, 10 labelled IGRLOSS steps (bfloat16) ---
    # in a process of their own: after these two traces, torch.profiler's
    # later traces in the same process held no device event (kernels_per_call,
    # phase 5: three tries of three, in this script's first run with them)
    code = ("import json, pathlib, chip_smoke\n"
            f"out = chip_smoke.trace_steps(pathlib.Path({str(run_root)!r}), {str(own_dir)!r})\n"
            "print('TRACE_STEPS ' + json.dumps(out))\n")
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=600)
    if res.returncode != 0:
        raise RuntimeError(f"phase 4i (f) failed ({res.returncode}): {res.stderr[-3000:]}")
    (line,) = [ln for ln in res.stdout.splitlines() if ln.startswith("TRACE_STEPS ")]
    traces, child_launches = json.loads(line[len("TRACE_STEPS "):])
    launches["host_tools/igr_trace_warm"] = child_launches
    timings["trace_process"] = time.perf_counter() - t0
    for tag, reading in traces.items():
        print(f"phase 4i (f) trace of the {tag.replace('_', ' ')} ({card}): window "
              f"{reading['window_ms']:.3f} ms (untraced {reading['untraced_ms']:.3f}), device busy "
              f"{reading['device_busy_ms']:.3f} ms, idle share {reading['idle_share']:.4f}, "
              f"{reading['kernel_launches']} kernel launches; top 5: " + json.dumps(reading["top5"])
              + f"; kernels 8-9 {reading['igr_kernels_ms']:.3f} ms ({reading['igr_share_of_busy']:.4f} "
              "of busy)", flush=True)
    print(f"phase 4i (f) the process {timings['trace_process']:.1f} s", flush=True)
    if not traces["igr_steps"]["igr_kernels_ms"] > 0:
        raise RuntimeError("phase 4i (f): the IGR trace holds no igr_* kernel")
    out["traces"] = traces
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"phase 4i: {out['phase_s']:.1f} s", flush=True)
    report["host_tools"] = out
    return launches


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_ranks(work, tag, specs):
    """One process per spec, ``python3 chip_smoke.py --rank R --spec FILE``,
    its output to work/<tag>_rank<R>.log."""
    procs = []
    for rank, spec in enumerate(specs):
        spec_path = work / f"{tag}_rank{rank}.json"
        spec_path.write_text(json.dumps(spec))
        log_path = work / f"{tag}_rank{rank}.log"
        log = open(log_path, "w")
        procs.append((subprocess.Popen([sys.executable, str(REPO / "chip_smoke.py"), "--rank",
                                        str(rank), "--spec", str(spec_path)], cwd=str(REPO),
                                       stdout=log, stderr=subprocess.STDOUT), log, log_path))
    return tag, procs, time.perf_counter()


def finish_ranks(handle, timeout):
    """Every rank's result line. Raises if the set outlives ``timeout`` (a
    hung collective: every rank is killed first) or a rank exits non-zero."""
    tag, procs, t0 = handle
    hung = False
    try:
        for p, _, _ in procs:
            p.wait(timeout=max(0.1, timeout - (time.perf_counter() - t0)))
    except subprocess.TimeoutExpired:
        hung = True
    finally:
        for p, log, _ in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    texts = [path.read_text() for _, _, path in procs]
    if hung:
        raise RuntimeError(f"{tag}: the ranks did not finish within {timeout} s (a hung "
                           f"collective?); rank 0's output ends:\n{texts[0][-2000:]}")
    results = []
    for rank, ((p, _, _), text) in enumerate(zip(procs, texts)):
        if p.returncode != 0:
            raise RuntimeError(f"{tag}: rank {rank} exited {p.returncode}:\n{text[-3000:]}")
        lines = [ln for ln in text.splitlines() if ln.startswith(MH_RESULT)]
        if not lines:
            raise RuntimeError(f"{tag}: rank {rank} printed no result")
        results.append(json.loads(lines[-1][len(MH_RESULT):]))
    return results


def param_checksum(state):
    import hashlib

    h = hashlib.sha256()
    for key in sorted(state):
        h.update(state[key].detach().cpu().contiguous().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def param_distance(a, b, init):
    """||a - b|| over ||b - init||, every tensor of the state dicts at once."""
    num = sum(float(((a[k].double() - b[k].double()) ** 2).sum()) for k in b)
    den = sum(float(((b[k].double() - init[k].double()) ** 2).sum()) for k in b)
    return math.sqrt(num / den)


def time_rank_steps(mesh, pcd_config):
    """Per-rank times under the group: the labelled IGRLOSS step (8x512,
    16,384 points) and the point-cloud step (8x256, 16,384 + 5,461 points),
    bfloat16, each as the trainers make it; host clock around a
    synchronized step, the ranks started together at a barrier. Then the
    same steps with every all_reduce synchronized and timed (its share), and
    kernels 8-9 alone on this rank's rows (CUDA events)."""
    import torch.distributed as dist

    from sdf_representation_tpu_torch.configgen import Configuration
    from sdf_representation_tpu_torch.losses.losses import IGRLOSS
    from sdf_representation_tpu_torch.models import ImplicitNet
    from sdf_representation_tpu_torch.ops import fused_igr as fi
    from sdf_representation_tpu_torch.ops import fused_mlp as fm
    from sdf_representation_tpu_torch.training import PointCloudTrainer
    from sdf_representation_tpu_torch.training.trainer import make_train_step

    dev = mesh.device
    gen = torch.Generator().manual_seed(SEED)
    x = (torch.rand(16384, 3, generator=gen) * 2 - 1).to(dev)
    r = x.norm(dim=1, keepdim=True)
    y = torch.cat([r - 0.85, x / r], dim=1)
    model = ImplicitNet(hidden_dims=(512,) * 8, skip_in=(4,), beta=100.0, radius_init=0.5,
                        generator=torch.Generator().manual_seed(SEED), device=dev)
    igr_step = make_train_step(model, IGRLOSS(), torch.optim.Adam(model.parameters(), lr=1e-4),
                               "bfloat16", mesh=mesh)
    pcd = PointCloudTrainer(Configuration(pcd_config), mesh=mesh)
    pcd_step = pcd._make_step(torch.optim.Adam(pcd.model.parameters(), lr=1e-4), 16384)
    cloud = torch.randn(16384, 3, generator=gen)
    cloud = (0.85 * cloud / cloud.norm(dim=1, keepdim=True)).to(dev)
    step_gen = torch.Generator(device=dev).manual_seed(SEED)

    def host_ms(fn, reps=10):
        dist.barrier()
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(times))

    spent = []
    real_all_reduce = dist.all_reduce

    def timed_all_reduce(tensor, *args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_all_reduce(tensor, *args, **kwargs)
        torch.cuda.synchronize()
        spent.append((time.perf_counter() - t0) * 1e3)
        return out

    out = {}
    for name, step, net_model, n_rows in (
            ("igr_step_8x512_n16384", lambda: igr_step(x, y, 0), model, 16384),
            ("pcd_step_8x256_n16384", lambda: pcd_step(cloud, step_gen), pcd.model, 16384 // 3)):
        step_ms = host_ms(step)
        dist.all_reduce = timed_all_reduce
        try:
            spent.clear()
            traced_ms = host_ms(step)
            calls = len(spent) // 11  # the warm-up step and ten timed ones
            reduce_ms = sum(spent[-10 * calls:]) / 10
        finally:
            dist.all_reduce = real_all_reduce
        start, stop = mesh.rows(n_rows)
        g = torch.Generator(device=dev).manual_seed(SEED)
        xs = (torch.rand(n_rows, 3, generator=g, device=dev) * 2 - 1)[start:stop]
        a = torch.randn(n_rows, generator=g, device=dev)[start:stop] / n_rows
        c = torch.randn(n_rows, 3, generator=g, device=dev)[start:stop] / n_rows
        net = fm.FusedNet(net_model, torch.bfloat16)
        dist.barrier()
        kernel_ms = timed(lambda: (fi.fused_value_and_grad(net, xs), fi.fused_param_grads(net, xs, a, c)), 10)
        out[name] = {"step_ms": step_ms, "step_ms_with_reduce_timed": traced_ms,
                     "all_reduce_calls": calls, "all_reduce_ms": reduce_ms,
                     "all_reduce_share": reduce_ms / traced_ms, "rank_rows": stop - start,
                     "kernels_8_9_ms": kernel_ms, "kernels_8_9_share": kernel_ms / step_ms}
    return out


def rank_main(argv):
    """One rank of phase 4j, spawned by drive_multihost: join the group the
    spec names, drive its runs through the trainers and the entry point
    (launch counts zeroed before each run), save each run's parameters,
    time the steps, print one result line."""
    import argparse

    import torch.distributed as dist

    from sdf_representation_tpu_torch.parallel.multihost import initialize_multihost

    parser = argparse.ArgumentParser()
    parser.add_argument("--rank", type=int, required=True)
    parser.add_argument("--spec", required=True)
    args = parser.parse_args(argv)
    spec = json.loads(pathlib.Path(args.spec).read_text())
    initialize_multihost(spec["addr"], spec["world"], args.rank, backend=spec.get("backend"),
                         device=spec.get("device"))
    if spec.get("fault"):  # the controls: one rank exits or hangs, the others wait for it
        if spec["fault"] == "exit":
            os._exit(3)
        if spec["fault"] == "hang":
            time.sleep(3600)
        dist.barrier()
        return 0

    from sdf_representation_tpu_torch import cli
    from sdf_representation_tpu_torch.configgen import Configuration
    from sdf_representation_tpu_torch.parallel.mesh import process_mesh
    from sdf_representation_tpu_torch.training import PointCloudTrainer, Trainer
    from sdf_representation_tpu_torch.training import trainer as trainer_module

    mesh = process_mesh()
    work = pathlib.Path(spec["work"])
    out = {"rank": mesh.rank, "world": mesh.size, "backend": dist.get_backend(),
           "device": str(mesh.device), "card": torch.cuda.get_device_name(mesh.device)}
    print(f"rank {mesh.rank} of {mesh.size}: backend {out['backend']}, device {out['device']}",
          flush=True)
    launches = {}
    for name, kind, cfg in spec["runs"]:
        t0 = time.perf_counter()
        with counted(launches, name):
            if kind == "cli":
                if cli.main([cfg]) != 0:
                    raise RuntimeError(f"{name}: the entry point failed")
                row = {}
            else:
                trainer = (Trainer if kind == "igr" else PointCloudTrainer)(Configuration(cfg),
                                                                          mesh=mesh)
                result = trainer.train()
                state = {k: v.detach().cpu().clone() for k, v in trainer.model.state_dict().items()}
                torch.save(state, work / f"{name}_rank{mesh.rank}.pt")
                row = {"train_loss": result.get("train_losses", result.get("losses")),
                       "val_loss": result.get("val_losses"), "checksum": param_checksum(state)}
        row.update(wall_s=time.perf_counter() - t0, launches=launches[name],
                   **dict(trainer_module.LAST_RUN))
        print(f"rank {mesh.rank} {name}: " + json.dumps(row), flush=True)
        out[name] = row
    out["times"] = time_rank_steps(mesh, spec["pcd_config"])
    print(f"rank {mesh.rank} times (ms): {json.dumps(out['times'])}", flush=True)
    dist.barrier()
    dist.destroy_process_group()
    print(MH_RESULT + json.dumps(out), flush=True)
    return 0


def drive_multihost(device, run_root, igr_x2, report):
    """Phase 4j: one process per card over torch.distributed, the ranks
    spawned with a fixed timeout. (a) NCCL, one rank: the labelled IGRLOSS
    run and one supervised epoch through the entry point, bit-equal to the
    same runs with no group (made here first). (b) gloo, two ranks on the
    one card: the point-cloud run, the labelled IGRLOSS run (ranks bit-equal
    to each other; losses and parameters against the one-process mesh of
    two: MH_LOSS_RTOL, MH_PARAM_RATIO) and one supervised epoch in per-rank
    directories, only rank 0's receiving files. (c) Controls, on the CPU:
    a set with a rank that exits and one with a rank that hangs must fail.
    Returns the launches per rank and run."""
    t_phase = time.perf_counter()
    root = run_root / "pipeline"
    work = run_root / "multihost"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    data_root = root / "float32" / "r_sphere"
    configs = {}

    def config(name, base, labelled=True, **keys):
        """``base`` with its directory under work/<name>/ (the labelled CSVs
        hard-linked in) and ``keys`` changed."""
        if labelled:
            shutil.copytree(data_root, work / name / data_root.name, copy_function=os.link,
                            ignore=shutil.ignore_patterns("ImplicitNet*", "info.txt"))
        path = work / f"{name}.ini"
        path.write_text(with_keys((root / base).read_text(), directory=f"{work / name}/", **keys))
        configs[name] = str(path)
        return str(path)

    igr = dict(epochs=DP_IGR_EPOCHS, min_epochs=DP_IGR_EPOCHS, checkpointing=DP_IGR_EPOCHS)
    pcd = dict(epochs=MH_PCD_EPOCHS, min_epochs=MH_PCD_EPOCHS)
    sup = dict(epochs=1, min_epochs=1, checkpointing=1)
    for prefix in ("ref", "nccl", "gloo"):
        config(f"{prefix}_igr", "igr_bfloat16.ini", **igr)
    for prefix in ("ref", "ref_x2", "gloo"):
        config(f"{prefix}_pcd", "pcd_bfloat16.ini", labelled=False, **pcd)
    for name in ("ref_sup", "nccl_sup", "gloo_sup_rank0", "gloo_sup_rank1"):
        config(name, "train_bfloat16.ini", **sup)
    sup_dirs = [work / f"gloo_sup_rank{r}" for r in range(2)]
    sup_files = [files_under(d) for d in sup_dirs]

    # (c) the controls start first, on the CPU, and run beside the rest
    controls = [start_ranks(work, f"control_{fault}", [
        {"addr": f"127.0.0.1:{port}", "world": 2, "device": "cpu"},
        {"addr": f"127.0.0.1:{port}", "world": 2, "device": "cpu", "fault": fault}])
        for fault, port in (("exit", free_port()), ("hang", free_port()))]
    try:
        out = multihost_runs(device, work, configs, igr_x2, report)
    finally:
        failed = {}
        for handle in controls:
            try:
                finish_ranks(handle, MH_CONTROL_TIMEOUT)
            except RuntimeError as exc:
                failed[handle[0]] = str(exc).splitlines()[0]
    for handle in controls:
        if handle[0] not in failed:
            raise RuntimeError(f"phase 4j (c) {handle[0]}: a failing rank did not fail the set")
        print(f"phase 4j (c) {handle[0]}: the set fails as it must: {failed[handle[0]]}", flush=True)
    out["controls"] = failed

    gained = [sorted(set(files_under(d)) - set(before)) for d, before in zip(sup_dirs, sup_files)]
    print(f"phase 4j (b) supervised epoch through the entry point in per-rank directories: rank 0 "
          f"gained {[p.name for p in gained[0]]}, rank 1 {[p.name for p in gained[1]]}", flush=True)
    if gained[1] or not {"train_loss.txt", "best_model.ckpt"} <= {p.name for p in gained[0]}:
        raise RuntimeError("phase 4j (b): a rank other than 0 wrote files, or rank 0 wrote none")
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"phase 4j: {out['wall_s']:.1f} s", flush=True)
    report["multihost"] = out
    return {f"multihost/{tag}/{name}/rank{r['rank']}": r[name]["launches"]
            for tag in ("nccl_x1", "gloo_x2") for r in out[tag]["ranks"]
            for name in ("pcd", "igr", "sup") if name in r}


def files_under(directory):
    return sorted(p.relative_to(directory) for p in directory.rglob("*") if p.is_file())


def multihost_runs(device, work, configs, igr_x2, report):
    """Phase 4j's runs with no group, (a) and (b); see drive_multihost."""
    from sdf_representation_tpu_torch import cli
    from sdf_representation_tpu_torch.configgen import Configuration
    from sdf_representation_tpu_torch.training import PointCloudTrainer, Trainer, graphs
    from sdf_representation_tpu_torch.training import checkpoint as ckpt

    def state_of(model):
        return {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}

    t0 = time.perf_counter()
    ref_trainer = Trainer(Configuration(configs["ref_igr"]))
    init = state_of(ref_trainer.model)
    ref_igr = ref_trainer.train()
    ref_igr_state = state_of(ref_trainer.model)
    if cli.main([configs["ref_sup"]]) != 0:
        raise RuntimeError("phase 4j: the reference supervised epoch failed")
    pcd_refs = {}
    for name, mesh in (("ref_pcd", None), ("ref_x2_pcd", (device,) * 2)):
        t = PointCloudTrainer(Configuration(configs[name]), mesh=mesh)
        pcd_init = state_of(t.model)
        pcd_refs[name] = (t.train()["losses"], state_of(t.model))
    refs_s = time.perf_counter() - t0
    print(f"phase 4j: the runs with no group (labelled IGRLOSS {DP_IGR_EPOCHS} epochs, a supervised "
          f"epoch, the point cloud x1 and over the card x2, {MH_PCD_EPOCHS} epochs) in {refs_s:.1f} s",
          flush=True)

    base_spec = {"work": str(work), "pcd_config": configs["gloo_pcd"]}
    t0 = time.perf_counter()
    (nccl,) = finish_ranks(start_ranks(work, "nccl_x1", [{
        **base_spec, "addr": f"tcp://127.0.0.1:{free_port()}", "world": 1,
        "runs": [["igr", "igr", configs["nccl_igr"]], ["sup", "cli", configs["nccl_sup"]]]}]),
        MH_TIMEOUT)
    nccl_s = time.perf_counter() - t0
    n_rows = sum(report["pipeline"]["sampling"]["rows"].values())
    igr_steps = ((n_rows - math.ceil(0.1 * n_rows)) // 16384) * DP_IGR_EPOCHS
    pcd_steps = (PCD_POINTS // 16384) * MH_PCD_EPOCHS
    if nccl["backend"] != "nccl" or nccl["world"] != 1:
        raise RuntimeError(f"phase 4j (a): ran on {nccl['backend']} x{nccl['world']}")
    # the rank's steps are graph replays (training/graphs.py), after WARMUP eager steps
    igr_launches = igr_steps + graphs.WARMUP
    if nccl["igr"]["launches"]["igr_fwd"] != igr_launches or \
            nccl["igr"]["launches"]["igr_bwd"] != igr_launches or not nccl["igr"]["graphed"]:
        raise RuntimeError(f"phase 4j (a): launches {nccl['igr']['launches']}, graphed "
                           f"{nccl['igr']['graphed']}, {igr_steps} steps")
    got = torch.load(work / "igr_rank0.pt")
    same_igr = (nccl["igr"]["train_loss"] == ref_igr["train_losses"]
                and nccl["igr"]["val_loss"] == ref_igr["val_losses"]
                and all(torch.equal(got[k], ref_igr_state[k]) for k in ref_igr_state))
    sup_paths = [pathlib.Path(Trainer(Configuration(configs[n])).train_path) for n in ("ref_sup", "nccl_sup")]
    sup_states = [ckpt.load_checkpoint(str(p / "models" / "best_model.ckpt"))["model"] for p in sup_paths]
    same_sup = ((sup_paths[0] / "train_loss.txt").read_text() == (sup_paths[1] / "train_loss.txt").read_text()
                and all(torch.equal(sup_states[0][k], sup_states[1][k]) for k in sup_states[0]))
    print(f"phase 4j (a) NCCL, one rank ({nccl['card']}): {nccl_s:.1f} s; labelled IGRLOSS "
          f"{igr_steps} steps, launches {nccl['igr']['launches']}, bit-equal to no group: {same_igr} "
          f"(checksum {nccl['igr']['checksum'][:16]}); supervised epoch through the entry point "
          f"bit-equal: {same_sup}", flush=True)
    if not (same_igr and same_sup):
        raise RuntimeError("phase 4j (a): one rank over NCCL differs from no group")

    # (b) gloo, two ranks on the one card
    addr = f"tcp://127.0.0.1:{free_port()}"
    t0 = time.perf_counter()
    gloo = finish_ranks(start_ranks(work, "gloo_x2", [{
        **base_spec, "addr": addr, "world": 2, "backend": "gloo", "device": "cuda:0",
        "runs": [["pcd", "pcd", configs["gloo_pcd"]], ["igr", "igr", configs["gloo_igr"]],
                 ["sup", "cli", configs[f"gloo_sup_rank{r}"]]]} for r in range(2)]), MH_TIMEOUT)
    gloo_s = time.perf_counter() - t0
    out = {"refs_s": refs_s, "nccl_x1": {"wall_s": nccl_s, "ranks": [nccl]},
           "gloo_x2": {"wall_s": gloo_s, "ranks": gloo}}
    for r in gloo:
        if r["backend"] != "gloo" or r["device"] != "cuda:0" or r["world"] != 2:
            raise RuntimeError(f"phase 4j (b): rank {r['rank']} on {r['backend']} {r['device']}")
    for name, steps, want_curve, want_state, single_state, init_state in (
            ("pcd", pcd_steps, pcd_refs["ref_x2_pcd"][0], pcd_refs["ref_x2_pcd"][1],
             pcd_refs["ref_pcd"][1], pcd_init),
            ("igr", igr_steps, igr_x2["train_loss"], igr_x2["state"], ref_igr_state, init)):
        states = [torch.load(work / f"{name}_rank{r}.pt") for r in range(2)]
        equal = (all(torch.equal(states[0][k], states[1][k]) for k in states[0])
                 and gloo[0][name]["checksum"] == gloo[1][name]["checksum"]
                 and gloo[0][name]["train_loss"] == gloo[1][name]["train_loss"])
        launched = [r[name]["launches"] for r in gloo]
        loss_rel = float(np.max(np.abs(np.array(gloo[0][name]["train_loss"]) / np.array(want_curve) - 1)))
        reading = param_distance(single_state, want_state, init_state)
        dist_ = param_distance(states[0], want_state, init_state)
        row = {"ranks_bit_equal": equal, "launches_per_rank": launched, "steps": steps,
               "graphed": [r[name]["graphed"] for r in gloo],
               "train_loss": gloo[0][name]["train_loss"], "mesh_x2_train_loss": want_curve,
               "loss_rel": loss_rel, "param_distance_to_mesh_x2": dist_,
               "single_device_param_distance_to_mesh_x2": reading}
        print(f"phase 4j (b) gloo, two ranks on the card, {name}: " + json.dumps(row), flush=True)
        if not equal:
            raise RuntimeError(f"phase 4j (b) {name}: the ranks' parameters differ")
        if any(c["igr_fwd"] != steps or c["igr_bwd"] != steps for c in launched):
            raise RuntimeError(f"phase 4j (b) {name}: not one igr_fwd and igr_bwd per rank and step")
        if any(row["graphed"]):  # a gloo group stays eager (training/graphs.captures)
            raise RuntimeError(f"phase 4j (b) {name}: a gloo rank's steps were graph replays")
        if loss_rel > MH_LOSS_RTOL or dist_ > MH_PARAM_RATIO * reading:
            raise RuntimeError(f"phase 4j (b) {name}: off the one-process mesh of two")
        out["gloo_x2"][name] = row
    times = {f"G={len(ranks)} {ranks[0]['backend']} rank {r['rank']}": r["times"]
             for ranks in ([nccl], gloo) for r in ranks}
    out["times"] = times
    print(f"phase 4j per-rank step times ({report['card']}; gloo over one card says nothing of NCCL "
          f"across cards): {json.dumps(times)}", flush=True)
    return out


T_START = time.perf_counter()


def stamp(what):
    """The seconds since the script started, before a phase: a profile of
    the run against its time limit."""
    print(f"[{time.perf_counter() - T_START:.1f} s] {what}", flush=True)


def main() -> int:
    t_start = T_START
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    from sdf_representation_tpu_torch import cli, kernels
    from sdf_representation_tpu_torch.configgen import Configuration
    from sdf_representation_tpu_torch.evaluations import reconstruct
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
    ptxas = {}
    report["build_s"] = kernels.build_all(["fused_mlp", "sdf_streams", "fused_igr"], verbose=True, reports=ptxas)
    print(f"build: {report['build_s']} s per source, {time.perf_counter() - t0:.1f} s in all "
          "(one nvcc each, started together)", flush=True)
    # fused_mlp: points, grid, blocks x widths 128-512, bf16 and f32 (split
    # TF32); fused_igr, bf16 (namespace tc) and f32 (namespace tf32):
    # igr_fwd and igr_bwd x widths x softplus / ReLU, and igr_dw
    report["sass"] = {**check_sass(kernels.library_path("fused_mlp"), "wgmma_", 12),
                      **check_sass(kernels.library_path("fused_mlp"), "tf32_", 12, tf32=True),
                      **check_sass(kernels.library_path("fused_igr"), r"2tc\d+igr_", 17),
                      **check_sass(kernels.library_path("fused_igr"), r"4tf32\d+igr_", 17, tf32=True),
                      **check_sass(kernels.library_path("sdf_streams"), r"(dist|wind)_kernel", 2,
                                   tensor_cores=False)}
    # a kernel whose wgmma ptxas serialises has lost its issue schedule
    serialised = [k for text in ptxas.values() for k in kernels.serialised_wgmma(text)]
    if serialised:
        raise RuntimeError(f"ptxas serialises the wgmma of {serialised}")
    report["stream_layout"] = ss.kernel_layout()
    print(f"stream kernels: {report['stream_layout']}", flush=True)

    # ---- 3. kernels against plain -------------------------------------------
    stamp("phase 3: kernels against plain")
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

    def tf32_control(name, net, x, want):
        """f32: the split-TF32 emulation of the same inputs beside the
        kernel (fused_mlp.forward_tf32_model: the kernels' operand
        roundings, f64 sums), which must hold F32_TOL, and its one-pass
        form (hi.hi only: a single TF32 pass), the control, which must fail
        it."""
        want = want.reshape(-1)
        row = {}
        for passes in (3, 1):
            diff = (fm.forward_tf32_model(net, x, passes) - want).abs()
            row[f"emulated_{passes}_pass"] = {"max_abs_err": diff.max().item(),
                                              "mean_abs_err": diff.mean().item()}
        controls[f"{name}/tf32"] = row
        print(f"control {name}/tf32 (tolerance {F32_TOL:g}): {json.dumps(row)}", flush=True)
        if row["emulated_3_pass"]["max_abs_err"] > F32_TOL:
            raise RuntimeError(f"control {name}: the three-pass emulation fails F32_TOL")
        if row["emulated_1_pass"]["max_abs_err"] <= F32_TOL:
            raise RuntimeError(f"control {name}: F32_TOL would pass a single TF32 pass")

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
        else:
            tf32_control("fused_points", net, pts, want)
        want = fm.fused_grid_plain(net, 128)
        check(f"fused_grid/{tag}/n128", fm.fused_grid(net, 128), want, dt)
        if dt == torch.bfloat16:
            control("fused_grid/n128", net, fm.grid_points(128, 0, 128 ** 3, device), want,
                    softplus_drops)
        else:
            tf32_control("fused_grid/n128", net, fm.grid_points(128, 0, 128 ** 3, device), want)
        blocks = fm.fused_blocks(net, ids, count, 256, 8)
        want = fm.fused_blocks_plain(net, ids, count, 256, 8)
        check(f"sparse_blocks/{tag}/n256", blocks, want, dt)
        if dt == torch.bfloat16:
            control("sparse_blocks/n256", net, fm.block_points(ids, 256, 8), want, softplus_drops)
        else:
            tf32_control("sparse_blocks/n256", net, fm.block_points(ids, 256, 8), want)
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
        else:
            tf32_control("fused_points/relu", relu_net, pts, want)
    del want, blocks, dense
    (stream_P, (stream_sb, stream_sc), stream_tables, tri_chunk, stream_errors, stream_mesh,
     stream_pts) = check_streams(device, report)
    checks.update(stream_errors)
    shard_P, shard_dist, shard_wind, shard_tables, shard_tc, shard_errors = check_sharded(
        device, stream_mesh, stream_pts, report)
    checks.update(shard_errors)
    stamp("phase 3: igr_fwd, igr_bwd against plain")
    igr_cases, igr_errors = check_igr(device, gen, report)

    # ---- 4. the main path, once per route -----------------------------------
    stamp("phase 4: the main path")
    run_root = REPO / "build" / "chip_smoke_run"
    # cubesize 256 takes the sparse evaluator (block kernel) and marches on
    # the card, 128 the dense one and marches on the host
    route_kernel = {256: "sparse_blocks", 128: "fused_grid"}
    configs, stls = {}, {}
    for cubesize in route_kernel:
        configs[cubesize], stls[cubesize] = reconstruct_config(run_root, cubesize)
        trainer = Trainer(Configuration(configs[cubesize]))
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
              f"host clock per stage (s) {stages}"
              + ("; with the host marcher (PERF.md §5): evaluate 0.106 s, whole ~0.5 s"
                 if cubesize == 256 else ""), flush=True)
        others = [k for k in launches if k != kernel]
        if launches[kernel] < 1 or any(launches[k] for k in others):
            raise RuntimeError(f"cubesize {cubesize} should launch {kernel} and nothing else "
                               f"(a dense fallback launches fused_grid): {launches}")
        if ("decode" in stages) != (cubesize == 256):
            raise RuntimeError(f"cubesize {cubesize}: marched on the wrong side: stages {stages}")
        if not stl.exists():
            raise RuntimeError(f"cubesize {cubesize}: the entry point wrote no STL")
        vertices, n_faces = stl_vertices(stl, device)
        verts = torch.as_tensor(vertices, dtype=torch.float32, device=device)
        if n_faces < 1000 or not torch.isfinite(verts).all() or verts.abs().max() > 1:
            raise RuntimeError(f"the {cubesize}^3 mesh is too small or has vertices off the grid")
        with torch.no_grad():
            p99 = torch.quantile(model(verts).abs(), 0.99).item()
        bound = 2.0 / (cubesize - 1) + checks["fused_points/bfloat16"]
        print(f"mesh {cubesize}^3: {len(vertices)} vertices, {n_faces} faces; "
              f"p99 |f(vertex)| plain f32 {p99:.3e} (bound {bound:.3e})", flush=True)
        if not p99 < bound:
            raise RuntimeError(f"p99 |f| at the vertices {p99} over {bound}")
        main_path[cubesize] = {"launches": launches, "wall_s": wall, "stages_s": stages,
                               "faces": n_faces, "p99_abs_f": p99, "p99_bound": bound}
    _, count256 = sg.sparse_grid_eval(model, 256, return_count=True)
    print(f"active blocks at 256: {count256} of {32 ** 3}", flush=True)
    report.update(main_path=main_path, active_blocks=count256, checks=checks,
                  mean_abs_err=means, controls=controls)

    # ---- 4b. sample -> train -> audit -> reconstruct ---------------------------
    runs = {f"reconstruct/{n}": run["launches"] for n, run in main_path.items()}
    stamp("phase 4b-4c: sample, train, audit, reconstruct, eikonal runs")
    runs.update(drive_pipeline(device, run_root, report))
    stamp("phase 4c (d): the graphed trainers against their eager steps")
    runs.update(drive_graphs_process(report))
    stamp("phase 4d: culled exact SDF")
    runs.update(drive_culled(device, report))
    stamp("phase 4e: sharded evaluators, data-parallel training")
    sharded_runs, shard_eval = drive_sharded(device, run_root, model, report)
    runs.update(sharded_runs)
    stamp("phase 4f: marching, giga")
    runs.update(drive_marching(device, run_root, model, checks, report))
    stamp("phase 4g: 2-D mode, export")
    runs.update(drive_export_two_dim(device, run_root, report))
    stamp("phase 4h: model families")
    runs.update(drive_families(device, run_root, report))
    stamp("phase 4i: host tools")
    runs.update(drive_host_tools(device, run_root, report))
    stamp("phase 4j: one process per card")
    runs.update(drive_multihost(device, run_root, shard_eval["igr_x2"], report))

    # ---- 5. times -----------------------------------------------------------
    stamp("phase 5: times")
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

    def tf32_bound(flops, t_bytes, t_ops, ctas, tiles):
        """The f32 rows' bound: the split-TF32 kernels issue TF32_PASSES
        tensor-core products per multiply-add, at PEAK_TF32; beside it the
        FP32 pipes' bound (the same operations once at 67 TFLOP/s), and the
        weight stages the launch reads from L2 (each CTA reads all of its
        weight image ``tiles`` once; CTAs past a blocks launch's count read
        nothing): computed from the launch, not measured."""
        t_tf32 = TF32_PASSES * flops / PEAK_TF32 * 1e3
        return {"bound_ms": max(t_bytes, t_tf32), "bound_by": "operations" if t_tf32 >= t_bytes else "bytes",
                "bound_ms_fp32_pipes": max(t_bytes, t_ops), "ctas": ctas,
                "l2_weight_bytes": ctas * tiles.numel() * 4}

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
            ms, plain_ms = timed(run), timed(plain, 1, warmup=False)
            lib_ms = timed(lambda: library_chain(x, dt), 1, warmup=False)
            numbers = {"max_abs_err": checks[key], "mean_abs_err": means[key], "ms": ms, "plain_ms": plain_ms,
                       "bound_ms": max(t_bytes, t_ops),
                       "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                       "library_ms": lib_ms, "points": npts,
                       "tflops": flops / ms / 1e9, "points_per_s": npts / ms * 1e3}
            if dt == torch.float32:
                numbers.update(tf32_bound(flops, t_bytes, t_ops, -(-npts // fm.TILE_P), net.tf32_tiles))
                if not ms < lib_ms:
                    print(f"time {name}/{tag}: the kernel is not faster than its library chain", flush=True)
            print(f"time {name}/{tag}: " + json.dumps(numbers), flush=True)
            if dt == torch.bfloat16:
                entry.update(numbers, dtype="bfloat16")
            else:
                entry["float32"] = numbers
        kernels_line.append(entry)
    # the streams at phase 3's shapes, dense schedule; no one PyTorch call
    # computes either function, so there is no library time. Beside each
    # time: the kernel's SASS (phase 2), and its CTA shape and table as the
    # build reports them (kernel_layout); the bound reads each table once
    layout = report["stream_layout"]

    def stream_facts(kernel):
        sass = next(c for fn, c in report["sass"].items() if kernel in fn)
        k = kernel.split("_")[0]
        return {"kernel": kernel, "sass_instructions": sass["instructions"],
                "registers": sass["registers"], "local_bytes": sass["local"],
                "stack_bytes": sass["stack"], "points_per_thread": layout["points_per_thread"],
                "threads": layout["threads"], "stages": layout["stages"],
                "stage_triangles": layout[f"{k}_stage_triangles"], "table_rows": layout[f"{k}_rows"],
                "stage_bytes": layout[f"{k}_ring_bytes"] // layout["stages"]}

    # the SM clock, power and temperature as the stream timings start (the
    # card clocks down under long loads, and these kernels are issue-bound)
    report["card_state_before_stream_times"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,temperature.gpu",
         "--format=csv,noheader"], capture_output=True, text=True, check=True).stdout.strip()
    print(f"card state before the stream times: {report['card_state_before_stream_times']}",
          flush=True)
    n_blocks, m_pts, _ = stream_P.shape
    n_chunks = stream_tables["a"].shape[0]
    pairs = n_blocks * m_pts * n_chunks * tri_chunk
    schedule_bytes = 4 * (n_blocks + 1 + n_blocks * n_chunks)
    for name, replaces, ops, rows, out_bytes, run, plain in (
        ("dist_stream", "sdf_representation_tpu/ops/pallas_streams.py:284 _dist_slab_call",
         DIST_OPS_PER_PAIR, layout["dist_rows"], 8,
         lambda: ss.dist_stream(stream_P, stream_sb, stream_sc, stream_tables, tri_chunk),
         lambda: ss.dist_stream_plain(stream_P, stream_sb, stream_sc, stream_tables, tri_chunk)),
        ("wind_stream", "sdf_representation_tpu/ops/pallas_streams.py:388 _wind_slab_call",
         WIND_OPS_PER_PAIR, layout["wind_rows"], 4,
         lambda: ss.wind_stream(stream_P, stream_sb, stream_sc, stream_tables, tri_chunk),
         lambda: ss.wind_stream_plain(stream_P, stream_sb, stream_sc, stream_tables, tri_chunk)),
    ):
        bytes_ = (stream_P.numel() * 4 + n_chunks * tri_chunk * rows * 4 + schedule_bytes
                  + (n_blocks + 1) * m_pts * out_bytes)
        t_bytes, t_ops = bytes_ / MEM_BW * 1e3, pairs * ops / PEAK[torch.float32] * 1e3
        ms, plain_ms = timed(run), timed(plain, 1, warmup=False)
        by_run = {tag: counts[name] for tag, counts in runs.items() if counts[name]}
        entry = {"name": name, "route": "cuda",
                 "source": "sdf_representation_tpu_torch/csrc/sdf_streams.cu", "replaces": replaces,
                 "launches": sum(by_run.values()), "launches_by_run": by_run, "dtype": "float32",
                 "max_abs_err": checks[f"{name}/dense"], "max_abs_err_sparse": checks[f"{name}/sparse"],
                 "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
                 "bound_by": "operations" if t_ops >= t_bytes else "bytes", "library_ms": None,
                 "pairs": pairs, "ops_per_pair": ops, "pairs_per_s": pairs / ms * 1e3,
                 **stream_facts("dist_kernel" if name == "dist_stream" else "wind_kernel")}
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
         DIST_OPS_PER_PAIR, layout["dist_rows"], 8, shard_dist, ss.dist_stream_sharded, ss.dist_stream_sharded_plain),
        ("wind_stream_sharded",
         "sdf_representation_tpu/ops/pallas_streams.py:646 wind_stream_pallas_sharded",
         WIND_OPS_PER_PAIR, layout["wind_rows"], 4, shard_wind, ss.wind_stream_sharded, ss.wind_stream_sharded_plain),
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
                 "pairs_per_s": pairs / ms * 1e3,
                 **stream_facts("dist_kernel" if name == "dist_stream_sharded" else "wind_kernel")}
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

    stamp("phase 5: igr_fwd, igr_bwd")
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
                # weight images) is reported beside the bound, not in it.
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
                    ctas = -(-n // (fi.FWD_CTA_P if bf16 else fi.FWD_TILE_P))
                else:
                    # two chains forward, two back (no W^T pass below the first
                    # layer), two into dW (~6 per layer); out: f32 dW and db
                    ops = 2.0 * n * (2 * macs + 2 * (macs - mac0) + 2 * macs)
                    bytes_ = n * (2 * d + 1) * 4 + w_bytes + (wbuf.numel() + bbuf.numel()) * 4
                    run = lambda: fi.fused_param_grads(net, x, a, c)
                    plain = lambda: fi.fused_param_grads_plain(net, x, a, c)
                    lib = lambda: library_vag(net_model, x, a, c, dt, True)
                    # igr_bwd, then the dW pass (igr_dw) from the same call (f32:
                    # then the sum of its parts where it cuts the rows, not an igr_* kernel)
                    expect = {"igr_bwd_kernel": 1, "igr_dw_kernel": 1}
                    ctas = -(-n // (fi.BWD_CTA_P if bf16 else fi.BWD_TILE_P))
                    # the dW pass alone, on this input's workspace
                    ws, part = fi.images_plain(net, x, a, c)
                    extra["dw_pass_ms"] = timed(lambda: fi.dw_pass(net, ws, part), 5)
                    extra["dw_pass_jobs"] = len(fi.dw_plan(net))
                    if not bf16:
                        extra["dw_pass_splits"] = fi.dw_splits(extra["dw_pass_jobs"], part.shape[0], x.device)
                    del ws, part
                t_bytes, t_ops = bytes_ / MEM_BW * 1e3, ops / PEAK[dt] * 1e3
                ms = timed(run, 5)
                workspace = fi.WORKSPACE_BYTES[name]  # what the timed calls allocated
                launched = kernels_per_call(run, expect)
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
                if not bf16:  # split TF32: three TF32 products per multiply-add
                    numbers.update(tf32_bound(ops, t_bytes, t_ops, ctas, net.igr_tf32_tiles))
                tag = str(dt).split(".")[1]
                print(f"time {name}/{case}/{tag}: " + json.dumps(numbers), flush=True)
                if case == "8x512/n16384" and dt == torch.bfloat16:
                    entry.update(numbers, dtype="bfloat16", shape=case)
                else:
                    entry[f"{case}/{tag}"] = numbers
        # phase 4j: each rank's step under a process group beside the kernels' time on its rows
        entry["per_rank_steps_ms"] = report["multihost"]["times"]
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
    stamp("phase 5: kernels 10, 11")
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
            plain_ms, lib_ms = timed(plain, 1, warmup=False), timed(lambda: library_chain(x, dt), 1, warmup=False)
            numbers = {"max_abs_err": err, "ms": ms_by[4], "plain_ms": plain_ms,
                       "bound_ms": max(t_bytes, t_ops),
                       "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                       "library_ms": lib_ms, "points": npts, "shards": 4,
                       "ms_by_shards": ms_by, "tflops": flops / ms_by[4] / 1e9}
            if dt == torch.float32:
                ctas = 4 * se.slab_tiles(256, 4, 1024) if name == "sharded_grid" else npts // fm.TILE_P
                numbers.update(tf32_bound(flops, t_bytes, t_ops, ctas, net.tf32_tiles))
            print(f"time {name}/{tag}: " + json.dumps(numbers), flush=True)
            if dt == torch.bfloat16:
                entry.update(numbers, dtype="bfloat16")
            else:
                entry["float32"] = numbers
        if entry["launches"] < 1:
            raise RuntimeError(f"{name} was launched on no run of the main path")
        kernels_line.append(entry)
    # the whole evaluators and the data-parallel eikonal step, x1 / x2 / x4
    stamp("phase 5: the sharded evaluators and steps")
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
    report.update(kernels=kernels_line, sparse_grid_eval_ms=sparse_ms,
                  wall_s=time.perf_counter() - t_start)
    print(f"chip_smoke: {report['wall_s']:.1f} s from start to report, build included", flush=True)

    (REPO / "build" / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    print(card)
    print(json.dumps({"kernels": kernels_line}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


def drive_graphs_process(report):
    """Phase 4c (d) in a process of its own (``--graphs``), as phase 4i (f)
    runs its traces: after a process's torch.profiler traces, its later ones
    have held no device event. Returns the phase's launches per run."""
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, str(REPO / "chip_smoke.py"), "--graphs"], cwd=REPO,
                         capture_output=True, text=True, timeout=900)
    print(res.stdout, end="", flush=True)
    if res.returncode != 0:
        raise RuntimeError(f"phase 4c (d) failed ({res.returncode}): {res.stderr[-3000:]}")
    child = json.loads((REPO / "build" / "chip_smoke_graphs.json").read_text())
    report["graphs"] = {**child["graphs"], "process_s": time.perf_counter() - t0}
    return child["launches"]


def graphs_main() -> int:
    """``python3 chip_smoke.py --graphs``: phase 4c (d) alone, after the
    card's name and power limit and the build of csrc/fused_igr.cu; its
    readings in build/chip_smoke_graphs.json."""
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    from sdf_representation_tpu_torch import kernels
    from sdf_representation_tpu_torch.utils.device import resolve_device

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    report = {"card": card, "build_s": kernels.build_all(["fused_igr"])}
    stamp("phase 4c (d): the graphed trainers against their eager steps")
    report["launches"] = drive_graphs(resolve_device(), REPO / "build" / "chip_smoke_run", report)
    (REPO / "build" / "chip_smoke_graphs.json").write_text(json.dumps(report, indent=1))
    stamp("done")
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        sys.exit(rank_main(sys.argv[1:]))
    sys.exit(graphs_main() if sys.argv[1:] == ["--graphs"] else main())
