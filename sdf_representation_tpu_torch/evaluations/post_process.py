"""Dense-grid accuracy audit of a trained field vs exact mesh distance —
counterpart of sdf_representation_tpu/evaluations/post_process.py (reference
evaluations/post_process.py:40-211).

The model is evaluated over the cubesize^3 grid as the JAX package
dispatches it (post_process.py:65-83): an ImplicitNet through the fused
grid kernel (on the CPU: the module's own f32 forward on the dense grid, as
the JAX package evaluates on a CPU backend), a HashMLP through the separable
evaluator (ops/hash_grid_eval.py), any other family through
``evaluate_points`` (chunks of min(postprocessbatchsize, 262144) points,
quartered on the card's out-of-memory error), compared on the device against
EXACT signed distances (``ops/sdf_exact.signed_distance`` through the
distance and winding streams, sharded over the trainer's mesh when it has
more than one device), and the same artifact set is written:

  * thresholded NMSE at 0.01 and 0.00025, sign accuracy
  * classification_report{1,2}.csv, and confusion_matrix.png where
    matplotlib is installed
  * mismatching_co-ordinates{1,2}.csv (at most 1M rows each)
  * an appended results.csv row with wall time / epoch / resolution
  * Chamfer distance between the reconstructed (at min(n, 128)) and the
    ground-truth surface.

An audit that cannot run is a failure, not a number: nothing is caught,
the Chamfer stage included (the JAX package turns its failure into NaN).
``LAST_STAGE_SECONDS`` holds the host-clock seconds of the last audit's
stages.
"""

from __future__ import annotations

import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..geometry.mesh_io import load_mesh
from ..models.hash_mlp import HashMLP
from ..models.implicit_net import ImplicitNet
from ..ops.fused_mlp import fused_grid_eval
from ..ops.grid_eval import evaluate_grid, evaluate_points, grid_axis, grid_coords
from ..ops.hash_grid_eval import hash_grid_eval
from ..ops.sdf_exact import signed_distance
from ..sampling.sampler import sample_surface_points
from .metrics import (
    _report_from_confusion,
    chamfer_distance,
    compute_grid_metrics,
    confusion_matrix_png,
)
from .reconstruct import reconstruct_mesh

THRESHOLD_1 = 0.01
THRESHOLD_2 = 0.00025
RESULT_COLUMNS = ("Time Taken", "Epoch", "Resolution", "NMSELoss_Mismatch 0.01",
                  "NMSELoss_Mismatch 0.00025", "Accuracy", "Chamfer")

# host-clock seconds of each stage of the last audit; a stage that leaves
# work on the card is closed with a synchronize, so the stages add up
LAST_STAGE_SECONDS: dict = {}


def post_process(trainer, mesh_path: Optional[str] = None) -> Dict[str, float]:
    c = trainer.config
    t0 = time.time()
    LAST_STAGE_SECONDS.clear()
    lap_start = [time.perf_counter()]

    def lap(name: str) -> None:
        if trainer.device.type == "cuda":
            torch.cuda.synchronize(trainer.device)
        now = time.perf_counter()
        LAST_STAGE_SECONDS[name] = now - lap_start[0]
        lap_start[0] = now

    _, epoch = trainer.load_model(best=True)
    if mesh_path is None:
        mesh_path = (
            getattr(trainer, "rescaled_path", None)
            or os.path.join(trainer.main_path, trainer.geometry_name + "_rescaled.stl")
        )
        if not os.path.exists(mesh_path):
            mesh_path = c.geometry
    mesh = load_mesh(mesh_path)
    lap("load")

    n = c.cubesize
    if isinstance(trainer.model, HashMLP):
        pred = hash_grid_eval(trainer.model, n).reshape(-1)
    elif not isinstance(trainer.model, ImplicitNet):
        pred = torch.from_numpy(evaluate_points(trainer.model, grid_coords(n),
                                                chunk=min(c.ppbatchsize, 262144)))
        pred = pred.to(trainer.device)
    elif trainer.device.type == "cpu":
        # the JAX package on a CPU backend: evaluate_points, dense and f32
        pred = evaluate_grid(trainer.model, n).reshape(-1)
    else:
        pred = fused_grid_eval(trainer.model, n, compute_dtype=trainer.compute_dtype).reshape(-1)
    lap("predict")
    # exact distances stay on the device: the metrics reduce there. A
    # multi-device run shards the streams over the training mesh (JAX
    # post_process.py:91-97); under a process group rank 0 audits alone
    mesh_devices = (trainer.mesh if isinstance(trainer.mesh, tuple) and len(trainer.mesh) > 1
                    else None)
    true, _ = signed_distance(grid_coords(n), mesh, return_normals=False,
                              return_device=True, device=trainer.device, devices=mesh_devices)
    lap("exact_distance")

    gm = compute_grid_metrics(pred, true, thresholds=(THRESHOLD_1, THRESHOLD_2))
    out: Dict[str, float] = {
        "nmse_0.01": gm[f"nmse_{THRESHOLD_1}"],
        "nmse_0.00025": gm[f"nmse_{THRESHOLD_2}"],
        "sign_accuracy": gm["sign_accuracy"],
    }
    lap("metrics")

    save = trainer.postprocess_save_path
    # sign labels do not depend on the threshold: one report, written under
    # both artifact names; the x/y/z columns are rebuilt from flat indices
    # (flat = x*n^2 + y*n + z)
    axis32 = grid_axis(n).astype(np.float32)
    report = _report_from_confusion(gm["confusion"])
    for tag, cnt, idx in (
        ("1", gm["mismatch_counts"][0], gm["mismatch_indices"][0]),
        ("2", gm["mismatch_counts"][1], gm["mismatch_indices"][1]),
    ):
        out[f"n_mismatch_{tag}"] = int(cnt)
        rows = np.stack(
            [axis32[idx // (n * n)], axis32[(idx // n) % n], axis32[idx % n]], axis=-1
        ).reshape(-1, 3)
        np.savetxt(os.path.join(save, f"mismatching_co-ordinates{tag}.csv"), rows,
                   fmt="%.9g", delimiter=",", header="x,y,z", comments="")
        report.to_csv(os.path.join(save, f"classification_report{tag}.csv"))
    confusion_matrix_png(gm["confusion"], os.path.join(save, "confusion_matrix.png"))
    lap("write_artifacts")

    # Chamfer between reconstructed and ground-truth surfaces
    recon = reconstruct_mesh(trainer.model, min(n, 128), compute_dtype=trainer.compute_dtype)
    if len(recon.faces):
        rng = np.random.default_rng(0)
        pa = sample_surface_points(recon, 1, rng, area_weighted=True, total_points=20000)
        pb = sample_surface_points(mesh, 1, rng, area_weighted=True, total_points=20000)
        out["chamfer"] = chamfer_distance(pa, pb)
    else:
        out["chamfer"] = float("inf")
    lap("chamfer")

    elapsed = time.time() - t0
    row = (elapsed, epoch, n, out["nmse_0.01"], out["nmse_0.00025"], out["sign_accuracy"],
           out["chamfer"])
    results_csv = os.path.join(save, "results.csv")
    new_file = not os.path.exists(results_csv)
    with open(results_csv, "a") as f:
        if new_file:
            f.write(",".join(RESULT_COLUMNS) + "\n")
        f.write(",".join(repr(float(v)) if isinstance(v, float) else str(v) for v in row) + "\n")
    out["time_taken"] = elapsed
    return out
