"""Model-vs-exact normal quality audit — counterpart of
sdf_representation_tpu/evaluations/normal_comparison.py (reference
utils/normal_comparison.py:15-128 `compute_normal_for_model`, whose shipped
version exits halfway, :67).

The trained field and its input-gradient normals are evaluated at given
coordinates and compared with the exact mesh distances and normals
(``ops/sdf_exact.signed_distance``: the CUDA streams on the card): RMSE and
per-point cosine-similarity statistics, written as the same artifact set
(exact_wf.csv, computed.csv, error_points.csv, similarity_points.csv,
similarity.csv) with error heatmaps where matplotlib imports. The CSVs are
numpy writes of the files pandas writes in the JAX package.
"""

from __future__ import annotations

import glob
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..data.dataset import frame_from_csv
from ..geometry.mesh_io import load_mesh
from ..ops.diffops import sdf_and_gradient
from ..ops.sdf_exact import signed_distance
from ..sampling.sampler import COLUMNS, Frame
from ..utils.device import matmul_precision


def compute_normal_for_model(
    model,
    save_path: str,
    coords_csv: str = "nodes_coordinates.csv",
    mesh_path: Optional[str] = None,
    plot: bool = True,
) -> Dict[str, float]:
    """``model``: a module on the device to evaluate on. The coordinates are
    read from ``save_path/coords_csv`` by the column names x, y, z (a
    leading index column is allowed); the mesh is ``mesh_path``, else the
    first ``*.stl`` in ``save_path``. Returns eval_seconds and, with a mesh,
    rmse and cos_mean / cos_median / cos_std / cos_min / cos_max."""
    coords = frame_from_csv(os.path.join(save_path, coords_csv))
    pts = np.column_stack([coords[c] for c in ("x", "y", "z")]).astype(np.float32)
    device = next(model.parameters()).device

    # ground truth from the mesh (an .stl beside the coords, like the
    # reference glob, normal_comparison.py:30-37)
    if mesh_path is None:
        stls = glob.glob(os.path.join(save_path, "*.stl"))
        mesh_path = stls[0] if stls else None
    truth = None
    if mesh_path is not None:
        S, n = signed_distance(pts.astype(np.float64), load_mesh(mesh_path), device=device)
        truth = Frame(COLUMNS, np.column_stack([pts, S, n]))
        truth.to_csv(os.path.join(save_path, "exact_wf.csv"))

    t0 = time.time()
    with matmul_precision("highest"):
        vals, grads = sdf_and_gradient(model, torch.from_numpy(pts).to(device))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    elapsed = time.time() - t0
    vals = vals.detach().cpu().numpy()
    normals = grads[:, -3:].detach().cpu().numpy()

    Frame(COLUMNS, np.column_stack([pts, vals, normals])).to_csv(
        os.path.join(save_path, "computed.csv"))

    out: Dict[str, float] = {"eval_seconds": elapsed}
    if truth is not None:
        err = np.abs(truth["S"] - vals)
        Frame(("x", "y", "z", "error"), np.column_stack([pts, err])).to_csv(
            os.path.join(save_path, "error_points.csv"))
        out["rmse"] = float(np.sqrt(np.mean(err**2)))

        tn = truth.values[:, 4:7]
        denom = np.linalg.norm(tn, axis=1) * np.linalg.norm(normals, axis=1)
        cos = np.einsum("ij,ij->i", tn, normals) / np.maximum(denom, 1e-12)
        Frame(("x", "y", "z", "similarity"), np.column_stack([pts, cos])).to_csv(
            os.path.join(save_path, "similarity_points.csv"))
        stats = {
            "mean": float(np.mean(cos)),
            "median": float(np.median(cos)),
            "std": float(np.std(cos)),
            "min": float(np.min(cos)),
            "max": float(np.max(cos)),
        }
        Frame(tuple(stats), np.array([list(stats.values())])).to_csv(
            os.path.join(save_path, "similarity.csv"), index=False)
        out.update({f"cos_{k}": v for k, v in stats.items()})
        if plot:
            try:
                from .visualize_errors import plot_errors

                plot_errors(save_path)
            except Exception as exc:
                print(f"error plots failed: {exc}")
    return out
