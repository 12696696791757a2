"""Octree-vs-network comparison — counterpart of
sdf_representation_tpu/evaluations/compare_octree_dl.py (a working version
of the reference's skeleton, evaluations/compare_octree_dl.py:1-36, which
reads a PVTU mesh through VTK and names an undefined `transform`/`model`).

Octree sources:
  * VTU / PVTU XML with ascii DataArrays (a minimal parser; no vtk);
  * the native DeepTrace engine's points.csv (x,y,z,S,nx,ny,nz).

The trained network is evaluated at every octree node
(``ops/grid_eval.evaluate_points``, float32) and compared with the node's
stored scalar where there is one; the result is written as a CSV (no index
column) and summarised.
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from typing import Dict, Optional, Tuple

import numpy as np

from ..ops.grid_eval import evaluate_points
from ..sampling.sampler import Frame


def _parse_data_array(elem) -> np.ndarray:
    if elem.get("format", "ascii") != "ascii":
        raise ValueError("only ascii DataArrays are supported")
    vals = np.array(" ".join(elem.itertext()).split(), dtype=np.float64)
    n_comp = int(elem.get("NumberOfComponents", "1"))
    return vals.reshape(-1, n_comp) if n_comp > 1 else vals


def read_vtu_points(path: str) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """(points (N,3), first point-data scalar array or None) from a .vtu."""
    tree = ET.parse(path)
    root = tree.getroot()
    pts = None
    scalars = None
    for piece in root.iter("Piece"):
        for points in piece.iter("Points"):
            for da in points.iter("DataArray"):
                pts = _parse_data_array(da)
        for pdata in piece.iter("PointData"):
            for da in pdata.iter("DataArray"):
                arr = _parse_data_array(da)
                if arr.ndim == 1:
                    scalars = arr
                    break
    if pts is None:
        raise ValueError(f"no Points in {path}")
    return np.asarray(pts, dtype=np.float64).reshape(-1, 3), scalars


def read_pvtu_points(path: str) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Concatenate every <Piece Source=...> of a .pvtu."""
    tree = ET.parse(path)
    base = os.path.dirname(path)
    all_pts, all_scal = [], []
    for piece in tree.getroot().iter("Piece"):
        src = piece.get("Source")
        if not src:
            continue
        pts, scal = read_vtu_points(os.path.join(base, src))
        all_pts.append(pts)
        all_scal.append(scal)
    if not all_pts:
        raise ValueError(f"no pieces in {path}")
    pts = np.concatenate(all_pts)
    scal = (
        np.concatenate(all_scal)
        if all(s is not None for s in all_scal)
        else None
    )
    return pts, scal


def load_octree_nodes(path: str) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    ext = os.path.splitext(path)[1].lower()
    if ext == ".vtu":
        return read_vtu_points(path)
    if ext == ".pvtu":
        return read_pvtu_points(path)
    if ext == ".csv":
        arr = np.loadtxt(path, delimiter=",")
        arr = np.atleast_2d(arr)
        pts = arr[:, :3]
        scal = arr[:, 3] if arr.shape[1] > 3 else None
        return pts, scal
    raise ValueError(f"unsupported octree format {ext}")


def compare_octree_dl(
    model,
    octree_path: str,
    out_csv: Optional[str] = None,
    transform=None,
) -> Dict[str, float]:
    """Evaluate the network (a module on its device) at the octree nodes;
    diff against the stored scalars."""
    pts, stored = load_octree_nodes(octree_path)
    if transform is not None:
        pts = transform(pts)
    pred = evaluate_points(model, pts.astype(np.float32))

    names, cols = ["x", "y", "z", "model_sdf"], [pts[:, 0], pts[:, 1], pts[:, 2], pred]
    out: Dict[str, float] = {"n_nodes": float(len(pts))}
    if stored is not None:
        err = pred - stored
        names += ["octree_sdf", "error"]
        cols += [stored, err]
        out["rmse"] = float(np.sqrt(np.mean(err**2)))
        out["max_abs_err"] = float(np.max(np.abs(err)))
        out["sign_agreement"] = float(np.mean((pred < 0) == (stored < 0)))
    if out_csv:
        Frame(tuple(names), np.column_stack(cols)).to_csv(out_csv, index=False)
    return out
