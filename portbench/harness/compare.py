"""The numbers that decide ``correct``, and the verdict against their limits.

Training, over the window's first epochs (``train_cell.CHECK_EPOCHS``), and over the
set-up's steps one by one (the same names after ``steps.``), program against
reference: ``loss_gap``, the worst relative gap of an epoch's mean training
loss; ``val_gap``, the worst relative gap of the validation loss after an
epoch; ``best_gap``, the relative gap between the validation loss that the
program recorded for the epoch it kept as its best and that of the kept
checkpoint's parameters, worked out again (infinite where the kept epoch
is not the best recorded one); ``grad1_gap`` and ``change_gap``, the first
gradient and the parameters' change by the worst leaf: the gap between the
program's norm of a leaf and the reference's, over the larger of the
reference's norm of that leaf and of the median leaf. The change leaves
out leaves whose reference gradient is under a thousandth of the median
leaf's: Adam moves those by round-off alone.

Labels: ``points_err``, the largest coordinate gap of the sampled points;
``sdf_err``, the largest gap of signed distance (a wrong sign reads twice
the distance); ``normals_off``, the count of rows whose unit normals differ
by more than ``NORMAL_TOL`` (a tie between two triangles may turn one).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

NORMAL_TOL = 0.05
MOVED = 1e-3  # a leaf whose reference gradient is under this share of the median's


def _norms(leaves: Sequence[torch.Tensor]) -> np.ndarray:
    return np.array([float(t.double().norm()) for t in leaves])


def leaf_gap(program: Sequence[torch.Tensor], reference: Sequence[torch.Tensor],
             keep: Optional[Sequence[bool]] = None) -> float:
    p, r = _norms(program), _norms(reference)
    if p.shape != r.shape or not np.isfinite(p).all():
        return math.inf  # a leaf missing or not finite
    keep = np.ones(len(r), bool) if keep is None else np.asarray(keep, bool)
    floor = np.median(r[keep])
    return float(np.max(np.abs(p - r)[keep] / np.maximum(r[keep], floor)))


def moved_leaves(grad1_ref: Sequence[torch.Tensor]) -> List[bool]:
    r = _norms(grad1_ref)
    return list(r >= MOVED * np.median(r))


def _rel(a: float, b: float) -> float:
    if not math.isfinite(a):
        return math.inf
    return abs(a - b) / abs(b) if b else (0.0 if a == b else math.inf)


def _worst(program: Sequence[float], reference: Sequence[float]) -> float:
    if len(program) < len(reference):
        return math.inf  # an epoch missing
    return max(_rel(a, b) for a, b in zip(program, reference))


def train_numbers(program: Dict, reference: Dict) -> Dict[str, float]:
    """Each key that both sides give: ``epoch_losses`` and ``val_losses``
    (lists, one per epoch); ``best`` ((recorded, recomputed), or None where
    the kept epoch is not the best recorded); ``grad1``, the first step's
    gradient; ``change``, the leaves' change (None where the kept epoch is
    not the best recorded). The reference's ``grad1`` picks the moved leaves."""
    out = {"loss_gap": _worst(program["epoch_losses"], reference["epoch_losses"])}
    if reference.get("val_losses") and "val_losses" in program:
        out["val_gap"] = _worst(program["val_losses"], reference["val_losses"])
    if "best" in program:
        best = program["best"]
        out["best_gap"] = math.inf if best is None else _rel(*best)
    if "grad1" in program:
        out["grad1_gap"] = leaf_gap(program["grad1"], reference["grad1"])
    if "change" in program:
        change = program["change"]
        out["change_gap"] = (math.inf if change is None else
                             leaf_gap(change, reference["change"], moved_leaves(reference["grad1"])))
    return out


def label_numbers(sdf_p, normals_p, sdf_r, normals_r, points_p=None, points_r=None) -> Dict[str, float]:
    out = {}
    if points_p is not None:
        out["points_err"] = float(np.max(np.abs(np.asarray(points_p, np.float64) - points_r)))
    out["sdf_err"] = float(np.max(np.abs(np.asarray(sdf_p, np.float64) - sdf_r)))
    off = np.linalg.norm(np.asarray(normals_p, np.float64) - normals_r, axis=1) > NORMAL_TOL
    out["normals_off"] = float(np.count_nonzero(off | ~np.isfinite(normals_p).all(axis=1)))
    return {k: (v if math.isfinite(v) else math.inf) for k, v in out.items()}


def judge(numbers: Dict[str, float], limits: Dict) -> Tuple[bool, List[Dict]]:
    """Every number against its limit (a NaN fails). A cell's limits file
    names the numbers it does not compare under ``not_compared``; any other
    number without a limit is an error."""
    skipped = set(limits.get("not_compared", {}))
    missing = sorted(set(numbers) - set(limits) - skipped)
    if missing:
        raise KeyError(f"no limit for {missing}")
    checks = [{"name": k, "value": v, "limit": limits[k]} for k, v in numbers.items()
              if k not in skipped]
    return all(c["value"] <= c["limit"] for c in checks), checks
