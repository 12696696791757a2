"""Quantitative evaluation metrics — counterpart of
sdf_representation_tpu/evaluations/metrics.py (the reference's
post_process.py bookkeeping plus Chamfer distance), without pandas or
sklearn: the classification report is the port's numpy ``Frame`` with the
row labels and columns of the JAX package's DataFrame."""

from __future__ import annotations

import numpy as np
import torch
from scipy.spatial import cKDTree

from ..sampling.sampler import Frame

REPORT_COLUMNS = ("precision", "recall", "f1-score", "support")


def chamfer_distance(points_a: np.ndarray, points_b: np.ndarray) -> float:
    """Symmetric Chamfer distance (mean nearest-neighbour, both directions)."""
    ta, tb = cKDTree(points_a), cKDTree(points_b)
    da, _ = tb.query(points_a, k=1)
    db, _ = ta.query(points_b, k=1)
    return float(da.mean() + db.mean())


def sign_accuracy(pred_sdf: np.ndarray, true_sdf: np.ndarray) -> float:
    """Fraction of points whose inside/outside classification matches
    (cf. reference post_process.py:102-104, 171-172)."""
    n = pred_sdf.size
    if n == 0:
        return 0.0
    wrong = np.count_nonzero((pred_sdf < 0) ^ (true_sdf < 0))
    return float((n - wrong) / n)


def thresholded_nmse(pred_sdf: np.ndarray, true_sdf: np.ndarray, threshold: float) -> float:
    """Normalized MSE over points where |pred - true| > threshold — the
    reference's "NMSELoss_Mismatch" metric (post_process.py:99-101, 162-163):
    sum of squared errors of mismatching points / sum of squared true
    values, in float32."""
    t32 = np.asarray(true_sdf, np.float32)
    err = np.asarray(pred_sdf, np.float32) - t32
    e2 = err * err
    denom = float(np.dot(t32, t32))
    if denom == 0:
        return 0.0
    num = float(np.sum(np.where(e2 > np.float32(threshold) ** 2, e2, np.float32(0))))
    return num / denom


def sign_confusion_counts(pred_sdf: np.ndarray, true_sdf: np.ndarray) -> np.ndarray:
    """2x2 confusion counts [true][pred] of the inside(1)/outside(0) labels."""
    t = true_sdf < 0
    p = pred_sdf < 0
    n = t.size
    tp = int(np.count_nonzero(t & p))
    t1 = int(np.count_nonzero(t))
    p1 = int(np.count_nonzero(p))
    return np.array([[n - t1 - p1 + tp, p1 - tp], [t1 - tp, tp]], dtype=np.int64)


def classification_report_frame(pred_sdf: np.ndarray, true_sdf: np.ndarray) -> Frame:
    """Per-class precision/recall/f1/support on the sign labels, with
    sklearn's classification_report layout (cf. reference post_process.py
    generate_classification_report :21-28), derived from the confusion
    counts (JAX metrics.py:66-72)."""
    return _report_from_confusion(sign_confusion_counts(pred_sdf, true_sdf))


def _report_from_confusion(cm: np.ndarray) -> Frame:
    """Per-class precision/recall/f1/support plus accuracy and the macro and
    weighted averages: a Frame with rows "0", "1", "accuracy", "macro avg",
    "weighted avg" over REPORT_COLUMNS, float64."""
    total = cm.sum()
    rows = {}
    f1s, precs, recs, supports = [], [], [], []
    for cls in (0, 1):
        tp = cm[cls, cls]
        support = cm[cls].sum()
        pred_pos = cm[:, cls].sum()
        prec = tp / pred_pos if pred_pos else 0.0
        rec = tp / support if support else 0.0
        f1 = 2 * prec * rec / (prec + rec) if prec + rec else 0.0
        rows[str(cls)] = {"precision": prec, "recall": rec, "f1-score": f1,
                          "support": float(support)}
        precs.append(prec)
        recs.append(rec)
        f1s.append(f1)
        supports.append(support)
    acc = (cm[0, 0] + cm[1, 1]) / total if total else 0.0
    rows["accuracy"] = {"precision": acc, "recall": acc, "f1-score": acc,
                        "support": float(total)}
    rows["macro avg"] = {"precision": np.mean(precs), "recall": np.mean(recs),
                         "f1-score": np.mean(f1s), "support": float(total)}
    w = np.asarray(supports) / max(total, 1)
    rows["weighted avg"] = {"precision": float(np.dot(w, precs)), "recall": float(np.dot(w, recs)),
                            "f1-score": float(np.dot(w, f1s)), "support": float(total)}
    return Frame(REPORT_COLUMNS, np.array([[float(row[k]) for k in REPORT_COLUMNS]
                                           for row in rows.values()]), index=tuple(rows))


def confusion_matrix_png(cm: np.ndarray, path: str) -> bool:
    """Confusion-matrix heatmap (cf. post_process.py :29-38), written where
    matplotlib is installed; returns False (and prints one line) where not."""
    try:
        import matplotlib
    except ImportError:
        print("confusion-matrix plot skipped: matplotlib is not installed")
        return False
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots()
    im = ax.imshow(cm, cmap="Blues")
    for (i, j), v in np.ndenumerate(cm):
        ax.text(j, i, str(v), ha="center", va="center")
    ax.set_xlabel("predicted (inside=1)")
    ax.set_ylabel("true (inside=1)")
    fig.colorbar(im)
    fig.savefig(path, dpi=100)
    plt.close(fig)
    return True


def compute_grid_metrics(pred_sdf, true_sdf, thresholds=(0.01, 0.00025),
                         max_mismatch: int = 1_000_000):
    """All post-process scalar metrics + mismatch samples as torch ops on the
    inputs' device; only the scalars (one copy) and at most ``max_mismatch``
    flat indices per threshold reach the host: at 256^3 neither the grids nor full masks
    cross to the host. When a threshold's mismatch count exceeds the cap the
    points are decimated by an unbiased Bernoulli draw (a seeded generator on
    the device).

    Returns dict with nmse_{t}, sign_accuracy, confusion (2,2),
    mismatch_counts (true counts per threshold), and mismatch_indices
    (host int64 arrays of flat grid indices, each len <= max_mismatch).
    """
    p = torch.as_tensor(pred_sdf).to(torch.float32).reshape(-1)
    t = torch.as_tensor(true_sdf).to(device=p.device, dtype=torch.float32).reshape(-1)
    n = p.numel()
    cap = int(min(max_mismatch, n))

    err = p - t
    e2 = err * err
    denom = torch.clamp_min(torch.dot(t, t), 1e-30)
    gen = torch.Generator(device=p.device).manual_seed(0)
    u = torch.rand(n, generator=gen, device=p.device)
    scalars, idxs = [], []
    for thr in thresholds:
        m = err.abs() > thr
        cnt = torch.count_nonzero(m)
        scalars += [(torch.sum(torch.where(m, e2, 0.0)) / denom).to(torch.float64),
                    cnt.to(torch.float64)]
        # target slightly under the cap: a draw that overshot it would be
        # truncated at the HIGHEST flat indices, biasing the sample against
        # one side of the grid; 0.997 keeps that improbable
        keep = torch.where(cnt <= cap, 1.0, 0.997 * cap / torch.clamp_min(cnt.float(), 1.0))
        idxs.append(torch.nonzero(m & (u < keep)).flatten()[:cap])
    ti, pi = t < 0, p < 0
    scalars += [c.to(torch.float64) for c in (torch.count_nonzero(ti & pi),
                                              torch.count_nonzero(ti), torch.count_nonzero(pi))]
    fetched = torch.stack(scalars).cpu().numpy()  # every scalar in one copy
    k = 2 * len(thresholds)
    tp, t1, p1 = (int(v) for v in fetched[k:k + 3])
    cm = np.array([[n - t1 - p1 + tp, p1 - tp], [t1 - tp, tp]], np.int64)
    out = {f"nmse_{thr}": float(fetched[2 * i]) for i, thr in enumerate(thresholds)}
    out["sign_accuracy"] = (cm[0, 0] + cm[1, 1]) / max(n, 1)
    out["confusion"] = cm
    out["mismatch_counts"] = [int(fetched[2 * i + 1]) for i in range(len(thresholds))]
    out["mismatch_indices"] = [ix.cpu().numpy() for ix in idxs]
    return out
