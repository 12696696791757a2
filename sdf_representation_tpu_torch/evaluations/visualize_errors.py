"""3D scatter heatmaps of pointwise error / normal similarity — counterpart
of sdf_representation_tpu/evaluations/visualize_errors.py (reference
utils/visualize_errors.py:8-89 `plot_errors`): reads error_points.csv /
similarity_points.csv from a directory and renders (a) an error heatmap,
(b) a similarity heatmap, (c) a red/blue thresholded plot (threshold 1/256
like the reference). matplotlib is imported only when a plot is drawn."""

from __future__ import annotations

import os

import numpy as np

from ..data.dataset import frame_from_csv

THRESHOLD = 1.0 / 256.0


def _scatter3d(ax, pts, c, title, cmap="viridis"):
    sc = ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], c=c, s=2, cmap=cmap)
    ax.set_title(title)
    return sc


def plot_errors(save_path: str) -> None:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    err_csv = os.path.join(save_path, "error_points.csv")
    sim_csv = os.path.join(save_path, "similarity_points.csv")

    if os.path.exists(err_csv):
        frame = frame_from_csv(err_csv)
        pts = np.column_stack([frame[c] for c in ("x", "y", "z")])
        err = frame["error"]

        fig = plt.figure(figsize=(10, 5))
        ax = fig.add_subplot(121, projection="3d")
        sc = _scatter3d(ax, pts, err, "abs SDF error")
        fig.colorbar(sc, ax=ax, shrink=0.6)

        ax2 = fig.add_subplot(122, projection="3d")
        above = err > THRESHOLD
        ax2.scatter(*pts[above].T, c="red", s=2, label=f"err > 1/256 ({above.sum()})")
        ax2.scatter(*pts[~above].T, c="blue", s=1, alpha=0.2, label="ok")
        ax2.set_title("thresholded")
        ax2.legend()
        fig.savefig(os.path.join(save_path, "error_heatmap.png"), dpi=110)
        plt.close(fig)

    if os.path.exists(sim_csv):
        frame = frame_from_csv(sim_csv)
        pts = np.column_stack([frame[c] for c in ("x", "y", "z")])
        fig = plt.figure(figsize=(5, 5))
        ax = fig.add_subplot(111, projection="3d")
        sc = _scatter3d(ax, pts, frame["similarity"], "normal cosine similarity", cmap="coolwarm")
        fig.colorbar(sc, ax=ax, shrink=0.6)
        fig.savefig(os.path.join(save_path, "similarity_heatmap.png"), dpi=110)
        plt.close(fig)
