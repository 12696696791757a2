"""2D contour validation against the analytic circle — counterpart of
sdf_representation_tpu/evaluations/two_dim.py (reference
executor/executor.py:402-480, Executor.two_dim_contour).

The best checkpoint's field is evaluated on a 2D slice grid (z = 0) in
float32 with the module's own forward (``ops.grid_eval.evaluate_points``, no
fused kernel); the points with |f| < CONTOUR_EPS are the contour, and their
distances from the origin are written to contour_distances.csv (columns
x, y, r, no index). The plot of the field with the analytic circle
r = sqrt(2/pi) overlaid is drawn where matplotlib is installed; where it is
not, one line says so.

Divergence from the JAX package: it imports matplotlib first, so without
matplotlib it fails before it writes the CSV; here the CSV is written
either way.
"""

from __future__ import annotations

import os

import numpy as np

from ..ops.grid_eval import evaluate_points

CONTOUR_EPS = 2.0 ** -10


def two_dim_contour(trainer, resolution: int = 512) -> np.ndarray:
    """Write the contour of the best checkpoint's field; returns the contour
    points' distances from the origin."""
    _, epoch = trainer.load_model(best=True)
    ax_vals = np.linspace(-1, 1, resolution, dtype=np.float32)
    xx, yy = np.meshgrid(ax_vals, ax_vals, indexing="ij")
    pts = np.stack([xx.ravel(), yy.ravel(), np.zeros(xx.size, np.float32)], axis=1)
    sdf = evaluate_points(trainer.model, pts)

    near = np.abs(sdf) < CONTOUR_EPS
    contour_pts = pts[near]
    dists = np.linalg.norm(contour_pts[:, :2], axis=1)
    np.savetxt(os.path.join(trainer.postprocess_save_path, "contour_distances.csv"),
               np.column_stack([contour_pts[:, 0], contour_pts[:, 1], dists]),
               fmt="%.9g", delimiter=",", header="x,y,r", comments="")

    try:
        import matplotlib
    except ImportError:
        print("contour plot skipped: matplotlib is not installed")
        return dists
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    radius = np.sqrt(2.0 / np.pi)
    fig, ax = plt.subplots(figsize=(6, 6))
    im = ax.contourf(xx, yy, sdf.reshape(resolution, resolution), levels=30)
    theta = np.linspace(0, 2 * np.pi, 256)
    ax.plot(radius * np.cos(theta), radius * np.sin(theta), "r--", label="analytic")
    if len(contour_pts):
        ax.scatter(contour_pts[:, 0], contour_pts[:, 1], s=1, c="k", label="predicted")
    ax.set_aspect("equal")
    ax.legend()
    fig.colorbar(im)
    fig.savefig(os.path.join(trainer.plot_save_path, f"contour_epoch{epoch}.png"), dpi=120)
    plt.close(fig)
    return dists
