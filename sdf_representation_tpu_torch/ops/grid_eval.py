"""Dense voxel-grid SDF evaluation with the plain module forward.

Counterpart of sdf_representation_tpu/ops/grid_eval.py: coordinates are
made from the flat index as -1 + step*i in f32 (grid_eval.py:49-60), in
chunks, so the n^3 x 3 coordinate array is never materialised whole. The
reconstruction path uses the fused kernels (ops/fused_mlp.py); this is the
plain reference they are compared with.

Grid convention: linspace(-1, 1, n) per axis, 'ij' indexing,
flat = x*n^2 + y*n + z.
"""

from __future__ import annotations

import numpy as np
import torch

from .fused_mlp import grid_points


def grid_axis(n: int) -> np.ndarray:
    return np.linspace(-1.0, 1.0, n, dtype=np.float64)


def grid_coords(n: int) -> np.ndarray:
    """(n^3, 3) float32 coordinates in reference ordering (host helper)."""
    ax = grid_axis(n).astype(np.float32)
    g = np.stack(np.meshgrid(ax, ax, ax, indexing="ij"), axis=-1)
    return g.reshape(-1, 3)


def evaluate_grid(model, n: int, chunk: int = 262144) -> torch.Tensor:
    """The module's own f32 forward on the dense n^3 grid: (n, n, n) f32 on
    the module's device."""
    device = next(model.parameters()).device
    total = n ** 3
    out = torch.empty(total, dtype=torch.float32, device=device)
    with torch.no_grad():
        for start in range(0, total, chunk):
            stop = min(total, start + chunk)
            out[start:stop] = model(grid_points(n, start, stop, device))
    return out.reshape(n, n, n)
