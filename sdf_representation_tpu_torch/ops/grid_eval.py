"""Dense voxel-grid and point SDF evaluation with the plain module forward.

Counterpart of sdf_representation_tpu/ops/grid_eval.py: coordinates are
made from the flat index as -1 + step*i in f32 (grid_eval.py:49-60), in
chunks, so the n^3 x 3 coordinate array is never materialised whole. The
reconstruction path uses the fused kernels (ops/fused_mlp.py); this is the
plain reference they are compared with. ``evaluate_points`` evaluates given
points in chunks (the 2-D contour's path), with ordinary torch operations
as the JAX package leaves it to XLA.

Grid convention: linspace(-1, 1, n) per axis, 'ij' indexing,
flat = x*n^2 + y*n + z.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.device import matmul_precision
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


def evaluate_points(model, points: np.ndarray, chunk: int = 262144,
                    compute_dtype: torch.dtype = torch.float32) -> np.ndarray:
    """(N, d) points -> (N,) float32 values of the module's own forward on
    its device, in chunks of ``chunk`` points, the last one padded with
    zero points (JAX grid_eval.py:80-130). ``compute_dtype`` bfloat16 runs
    on bfloat16 copies of the parameters and points (the output widened to
    float32); float32 runs the matrix products in full float32 (TF32 off).

    When a chunk does not fit in the card's memory
    (``torch.cuda.OutOfMemoryError``), the chunk is quartered and the sweep
    retried, down to 4096 points."""
    pts = np.asarray(points, dtype=np.float32)
    N = len(pts)
    chunk = min(chunk, max(N, 1))
    device = next(model.parameters()).device
    params = {k: v.to(compute_dtype) if v.is_floating_point() else v
              for k, v in model.named_parameters()}

    while True:
        n_chunks = -(-N // chunk)
        padded = n_chunks * chunk
        pts_pad = (np.concatenate([pts, np.zeros((padded - N, pts.shape[1]), np.float32)])
                   if padded != N else pts)
        try:
            out = np.empty(padded, np.float32)
            with torch.no_grad(), matmul_precision("highest"):
                for i in range(n_chunks):
                    x = torch.from_numpy(pts_pad[i * chunk:(i + 1) * chunk]).to(device)
                    f = torch.func.functional_call(model, params, (x.to(compute_dtype),))
                    out[i * chunk:(i + 1) * chunk] = f.float().cpu().numpy()
            return out[:N]
        except torch.cuda.OutOfMemoryError:
            if chunk <= 4096:
                raise
            chunk //= 4
            print(f"evaluate_points: chunk OOM, retrying with chunk={chunk}", flush=True)
