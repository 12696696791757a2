"""Geometry rescaling into the unit cube — semantics of Executor.rescale
(reference executor/executor.py:59-85): scale so |volume| equals half the
[-1,1]^3 cube, center at the vertex mean, then shrink until
max|coord| + 0.15 < 1. Idempotent via the *_rescaled.stl cache file.

The port's own copy of sdf_representation_tpu/geometry/rescale.py (numpy
only)."""

from __future__ import annotations

import os

import numpy as np

from .mesh_io import Mesh, load_mesh, save_mesh


def rescale_mesh(mesh: Mesh) -> Mesh:
    out = mesh.copy()
    desired_volume = 0.5 * (1 - (-1)) ** 3
    vol = abs(out.volume)
    if vol > 0:
        out.vertices = out.vertices * (desired_volume / vol) ** (1.0 / 3.0)
    out.vertices = out.vertices - out.vertices.mean(axis=0)
    max_abs = np.max(np.abs(out.vertices))
    # closed form of the reference's *=0.99999 loop (executor.py:80-81)
    limit = 1.0 - 0.15
    if max_abs > limit:
        out.vertices = out.vertices * (limit / max_abs) * 0.999999
    return out


def rescale_file(geometry_path: str, rescaled_path: str) -> str:
    """Load -> rescale -> export STL, skipping if the cache already exists."""
    if not os.path.exists(rescaled_path):
        mesh = load_mesh(geometry_path)
        save_mesh(rescale_mesh(mesh), rescaled_path, file_type="stl")
    return rescaled_path
