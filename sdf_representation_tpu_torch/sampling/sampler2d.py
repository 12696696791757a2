"""2D polygon sampling with exact signed distances — counterpart of
sdf_representation_tpu/sampling/sampler2d.py (reference
datagenerator/data_generator.py:540-640 `generate_signed_distance_2D_msh`,
whose shipped version exits after writing surface.csv, picks the nearest
segment by a 2-NN over segment midpoints and labels the uniform points with
the circle formula).

Every sample gets the EXACT polygon SDF: point-to-segment distance over all
segments, and ray-casting parity for the sign (the sign convention of the
reference's compute_distance_vector :139-214). Normals are the SDF gradient
direction (point - closest) / distance * sign. numpy float64 on the host,
as in the JAX package; the results are ``Frame``s.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple, Union

import numpy as np

from ..geometry.msh_io import extract_polygon_from_msh
from ..utils.constants import RANDOM_SEED_DATA_GENERATION
from .sampler import COLUMNS, Frame


def polygon_sdf(points_2d: np.ndarray, polygon: np.ndarray):
    """Exact signed distance of 2D points to a closed polygon.

    points_2d: (N, 2); polygon: (M, 2) closed or open (auto-closed).
    Returns (sdf (N,), normals (N, 2)) — negative inside.
    """
    pts = np.asarray(points_2d, dtype=np.float64)
    poly = np.asarray(polygon, dtype=np.float64)
    if not np.allclose(poly[0], poly[-1]):
        poly = np.vstack([poly, poly[:1]])
    a = poly[:-1]  # (M, 2) segment starts
    b = poly[1:]  # segment ends
    ab = b - a  # (M, 2)
    ab_len2 = np.maximum(np.einsum("md,md->m", ab, ab), 1e-300)

    # (N, M) closest point parameter, clamped
    ap = pts[:, None, :] - a[None, :, :]  # (N, M, 2)
    t = np.clip(np.einsum("nmd,md->nm", ap, ab) / ab_len2, 0.0, 1.0)
    closest = a[None, :, :] + t[..., None] * ab[None, :, :]  # (N, M, 2)
    diff = pts[:, None, :] - closest
    d2 = np.einsum("nmd,nmd->nm", diff, diff)
    best = np.argmin(d2, axis=1)
    idx = np.arange(len(pts))
    dist = np.sqrt(d2[idx, best])
    dvec = diff[idx, best]  # (N, 2)

    # ray casting parity (horizontal ray toward +x), the reference's test
    # (:205-214)
    ay, by = a[None, :, 1], b[None, :, 1]
    py = pts[:, 1:2]
    straddles = ((ay <= py) & (by > py)) | ((ay > py) & (by <= py))
    with np.errstate(divide="ignore", invalid="ignore"):
        x_int = a[None, :, 0] + (py - ay) * ab[None, :, 0] / np.where(
            np.abs(ab[None, :, 1]) > 0, ab[None, :, 1], np.inf
        )
    crossings = np.sum(straddles & (pts[:, 0:1] < x_int), axis=1)
    inside = crossings % 2 == 1
    sign = np.where(inside, -1.0, 1.0)

    sdf = sign * dist
    with np.errstate(divide="ignore", invalid="ignore"):
        normal = np.where(
            dist[:, None] > 1e-12, sign[:, None] * dvec / dist[:, None], 0.0
        )
    return sdf, normal


def _frame(pts_2d, polygon) -> Frame:
    sdf, n2 = polygon_sdf(pts_2d, polygon)
    n = len(pts_2d)
    return Frame(COLUMNS, np.column_stack(
        [pts_2d[:, 0], pts_2d[:, 1], np.zeros(n), sdf, n2[:, 0], n2[:, 1], np.zeros(n)]))


def sample_polygon_boundary(polygon: np.ndarray, n_points: int, rng) -> np.ndarray:
    """Points uniformly on the polygon boundary (length-weighted)."""
    poly = np.asarray(polygon, dtype=np.float64)
    if not np.allclose(poly[0], poly[-1]):
        poly = np.vstack([poly, poly[:1]])
    a, b = poly[:-1], poly[1:]
    seg_len = np.linalg.norm(b - a, axis=1)
    probs = seg_len / seg_len.sum()
    seg = rng.choice(len(a), size=n_points, p=probs)
    t = rng.uniform(size=n_points)
    return a[seg] + t[:, None] * (b[seg] - a[seg])


def generate_signed_distance_2D_msh(
    uniform_points: int,
    narrow_points: int,
    on_surface_points: int,
    width: float,
    geometry_path: Union[str, np.ndarray],
    save_path: Optional[str] = None,
    seed: int = RANDOM_SEED_DATA_GENERATION,
) -> Tuple[Frame, Frame, Frame]:
    """Polygon from a .msh (or an array) -> uniform / surface / narrow-band
    frames with exact polygon SDF labels, written as uniform.csv,
    surface.csv and narrow.csv (with the index column) under ``save_path``.

    Returns (uniform, narrow, on_surface), the JAX package's order.
    """
    if isinstance(geometry_path, str):
        polygon = extract_polygon_from_msh(geometry_path)
    else:
        polygon = np.asarray(geometry_path, dtype=np.float64)
    rng = np.random.default_rng(seed)

    uni = rng.uniform(-1, 1, size=(uniform_points, 2))
    uniform = _frame(uni, polygon)

    surf = sample_polygon_boundary(polygon, on_surface_points, rng)
    surface = _frame(surf, polygon)

    base = sample_polygon_boundary(polygon, narrow_points, rng)
    # on-boundary normals are ill-defined from distance: the offset follows
    # the normal at a small outward probe
    offs = rng.uniform(-width, width, size=narrow_points)
    probe = base + 1e-6 * np.ones_like(base)
    _, probe_normal = polygon_sdf(probe, polygon)
    nb = base + offs[:, None] * np.where(
        np.linalg.norm(probe_normal, axis=1, keepdims=True) > 0, probe_normal, 0.0
    )
    narrow = _frame(nb, polygon)

    if save_path:
        for name, frame in (("uniform", uniform), ("surface", surface), ("narrow", narrow)):
            frame.to_csv(os.path.join(save_path, f"{name}.csv"))
    return uniform, narrow, surface
