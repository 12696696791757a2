"""Procedural test/benchmark geometries (no external assets needed).

The port's own copy of sdf_representation_tpu/geometry/primitives.py (numpy
only), so the port imports nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np

from .mesh_io import Mesh


def make_box(half_extents=(0.5, 0.5, 0.5), center=(0.0, 0.0, 0.0)) -> Mesh:
    """Axis-aligned box, 12 triangles, outward-oriented."""
    h = np.asarray(half_extents, dtype=np.float64)
    c = np.asarray(center, dtype=np.float64)
    corners = np.array(
        [[x, y, z] for x in (-1, 1) for y in (-1, 1) for z in (-1, 1)],
        dtype=np.float64,
    )  # index bits: x<<2 | y<<1 | z
    verts = corners * h + c
    quads = [
        (0, 1, 3, 2),  # -x
        (4, 6, 7, 5),  # +x
        (0, 4, 5, 1),  # -y
        (2, 3, 7, 6),  # +y
        (0, 2, 6, 4),  # -z
        (1, 5, 7, 3),  # +z
    ]
    faces = []
    for a, b, cc, d in quads:
        faces.append([a, b, cc])
        faces.append([a, cc, d])
    return Mesh(verts, np.asarray(faces, dtype=np.int64))


def box_sdf(points: np.ndarray, half_extents=(0.5, 0.5, 0.5)) -> np.ndarray:
    """Analytic SDF of the axis-aligned box (negative inside)."""
    p = np.abs(np.asarray(points, dtype=np.float64))
    q = p - np.asarray(half_extents)
    outside = np.linalg.norm(np.maximum(q, 0.0), axis=-1)
    inside = np.minimum(np.max(q, axis=-1), 0.0)
    return outside + inside


def make_icosphere(subdivisions: int = 3, radius: float = 0.5) -> Mesh:
    """Unit icosahedron subdivided + projected to the sphere of given radius."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array(
        [
            [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
            [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
            [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
        ],
        dtype=np.float64,
    )
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.array(
        [
            [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
            [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
            [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
            [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
        ],
        dtype=np.int64,
    )
    for _ in range(subdivisions):
        # vectorized midpoint subdivision (the dict-per-edge loop took
        # minutes at the 10M+ face scales the labeling benchmarks use)
        e = faces[:, [0, 1, 1, 2, 2, 0]].reshape(-1, 2)  # (3F, 2) ab|bc|ca
        e = np.sort(e, axis=1)
        uniq, inv = np.unique(e, axis=0, return_inverse=True)
        mids = verts[uniq[:, 0]] + verts[uniq[:, 1]]
        mids /= np.linalg.norm(mids, axis=1, keepdims=True)
        mid_idx = (len(verts) + inv).reshape(-1, 3)  # (F, 3) ab, bc, ca
        a, b, c = faces[:, 0], faces[:, 1], faces[:, 2]
        ab, bc, ca = mid_idx[:, 0], mid_idx[:, 1], mid_idx[:, 2]
        faces = np.stack(
            [
                np.stack([a, ab, ca], 1),
                np.stack([b, bc, ab], 1),
                np.stack([c, ca, bc], 1),
                np.stack([ab, bc, ca], 1),
            ],
            axis=1,
        ).reshape(-1, 3)
        verts = np.concatenate([verts, mids])
    return Mesh(verts * radius, faces)


def make_torus(
    major_radius: float = 0.6,
    minor_radius: float = 0.25,
    n_major: int = 64,
    n_minor: int = 32,
) -> Mesh:
    """Torus around the z-axis (genus-1 test geometry)."""
    u = np.linspace(0, 2 * np.pi, n_major, endpoint=False)
    v = np.linspace(0, 2 * np.pi, n_minor, endpoint=False)
    uu, vv = np.meshgrid(u, v, indexing="ij")
    x = (major_radius + minor_radius * np.cos(vv)) * np.cos(uu)
    y = (major_radius + minor_radius * np.cos(vv)) * np.sin(uu)
    z = minor_radius * np.sin(vv)
    verts = np.stack([x, y, z], axis=-1).reshape(-1, 3)
    faces = []
    for i in range(n_major):
        for j in range(n_minor):
            a = i * n_minor + j
            b = ((i + 1) % n_major) * n_minor + j
            c = ((i + 1) % n_major) * n_minor + (j + 1) % n_minor
            d = i * n_minor + (j + 1) % n_minor
            faces += [[a, b, c], [a, c, d]]
    return Mesh(verts, np.asarray(faces, dtype=np.int64))


def torus_sdf(points, major_radius=0.6, minor_radius=0.25):
    p = np.asarray(points, dtype=np.float64)
    q = np.stack(
        [np.sqrt(p[:, 0] ** 2 + p[:, 1] ** 2) - major_radius, p[:, 2]], axis=-1
    )
    return np.linalg.norm(q, axis=-1) - minor_radius


def _cylinder_sdf(points, axis: int, c1: float, c2: float, radius: float):
    """Infinite cylinder along `axis`; (c1, c2) = center in the two other
    axes (in x<y<z order with `axis` removed)."""
    p = np.asarray(points, dtype=np.float64)
    other = [i for i in range(3) if i != axis]
    return (
        np.sqrt((p[..., other[0]] - c1) ** 2 + (p[..., other[1]] - c2) ** 2)
        - radius
    )


def bracket_sdf(points: np.ndarray) -> np.ndarray:
    """CSG field of a hard test geometry: flanged L-bracket with four bolt
    holes plus a detached block (the procedural stand-in for the reference's
    CAD showcase set, README.md:38-39 bunny/turbine/pipe — sharp edges, thin
    plates, genus 4, two connected components, total Euler characteristic -4).

    union = min, subtraction = max(a, -b); exact signs everywhere, exact
    distances on the surface away from the (measure-zero) CSG intersection
    curves — sufficient for zero-level-set extraction.
    """
    p = np.asarray(points, dtype=np.float64)
    # base plate: thin box in the x-y plane at the bottom
    base = box_sdf(p - [0.0, 0.0, -0.42], (0.7, 0.5, 0.08))
    # vertical plate rising from the back edge (sharp interior corner)
    wall = box_sdf(p - [0.0, -0.42, 0.08], (0.7, 0.08, 0.5))
    body = np.minimum(base, wall)
    # two bolt holes through the base plate (cylinders along z)
    for sx in (-0.35, 0.35):
        body = np.maximum(body, -_cylinder_sdf(p, 2, sx, 0.1, 0.12))
    # two bolt holes through the vertical plate (cylinders along y)
    for sx in (-0.35, 0.35):
        body = np.maximum(body, -_cylinder_sdf(p, 1, sx, 0.25, 0.12))
    # detached floating block (second connected component)
    block = box_sdf(p - [0.0, 0.25, 0.3], (0.12, 0.12, 0.12))
    return np.minimum(body, block)


def impeller_sdf(points: np.ndarray, n_blades: int = 6,
                 twist: float = 1.2) -> np.ndarray:
    """CSG field of the second hard showcase geometry: a shrouded impeller
    (turbine stand-in for the reference's CAD set, README.md:38-39
    bunny/turbine/pipe) — an annular hub, `n_blades` thin TWISTED blades,
    and an outer shroud ring. Thin curved plates, sharp edges, one
    connected component of genus 7 (hub torus + ring torus joined by 6
    handles), Euler characteristic -12.

    union = min, subtraction = max(a, -b). The blade SDF is evaluated in a
    z-dependent rotated frame (twist*z about z): the rotation is bijective,
    so SIGNS and the zero set are exact everywhere; distances distort
    slightly off-surface (irrelevant for level-set extraction, which only
    interpolates sign crossings)."""
    p = np.asarray(points, dtype=np.float64)
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    r = np.sqrt(x * x + y * y)
    # annular hub: 0.10 <= r <= 0.30, |z| <= 0.16
    hub = np.maximum(
        np.maximum(r - 0.30, np.abs(z) - 0.16), 0.10 - r
    )
    # shroud ring: 0.72 <= r <= 0.84, |z| <= 0.10
    ring = np.maximum(
        np.maximum(r - 0.84, np.abs(z) - 0.10), 0.72 - r
    )
    body = np.minimum(hub, ring)
    # blades: radial boxes in the twisted frame, spanning hub -> ring
    for k in range(n_blades):
        ang = 2.0 * np.pi * k / n_blades + twist * z
        c, s = np.cos(ang), np.sin(ang)
        xr = c * x + s * y - 0.51
        yr = -s * x + c * y
        blade = np.maximum(
            np.maximum(np.abs(xr) - 0.26, np.abs(yr) - 0.035),
            np.abs(z) - 0.09,
        )
        body = np.minimum(body, blade)
    return body


def make_impeller(resolution: int = 192, n_blades: int = 6,
                  twist: float = 1.2) -> Mesh:
    """Triangle mesh of `impeller_sdf`, extracted with the project's own
    marching cubes on a resolution^3 grid over [-1, 1]^3."""
    from ..ops.marching import marching_cubes

    ax = np.linspace(-1.0, 1.0, resolution, dtype=np.float64)
    pts = np.stack(np.meshgrid(ax, ax, ax, indexing="ij"), axis=-1)
    vol = impeller_sdf(
        pts.reshape(-1, 3), n_blades=n_blades, twist=twist
    ).reshape(resolution, resolution, resolution)
    step = 2.0 / (resolution - 1)
    verts, faces = marching_cubes(
        vol.astype(np.float32), 0.0, (step, step, step), (-1.0, -1.0, -1.0)
    )
    return Mesh(verts, faces)


def make_bracket(resolution: int = 192) -> Mesh:
    """Triangle mesh of `bracket_sdf`, extracted with the project's own
    marching cubes on a resolution^3 grid over [-1, 1]^3."""
    from ..ops.marching import marching_cubes

    ax = np.linspace(-1.0, 1.0, resolution, dtype=np.float64)
    pts = np.stack(np.meshgrid(ax, ax, ax, indexing="ij"), axis=-1)
    vol = bracket_sdf(pts.reshape(-1, 3)).reshape(resolution, resolution,
                                                  resolution)
    step = 2.0 / (resolution - 1)
    verts, faces = marching_cubes(
        vol.astype(np.float32), 0.0, (step, step, step), (-1.0, -1.0, -1.0)
    )
    return Mesh(verts, faces)
