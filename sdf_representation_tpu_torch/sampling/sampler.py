"""Labeled point sampling for SDF training — counterpart of
sdf_representation_tpu/sampling/sampler.py (reference
datagenerator/data_generator.py:810-910).

The sweep over triangles is batched numpy on the host, with the same
``default_rng`` draw order as the JAX package, so the sampled points are
bit-identical to its; the labels come from ``ops/sdf_exact.signed_distance``
on the device.

Distribution semantics kept:
  * uniform points ~ U(-1, 1)^3
  * per-triangle surface points with barycentric weights w = u/(u1+u2+u3),
    u ~ U(0,1)^3 — NOT area-uniform (the reference's bias toward triangle
    centers is kept; ``area_weighted=True`` draws an area-uniform sample)
  * narrow-band points: barycentric point + face normal * U(-width, width);
    the reference zips num_points_surface barycentric points against
    num_points_narrow_band widths, truncating to the min — same here
  * dataset columns x,y,z,S,nx,ny,nz; seed RANDOM_SEED_DATA_GENERATION = 100.

Frames are a small numpy record (``Frame``), not pandas; ``Frame.to_csv``
writes the layout pandas gives ``DataFrame.to_csv`` (a leading index column).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Tuple, Union

import numpy as np

from ..geometry.mesh_io import Mesh, load_mesh
from ..ops.sdf_exact import signed_distance
from ..utils.constants import RANDOM_SEED_DATA_GENERATION

COLUMNS = ("x", "y", "z", "S", "nx", "ny", "nz")

# host-clock seconds of the stages of the last generate_signed_distance_data
# ("sample" on the host, "label" up to the labels' arrival on the host)
LAST_STAGE_SECONDS: dict = {}


@dataclasses.dataclass
class Frame:
    """A table of float64 rows under named columns."""

    columns: Tuple[str, ...]
    values: np.ndarray  # (N, len(columns)) float64

    def __len__(self) -> int:
        return len(self.values)

    def __getitem__(self, column: str) -> np.ndarray:
        return self.values[:, self.columns.index(column)]

    def to_csv(self, path: str) -> None:
        """``,x,y,...`` header and a leading row-index column: the file
        pandas writes. Values are written with 17 significant digits, so
        they read back exactly."""
        values = np.asarray(self.values, np.float64).reshape(len(self.values), len(self.columns))
        values = np.column_stack([np.arange(len(values), dtype=np.float64), values])
        np.savetxt(path, values, fmt=["%d"] + ["%.17g"] * len(self.columns), delimiter=",",
                   header="," + ",".join(self.columns), comments="")


def _as_mesh(geometry: Union[str, Mesh]) -> Mesh:
    return load_mesh(geometry) if isinstance(geometry, str) else geometry


def _barycentric(rng: np.random.Generator, n_tri: int, k: int) -> np.ndarray:
    """(F, k, 3) barycentric weights, u/(sum u) like the reference."""
    u = rng.uniform(0.0, 1.0, size=(n_tri, k, 3))
    return u / u.sum(axis=-1, keepdims=True)


def sample_surface_points(
    mesh: Mesh,
    points_per_triangle: int,
    rng: np.random.Generator,
    area_weighted: bool = False,
    total_points: Optional[int] = None,
) -> np.ndarray:
    """Barycentric surface samples. Default: fixed count per triangle
    (reference behavior); area_weighted draws triangle indices in proportion
    to area for a statistically uniform surface measure."""
    tri = mesh.triangles  # (F, 3, 3)
    if area_weighted:
        n = total_points or points_per_triangle * len(tri)
        areas = mesh.face_areas()
        probs = areas / areas.sum()
        idx = rng.choice(len(tri), size=n, p=probs)
        # sqrt trick = uniform over each triangle
        r1 = np.sqrt(rng.uniform(size=n))
        r2 = rng.uniform(size=n)
        w = np.stack([1 - r1, r1 * (1 - r2), r1 * r2], axis=1)
        return np.einsum("nc,ncd->nd", w, tri[idx])
    bary = _barycentric(rng, len(tri), points_per_triangle)
    return np.einsum("fkc,fcd->fkd", bary, tri).reshape(-1, 3)


def sample_narrow_band_points(
    mesh: Mesh,
    points_per_triangle: int,
    width_count: int,
    width: float,
    rng: np.random.Generator,
) -> np.ndarray:
    """Surface samples offset by face-normal * U(-width, width). The zip
    truncation quirk (count = min of the two) is reproduced so datasets are
    size-compatible."""
    k = min(points_per_triangle, width_count)
    tri = mesh.triangles
    bary = _barycentric(rng, len(tri), k)
    pts = np.einsum("fkc,fcd->fkd", bary, tri)  # (F, k, 3)
    normals = mesh.face_normals()  # (F, 3); degenerate -> 0
    areas2 = np.linalg.norm(
        np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]), axis=1
    )
    normals = np.where(areas2[:, None] > 0, normals, 0.0)
    widths = rng.uniform(-width, width, size=(len(tri), k))
    return (pts + widths[..., None] * normals[:, None, :]).reshape(-1, 3)


def _label(points: np.ndarray, mesh: Mesh, device=None) -> Frame:
    """Attach exact signed distance + normals (computed on the device).

    Keeps the reference's empty-input sentinel (data_generator.py:882-886:
    a single (0,0,0) point labeled S = -0.5, n = 0)."""
    if len(points) == 0:
        points = np.zeros((1, 3), dtype=np.float64)
        S = np.array([-0.5])
        n = np.zeros((1, 3))
    else:
        S, n = signed_distance(points, mesh, device=device)
    return Frame(COLUMNS, np.column_stack((points, S, n)))


def generate_signed_distance_data(
    geometry: Union[str, Mesh],
    num_points_uniform: int,
    num_points_surface: int,
    num_points_narrow_band: int,
    dense_width: float = 0.1,
    area_weighted: bool = False,
    seed: int = RANDOM_SEED_DATA_GENERATION,
    device=None,
) -> Tuple[Frame, Frame, Frame]:
    """Main 3D sampler (cf. data_generator.py:810-910).

    Returns (uniform, on_surface, narrow_band) frames, each with columns
    x,y,z,S,nx,ny,nz."""
    t0 = time.perf_counter()
    mesh = _as_mesh(geometry)
    rng = np.random.default_rng(seed)
    uniform_pts = rng.uniform(-1.0, 1.0, size=(int(num_points_uniform), 3))
    surface_pts = sample_surface_points(
        mesh, num_points_surface, rng, area_weighted=area_weighted
    )
    narrow_pts = sample_narrow_band_points(
        mesh, num_points_surface, num_points_narrow_band, dense_width, rng
    )
    t1 = time.perf_counter()
    on_surface = _label(surface_pts, mesh, device)
    uniform = _label(uniform_pts, mesh, device)
    narrow = _label(narrow_pts, mesh, device)
    LAST_STAGE_SECONDS.update(sample=t1 - t0, label=time.perf_counter() - t1)
    return uniform, on_surface, narrow


def generate_signed_distance(query_points: np.ndarray, geometry: Union[str, Mesh],
                             device=None) -> Frame:
    """Label arbitrary query points (cf. data_generator.py:273-301)."""
    return _label(np.asarray(query_points, dtype=np.float64), _as_mesh(geometry), device)
