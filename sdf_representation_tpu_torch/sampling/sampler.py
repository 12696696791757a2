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

Also the analytic fixtures (the sphere, the 2-D circle at z = 0: numpy only,
bit-identical to the JAX package's), the dense occupancy grid and the
mismatch loop (the audit's mismatching coordinates labelled into
mismatch.csv), whose labels come from ``signed_distance`` on the device.

Frames are a small numpy record (``Frame``), not pandas; ``Frame.to_csv``
writes the layout pandas gives ``DataFrame.to_csv`` (a leading index column,
or the row labels of a labelled frame such as the classification report).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple, Union

import numpy as np

from ..geometry.mesh_io import Mesh, load_mesh
from ..ops.sdf_exact import signed_distance
from ..utils.constants import RANDOM_SEED_DATA_GENERATION
from ..utils.profiling import span

COLUMNS = ("x", "y", "z", "S", "nx", "ny", "nz")

# host-clock seconds of the stages of the last generate_signed_distance_data
# ("sample" on the host, "label" up to the labels' arrival on the host): the
# spans sampler.draw and sampler.label
LAST_STAGE_SECONDS: dict = {}


@dataclasses.dataclass
class Frame:
    """A table of float64 rows under named columns, the rows labelled
    (``index``) or numbered from 0."""

    columns: Tuple[str, ...]
    values: np.ndarray  # (N, len(columns)) float64
    index: Optional[Tuple[str, ...]] = None

    def __len__(self) -> int:
        return len(self.values)

    def __getitem__(self, column: str) -> np.ndarray:
        return self.values[:, self.columns.index(column)]

    def to_csv(self, path: str, index: bool = True, mode: str = "w", header: bool = True) -> None:
        """The rows pandas' ``DataFrame.to_csv(path, index=, mode=, header=)``
        writes: a ``,x,y,...`` header line (``x,y,...`` without the index)
        and, with ``index``, a leading row-index column from 0, also in a
        block appended with ``mode="a"``. Values are written with 17
        significant digits, so they read back exactly. A labelled frame
        writes its labels and each value as ``repr`` of the float, as pandas
        does for a float64 frame."""
        values = np.asarray(self.values, np.float64).reshape(len(self.values), len(self.columns))
        if self.index is not None:
            with open(path, mode) as f:
                if header:
                    f.write("," * index + ",".join(self.columns) + "\n")
                for label, row in zip(self.index, values.tolist()):
                    f.write((f"{label}," if index else "") + ",".join(map(repr, row)) + "\n")
            return
        fmt, names = ["%.17g"] * len(self.columns), ",".join(self.columns)
        if index:
            values = np.column_stack([np.arange(len(values), dtype=np.float64), values])
            fmt, names = ["%d"] + fmt, "," + names
        with open(path, mode) as f:
            np.savetxt(f, values, fmt=fmt, delimiter=",", header=names if header else "",
                       comments="")


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
    with span("sampler.frame"):
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
    x,y,z,S,nx,ny,nz. Spans: ``sampler.draw`` (the points drawn) then
    ``sampler.label``, which holds the three labellings."""
    with span("sampler.draw", LAST_STAGE_SECONDS, "sample"):
        mesh = _as_mesh(geometry)
        rng = np.random.default_rng(seed)
        uniform_pts = rng.uniform(-1.0, 1.0, size=(int(num_points_uniform), 3))
        surface_pts = sample_surface_points(
            mesh, num_points_surface, rng, area_weighted=area_weighted
        )
        narrow_pts = sample_narrow_band_points(
            mesh, num_points_surface, num_points_narrow_band, dense_width, rng
        )
    with span("sampler.label", LAST_STAGE_SECONDS, "label"):
        on_surface = _label(surface_pts, mesh, device)
        uniform = _label(uniform_pts, mesh, device)
        narrow = _label(narrow_pts, mesh, device)
    return uniform, on_surface, narrow


def generate_signed_distance(query_points: np.ndarray, geometry: Union[str, Mesh],
                             device=None) -> Frame:
    """Label arbitrary query points (cf. data_generator.py:273-301)."""
    return _label(np.asarray(query_points, dtype=np.float64), _as_mesh(geometry), device)


def generate_occupancy(cube_size: int, geometry: Union[str, Mesh], device=None) -> Frame:
    """Dense-grid occupancy (sign of S) (cf. data_generator.py:307-350):
    columns x, y, z, occupancy."""
    axis = np.linspace(-1, 1, cube_size)
    g = np.stack(np.meshgrid(axis, axis, axis, indexing="ij"), axis=-1).reshape(-1, 3)
    S, _ = signed_distance(g, _as_mesh(geometry), device=device)
    return Frame(("x", "y", "z", "occupancy"), np.column_stack([g, np.sign(S)]))


# ---------------------------------------------------------------------------
# Analytic fixtures (correctness oracles)
# ---------------------------------------------------------------------------

def _radial_frame(pts: np.ndarray, radius: float) -> Frame:
    """Rows labelled with |p| - radius and the unit radial normal (0 at the
    origin)."""
    S = np.linalg.norm(pts, axis=1) - radius
    norms = np.linalg.norm(pts, axis=1, keepdims=True)
    n = np.divide(pts, norms, out=np.zeros_like(pts), where=norms > 0)
    return Frame(COLUMNS, np.column_stack([pts, S, n]))


def _save_frames(save_path: Optional[str], uniform: Frame, surface: Frame, narrow: Frame) -> None:
    if save_path:
        for name, frame in (("uniform", uniform), ("surface", surface), ("narrow", narrow)):
            frame.to_csv(os.path.join(save_path, f"{name}.csv"))


def generate_analytical_sphere(
    uniform_points: int,
    narrow_points: int,
    on_surface_points: int,
    save_path: Optional[str] = None,
    seed: int = RANDOM_SEED_DATA_GENERATION,
) -> Tuple[Frame, Frame, Frame]:
    """Analytic sphere r = 0.5 dataset incl. extra pole/axis points
    (cf. data_generator.py:392-466). Normals are unit (the reference stored
    the un-normalised point as 'normal'; unit normals are what the losses
    consume). Returns (uniform, narrow, surface)."""
    radius = 0.5
    rng = np.random.default_rng(seed)

    def spherical(r):
        n = len(r)
        theta = rng.uniform(0, 2 * np.pi, n)
        phi = rng.uniform(0, np.pi, n)
        return np.column_stack(
            [r * np.sin(phi) * np.cos(theta), r * np.sin(phi) * np.sin(theta), r * np.cos(phi)]
        )

    uniform = _radial_frame(spherical(rng.uniform(-1, 1, uniform_points)), radius)
    narrow = _radial_frame(spherical(rng.uniform(0.846, 0.854, narrow_points)), radius)

    surf = spherical(radius * np.ones(on_surface_points))
    n_extra = int(0.1 * on_surface_points)
    if n_extra > 0:
        axes = np.array(
            [[0, 0, 1], [0, 0, -1], [0, 1, 0], [0, -1, 0], [1, 0, 0], [-1, 0, 0]],
            dtype=np.float64,
        ) * radius
        jitter = rng.normal(0, 0.001, size=(6, n_extra, 3))
        near = axes[:, None, :] + jitter
        near = near / np.linalg.norm(near, axis=-1, keepdims=True) * radius
        surf = np.vstack([surf, near.reshape(-1, 3)])
    surface = _radial_frame(surf, radius)
    _save_frames(save_path, uniform, surface, narrow)
    return uniform, narrow, surface


def generate_points_circle(
    uniform_points: int,
    on_surface_points: int,
    narrow_points: int,
    width: float,
    save_path: Optional[str] = None,
    seed: int = RANDOM_SEED_DATA_GENERATION,
) -> Tuple[Frame, Frame, Frame]:
    """2D analytic circle r = sqrt(2/pi) at z = 0 (cf. data_generator.py:
    468-536). Returns (uniform, narrow, surface)."""
    radius = np.sqrt(2.0 / np.pi)
    rng = np.random.default_rng(seed)

    xy = rng.uniform(-1, 1, size=(uniform_points, 2))
    uniform = _radial_frame(np.column_stack([xy, np.zeros(uniform_points)]), radius)

    r = rng.uniform(radius - width, radius + width, narrow_points)
    th = rng.uniform(0, 2 * np.pi, narrow_points)
    narrow = _radial_frame(
        np.column_stack([r * np.cos(th), r * np.sin(th), np.zeros(narrow_points)]), radius)

    th = rng.uniform(0, 2 * np.pi, on_surface_points)
    surface = _radial_frame(
        np.column_stack([radius * np.cos(th), radius * np.sin(th), np.zeros(on_surface_points)]),
        radius)
    _save_frames(save_path, uniform, surface, narrow)
    return uniform, narrow, surface


def write_signed_distance_mismatch(
    query_points: np.ndarray,
    geometry: Union[str, Mesh],
    save_directory: str,
    device=None,
) -> str:
    """Label the post-process mismatching coordinates and write them as
    mismatch.csv so the next training round (mismatchuse = True) focuses on
    them (cf. reference data_generator.py:643-671 write_signed_distance_mismatch
    + load_data.py:44-45)."""
    frame = generate_signed_distance(query_points, geometry, device)
    path = os.path.join(save_directory, "mismatch.csv")
    frame.to_csv(path)
    return path


def augment_mismatch_from_postprocess(trainer, mesh_path: Optional[str] = None) -> str:
    """Close the mismatch loop: read mismatching_co-ordinates1.csv written by
    the audit (evaluations/post_process.py), label those points exactly on
    the trainer's device, write mismatch.csv into the trainer's data path.
    The mesh is ``mesh_path``, else the trainer's rescaled geometry where
    this trainer rescaled it, else ``config.geometry`` (the JAX package's
    rule)."""
    from ..data.dataset import frame_from_csv

    coords = frame_from_csv(os.path.join(trainer.postprocess_save_path,
                                         "mismatching_co-ordinates1.csv"))
    points = np.column_stack([coords[c] for c in ("x", "y", "z")])
    if mesh_path is None:
        mesh_path = getattr(trainer, "rescaled_path", None) or trainer.config.geometry
    return write_signed_distance_mismatch(points, mesh_path, trainer.data_path, trainer.device)
