"""Multi-file ("distributed") geometry sampling with resumable progress —
counterpart of sdf_representation_tpu/sampling/distributed.py (reference
datagenerator/data_generator.py:678-807: glob sub-directories for .ply
shards, global bbox with margin, `processed_files.log` resume journal,
corrupt-mesh skipping, append-to-surface.csv). As in the JAX package:

  * compute_min_max returns (min, max); the reference returned (max, min)
    and its caller unpacked (min, max) (data_generator.py:390 vs :702).
  * the files can be dealt out over hosts by (host_id, num_hosts).

Everything here runs on the host (numpy); no signed distance is computed.
"""

from __future__ import annotations

import glob
import os
from typing import Tuple

import numpy as np

from ..geometry.mesh_io import load_mesh
from ..utils.constants import RANDOM_SEED_DATA_GENERATION
from ..utils.files import create_directory
from .sampler import COLUMNS, Frame, sample_surface_points


def compute_min_max(geometry_dir: str, cache_name: str = "max_min.txt") -> Tuple[float, float]:
    """Global vertex (min, max) over all .ply files under geometry_dir,
    cached in max_min.txt (cf. data_generator.py:352-390)."""
    cache = os.path.join(geometry_dir, cache_name)
    if os.path.exists(cache):
        with open(cache) as f:
            vals = [float(v) for v in f.read().split()]
        return vals[0], vals[1]
    lo, hi = np.inf, -np.inf
    for path in sorted(glob.glob(os.path.join(geometry_dir, "**", "*.ply"), recursive=True)):
        try:
            mesh = load_mesh(path)
        except Exception:  # a corrupt shard adds nothing to the box
            continue
        lo = min(lo, float(mesh.vertices.min()))
        hi = max(hi, float(mesh.vertices.max()))
    with open(cache, "w") as f:
        f.write(f"{lo} {hi}\n")
    return lo, hi


def write_signed_distance_distributed(
    geometry_dir: str,
    save_directory: str,
    num_points_uniform: int = 0,
    num_points_surface: int = 0,
    num_points_narrow_band: int = 0,
    dense_width: float = 0.1,
    host_id: int = 0,
    num_hosts: int = 1,
    include_vertices: bool = True,
    seed: int = RANDOM_SEED_DATA_GENERATION,
    log_name: str = "processed_files.log",
) -> str:
    """Walk every .ply shard, append its surface points to surface.csv,
    journaling completed files so interrupted runs resume where they stopped
    (cf. data_generator.py:711-719, :804-805).

    The reference's shipped behaviour (vertices -> surface.csv,
    data_generator.py:745-801); with num_points_surface > 0 also that many
    barycentric surface samples per triangle. Each shard's block carries a
    row index from 0, as pandas' appending ``to_csv`` writes it.
    """
    create_directory(save_directory)
    log_path = os.path.join(save_directory, log_name)
    surface_csv = os.path.join(save_directory, "surface.csv")

    processed = set()
    if os.path.exists(log_path):
        with open(log_path) as f:
            processed = {line.strip() for line in f if line.strip()}

    lo, hi = compute_min_max(geometry_dir)
    span = hi - lo
    # 40% margin like the reference bbox handling (data_generator.py:702-709)
    scale = max(abs(lo - 0.4 * span), abs(hi + 0.4 * span), 1e-12)

    files = sorted(glob.glob(os.path.join(geometry_dir, "**", "*.ply"), recursive=True))
    files = [p for i, p in enumerate(files) if i % num_hosts == host_id]

    rng = np.random.default_rng(seed + host_id)
    for path in files:
        key = os.path.relpath(path, geometry_dir)
        if key in processed:
            continue
        try:
            mesh = load_mesh(path)
        except Exception as exc:  # corrupt shard: skip but journal it
            print(f"[distributed-sampling] skipping corrupt mesh {path}: {exc}")
            with open(log_path, "a") as f:
                f.write(key + "\n")
            continue

        rows = []
        if include_vertices and len(mesh.vertices):
            rows.append(mesh.vertices / scale)
        if num_points_surface > 0 and len(mesh.faces):
            rows.append(sample_surface_points(mesh, num_points_surface, rng) / scale)
        if rows:
            pts = np.concatenate(rows, axis=0)
            block = Frame(COLUMNS, np.column_stack([pts, np.zeros((len(pts), 4))]))
            block.to_csv(surface_csv, mode="a", header=not os.path.exists(surface_csv))

        with open(log_path, "a") as f:
            f.write(key + "\n")

    return surface_csv
