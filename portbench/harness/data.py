"""The cells' inputs, made from the configuration and the seed.

The shape: a configuration's ``geometry`` names one of the port's primitive
meshes at a resolution, rescaled into the unit cube as the port's CLI
rescales an STL (``rescale = True``). It is the input both sides read: the
program samples and labels it, the reference labels the same points again.

The point cloud of a point-cloud cell is the benchmark's own: ``per_face``
points on every triangle at barycentric weights u / sum(u), shuffled, float32,
drawn from the seed.
"""

from __future__ import annotations

import numpy as np

# the trainers' generators take ((init_seed + 1) << 44) + ... as a 64-bit seed
INIT_SEED_MOD = (1 << 20) - 1


def init_seed(seed: int) -> int:
    return int(seed) % INIT_SEED_MOD


def stand_in(geometry: dict):
    """(vertices (V, 3) float64, faces (F, 3) int64)."""
    from sdf_representation_tpu_torch.geometry import primitives
    from sdf_representation_tpu_torch.geometry.rescale import rescale_mesh

    mesh = {"impeller": primitives.make_impeller}[geometry["shape"]](int(geometry["resolution"]))
    if geometry.get("rescale", True):
        mesh = rescale_mesh(mesh)
    return np.asarray(mesh.vertices, np.float64), np.asarray(mesh.faces, np.int64)


def point_cloud(vertices, faces, per_face: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng([int(seed) % (1 << 63), 7])
    tri = vertices[faces]
    u = rng.uniform(0.0, 1.0, size=(len(tri), per_face, 3))
    pts = np.einsum("fkc,fcd->fkd", u / u.sum(axis=-1, keepdims=True), tri).reshape(-1, 3)
    return np.ascontiguousarray(pts[rng.permutation(len(pts))], dtype=np.float32)
