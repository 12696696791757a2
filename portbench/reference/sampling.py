"""The labelled points' draws and the train/validation split, worked out again.

The sampler's published procedure (the reference repository's
data_generator.py:810-910, which the port keeps draw for draw): from
``numpy.random.default_rng(seed)``, ``n_uniform`` points ~ U(-1, 1)^3; then
``surface`` points per triangle at barycentric weights u / sum(u), u ~ U(0,
1)^3; then min(surface, narrow) points per triangle at such weights, moved
along the unit face normal by U(-width, width). The dataset is uniform, then
surface, then narrow-band rows; the validation rows are the first
ceil(test_size * n) of ``numpy.random.RandomState(42).permutation(n)`` and
the training rows the rest (scikit-learn's ``train_test_split``).
"""

from __future__ import annotations

import math

import numpy as np


def draw_points(vertices, faces, n_uniform: int, surface: int, narrow: int, width: float,
                seed: int):
    """(uniform (U, 3), surface (F*surface, 3), narrow (F*k, 3)) float64."""
    tri = np.asarray(vertices, np.float64)[np.asarray(faces)]
    rng = np.random.default_rng(seed)
    uniform = rng.uniform(-1.0, 1.0, size=(int(n_uniform), 3))

    def bary(k):
        u = rng.uniform(0.0, 1.0, size=(len(tri), k, 3))
        return u / u.sum(axis=-1, keepdims=True)

    on_surface = np.einsum("fkc,fcd->fkd", bary(surface), tri).reshape(-1, 3)
    k = min(surface, narrow)
    near = np.einsum("fkc,fcd->fkd", bary(k), tri)
    normal = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    length = np.linalg.norm(normal, axis=1, keepdims=True)
    normal = np.where(length > 0, normal / np.maximum(length, 1e-300), 0.0)
    offset = rng.uniform(-width, width, size=(len(tri), k))
    near = (near + offset[..., None] * normal[:, None, :]).reshape(-1, 3)
    return uniform, on_surface, near


def split(n: int, test_size: float, seed: int = 42):
    """(training rows, validation rows) of n rows."""
    n_test = math.ceil(test_size * n)
    perm = np.random.RandomState(seed).permutation(n)
    return perm[n_test:], perm[:n_test]
