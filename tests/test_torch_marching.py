"""The port's copy of the numpy marching tetrahedra gives output identical
to the JAX package's on the same volume, numpy or torch."""

import numpy as np
import pytest
import torch

from sdf_representation_tpu.ops.marching import marching_cubes as jax_marching_cubes
from sdf_representation_tpu_torch.ops.marching import marching_cubes


def _volumes():
    rng = np.random.default_rng(0)
    ax = np.linspace(-1, 1, 40, dtype=np.float32)
    x, y, z = np.meshgrid(ax, ax, ax, indexing="ij")
    sphere = np.sqrt(x ** 2 + y ** 2 + z ** 2) - 0.6
    torus = np.sqrt((np.sqrt(x ** 2 + y ** 2) - 0.5) ** 2 + z ** 2) - 0.2
    noisy = sphere + 0.05 * rng.standard_normal(sphere.shape).astype(np.float32)
    return {"sphere": sphere, "torus": torus, "noisy": noisy}


@pytest.mark.parametrize("name", ["sphere", "torus", "noisy"])
@pytest.mark.parametrize("level", [0.0, 0.1])
def test_marching_identical_to_jax_package(name, level):
    vol = _volumes()[name]
    sp = 2.0 / 39
    vj, fj = jax_marching_cubes(vol, level, (sp,) * 3, (-1.0,) * 3)
    vt, ft = marching_cubes(vol, level, (sp,) * 3, (-1.0,) * 3)
    assert len(fj) > 100
    np.testing.assert_array_equal(ft, fj)
    np.testing.assert_array_equal(vt, vj)
    vt2, ft2 = marching_cubes(torch.from_numpy(vol), level, (sp,) * 3, (-1.0,) * 3)
    np.testing.assert_array_equal(ft2, fj)
    np.testing.assert_array_equal(vt2, vj)


def test_marching_empty_and_tiny_volumes():
    v, f = marching_cubes(np.ones((8, 8, 8), np.float32))
    assert v.shape == (0, 3) and f.shape == (0, 3)
    v, f = marching_cubes(np.ones((1, 8, 8), np.float32))
    assert f.shape == (0, 3)
