"""The port's sampler against the JAX package's: the same ``default_rng``
draw order, so the sampled points are bit-identical; the labels come from
the two exact-SDF implementations and agree within rtol 1e-5 / atol 1e-6
(distance) with equal signs, and the normals where both pick the same
closest feature (ties between faces aside)."""

import numpy as np
import pytest
import torch

from sdf_representation_tpu.geometry.primitives import make_box, make_icosphere
from sdf_representation_tpu.sampling import sampler as jax_sampler
from sdf_representation_tpu_torch.geometry.mesh_io import Mesh, save_mesh
from sdf_representation_tpu_torch.sampling import sampler

torch.set_num_threads(2)
XYZ = ["x", "y", "z"]


def _port_mesh(mesh):
    return Mesh(mesh.vertices, mesh.faces)


@pytest.mark.parametrize("surface,narrow", [(3, 3), (4, 2), (2, 5)])
def test_sampled_points_bit_equal_and_labels_close(surface, narrow):
    mesh = make_icosphere(2, 0.5)
    theirs = jax_sampler.generate_signed_distance_data(mesh, 1500, surface, narrow, 0.1)
    ours = sampler.generate_signed_distance_data(_port_mesh(mesh), 1500, surface, narrow, 0.1,
                                                 device="cpu")
    k = min(surface, narrow)  # the zip-truncation quirk
    sizes = (1500, 320 * surface, 320 * k)
    for frame, df, size in zip(ours, theirs, sizes):
        assert frame.columns == tuple(df.columns) == sampler.COLUMNS
        assert len(frame) == len(df) == size
        np.testing.assert_array_equal(frame.values[:, :3], df[XYZ].to_numpy())
        S, S_ref = frame["S"], df["S"].to_numpy()
        np.testing.assert_allclose(S, S_ref, rtol=1e-5, atol=1e-6)
        off = np.abs(S_ref) > 1e-5
        assert np.all(np.sign(S[off]) == np.sign(S_ref[off]))
        n, n_ref = frame.values[:, 4:], df[["nx", "ny", "nz"]].to_numpy()
        assert (np.linalg.norm(n - n_ref, axis=1) < 1e-3).mean() > 0.9
    # off-surface labels carry unit gradients
    uniform = ours[0]
    np.testing.assert_allclose(np.linalg.norm(uniform.values[:, 4:], axis=1), 1.0, atol=1e-5)
    assert np.abs(ours[2]["S"]).max() <= 0.1 + 1e-6  # the narrow band's width


def test_surface_and_narrow_band_draws_equal_jax():
    mesh = make_box()
    for kw in ({}, {"area_weighted": True, "total_points": 500}):
        a = sampler.sample_surface_points(_port_mesh(mesh), 7, np.random.default_rng(3), **kw)
        b = jax_sampler.sample_surface_points(mesh, 7, np.random.default_rng(3), **kw)
        np.testing.assert_array_equal(a, b)
    a = sampler.sample_narrow_band_points(_port_mesh(mesh), 5, 3, 0.05, np.random.default_rng(4))
    b = jax_sampler.sample_narrow_band_points(mesh, 5, 3, 0.05, np.random.default_rng(4))
    np.testing.assert_array_equal(a, b)
    assert a.shape == (12 * 3, 3)


def test_per_triangle_distribution_is_not_area_uniform():
    """Every triangle gets the same count whatever its area."""
    mesh = make_box((0.9, 0.1, 0.1))
    pts = sampler.sample_surface_points(_port_mesh(mesh), 50, np.random.default_rng(0))
    assert pts.shape == (12 * 50, 3)
    on_small_faces = np.isclose(np.abs(pts[:, 0]), 0.9).sum()
    assert on_small_faces == 4 * 50  # 4 of 12 triangles, though ~5% of the area


def test_empty_input_sentinel_and_query_labels(tmp_path):
    mesh = _port_mesh(make_box())
    frame = sampler._label(np.zeros((0, 3)), mesh, device="cpu")
    theirs = jax_sampler._label(np.zeros((0, 3)), make_box())
    np.testing.assert_array_equal(frame.values, theirs.to_numpy())
    assert frame.values.tolist() == [[0, 0, 0, -0.5, 0, 0, 0]]

    q = np.array([[0.9, 0.0, 0.0], [0.0, 0.0, 0.25]])
    save_mesh(mesh, str(tmp_path / "box.stl"))
    for geometry in (mesh, str(tmp_path / "box.stl")):
        got = sampler.generate_signed_distance(q, geometry, device="cpu")
        np.testing.assert_allclose(got["S"], [0.4, -0.25], atol=1e-6)
        np.testing.assert_allclose(got.values[0, 4:], [1, 0, 0], atol=1e-6)
    ref = jax_sampler.generate_signed_distance(q, make_box())
    np.testing.assert_allclose(got.values, ref.to_numpy(), atol=1e-6)
