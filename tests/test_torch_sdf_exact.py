"""The port's exact signed distance (plain streams on the CPU) against the
JAX package's on the same points and meshes, and against the analytic cases
of tests/test_sdf_exact.py (box, sphere, torus) at that file's tolerances.

Against the JAX function: rtol 1e-5 / atol 1e-6 on the distance and equal
signs (tests/test_pallas_streams.py holds the two JAX paths to the same).
Normals are compared where both pick the same closest feature: on a tie
between two faces the two may return either face's direction."""

import numpy as np
import pytest
import torch

from sdf_representation_tpu.geometry.primitives import (
    box_sdf,
    make_box,
    make_icosphere,
    make_torus,
    torus_sdf,
)
from sdf_representation_tpu.ops import sdf_exact as jax_sdf_exact
from sdf_representation_tpu_torch.geometry import primitives
from sdf_representation_tpu_torch.ops import sdf_exact

torch.set_num_threads(2)


def _sd(points, *mesh, **kw):
    return sdf_exact.signed_distance(points, *mesh, device="cpu", **kw)


@pytest.mark.parametrize("case", ["icosphere", "torus", "box"])
def test_signed_distance_matches_jax(case):
    mesh, tri_chunk = {"icosphere": (make_icosphere(3, 0.5), 256),
                       "torus": (make_torus(n_major=32, n_minor=16), 256),
                       "box": (make_box(), 16)}[case]
    pts = np.random.default_rng(4).uniform(-1, 1, (3000, 3))
    ref, ref_n = jax_sdf_exact.signed_distance(pts, mesh, method="dense", use_pallas=False,
                                               tri_chunk=tri_chunk)
    got, got_n = _sd(pts, mesh, method="dense", point_chunk=512, tri_chunk=tri_chunk)
    assert got.dtype == np.float64 and got_n.shape == (3000, 3)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    assert np.all(np.sign(got) == np.sign(ref))
    same = np.linalg.norm(got_n - ref_n, axis=1) < 1e-3
    assert same.mean() > 0.97  # the rest sit on ties between faces
    np.testing.assert_allclose(np.linalg.norm(got_n, axis=1), 1.0, atol=1e-5)


def test_port_primitives_equal_the_jax_package():
    for ours, theirs in ((primitives.make_icosphere(3, 0.5), make_icosphere(3, 0.5)),
                         (primitives.make_box(), make_box()),
                         (primitives.make_torus(), make_torus())):
        np.testing.assert_array_equal(ours.vertices, theirs.vertices)
        np.testing.assert_array_equal(ours.faces, theirs.faces)


def test_eberly_and_oracle_match_jax():
    rng = np.random.default_rng(3)
    tri = rng.normal(size=(200, 3, 3))
    pts = rng.normal(size=(200, 3)) * 2
    np.testing.assert_array_equal(sdf_exact.closest_point_on_triangles(pts, tri),
                                  jax_sdf_exact.closest_point_on_triangles(pts, tri))
    a, b, c, d, e = (rng.normal(size=500).astype(np.float32) for _ in range(5))
    a, c = np.abs(a) + 0.1, np.abs(c) + 0.1
    s_np, t_np = sdf_exact._eberly_st(a, b, c, d, e)
    s_t, t_t = sdf_exact._eberly_st(*(torch.from_numpy(v) for v in (a, b, c, d, e)))
    # one body, two array types: the same float32 operations
    np.testing.assert_allclose(s_t.numpy(), s_np, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(t_t.numpy(), t_np, rtol=1e-6, atol=1e-7)


def test_matmul_sweep_matches_jax_point_block():
    import jax.numpy as jnp

    mesh = make_icosphere(3, 0.6)
    P = np.random.default_rng(6).uniform(-1, 1, (512, 3)).astype(np.float32)
    tables, F = sdf_exact._triangle_tables(mesh.vertices, mesh.faces, 256)
    ref_d2, ref_best, ref_w = jax_sdf_exact._sdf_point_block(
        jnp.asarray(P), {k: jnp.asarray(v) for k, v in tables.items()}, 256)
    d2, best, w = sdf_exact._sdf_point_block(
        torch.from_numpy(P), {k: torch.from_numpy(v) for k, v in tables.items()}, 256)
    np.testing.assert_allclose(d2.numpy(), np.asarray(ref_d2), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(w.numpy(), np.asarray(ref_w), rtol=1e-4, atol=1e-3)
    assert (best.numpy() != np.asarray(ref_best)).mean() < 0.08


def test_box_signed_distance_matches_analytic():
    pts = np.random.default_rng(0).uniform(-1, 1, (2000, 3))
    sdf, normals = _sd(pts, make_box(), point_chunk=512, tri_chunk=16)
    np.testing.assert_allclose(sdf, box_sdf(pts), atol=1e-6)
    assert normals.shape == (2000, 3)
    np.testing.assert_allclose(np.linalg.norm(normals, axis=1), 1.0, atol=1e-6)


def test_box_normals_outside_point_away():
    pts = np.array([[0.9, 0.0, 0.0], [0.0, -0.9, 0.0], [0.0, 0.0, 0.25]])
    sdf, normals = _sd(pts, make_box(), point_chunk=8, tri_chunk=16)
    np.testing.assert_allclose(normals[0], [1, 0, 0], atol=1e-6)
    np.testing.assert_allclose(normals[1], [0, -1, 0], atol=1e-6)
    # inside point: gradient points toward nearest face (+z here, dist 0.25)
    assert sdf[2] == pytest.approx(-0.25, abs=1e-6)
    np.testing.assert_allclose(normals[2], [0, 0, 1], atol=1e-6)


def test_sphere_signed_distance():
    pts = np.random.default_rng(1).uniform(-0.9, 0.9, (1000, 3))
    sdf, _ = _sd(pts, make_icosphere(subdivisions=3, radius=0.5), point_chunk=512, tri_chunk=256)
    expected = np.linalg.norm(pts, axis=1) - 0.5
    np.testing.assert_allclose(sdf, expected, atol=5e-3)  # facet sag
    far = np.abs(expected) > 5e-3
    assert np.all(np.sign(sdf[far]) == np.sign(expected[far]))


def test_torus_signed_distance():
    pts = np.random.default_rng(2).uniform(-1, 1, (500, 3))
    sdf, _ = _sd(pts, make_torus(), point_chunk=512, tri_chunk=512)
    np.testing.assert_allclose(sdf, torus_sdf(pts), atol=2e-2)


def test_winding_number_inside_outside():
    pts = np.array([[0, 0, 0], [0.49, 0.49, 0.49], [0.51, 0, 0], [2, 2, 2], [0, 0, -0.7]])
    w = sdf_exact.winding_number(pts, make_box(), point_chunk=8, tri_chunk=16, device="cpu")
    ref = jax_sdf_exact.winding_number(pts, make_box(), point_chunk=8, tri_chunk=16)
    np.testing.assert_allclose(w[:2], 1.0, atol=1e-4)
    np.testing.assert_allclose(w[2:], 0.0, atol=1e-4)
    np.testing.assert_allclose(w, ref, atol=1e-5)


def test_default_chunks_and_padding():
    """Point counts that do not divide the chunk size are padded correctly,
    with the default chunks too (8192 points, 1024 triangles)."""
    pts = np.random.default_rng(4).uniform(-1, 1, (1037, 3))
    sdf, _ = _sd(pts, make_box(), point_chunk=256, tri_chunk=16)
    np.testing.assert_allclose(sdf, box_sdf(pts), atol=1e-6)
    sdf, _ = _sd(pts, make_box())
    np.testing.assert_allclose(sdf, box_sdf(pts), atol=1e-6)


def test_on_surface_points_get_face_normals():
    pts = np.array([[0.5, 0.1, 0.2], [-0.5, -0.3, 0.1]])  # exactly on the +x / -x faces
    sdf, normals = _sd(pts, make_box(), point_chunk=8, tri_chunk=16)
    np.testing.assert_allclose(np.abs(sdf), 0.0, atol=1e-7)
    np.testing.assert_allclose(np.abs(normals[:, 0]), 1.0, atol=1e-6)
    # a wide on_surface_eps turns near-surface gradients into face normals
    near = np.array([[0.5004, 0.1, 0.2]])
    _, n_wide = _sd(near, make_box(), tri_chunk=16, on_surface_eps=1e-3)
    np.testing.assert_allclose(n_wide[0], [1, 0, 0], atol=1e-6)


def test_empty_inputs_device_results_and_methods(capsys):
    box = make_box()
    sdf, normals = _sd(np.zeros((0, 3)), box)
    assert sdf.shape == (0,) and normals.shape == (0, 3)
    empty = (np.zeros((0, 3)), np.zeros((0, 3), np.int64))
    sdf, normals = _sd(np.zeros((5, 3)), *empty)
    assert np.all(np.isinf(sdf)) and np.all(sdf > 0) and not normals.any()
    sdf, normals = _sd(np.zeros((5, 3)), *empty, return_device=True)
    assert isinstance(sdf, torch.Tensor) and torch.isinf(sdf).all()

    pts = np.random.default_rng(0).uniform(-1, 1, (300, 3))
    dev_sdf, dev_n = _sd(pts, box, tri_chunk=16, return_device=True)
    host_sdf, host_n = _sd(pts, box, tri_chunk=16)
    assert dev_sdf.dtype == torch.float32 and dev_n.shape == (300, 3)
    np.testing.assert_array_equal(dev_sdf.numpy().astype(np.float64), host_sdf)
    assert _sd(pts, box, tri_chunk=16, return_normals=False)[1] is None
    # tensors are taken as points too
    np.testing.assert_array_equal(_sd(torch.from_numpy(pts), box, tri_chunk=16)[0], host_sdf)

    # the culled method runs (tests/test_torch_sdf_culled.py holds it to the JAX package)
    culled, culled_n = _sd(pts, box, method="culled", tri_chunk=16)
    np.testing.assert_allclose(culled, host_sdf, atol=1e-6)
    assert culled_n.shape == (300, 3)
    with pytest.raises(ValueError):
        _sd(pts, box, method="fastest")
    capsys.readouterr()
    _sd(pts, box, tri_chunk=16)
    assert "dense" not in capsys.readouterr().out  # small work: "auto" says nothing
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            sdf_exact.signed_distance(pts, box)
