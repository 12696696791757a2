"""The port's gmsh reader and 2-D polygon sampler against the JAX package's.

Both compute in numpy float64 on the host from the same ``default_rng``
draws, so the nodes are equal and the labels agree to atol 1e-12 (the same
arithmetic; only library summation order could differ). The CSVs are read
back and held to the same limit."""

import numpy as np
import pandas as pd
import pytest

from sdf_representation_tpu.geometry import msh_io as jax_msh_io
from sdf_representation_tpu.sampling import sampler2d as jax_sampler2d
from sdf_representation_tpu_torch.geometry import msh_io
from sdf_representation_tpu_torch.sampling import sampler2d

TOL = 1e-12
SQUARE = np.array([[-0.5, -0.5], [0.5, -0.5], [0.5, 0.5], [-0.5, 0.5]])
L_SHAPE = np.array([[-0.6, -0.6], [0.6, -0.6], [0.6, 0.0], [0.0, 0.0], [0.0, 0.6], [-0.6, 0.6]])

# gmsh ASCII v4.1: two entity blocks, tags out of file order
MSH_V41 = """$MeshFormat
4.1 0 8
$EndMeshFormat
$Entities
0 1 0 0
$EndEntities
$Nodes
2 5 1 5
1 1 0 3
3
1
5
0.5 0.5 0
-0.5 -0.5 0
0.25 0.75 0
1 2 0 2
4
2
-0.5 0.5 0
0.5 -0.5 0
$EndNodes
$Elements
1 1 1 1
1 1 1 1
1 1 2
$EndElements
"""


def _ngon(n, r=0.6):
    th = np.linspace(0, 2 * np.pi, n, endpoint=False)
    return np.column_stack([r * np.cos(th), r * (0.7 + 0.3 * np.sin(3 * th)) * np.sin(th)])


def test_write_msh_polygon_bytes_equal_and_v22_nodes(tmp_path):
    poly = _ngon(37)
    ours = msh_io.write_msh_polygon(str(tmp_path / "ours.msh"), poly)
    theirs = jax_msh_io.write_msh_polygon(str(tmp_path / "theirs.msh"), poly)
    assert open(ours).read() == open(theirs).read()
    nodes = msh_io.read_msh_nodes(ours)
    np.testing.assert_array_equal(nodes, jax_msh_io.read_msh_nodes(ours))
    assert nodes.shape == (37, 3) and nodes.dtype == np.float64
    closed = msh_io.extract_polygon_from_msh(ours)
    np.testing.assert_array_equal(closed, jax_msh_io.extract_polygon_from_msh(ours))
    assert closed.shape == (38, 2) and np.array_equal(closed[0], closed[-1])


def test_v41_nodes_in_tag_order(tmp_path):
    path = tmp_path / "v41.msh"
    path.write_text(MSH_V41)
    nodes = msh_io.read_msh_nodes(str(path))
    np.testing.assert_array_equal(nodes, jax_msh_io.read_msh_nodes(str(path)))
    np.testing.assert_array_equal(nodes[:, :2], [[-0.5, -0.5], [0.5, -0.5], [0.5, 0.5],
                                                 [-0.5, 0.5], [0.25, 0.75]])


def test_msh_without_nodes_raises(tmp_path):
    path = tmp_path / "empty.msh"
    path.write_text("$MeshFormat\n2.2 0 8\n$EndMeshFormat\n")
    with pytest.raises(ValueError, match="No \\$Nodes"):
        msh_io.read_msh_nodes(str(path))
    with pytest.raises(ValueError):
        jax_msh_io.read_msh_nodes(str(path))


@pytest.mark.parametrize("polygon", [SQUARE, L_SHAPE], ids=["square", "L"])
@pytest.mark.parametrize("closed", [False, True])
def test_polygon_sdf_equals_jax(polygon, closed):
    poly = np.vstack([polygon, polygon[:1]]) if closed else polygon
    pts = np.random.default_rng(1).uniform(-1, 1, (500, 2))
    pts = np.vstack([pts, polygon, [[0.0, 0.0], [0.3, 0.3]]])  # vertices, the L's notch
    sdf, normal = sampler2d.polygon_sdf(pts, poly)
    sdf_ref, normal_ref = jax_sampler2d.polygon_sdf(pts, poly)
    np.testing.assert_allclose(sdf, sdf_ref, rtol=0, atol=TOL)
    np.testing.assert_allclose(normal, normal_ref, rtol=0, atol=TOL)
    if polygon is SQUARE:  # the analytic square
        inside = np.all(np.abs(pts) < 0.5, axis=1)
        assert np.all(sdf[inside] < 0) and np.all(sdf[~inside] >= 0)
        np.testing.assert_allclose(sdf[inside], np.abs(pts[inside]).max(axis=1) - 0.5, atol=TOL)


@pytest.mark.parametrize("source", ["v22", "v41", "array"])
def test_generate_2d_msh_equals_jax(tmp_path, source):
    if source == "v41":
        (tmp_path / "poly.msh").write_text(MSH_V41)
        geometry = str(tmp_path / "poly.msh")
    elif source == "v22":
        geometry = msh_io.write_msh_polygon(str(tmp_path / "poly.msh"), _ngon(60))
    else:
        geometry = L_SHAPE
    ours_dir, theirs_dir = tmp_path / "ours", tmp_path / "theirs"
    ours_dir.mkdir()
    theirs_dir.mkdir()
    ours = sampler2d.generate_signed_distance_2D_msh(300, 200, 100, 0.05, geometry,
                                                      save_path=str(ours_dir), seed=7)
    theirs = jax_sampler2d.generate_signed_distance_2D_msh(300, 200, 100, 0.05, geometry,
                                                            save_path=str(theirs_dir), seed=7)
    # JAX's return order: (uniform, narrow, surface)
    for frame, df, n in zip(ours, theirs, (300, 200, 100)):
        assert frame.columns == tuple(df.columns) and len(frame) == n
        np.testing.assert_allclose(frame.values, df.to_numpy(), rtol=0, atol=TOL)
    np.testing.assert_allclose(ours[2]["S"], 0.0, atol=1e-9)  # on the boundary
    assert np.abs(ours[1]["S"]).max() <= 0.05 + 1e-9
    for name in ("uniform", "surface", "narrow"):
        got = pd.read_csv(ours_dir / f"{name}.csv", index_col=0)
        want = pd.read_csv(theirs_dir / f"{name}.csv", index_col=0)
        assert list(got.columns) == list(want.columns)
        np.testing.assert_array_equal(got.index, want.index)
        np.testing.assert_allclose(got.to_numpy(), want.to_numpy(), rtol=0, atol=TOL)
        assert (ours_dir / f"{name}.csv").read_text().splitlines()[0] == ",x,y,z,S,nx,ny,nz"


def test_sampling_package_exports():
    from sdf_representation_tpu_torch import sampling

    assert sampling.generate_signed_distance_2D_msh is sampler2d.generate_signed_distance_2D_msh
    assert sampling.polygon_sdf is sampler2d.polygon_sdf
    assert callable(sampling.write_signed_distance_distributed)
    assert callable(sampling.compute_min_max)
