"""The port's octree readers and octree-vs-network comparison against the
JAX package's. The readers parse the same text into float64: equal arrays.
The network (ImplicitNet 32x2, skip at layer 1, beta 100; JAX init carried
over through ``convert.params_from_jax``) is evaluated in float32 by both
packages' ``evaluate_points``: values and statistics within rtol = atol =
2e-5 (tests/test_torch_diffops.py), sign agreement equal."""

import importlib

import jax
import numpy as np
import pandas as pd
import pytest
import torch

from sdf_representation_tpu.models import ImplicitNet as JaxImplicitNet
from sdf_representation_tpu_torch.convert import params_from_jax
from sdf_representation_tpu_torch.evaluations import compare_octree_dl as octree
from sdf_representation_tpu_torch.models import ImplicitNet

# the JAX package's evaluations/__init__ binds the function over the module's name
jax_octree = importlib.import_module("sdf_representation_tpu.evaluations.compare_octree_dl")
torch.set_num_threads(2)
F32 = 2e-5


def _vtu(path, pts, scalars=None, vectors=None):
    """An ascii .vtu piece; the point data may hold a 3-vector array before
    the scalar one (the reader takes the first 1-component array)."""
    text = "\n".join(" ".join(f"{v:.17g}" for v in p) for p in pts)
    data = ""
    if vectors is not None:
        vec = "\n".join(" ".join(f"{v:.17g}" for v in p) for p in vectors)
        data += f'<DataArray Name="n" NumberOfComponents="3" format="ascii">{vec}</DataArray>'
    if scalars is not None:
        data += ('<DataArray Name="sdf" format="ascii">\n'
                 + " ".join(f"{v:.17g}" for v in scalars) + "\n</DataArray>")
    path.write_text(f"""<VTKFile type="UnstructuredGrid">
<UnstructuredGrid><Piece NumberOfPoints="{len(pts)}">
<Points><DataArray NumberOfComponents="3" format="ascii">
{text}
</DataArray></Points>
<PointData>{data}</PointData>
</Piece></UnstructuredGrid></VTKFile>""")
    return str(path)


def _pvtu(path, sources):
    pieces = "".join(f'<Piece Source="{s}"/>' for s in sources)
    path.write_text(f'<VTKFile type="PUnstructuredGrid"><PUnstructuredGrid>{pieces}'
                    "</PUnstructuredGrid></VTKFile>")
    return str(path)


def _nodes(n=300, seed=0):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1, 1, (n, 3))
    return pts, np.linalg.norm(pts, axis=1) - 0.5, rng.normal(size=(n, 3))


def _files(tmp_path, with_scalars):
    pts, sdf, nrm = _nodes()
    s = sdf if with_scalars else None
    files = {"vtu": _vtu(tmp_path / "one.vtu", pts, s, nrm)}
    _vtu(tmp_path / "p0.vtu", pts[:120], None if s is None else s[:120])
    _vtu(tmp_path / "p1.vtu", pts[120:], None if s is None else s[120:], nrm[120:])
    files["pvtu"] = _pvtu(tmp_path / "all.pvtu", ["p0.vtu", "p1.vtu"])
    cols = np.column_stack([pts, sdf, nrm]) if with_scalars else pts
    np.savetxt(tmp_path / "points.csv", cols, delimiter=",", fmt="%.17g")
    files["csv"] = str(tmp_path / "points.csv")
    return pts, s, files


@pytest.mark.parametrize("with_scalars", [True, False], ids=["scalars", "no_scalars"])
@pytest.mark.parametrize("kind", ["vtu", "pvtu", "csv"])
def test_readers_equal_jax(tmp_path, kind, with_scalars):
    pts, sdf, files = _files(tmp_path, with_scalars)
    got_pts, got_s = octree.load_octree_nodes(files[kind])
    want_pts, want_s = jax_octree.load_octree_nodes(files[kind])
    np.testing.assert_array_equal(got_pts, want_pts)
    np.testing.assert_array_equal(got_pts, pts)
    if with_scalars:
        np.testing.assert_array_equal(got_s, want_s)
        np.testing.assert_array_equal(got_s, sdf)
    else:
        assert got_s is None and want_s is None


def test_reader_errors(tmp_path):
    (tmp_path / "b.vtu").write_text('<VTKFile><UnstructuredGrid><Piece><Points>'
                                    '<DataArray format="binary">AAAA</DataArray>'
                                    '</Points></Piece></UnstructuredGrid></VTKFile>')
    (tmp_path / "e.vtu").write_text("<VTKFile><UnstructuredGrid><Piece/></UnstructuredGrid></VTKFile>")
    _pvtu(tmp_path / "e.pvtu", [])
    (tmp_path / "x.vtk").write_text("")
    for name, match in (("b.vtu", "ascii"), ("e.vtu", "no Points"), ("e.pvtu", "no pieces"),
                        ("x.vtk", "unsupported")):
        with pytest.raises(ValueError, match=match):
            octree.load_octree_nodes(str(tmp_path / name))
        with pytest.raises(ValueError, match=match):
            jax_octree.load_octree_nodes(str(tmp_path / name))


@pytest.mark.parametrize("kind,with_scalars", [("csv", True), ("pvtu", True), ("vtu", False)])
def test_compare_octree_dl_equals_jax(tmp_path, kind, with_scalars):
    _, _, files = _files(tmp_path, with_scalars)
    jm = JaxImplicitNet(d_in=3, hidden_dims=(32,) * 2, skip_in=(1,), beta=100.0)
    params = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    model = ImplicitNet(d_in=3, hidden_dims=(32,) * 2, skip_in=(1,), beta=100.0)
    model.load_state_dict(params_from_jax(params))
    half = lambda p: 0.5 * p  # noqa: E731
    got = octree.compare_octree_dl(model, files[kind], out_csv=str(tmp_path / "ours.csv"),
                                   transform=half)
    want = jax_octree.compare_octree_dl(jm, params, files[kind],
                                        out_csv=str(tmp_path / "theirs.csv"), transform=half)
    assert set(got) == set(want)
    assert set(got) == ({"n_nodes", "rmse", "max_abs_err", "sign_agreement"} if with_scalars
                        else {"n_nodes"})
    assert got["n_nodes"] == want["n_nodes"] == 300
    for key in set(got) - {"n_nodes"}:
        assert got[key] == pytest.approx(want[key], rel=F32, abs=F32), key
    ours = pd.read_csv(tmp_path / "ours.csv", float_precision="round_trip")
    theirs = pd.read_csv(tmp_path / "theirs.csv", float_precision="round_trip")
    assert list(ours.columns) == list(theirs.columns) == (
        ["x", "y", "z", "model_sdf"] + ["octree_sdf", "error"] * with_scalars)
    np.testing.assert_array_equal(ours[["x", "y", "z"]], theirs[["x", "y", "z"]])
    np.testing.assert_allclose(ours, theirs, rtol=F32, atol=F32)
