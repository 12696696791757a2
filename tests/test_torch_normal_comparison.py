"""The port's normal audit against the JAX package's, on the setup of the
JAX package's tests/test_evaluations.py (200 points in [-0.9, 0.9]^3, the
icosphere(2) of radius 0.5 as sphere.stl, ImplicitNet 32x2 with a skip at
layer 1, beta 100; JAX init carried over through ``convert.params_from_jax``).

Tolerances: the model's values and normals in float32 within rtol = atol =
2e-5 (tests/test_torch_diffops.py); the exact labels within rtol 1e-5 /
atol 1e-6 (tests/test_torch_sdf_exact.py), the exact normals within 1e-3
at nine points in ten (tests/test_torch_sampler.py: a point near a facet
edge may take another closest feature); the statistics, which combine the
two, within 2e-5. The CSVs are read back with pandas and compared with the
same limits; the per-point similarity within 1e-3, and 2e-5 where the
exact normals agree within 2e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from sdf_representation_tpu.evaluations.normal_comparison import (
    compute_normal_for_model as jax_compute_normal_for_model,
)
from sdf_representation_tpu.models import ImplicitNet as JaxImplicitNet
from sdf_representation_tpu.ops import diffops as jax_diffops
from sdf_representation_tpu_torch.convert import params_from_jax
from sdf_representation_tpu_torch.evaluations import normal_comparison
from sdf_representation_tpu_torch.geometry.mesh_io import save_mesh
from sdf_representation_tpu_torch.geometry.primitives import make_icosphere
from sdf_representation_tpu_torch.models import ImplicitNet
from sdf_representation_tpu_torch.ops import diffops

torch.set_num_threads(2)
F32 = 2e-5
LABELS = (1e-5, 1e-6)
STATS = ("rmse", "cos_mean", "cos_median", "cos_std", "cos_min", "cos_max")


def _nets():
    jm = JaxImplicitNet(d_in=3, hidden_dims=(32,) * 2, skip_in=(1,), beta=100.0)
    params = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    model = ImplicitNet(d_in=3, hidden_dims=(32,) * 2, skip_in=(1,), beta=100.0)
    model.load_state_dict(params_from_jax(params))
    return jm, params, model


def _save_dir(path, pts, index):
    path.mkdir()
    pd.DataFrame(pts, columns=["x", "y", "z"]).to_csv(path / "nodes_coordinates.csv", index=index)
    save_mesh(make_icosphere(2, 0.5), str(path / "sphere.stl"))
    return path


def _read(path, name):
    return pd.read_csv(path / name, index_col=0, float_precision="round_trip")


@pytest.mark.parametrize("index", [False, True], ids=["plain_coords", "indexed_coords"])
def test_normal_audit_equals_jax(tmp_path, index):
    pts = np.random.default_rng(0).uniform(-0.9, 0.9, (200, 3))
    ours, theirs = _save_dir(tmp_path / "ours", pts, index), _save_dir(tmp_path / "theirs", pts, index)
    jm, params, model = _nets()
    got = normal_comparison.compute_normal_for_model(model, str(ours), plot=False)
    want = jax_compute_normal_for_model(jm, params, str(theirs), plot=False)
    assert set(got) == set(want) == {"eval_seconds", *STATS}
    for key in STATS:
        assert got[key] == pytest.approx(want[key], rel=F32, abs=F32), key
    assert got["eval_seconds"] >= 0 and -1 <= got["cos_min"] <= got["cos_max"] <= 1

    truth, truth_ref = _read(ours, "exact_wf.csv"), _read(theirs, "exact_wf.csv")
    assert list(truth.columns) == list(truth_ref.columns) == ["x", "y", "z", "S", "nx", "ny", "nz"]
    np.testing.assert_array_equal(truth.index, np.arange(200))
    np.testing.assert_array_equal(truth[["x", "y", "z"]], truth_ref[["x", "y", "z"]])
    np.testing.assert_allclose(truth["S"], truth_ref["S"], rtol=LABELS[0], atol=LABELS[1])
    # normals where both pick the same closest feature (tests/test_torch_sampler.py)
    dn = np.linalg.norm(truth[["nx", "ny", "nz"]].to_numpy()
                        - truth_ref[["nx", "ny", "nz"]].to_numpy(), axis=1)
    assert (dn < 1e-3).mean() > 0.9
    same = dn < F32
    computed, computed_ref = _read(ours, "computed.csv"), _read(theirs, "computed.csv")
    assert list(computed.columns) == list(computed_ref.columns)
    np.testing.assert_allclose(computed, computed_ref, rtol=F32, atol=F32)
    for name, column in (("error_points.csv", "error"), ("similarity_points.csv", "similarity")):
        frame, ref = _read(ours, name), _read(theirs, name)
        assert list(frame.columns) == list(ref.columns) == ["x", "y", "z", column]
        np.testing.assert_array_equal(frame.index, ref.index)
        # the similarity carries the exact normals' difference
        np.testing.assert_allclose(frame[same], ref[same], rtol=F32, atol=F32)
        np.testing.assert_allclose(frame, ref, rtol=0, atol=1e-3)
    # one row, no index column
    lines = (ours / "similarity.csv").read_text().splitlines()
    assert lines[0] == "mean,median,std,min,max" and len(lines) == 2
    np.testing.assert_allclose(np.array(lines[1].split(","), float),
                               pd.read_csv(theirs / "similarity.csv").to_numpy()[0],
                               rtol=F32, atol=F32)


def test_normal_audit_without_mesh_and_failing_plots(tmp_path, monkeypatch, capsys):
    pts = np.random.default_rng(1).uniform(-0.9, 0.9, (50, 3))
    ours = _save_dir(tmp_path / "ours", pts, False)
    (ours / "sphere.stl").unlink()
    _, _, model = _nets()
    assert set(normal_comparison.compute_normal_for_model(model, str(ours))) == {"eval_seconds"}
    assert (ours / "computed.csv").exists() and not (ours / "exact_wf.csv").exists()

    save_mesh(make_icosphere(2, 0.5), str(tmp_path / "elsewhere.stl"))
    from sdf_representation_tpu_torch.evaluations import visualize_errors

    def broken(save_path):
        raise RuntimeError("no display")

    monkeypatch.setattr(visualize_errors, "plot_errors", broken)
    out = normal_comparison.compute_normal_for_model(
        model, str(ours), mesh_path=str(tmp_path / "elsewhere.stl"), plot=True)
    assert "rmse" in out and "error plots failed: no display" in capsys.readouterr().out


def test_sdf_and_normal_equals_jax():
    jm, params, model = _nets()
    x = np.random.default_rng(2).uniform(-1, 1, (128, 3)).astype(np.float32)
    f_ref, n_ref = jax_diffops.sdf_and_normal(jm.apply, params, jnp.asarray(x))
    f, n = diffops.sdf_and_normal(model, torch.from_numpy(x))
    assert n.shape == (128, 3)
    np.testing.assert_allclose(f.detach().numpy(), np.asarray(f_ref), rtol=F32, atol=F32)
    np.testing.assert_allclose(n.detach().numpy(), np.asarray(n_ref), rtol=F32, atol=F32)
