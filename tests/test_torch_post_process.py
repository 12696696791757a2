"""The audit's metrics against the JAX package's on the same arrays, and the
slice as a whole on the CPU through the entry point: sample -> train a few
epochs -> audit -> reconstruct.

``compute_grid_metrics``: each NMSE is a ratio of two float32 sums over the
8,000 grid values, taken in another order by the two frameworks (measured
1.5e-5 apart; held to rtol 1e-4); counts, confusion and the mismatch indices
(when under the cap, where nothing is decimated) are equal."""

import pathlib

import numpy as np
import pandas as pd
import pytest
import torch

from sdf_representation_tpu.evaluations import metrics as jax_metrics
from sdf_representation_tpu_torch.cli import main
from sdf_representation_tpu_torch.configgen import Configuration
from sdf_representation_tpu_torch.evaluations import metrics, post_process, reconstruct
from sdf_representation_tpu_torch.geometry.mesh_io import load_mesh, save_mesh
from sdf_representation_tpu_torch.geometry.primitives import make_icosphere
from sdf_representation_tpu_torch.ops import fused_mlp, sdf_streams
from sdf_representation_tpu_torch.training import Trainer

torch.set_num_threads(2)
REPO = pathlib.Path(__file__).resolve().parent.parent


def _fields(n=20, seed=0, noise=0.02):
    rng = np.random.default_rng(seed)
    ax = np.linspace(-1, 1, n)
    g = np.stack(np.meshgrid(ax, ax, ax, indexing="ij"), -1).reshape(-1, 3)
    true = (np.linalg.norm(g, axis=1) - 0.5).astype(np.float32)
    pred = (true + noise * rng.normal(size=true.shape)).astype(np.float32)
    return pred, true


@pytest.mark.parametrize("noise", [0.02, 0.0002])
def test_grid_metrics_match_jax(noise):
    pred, true = _fields(noise=noise)
    ref = jax_metrics.compute_grid_metrics(pred, true)
    got = metrics.compute_grid_metrics(torch.from_numpy(pred), torch.from_numpy(true))
    for thr in (0.01, 0.00025):
        assert got[f"nmse_{thr}"] == pytest.approx(ref[f"nmse_{thr}"], rel=1e-4, abs=1e-12)
    assert got["sign_accuracy"] == ref["sign_accuracy"]
    np.testing.assert_array_equal(got["confusion"], ref["confusion"])
    assert got["mismatch_counts"] == ref["mismatch_counts"]
    for a, b in zip(got["mismatch_indices"], ref["mismatch_indices"]):
        np.testing.assert_array_equal(a, b)
    # the same numbers from the host-side functions
    assert got["sign_accuracy"] == pytest.approx(metrics.sign_accuracy(pred, true))
    assert got["nmse_0.01"] == pytest.approx(metrics.thresholded_nmse(pred, true, 0.01), rel=1e-4,
                                             abs=1e-12)
    np.testing.assert_array_equal(got["confusion"], metrics.sign_confusion_counts(pred, true))


def test_mismatch_samples_are_capped_and_unbiased():
    pred, true = _fields(n=24)
    got = metrics.compute_grid_metrics(pred, true, max_mismatch=500)
    count = got["mismatch_counts"][1]
    idx = got["mismatch_indices"][1]
    assert count > 5000 and 350 < len(idx) <= 500
    assert np.all(np.diff(idx) > 0) and idx.max() < 24 ** 3
    # decimated evenly over the grid, not truncated at the high indices
    assert 0.35 < np.mean(idx < 24 ** 3 // 2) < 0.65


def test_host_metrics_and_report_match_jax(tmp_path):
    pred, true = _fields(seed=3)
    for ours, theirs in ((metrics.sign_accuracy, jax_metrics.sign_accuracy),
                         (metrics.sign_confusion_counts, jax_metrics.sign_confusion_counts)):
        np.testing.assert_array_equal(ours(pred, true), theirs(pred, true))
    assert metrics.thresholded_nmse(pred, true, 0.01) == jax_metrics.thresholded_nmse(pred, true, 0.01)
    rng = np.random.default_rng(0)
    a, b = rng.normal(size=(300, 3)), rng.normal(size=(200, 3))
    assert metrics.chamfer_distance(a, b) == jax_metrics.chamfer_distance(a, b)

    frame = jax_metrics.classification_report_frame(pred, true)
    report = metrics.classification_report_frame(pred, true)
    assert list(report.index) == list(frame.index)
    np.testing.assert_array_equal(report.values, frame.to_numpy(np.float64))
    # the CSV reads back as the frame pandas would have written
    path = tmp_path / "report.csv"
    report.to_csv(str(path))
    back = pd.read_csv(path, index_col=0)
    pd.testing.assert_frame_equal(back, frame, check_names=False, rtol=1e-12)
    # a degenerate field (nothing inside) divides by nothing
    empty = metrics.classification_report_frame(np.ones(8), np.ones(8))
    assert empty.values[empty.index.index("1")].tolist() == [0.0, 0.0, 0.0, 0.0]


@pytest.mark.parametrize("case", ["balanced", "one_class", "empty"])
def test_classification_report_frame_equals_jax(tmp_path, case):
    """The report as the port's Frame against the JAX package's DataFrame:
    row labels, columns and float64 values exactly; the CSV text pandas
    writes for it, and what pandas reads back from the port's."""
    rng = np.random.default_rng(7)
    true = {"balanced": rng.normal(size=4000), "one_class": np.abs(rng.normal(size=300)),
            "empty": np.zeros(0)}[case]
    pred = true + 0.3 * rng.normal(size=true.shape)
    want = jax_metrics.classification_report_frame(pred, true)
    got = metrics.classification_report_frame(pred, true)
    assert got.index == ("0", "1", "accuracy", "macro avg", "weighted avg")
    assert list(want.index) == list(got.index) and list(want.columns) == list(got.columns)
    assert got.values.dtype == np.float64
    np.testing.assert_array_equal(got.values, want.to_numpy(np.float64))
    got.to_csv(str(tmp_path / "port.csv"))
    want.to_csv(tmp_path / "jax.csv")
    assert (tmp_path / "port.csv").read_text() == (tmp_path / "jax.csv").read_text()
    pd.testing.assert_frame_equal(pd.read_csv(tmp_path / "port.csv", index_col=0),
                                  pd.read_csv(tmp_path / "jax.csv", index_col=0))


def _config(root, **changes):
    text = (REPO / "tests/test_config.ini").read_text().replace("@DIR@", str(root))
    base = {"hidden_dim": 64, "num_hidden_layers": 4, "skip_connection": 2, "beta": 100,
            "geometric_init": True, "lr": 0.001, "epochs": 8, "min_epochs": 2,
            "checkpointing": 4, "batch_size": 512, "uniform_points": 2000, "surface": 3,
            "narrowband": 3, "cubesize": 32}
    base.update(changes)
    for key, value in base.items():
        line = next(ln for ln in text.splitlines() if ln.startswith(f"{key} = "))
        text = text.replace(line, f"{key} = {value}")
    path = root / "config.ini"
    path.write_text(text)
    return str(path)


def test_slice_end_to_end_through_the_entry_point(tmp_path):
    """sample -> train -> audit -> reconstruct with `--device cpu`."""
    save_mesh(make_icosphere(2, 0.5), str(tmp_path / "sphere.stl"))
    cpu = ["--device", "cpu", "--compute-dtype", "float32"]
    fused_mlp.reset_launches()
    sdf_streams.reset_launches()

    assert main([_config(tmp_path, samplingonly=True), *cpu]) == 0
    trainer = Trainer(Configuration(_config(tmp_path)), device="cpu")
    data, train = pathlib.Path(trainer.data_path), pathlib.Path(trainer.train_path)
    rows = {name: len((data / f"{name}.csv").read_text().splitlines()) - 1
            for name in ("uniform", "surface", "narrow")}
    assert rows == {"uniform": 2000, "surface": 960, "narrow": 960}
    rescaled = load_mesh(str(pathlib.Path(trainer.main_path) / "sphere_rescaled.stl"))
    assert np.abs(rescaled.vertices).max() == pytest.approx(0.85, abs=1e-3)
    assert not list((train / "models").iterdir())  # sampling only: nothing trained

    assert main([_config(tmp_path), *cpu]) == 0
    losses = np.loadtxt(train / "train_loss.txt")
    assert losses.shape == (8, 3) and losses[-1, 1] < 0.3 * losses[0, 1]
    assert {p.name for p in (train / "models").iterdir()} == {
        "best_model.ckpt", "model_epoch3.ckpt", "model_epoch7.ckpt"}

    assert main([_config(tmp_path, ppo=True), *cpu]) == 0
    post = train / "postprocess"
    results = pd.read_csv(post / "results.csv")
    assert list(results.columns) == list(post_process.RESULT_COLUMNS) and len(results) == 1
    row = results.iloc[0]
    assert row["Resolution"] == 32 and 0 <= row["Epoch"] <= 7
    # the rescaled sphere (radius 0.85) holds ~31% of the grid: a fit after 8
    # epochs must beat calling everything outside
    inside = np.linalg.norm(np.stack(np.meshgrid(*[np.linspace(-1, 1, 32)] * 3), -1), axis=-1) < 0.85
    assert row["Accuracy"] > max(0.9, 1 - inside.mean())
    assert 0 < row["Chamfer"] < 0.2 and row["NMSELoss_Mismatch 0.01"] < 0.1
    assert list(post_process.LAST_STAGE_SECONDS) == [
        "load", "predict", "exact_distance", "metrics", "write_artifacts", "chamfer"]
    mism = pd.read_csv(post / "mismatching_co-ordinates1.csv")
    assert list(mism.columns) == ["x", "y", "z"] and mism.abs().to_numpy().max() <= 1.0
    assert len(pd.read_csv(post / "mismatching_co-ordinates2.csv")) >= len(mism)
    report = pd.read_csv(post / "classification_report1.csv", index_col=0)
    assert report.loc["accuracy", "precision"] == pytest.approx(row["Accuracy"])
    assert (post / "classification_report2.csv").read_text() == (
        post / "classification_report1.csv").read_text()
    assert main([_config(tmp_path, ppo=True), *cpu]) == 0  # a second audit appends its row
    assert len(pd.read_csv(post / "results.csv")) == 2

    assert main([_config(tmp_path, ppo=True, reconstruct=True), *cpu]) == 0
    mesh = load_mesh(str(post / "reconstructed_epoch7.stl"))
    radii = np.linalg.norm(mesh.vertices, axis=1)
    assert len(mesh.faces) > 500 and abs(np.median(radii) - 0.85) < 0.05
    assert list(reconstruct.LAST_STAGE_SECONDS) == ["load_checkpoint", "evaluate", "march",
                                                    "write_stl"]
    # on the CPU everything ran through the plain versions
    assert set(fused_mlp.LAUNCHES.values()) | set(sdf_streams.LAUNCHES.values()) == {0}


def test_audit_truth_matches_jax_signed_distance(tmp_path):
    """The audit's ground truth on the grid against the JAX package's."""
    from sdf_representation_tpu.ops.sdf_exact import signed_distance as jax_signed_distance
    from sdf_representation_tpu_torch.ops.grid_eval import grid_coords
    from sdf_representation_tpu_torch.ops.sdf_exact import signed_distance

    from sdf_representation_tpu.geometry.primitives import make_icosphere as jax_icosphere

    mesh = jax_icosphere(2, 0.6)
    coords = grid_coords(12)
    ref, _ = jax_signed_distance(coords, mesh, return_normals=False, method="dense",
                                 use_pallas=False)
    got, none = signed_distance(coords, mesh, return_normals=False, return_device=True,
                                device="cpu")
    assert none is None and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-6)
    assert np.all(np.sign(got.numpy()) == np.sign(ref))
