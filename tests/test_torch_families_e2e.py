"""Every model family through the port's normal entry points on the CPU.

HashMLP: the shipped configs/mesh_sdf_hash.ini through ``python -m
sdf_representation_tpu_torch cfg --device cpu``, with only its paths and
sizes changed (epochs 30, uniform_points 20000, cubesize 24: the CPU's plain
exact-distance streams label ~1e6 point-face pairs a second) and the tables
shrunk (4 levels, T = 2^11, max resolution 64, as
tests/test_model_families_e2e.py shrinks them; the INI has no key for them):
it samples, trains in its own bfloat16 (one step of 16,384 an epoch; the
loss halves), audits and reconstructs. The mesh equals the JAX package's reconstruct_mesh
on the checkpoint's weights (the separable volume marched over the packed
wire in both): faces identical, vertices within 1e-5.

FeedForwardNetwork, Siren and KAN train a few epochs through ``Trainer``
with the loss falling (tests/test_model_families_e2e.py), then reconstruct
through the "plain" route (the module's float32 forward on the dense grid,
marched on the host, as the JAX package does) with the JAX mesh on the same
weights, and are audited through ``evaluate_points``."""

import functools
import pathlib

import jax
import numpy as np
import pytest
import torch

from sdf_representation_tpu import models as jax_models
from sdf_representation_tpu.evaluations.reconstruct import reconstruct_mesh as jax_reconstruct
from sdf_representation_tpu_torch.cli import main
from sdf_representation_tpu_torch.configgen import Configuration, config_reader
from sdf_representation_tpu_torch.convert import params_to_numpy
from sdf_representation_tpu_torch.data.dataset import SDFDataset
from sdf_representation_tpu_torch.evaluations import post_process, reconstruct
from sdf_representation_tpu_torch.geometry.mesh_io import load_mesh, save_mesh
from sdf_representation_tpu_torch.geometry.primitives import make_icosphere
from sdf_representation_tpu_torch.models import KAN, HashMLP
from sdf_representation_tpu_torch.training import Trainer

torch.set_num_threads(2)
REPO = pathlib.Path(__file__).resolve().parent.parent
SMALL_TABLES = dict(n_levels=4, log2_table_size=11, max_resolution=64)


def _hash_config(root, **flags):
    text = (REPO / "configs/mesh_sdf_hash.ini").read_text()
    for old, new in (("geometry = ./bunny.stl", f"geometry = {root}/sphere.stl"),
                     ("directory = ./runs/", f"directory = {root}/runs/"),
                     ("epochs = 100", "epochs = 30"), ("min_epochs = 200", "min_epochs = 30"),
                     ("checkpointing = 200", "checkpointing = 15"), ("cubesize = 256", "cubesize = 24"),
                     ("uniform_points = 100000", "uniform_points = 20000"),
                     *((f"{k} = False", f"{k} = {v}") for k, v in flags.items())):
        assert old in text, old
        text = text.replace(old, new)
    path = root / "hash.ini"
    path.write_text(text)
    return str(path)


def _assert_same_mesh(got, want):
    assert len(got.faces) == len(want.faces) > 100
    np.testing.assert_array_equal(got.faces, want.faces)
    np.testing.assert_allclose(got.vertices, want.vertices, rtol=0, atol=1e-5)


def test_hash_config_end_to_end_through_the_entry_point(tmp_path, monkeypatch):
    monkeypatch.setattr(config_reader, "HashMLP", functools.partial(HashMLP, **SMALL_TABLES))
    save_mesh(make_icosphere(2, 0.5), str(tmp_path / "sphere.stl"))
    cpu = ["--device", "cpu"]
    assert main([_hash_config(tmp_path, samplingonly=True), *cpu]) == 0
    assert main([_hash_config(tmp_path), *cpu]) == 0
    trainer = Trainer(Configuration(_hash_config(tmp_path)), device="cpu")
    assert isinstance(trainer.model, HashMLP) and trainer.model.n_levels == 4
    assert trainer.config.train_matmul_precision == "bfloat16"
    losses = np.loadtxt(pathlib.Path(trainer.train_path) / "train_loss.txt")
    assert losses.shape == (30, 3) and np.isfinite(losses).all()
    assert losses[-1, 1] < 0.5 * losses[0, 1]

    assert main([_hash_config(tmp_path, ppo=True), *cpu]) == 0
    post = pathlib.Path(trainer.postprocess_save_path)
    header, row = (post / "results.csv").read_text().splitlines()[:2]
    result = dict(zip(header.split(","), map(float, row.split(","))))
    ax = np.linspace(-1, 1, 24)
    inside = (ax[:, None, None] ** 2 + ax[None, :, None] ** 2 + ax[None, None, :] ** 2) < 0.85 ** 2
    assert result["Resolution"] == 24 and result["Accuracy"] > max(0.9, 1 - inside.mean())

    assert main([_hash_config(tmp_path, ppo=True, reconstruct=True), *cpu]) == 0
    assert list(reconstruct.LAST_STAGE_SECONDS) == ["load_checkpoint", "evaluate", "march",
                                                    "decode", "write_stl"]
    mesh = load_mesh(str(post / "reconstructed_epoch29.stl"))
    assert abs(np.median(np.linalg.norm(mesh.vertices, axis=1)) - 0.85) < 0.05
    _, epoch = trainer.load_model(best=False)
    assert epoch == 29
    ours = reconstruct.reconstruct_mesh(trainer.model, 24)
    jm = jax_models.HashMLP(d_in=3, hidden_dim=64, num_layers=3, **SMALL_TABLES)
    params = jax.tree_util.tree_map(np.asarray, params_to_numpy(trainer.model))
    _assert_same_mesh(ours, jax_reconstruct(jm.apply, params, 24, model=jm))


def _sphere_dataset(n=1500, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    r = np.linalg.norm(x, axis=1, keepdims=True)
    y = np.concatenate([r - 0.5, x / np.maximum(r, 1e-9)], axis=1).astype(np.float32)
    k = int(n * 0.9)
    return SDFDataset(x[:k], y[:k], x[k:], y[k:])


@pytest.mark.parametrize("name,hidden,layers", [("FeedForwardNetwork", 32, 2), ("Siren", 32, 2),
                                                ("KAN", 8, 1)])
def test_family_trains_reconstructs_and_audits(tmp_path, name, hidden, layers):
    save_mesh(make_icosphere(2, 0.5), str(tmp_path / "sphere.stl"))
    text = (REPO / "tests/test_config.ini").read_text().replace("@DIR@", str(tmp_path))
    for old, new in (("model = ImplicitNet", f"model = {name}"),
                     ("hidden_dim = 512", f"hidden_dim = {hidden}"),
                     ("num_hidden_layers = 8", f"num_hidden_layers = {layers}"),
                     ("lr = 0.00001", "lr = 0.003"), ("epochs = 20000", "epochs = 6"),
                     ("min_epochs = 400", "min_epochs = 2"), ("batch_size = 4096", "batch_size = 256"),
                     ("checkpointing = 100", "checkpointing = 3"), ("cubesize = 256", "cubesize = 24"),
                     ("rescale = True", "rescale = False")):
        assert old in text, old
        text = text.replace(old, new)
    (tmp_path / "m.ini").write_text(text)
    trainer = Trainer(Configuration(str(tmp_path / "m.ini")), device="cpu")
    assert type(trainer.model).__name__ == name
    if name == "KAN":  # the default grid of 256 is heavy for the CPU; JAX's test shrinks it too
        trainer.model = KAN(layers_hidden=(3, 8, 1), grid_size=8)
    res = trainer.train(dataset=_sphere_dataset())
    losses = res["train_losses"]
    assert len(losses) == 6 and np.all(np.isfinite(losses)) and losses[-1] < losses[0]

    trainer.load_model(best=False)
    ours = reconstruct.reconstruct_mesh(trainer.model, 24)
    if name == "KAN":
        jm = jax_models.KAN(layers_hidden=(3, 8, 1), grid_size=8)
    else:
        jm = getattr(jax_models, name)(**{
            "FeedForwardNetwork": dict(hidden_dim=hidden, num_layers=layers),
            "Siren": dict(hidden_dims=(hidden,) * layers)}[name])
    params = jax.tree_util.tree_map(np.asarray, params_to_numpy(trainer.model))
    want = jax_reconstruct(jm.apply, params, 24, model=jm)
    assert len(ours.faces) == len(want.faces)
    np.testing.assert_array_equal(ours.faces, want.faces)
    np.testing.assert_allclose(ours.vertices, want.vertices, rtol=0, atol=1e-5)

    out = post_process.post_process(trainer, mesh_path=str(tmp_path / "sphere.stl"))
    assert 0.0 <= out["sign_accuracy"] <= 1.0 and np.isfinite(out["nmse_0.01"])
    assert list(post_process.LAST_STAGE_SECONDS)[:2] == ["load", "predict"]
