"""The slice as a whole on the CPU: `python -m sdf_representation_tpu_torch
cfg --device cpu` reconstructs from a port checkpoint holding JAX-initialised
weights, and the mesh matches the JAX package's reconstruct_mesh on the same
weights: faces identical, vertices within 1e-5. The card's sparse route (the
sparse evaluator's volume marched by the device marcher over the packed
wire) is taken on the CPU by asking ``choose_route`` for a card's route, and
matches the JAX package's sparse volume marched over its packed wire.

The two fields agree to ~1e-7 (f32 summation order; the fused forward splits
the skip matmul). A vertex interpolates t = -va / (vb - va) along a grid
edge, so where the edge's end values nearly coincide that difference is
magnified: such vertices (under 0.1% here) are held to 1e-3 instead."""

import pathlib
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdf_representation_tpu.evaluations.reconstruct import reconstruct_mesh as jax_reconstruct
from sdf_representation_tpu.models import ImplicitNet as JaxImplicitNet
from sdf_representation_tpu.ops.marching import marching_cubes as jax_marching_cubes
from sdf_representation_tpu.ops.sparse_grid import sparse_grid_eval as jax_sparse_grid_eval
from sdf_representation_tpu_torch.cli import main
from sdf_representation_tpu_torch.configgen import Configuration
from sdf_representation_tpu_torch.convert import params_from_jax
from sdf_representation_tpu_torch.evaluations import reconstruct
from sdf_representation_tpu_torch.geometry.mesh_io import Mesh
from sdf_representation_tpu_torch.ops import giga_extract
from sdf_representation_tpu_torch.training import Trainer
from sdf_representation_tpu_torch.training.checkpoint import save_checkpoint

torch.set_num_threads(2)
REPO = pathlib.Path(__file__).resolve().parent.parent


def _config(tmp_path, cubesize, ppo=True, rec=True):
    text = (REPO / "tests/test_config.ini").read_text().replace("@DIR@", str(tmp_path))
    for old, new in [("hidden_dim = 512", "hidden_dim = 64"),
                     ("num_hidden_layers = 8", "num_hidden_layers = 4"),
                     ("skip_connection = 0", "skip_connection = 2"),
                     ("beta = 0", "beta = 100"),
                     ("geometric_init = False", "geometric_init = True"),
                     ("ppo = False", f"ppo = {ppo}"),
                     ("reconstruct = False", f"reconstruct = {rec}"),
                     ("cubesize = 256", f"cubesize = {cubesize}")]:
        assert old in text
        text = text.replace(old, new)
    path = tmp_path / "config.ini"
    path.write_text(text)
    return str(path)


def _assert_vertices_close(got, want):
    diff = np.abs(np.asarray(got, np.float64) - want).max(axis=-1).reshape(-1)
    assert np.mean(diff <= 1e-5) > 0.999
    assert diff.max() <= 1e-3


def _stl_triangles(path):
    blob = pathlib.Path(path).read_bytes()
    (count,) = struct.unpack("<I", blob[80:84])
    rec = np.frombuffer(blob[84:84 + 50 * count], np.uint8).reshape(count, 50)
    return rec[:, 12:48].copy().view("<f4").reshape(count, 3, 3)


def _card_routes(monkeypatch):
    """reconstruct_mesh takes the route a card would take, on CPU tensors."""
    real = reconstruct.choose_route
    monkeypatch.setattr(reconstruct, "choose_route", lambda n, kind: real(n, "cuda"))


@pytest.mark.parametrize("cubesize,sparse", [(32, False), (64, True)])
def test_cli_reconstruction_matches_jax(tmp_path, monkeypatch, cubesize, sparse):
    if sparse:  # the card's sparse route, 64 standing in for >= 256
        monkeypatch.setattr(reconstruct, "SPARSE_MIN_CUBESIZE", cubesize)
        _card_routes(monkeypatch)
        assert reconstruct.choose_route(cubesize, "cpu") == "sparse"
    cfg_path = _config(tmp_path, cubesize)
    jm = JaxImplicitNet(d_in=3, hidden_dims=(64,) * 4, skip_in=(2,), beta=100.0, radius_init=0.5)
    params = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    trainer = Trainer(Configuration(cfg_path), device="cpu")
    save_checkpoint(f"{trainer.model_save_path}/model_epoch0.ckpt",
                    {"model": params_from_jax(params), "epoch": 0})

    assert main([cfg_path, "--device", "cpu", "--compute-dtype", "float32"]) == 0
    stages = reconstruct.LAST_STAGE_SECONDS
    assert list(stages) == ["load_checkpoint", "evaluate", "march"] + ["decode"] * sparse + ["write_stl"]
    assert all(s >= 0 for s in stages.values())

    stl = pathlib.Path(trainer.postprocess_save_path) / "reconstructed_epoch0.stl"
    assert stl.exists() and stl.stat().st_size > 84
    if sparse:
        # the JAX package's route on an accelerator: the sparse volume stays
        # on the device and is marched there over the packed wire
        vol = jax_sparse_grid_eval(jm, params, cubesize, compute_dtype=jnp.float32, interpret=True)
        sp = 2.0 / (cubesize - 1)
        ref = Mesh(*jax_marching_cubes(vol, 0.0, (sp,) * 3, (-1.0,) * 3, wire="packed"))
    else:
        ref = jax_reconstruct(jm.apply, params, cubesize, model=jm, use_pallas=False)
    tris = _stl_triangles(stl)
    assert len(tris) == len(ref.faces) > 100
    _assert_vertices_close(tris, ref.vertices[ref.faces])

    trainer.load_model(best=False)
    ours = reconstruct.reconstruct_mesh(trainer.model, cubesize, compute_dtype=torch.float32)
    np.testing.assert_array_equal(ours.faces, ref.faces)
    _assert_vertices_close(ours.vertices, ref.vertices)
    # a 4x64 geometric-init net is only roughly |x| - 0.5: its zero set is a
    # closed blob around the origin with median radius ~0.69
    radii = np.linalg.norm(ours.vertices, axis=1)
    assert 0.5 < np.median(radii) < 0.8 and radii.min() > 0.2


def test_unported_modes_and_missing_card_raise(tmp_path):
    cfg = Configuration(_config(tmp_path, 32, ppo=False, rec=False))
    # the eikonal losses are ported: the configured loss is built
    cfg.loss_name = "IGRLOSS"
    cfg.loss_kwargs = {"delta": 0.1}
    assert type(cfg.make_loss()).__name__ == "IGRLOSS"
    cfg.loss_name = "WeightedSmoothL2Loss"
    cfg.loss_kwargs = {"weight_factor": 0.5, "delta": 0.1}
    # every model family is ported (tests/test_torch_model_families.py): the
    # configured one is built
    for name in ("HashMLP", "FeedForwardNetwork", "Siren", "KAN"):
        cfg.model_name = name
        assert type(Trainer(cfg, device="cpu").model).__name__ == name
    cfg.model_name = "ImplicitNet"
    # the audit and reconstruction need a checkpoint
    cfg.ppo = True
    with pytest.raises(FileNotFoundError):
        Trainer(cfg, device="cpu").run()
    with pytest.raises(FileNotFoundError):
        Trainer(cfg, device="cpu").load_model()
    with pytest.raises(FileNotFoundError):
        reconstruct.reconstruct_only(Trainer(cfg, device="cpu"), gif=True)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Trainer(cfg)


@pytest.mark.parametrize("plot", ["fails", "draws"])
def test_reconstruct_only_gif(tmp_path, monkeypatch, capsys, plot):
    """The GIF beside the STL (JAX reconstruct.py:125-130): a failure to draw
    it is printed and the STL is still returned."""
    from sdf_representation_tpu_torch.evaluations import generate_gif

    trainer = Trainer(Configuration(_config(tmp_path, 16)), device="cpu")
    save_checkpoint(f"{trainer.model_save_path}/model_epoch3.ckpt",
                    {"model": trainer.model.state_dict(), "epoch": 3})
    if plot == "fails":
        def broken(stl_path, gif_path, **kw):
            raise RuntimeError("no matplotlib")

        monkeypatch.setattr(generate_gif, "plot_stl", broken)
    else:
        pytest.importorskip("matplotlib")
    stl = pathlib.Path(reconstruct.reconstruct_only(trainer))
    assert stl.name == "reconstructed_epoch3.stl" and stl.stat().st_size > 84
    gif = stl.with_suffix(".gif")
    if plot == "fails":
        assert "GIF generation failed: no matplotlib" in capsys.readouterr().out
        assert not gif.exists()
    else:
        assert gif.read_bytes()[:6] == b"GIF89a"


def test_routes_follow_the_jax_dispatch():
    route = reconstruct.choose_route
    assert [route(n, "cpu") for n in (32, 256, 1024)] == ["cpu"] * 3
    # giga from cubesize^3 * 7 >= 2^31: 680 is the first multiple of 8
    assert [route(n, "cuda") for n in (128, 255, 256, 512, 672, 680, 1024, 1025)] == [
        "dense", "dense", "sparse", "sparse", "sparse", "giga", "giga", "dense"]


def test_giga_grid_takes_the_slab_extractor(tmp_path, monkeypatch):
    """A giga-sized grid on a card goes to extract_mesh_giga over the packed
    wire with the dense answer to a certificate violation (the JAX call)."""
    model = Trainer(Configuration(_config(tmp_path, 32)), device="cpu").model
    _card_routes(monkeypatch)
    calls = []

    def fake(m, n, **kw):
        calls.append((m, n, kw))
        kw["stages"].update(evaluate=0.0, march=0.0, decode=0.0)
        return np.zeros((3, 3)), np.array([[0, 1, 2]])

    monkeypatch.setattr(giga_extract, "extract_mesh_giga", fake)
    reconstruct.LAST_STAGE_SECONDS.clear()
    mesh = reconstruct.reconstruct_mesh(model, 1024, compute_dtype=torch.float32)
    assert len(mesh.faces) == 1
    (m, n, kw), = calls
    assert m is model and n == 1024
    assert kw["wire"] == "packed" and kw["on_violation"] == "dense"
    assert kw["compute_dtype"] == torch.float32 and kw["devices"] is None
    assert list(reconstruct.LAST_STAGE_SECONDS) == ["evaluate", "march", "decode"]
