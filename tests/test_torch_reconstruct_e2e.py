"""The slice as a whole on the CPU: `python -m sdf_representation_tpu_torch
cfg --device cpu` reconstructs from a port checkpoint holding JAX-initialised
weights, and the mesh matches the JAX package's reconstruct_mesh on the same
weights: faces identical, vertices within 1e-5.

The two fields agree to ~1e-7 (f32 summation order; the fused forward splits
the skip matmul). A vertex interpolates t = -va / (vb - va) along a grid
edge, so where the edge's end values nearly coincide that difference is
magnified: such vertices (under 0.1% here) are held to 1e-3 instead."""

import pathlib
import struct

import jax
import numpy as np
import pytest
import torch

from sdf_representation_tpu.evaluations.reconstruct import reconstruct_mesh as jax_reconstruct
from sdf_representation_tpu.models import ImplicitNet as JaxImplicitNet
from sdf_representation_tpu_torch.cli import main
from sdf_representation_tpu_torch.configgen import Configuration
from sdf_representation_tpu_torch.convert import params_from_jax
from sdf_representation_tpu_torch.evaluations import reconstruct
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


@pytest.mark.parametrize("cubesize,sparse", [(32, False), (64, True)])
def test_cli_reconstruction_matches_jax(tmp_path, monkeypatch, cubesize, sparse):
    if sparse:  # stand-in for the >= 256 route
        monkeypatch.setattr(reconstruct, "SPARSE_MIN_CUBESIZE", cubesize)
    cfg_path = _config(tmp_path, cubesize)
    jm = JaxImplicitNet(d_in=3, hidden_dims=(64,) * 4, skip_in=(2,), beta=100.0, radius_init=0.5)
    params = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    trainer = Trainer(Configuration(cfg_path), device="cpu")
    save_checkpoint(f"{trainer.model_save_path}/model_epoch0.ckpt",
                    {"model": params_from_jax(params), "epoch": 0})

    assert main([cfg_path, "--device", "cpu", "--compute-dtype", "float32"]) == 0
    stages = reconstruct.LAST_STAGE_SECONDS
    assert list(stages) == ["load_checkpoint", "evaluate", "march", "write_stl"]
    assert all(s >= 0 for s in stages.values())

    stl = pathlib.Path(trainer.postprocess_save_path) / "reconstructed_epoch0.stl"
    assert stl.exists() and stl.stat().st_size > 84
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
    # what ROADMAP.md still queues raises: the eikonal losses, the 2-D mode
    cfg.loss_name = "IGRLOSS"
    with pytest.raises(NotImplementedError, match="slice 3"):
        Trainer(cfg, device="cpu").run()
    cfg.loss_name = "WeightedSmoothL2Loss"
    cfg.two_dim = True
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Trainer(cfg, device="cpu").run()
    cfg.two_dim = False
    # the audit and reconstruction need a checkpoint
    cfg.ppo = True
    with pytest.raises(FileNotFoundError):
        Trainer(cfg, device="cpu").run()
    with pytest.raises(FileNotFoundError):
        Trainer(cfg, device="cpu").load_model()
    with pytest.raises(NotImplementedError):
        reconstruct.reconstruct_only(Trainer(cfg, device="cpu"), gif=True)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Trainer(cfg)


def test_giga_grid_raises(tmp_path):
    model = Trainer(Configuration(_config(tmp_path, 32)), device="cpu").model
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        reconstruct.reconstruct_mesh(model, 1024)
