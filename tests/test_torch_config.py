"""The port's Configuration parses the repo's INI files to the same fields
as the JAX package's, and builds the torch model from them."""

import pathlib

import pytest
import torch

from sdf_representation_tpu.configgen import Configuration as JaxConfiguration
from sdf_representation_tpu_torch.configgen import Configuration
from sdf_representation_tpu_torch.models import ImplicitNet

REPO = pathlib.Path(__file__).resolve().parent.parent
CONFIGS = ["configs/mesh_sdf.ini", "configs/pointcloud_igr.ini", "tests/test_config.ini",
           "configs/circle_2d.ini", "configs/mesh_sdf_hash.ini"]


def _fields(cfg):
    return {k: v for k, v in vars(cfg).items() if k not in ("config", "_model", "_loss")}


@pytest.mark.parametrize("path", CONFIGS)
def test_same_fields_as_jax_configuration(path):
    theirs = JaxConfiguration(str(REPO / path))
    ours = Configuration(str(REPO / path))
    assert _fields(ours) == _fields(theirs)


def test_skip_connection_zero_forces_relu(tmp_path):
    ours = Configuration(str(REPO / "tests/test_config.ini"))
    assert ours.skip_connection == () and ours.beta == 0.0
    text = (REPO / "configs/mesh_sdf.ini").read_text()
    p = tmp_path / "c.ini"
    p.write_text(text.replace("skip_connection = 4", "skip_connection = 0"))
    ours, theirs = Configuration(str(p)), JaxConfiguration(str(p))
    assert ours.skip_connection == theirs.skip_connection == ()
    assert ours.beta == theirs.beta == 0.0


def test_make_model_builds_the_flagship_architecture():
    cfg = Configuration(str(REPO / "configs/mesh_sdf.ini"))
    jax_model = JaxConfiguration(str(REPO / "configs/mesh_sdf.ini")).make_model()
    model = cfg.make_model(generator=torch.Generator().manual_seed(0))
    assert isinstance(model, ImplicitNet)
    assert (model.d_in, model.hidden_dims, model.skip_in, model.beta) == (
        jax_model.d_in, jax_model.hidden_dims, jax_model.skip_in, jax_model.beta)
    assert model.layer_shapes() == list(jax_model.layer_shapes())
    loss = cfg.make_loss()
    assert type(loss).__name__ == "WeightedSmoothL2Loss"
    assert (loss.weight_factor, loss.delta) == (0.5, 0.1)
    # the point-cloud config: the eikonal family, 8x256, the point-cloud trainer
    pcd = Configuration(str(REPO / "configs/pointcloud_igr.ini"))
    jax_pcd = JaxConfiguration(str(REPO / "configs/pointcloud_igr.ini"))
    loss, jax_loss = pcd.make_loss(), jax_pcd.make_loss()
    assert type(loss).__name__ == type(jax_loss).__name__ == "IGRLOSSPCD"
    assert (loss.delta, loss.lambda_g, loss.local_sigma, loss.global_sigma) == (
        jax_loss.delta, jax_loss.lambda_g, jax_loss.local_sigma, jax_loss.global_sigma)
    assert pcd.distributed and pcd.make_model().hidden_dims == (256,) * 8


def test_hash_config_builds_the_jax_model(tmp_path):
    """configs/mesh_sdf_hash.ini builds the HashMLP the JAX package builds
    (num_layers = max(2, num_hidden_layers)); an unknown name raises as
    there."""
    cfg = Configuration(str(REPO / "configs/mesh_sdf_hash.ini"))
    jax_model = JaxConfiguration(str(REPO / "configs/mesh_sdf_hash.ini")).make_model()
    model = cfg.make_model(generator=torch.Generator().manual_seed(0))
    assert type(model).__name__ == type(jax_model).__name__ == "HashMLP"
    fields = ("d_in", "n_levels", "n_features", "log2_table_size", "base_resolution",
              "max_resolution", "hidden_dim", "num_layers", "include_xyz")
    assert [getattr(model, f) for f in fields] == [getattr(jax_model, f) for f in fields]
    assert model.num_layers == 3 and cfg.train_matmul_precision == "bfloat16"
    cfg.model_name = "NoSuchNet"
    with pytest.raises(ValueError, match="Unknown model"):
        cfg.make_model()
