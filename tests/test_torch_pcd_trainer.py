"""The port's point-cloud (IGR) trainer and the labelled trainer with the
eikonal losses, on the CPU at a tiny size (a 2,000-point sphere cloud,
ImplicitNet 4x32).

Parity with the JAX package: one fixed batch, with the same subsample
indices and the same noise, through ``PointCloudTrainer``'s loss formula in
both packages (jax.random is not reproduced, so the draws are made with numpy
and handed to both): value and parameter gradients within rtol 2e-4 / atol
2e-5. Loop semantics are checked on the port alone: the loss falls, the
checkpoint cadence and names, resume, ``load_model``, and reconstruction from
the point-cloud checkpoint through the command line."""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdf_representation_tpu.models import ImplicitNet as JaxImplicitNet
from sdf_representation_tpu.ops.diffops import sdf_and_gradient_fwd as jax_sdf_and_gradient_fwd
from sdf_representation_tpu.training.trainer import _bind_apply as jax_bind_apply
from sdf_representation_tpu_torch import cli
from sdf_representation_tpu_torch.configgen import Configuration
from sdf_representation_tpu_torch.convert import params_from_jax
from sdf_representation_tpu_torch.geometry.mesh_io import load_mesh
from sdf_representation_tpu_torch.models import ImplicitNet
from sdf_representation_tpu_torch.ops import fused_igr
from sdf_representation_tpu_torch.training import PointCloudTrainer, Trainer
from sdf_representation_tpu_torch.training import checkpoint as ckpt
from sdf_representation_tpu_torch.training import trainer as trainer_module
from sdf_representation_tpu_torch.training.pcd_trainer import pcd_loss
from sdf_representation_tpu_torch.training.trainer import bind_apply, use_fused_igr

torch.set_num_threads(2)
REPO = pathlib.Path(__file__).resolve().parent.parent
RADIUS = 0.5


def _cloud(n=2000, seed=0):
    pts = np.random.default_rng(seed).normal(size=(n, 3))
    return (RADIUS * pts / np.linalg.norm(pts, axis=1, keepdims=True)).astype(np.float32)


def _config(tmp_path, **changes):
    """tests/test_config.ini at 4x32 with IGRLOSSPCD; ``changes`` by key."""
    text = (REPO / "tests/test_config.ini").read_text().replace("@DIR@", str(tmp_path))
    base = {"geometry": f"{tmp_path}/cloud", "name": "sphere", "hidden_dim": 32,
            "num_hidden_layers": 4, "skip_connection": 2, "beta": 100, "geometric_init": True,
            "loss_function": "IGRLOSSPCD", "lr": 0.003, "epochs": 8, "min_epochs": 1,
            "batch_size": 500, "checkpointing": 4, "distributed": True, "rescale": False,
            "uniform_points": 0, "surface": 0, "narrowband": 0, "cubesize": 24}
    base.update(changes)
    tpu = {k: base.pop(k) for k in list(base) if k == "train_matmul_precision"}
    text = text.replace("weight_factor = 0.5\n", "lambda_g = 0.1\n")
    for key, value in base.items():
        lines = [ln for ln in text.splitlines() if ln.startswith(f"{key} = ")]
        text = text.replace(lines[0], f"{key} = {value}")
    if tpu:
        text += "\n[TPU]\n" + "".join(f"{k} = {v}\n" for k, v in tpu.items())
    tmp_path.mkdir(parents=True, exist_ok=True)
    path = tmp_path / "config.ini"
    path.write_text(text)
    return str(path)


def _write_cloud(tmp_path, pts, junk=False):
    (tmp_path / "cloud").mkdir(parents=True, exist_ok=True)
    rows = [f"{a!r},{b!r},{c!r},9" for a, b, c in pts.astype(np.float64).tolist()]
    if junk:  # rows that are not numbers are dropped
        rows.insert(5, "not,a,number,0")
        rows.insert(40, "1.0,,2.0,0")
    (tmp_path / "cloud" / "surface.csv").write_text("x,y,z,extra\n" + "\n".join(rows) + "\n")


def _labelled_csv(path, pts):
    """A bare-point CSV for a ``*_pcd`` run: an index column, x, y, z."""
    body = "\n".join(f"{i},{a!r},{b!r},{c!r}" for i, (a, b, c) in enumerate(pts.astype(np.float64).tolist()))
    path.write_text(",x,y,z\n" + body + "\n")


def test_loss_formula_matches_jax_on_a_fixed_batch():
    jm = JaxImplicitNet(d_in=3, hidden_dims=(32,) * 4, skip_in=(2,), beta=100.0)
    params = jm.init(jax.random.PRNGKey(0))
    model = ImplicitNet(d_in=3, hidden_dims=(32,) * 4, skip_in=(2,), beta=100.0)
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    rng = np.random.default_rng(1)
    xb = _cloud(300, seed=1)
    idx = rng.permutation(300)[:100]
    noise = (1e-4 * rng.normal(size=(100, 3))).astype(np.float32)
    apply_fn = jax_bind_apply(jm, None)

    def jax_loss(p):  # the body of pcd_trainer._make_epoch_fn's loss_fn, its draws given
        surface_loss = jnp.mean(jnp.abs(apply_fn(p, jnp.asarray(xb))))
        sampled = jnp.asarray(xb)[idx] + jnp.asarray(noise)
        _, grads = jax_sdf_and_gradient_fwd(apply_fn, p, sampled)
        grad_norm = jnp.linalg.norm(grads[:, -3:], axis=-1)
        return surface_loss + 0.1 * jnp.mean((grad_norm - 1.0) ** 2)

    want_value, want = jax.value_and_grad(jax_loss)(params)
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, want))
    value = pcd_loss(bind_apply(model), model, torch.from_numpy(xb), torch.from_numpy(idx),
                     torch.from_numpy(noise), 0.1)
    value.backward()
    np.testing.assert_allclose(float(value.detach()), float(want_value), rtol=2e-4)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), rtol=2e-4, atol=2e-5,
                                   err_msg=name)


def test_point_cloud_trainer_end_to_end(tmp_path, capsys):
    pts = _cloud()
    _write_cloud(tmp_path, pts, junk=True)
    cfg_path = _config(tmp_path)
    assert cli.main([cfg_path, "--device", "cpu"]) == 0  # distributed = True dispatches here
    assert "Training done: 8 epochs" in capsys.readouterr().out
    trainer = PointCloudTrainer(Configuration(cfg_path), device="cpu")
    assert trainer._load_points().shape == (2000, 3)
    np.testing.assert_array_equal(trainer._load_points(), pts)
    assert trainer.grad_lambda == 0.1 and trainer.local_sigma == 1e-4
    assert not use_fused_igr(trainer.model, "bfloat16")  # on the CPU the kernels never run
    log = (pathlib.Path(trainer.train_path) / "train_loss.txt").read_text().splitlines()
    assert len(log) == 8 and log[0].startswith("Epoch 1/8: train loss ")
    curve = [float(ln.rsplit(" ", 1)[1]) for ln in log]
    assert curve[-1] < 0.5 * curve[0] and np.isfinite(curve).all()
    # "best" every int(1.5 * 4) = 6 epochs and at the end, model_epoch{E} every 4
    names = sorted(p.name for p in pathlib.Path(trainer.model_save_path).iterdir())
    assert names == ["best_model.ckpt", "model_epoch0.ckpt", "model_epoch4.ckpt"]
    state = ckpt.load_checkpoint(str(pathlib.Path(trainer.model_save_path) / "best_model.ckpt"))
    assert set(state) == {"model", "optimizer", "epoch", "losses"}
    assert state["epoch"] == 7 and state["losses"] == curve
    assert trainer_module.LAST_RUN["epochs_run"] == 8 and trainer_module.LAST_RUN["points_per_sec"] > 0
    _, epoch = trainer.load_model()
    assert epoch == 7
    _, epoch = trainer.load_model(best=False)
    assert epoch == 4
    with torch.no_grad():  # the zero set moved onto the cloud
        assert float(trainer.model(torch.from_numpy(pts)).abs().mean()) < 0.05

    # resume: the same hyperparameters, continue = True, more epochs would
    # name another directory, so resume within this run's epochs is a no-op
    resumed = PointCloudTrainer(Configuration(_config(tmp_path, **{"continue": True})), device="cpu")
    out = resumed.train()
    assert out["epochs_run"] == 0 and out["losses"] == curve

    # reconstruct from the newest model_epoch checkpoint through the command line
    rec = _config(tmp_path, distributed=False, ppo=True, reconstruct=True)
    assert cli.main([rec, "--device", "cpu", "--compute-dtype", "float32"]) == 0
    mesh = load_mesh(str(pathlib.Path(trainer.postprocess_save_path) / "reconstructed_epoch4.stl"))
    radii = np.linalg.norm(mesh.vertices, axis=1)
    assert len(mesh.faces) > 100 and abs(np.median(radii) - RADIUS) < 0.1


def test_point_cloud_trainer_resumes_with_optimizer_state(tmp_path):
    pts = _cloud()
    cfg = Configuration(_config(tmp_path, epochs=4, checkpointing=2))
    straight = PointCloudTrainer(cfg, device="cpu").train(pts)
    # the same run in two halves: stop after 2 epochs, then continue
    half_dir = tmp_path / "half"
    cfg_a = Configuration(_config(half_dir, epochs=4, checkpointing=2))
    first = PointCloudTrainer(cfg_a, device="cpu")
    cfg_a.epochs = 2
    first.train(pts)
    cfg_b = Configuration(_config(half_dir, epochs=4, checkpointing=2, **{"continue": True}))
    second = PointCloudTrainer(cfg_b, device="cpu")
    out = second.train(pts)
    assert out["epochs_run"] == 2 and out["last_epoch"] == 3
    np.testing.assert_allclose(out["losses"], straight["losses"], rtol=1e-5)


@pytest.mark.parametrize("precision", ["default", "bfloat16"])
def test_point_cloud_trainer_lipschitz_and_precisions(tmp_path, precision):
    """The Lipschitz variant adds its bound's penalty; on the CPU every
    precision takes the shared-matmul derivation (no kernel launch)."""
    cfg_path = _config(tmp_path, epochs=2, train_matmul_precision=precision)
    text = pathlib.Path(cfg_path).read_text().replace(
        "geometric_init = True", "geometric_init = True\nlipschitz = True\nlipschitz_weight = 0.001")
    pathlib.Path(cfg_path).write_text(text)
    fused_igr.reset_launches()
    trainer = PointCloudTrainer(Configuration(cfg_path), device="cpu")
    assert trainer.model.lipschitz
    before = float(trainer.model.lipschitz_bound().detach())
    out = trainer.train(_cloud(1000))
    assert np.isfinite(out["losses"]).all() and out["losses"][0] > 0.001 * before * 0.5
    assert float(trainer.model.lipschitz_bound().detach()) != before  # the bounds are trained
    assert fused_igr.LAUNCHES == {"igr_fwd": 0, "igr_bwd": 0}


@pytest.mark.parametrize("loss_name", ["IGRLOSS", "RegularizedCustomSDFLoss", "GaussBonnetLoss"])
def test_labelled_trainer_with_the_eikonal_losses(tmp_path, loss_name, capsys):
    from sdf_representation_tpu_torch.data.dataset import SDFDataset

    rng = np.random.default_rng(0)

    def xy(n):
        x = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
        r = np.linalg.norm(x, axis=1, keepdims=True)
        return x, np.concatenate([r - RADIUS, x / r], axis=1).astype(np.float32)

    n_train = 128 if loss_name == "GaussBonnetLoss" else 512
    cfg_path = _config(tmp_path, loss_function=loss_name, distributed=False, epochs=4,
                       checkpointing=2, batch_size=64, lr=0.001)
    extra = {"GaussBonnetLoss": "lambda_g = 0.1\ngauss_bonnet_weight = 1e-8",
             "RegularizedCustomSDFLoss": "regularizer_weight = 1.0", "IGRLOSS": "lambda_g = 0.1"}
    text = pathlib.Path(cfg_path).read_text().replace("lambda_g = 0.1", extra[loss_name])
    pathlib.Path(cfg_path).write_text(text)
    trainer = Trainer(Configuration(cfg_path), device="cpu")
    out = trainer.train(SDFDataset(*xy(n_train), *xy(64)))
    assert out["epochs_run"] == 4 and np.isfinite(out["train_losses"]).all()
    assert np.isfinite(out["val_losses"]).all()
    assert out["train_losses"][-1] < out["train_losses"][0]
    state = ckpt.load_checkpoint(str(pathlib.Path(trainer.model_save_path) / "model_epoch3.ckpt"))
    if loss_name == "GaussBonnetLoss":  # the Euler scalar is trained and saved
        assert set(state["aux"]) == {"euler_characteristic"}
        assert float(state["aux"]["euler_characteristic"]) != 2.0
        resumed = Trainer(Configuration(cfg_path), device="cpu")
        resumed.config.contd = True
        resumed.train(SDFDataset(*xy(n_train), *xy(64)))
        assert "Resumed from" in capsys.readouterr().out
    else:
        assert "aux" not in state


@pytest.mark.parametrize("precision", ["default", "bfloat16"])
def test_labelled_trainer_on_a_pcd_run_name(tmp_path, precision, capsys):
    """A run whose name holds "pcd": no sampling, ``geometry`` is one CSV of
    bare points, the targets are empty and IGRLOSSPCD draws its own points
    from the step's generator."""
    pts = _cloud()
    _labelled_csv(tmp_path / "scan.csv", pts)
    cfg_path = _config(tmp_path, name="scan_pcd", geometry=f"{tmp_path}/scan.csv",
                       distributed=False, epochs=3, batch_size=256,
                       train_matmul_precision=precision)
    assert cli.main([cfg_path, "--device", "cpu"]) == 0
    assert "Training done: 3 epochs" in capsys.readouterr().out
    trainer = Trainer(Configuration(cfg_path), device="cpu")
    curve = np.loadtxt(pathlib.Path(trainer.train_path) / "train_loss.txt")
    assert curve.shape == (3, 3) and np.isfinite(curve).all() and curve[-1, 1] < curve[0, 1]
    # the schedule depends on (seed, epoch, step) only: a second run repeats it
    again = tmp_path / "again"
    again.mkdir()
    cfg2 = _config(again, name="scan_pcd", geometry=f"{tmp_path}/scan.csv", distributed=False,
                   epochs=3, batch_size=256, train_matmul_precision=precision)
    assert cli.main([cfg2, "--device", "cpu"]) == 0
    curve2 = np.loadtxt(pathlib.Path(Trainer(Configuration(cfg2), device="cpu").train_path)
                        / "train_loss.txt")
    np.testing.assert_array_equal(curve, curve2)


def test_use_fused_igr_rule():
    """bfloat16 asked for, not the Lipschitz variant, the model on a card."""
    model = ImplicitNet(d_in=3, hidden_dims=(16,) * 2, skip_in=(), beta=100.0)
    lip = ImplicitNet(d_in=3, hidden_dims=(16,) * 2, skip_in=(), beta=100.0, lipschitz=True)
    for precision in (None, "bfloat16", "bfloat16_mxu"):
        assert not use_fused_igr(model, precision)  # on the CPU: never
        assert not use_fused_igr(lip, precision)
    apply = bind_apply(model, "bfloat16")
    x = torch.from_numpy(_cloud(8))
    f, g = apply._implicitnet_fast(x)
    assert f.dtype == g.dtype == torch.float32 and g.shape == (8, 3)
    f32, g32 = bind_apply(model)._implicitnet_fast(x)
    assert not torch.equal(f, f32) and torch.allclose(f, f32.detach(), atol=0.05)
