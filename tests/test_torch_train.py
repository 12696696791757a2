"""The port's training step and loop against the JAX package's.

Parity: from the same weights (JAX init carried over through
``convert.params_from_jax``) and identical unshuffled batches, the
parameters after K = 5 Adam steps in f32, with and without the ``lr_step``
staircase, agree with ``make_train_step`` + the JAX trainer's optax
optimizer. Tolerance: rtol 1e-4 / atol 2e-6 at lr 1e-3, i.e. 0.2% of one
step's movement: Adam divides by sqrt(v), so the f32 summation-order
difference of a gradient (~1e-6 relative) passes into the update unscaled.

Loop semantics are checked on the port alone: schedule independent of
anything but (seed, epoch), partial batches dropped, checkpoints and their
cadence, resume with optimizer and scheduler state, early stop, the
precision modes."""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdf_representation_tpu.configgen import Configuration as JaxConfiguration
from sdf_representation_tpu.models import ImplicitNet as JaxImplicitNet
from sdf_representation_tpu.training import trainer as jax_trainer
from sdf_representation_tpu_torch.configgen import Configuration
from sdf_representation_tpu_torch.convert import params_from_jax
from sdf_representation_tpu_torch.data.dataset import SDFDataset
from sdf_representation_tpu_torch.training import Trainer
from sdf_representation_tpu_torch.training import checkpoint as ckpt
from sdf_representation_tpu_torch.training.trainer import make_train_step

torch.set_num_threads(2)
REPO = pathlib.Path(__file__).resolve().parent.parent
HIDDEN, LAYERS, SKIP = 32, 3, 2


def _config(tmp_path, **changes):
    text = (REPO / "tests/test_config.ini").read_text().replace("@DIR@", str(tmp_path))
    base = {"hidden_dim": HIDDEN, "num_hidden_layers": LAYERS, "skip_connection": SKIP,
            "beta": 100, "geometric_init": True, "lr": 0.001, "epochs": 4, "min_epochs": 1,
            "batch_size": 64, "checkpointing": 2, "patience": 1000}
    base.update(changes)
    extra = []
    for key, value in base.items():
        lines = [ln for ln in text.splitlines() if ln.startswith(f"{key} = ")]
        if lines:
            text = text.replace(lines[0], f"{key} = {value}")
        else:
            extra.append((key, value))
    training = [kv for kv in extra if kv[0] in ("lr_step", "lr_gamma")]
    tpu = [kv for kv in extra if kv[0] not in ("lr_step", "lr_gamma")]
    text = text.replace("patience = ", "".join(f"{k} = {v}\n" for k, v in training) + "patience = ")
    if tpu:
        text += "\n[TPU]\n" + "".join(f"{k} = {v}\n" for k, v in tpu)
    tmp_path.mkdir(parents=True, exist_ok=True)
    path = tmp_path / "config.ini"
    path.write_text(text)
    return str(path)


def _dataset(n_train=300, n_val=40, seed=0):
    rng = np.random.default_rng(seed)

    def xy(n):
        x = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
        r = np.linalg.norm(x, axis=1, keepdims=True)
        return x, np.concatenate([r - 0.5, x / r], axis=1).astype(np.float32)

    return SDFDataset(*xy(n_train), *xy(n_val))


@pytest.mark.parametrize("lr_step", [0, 1], ids=["constant_lr", "lr_step"])
def test_five_adam_steps_match_jax(tmp_path, lr_step):
    changes = {"lr_step": lr_step, "lr_gamma": 0.5} if lr_step else {}
    cfg_path = _config(tmp_path, **changes)
    data = _dataset()
    batch, n_train, K = 64, 128, 5  # 2 steps per epoch: the rate halves after steps 2 and 4

    jcfg = JaxConfiguration(cfg_path)
    jt = jax_trainer.Trainer(jcfg)
    optimizer = jt._make_optimizer(n_train)
    trainable = {"params": jt.model.init(jax.random.PRNGKey(0)), "aux": {}}
    start = jax.tree_util.tree_map(np.asarray, trainable["params"])
    opt_state = optimizer.init(trainable)
    jstep = jax.jit(jax_trainer.make_train_step(jt.model, jt.loss, optimizer))

    trainer = Trainer(Configuration(cfg_path), device="cpu")
    trainer.model.load_state_dict(params_from_jax(start))
    opt, sched = trainer._make_optimizer()
    assert (sched is not None) == bool(lr_step)
    step = make_train_step(trainer.model, trainer.config.make_loss(), opt)

    ref_losses, got_losses = [], []
    for k in range(K):
        lo = (k % 2) * batch
        xb, yb = data.train_x[lo:lo + batch], data.train_y[lo:lo + batch]
        trainable, opt_state, loss = jstep(trainable, opt_state, jnp.asarray(xb), jnp.asarray(yb),
                                           jax.random.PRNGKey(0), 0)
        ref_losses.append(float(loss))
        got_losses.append(step(torch.from_numpy(xb), torch.from_numpy(yb), k // 2).item())
        if sched is not None and k % 2 == 1:
            sched.step()  # once per epoch
    np.testing.assert_allclose(got_losses, ref_losses, rtol=1e-4)
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, trainable["params"]))
    moved = 0.0
    for key, value in want.items():
        got = trainer.model.get_parameter(key).detach().numpy()
        np.testing.assert_allclose(got, value.numpy(), rtol=1e-4, atol=2e-6, err_msg=key)
        moved = max(moved, np.abs(got - params_from_jax(start)[key].numpy()).max())
    # K steps moved the weights by ~K * lr (less under the staircase)
    assert 1e-3 < moved < 6e-3
    if lr_step:
        assert opt.param_groups[0]["lr"] == pytest.approx(0.001 * 0.25)


def test_training_loop_files_schedule_and_result(tmp_path):
    cfg = Configuration(_config(tmp_path, epochs=4, checkpointing=2))
    trainer = Trainer(cfg, device="cpu")
    data = _dataset()
    result = trainer.train(data)
    assert result["epochs_run"] == 4 and result["last_epoch"] == 3
    assert len(result["train_losses"]) == len(result["val_losses"]) == 4
    assert result["train_losses"][-1] < result["train_losses"][0]
    assert result["best_val"] == min(result["val_losses"]) and result["points_per_sec"] > 0
    models = pathlib.Path(trainer.model_save_path)
    assert sorted(p.name for p in models.iterdir()) == [
        "best_model.ckpt", "model_epoch1.ckpt", "model_epoch3.ckpt"]
    log = (pathlib.Path(trainer.train_path) / "train_loss.txt").read_text().split("\n")
    assert [ln.split()[0] for ln in log if ln] == ["0", "1", "2", "3"]
    assert float(log[2].split()[1]) == result["train_losses"][2]
    state = ckpt.load_checkpoint(str(models / "model_epoch3.ckpt"))
    assert set(state) == {"model", "epoch", "optimizer", "scheduler", "train_losses",
                          "val_losses", "best_val"}
    assert state["epoch"] == 3 and state["scheduler"] is None
    # 300 points in batches of 64: 4 batches, the partial one dropped
    assert state["optimizer"]["state"][0]["step"].item() == 4 * 4
    idx = trainer._epoch_batches(2, 300, 64)
    assert idx.shape == (4, 64) and len(set(idx.flatten().tolist())) == 256
    assert torch.equal(idx, trainer._epoch_batches(2, 300, 64))
    assert not torch.equal(idx, trainer._epoch_batches(3, 300, 64))
    # a second trainer with the same seed repeats the run bit for bit
    again = Trainer(Configuration(_config(tmp_path / "again", epochs=4)), device="cpu").train(data)
    assert again["train_losses"] == result["train_losses"]


def test_resume_restores_optimizer_scheduler_and_history(tmp_path):
    data = _dataset()
    common = {"lr_step": 2, "lr_gamma": 0.5, "checkpointing": 100}
    whole = Trainer(Configuration(_config(tmp_path / "whole", epochs=6, **common)), device="cpu")
    ref = whole.train(data)

    first_cfg = Configuration(_config(tmp_path / "split", epochs=3, **common))
    first = Trainer(first_cfg, device="cpu")
    part = first.train(data)
    assert part["train_losses"] == ref["train_losses"][:3]
    best = ckpt.load_checkpoint(str(pathlib.Path(first.model_save_path) / "best_model.ckpt"))
    e = best["epoch"]
    assert best["optimizer"]["state"][0]["exp_avg"].abs().sum() > 0
    assert best["scheduler"]["last_epoch"] == e + 1
    assert best["train_losses"] == ref["train_losses"][:e + 1]

    # the run directory encodes `epochs`: resume there with `continue = True`
    second_cfg = Configuration(_config(tmp_path / "split", epochs=3, **common))
    second_cfg.contd = True
    second = Trainer(second_cfg, device="cpu")
    second_cfg.epochs = 6  # after the directories are named
    rest = second.train(data)
    assert rest["epochs_run"] == 6 - (e + 1)
    # Adam moments, the step count and the rate staircase all came back: the
    # resumed epochs repeat the uninterrupted run's
    np.testing.assert_allclose(rest["train_losses"], ref["train_losses"], rtol=1e-6)
    for a, b in zip(second.model.parameters(), whole.model.parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), rtol=1e-5, atol=1e-7)


def test_checkpoint_of_the_reconstruction_slice_still_loads(tmp_path):
    cfg = Configuration(_config(tmp_path, epochs=2))
    cfg.contd = True
    trainer = Trainer(cfg, device="cpu", init_seed=3)
    other = Trainer(cfg, device="cpu", init_seed=4)
    ckpt.save_checkpoint(str(pathlib.Path(trainer.model_save_path) / "best_model.ckpt"),
                         {"model": other.model.state_dict(), "epoch": 0})
    result = trainer.train(_dataset())  # resumes at epoch 1 with fresh Adam state
    assert result["epochs_run"] == 1 and result["last_epoch"] == 1
    _, epoch = Trainer(cfg, device="cpu").load_model(best=True)
    assert epoch in (0, 1)


def test_early_stop_and_validation_batches(tmp_path):
    cfg = Configuration(_config(tmp_path, epochs=50, min_epochs=2, patience=2, lr=0.0))
    trainer = Trainer(cfg, device="cpu")
    data = _dataset(n_train=128, n_val=100)
    result = trainer.train(data)
    # lr = 0: validation never improves after epoch 0, so patience runs out at epoch 2
    assert result["last_epoch"] == 2 and result["epochs_run"] == 3
    assert len(set(result["val_losses"])) == 1
    loss_fn = cfg.make_loss()
    Xv, Yv = torch.from_numpy(data.val_x), torch.from_numpy(data.val_y)
    # min(batch, n_val) = 64-sized validation batches: one, the remainder dropped
    want = loss_fn(trainer.model, Xv[:64], Yv[:64], 0).item()
    assert result["val_losses"][0] == pytest.approx(want, rel=1e-6)
    empty = SDFDataset(data.train_x, data.train_y, data.val_x[:0], data.val_y[:0])
    cfg2 = Configuration(_config(tmp_path / "noval", epochs=2))
    r2 = Trainer(cfg2, device="cpu").train(empty)
    assert r2["val_losses"] == r2["train_losses"]  # no validation data: the train loss stands in


@pytest.mark.parametrize("precision", ["bfloat16", "bfloat16_mxu"])
def test_precision_modes_train_and_restore_the_switch(tmp_path, precision):
    cfg = Configuration(_config(tmp_path, epochs=3, train_matmul_precision=precision,
                                epochs_per_call=50))
    assert cfg.train_matmul_precision == precision and cfg.epochs_per_call == 50
    before = torch.get_float32_matmul_precision()
    trainer = Trainer(cfg, device="cpu")
    result = trainer.train(_dataset())
    assert torch.get_float32_matmul_precision() == before
    assert all(p.dtype == torch.float32 for p in trainer.model.parameters())  # f32 masters
    assert np.isfinite(result["train_losses"]).all()
    assert result["train_losses"][-1] < result["train_losses"][0]
    state = ckpt.load_checkpoint(str(pathlib.Path(trainer.model_save_path) / "best_model.ckpt"))
    assert state["optimizer"]["state"][0]["exp_avg"].dtype == torch.float32
    f32 = Trainer(Configuration(_config(tmp_path / "f32", epochs=3)), device="cpu").train(_dataset())
    # same data, same schedule: the reduced-precision run tracks the f32 one
    np.testing.assert_allclose(result["train_losses"], f32["train_losses"], rtol=0.2)
    if precision == "bfloat16":
        assert result["train_losses"] != f32["train_losses"]


def test_unknown_precision_and_unported_losses_raise(tmp_path):
    cfg = Configuration(_config(tmp_path))
    trainer = Trainer(cfg, device="cpu")
    opt, _ = trainer._make_optimizer()
    with pytest.raises(ValueError, match="train_matmul_precision"):
        make_train_step(trainer.model, cfg.make_loss(), opt, "float16")
    # the eikonal family trains through the same loop
    cfg.loss_name = "IGRLOSS"
    cfg.loss_kwargs = {"delta": 0.1}
    out = trainer.train(_dataset())
    assert out["epochs_run"] == 4 and np.isfinite(out["train_losses"]).all()
    assert out["train_losses"][-1] < out["train_losses"][0]
