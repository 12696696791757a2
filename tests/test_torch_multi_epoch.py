"""The port's ``epochs_per_call`` blocks against per-epoch training and
against the JAX trainer's multi-epoch call (tests/test_multi_epoch.py's
cases), and the pieces of training/graphs.py that run on the CPU.

  * block invariance: ``epochs_per_call`` 4, 8 (a final partial block) and
    12 over 12 epochs give the losses, parameters and Adam state of
    per-epoch training bit for bit (tolerance 0);
  * an early stop inside a block at lr = 0: the JAX trainer's
    ``epochs_run`` and validation losses (rtol 1e-5), from the JAX weights
    (``convert.params_from_jax``); a device best after the stop is adopted
    with its history, as JAX adopts it;
  * the best checkpoint in mid-block (a loss whose validation minimum is
    epoch 3 by construction): epoch 3 in both packages, and its parameters
    and optimizer state those of a 4-epoch per-epoch run, bit for bit;
  * ``model_epoch*.ckpt`` names equal to the JAX run's for blocks that do
    not divide ``checkpointing``;
  * a resume after a block continues the uninterrupted run bit for bit;
  * ``FusedNet``'s descriptor made once per layout and device, Adam state
    written with a device's rate tensor loading on the CPU, and the dropout
    generators' reseeding.

Everything runs eagerly here: the CPU is the plain version of the graphed
step (training/graphs.py), which only a card captures."""

import os
import pathlib

import jax
import numpy as np
import pytest
import torch

from sdf_representation_tpu.training import Trainer as JaxTrainer
from sdf_representation_tpu_torch.configgen import Configuration
from sdf_representation_tpu_torch.convert import params_from_jax
from sdf_representation_tpu_torch.models import ImplicitNet
from sdf_representation_tpu_torch.ops.fused_mlp import FusedNet
from sdf_representation_tpu_torch.training import Trainer
from sdf_representation_tpu_torch.training import checkpoint as ckpt
from sdf_representation_tpu_torch.training import graphs
from tests.test_trainer import sphere_dataset, tiny_config

torch.set_num_threads(2)


def _port(tmp_path, epochs_per_call=1, loss=None, jax_weights=False, **overrides):
    """A port Trainer on tiny_config's ini (the JAX test's config) on the CPU."""
    tmp_path.mkdir(parents=True, exist_ok=True)
    jcfg = tiny_config(tmp_path, **overrides)
    cfg = Configuration(str(tmp_path / "c.ini"))
    cfg.epochs_per_call = epochs_per_call
    if loss is not None:
        cfg.make_loss = lambda: loss
    trainer = Trainer(cfg, device="cpu")
    if jax_weights:  # the JAX trainer's init (PRNGKey(init_seed = 0))
        params = jax.tree_util.tree_map(np.asarray, JaxTrainer(jcfg).model.init(jax.random.PRNGKey(0)))
        trainer.model.load_state_dict(params_from_jax(params))
    return trainer


def _jax(tmp_path, epochs_per_call=1, loss=None, **overrides):
    tmp_path.mkdir(parents=True, exist_ok=True)
    cfg = tiny_config(tmp_path, **overrides)
    cfg.epochs_per_call = epochs_per_call
    trainer = JaxTrainer(cfg)
    if loss is not None:
        trainer.loss = loss
    return trainer


def _assert_states_equal(a, b):
    """Two checkpoints' model, aux and optimizer state, bit for bit."""
    assert a["model"].keys() == b["model"].keys()
    for key in a["model"]:
        assert torch.equal(a["model"][key], b["model"][key]), key
    assert a["optimizer"]["param_groups"] == b["optimizer"]["param_groups"]
    assert a["optimizer"]["state"].keys() == b["optimizer"]["state"].keys()
    for i, st in a["optimizer"]["state"].items():
        for name, value in st.items():
            assert torch.equal(value, b["optimizer"]["state"][i][name]), (i, name)


class _TrapLoss:
    """Validation minimal at epoch 3 by construction (tests/test_multi_epoch.py's
    _EpochTrapLoss): the |epoch - 3| shift has no parameter gradient."""

    def __call__(self, model, x, y, epoch, generator=None, aux=None):
        pred = model(x).reshape(x.shape[0])
        shift = torch.abs(torch.as_tensor(epoch, dtype=torch.float32, device=x.device) - 3.0)
        return torch.mean((pred - y[:, 0]) ** 2) + shift


class _JaxTrapLoss:
    def __call__(self, params, apply_fn, x, y, epoch, rng=None, aux=None):
        import jax.numpy as jnp

        pred = apply_fn(params, x).reshape(x.shape[0])
        return jnp.mean((pred - y[:, 0]) ** 2) + jnp.abs(jnp.asarray(epoch, jnp.float32) - 3.0)


class _ScheduleLoss:
    """Validation follows ``offsets`` by epoch at lr = 0 (the JAX test's)."""

    def __init__(self, offsets):
        self.offsets = offsets

    def __call__(self, model, x, y, epoch, generator=None, aux=None):
        pred = model(x).reshape(x.shape[0])
        e = min(max(int(epoch), 0), len(self.offsets) - 1)
        return torch.mean((pred - y[:, 0]) ** 2) * 0.0 + torch.tensor(self.offsets[e])


class _JaxScheduleLoss:
    def __init__(self, offsets):
        self.offsets = offsets

    def __call__(self, params, apply_fn, x, y, epoch, rng=None, aux=None):
        import jax.numpy as jnp

        pred = apply_fn(params, x).reshape(x.shape[0])
        e = jnp.clip(jnp.asarray(epoch, jnp.int32), 0, len(self.offsets) - 1)
        return jnp.mean((pred - y[:, 0]) ** 2) * 0.0 + jnp.take(jnp.asarray(self.offsets, jnp.float32), e)


@pytest.mark.parametrize("k", [4, 8, 12])
def test_blocks_give_per_epoch_training_bit_for_bit(tmp_path, k):
    ds = sphere_dataset()
    one = _port(tmp_path / "k1", epochs=12, checkpointing=4)
    ref = one.train(ds)
    blocks = _port(tmp_path / f"k{k}", epochs_per_call=k, epochs=12, checkpointing=4)
    got = blocks.train(ds)
    assert got["epochs_run"] == 12 and got["last_epoch"] == 11
    assert got["train_losses"] == ref["train_losses"]
    assert got["val_losses"] == ref["val_losses"] and got["best_val"] == ref["best_val"]
    for key, value in one.model.state_dict().items():
        assert torch.equal(blocks.model.state_dict()[key], value), key
    # model_epoch11.ckpt: the last epoch's parameters and Adam state, whatever the block
    want = ckpt.load_checkpoint(os.path.join(one.model_save_path, "model_epoch11.ckpt"))
    have = ckpt.load_checkpoint(os.path.join(blocks.model_save_path, "model_epoch11.ckpt"))
    _assert_states_equal(have, want)
    assert have["optimizer"]["state"][0]["step"].item() == 12 * 7  # 3600 points, batch 512
    best = [ckpt.load_checkpoint(os.path.join(t.model_save_path, "best_model.ckpt"))
            for t in (one, blocks)]
    assert best[1]["epoch"] == best[0]["epoch"]
    _assert_states_equal(best[1], best[0])
    log = (pathlib.Path(blocks.train_path) / "train_loss.txt").read_text().splitlines()
    assert log == (pathlib.Path(one.train_path) / "train_loss.txt").read_text().splitlines()


def test_early_stop_inside_a_block_matches_jax(tmp_path):
    ds = sphere_dataset(2000)
    overrides = dict(epochs=100, patience=3, min_epochs=1, lr=0.0)
    jt = _jax(tmp_path / "jax", 5, **overrides)
    want = jt.train(dataset=ds)
    port = _port(tmp_path / "port", 5, jax_weights=True, **overrides)
    got = port.train(ds)
    assert got["epochs_run"] == want["epochs_run"] <= 15
    assert got["last_epoch"] == want["last_epoch"]
    np.testing.assert_allclose(got["val_losses"], want["val_losses"], rtol=1e-5)
    # lr = 0: every epoch validates the same weights
    assert len(set(got["val_losses"])) == 1
    assert sorted(os.listdir(port.model_save_path)) == sorted(os.listdir(jt.model_save_path))


def test_device_best_after_an_early_stop_is_adopted_as_in_jax(tmp_path):
    # block 1 (epochs 0-3) improves; block 2 (4-7) is worse at 4 and 5, the
    # stop fires at 5 (patience 2), and epoch 6 (0.6) beats the best
    offsets = [1.0, 0.9, 0.8, 0.7, 0.9, 0.95, 0.6, 0.65]
    ds = sphere_dataset(2000)
    overrides = dict(epochs=8, patience=2, min_epochs=1, lr=0.0)
    jt = _jax(tmp_path / "jax", 4, _JaxScheduleLoss(offsets), **overrides)
    want = jt.train(dataset=ds)
    port = _port(tmp_path / "port", 4, _ScheduleLoss(offsets), **overrides)
    got = port.train(ds)
    assert got["last_epoch"] == want["last_epoch"] == 5
    assert jt.load_model(best=True)[1] == port.load_model(best=True)[1] == 6
    state = ckpt.load_checkpoint(os.path.join(port.model_save_path, "best_model.ckpt"))
    assert state["epoch"] == 6 and len(state["val_losses"]) == len(state["train_losses"]) == 7
    np.testing.assert_allclose(state["val_losses"], offsets[:7], rtol=1e-6)
    assert state["best_val"] == pytest.approx(0.6, rel=1e-6) and got["best_val"] == state["best_val"]


def test_best_checkpoint_in_mid_block_is_the_best_epochs_state(tmp_path):
    ds = sphere_dataset()
    jt = _jax(tmp_path / "jax", 10, _JaxTrapLoss(), epochs=10)
    assert int(np.argmin(jt.train(dataset=ds)["val_losses"])) == 3
    assert jt.load_model(best=True)[1] == 3

    port = _port(tmp_path / "k10", 10, _TrapLoss(), epochs=10)
    res = port.train(ds)
    assert int(np.argmin(res["val_losses"])) == 3
    state = ckpt.load_checkpoint(os.path.join(port.model_save_path, "best_model.ckpt"))
    assert state["epoch"] == 3 and len(state["val_losses"]) == 10
    # per-epoch training to epoch 3 gives the epoch-3 state (the schedule
    # does not depend on the block)
    short = _port(tmp_path / "k1", 1, _TrapLoss(), epochs=4)
    short.train(ds)
    ref = ckpt.load_checkpoint(os.path.join(short.model_save_path, "best_model.ckpt"))
    assert ref["epoch"] == 3
    _assert_states_equal(state, ref)
    # the block-end parameters (epoch 9) are not the checkpoint's
    assert any(not torch.equal(v, state["model"][k]) for k, v in port.model.state_dict().items())


@pytest.mark.parametrize("k", [3, 6])
def test_epoch_checkpoint_names_follow_jax(tmp_path, k):
    ds = sphere_dataset(2000)
    overrides = dict(epochs=10, checkpointing=4)
    jt = _jax(tmp_path / "jax", k, **overrides)
    jt.train(dataset=ds)
    port = _port(tmp_path / "port", k, **overrides)
    port.train(ds)
    names = sorted(os.listdir(port.model_save_path))
    assert names == sorted(os.listdir(jt.model_save_path))
    assert names == {3: ["best_model.ckpt", "model_epoch5.ckpt", "model_epoch8.ckpt"],
                     6: ["best_model.ckpt", "model_epoch5.ckpt", "model_epoch9.ckpt"]}[k]


def test_resume_after_a_block_continues_the_run(tmp_path):
    ds = sphere_dataset()
    whole = _port(tmp_path / "whole", 4, epochs=12)
    ref = whole.train(ds)
    first = _port(tmp_path / "resume", 4, epochs=12)
    first.config.epochs = 8  # the run directory names 12 epochs; stop after two blocks
    part = first.train(ds)
    assert part["val_losses"] == ref["val_losses"][:8]
    # the best epoch of the first 8 is the last, so the resume starts at 8
    assert int(np.argmin(part["val_losses"])) == 7
    again = _port(tmp_path / "resume", 4, epochs=12, **{"continue": "True"})
    got = again.train(ds)
    assert got["epochs_run"] == 4
    assert got["train_losses"] == ref["train_losses"] and got["val_losses"] == ref["val_losses"]
    for key, value in whole.model.state_dict().items():
        assert torch.equal(again.model.state_dict()[key], value), key


def test_fused_net_descriptor_is_made_once_per_layout_and_device():
    def net(depth, seed):
        return ImplicitNet(hidden_dims=(64,) * depth, skip_in=(2,), beta=100.0,
                           generator=torch.Generator().manual_seed(seed))

    a, b, c = (FusedNet(net(d, s)) for d, s in ((3, 0), (3, 1), (5, 0)))
    assert a.packed[2] is b.packed[2] and a.packed[2] is not c.packed[2]
    for n in (a, c):
        assert torch.equal(n.packed[2], torch.tensor(n.layout, dtype=torch.int64))
        assert n.packed[2].device == n.device
    # a net of the same layout from bfloat16 layers (the mixed step's copies)
    layers = [(w.to(torch.bfloat16), bias.to(torch.bfloat16)) for w, bias in net(3, 2).effective_layers()]
    assert FusedNet(net(3, 2), layers=layers).packed[2] is a.packed[2]


def test_card_optimizer_state_loads_on_the_cpu():
    """Adam state as a card writes it (capturable, the rate a tensor, each
    step a float32 tensor) loads into the CPU's Adam with a float rate and
    steps on the host; the CPU's own state loads back unchanged."""
    torch.manual_seed(0)
    params = [torch.nn.Parameter(torch.randn(4, 3)), torch.nn.Parameter(torch.randn(3))]
    card = torch.optim.Adam(params, lr=torch.tensor(0.25), foreach=False)
    for p in params:
        p.grad = torch.ones_like(p)
    card.step()
    saved = card.state_dict()
    saved["param_groups"][0]["capturable"] = True  # as graphs.make_adam sets it on a card
    cpu = graphs.make_adam([torch.nn.Parameter(p.detach().clone()) for p in params], 1e-3, "cpu")
    graphs.load_optimizer_state(cpu, saved)
    group = cpu.param_groups[0]
    assert group["lr"] == 0.25 and isinstance(group["lr"], float) and group["capturable"] is False
    for i, p in enumerate(group["params"]):
        st = cpu.state[p]
        assert st["step"].device.type == "cpu" and st["step"].dtype == torch.float32
        assert torch.equal(st["exp_avg"], card.state[params[i]]["exp_avg"])
    for p in group["params"]:
        p.grad = torch.ones_like(p)
    cpu.step()  # steps as a CPU Adam
    assert cpu.state[group["params"][0]]["step"].item() == 2


def test_dropout_masks_reseed_every_call_of_a_step():
    masks = graphs.DropoutMasks("cpu")
    assert masks.next() is None  # no seed: no dropout
    masks.reseed(5)
    draws = [torch.rand(4, generator=masks.next()) for _ in range(3)]
    assert all(torch.equal(d, draws[0]) for d in draws) and len(masks.pool) == 3
    masks.reseed(6)
    other = [torch.rand(4, generator=masks.next()) for _ in range(3)]
    assert len(masks.pool) == 3 and not torch.equal(other[0], draws[0])
    masks.reseed(5)
    assert torch.equal(torch.rand(4, generator=masks.next()), draws[0])
