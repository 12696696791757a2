"""The sharded device-resident epoch on the CPU: the capture rule of
training/graphs.py, and the sharded trainers' ``epochs_per_call`` blocks
against the JAX trainers under their sharded meshes.

  * ``graphs.captures``: a card alone, a mesh of one card listed 4 times and
    a process group over NCCL capture; a mesh of distinct cards, a gloo
    group, ``debug_nans`` and the CPU run eagerly and print why (devices
    named by index: no card is needed to decide);
  * ``Trainer(mesh=("cpu",) * 2)`` with ``epochs_per_call = 3``
    (WeightedSmoothL2Loss, 7 epochs: blocks of 3, 3, 1) against the JAX ``Trainer`` with
    ``get_mesh(2)`` on the conftest's virtual CPU devices, from the JAX
    weights (``convert.params_from_jax``): per-epoch training and
    validation losses within rtol 1e-5 (tests/test_torch_multihost.py's
    tolerance), parameters within rtol 1e-4 / atol 1e-6, the best epoch and
    the checkpoint names equal;
  * ``PointCloudTrainer(mesh=("cpu",) * 4)`` the same against the JAX
    point-cloud trainer on ``get_mesh(4)``;
  * two gloo ranks (this file run as a script, one process each; no JAX)
    through the same labelled run on the group's data axis: bit-equal to
    each other, the JAX run's losses, parameters, best epoch and checkpoint
    names within the same limits, and each prints its eager line;
  * the eager path of ``graphs.StepRunner`` under ``("cpu",) * 2`` is a
    plain call of ``make_train_step``, bit for bit.

``jax.random`` streams are not reproduced by the port (ROADMAP §3), so the
trainer runs pin the draws in both packages: every permutation is the
identity (each epoch's batches are the data in order, each point-cloud
subsample its batch's first third) and the point-cloud noise is zero."""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from sdf_representation_tpu_torch.configgen import Configuration
from sdf_representation_tpu_torch.data.dataset import SDFDataset
from sdf_representation_tpu_torch.losses.losses import IGRLOSS, IGRLOSSPCD
from sdf_representation_tpu_torch.models import ImplicitNet
from sdf_representation_tpu_torch.parallel import multihost
from sdf_representation_tpu_torch.parallel.mesh import ProcessMesh, process_mesh
from sdf_representation_tpu_torch.training import PointCloudTrainer, Trainer, graphs
from sdf_representation_tpu_torch.training.trainer import make_train_step

torch.set_num_threads(2)
REPO = pathlib.Path(__file__).resolve().parent.parent
CARD0, CARD1 = torch.device("cuda", 0), torch.device("cuda", 1)
RANK_TIMEOUT = 120  # seconds for both ranks
# the labelled run: configs/mesh_sdf.ini's loss on a 2x32 softplus net, 7
# epochs in blocks of 3; 3,600 training rows in batches of 512 (7 steps), one
# validation batch of 400. Not IGRLOSS: its parameter gradients differ from
# JAX's within rtol 2e-4 (tests/test_torch_igr_losses.py), which 49 Adam steps
# carry past the losses' 1e-5 whether or not the step is sharded
LABELLED = dict(hidden_dim=32, num_hidden_layers=2, beta=100,
                loss_function="WeightedSmoothL2Loss", epochs=7, checkpointing=4, batch_size=512,
                lr=0.003)
EPOCHS_PER_CALL = 3
# the point-cloud run: 1,200 points of the sphere in batches of 300, 4 epochs
POINT_CLOUD = dict(hidden_dim=32, num_hidden_layers=2, beta=100, epochs=4, checkpointing=2,
                   batch_size=300, lr=0.003)


# ---------------------------------------------------------------------------
# the capture rule
# ---------------------------------------------------------------------------

RULE = {  # (device, mesh, backend, debug_nans) -> captured, or the word its line names
    "one_card": ((CARD0, None, None, False), True),
    "one_card_listed_4_times": ((CARD0, (CARD0,) * 4, None, False), True),
    "distinct_cards": ((CARD0, (CARD0, CARD1), None, False), "distinct cards"),
    "nccl_group": ((CARD0, ProcessMesh(CARD0, 0, 2), "nccl", False), True),
    "gloo_group": ((CARD0, ProcessMesh(CARD0, 0, 2), "gloo", False), "gloo"),
    "debug_nans": ((CARD0, None, None, True), "debug_nans"),
    "cpu": ((torch.device("cpu"), ("cpu",) * 2, None, False), "CPU"),
}


@pytest.mark.parametrize("case", RULE)
def test_capture_rule(case, capsys):
    args, want = RULE[case]
    assert graphs.captures(*args, eager=False) is (want is True)
    out = capsys.readouterr().out
    if want is True:
        assert out == ""
    else:
        assert out.count("\n") == 1 and out.startswith("training steps run eagerly: ")
        assert want in out
    # the caller's eager=True: no capture, and nothing to say
    assert graphs.captures(*args, eager=True) is False
    assert capsys.readouterr().out == ""


# ---------------------------------------------------------------------------
# the draws of both packages pinned
# ---------------------------------------------------------------------------

class _Delegate:
    """``real`` with the attributes ``over`` replaced."""

    def __init__(self, real, **over):
        self._real, self._over = real, over

    def __getattr__(self, name):
        return self._over[name] if name in self._over else getattr(self._real, name)


def _pin_jax(monkeypatch, module):
    """The ``jax`` of one JAX training module with its permutations the
    identity and its normal draws zero."""
    import jax
    import jax.numpy as jnp

    random = _Delegate(jax.random, permutation=lambda key, n: jnp.arange(n),
                       normal=lambda key, shape=(), dtype=jnp.float32: jnp.zeros(shape, dtype))
    monkeypatch.setattr(module, "jax", _Delegate(jax, random=random))


def _pin_torch(monkeypatch):
    """The port's draws pinned as _pin_jax pins JAX's."""
    monkeypatch.setattr(torch, "randperm",
                        lambda n, generator=None, device=None, **kw: torch.arange(n, device=device))
    monkeypatch.setattr(torch, "randn",
                        lambda size, generator=None, dtype=None, device=None, **kw:
                        torch.zeros(size, dtype=dtype, device=device))


# ---------------------------------------------------------------------------
# configs and the JAX runs
# ---------------------------------------------------------------------------

def _config(root, **overrides):
    """tests/test_trainer.py's tiny_config written under ``root``: (the
    JAX package's Configuration, the port's)."""
    from tests.test_trainer import tiny_config

    root.mkdir(parents=True, exist_ok=True)
    jcfg = tiny_config(root, **overrides)
    jcfg.epochs_per_call = EPOCHS_PER_CALL
    cfg = Configuration(str(root / "c.ini"))
    cfg.epochs_per_call = EPOCHS_PER_CALL
    return jcfg, cfg


def _cloud(n=1200, seed=0):
    d = np.random.default_rng(seed).normal(size=(n, 3))
    return (0.5 * d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)


def _jax_init(jax_trainer):
    import jax

    from sdf_representation_tpu_torch.convert import params_from_jax

    params = jax_trainer.model.init(jax.random.PRNGKey(0))  # the trainers' init_seed 0
    return params_from_jax(jax.tree_util.tree_map(np.asarray, params))


def _jax_weights(params):
    import jax

    from sdf_representation_tpu_torch.convert import params_from_jax

    return params_from_jax(jax.tree_util.tree_map(np.asarray, params))


@pytest.fixture(scope="module")
def jax_labelled(tmp_path_factory):
    """The JAX Trainer's labelled run under get_mesh(2), its draws pinned:
    losses, final weights, best epoch, checkpoint names; and its init."""
    from sdf_representation_tpu.parallel.mesh import get_mesh
    from sdf_representation_tpu.training import Trainer as JaxTrainer
    from sdf_representation_tpu.training import trainer as jax_trainer_module
    from tests.test_trainer import sphere_dataset

    jcfg, _ = _config(tmp_path_factory.mktemp("jax_labelled"), **LABELLED)
    trainer = JaxTrainer(jcfg, mesh=get_mesh(2))
    with pytest.MonkeyPatch.context() as mp:
        _pin_jax(mp, jax_trainer_module)
        result = trainer.train(dataset=sphere_dataset())
    return {"train_losses": result["train_losses"], "val_losses": result["val_losses"],
            "params": _jax_weights(result["trainable"]["params"]),
            "best_epoch": trainer.load_model(best=True)[1],
            "names": sorted(os.listdir(trainer.model_save_path)), "init": _jax_init(trainer)}


def _close(got, want, what):
    for name, value in got.items():
        np.testing.assert_allclose(value.numpy(), want[name].numpy(), rtol=1e-4, atol=1e-6,
                                   err_msg=f"{what}: {name}")


def _assert_labelled_run(got, want):
    np.testing.assert_allclose(got["train_losses"], want["train_losses"], rtol=1e-5)
    np.testing.assert_allclose(got["val_losses"], want["val_losses"], rtol=1e-5)
    _close(got["params"], want["params"], "parameters")
    assert got["best_epoch"] == want["best_epoch"]
    assert got["names"] == want["names"]


def _port_labelled(trainer, init, dataset):
    """The port trainer's labelled run from ``init``: what jax_labelled holds."""
    trainer.model.load_state_dict(init)
    result = trainer.train(dataset)
    params = {k: v.detach().clone() for k, v in trainer.model.state_dict().items()}
    return {"train_losses": result["train_losses"], "val_losses": result["val_losses"],
            "params": params, "best_epoch": trainer.load_model(best=True)[1],
            "names": sorted(os.listdir(trainer.model_save_path))}


# ---------------------------------------------------------------------------
# the sharded trainers against the JAX ones
# ---------------------------------------------------------------------------

def test_mesh_trainer_block_matches_the_jax_sharded_trainer(tmp_path, jax_labelled, monkeypatch,
                                                            capsys):
    from tests.test_trainer import sphere_dataset

    _, cfg = _config(tmp_path, **LABELLED)
    trainer = Trainer(cfg, device="cpu", mesh=("cpu",) * 2)
    _pin_torch(monkeypatch)
    got = _port_labelled(trainer, jax_labelled["init"], sphere_dataset())
    assert "training steps run eagerly: the CPU" in capsys.readouterr().out
    assert len(got["train_losses"]) == 7 and got["train_losses"][-1] < got["train_losses"][0]
    _assert_labelled_run(got, jax_labelled)


def test_mesh_point_cloud_trainer_matches_the_jax_sharded_trainer(tmp_path, monkeypatch):
    from sdf_representation_tpu.parallel.mesh import get_mesh
    from sdf_representation_tpu.training import pcd_trainer as jax_pcd_module

    cloud = _cloud()
    jcfg, _ = _config(tmp_path / "jax", **POINT_CLOUD)
    jt = jax_pcd_module.PointCloudTrainer(jcfg, mesh=get_mesh(4))
    with monkeypatch.context() as mp:
        _pin_jax(mp, jax_pcd_module)
        want = jt.train(cloud)
    _, cfg = _config(tmp_path / "port", **POINT_CLOUD)
    port = PointCloudTrainer(cfg, device="cpu", mesh=("cpu",) * 4)
    port.model.load_state_dict(_jax_init(jt))
    _pin_torch(monkeypatch)
    got = port.train(cloud)
    assert got["losses"][-1] < got["losses"][0]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
    _close({k: v.detach() for k, v in port.model.state_dict().items()}, _jax_weights(want["params"]),
           "parameters")
    assert port.load_model(best=True)[1] == jt.load_model(best=True)[1]
    assert sorted(os.listdir(port.model_save_path)) == sorted(os.listdir(jt.model_save_path))


# ---------------------------------------------------------------------------
# two gloo ranks
# ---------------------------------------------------------------------------

def _rank_main(rank: int, spec_path: str) -> None:
    """One rank: the labelled run on the group's data axis, its draws
    pinned; the result to <out>/rank<r>.pt."""
    spec = json.loads(pathlib.Path(spec_path).read_text())
    torch.set_num_threads(1)
    multihost.initialize_multihost(f"file://{spec['init_file']}", 2, rank, device="cpu")
    inputs = torch.load(spec["inputs"], weights_only=False)
    cfg = Configuration(spec["config"])
    cfg.epochs_per_call = EPOCHS_PER_CALL
    trainer = Trainer(cfg, mesh=process_mesh())
    with pytest.MonkeyPatch.context() as mp:
        _pin_torch(mp)
        out = _port_labelled(trainer, inputs["init"], inputs["dataset"])
    out["jax_imported"] = "jax" in sys.modules
    torch.save(out, pathlib.Path(spec["out"]) / f"rank{rank}.pt")
    torch.distributed.destroy_process_group()


def test_two_gloo_ranks_run_the_block_as_the_jax_sharded_trainer(tmp_path, jax_labelled):
    from tests.test_trainer import sphere_dataset

    _, cfg = _config(tmp_path / "run", **LABELLED)
    ds = sphere_dataset()  # the JAX package's type: the ranks get the port's
    torch.save({"init": jax_labelled["init"],
                "dataset": SDFDataset(ds.train_x, ds.train_y, ds.val_x, ds.val_y)},
               tmp_path / "inputs.pt")
    spec = {"init_file": str(tmp_path / "rendezvous"), "inputs": str(tmp_path / "inputs.pt"),
            "out": str(tmp_path), "config": str(tmp_path / "run" / "c.ini")}
    (tmp_path / "spec.json").write_text(json.dumps(spec))
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    env.pop("JAX_PLATFORMS", None)
    logs = [open(tmp_path / f"rank{r}.log", "w") for r in range(2)]
    procs = [subprocess.Popen([sys.executable, __file__, str(r), str(tmp_path / "spec.json")],
                              cwd=str(tmp_path), env=env, stdout=logs[r], stderr=subprocess.STDOUT)
             for r in range(2)]
    try:
        for p in procs:
            p.wait(timeout=RANK_TIMEOUT)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    texts = [(tmp_path / f"rank{r}.log").read_text() for r in range(2)]
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{texts[r][-4000:]}"
        # the CPU's line: a gloo group of cards would print its own (test_capture_rule)
        assert "training steps run eagerly: the CPU" in texts[r]
    got = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(2)]
    assert not got[0]["jax_imported"] and not got[1]["jax_imported"]
    assert got[0]["train_losses"] == got[1]["train_losses"]
    assert got[0]["val_losses"] == got[1]["val_losses"]
    for name, value in got[0]["params"].items():
        assert torch.equal(value, got[1]["params"][name]), name
    _assert_labelled_run(got[0], jax_labelled)


# ---------------------------------------------------------------------------
# StepRunner's eager path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("loss_cls", [IGRLOSS, IGRLOSSPCD])
def test_step_runner_eager_path_is_a_plain_sharded_step(loss_cls):
    """IGRLOSSPCD draws its points from the step's generator: the runner's
    seed must reach it as the plain call's generator does."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.uniform(-1, 1, (1024, 3)).astype(np.float32))
    r = x.norm(dim=1, keepdim=True)
    y = torch.cat([r - 0.5, x / r], dim=1)
    rows = torch.from_numpy(rng.permutation(1024)[:768].reshape(3, 256))
    models = [ImplicitNet(hidden_dims=(32,) * 3, skip_in=(2,), beta=100.0,
                          generator=torch.Generator().manual_seed(0)) for _ in range(2)]
    steps = [make_train_step(m, loss_cls(), graphs.make_adam(m.parameters(), 3e-3, "cpu"),
                             mesh=("cpu",) * 2) for m in models]
    runner = graphs.StepRunner(lambda idx, epoch, gen: steps[0].body(x[idx], y[idx], epoch, gen),
                               "cpu", steps[0].masks)
    for i in range(3):
        seed = 1000 + i
        got = runner(rows[i], 0, seed)
        want = steps[1](x[rows[i]], y[rows[i]], 0, torch.Generator().manual_seed(seed))
        assert torch.equal(got, want), i
    for (name, a), b in zip(models[0].state_dict().items(), models[1].state_dict().values()):
        assert torch.equal(a, b), name


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), sys.argv[2])
