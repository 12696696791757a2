"""One process per card: parallel/multihost.py and both trainers over a
process group, on the CPU with two real ranks over gloo (``file://``
rendezvous in the test's directory).

initialize_multihost, auto_initialize and host_shard are held against the
JAX package's with the process-group calls recorded. The ranks run this
file as a script (``_rank_main``) and import no JAX. From the same weights
and batches, two ranks x 3 steps (ImplicitNet 4x64, WeightedSmoothL2Loss;
the point-cloud loss with its draws given; ``PointCloudTrainer``'s own step)
must hold parameters bit-equal across the ranks, and match the JAX
package's sharded step on a 2-device CPU mesh and the port's in-process
``mesh=("cpu",) * 2`` at tests/test_torch_sharding.py's tolerances (loss
rel 1e-5; weights rtol 1e-4 / atol 1e-6). Three cases count a term that
every rank computes whole once (an odd batch, a one-row batch, a Lipschitz
model under GaussBonnetLoss with its learnable ``aux``): every step's
gradients, after the all-reduce, within rtol 1e-4 / atol 1e-7 of the
one-process step's. The command line under the group: only rank 0 writes,
the other ranks read after a barrier, and the loss history equals the
one-process run's (rel 1e-5)."""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from sdf_representation_tpu_torch import cli
from sdf_representation_tpu_torch.configgen import Configuration
from sdf_representation_tpu_torch.losses.losses import (GaussBonnetLoss, IGRLOSS,
                                                        WeightedSmoothL2Loss)
from sdf_representation_tpu_torch.models import ImplicitNet
from sdf_representation_tpu_torch.parallel import multihost
from sdf_representation_tpu_torch.parallel.mesh import (ProcessMesh, allreduce_grads,
                                                        process_mesh, rank_rows)
from sdf_representation_tpu_torch.sampling.sampler import Frame
from sdf_representation_tpu_torch.training import PointCloudTrainer, Trainer
from sdf_representation_tpu_torch.training.pcd_trainer import pcd_loss
from sdf_representation_tpu_torch.training.trainer import bind_apply, make_train_step

torch.set_num_threads(2)
REPO = pathlib.Path(__file__).resolve().parent.parent
RANKS = 2
STEPS = 3
RANK_TIMEOUT = 300  # seconds for both ranks: every case and both CLI runs

# the steps each case takes: (loss, batch rows, optimizer, lipschitz)
CASES = {"l2": (WeightedSmoothL2Loss, 256, "adam", False),
         "odd": (lambda: IGRLOSS(global_norm_quirk=1.0), 255, "sgd", False),
         "one_row": (IGRLOSS, 1, "sgd", False),
         "gauss_lip": (GaussBonnetLoss, 64, "sgd", True)}
REPLICATED = ("odd", "one_row", "gauss_lip")


def _net(lipschitz=False):
    return ImplicitNet(d_in=3, hidden_dims=(64,) * 4, skip_in=(2,), beta=100.0,
                       lipschitz=lipschitz, lipschitz_weight=0.05)


def _optimizer(kind, params):
    if kind == "adam":
        return torch.optim.Adam(params, lr=1e-3, betas=(0.9, 0.999), eps=1e-8)
    return torch.optim.SGD(params, lr=1e-2)


def _run_step_case(name, inputs, mesh):
    """STEPS steps of make_train_step from the case's weights on its
    batches: losses, the gradients after each step (after the all-reduce
    under a group), the final parameters."""
    loss_cls, _, opt_kind, lipschitz = CASES[name]
    model = _net(lipschitz)
    model.load_state_dict(inputs[name]["init"])
    loss = loss_cls()
    aux = ({"euler_characteristic": torch.nn.Parameter(torch.tensor(2.0))}
           if getattr(loss, "needs_aux", ()) else {})
    opt = _optimizer(opt_kind, [*model.parameters(), *aux.values()])
    step = make_train_step(model, loss, opt, aux=aux, mesh=mesh)
    losses, grads = [], []
    for i, (x, y) in enumerate(zip(inputs[name]["x"], inputs[name]["y"])):
        losses.append(step(x, y, 0, torch.Generator().manual_seed(100 + i)).item())
        grads.append({**{k: p.grad.clone() for k, p in model.named_parameters()},
                      **{k: p.grad.clone() for k, p in aux.items()}})
    params = {**{k: v.detach().clone() for k, v in model.named_parameters()},
              **{k: v.detach().clone() for k, v in aux.items()}}
    return {"losses": losses, "grads": grads, "params": params}


def _run_pcd_case(inputs, mesh):
    """STEPS point-cloud steps (PointCloudTrainer's loss) with the draws
    given, Adam as the trainer makes it."""
    model = _net()
    model.load_state_dict(inputs["pcd"]["init"])
    opt = _optimizer("adam", model.parameters())
    apply = bind_apply(model, mesh=mesh)
    losses = []
    for xb, idx, noise in zip(*(inputs["pcd"][k] for k in ("x", "idx", "noise"))):
        opt.zero_grad(set_to_none=True)
        value = pcd_loss(apply, model, xb, idx, noise, 0.1, mesh)
        value.backward()
        if isinstance(mesh, ProcessMesh):
            allreduce_grads(list(model.parameters()))
        opt.step()
        losses.append(value.item())
    return {"losses": losses, "params": {k: v.detach().clone() for k, v in model.named_parameters()}}


def _run_pcd_trainer_case(inputs, mesh):
    """STEPS steps of PointCloudTrainer's own step (its draws from the step
    generator) on the trainer's seeded model."""
    trainer = PointCloudTrainer(Configuration(inputs["pcd_trainer"]["config"]), device="cpu",
                                mesh=mesh)
    step = trainer._make_step(torch.optim.Adam(trainer.model.parameters(), lr=3e-3), 300)
    gen = torch.Generator()
    losses = []
    for i, xb in enumerate(inputs["pcd_trainer"]["x"]):
        gen.manual_seed(trainer._step_seed(0, i))
        losses.append(step(xb, gen).item())
    return {"losses": losses,
            "params": {k: v.detach().clone() for k, v in trainer.model.named_parameters()}}


def _run_case(name, inputs, mesh):
    if name == "pcd":
        return _run_pcd_case(inputs, mesh)
    if name == "pcd_trainer":
        return _run_pcd_trainer_case(inputs, mesh)
    return _run_step_case(name, inputs, mesh)


ALL_CASES = (*CASES, "pcd", "pcd_trainer")


def _rank_main(rank: int, spec_path: str) -> None:
    """One rank: every case over the group, the mesh_devices check, the
    command line twice (per-rank directories; a shared one with sampling,
    then resumed); results to <out>/rank<r>.pt."""
    spec = json.loads(pathlib.Path(spec_path).read_text())
    torch.set_num_threads(1)
    multihost.initialize_multihost(f"file://{spec['init_file']}", RANKS, rank, device="cpu")
    mesh = process_mesh()
    inputs = torch.load(spec["inputs"], weights_only=False)
    out = {"mesh": (str(mesh.device), mesh.rank, mesh.size)}
    for name in ALL_CASES:
        out[name] = _run_case(name, inputs, mesh)
    raised = []
    for kwargs in ({"mesh": mesh}, {"mesh": ("cpu",) * 2}):
        try:
            Trainer(Configuration(spec["mesh_devices_config"]), **kwargs)
        except ValueError as exc:
            raised.append(str(exc))
    out["mesh_devices_raised"] = raised
    cli.main([spec["cli_configs"][rank], "--device", "cpu"])
    for path in spec["shared_configs"]:
        cli.main([path, "--device", "cpu"])
    out["jax_imported"] = "jax" in sys.modules
    torch.save(out, pathlib.Path(spec["out"]) / f"rank{rank}.pt")


# ---------------------------------------------------------------------------
# configs and data
# ---------------------------------------------------------------------------

def _config(path, **changes):
    """tests/test_config.ini at 3x32 with ``changes`` by key (mesh_devices
    under [TPU]); written to ``path``."""
    root = path.parent
    text = (REPO / "tests/test_config.ini").read_text().replace("@DIR@", str(root))
    base = {"hidden_dim": 32, "num_hidden_layers": 3, "skip_connection": 2, "beta": 100,
            "geometric_init": True, "lr": 0.001, "epochs": 3, "min_epochs": 1,
            "batch_size": 256, "checkpointing": 2, "uniform_points": 0, "surface": 0,
            "narrowband": 0, "rescale": False}
    base.update(changes)
    tpu = {k: base.pop(k) for k in list(base) if k == "mesh_devices"}
    if base.get("loss_function") == "IGRLOSSPCD":
        text = text.replace("weight_factor = 0.5\n", "lambda_g = 0.1\n")
    for key, value in base.items():
        lines = [ln for ln in text.splitlines() if ln.startswith(f"{key} = ")]
        text = text.replace(lines[0], f"{key} = {value}")
    if tpu:
        text += "\n[TPU]\n" + "".join(f"{k} = {v}\n" for k, v in tpu.items())
    root.mkdir(parents=True, exist_ok=True)
    path.write_text(text)
    return str(path)


def _write_labels(config_path, n=1500):
    """Labelled CSVs in the run's data directory, and nothing else."""
    trainer = Trainer(Configuration(config_path), device="cpu")
    os.remove(pathlib.Path(trainer.data_path) / "info.txt")
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (n, 3))
    r = np.linalg.norm(x, axis=1, keepdims=True)
    values = np.concatenate([x, r - 0.5, x / r], axis=1)
    for name, part in zip(("uniform", "surface", "narrow"), np.array_split(values, 3)):
        Frame(("x", "y", "z", "S", "nx", "ny", "nz"), part).to_csv(
            str(pathlib.Path(trainer.data_path) / f"{name}.csv"))
    return trainer


def _sphere_batch(rng, n):
    x = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    r = np.linalg.norm(x, axis=1, keepdims=True)
    return x, np.concatenate([r - 0.5, x / r], axis=1).astype(np.float32)


def _make_inputs(tmp):
    """Weights from the JAX package's init (converted), batches and draws
    from numpy; the point-cloud trainer's config and cloud."""
    import jax

    from sdf_representation_tpu.models import ImplicitNet as JaxImplicitNet
    from sdf_representation_tpu_torch.convert import params_from_jax

    rng = np.random.default_rng(0)
    inputs, jax_params = {}, {}
    for seed, name in enumerate(("l2", "pcd", "odd", "one_row", "gauss_lip")):
        if name == "gauss_lip":
            init = _net(True).state_dict()
        else:
            jm = JaxImplicitNet(d_in=3, hidden_dims=(64,) * 4, skip_in=(2,), beta=100.0)
            jax_params[name] = jm.init(jax.random.PRNGKey(seed))
            init = params_from_jax(jax.tree_util.tree_map(np.asarray, jax_params[name]))
        inputs[name] = {"init": init}
    for name, (_, rows, _, _) in CASES.items():
        xs, ys = zip(*(_sphere_batch(rng, rows) for _ in range(STEPS)))
        inputs[name].update(x=[torch.from_numpy(x) for x in xs], y=[torch.from_numpy(y) for y in ys])
    cloud = rng.normal(size=(STEPS, 300, 3))
    cloud = (0.5 * cloud / np.linalg.norm(cloud, axis=-1, keepdims=True)).astype(np.float32)
    inputs["pcd"].update(
        x=[torch.from_numpy(c) for c in cloud],
        idx=[torch.from_numpy(rng.permutation(300)[:100]) for _ in range(STEPS)],
        noise=[torch.from_numpy((1e-4 * rng.normal(size=(100, 3))).astype(np.float32))
               for _ in range(STEPS)])
    pcd_cfg = _config(tmp / "pcd" / "config.ini", geometry=f"{tmp}/pcd/cloud", name="sphere_pcd",
                      loss_function="IGRLOSSPCD", distributed=True, batch_size=300, lr=0.003)
    inputs["pcd_trainer"] = {"config": pcd_cfg, "x": [torch.from_numpy(c) for c in cloud]}
    return inputs, jax_params


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both ranks' results, the one-process references and the paths the
    command-line runs used."""
    tmp = tmp_path_factory.mktemp("multihost")
    inputs, jax_params = _make_inputs(tmp)
    torch.save(inputs, tmp / "inputs.pt")
    cli_configs = [_config(tmp / f"cli_rank{r}" / "config.ini") for r in range(RANKS)]
    for path in cli_configs:
        _write_labels(path)
    single = _config(tmp / "cli_single" / "config.ini")
    _write_labels(single)
    from sdf_representation_tpu_torch.geometry.mesh_io import save_mesh
    from sdf_representation_tpu_torch.geometry.primitives import make_icosphere

    (tmp / "shared").mkdir()
    save_mesh(make_icosphere(2, radius=0.5), str(tmp / "shared" / "sphere.stl"))
    config = _config(tmp / "shared" / "config.ini", uniform_points=600, surface=2, narrowband=2,
                     rescale=True, epochs=2)
    resume = tmp / "shared" / "resume.ini"
    resume.write_text(pathlib.Path(config).read_text().replace("continue = False",
                                                               "continue = True"))
    shared_configs = [config, str(resume)]
    spec = {"init_file": str(tmp / "rendezvous"), "inputs": str(tmp / "inputs.pt"),
            "out": str(tmp), "cli_configs": cli_configs, "shared_configs": shared_configs,
            "mesh_devices_config": _config(tmp / "md" / "config.ini", mesh_devices=4)}
    (tmp / "spec.json").write_text(json.dumps(spec))
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    env.pop("JAX_PLATFORMS", None)
    logs = [open(tmp / f"rank{r}.log", "w") for r in range(RANKS)]
    procs = [subprocess.Popen([sys.executable, __file__, str(r), str(tmp / "spec.json")],
                              cwd=str(tmp), env=env, stdout=logs[r], stderr=subprocess.STDOUT)
             for r in range(RANKS)]
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
    texts = [(tmp / f"rank{r}.log").read_text() for r in range(RANKS)]
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{texts[r][-4000:]}"
    out = [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(RANKS)]
    return {"tmp": tmp, "inputs": inputs, "jax_params": jax_params, "out": out, "logs": texts,
            "cli_configs": cli_configs, "single_config": single, "shared_configs": shared_configs}


# ---------------------------------------------------------------------------
# initialize_multihost, auto_initialize, host_shard against JAX
# ---------------------------------------------------------------------------

ENV_NAMES = ("JAX_COORDINATOR", "NPROC", "PROC_ID", "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE",
             "RANK", "LOCAL_RANK", "TPU_WORKER_HOSTNAMES")


def _record_both(monkeypatch, fail=None):
    """Patch jax.distributed.initialize and torch's init_process_group to
    record their kwargs (or raise ``fail``)."""
    import jax

    calls = {"jax": [], "torch": []}

    def recorder(key):
        def record(*args, **kwargs):
            if fail is not None:
                raise fail
            calls[key].append((args, kwargs))
        return record

    monkeypatch.setattr(jax.distributed, "initialize", recorder("jax"))
    monkeypatch.setattr(multihost.dist, "init_process_group", recorder("torch"))
    monkeypatch.setattr(multihost, "LOCAL_DEVICE", None)
    for name in ENV_NAMES:
        monkeypatch.delenv(name, raising=False)
    return calls


@pytest.mark.parametrize("case", ["arguments", "environment", "arguments_over_environment",
                                  "process_id_0"])
def test_initialize_multihost_reads_what_jax_reads(monkeypatch, case):
    from sdf_representation_tpu.parallel import multihost as jax_multihost

    calls = _record_both(monkeypatch)
    args = {}
    if case != "arguments":
        monkeypatch.setenv("JAX_COORDINATOR", "envhost:1111")
        monkeypatch.setenv("NPROC", "4")
        monkeypatch.setenv("PROC_ID", "3")
    if case in ("arguments", "arguments_over_environment"):
        args = dict(coordinator_address="arghost:2222", num_processes=8, process_id=5)
    if case == "process_id_0":
        args = dict(process_id=0)
    jax_multihost.initialize_multihost(**args)
    multihost.initialize_multihost(**args, device="cpu")
    (_, want), = calls["jax"]
    (got_args, got), = calls["torch"]
    assert got_args == ("gloo",)
    assert got == {"init_method": "tcp://" + want["coordinator_address"],
                   "world_size": want["num_processes"], "rank": want["process_id"]}
    if case == "process_id_0":
        assert got["rank"] == 0


def test_initialize_multihost_reads_a_launchers_environment(monkeypatch):
    calls = _record_both(monkeypatch)
    for name, value in (("MASTER_ADDR", "node0"), ("MASTER_PORT", "29500"), ("WORLD_SIZE", "2"),
                        ("RANK", "1"), ("LOCAL_RANK", "1")):
        monkeypatch.setenv(name, value)
    multihost.initialize_multihost(device="cpu", backend="gloo")
    assert calls["torch"] == [(("gloo",), {"init_method": "tcp://node0:29500", "world_size": 2,
                                           "rank": 1})]
    multihost.initialize_multihost("file:///tmp/rv", device="cpu")
    assert calls["torch"][1][1]["init_method"] == "file:///tmp/rv"


def test_initialize_multihost_checks_the_device(monkeypatch):
    calls = _record_both(monkeypatch)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setenv("LOCAL_RANK", "2")  # cuda:2 of two cards: raises, never wraps round
    with pytest.raises(ValueError, match="does not exist"):
        multihost.initialize_multihost("h:1", 4, 2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        multihost.initialize_multihost("h:1", 4, 2)
    with pytest.raises(ValueError, match="coordinator address"):
        multihost.initialize_multihost(device="cpu")
    assert calls["torch"] == []


@pytest.mark.parametrize("trigger", ["none", "coordinator", "launcher", "fails"])
def test_auto_initialize_matches_jax(monkeypatch, capsys, trigger):
    from sdf_representation_tpu.parallel import multihost as jax_multihost

    _record_both(monkeypatch, fail=RuntimeError("already initialised") if trigger == "fails"
                 else None)
    results = {}
    for pkg, module in (("jax", jax_multihost), ("torch", multihost)):
        for name in ENV_NAMES:
            monkeypatch.delenv(name, raising=False)
        if trigger in ("coordinator", "fails"):
            env = {"JAX_COORDINATOR": "h:1", "NPROC": "2", "PROC_ID": "0"}
        elif trigger == "launcher":  # TPU_WORKER_HOSTNAMES with a comma <-> WORLD_SIZE > 1
            env = ({"TPU_WORKER_HOSTNAMES": "a,b", "JAX_COORDINATOR": ""} if pkg == "jax" else
                   {"MASTER_ADDR": "h", "MASTER_PORT": "1", "WORLD_SIZE": "2", "RANK": "0"})
        else:
            env = {"WORLD_SIZE": "1"} if pkg == "torch" else {"TPU_WORKER_HOSTNAMES": "a"}
        for name, value in env.items():
            monkeypatch.setenv(name, value)
        if pkg == "torch":
            monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
            monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
            monkeypatch.setattr(torch.cuda, "set_device", lambda d: None)
        results[pkg] = (module.auto_initialize(), capsys.readouterr().out)
    assert results["torch"] == results["jax"]
    assert results["torch"][0] == (trigger in ("coordinator", "launcher"))
    if trigger == "fails":
        assert results["torch"][1] == "multihost init skipped: already initialised\n"


@pytest.mark.parametrize("total", [0, 1, 7, 16, 17])
def test_host_shard_matches_jax(monkeypatch, total):
    import jax

    from sdf_representation_tpu.parallel import multihost as jax_multihost

    for n in range(1, 5):
        for i in range(n):
            monkeypatch.setattr(jax, "process_count", lambda n=n: n)
            monkeypatch.setattr(jax, "process_index", lambda i=i: i)
            monkeypatch.setattr(multihost, "process_count", lambda n=n: n)
            monkeypatch.setattr(multihost, "process_index", lambda i=i: i)
            assert multihost.host_shard(total) == jax_multihost.host_shard(total)
    monkeypatch.undo()
    assert multihost.host_shard(total) == slice(0, total)  # no process group: everything


@pytest.mark.parametrize("n", [0, 1, 2, 7, 255, 256])
def test_rank_rows_are_tensor_splits_pieces(n):
    for size in (1, 2, 3, 4):
        pieces = torch.tensor_split(torch.arange(n), size)
        for rank in range(size):
            start, stop = rank_rows(n, rank, size)
            assert torch.equal(torch.arange(n)[start:stop], pieces[rank])


# ---------------------------------------------------------------------------
# two ranks over gloo
# ---------------------------------------------------------------------------

def _close(got, want, rtol, atol, what):
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(), rtol=rtol, atol=atol,
                                   err_msg=f"{what}: {name}")


def test_ranks_run_on_the_group_and_import_no_jax(ranks):
    for r, out in enumerate(ranks["out"]):
        assert out["mesh"] == ("cpu", r, RANKS)
        assert out["jax_imported"] is False


@pytest.mark.parametrize("case", ALL_CASES)
def test_ranks_hold_bit_equal_parameters(ranks, case):
    a, b = (out[case] for out in ranks["out"])
    assert a["losses"] == b["losses"]
    for name in a["params"]:
        assert torch.equal(a["params"][name], b["params"][name]), name


@pytest.mark.parametrize("case", ["l2", "pcd", "pcd_trainer"])
def test_two_ranks_match_the_in_process_two_shard_mesh(ranks, case):
    want = _run_case(case, ranks["inputs"], ("cpu",) * 2)
    got = ranks["out"][0][case]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
    _close(got["params"], want["params"], 1e-4, 1e-6, case)


def _jax_weights(tree):
    import jax

    from sdf_representation_tpu_torch.convert import params_from_jax

    out = params_from_jax(jax.tree_util.tree_map(np.asarray, tree))
    return {k: v for k, v in out.items() if k.endswith("weight")}


def test_two_ranks_match_the_jax_sharded_step(ranks):
    import jax
    import jax.numpy as jnp
    import optax

    from sdf_representation_tpu.losses import WeightedSmoothL2Loss as JaxWeightedSmoothL2Loss
    from sdf_representation_tpu.models import ImplicitNet as JaxImplicitNet
    from sdf_representation_tpu.parallel.mesh import (data_sharding, get_mesh,
                                                      replicated_sharding)
    from sdf_representation_tpu.training.trainer import make_train_step as jax_make_train_step

    jm = JaxImplicitNet(d_in=3, hidden_dims=(64,) * 4, skip_in=(2,), beta=100.0)
    optimizer, mesh = optax.adam(1e-3), get_mesh(2)
    trainable = jax.device_put({"params": ranks["jax_params"]["l2"], "aux": {}},
                               replicated_sharding(mesh))
    opt_state = jax.device_put(optimizer.init(trainable), replicated_sharding(mesh))
    step = jax.jit(jax_make_train_step(jm, JaxWeightedSmoothL2Loss(), optimizer, mesh=mesh))
    losses = []
    for x, y in zip(ranks["inputs"]["l2"]["x"], ranks["inputs"]["l2"]["y"]):
        trainable, opt_state, loss = step(
            trainable, opt_state, jax.device_put(jnp.asarray(x.numpy()), data_sharding(mesh)),
            jax.device_put(jnp.asarray(y.numpy()), data_sharding(mesh)), jax.random.PRNGKey(0), 0)
        losses.append(float(loss))
    got = ranks["out"][0]["l2"]
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
    _close(got["params"], _jax_weights(trainable["params"]), 1e-4, 1e-6, "l2")


def test_two_ranks_match_the_jax_sharded_point_cloud_step(ranks):
    """The point-cloud loss (JAX pcd_trainer.py's loss_fn, its draws given)
    under the JAX package's 2-device sharded apply, Adam, 3 steps."""
    import jax
    import jax.numpy as jnp
    import optax

    from sdf_representation_tpu.models import ImplicitNet as JaxImplicitNet
    from sdf_representation_tpu.ops.diffops import sdf_and_gradient_fwd
    from sdf_representation_tpu.parallel.mesh import data_sharding, get_mesh, shard_batch
    from sdf_representation_tpu.training.trainer import _bind_apply

    jm = JaxImplicitNet(d_in=3, hidden_dims=(64,) * 4, skip_in=(2,), beta=100.0)
    mesh = get_mesh(2)
    apply_fn = _bind_apply(jm, None, mesh=mesh)

    def loss_fn(p, xb, idx, noise):
        xb = shard_batch(xb, mesh)
        surface_loss = jnp.mean(jnp.abs(apply_fn(p, xb)))
        _, grads = sdf_and_gradient_fwd(apply_fn, p, xb[idx] + noise)
        return surface_loss + 0.1 * jnp.mean((jnp.linalg.norm(grads[:, -3:], axis=-1) - 1.0) ** 2)

    grad_fn = jax.jit(jax.value_and_grad(loss_fn))
    optimizer = optax.adam(1e-3)
    params = ranks["jax_params"]["pcd"]
    opt_state = optimizer.init(params)
    losses = []
    for xb, idx, noise in zip(*(ranks["inputs"]["pcd"][k] for k in ("x", "idx", "noise"))):
        value, grads = grad_fn(params, jax.device_put(jnp.asarray(xb.numpy()), data_sharding(mesh)),
                               jnp.asarray(idx.numpy()), jnp.asarray(noise.numpy()))
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        losses.append(float(value))
    got = ranks["out"][0]["pcd"]
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
    _close(got["params"], _jax_weights(params), 1e-4, 1e-6, "pcd")


@pytest.mark.parametrize("case", REPLICATED)
def test_replicated_terms_count_once(ranks, case):
    """Every step's gradients after the all-reduce against the one-process
    step's: a term every rank computes whole (the one-row batch's forward,
    GaussBonnetLoss's per-point curvature and learnable Euler
    characteristic, the Lipschitz bound) counted twice would differ by its
    own size. SGD keeps the parameters as sensitive as the gradients."""
    want = _run_case(case, ranks["inputs"], None)
    got = ranks["out"][0][case]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
    for step, (g, w) in enumerate(zip(got["grads"], want["grads"])):
        _close(g, w, 1e-4, 1e-7, f"{case} step {step}")
    _close(got["params"], want["params"], 1e-4, 1e-7, case)


def test_mesh_devices_must_equal_the_ranks(ranks):
    for out in ranks["out"]:
        first, second = out["mesh_devices_raised"]
        assert "mesh_devices = 4 under a process group of 2 ranks" in first
        assert "each rank drives one device" in second


def test_cli_only_rank_zero_writes_and_repeats_one_process(ranks, capsys):
    """Per-rank run directories (labels written into both beforehand): rank
    0's receives info.txt, the loss log and the checkpoints, rank 1's none;
    the loss history equals the one-process run's."""
    files = [sorted(p.name for p in (pathlib.Path(path).parent / "out").rglob("*") if p.is_file())
             for path in ranks["cli_configs"]]
    assert files[1] == ["narrow.csv", "surface.csv", "uniform.csv"]
    assert {"info.txt", "train_loss.txt", "best_model.ckpt", "model_epoch1.ckpt"} <= set(files[0])
    assert cli.main([ranks["single_config"], "--device", "cpu"]) == 0
    capsys.readouterr()
    single = Trainer(Configuration(ranks["single_config"]), device="cpu")
    rank0 = Trainer(Configuration(ranks["cli_configs"][0]), device="cpu")
    want = np.loadtxt(pathlib.Path(single.train_path) / "train_loss.txt")
    got = np.loadtxt(pathlib.Path(rank0.train_path) / "train_loss.txt")
    assert want.shape == (3, 3) and want[-1, 1] < want[0, 1]
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_cli_shared_directory_samples_once_and_resumes(ranks):
    """One run directory for both ranks: rank 0 samples and labels, both read
    the CSVs after the barrier and train; the loss log has one line per
    epoch; the resumed run reads rank 0's checkpoint on both ranks."""
    trainer = Trainer(Configuration(ranks["shared_configs"][0]), device="cpu")
    data = pathlib.Path(trainer.data_path)
    assert all((data / f"{n}.csv").exists() for n in ("uniform", "surface", "narrow"))
    log = (pathlib.Path(trainer.train_path) / "train_loss.txt").read_text().splitlines()
    assert [int(line.split()[0]) for line in log] == [0, 1]
    for text in ranks["logs"]:
        assert text.count("Training done: 2 epochs") == 1
        assert "Resumed from" in text and "Training done: 0 epochs" in text


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), sys.argv[2])
