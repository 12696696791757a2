"""Data-parallel training in the port: the mesh helpers, the sharded fused
eikonal op, the sharded training step against the JAX package's on its
eight virtual CPU devices, and the command line with ``mesh_devices``.

The port's mesh is the CPU listed N times (one process launches every
shard; parallel/mesh.py). Tolerances are those of tests/test_sharding.py:
the sharded step's loss rel 1e-5 and layer weights rtol 1e-4 / atol 1e-6;
the sharded fused op's loss rel 1e-5 (single-device fused) / 1e-4 (the
shared-matmul derivation) and parameter gradients rtol 2e-4 / atol 2e-5 /
rtol 5e-4 / atol 5e-5. The command line's loss history with and without a
mesh: rel 1e-5."""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sdf_representation_tpu.losses import WeightedSmoothL2Loss as JaxWeightedSmoothL2Loss
from sdf_representation_tpu.models import ImplicitNet as JaxImplicitNet
from sdf_representation_tpu.parallel.mesh import data_sharding, replicated_sharding
from sdf_representation_tpu.parallel.mesh import get_mesh as jax_get_mesh
from sdf_representation_tpu.training.trainer import make_train_step as jax_make_train_step
from sdf_representation_tpu_torch import cli
from sdf_representation_tpu_torch.configgen import Configuration
from sdf_representation_tpu_torch.convert import params_from_jax
from sdf_representation_tpu_torch.losses.losses import (IGRLOSS, IGRLOSSPCD, GaussBonnetLoss,
                                                        WeightedSmoothL2Loss)
from sdf_representation_tpu_torch.models import ImplicitNet
from sdf_representation_tpu_torch.ops import fused_igr
from sdf_representation_tpu_torch.ops.diffops import implicitnet_value_and_grad
from sdf_representation_tpu_torch.parallel.mesh import (gather, get_mesh, mesh_kind, replicate,
                                                        shard_batch)
from sdf_representation_tpu_torch.sampling.sampler import Frame
from sdf_representation_tpu_torch.training import PointCloudTrainer, Trainer
from sdf_representation_tpu_torch.training.trainer import bind_apply, make_train_step

torch.set_num_threads(2)
REPO = pathlib.Path(__file__).resolve().parent.parent
MESH8 = ("cpu",) * 8


def _setup(n=512, seed=0):
    """tests/test_sharding.py's setup: a 2x32 net (skip at 1) and n points
    labelled with the radius-0.5 sphere's distance and normal."""
    jm = JaxImplicitNet(d_in=3, hidden_dims=(32,) * 2, skip_in=(1,), beta=100.0)
    params = jm.init(jax.random.PRNGKey(seed))
    tm = ImplicitNet(d_in=3, hidden_dims=(32,) * 2, skip_in=(1,), beta=100.0)
    tm.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    nrm = x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-9)
    y = np.column_stack([np.linalg.norm(x, axis=1) - 0.5, nrm]).astype(np.float32)
    return jm, params, tm, x, y


# ---------------------------------------------------------------------------
# the mesh helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [16, 13, 3])
def test_shard_batch_cuts_contiguous_near_equal_pieces(n):
    x = torch.arange(n * 3, dtype=torch.float32).reshape(n, 3)
    pieces = shard_batch(x, ("cpu",) * 4)
    sizes = [p.shape[0] for p in pieces]
    assert len(pieces) == 4 and sum(sizes) == n and max(sizes) - min(sizes) <= 1
    torch.testing.assert_close(torch.cat(pieces), x)
    torch.testing.assert_close(gather(pieces, "cpu"), x)
    assert shard_batch(x, None) == [x]


def test_replicate_shares_a_device_and_sums_the_gradients():
    w = torch.tensor([1.0, 2.0], requires_grad=True)
    copies = replicate([w], ("cpu",) * 3)
    assert all(c[0] is w for c in copies)  # t.to(its own device) is t
    loss = sum((c[0] * (d + 1)).sum() for d, c in enumerate(copies))
    loss.backward()
    torch.testing.assert_close(w.grad, torch.tensor([6.0, 6.0]))


def test_mesh_is_all_cards_or_all_cpu():
    assert mesh_kind(("cpu",) * 2) == "cpu"
    assert get_mesh(3, devices=("cpu",) * 8) == (torch.device("cpu"),) * 3
    with pytest.raises(ValueError, match="all cards or all CPU"):
        get_mesh(devices=("cpu", "cuda:0"))
    with pytest.raises(ValueError, match="at least one device"):
        get_mesh(0, devices=("cpu",))


def test_trainer_device_must_be_the_mesh_head(tmp_path):
    cfg = Configuration(_labelled_config(tmp_path, mesh_devices=2))
    trainer = Trainer(cfg, mesh=("cpu",) * 2)
    assert trainer.device == torch.device("cpu") and trainer.mesh == (torch.device("cpu"),) * 2
    with pytest.raises(ValueError, match="first device"):
        Trainer(cfg, device="cuda:0", mesh=("cpu",) * 2)


# ---------------------------------------------------------------------------
# make_fused_value_and_grad_sharded (kernels 8 and 9 per shard)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [512, 328])  # 328: IGRLOSS's 369 points split unevenly over 8
def test_sharded_fused_eikonal_grads_match_single_device(n):
    _, _, tm, x, y = _setup(n)
    x, y = torch.from_numpy(x), torch.from_numpy(y)
    loss = IGRLOSS()

    def grads_with(fast):
        tm.zero_grad(set_to_none=True)
        fn = lambda z: tm(z)  # noqa: E731
        fn._implicitnet_fast = fast
        value = loss(fn, x, y, 0)
        value.backward()
        return value.item(), [p.grad.clone() for p in tm.parameters()]

    l_ref, g_ref = grads_with(lambda z, layers=None: implicitnet_value_and_grad(tm, z, layers))
    l_one, g_one = grads_with(fused_igr.make_fused_value_and_grad(tm, torch.float32))
    l_shd, g_shd = grads_with(fused_igr.make_fused_value_and_grad_sharded(tm, MESH8, torch.float32))
    assert l_shd == pytest.approx(l_one, rel=1e-5)
    assert l_shd == pytest.approx(l_ref, rel=1e-4)
    for a, b, c in zip(g_one, g_shd, g_ref):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(b.numpy(), c.numpy(), rtol=5e-4, atol=5e-5)


def test_sharded_fused_op_gathers_on_the_mesh_head():
    _, _, tm, x, _ = _setup(37)
    x = torch.from_numpy(x)
    f1, g1 = fused_igr.make_fused_value_and_grad(tm, torch.float32)(x)
    f4, g4 = fused_igr.make_fused_value_and_grad_sharded(tm, ("cpu",) * 4, torch.float32)(x)
    assert f4.shape == (37,) and g4.shape == (37, 3)
    torch.testing.assert_close(f4, f1, rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(g4, g1, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_sharded_fused_op_with_an_empty_shard(dt):
    """Three points over four shards: the last shard is empty and adds
    nothing, so the parameter gradients are the single-device op's."""
    _, _, tm, x, _ = _setup(3)
    x = torch.from_numpy(x)

    def grads(vag):
        tm.zero_grad(set_to_none=True)
        f, g = vag(x)
        (f.square().sum() + g.sin().sum()).backward()
        return [p.grad.clone() for p in tm.parameters()]

    one = grads(fused_igr.make_fused_value_and_grad(tm, dt))
    four = grads(fused_igr.make_fused_value_and_grad_sharded(tm, ("cpu",) * 4, dt))
    for u, v in zip(four, one):
        torch.testing.assert_close(u, v, rtol=1e-5, atol=1e-6 * float(v.abs().max()))


# ---------------------------------------------------------------------------
# the sharded training step
# ---------------------------------------------------------------------------

def test_sharded_step_matches_the_jax_sharded_step():
    """One WeightedSmoothL2Loss step on 8 shards against the JAX package's
    make_train_step(mesh=get_mesh(8)) from the same weights and batch."""
    jm, params, tm, x, y = _setup()
    optimizer = optax.adam(1e-3)
    mesh = jax_get_mesh(8)
    trainable = jax.device_put({"params": params, "aux": {}}, replicated_sharding(mesh))
    opt_state = jax.device_put(optimizer.init(trainable), replicated_sharding(mesh))
    step_dp = jax.jit(jax_make_train_step(jm, JaxWeightedSmoothL2Loss(), optimizer, mesh=mesh))
    t8, _, l8 = step_dp(trainable, opt_state, jax.device_put(jnp.asarray(x), data_sharding(mesh)),
                        jax.device_put(jnp.asarray(y), data_sharding(mesh)),
                        jax.random.PRNGKey(0), 0)

    opt = torch.optim.Adam(tm.parameters(), lr=1e-3, betas=(0.9, 0.999), eps=1e-8)
    step = make_train_step(tm, WeightedSmoothL2Loss(), opt, mesh=MESH8)
    loss = step(torch.from_numpy(x), torch.from_numpy(y), 0)
    assert loss.item() == pytest.approx(float(l8), rel=1e-5)
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, t8["params"]))
    for name, p in tm.named_parameters():
        if name.endswith("weight"):
            np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=1e-4,
                                       atol=1e-6, err_msg=name)


def _loss_and_aux(loss_cls):
    loss = loss_cls()
    aux = ({"euler_characteristic": torch.nn.Parameter(torch.tensor(2.0))}
           if getattr(loss, "needs_aux", ()) else None)
    return loss, aux


def _batch(loss_cls):
    _, _, _, x, y = _setup(328 if loss_cls is not GaussBonnetLoss else 64)
    return torch.from_numpy(x), torch.from_numpy(y)


LOSSES = [WeightedSmoothL2Loss, IGRLOSS, IGRLOSSPCD, GaussBonnetLoss]


@pytest.mark.parametrize("loss_cls", LOSSES)
def test_sharded_step_matches_the_single_device_step(loss_cls):
    """f32. The loss is taken on mesh[0] over the gathered batch with the
    step's one generator: IGRLOSSPCD's drawn points and GaussBonnetLoss's
    per-point curvature (a batch of one row runs whole on mesh[0]) are the
    single-device step's."""
    x, y = _batch(loss_cls)
    out = []
    for mesh in (None, MESH8):
        _, _, tm, _, _ = _setup(8)
        loss, aux = _loss_and_aux(loss_cls)
        opt = torch.optim.Adam([*tm.parameters(), *(aux or {}).values()], lr=1e-3)
        step = make_train_step(tm, loss, opt, aux=aux, mesh=mesh)
        value = step(x, y, 0, torch.Generator().manual_seed(11))
        out.append((value.item(), {k: v.detach().clone() for k, v in tm.named_parameters()}))
    (l1, p1), (l8, p8) = out
    assert l8 == pytest.approx(l1, rel=1e-5)
    for name in p1:
        np.testing.assert_allclose(p8[name].numpy(), p1[name].numpy(), rtol=1e-4, atol=1e-6,
                                   err_msg=name)


@pytest.mark.parametrize("loss_cls", LOSSES)
def test_sharded_bfloat16_gradients_match_the_single_device_ones(loss_cls):
    """"bfloat16": the loss as above (rel 1e-5); each parameter gradient
    within 2e-2 of its largest entry. The gradients of the bf16 parameter
    copies are bf16 tensors, and each shard's is rounded before autograd
    adds them into the f32 master (2^-8 relative per rounding); post-Adam
    weights are no measure here, since Adam's first step divides a gradient
    near zero by its own size."""
    x, y = _batch(loss_cls)
    out = []
    for mesh in (None, MESH8):
        _, _, tm, _, _ = _setup(8)
        loss, aux = _loss_and_aux(loss_cls)
        apply = bind_apply(tm, "bfloat16", mesh=mesh)
        value = loss(apply, x, y, 0, generator=torch.Generator().manual_seed(11), aux=aux)
        value.backward()
        out.append((value.item(), [p.grad.clone() for p in tm.parameters()]))
    (l1, g1), (l8, g8) = out
    assert l8 == pytest.approx(l1, rel=1e-5)
    for a, b in zip(g1, g8):
        assert (b - a).abs().max() <= 2e-2 * a.abs().max()


def test_sharded_apply_runs_every_shard_and_the_fast_path():
    _, _, tm, x, _ = _setup(40)
    x = torch.from_numpy(x)
    seen = []
    hook = tm.register_forward_hook(lambda mod, args, out: seen.append(args[0].shape[0]))
    try:
        apply = bind_apply(tm, mesh=("cpu",) * 4)
        torch.testing.assert_close(apply(x), tm(x)[:], rtol=1e-6, atol=1e-7)
    finally:
        hook.remove()
    assert seen[:4] == [10, 10, 10, 10]
    f, g = apply._implicitnet_fast(x)
    fr, gr = implicitnet_value_and_grad(tm, x)
    torch.testing.assert_close(f, fr, rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(g, gr, rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# the command line with mesh_devices
# ---------------------------------------------------------------------------

def _labelled_config(tmp_path, **changes):
    """tests/test_config.ini at 3x32 on labelled CSVs written into the run's
    data directory (no sampling); ``changes`` by key, mesh_devices under [TPU]."""
    text = (REPO / "tests/test_config.ini").read_text().replace("@DIR@", str(tmp_path))
    base = {"hidden_dim": 32, "num_hidden_layers": 3, "skip_connection": 2, "beta": 100,
            "geometric_init": True, "lr": 0.001, "epochs": 3, "min_epochs": 1,
            "batch_size": 256, "checkpointing": 2, "uniform_points": 0, "surface": 0,
            "narrowband": 0, "rescale": False}
    base.update(changes)
    tpu = {k: base.pop(k) for k in list(base) if k in ("mesh_devices", "train_matmul_precision")}
    for key, value in base.items():
        lines = [ln for ln in text.splitlines() if ln.startswith(f"{key} = ")]
        text = text.replace(lines[0], f"{key} = {value}")
    if tpu:
        text += "\n[TPU]\n" + "".join(f"{k} = {v}\n" for k, v in tpu.items())
    tmp_path.mkdir(parents=True, exist_ok=True)
    path = tmp_path / "config.ini"
    path.write_text(text)
    return str(path)


def _write_labels(trainer, n=1500, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (n, 3))
    r = np.linalg.norm(x, axis=1, keepdims=True)
    values = np.concatenate([x, r - 0.5, x / r], axis=1)
    for name, part in zip(("uniform", "surface", "narrow"), np.array_split(values, 3)):
        Frame(("x", "y", "z", "S", "nx", "ny", "nz"), part).to_csv(
            str(pathlib.Path(trainer.data_path) / f"{name}.csv"))


@pytest.mark.parametrize("loss_function", ["WeightedSmoothL2Loss", "IGRLOSS"])
def test_cli_mesh_devices_repeats_the_single_device_losses(tmp_path, loss_function, capsys):
    curves = {}
    for mesh_devices in (0, 4):
        cfg_path = _labelled_config(tmp_path / f"m{mesh_devices}", mesh_devices=mesh_devices,
                                    loss_function=loss_function)
        if loss_function == "IGRLOSS":
            text = pathlib.Path(cfg_path).read_text().replace("weight_factor = 0.5\n", "")
            pathlib.Path(cfg_path).write_text(text)
        trainer = Trainer(Configuration(cfg_path), device="cpu")
        _write_labels(trainer)
        assert cli.main([cfg_path, "--device", "cpu", "--compute-dtype", "float32"]) == 0
        assert "Training done: 3 epochs" in capsys.readouterr().out
        curves[mesh_devices] = np.loadtxt(pathlib.Path(trainer.train_path) / "train_loss.txt")
    assert curves[0].shape == (3, 3) and curves[0][-1, 1] < curves[0][0, 1]
    np.testing.assert_allclose(curves[4], curves[0], rtol=1e-5)


def test_cli_mesh_devices_point_cloud_trainer(tmp_path, capsys):
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(1500, 3))
    pts = 0.5 * pts / np.linalg.norm(pts, axis=1, keepdims=True)
    curves = {}
    for mesh_devices in (0, 4):
        root = tmp_path / f"m{mesh_devices}"
        (root / "cloud").mkdir(parents=True)
        np.savetxt(root / "cloud" / "surface.csv", pts, delimiter=",", header="x,y,z",
                   comments="")
        cfg_path = _labelled_config(root, mesh_devices=mesh_devices, geometry=f"{root}/cloud",
                                    loss_function="IGRLOSSPCD", distributed=True, epochs=3,
                                    batch_size=500, lr=0.003)
        text = pathlib.Path(cfg_path).read_text().replace("weight_factor = 0.5\n", "lambda_g = 0.1\n")
        pathlib.Path(cfg_path).write_text(text)
        assert cli.main([cfg_path, "--device", "cpu"]) == 0
        assert "Training done: 3 epochs" in capsys.readouterr().out
        trainer = PointCloudTrainer(Configuration(cfg_path), device="cpu")
        log = (pathlib.Path(trainer.train_path) / "train_loss.txt").read_text().splitlines()
        curves[mesh_devices] = np.array([float(ln.rsplit(" ", 1)[1]) for ln in log])
    assert len(curves[0]) == 3 and curves[0][-1] < curves[0][0]
    np.testing.assert_allclose(curves[4], curves[0], rtol=1e-5)
