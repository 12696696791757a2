"""The port's FeedForwardNetwork, Siren and KAN (models/ffn.py, siren.py,
kan.py), the registry and ``make_model`` against the JAX package's, on the
CPU at small widths, with the JAX weights carried over by ``convert.py``.

Tolerances: float32 forwards within 1e-6. Under the trainer's bfloat16 cast
(``bind_apply(model, "bfloat16")`` against the JAX step's ``_cast_bf16``):
Siren within 1e-6, since JAX promotes it back to float32 after the first
pre-activation and the port must widen where JAX does (torch alone would
stay in bfloat16 and miss by ~1e-3). FFN and KAN stay in bfloat16, which
each framework sums in its own order (XLA on the CPU also keeps some fused
intermediates in float32), so they are held by their distance from the
float32 forward: within 1.5 times JAX's bfloat16 distance (max and mean),
and at least a quarter of it (the cast happened). KAN's bases are bit-equal to JAX's
(closed form and recursion, float32 and bfloat16), its grid dispatch takes
the JAX branch for a cast grid, ``curve2coeff`` agrees within 1e-6 of the
largest coefficient and ``update_grid``'s refit (its systems on the data's
knots are worse conditioned) within 1e-5: JAX's float32 SVD against the
port's float64 one. FFN dropout is checked by its statistics: masks come
from the port's generator, not from ``jax.random``'s stream.

The eikonal losses with Siren (the family built for them): one labelled
IGRLOSS step (SGD, so the update is the gradient) and the point-cloud loss
on a fixed batch with the draws given, against JAX: rtol 2e-4 / atol 2e-5
(tests/test_torch_pcd_trainer.py). Neither takes the fused kernels 8-9:
they stay ImplicitNet-only, and Siren's (f, grad f) comes from forward-mode
passes, as ``jax.jvp`` gives them in JAX.
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sdf_representation_tpu.configgen import Configuration as JaxConfiguration
from sdf_representation_tpu.losses.losses import IGRLOSS as JaxIGRLOSS
from sdf_representation_tpu.models import FeedForwardNetwork as JaxFFN
from sdf_representation_tpu.models import KAN as JaxKAN
from sdf_representation_tpu.models import Siren as JaxSiren
from sdf_representation_tpu.models import kan as jax_kan
from sdf_representation_tpu.models.registry import MODEL_REGISTRY as JAX_REGISTRY
from sdf_representation_tpu.ops.diffops import sdf_and_gradient_fwd as jax_sdf_and_gradient_fwd
from sdf_representation_tpu.training import trainer as jax_trainer
from sdf_representation_tpu.training.trainer import _cast_bf16
from sdf_representation_tpu_torch.configgen import Configuration
from sdf_representation_tpu_torch.convert import params_from_jax, params_to_numpy
from sdf_representation_tpu_torch.losses.losses import IGRLOSS
from sdf_representation_tpu_torch.models import (
    KAN, MODEL_REGISTRY, FeedForwardNetwork, Siren, get_model_class, register_model)
from sdf_representation_tpu_torch.models import kan
from sdf_representation_tpu_torch.training.pcd_trainer import pcd_loss
from sdf_representation_tpu_torch.training.trainer import bind_apply, make_train_step, use_fused_igr

torch.set_num_threads(2)
REPO = pathlib.Path(__file__).resolve().parent.parent

FAMILIES = {
    "ffn": (lambda: JaxFFN(hidden_dim=32, num_layers=3),
            lambda: FeedForwardNetwork(hidden_dim=32, num_layers=3)),
    "siren": (lambda: JaxSiren(hidden_dims=(32,) * 3), lambda: Siren(hidden_dims=(32,) * 3)),
    "kan_grid5": (lambda: JaxKAN(layers_hidden=(3, 8, 8, 1), grid_size=5),
                  lambda: KAN(layers_hidden=(3, 8, 8, 1), grid_size=5)),
    "kan_grid256": (lambda: JaxKAN(layers_hidden=(3, 8, 1), grid_size=256),
                    lambda: KAN(layers_hidden=(3, 8, 1), grid_size=256)),
}


def _pair(name, seed=1):
    """The JAX model, its params (numpy) and the port's model with the same
    weights: JAX's init carried over, but for KAN, whose JAX init compiles
    a batched SVD (~10 s on the CPU), the port's init carried the other way
    (``curve2coeff``, the init's solve, is held against JAX's below)."""
    make_jax, make_port = FAMILIES[name]
    jm, tm = make_jax(), make_port()
    if name.startswith("kan"):
        tm = KAN(layers_hidden=tm.layers_hidden, grid_size=tm.grid_size,
                 generator=torch.Generator().manual_seed(seed))
        return jm, params_to_numpy(tm), tm
    params = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(seed)))
    tm.load_state_dict(params_from_jax(params, tm))
    return jm, params, tm


def _points(n=512, seed=0):
    return np.random.default_rng(seed).uniform(-1, 1, (n, 3)).astype(np.float32)


@pytest.mark.parametrize("name", list(FAMILIES))
def test_forward_matches_jax(name):
    jm, params, tm = _pair(name)
    x = _points()
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    want = np.asarray(jm.apply(jp, jnp.asarray(x)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
        got_bf16 = bind_apply(tm, "bfloat16")(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    want_bf16 = np.asarray(jm.apply(_cast_bf16(jp), jnp.asarray(x).astype(jnp.bfloat16))
                           .astype(jnp.float32))
    if name == "siren":
        np.testing.assert_allclose(got_bf16, want_bf16, rtol=0, atol=1e-6)
    ours, theirs = np.abs(got_bf16 - want), np.abs(want_bf16 - want)
    assert ours.max() <= 1.5 * theirs.max() and ours.mean() <= 1.5 * theirs.mean()
    assert ours.max() >= 0.25 * theirs.max() > 0  # bfloat16 arithmetic ran


def test_convert_round_trip_every_family():
    for name in FAMILIES:
        _, params, tm = _pair(name, seed=2)
        back = params_to_numpy(tm)
        flat = jax.tree_util.tree_leaves_with_path(params)
        got = dict(jax.tree_util.tree_leaves_with_path(back))
        assert sorted(map(str, got)) == sorted(str(p) for p, _ in flat), name
        for path, leaf in flat:
            np.testing.assert_array_equal(got[path], leaf)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kan_bases_equal_jax(dtype):
    """Against the JAX functions run op by op (as written; under jit XLA
    may fuse and contract their float32 arithmetic)."""
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    x = np.random.default_rng(1).uniform(-1.05, 1.05, (256, 4)).astype(np.float32)
    x[:5, 0] = [1.0, -1.0, 0.9921875, 1.0234375, 0.0]  # knots and the domain's edges
    for g in (5, 256):
        h = 2.0 / g
        want = jax_kan.b_splines_uniform(jnp.asarray(x).astype(jdt), -1.0, h, g + 3, 3)
        got = kan.b_splines_uniform(torch.from_numpy(x).to(tdt), -1.0, h, g + 3, 3)
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))
        grid = np.asarray(jax_kan.KANLayerSpec(4, 2, grid_size=g).default_grid())
        want = jax_kan.b_splines(jnp.asarray(x).astype(jdt), jnp.asarray(grid).astype(jdt), 3)
        got = kan.b_splines(torch.from_numpy(x).to(tdt), torch.from_numpy(grid).to(tdt), 3)
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))
    for k in (1, 2):
        want = jax_kan.b_splines_uniform(jnp.asarray(x).astype(jdt), -1.0, 0.4, 5 + k, k)
        got = kan.b_splines_uniform(torch.from_numpy(x).to(tdt), -1.0, 0.4, 5 + k, k)
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


def test_kan_dispatch_takes_the_jax_branch():
    """The closed form runs while the stored grid equals the default in
    float32: a bfloat16 copy of the grid matches at grid 256 (knots on
    multiples of 2^-7) and not at grid 5 (h = 0.4)."""
    for g, closed_bf16 in ((5, False), (256, True)):
        layer = kan.KANLayer(3, 2, grid_size=g)
        spec = jax_kan.KANLayerSpec(3, 2, grid_size=g)
        jax_says = bool(jnp.all(spec.default_grid().astype(jnp.bfloat16) == spec.default_grid()))
        assert layer.uses_closed_form() and jax_says == closed_bf16
        layer.grid = layer.grid.to(torch.bfloat16)
        assert layer.uses_closed_form() == closed_bf16


def test_kan_curve2coeff_update_grid_and_regularizer_match_jax():
    rng = np.random.default_rng(0)
    for g in (5, 256):
        grid = np.asarray(jax_kan.KANLayerSpec(4, 3, grid_size=g).default_grid())
        interior = grid.T[3:-3].copy()
        noise = ((rng.uniform(size=(g + 1, 4, 3)) - 0.5) * 0.1 / g).astype(np.float32)
        want = np.asarray(jax.jit(jax_kan.curve2coeff, static_argnums=3)(
            jnp.asarray(interior), jnp.asarray(noise), jnp.asarray(grid), 3))
        got = kan.curve2coeff(torch.from_numpy(interior), torch.from_numpy(noise),
                              torch.from_numpy(grid), 3).numpy()
        assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max() + 1e-9
    jm = JaxKAN(layers_hidden=(3, 6, 5, 1), grid_size=5)
    tm = KAN(layers_hidden=(3, 6, 5, 1), grid_size=5, generator=torch.Generator().manual_seed(3))
    params = params_to_numpy(tm)
    x = rng.uniform(-0.8, 0.9, (257, 3)).astype(np.float32)
    new = jax.jit(jm.update_grid)(jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x))
    tm.update_grid(torch.from_numpy(x))
    got = params_to_numpy(tm)
    for lw, lg in zip(new["layers"], got["layers"]):
        for key in ("grid", "spline_w", "base_w", "spline_scaler"):
            want = np.asarray(lw[key])
            assert np.abs(lg[key] - want).max() <= 1e-5 * np.abs(want).max(), key
    assert not any(layer.uses_closed_form() for layer in tm.layers)
    with torch.no_grad():
        np.testing.assert_allclose(tm(torch.from_numpy(x)).numpy(),
                                   np.asarray(jm.apply(new, jnp.asarray(x))), rtol=0, atol=1e-6)
    assert float(tm.regularization_loss()) == pytest.approx(float(jm.regularization_loss(new)),
                                                           rel=1e-6)


def test_ffn_dropout_statistics_and_the_step_passes_train():
    p = 0.5
    tm = FeedForwardNetwork(hidden_dim=256, num_layers=1, dropout_rate=p,
                            generator=torch.Generator().manual_seed(0))
    seen = []
    tm.out.register_forward_pre_hook(lambda module, args: seen.append(args[0].detach()))
    x = torch.from_numpy(_points(4096))
    gen = torch.Generator().manual_seed(7)
    with torch.no_grad():
        plain = tm(x)
        dropped = tm(x, generator=gen, train=True)
        assert torch.equal(tm(x, train=True), plain)  # no generator: no dropout
    h, hd = seen[0], seen[1]
    live = h > 0
    kept = hd[live] != 0
    n = int(live.sum())
    assert abs(float(kept.float().mean()) - (1 - p)) < 4 * (p * (1 - p) / n) ** 0.5
    torch.testing.assert_close(hd[live][kept], h[live][kept] / (1 - p), rtol=1e-6, atol=0)
    assert not torch.equal(dropped, plain)
    # the training step's forward drops out, with the same masks on every
    # call of one step (JAX's apply is a function of its rng) and others on
    # the next step; the validation forward (no generator) does not
    with torch.no_grad():
        step = bind_apply(tm, generator=torch.Generator().manual_seed(7))
        first = step(x)
        assert torch.equal(step(x), first) and not torch.equal(first, plain)
        assert not torch.equal(bind_apply(tm, generator=torch.Generator().manual_seed(8))(x), first)
        assert torch.equal(bind_apply(tm)(x), plain)
    # with dropout_rate 0 and train=True the forward is JAX's
    jm = JaxFFN(hidden_dim=32, num_layers=2, dropout_rate=0.0)
    params = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(4)))
    tm = FeedForwardNetwork(hidden_dim=32, num_layers=2, dropout_rate=0.0)
    tm.load_state_dict(params_from_jax(params, tm))
    want = jm.apply(jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x.numpy()),
                    rng=jax.random.PRNGKey(0), train=True)
    with torch.no_grad():
        got = tm(x, generator=gen, train=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


def test_registry_and_register_model():
    assert sorted(MODEL_REGISTRY) == sorted(JAX_REGISTRY)
    for name in MODEL_REGISTRY:
        assert get_model_class(name) is MODEL_REGISTRY[name]
    with pytest.raises(ValueError, match="Unknown model"):
        get_model_class("NoSuchNet")

    class Tiny(torch.nn.Module):
        def __init__(self, generator=None, device=None):
            super().__init__()
            self.w = torch.nn.Parameter(torch.ones(3, device=device))

        def forward(self, x):
            return x @ self.w

    register_model("TinyNet", Tiny)
    try:
        assert get_model_class("TinyNet") is Tiny
        cfg = Configuration(str(REPO / "configs/mesh_sdf.ini"))
        cfg.model_name = "TinyNet"
        assert isinstance(cfg.make_model(), Tiny)
    finally:
        del MODEL_REGISTRY["TinyNet"]


@pytest.mark.parametrize("name", ["FeedForwardNetwork", "Siren", "KAN", "HashMLP"])
def test_make_model_equals_jax_in_shape(tmp_path, name):
    text = (REPO / "configs/mesh_sdf.ini").read_text()
    text = (text.replace("model = ImplicitNet", f"model = {name}")
            .replace("hidden_dim = 512", "hidden_dim = 16")
            .replace("num_hidden_layers = 8", "num_hidden_layers = 2"))
    if name == "Siren":
        text = text.replace("[Loss]", "omega_0 = 12.5\n\n[Loss]")
    path = tmp_path / "m.ini"
    path.write_text(text)
    jax_model = JaxConfiguration(str(path)).make_model()
    model = Configuration(str(path)).make_model(generator=torch.Generator().manual_seed(0))
    assert type(model).__name__ == type(jax_model).__name__ == name
    shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape),
                                    jax.eval_shape(jax_model.init, jax.random.PRNGKey(0)))
    got = jax.tree_util.tree_map(lambda a: tuple(a.shape), params_to_numpy(model))
    assert got == shapes
    if name == "Siren":
        assert model.omega_0 == jax_model.omega_0 == 12.5
    if name == "KAN":
        assert model.grid_size == jax_model.grid_size == 256
        assert model.layers_hidden == jax_model.layers_hidden == (3, 16, 16, 1)
    if name == "HashMLP":
        assert model.num_layers == jax_model.num_layers == 2


def _sphere_batch(n=256, seed=5):
    x = np.random.default_rng(seed).uniform(-1, 1, (n, 3)).astype(np.float32)
    r = np.linalg.norm(x, axis=1, keepdims=True)
    return x, np.concatenate([r - 0.5, x / r], axis=1).astype(np.float32)


def test_siren_labelled_igr_step_matches_jax():
    jm, params, tm = _pair("siren", seed=6)
    assert not use_fused_igr(tm, "bfloat16") and not use_fused_igr(tm, None)
    assert not hasattr(bind_apply(tm, "bfloat16"), "_implicitnet_fast")
    x, y = _sphere_batch()
    lr = 1e-2
    opt = optax.sgd(lr)
    trainable = {"params": jax.tree_util.tree_map(jnp.asarray, params), "aux": {}}
    jstep = jax.jit(jax_trainer.make_train_step(jm, JaxIGRLOSS(), opt))
    new, _, jloss = jstep(trainable, opt.init(trainable), jnp.asarray(x), jnp.asarray(y),
                          jax.random.PRNGKey(0), 0)
    moved = params_from_jax(jax.tree_util.tree_map(np.asarray, new["params"]), tm)
    before = {n: p.detach().clone() for n, p in tm.named_parameters()}
    step = make_train_step(tm, IGRLOSS(), torch.optim.SGD(tm.parameters(), lr=lr))
    loss = step(torch.from_numpy(x), torch.from_numpy(y), 0)
    assert float(loss) == pytest.approx(float(jloss), rel=2e-4)
    for name, p in tm.named_parameters():
        want = (before[name] - moved[name]) / lr
        got = (before[name] - p.detach()) / lr
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-4,
                                   atol=2e-5 * float(want.abs().max()), err_msg=name)


def test_siren_point_cloud_loss_matches_jax():
    jm, params, tm = _pair("siren", seed=7)
    rng = np.random.default_rng(1)
    pts = rng.normal(size=(300, 3))
    xb = (0.5 * pts / np.linalg.norm(pts, axis=1, keepdims=True)).astype(np.float32)
    idx = rng.permutation(300)[:100]
    noise = (1e-4 * rng.normal(size=(100, 3))).astype(np.float32)
    apply_fn = jax_trainer._bind_apply(jm, None)
    assert not hasattr(apply_fn, "_implicitnet_fast")

    def jax_loss(p):  # the body of pcd_trainer._make_epoch_fn's loss_fn, its draws given
        surface_loss = jnp.mean(jnp.abs(apply_fn(p, jnp.asarray(xb))))
        _, grads = jax_sdf_and_gradient_fwd(apply_fn, p, jnp.asarray(xb)[idx] + jnp.asarray(noise))
        return surface_loss + 0.1 * jnp.mean((jnp.linalg.norm(grads[:, -3:], axis=-1) - 1.0) ** 2)

    want_value, want = jax.value_and_grad(jax_loss)(jax.tree_util.tree_map(jnp.asarray, params))
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, want), tm)
    value = pcd_loss(bind_apply(tm), tm, torch.from_numpy(xb), torch.from_numpy(idx),
                     torch.from_numpy(noise), 0.1)
    value.backward()
    np.testing.assert_allclose(float(value.detach()), float(want_value), rtol=2e-4)
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), rtol=2e-4,
                                   atol=2e-5 * float(want[name].abs().max()), err_msg=name)
