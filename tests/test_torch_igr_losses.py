"""The eikonal (IGR) losses of the port against the JAX package's.

Same weights, the same numpy-seeded points, targets and (for IGRLOSSPCD)
sample points through both. The JAX losses read (f, grad_x f) through the
Pallas kernels in interpret mode (float32), the port's through its fused op
(plain versions on the CPU) and through the shared-matmul derivation.
Tolerances, as tests/test_pallas_igr.py:88-94: loss value rtol 1e-5,
parameter gradients rtol 2e-4 / atol 2e-5. GaussBonnetLoss differentiates
det(Hessian), of magnitude beta^3: value rtol 1e-4, gradients relative to
each tensor's largest entry (2e-4)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdf_representation_tpu.losses import losses as jax_losses
from sdf_representation_tpu.models import ImplicitNet as JaxImplicitNet
from sdf_representation_tpu.ops.pallas_igr import make_fused_value_and_grad as jax_make_fused
from sdf_representation_tpu_torch.convert import params_from_jax
from sdf_representation_tpu_torch.losses import losses
from sdf_representation_tpu_torch.models import ImplicitNet
from sdf_representation_tpu_torch.ops.fused_igr import make_fused_value_and_grad
from sdf_representation_tpu_torch.training.trainer import bind_apply

torch.set_num_threads(2)


def _setup(n=200, seed=0, skip=(2,), beta=100.0):
    jm = JaxImplicitNet(d_in=3, hidden_dims=(64,) * 4, skip_in=skip, beta=beta)
    params = jm.init(jax.random.PRNGKey(seed))
    model = ImplicitNet(d_in=3, hidden_dims=(64,) * 4, skip_in=skip, beta=beta)
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    y = rng.uniform(-1, 1, (n, 4)).astype(np.float32)
    y[:, 0] *= 0.3  # some targets inside the clamp band, some outside

    def jax_apply(p, xx):
        return jm.apply(p, xx)

    jax_apply._implicitnet_fast = jax_make_fused(
        jm, fwd_tile_p=128, bwd_tile_p=128, compute_dtype=jnp.float32, interpret=True)
    return jm, params, jax_apply, model, x, y


def _apply(model, fused):
    """The trainer's closure; ``fused``: the fused op in float32 (the
    trainer's own choice is its bfloat16 working type) for the fast path."""
    apply = bind_apply(model)
    if fused:
        apply._implicitnet_fast = make_fused_value_and_grad(model, torch.float32)
    return apply


def _port(model, loss, x, y, fused, aux=None):
    model.zero_grad()
    apply = _apply(model, fused)
    value = loss(apply, torch.from_numpy(x), torch.from_numpy(y), 0, aux=aux)
    value.backward()
    return float(value.detach()), {name: p.grad.clone() for name, p in model.named_parameters()}


def _compare(got, want, rtol=2e-4, atol=2e-5):
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(), rtol=rtol, atol=atol,
                                   err_msg=name)


@pytest.mark.parametrize("fused", [True, False], ids=["fused_op", "shared_matmul"])
@pytest.mark.parametrize("kwargs", [{}, {"global_norm_quirk": 1.0},
                                    {"regularizer_threshold": 0.05, "tau": 0.5}],
                         ids=["default", "global_norm_quirk", "threshold"])
def test_igrloss(kwargs, fused):
    _, params, jax_apply, model, x, y = _setup()
    jl = jax_losses.IGRLOSS(**kwargs)
    value, grads = jax.value_and_grad(
        lambda p: jl(p, jax_apply, jnp.asarray(x), jnp.asarray(y), 0))(params)
    got_value, got = _port(model, losses.IGRLOSS(**kwargs), x, y, fused)
    np.testing.assert_allclose(got_value, float(value), rtol=1e-5)
    _compare(got, params_from_jax(jax.tree_util.tree_map(np.asarray, grads)))


@pytest.mark.parametrize("fused", [True, False], ids=["fused_op", "shared_matmul"])
def test_regularized_custom_sdf_loss(fused):
    _, params, jax_apply, model, x, y = _setup(seed=1)
    jl = jax_losses.RegularizedCustomSDFLoss(regularizer_weight=10.0)
    value, grads = jax.value_and_grad(
        lambda p: jl(p, jax_apply, jnp.asarray(x), jnp.asarray(y), 0))(params)
    got_value, got = _port(model, losses.RegularizedCustomSDFLoss(regularizer_weight=10.0),
                           x, y, fused)
    np.testing.assert_allclose(got_value, float(value), rtol=1e-5)
    _compare(got, params_from_jax(jax.tree_util.tree_map(np.asarray, grads)), atol=2e-4)


@pytest.mark.parametrize("fused", [True, False], ids=["fused_op", "shared_matmul"])
def test_igrlosspcd_at_jax_drawn_points(fused):
    """jax.random is not reproduced: the JAX-drawn sample points go to both."""
    _, params, jax_apply, model, x, y = _setup(seed=2)
    jl = jax_losses.IGRLOSSPCD(lambda_g=0.3)
    pts = np.array(jl.get_points(jax.random.PRNGKey(5), jnp.asarray(x)))

    class Fixed(jax_losses.IGRLOSSPCD):
        def get_points(self, rng, pc_input):
            return jnp.asarray(pts)

    value, grads = jax.value_and_grad(
        lambda p: Fixed(lambda_g=0.3)(p, jax_apply, jnp.asarray(x), jnp.zeros((len(x), 0)), 0,
                                      rng=jax.random.PRNGKey(5)))(params)
    ours = losses.IGRLOSSPCD(lambda_g=0.3)
    model.zero_grad()
    got_value = ours.at_points(_apply(model, fused), torch.from_numpy(x),
                               torch.from_numpy(pts))
    got_value.backward()
    np.testing.assert_allclose(float(got_value.detach()), float(value), rtol=1e-5)
    _compare({n: p.grad for n, p in model.named_parameters()},
             params_from_jax(jax.tree_util.tree_map(np.asarray, grads)))


def test_igrlosspcd_get_points_distribution():
    """Shape n + n // 8; the local part stays within a few local_sigma of
    the cloud, the global part is uniform in +-global_sigma; the generator
    decides the draw."""
    loss = losses.IGRLOSSPCD()
    x = torch.from_numpy(np.random.default_rng(0).uniform(-1, 1, (4000, 3)).astype(np.float32))
    pts = loss.get_points(torch.Generator().manual_seed(1), x)
    jpts = np.asarray(jax_losses.IGRLOSSPCD().get_points(jax.random.PRNGKey(1), jnp.asarray(x.numpy())))
    assert pts.shape == jpts.shape == (4500, 3)
    for ours, theirs in ((pts.numpy(), jpts),):
        for arr in (ours, theirs):
            local = arr[:4000] - x.numpy()
            assert abs(local.std() - loss.local_sigma) < 0.05 * loss.local_sigma
            assert abs(local.mean()) < 1e-3 and np.abs(local).max() < 6 * loss.local_sigma
            glob = arr[4000:]
            assert np.abs(glob).max() <= loss.global_sigma
            assert abs(glob.std() - loss.global_sigma / np.sqrt(3)) < 0.1 * loss.global_sigma
    again = loss.get_points(torch.Generator().manual_seed(1), x)
    other = loss.get_points(torch.Generator().manual_seed(2), x)
    assert torch.equal(pts, again) and not torch.equal(pts, other)
    # the whole loss: a default generator (seed 0) when none is given
    model = ImplicitNet(d_in=3, hidden_dims=(16,) * 2, skip_in=(), beta=100.0)
    apply = bind_apply(model)
    a = loss(apply, x[:64], x[:64, :0], 0)
    b = loss(apply, x[:64], x[:64, :0], 0, generator=torch.Generator().manual_seed(0))
    assert torch.isfinite(a) and torch.equal(a, b)


def test_gauss_bonnet_loss_trains_its_euler_scalar():
    _, params, jax_apply, model, x, y = _setup(n=48, seed=3)
    jl = jax_losses.GaussBonnetLoss(gauss_bonnet_weight=1e-9)
    assert losses.GaussBonnetLoss.needs_aux == jl.needs_aux == ("euler_characteristic",)

    def jloss(tr):
        return jl(tr["params"], jax_apply, jnp.asarray(x), jnp.asarray(y), 0, aux=tr["aux"])

    trainable = {"params": params, "aux": {"euler_characteristic": jnp.asarray(2.0)}}
    value, grads = jax.value_and_grad(jloss)(trainable)
    euler = torch.nn.Parameter(torch.tensor(2.0))
    got_value, got = _port(model, losses.GaussBonnetLoss(gauss_bonnet_weight=1e-9), x, y, True,
                           aux={"euler_characteristic": euler})
    np.testing.assert_allclose(got_value, float(value), rtol=1e-4)
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, grads["params"]))
    for name in want:
        scale = max(float(want[name].abs().max()), 1e-3)
        np.testing.assert_allclose(got[name].numpy() / scale, want[name].numpy() / scale,
                                   atol=2e-4, rtol=0, err_msg=name)
    np.testing.assert_allclose(float(euler.grad), float(grads["aux"]["euler_characteristic"]),
                               rtol=1e-4)
    # without aux the characteristic is the constant 2
    plain = losses.GaussBonnetLoss(gauss_bonnet_weight=1e-9)(
        bind_apply(model), torch.from_numpy(x), torch.from_numpy(y), 0)
    np.testing.assert_allclose(float(plain), got_value, rtol=1e-6)


def test_validation_needs_no_autograd():
    """Every loss of the family runs under no_grad (the trainer's validation)."""
    _, _, _, model, x, y = _setup(n=32)
    apply = bind_apply(model)
    with torch.no_grad():
        for cls in (losses.IGRLOSS, losses.IGRLOSSPCD, losses.RegularizedCustomSDFLoss,
                    losses.GaussBonnetLoss):
            value = cls()(apply, torch.from_numpy(x), torch.from_numpy(y), 0)
            assert value.shape == () and torch.isfinite(value), cls.__name__
