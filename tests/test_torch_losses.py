"""The port's supervised losses against the JAX package's on the same
network (JAX-initialised weights carried over), inputs and targets: the loss
value and its gradient with respect to every parameter, rtol 1e-5 (f32
summation order; the atol of 1e-6 of the largest gradient entry covers
entries that are sums of cancelling terms)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdf_representation_tpu.losses import losses as jax_losses
from sdf_representation_tpu.models import ImplicitNet as JaxImplicitNet
from sdf_representation_tpu_torch.convert import params_from_jax
from sdf_representation_tpu_torch.losses import losses
from sdf_representation_tpu_torch.models import ImplicitNet

torch.set_num_threads(2)

CASES = [
    ("MSELoss", {}),
    ("CustomSDFLoss", {"delta": 0.1}),
    ("CustomSDFLoss", {"delta": 0.03}),
    ("WeightedSmoothL2Loss", {"weight_factor": 0.5, "delta": 0.1}),
    ("WeightedSmoothL2Loss", {"weight_factor": 2.0, "delta": 0.05}),
    ("CombinedLoss", {"weight_factor": 0.5, "delta": 0.1, "alpha": 0.8}),
    ("CombinedLoss", {"weight_factor": 1.5, "delta": 0.2, "alpha": 0.3}),
]


def _pair(hidden=(48,) * 3, skip=(2,)):
    jm = JaxImplicitNet(d_in=3, hidden_dims=hidden, skip_in=skip, beta=100.0, radius_init=0.5)
    params = jm.init(jax.random.PRNGKey(0))
    tm = ImplicitNet(d_in=3, hidden_dims=hidden, skip_in=skip, beta=100.0, radius_init=0.5)
    tm.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    return jm, params, tm


def _batch(n=256, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    normals = x / np.linalg.norm(x, axis=1, keepdims=True)
    sdf = np.linalg.norm(x, axis=1, keepdims=True) - 0.5
    return x, np.concatenate([sdf, normals], axis=1).astype(np.float32)


@pytest.mark.parametrize("name,kwargs", CASES)
def test_loss_value_and_gradient_match_jax(name, kwargs):
    jm, params, tm = _pair()
    x, y = _batch()
    jloss = jax_losses.get_loss_class(name)(**kwargs)
    ref, ref_grads = jax.value_and_grad(
        lambda p: jloss(p, jm.apply, jnp.asarray(x), jnp.asarray(y), 0))(params)
    loss = losses.get_loss_class(name)(**kwargs)
    got = loss(tm, torch.from_numpy(x), torch.from_numpy(y), 0)
    assert got.shape == () and got.dtype == torch.float32
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-5)
    got.backward()
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, ref_grads))
    scale = max(float(v.abs().max()) for v in want.values())
    assert scale > 0
    for key, grad in want.items():
        np.testing.assert_allclose(tm.get_parameter(key).grad.numpy(), grad.numpy(),
                                   rtol=1e-5, atol=1e-6 * scale, err_msg=key)


def test_predictions_are_flat_not_broadcast():
    """A model returning (B, 1) must not broadcast against (B,) targets."""
    x, y = _batch(64)
    _, _, tm = _pair()
    column = lambda pts: tm(pts)[:, None]
    for name, kwargs in CASES:
        loss = losses.get_loss_class(name)(**kwargs)
        a = loss(tm, torch.from_numpy(x), torch.from_numpy(y), 0)
        b = loss(column, torch.from_numpy(x), torch.from_numpy(y), 0)
        assert torch.equal(a, b)


def test_registry_and_unported_family():
    assert set(losses.LOSS_REGISTRY) == {"MSELoss", "CustomSDFLoss", "WeightedSmoothL2Loss",
                                         "CombinedLoss"}
    for name in ("IGRLOSS", "IGRLOSSPCD", "RegularizedCustomSDFLoss", "GaussBonnetLoss"):
        assert name in jax_losses.LOSS_REGISTRY
        with pytest.raises(NotImplementedError, match="slice 3"):
            losses.get_loss_class(name)
    with pytest.raises(ValueError, match="Unsupported loss"):
        losses.get_loss_class("NoSuchLoss")

    class Zero:
        def __call__(self, model, x, y, epoch):
            return torch.zeros(())

    losses.register_loss("Zero", Zero)
    try:
        assert losses.get_loss_class("Zero") is Zero
    finally:
        del losses.LOSS_REGISTRY["Zero"]
