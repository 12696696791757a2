"""The port's differential operators against the JAX package's.

Same weights (JAX init carried over through ``convert.params_from_jax``) and
the same numpy-seeded points through ``sdf_representation_tpu.ops.diffops``
and ``sdf_representation_tpu_torch.ops.diffops`` in float32 on the CPU.
Tolerances: rtol = atol = 2e-5 for values and gradients (the limit of
tests/test_pallas_igr.py), 1e-4 for Hessians and curvature, whose second
derivatives carry a factor beta = 100 per layer."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdf_representation_tpu.models import ImplicitNet as JaxImplicitNet
from sdf_representation_tpu.ops import diffops as jax_diffops
from sdf_representation_tpu_torch.convert import params_from_jax
from sdf_representation_tpu_torch.models import ImplicitNet
from sdf_representation_tpu_torch.ops import diffops

torch.set_num_threads(2)
CASES = [((2,), 100.0), ((), 100.0), ((2,), 0.0)]
IDS = ["skip_softplus", "noskip_softplus", "skip_relu_tanh"]


def _setup(skip, beta, n=200, seed=0):
    jm = JaxImplicitNet(d_in=3, hidden_dims=(64,) * 4, skip_in=skip, beta=beta)
    params = jm.init(jax.random.PRNGKey(seed))
    model = ImplicitNet(d_in=3, hidden_dims=(64,) * 4, skip_in=skip, beta=beta)
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    x = np.random.default_rng(seed).uniform(-1, 1, (n, 3)).astype(np.float32)
    return jm, params, model, x


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("skip,beta", CASES, ids=IDS)
def test_implicitnet_value_and_grad(skip, beta):
    jm, params, model, x = _setup(skip, beta)
    f_ref, g_ref = jax_diffops.implicitnet_value_and_grad(jm, params, jnp.asarray(x))
    with torch.no_grad():  # needs no autograd graph on x
        f, g = diffops.implicitnet_value_and_grad(model, torch.from_numpy(x))
    _close(f, f_ref, 2e-5)
    _close(g, g_ref, 2e-5)
    # the module's own forward is the same function
    _close(model(torch.from_numpy(x)), f_ref, 2e-5)


@pytest.mark.parametrize("skip,beta", CASES, ids=IDS)
def test_compute_gradient_and_the_generic_paths(skip, beta):
    jm, params, model, x = _setup(skip, beta, n=64)
    g_ref = jax_diffops.compute_gradient(jm.apply, params, jnp.asarray(x))
    xt = torch.from_numpy(x)
    _close(diffops.compute_gradient(model, xt), g_ref, 2e-5)
    _close(diffops.compute_normal(model, xt), g_ref[:, -3:], 2e-5)
    f, g = diffops.sdf_and_gradient(model, xt)
    _close(g, g_ref, 2e-5)
    _close(f, jm.apply(params, jnp.asarray(x)), 2e-5)
    # no fast-path hook on the bare module: one forward-mode pass per coordinate
    f, g = diffops.sdf_and_gradient_fwd(model, xt)
    _close(g, g_ref, 2e-5)

    def hooked(x):
        return model(x)

    hooked._implicitnet_fast = lambda x: ("fast", x.shape)
    assert diffops.sdf_and_gradient_fwd(hooked, xt) == ("fast", xt.shape)


@pytest.mark.parametrize("skip,beta", CASES, ids=IDS)
def test_compute_hessian(skip, beta):
    jm, params, model, x = _setup(skip, beta, n=32)
    ref = jax_diffops.compute_hessian(jm.apply, params, jnp.asarray(x))
    with torch.no_grad():  # torch.func transforms ignore an outer no_grad
        got = diffops.compute_hessian(model, torch.from_numpy(x))
    assert got.shape == (32, 3, 3)
    scale = max(1.0, float(np.abs(np.asarray(ref)).max()))
    np.testing.assert_allclose(got.numpy() / scale, np.asarray(ref) / scale, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("skip,beta", CASES, ids=IDS)
def test_compute_gaussian_curvature(skip, beta):
    jm, params, model, x = _setup(skip, beta, n=32)
    ref = np.asarray(jax_diffops.compute_gaussian_curvature(jm.apply, params, jnp.asarray(x)))
    got = diffops.compute_gaussian_curvature(model, torch.from_numpy(x))
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(got.detach().numpy() / scale, ref / scale, rtol=1e-4, atol=1e-4)
    if beta > 0:  # third order: the curvature trains the parameters
        got.sum().backward()
        grads = {name: p.grad for name, p in model.named_parameters()}
        assert grads.pop("lin4.bias") is None  # derivatives of f do not see the last bias
        assert all(g is not None and torch.isfinite(g).all() and g.abs().max() > 0
                   for g in grads.values())
