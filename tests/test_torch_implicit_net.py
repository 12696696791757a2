"""The port's torch ImplicitNet against the JAX ImplicitNet on the same
(converted) weights, f32 at the tolerance of tests/test_pallas_mlp.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdf_representation_tpu.export.torch_import import import_torch_state_dict
from sdf_representation_tpu.models import ImplicitNet as JaxImplicitNet
from sdf_representation_tpu_torch.convert import params_from_jax, params_to_numpy
from sdf_representation_tpu_torch.models import ImplicitNet, ImplicitNetCompatible

torch.set_num_threads(2)
TOL = 2e-5


def _pair(skip, beta, lipschitz=False, hidden=(64,) * 4, seed=0):
    jm = JaxImplicitNet(d_in=3, hidden_dims=hidden, skip_in=skip, beta=beta,
                        radius_init=0.5, lipschitz=lipschitz)
    params = jm.init(jax.random.PRNGKey(seed))
    if lipschitz:
        # shrink the bounds so the row scaling actually bites
        params = {"layers": [dict(l, c=l["c"] - 1.0) for l in params["layers"]]}
    tm = ImplicitNet(d_in=3, hidden_dims=hidden, skip_in=skip, beta=beta,
                     radius_init=0.5, lipschitz=lipschitz)
    tm.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    return jm, params, tm


@pytest.mark.parametrize(
    "skip,beta,lipschitz",
    [((2,), 100.0, False), ((2,), 0.0, False), ((), 100.0, False), ((), 0.0, False),
     ((2,), 100.0, True)],
)
def test_forward_matches_jax(skip, beta, lipschitz):
    jm, params, tm = _pair(skip, beta, lipschitz)
    pts = np.random.default_rng(0).uniform(-1, 1, (500, 3)).astype(np.float32)
    ref = np.asarray(jm.apply(params, jnp.asarray(pts)))
    with torch.no_grad():
        got = tm(torch.from_numpy(pts)).numpy()
    assert got.shape == (500,)
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)


def test_lipschitz_bound_and_export_match_jax():
    jm, params, tm = _pair((2,), 100.0, lipschitz=True)
    np.testing.assert_allclose(float(tm.lipschitz_bound().detach()),
                               float(jm.lipschitz_bound(params)), rtol=1e-5)
    exp = jm.export_params(params)
    sd = tm.export_params()
    for i, layer in enumerate(exp["layers"]):
        np.testing.assert_allclose(sd[f"lin{i}.weight"].numpy().T, np.asarray(layer["w"]),
                                   rtol=1e-6, atol=1e-7)


def test_state_dict_reads_back_through_jax_importer():
    jm, params, tm = _pair((2,), 100.0)
    back = import_torch_state_dict(tm.state_dict())
    pts = np.random.default_rng(1).uniform(-1, 1, (64, 3)).astype(np.float32)
    np.testing.assert_allclose(np.asarray(jm.apply(back, jnp.asarray(pts))),
                               np.asarray(jm.apply(params, jnp.asarray(pts))), rtol=0, atol=0)
    roundtrip = params_to_numpy(tm)
    for a, b in zip(roundtrip["layers"], params["layers"]):
        np.testing.assert_array_equal(a["w"], np.asarray(b["w"]))
        np.testing.assert_array_equal(a["b"], np.asarray(b["b"]))


def test_geometric_init_shapes_and_bias():
    gen = torch.Generator().manual_seed(3)
    tm = ImplicitNet(d_in=3, hidden_dims=(32,) * 4, skip_in=(2,), radius_init=0.7,
                     generator=gen)
    shapes = [tuple(getattr(tm, f"lin{i}").weight.shape[::-1]) for i in range(5)]
    assert shapes == list(JaxImplicitNet(d_in=3, hidden_dims=(32,) * 4,
                                         skip_in=(2,)).layer_shapes())
    assert shapes[1] == (32, 29)  # feeds the skip: shrinks by d_in
    np.testing.assert_array_equal(tm.lin4.bias.detach().numpy(), np.float32([-0.7]))
    np.testing.assert_allclose(tm.lin4.weight.detach().numpy(), np.sqrt(np.pi) / np.sqrt(32),
                               atol=1e-4)
    # geometric init: f ~ |x| - radius, negative inside, positive far out
    with torch.no_grad():
        f = tm(torch.tensor([[0.0, 0.0, 0.0], [1.0, 1.0, 1.0]]))
    assert f[0] < 0 < f[1]
    # the torch-default init draws from the generator too: same seed, same weights
    a = ImplicitNet(hidden_dims=(16,) * 2, geometric_init=False,
                    generator=torch.Generator().manual_seed(5))
    b = ImplicitNet(hidden_dims=(16,) * 2, geometric_init=False,
                    generator=torch.Generator().manual_seed(5))
    assert torch.equal(a.lin0.weight, b.lin0.weight)
    assert float(a.lin0.weight.abs().max()) <= 1 / np.sqrt(3)


def test_compatible_alias_defaults_to_beta_99():
    net = ImplicitNetCompatible(hidden_dims=(16,) * 2)
    assert isinstance(net, ImplicitNet) and net.beta == 99.0
