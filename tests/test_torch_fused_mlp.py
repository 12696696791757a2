"""The port's fused forward (plain path on the CPU) against the JAX
package's Pallas kernels in interpret mode, on the same weights.

f32 at the tolerance of tests/test_pallas_mlp.py (2e-5). bf16 rounds at the
same three places in both (coordinates, accumulator before the activation,
activation output), so the two differ only by f32 summation order, and
where that moves a sum across a bf16 rounding boundary. Measured on these
cases: at most 2.4e-7. BF16_TOL = 1e-3 leaves room for one such flip; the
JAX test allows bf16 0.05 against the f32 forward."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdf_representation_tpu.models import ImplicitNet as JaxImplicitNet
from sdf_representation_tpu.ops import pallas_mlp
from sdf_representation_tpu_torch.convert import params_from_jax
from sdf_representation_tpu_torch.models import ImplicitNet
from sdf_representation_tpu_torch.ops import fused_mlp

torch.set_num_threads(2)
TOL = 2e-5
BF16_TOL = 1e-3

DT = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _pair(skip, beta, hidden=(64,) * 4):
    jm = JaxImplicitNet(d_in=3, hidden_dims=hidden, skip_in=skip, beta=beta, radius_init=0.5)
    params = jm.init(jax.random.PRNGKey(0))
    tm = ImplicitNet(d_in=3, hidden_dims=hidden, skip_in=skip, beta=beta, radius_init=0.5)
    tm.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    return jm, params, tm


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("skip,beta", [((2,), 100.0), ((), 100.0), ((), 0.0), ((2,), 0.0)])
def test_fused_apply_matches_jax_kernel(skip, beta, dt):
    jdt, tdt = DT[dt]
    jm, params, tm = _pair(skip, beta)
    pts = np.random.default_rng(0).uniform(-1, 1, (300, 3)).astype(np.float32)
    ref = np.asarray(pallas_mlp.fused_apply(jm, params, pts, tile_p=128, compute_dtype=jdt,
                                            interpret=True))
    got = fused_mlp.fused_apply(tm, pts, compute_dtype=tdt).numpy()
    tol = TOL if dt == "f32" else BF16_TOL
    np.testing.assert_allclose(got, ref, rtol=tol, atol=tol)
    fused_mlp.reset_launches()
    assert set(fused_mlp.LAUNCHES.values()) == {0}  # the CPU path launches nothing


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_fused_grid_eval_matches_jax_kernel(dt):
    jdt, tdt = DT[dt]
    jm, params, tm = _pair((), 100.0, hidden=(32,) * 3)
    n = 16
    ref = np.asarray(pallas_mlp.fused_grid_eval(jm, params, n, tile_p=128, compute_dtype=jdt,
                                                interpret=True))
    got = fused_mlp.fused_grid_eval(tm, n, compute_dtype=tdt).numpy()
    assert got.shape == (n, n, n)
    tol = TOL if dt == "f32" else BF16_TOL
    np.testing.assert_allclose(got, ref, rtol=tol, atol=tol)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_prepare_fused_weights_matches_jax(dt):
    jdt, tdt = DT[dt]
    jm, params, tm = _pair((2,), 100.0)
    jw, jspec, jh = pallas_mlp.prepare_fused_weights(jm, params, jdt)
    tw, tspec, th = fused_mlp.prepare_fused_weights(tm, tdt)
    assert th == jh == 128
    assert tspec == tuple(kind for kind, _ in jspec) == ("first", "plain", "skip", "plain", "plain")
    assert len(tw) == len(jw) == 11  # skip layer split into W_top and W_bot
    for a, b in zip(tw, jw):
        assert a.dtype == (torch.float32 if a.shape[0] == 1 else tdt)
        np.testing.assert_array_equal(a.float().numpy(), np.asarray(b, np.float32))
    # the split lands on the concat boundary: layer 1 emits 64 - 3 = 61 columns
    w_top, w_bot = tw[4], tw[5]
    assert w_top.shape == (128, 128) and w_bot.shape == (128, 128)
    assert torch.count_nonzero(w_top[61:]) == 0 and torch.count_nonzero(w_bot[3:]) == 0
    np.testing.assert_array_equal(w_bot[:3, :64].float().numpy(),
                                  tm.lin2.weight.detach().to(tdt).float().numpy().T[61:])


def test_plain_point_order_does_not_change_results():
    """A point's value must not depend on its position in a chunk (the
    property the sparse evaluator's bitwise equality rests on)."""
    _, _, tm = _pair((2,), 100.0)
    net = fused_mlp.FusedNet(tm, torch.bfloat16)
    pts = torch.from_numpy(np.random.default_rng(2).uniform(-1, 1, (1000, 3)).astype(np.float32))
    perm = torch.randperm(1000, generator=torch.Generator().manual_seed(0))
    a = fused_mlp.fused_points(net, pts)
    b = fused_mlp.fused_points(net, pts[perm].contiguous())
    assert torch.equal(a[perm], b)


def test_wrappers_reject_bad_input():
    _, _, tm = _pair((2,), 100.0)
    net = fused_mlp.FusedNet(tm, torch.float32)
    with pytest.raises(ValueError):
        fused_mlp.fused_points(net, torch.zeros(10, 2))
    with pytest.raises(ValueError):
        fused_mlp.FusedNet(tm, torch.float16)


def test_plain_evaluate_grid_matches_jax():
    from sdf_representation_tpu.ops.grid_eval import evaluate_grid as jax_evaluate_grid
    from sdf_representation_tpu.ops.grid_eval import grid_coords as jax_grid_coords
    from sdf_representation_tpu_torch.ops.grid_eval import evaluate_grid, grid_coords

    jm, params, tm = _pair((2,), 100.0)
    ref = jax_evaluate_grid(jm.apply, params, 16, chunk=1000)
    got = evaluate_grid(tm, 16, chunk=1000).numpy()
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(grid_coords(9), jax_grid_coords(9))
    # the kernels' coordinates (-1 + step*i in f32) are the JAX evaluator's
    pts = fused_mlp.grid_points(9, 0, 9 ** 3, "cpu").numpy()
    i = np.stack(np.meshgrid(*[np.arange(9)] * 3, indexing="ij"), -1).reshape(-1, 3)
    np.testing.assert_array_equal(pts, np.float32(-1.0) + np.float32(2.0 / 8) * i.astype(np.float32))
