"""The port's sparse evaluator: sparse == dense bit for bit on the active
blocks and identical meshes (the port's own version of
tests/test_sparse_grid.py), and agreement with the JAX evaluator."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdf_representation_tpu.models import ImplicitNet as JaxImplicitNet
from sdf_representation_tpu.ops import sparse_grid as jax_sparse
from sdf_representation_tpu_torch.convert import params_from_jax
from sdf_representation_tpu_torch.models import ImplicitNet
from sdf_representation_tpu_torch.ops import sparse_grid
from sdf_representation_tpu_torch.ops.fused_mlp import fused_grid_eval
from sdf_representation_tpu_torch.ops.marching import marching_cubes

torch.set_num_threads(2)


def _pair(skip=(2,), hidden=(64,) * 4, seed=0):
    jm = JaxImplicitNet(d_in=3, hidden_dims=hidden, skip_in=skip, beta=100.0, radius_init=0.5)
    params = jm.init(jax.random.PRNGKey(seed))
    tm = ImplicitNet(d_in=3, hidden_dims=hidden, skip_in=skip, beta=100.0, radius_init=0.5)
    tm.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    return jm, params, tm


def _blocks(vol, nb, block):
    return np.asarray(vol).reshape(nb, block, nb, block, nb, block).transpose(0, 2, 4, 1, 3, 5)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("skip", [(2,), ()])
def test_sparse_matches_dense_on_shell_and_mesh(skip, dt):
    _, _, tm = _pair(skip=skip)
    n, block = 64, 8
    dense = fused_grid_eval(tm, n, compute_dtype=dt).numpy()
    sparse, count = sparse_grid.sparse_grid_eval(tm, n, block=block, k_max_frac=0.5,
                                                 compute_dtype=dt, eps=1e-4, return_count=True)
    sparse = sparse.numpy()
    nb = n // block
    assert 0 < count < nb ** 3  # genuinely sparse
    _, mask, viol = sparse_grid.coarse_and_certificate(tm, n, block, 1.5, 1e-4)
    assert int(viol) == 0 and int(mask.sum()) == count
    active = mask.numpy().reshape(nb, nb, nb)
    np.testing.assert_array_equal(_blocks(sparse, nb, block)[active],
                                  _blocks(dense, nb, block)[active])
    assert np.all(np.sign(sparse[dense != 0]) * np.sign(dense[dense != 0]) >= 0)
    sp = 2.0 / (n - 1)
    vd, fd = marching_cubes(dense, 0.0, (sp,) * 3, (-1.0,) * 3)
    vs, fs = marching_cubes(sparse, 0.0, (sp,) * 3, (-1.0,) * 3)
    assert len(fd) > 100
    np.testing.assert_array_equal(fs, fd)
    np.testing.assert_array_equal(vs, vd)


def test_sparse_agrees_with_jax_evaluator():
    jm, params, tm = _pair()
    n, block = 64, 8
    jvol, jcount = jax_sparse.sparse_grid_eval(jm, params, n, block=block, k_max_frac=0.5,
                                               compute_dtype=jnp.float32, interpret=True,
                                               eps=1e-4, return_count=True)
    tvol, tcount = sparse_grid.sparse_grid_eval(tm, n, block=block, k_max_frac=0.5,
                                                compute_dtype=torch.float32, eps=1e-4,
                                                return_count=True)
    assert tcount == jcount
    jc, jmask, _ = jax_sparse.coarse_and_certificate(jm, params, n, block, 1.5, 1e-4)
    tc, tmask, _ = sparse_grid.coarse_and_certificate(tm, n, block, 1.5, 1e-4)
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    np.testing.assert_allclose(
        sparse_grid.adaptive_threshold(tc, n, block, 1.5, 1e-4).numpy(),
        np.asarray(jax_sparse.adaptive_threshold(jc, n, block, 1.5, 1e-4)), rtol=0, atol=1e-6)
    nb = n // block
    both = tmask.numpy().reshape(nb, nb, nb)
    np.testing.assert_allclose(_blocks(tvol.numpy(), nb, block)[both],
                               _blocks(np.asarray(jvol), nb, block)[both], rtol=2e-5, atol=2e-5)


def test_sparse_budget_overflow_retries():
    _, _, tm = _pair()
    n = 32
    vol, count = sparse_grid.sparse_grid_eval(tm, n, k_max_frac=0.02, eps=1e-4,
                                              compute_dtype=torch.float32, return_count=True)
    dense = fused_grid_eval(tm, n, compute_dtype=torch.float32).numpy()
    sp = 2.0 / (n - 1)
    vd, fd = marching_cubes(dense, 0.0, (sp,) * 3, (-1.0,) * 3)
    vs, fs = marching_cubes(vol.numpy(), 0.0, (sp,) * 3, (-1.0,) * 3)
    np.testing.assert_array_equal(fs, fd)
    np.testing.assert_array_equal(vs, vd)


def test_sparse_rejects_indivisible_n():
    _, _, tm = _pair()
    with pytest.raises(ValueError):
        sparse_grid.sparse_grid_eval(tm, 60, block=8)


def test_certificate_counts_sub_block_misses():
    nb = 4
    coarse = np.full((nb, nb, nb), 5.0, np.float32)
    coarse[2:] = -5.0
    mask = np.zeros((nb, nb, nb), bool)
    c, m = torch.from_numpy(coarse.reshape(-1)), torch.from_numpy(mask.reshape(-1))
    assert int(sparse_grid.certificate_violations(c, m, nb)) == nb * nb
    assert int(jax_sparse.certificate_violations(jnp.asarray(c.numpy()),
                                                 jnp.asarray(m.numpy()), nb)) == nb * nb
    mask[1] = True
    assert int(sparse_grid.certificate_violations(c, torch.from_numpy(mask.reshape(-1)), nb)) == 0


def test_active_threshold_matches_jax():
    assert sparse_grid.active_threshold(256, 8, 1.5, 0.01) == jax_sparse.active_threshold(
        256, 8, 1.5, 0.01)


def test_budget_cache_oversize_is_harmless():
    """The k_max cache is keyed on the architecture, so a second net of the
    same shape reuses (and may over-size) the first one's budget; the early
    exit and the dropped rows must keep the result exact."""
    _, _, tm = _pair(hidden=(16,) * 2, skip=(1,))
    n = 64
    _, count = sparse_grid.sparse_grid_eval(tm, n, compute_dtype=torch.float32,
                                            return_count=True)
    assert count < (n // 8) ** 3 // 2  # sparse, so the budget was cached
    other = ImplicitNet(d_in=3, hidden_dims=(16,) * 2, skip_in=(1,), beta=100.0)
    other.load_state_dict({k: v * 0.5 for k, v in tm.state_dict().items()})
    assert other.arch == tm.arch
    keys = [k for k in sparse_grid._KMAX_CACHE if k[0] == tm.arch and k[1] == n]
    assert keys
    v2 = sparse_grid.sparse_grid_eval(other, n, compute_dtype=torch.float32).reshape(-1)
    ref = fused_grid_eval(other, n, compute_dtype=torch.float32).reshape(-1)
    near = ref.abs() < 0.05
    assert near.any()
    assert torch.equal(v2[near], ref[near])


def test_adaptive_margin_selects_steep_field_by_construction():
    """f = 20 * x0 (local Lipschitz 20): the measured margin widens the
    selection, so on_violation='error' does not raise and the whole zero
    shell is refined exactly (tests/test_sparse_grid.py's steep plane)."""
    tm = ImplicitNet(d_in=3, hidden_dims=(8,), skip_in=(), beta=100.0)
    slope, offset = 20.0, 4.0
    with torch.no_grad():
        for p in tm.parameters():
            p.zero_()
        tm.lin0.weight[0, 0] = 1.0
        tm.lin0.bias[0] = offset
        tm.lin1.weight[0, 0] = slope
        tm.lin1.bias[0] = -slope * offset
        probe = tm(torch.tensor([[0.1, 0.3, -0.2], [-0.4, 0.0, 0.9]]))
    np.testing.assert_allclose(probe.numpy(), [2.0, -8.0], atol=1e-4)
    vol = sparse_grid.sparse_grid_eval(tm, 32, compute_dtype=torch.float32,
                                       on_violation="error").reshape(-1)
    dense = fused_grid_eval(tm, 32, compute_dtype=torch.float32).reshape(-1)
    shell = dense.abs() < slope * (2.0 / 31) * 2
    assert shell.any()
    assert torch.equal(vol[shell], dense[shell])
