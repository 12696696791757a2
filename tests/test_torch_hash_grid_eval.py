"""The port's separable HashMLP grid evaluator (ops/hash_grid_eval.py) against
the JAX package's on the CPU, and against the port's own pointwise forward.

Tolerance: rtol 2e-5 / atol 2e-6, the JAX test's (tests/test_hash_grid.py):
the separable contractions and the pointwise corner sum round differently in
float32. The banded interpolation matrices and the corner volumes are the
JAX ones bit for bit. The x-slab evaluator (the giga extractor's) holds a
plane that two calls share to the same bits in both."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdf_representation_tpu.models.hash_mlp import HashMLP as JaxHashMLP
from sdf_representation_tpu.ops import hash_grid_eval as jhge
from sdf_representation_tpu_torch.convert import params_from_jax
from sdf_representation_tpu_torch.models import HashMLP
from sdf_representation_tpu_torch.ops import hash_grid_eval as hge
from sdf_representation_tpu_torch.ops.grid_eval import evaluate_grid

torch.set_num_threads(2)
TOL = dict(rtol=2e-5, atol=2e-6)
WIDE = dict(n_levels=4, log2_table_size=10, base_resolution=4, max_resolution=48, hidden_dim=32,
            num_layers=2)
HASHED = dict(n_levels=4, log2_table_size=8, base_resolution=4, max_resolution=40, hidden_dim=16,
              num_layers=2)
NO_XYZ = dict(n_levels=3, log2_table_size=10, base_resolution=4, max_resolution=16, hidden_dim=16,
              num_layers=3, include_xyz=False)


def _pair(kw, seed):
    jm = JaxHashMLP(**kw)
    params = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(seed)))
    # tables wider than the init's +-1e-4, so that the levels carry signal
    rng = np.random.default_rng(seed)
    params["tables"] = [rng.uniform(-0.5, 0.5, t.shape).astype(np.float32)
                        for t in params["tables"]]
    tm = HashMLP(**kw)
    tm.load_state_dict(params_from_jax(params, tm))
    return jm, params, tm


@pytest.mark.parametrize("kw,seed,n,slab_d", [
    (WIDE, 0, 17, 8), (WIDE, 0, 32, 32), (WIDE, 0, 24, 7),  # divisible, one slab, ragged tail
    (HASHED, 1, 21, 8), (NO_XYZ, 2, 16, 16)])
def test_separable_matches_jax_and_pointwise(kw, seed, n, slab_d):
    jm, params, tm = _pair(kw, seed)
    if kw is HASHED:  # the finest levels exceed the table and hash
        assert not tm.is_dense(3) and tm.is_dense(0)
    got = hge.hash_grid_eval(tm, n, slab_d=slab_d)
    assert got.shape == (n, n, n) and got.dtype == torch.float32
    want = np.asarray(jhge.hash_grid_eval(jm, jax.tree_util.tree_map(jnp.asarray, params), n,
                                          slab_d=slab_d))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(got.numpy(), evaluate_grid(tm, n).numpy(), **TOL)
    assert np.abs(want).max() > 1e-2


def test_weights_and_volumes_equal_jax():
    jm, params, tm = _pair(HASHED, 3)
    for n in (7, 33):
        for res in (4, 9, 40):
            np.testing.assert_array_equal(hge._axis_weights(n, res, "cpu").numpy(),
                                          np.asarray(jhge._axis_weights(n, res)))
    for level in range(4):
        res = tm.level_resolution(level)
        np.testing.assert_array_equal(
            hge._level_volume(tm, level, res).detach().numpy(),
            np.asarray(jhge._level_volume(jm, jnp.asarray(params["tables"][level]), res)))


def test_x_slabs_match_dense_with_bit_equal_seams():
    jm, params, tm = _pair(WIDE, 4)
    n = 24
    dense = hge.hash_grid_eval(tm, n).numpy()
    # [0, 10) and [9, 19): plane 9 is shared; sub 4 makes each call back up
    a = hge.hash_grid_eval_x_slab(tm, 0, 10, n, sub=4).numpy()
    b = hge.hash_grid_eval_x_slab(tm, 9, 10, n, sub=4).numpy()
    assert a.shape == b.shape == (10, n, n)
    np.testing.assert_array_equal(a[9], b[0])
    np.testing.assert_allclose(a, dense[:10], **TOL)
    np.testing.assert_allclose(b, dense[9:19], **TOL)
    whole = hge.hash_grid_eval_x_slab(tm, 0, n, n, sub=8).numpy()
    np.testing.assert_array_equal(whole[9], a[9])
    want = np.asarray(jhge.hash_grid_eval_x_slab(
        jm, jax.tree_util.tree_map(jnp.asarray, params), 9, 10, n, sub=4))
    np.testing.assert_allclose(b, want, **TOL)
