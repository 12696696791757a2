"""The port's sharded grid evaluators (TPU kernels 10 and 11) against the
JAX package's on its eight virtual CPU devices, and against the port's own
single-device evaluators.

The port's mesh is the CPU listed 1, 2, 4 or 8 times; there the wrappers
take their plain versions (fused_grid_tiles_plain, fused_blocks_plain). The
JAX side runs its Pallas kernels in interpret mode (use_pallas=True,
interpret=True) or its XLA path (use_pallas=False), as
tests/test_sharded_eval.py does. Tolerances are that file's: dense rtol 2e-5
/ atol 1e-5, sparse rtol 2e-5 / atol 2e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdf_representation_tpu.models import ImplicitNet as JaxImplicitNet
from sdf_representation_tpu.ops import sharded_eval as jax_sharded
from sdf_representation_tpu.parallel.mesh import get_mesh as jax_get_mesh
from sdf_representation_tpu_torch.convert import params_from_jax
from sdf_representation_tpu_torch.models import ImplicitNet
from sdf_representation_tpu_torch.ops import fused_mlp as fm
from sdf_representation_tpu_torch.ops import sharded_eval, sparse_grid
from tests.test_sparse_grid import _steep_plane_params

torch.set_num_threads(2)
F32 = torch.float32


def _pair(radius_init=None, hidden=(32,) * 3, skip=(2,)):
    kw = {} if radius_init is None else {"radius_init": radius_init}
    jm = JaxImplicitNet(d_in=3, hidden_dims=hidden, skip_in=skip, beta=100.0, **kw)
    params = jm.init(jax.random.PRNGKey(0))
    tm = ImplicitNet(d_in=3, hidden_dims=hidden, skip_in=skip, beta=100.0, **kw)
    tm.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    return jm, params, tm


@pytest.fixture(scope="module")
def grid_pair():
    return _pair()


@pytest.fixture(scope="module")
def sdf_pair():
    # geometric init: f ~ |x| - 0.5, a field the sparse path finds sparse
    return _pair(radius_init=0.5)


def _mesh(k):
    return ("cpu",) * k


# ---------------------------------------------------------------------------
# kernel 10: the dense grid, a slab of tiles per shard
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,n_dev", [(16, 4), (16, 1), (16, 2), (16, 8), (15, 8)],
                         ids=["n16x4", "n16x1", "n16x2", "n16x8", "n15x8"])
def test_sharded_grid_against_jax_pallas(grid_pair, n, n_dev):
    """n = 15: 3,375 points in 27 tiles of 128, padded to 32 over 8
    devices; the padded tail must not reach the volume."""
    jm, params, tm = grid_pair
    want = np.asarray(jax_sharded.sharded_grid_eval(
        jm, params, n, jax_get_mesh(n_dev), tile_p=128, use_pallas=True, interpret=True,
        compute_dtype=jnp.float32))
    got = sharded_eval.sharded_grid_eval(tm, n, _mesh(n_dev), tile_p=128, compute_dtype=F32)
    assert got.shape == (n, n, n) and got.dtype == F32 and got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=1e-5)
    # every shard's tiles run the same plain function as one launch
    torch.testing.assert_close(got, fm.fused_grid_eval(tm, n, compute_dtype=F32), rtol=0, atol=0)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_grid_tiles_are_slices_of_the_whole_grid(grid_pair, dt):
    """fused_grid_tiles(base, count) holds flat indices [64 base, 64 (base +
    count)); past n^3 it is zero (the kernel leaves it unwritten)."""
    _, _, tm = grid_pair
    n = 13
    net = fm.FusedNet(tm, dt)
    whole = fm.fused_grid(net, n)
    tiles = -(-n ** 3 // fm.TILE_P)
    for base, count in ((0, tiles), (5, 7), (tiles - 3, 5)):
        part = fm.fused_grid_tiles(net, n, base, count)
        assert part.shape == (count * fm.TILE_P,)
        lo = base * fm.TILE_P
        live = min(n ** 3, lo + part.numel()) - lo
        torch.testing.assert_close(part[:live], whole[lo:lo + live], rtol=0, atol=0)
        assert not part[live:].any()


def test_slab_plan_follows_the_jax_rule():
    # n_tiles = round_up(ceil(n^3 / tile_p), n_dev); tiles_local tiles of tile_p per device
    assert sharded_eval.slab_tiles(15, 8, 128) == 4 * 2   # 27 -> 32 tiles, 4 of 128 each
    assert sharded_eval.slab_tiles(16, 4, 1024) == 1 * 16
    assert sharded_eval.slab_tiles(256, 2, 1024) == 8192 * 16
    with pytest.raises(ValueError):
        sharded_eval.slab_tiles(16, 2, 100)


# ---------------------------------------------------------------------------
# kernel 11: the sparse evaluator, a slice of the active list per shard
# ---------------------------------------------------------------------------

def test_sparse_sharded_against_jax_pallas(sdf_pair):
    jm, params, tm = sdf_pair
    n = 32  # nb = 4 over 4 devices: one block-plane each
    want, want_count = jax_sharded.sparse_sharded_grid_eval(
        jm, params, n, jax_get_mesh(4), compute_dtype=jnp.float32, use_pallas=True,
        interpret=True, eps=1e-4, return_count=True)
    got, count = sharded_eval.sparse_sharded_grid_eval(tm, n, _mesh(4), compute_dtype=F32,
                                                       eps=1e-4, return_count=True)
    assert count == want_count and 0 < count < (n // 8) ** 3
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("n_dev", [1, 2, 8])
def test_sparse_sharded_against_jax_xla(sdf_pair, n_dev):
    jm, params, tm = sdf_pair
    n = 64  # nb = 8 splits over 1, 2 and 8 devices
    want, want_count = jax_sharded.sparse_sharded_grid_eval(
        jm, params, n, jax_get_mesh(n_dev), compute_dtype=jnp.float32, use_pallas=False,
        eps=1e-4, return_count=True)
    got, count = sharded_eval.sparse_sharded_grid_eval(tm, n, _mesh(n_dev), compute_dtype=F32,
                                                       eps=1e-4, return_count=True)
    assert count == want_count and 0 < count < (n // 8) ** 3
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)
    # and the port's single-device sparse evaluator, the same plain block rows
    ref, ref_count = sparse_grid.sparse_grid_eval(tm, n, compute_dtype=F32, eps=1e-4,
                                                  return_count=True)
    assert count == ref_count
    torch.testing.assert_close(got, ref, rtol=0, atol=0)


def test_sparse_sharded_budget_overflow_retries(sdf_pair, capsys):
    _, _, tm = sdf_pair
    n, n_dev = 64, 2
    sharded_eval._KMAX_CACHE_SHARDED.clear()
    got, count = sharded_eval.sparse_sharded_grid_eval(tm, n, _mesh(n_dev), k_max_frac=0.01,
                                                       compute_dtype=F32, eps=1e-4,
                                                       return_count=True)
    first = -(-max(2 * n_dev, int(8 ** 3 * 0.01)) // (2 * n_dev)) * (2 * n_dev)
    (settled,) = sharded_eval._KMAX_CACHE_SHARDED.values()
    assert first < count <= settled and settled % (2 * n_dev) == 0  # it grew and settled
    ref = sparse_grid.sparse_grid_eval(tm, n, compute_dtype=F32, eps=1e-4)
    torch.testing.assert_close(got, ref, rtol=0, atol=0)
    assert "re-evaluating densely" not in capsys.readouterr().out


def test_sparse_sharded_rejects_indivisible_block_grid(sdf_pair):
    _, _, tm = sdf_pair
    with pytest.raises(ValueError, match="split over 2 devices"):
        sharded_eval.sparse_sharded_grid_eval(tm, 24, _mesh(2))  # nb = 3 over 2 devices
    with pytest.raises(ValueError, match="divisible by block"):
        sharded_eval.sparse_sharded_grid_eval(tm, 30, _mesh(2))
    with pytest.raises(ValueError, match="on_violation"):
        sharded_eval.sparse_sharded_grid_eval(tm, 32, _mesh(2), on_violation="ignore")


def test_sharded_steep_field_exact_by_construction():
    """The steep plane f = 20 x0 (tests/test_sparse_grid.py) is selected by
    the adaptive margin outright: on_violation="error" does not raise, and
    the zero shell equals the dense sharded evaluation exactly."""
    jm = JaxImplicitNet(d_in=3, hidden_dims=(8,), skip_in=(), beta=100.0)
    params = _steep_plane_params(jm)
    tm = ImplicitNet(d_in=3, hidden_dims=(8,), skip_in=(), beta=100.0)
    tm.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    vol = sharded_eval.sparse_sharded_grid_eval(tm, 64, _mesh(8), compute_dtype=F32,
                                                on_violation="error").reshape(-1)
    ref = sharded_eval.sharded_grid_eval(tm, 64, _mesh(8), compute_dtype=F32).reshape(-1)
    want = np.asarray(jax_sharded.sparse_sharded_grid_eval(
        jm, params, 64, jax_get_mesh(8), compute_dtype=jnp.float32, use_pallas=False,
        on_violation="error")).reshape(-1)
    shell = ref.abs() < 20.0 * (2.0 / 63) * 2
    assert shell.any()
    torch.testing.assert_close(vol[shell], ref[shell], rtol=0, atol=0)
    np.testing.assert_allclose(vol.numpy(), want, rtol=2e-5, atol=2e-5)


def test_active_slices_cover_the_list_once():
    """Shard d gets ids [d k_loc, (d + 1) k_loc) and count_loc = clamp(count
    - d k_loc, 0, k_loc), an int32 one-element tensor."""
    ids = torch.arange(12, dtype=torch.int32)
    count = torch.tensor([7], dtype=torch.int32)
    parts = [sharded_eval.active_slice(ids, count, d, 4) for d in range(4)]
    assert [c.item() for _, c in parts] == [3, 3, 1, 0]
    assert all(c.dtype == torch.int32 and c.shape == (1,) for _, c in parts)
    torch.testing.assert_close(torch.cat([i for i, _ in parts]), ids)
