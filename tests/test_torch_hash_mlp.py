"""The port's HashMLP (models/hash_mlp.py) against the JAX package's on the CPU.

The model has a dense level and hashed ones (n_levels 4, T = 2^9,
resolutions 4, 8, 16, 32: (4+1)^3 = 125 <= 512 is indexed directly, the
others hash), so both index branches are on the path.

  * corner indices: the JAX ``encode``'s one gather index, captured from the
    function itself, equals the port's bit for bit, for float32 inputs and
    for bfloat16 inputs and tables (the trainer's cast); the hashed levels'
    indices also equal a numpy uint32 hash;
  * forward within 1e-6; the gradients of the tables and the MLP against
    ``jax.grad`` within 1e-5 of each tensor's largest entry (float32
    summation order);
  * ``convert.py`` round trip;
  * one training step through ``make_train_step`` against the JAX one on the
    same batch and weights (SGD, so the update is the gradient): float32
    within 1e-5 of each tensor's largest entry; bfloat16 is held by its
    distance from the float32 gradients, which must be JAX's bfloat16
    step's within a factor 1.5 (max and mean): bfloat16 sums in another
    order in each framework (the tables' scatter-add accumulates in
    bfloat16: ~10% of the largest entry at single entries in both), so the
    two bfloat16 steps are not compared with each other. The port's must also
    differ from float32 by at least a quarter of JAX's distance (it ran in
    bfloat16 at all).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sdf_representation_tpu.losses.losses import WeightedSmoothL2Loss as JaxLoss
from sdf_representation_tpu.models import hash_mlp as jax_hash_mlp
from sdf_representation_tpu.training import trainer as jax_trainer
from sdf_representation_tpu.training.trainer import _cast_bf16
from sdf_representation_tpu_torch.convert import params_from_jax, params_to_numpy
from sdf_representation_tpu_torch.losses.losses import WeightedSmoothL2Loss
from sdf_representation_tpu_torch.models import HashMLP
from sdf_representation_tpu_torch.training.trainer import make_train_step

torch.set_num_threads(2)
KW = dict(n_levels=4, log2_table_size=9, base_resolution=4, max_resolution=32, hidden_dim=16,
          num_layers=3)


def _pair(seed=0, spread=None):
    """The JAX model and params (numpy), and the port's with the same
    weights; ``spread`` redraws the tables uniform in +-spread so that the
    features carry signal."""
    jm = jax_hash_mlp.HashMLP(**KW)
    params = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(seed)))
    if spread is not None:
        rng = np.random.default_rng(seed)
        params["tables"] = [rng.uniform(-spread, spread, t.shape).astype(np.float32)
                            for t in params["tables"]]
    tm = HashMLP(**KW)
    tm.load_state_dict(params_from_jax(params, tm))
    return jm, params, tm


def _points(n=2048, seed=1):
    x = np.random.default_rng(seed).uniform(-1.05, 1.05, (n, 3)).astype(np.float32)
    x[:4] = [[-1, -1, -1], [1, 1, 1], [0, 0, 0], [0.5, -0.25, 1]]  # lattice points and edges
    return x


def _jax_gather_index(jm, params, x, monkeypatch):
    """The index JAX's ``encode`` gathers the stacked tables with."""
    seen = []

    class Recorder:
        def __getattr__(self, name):
            return getattr(jnp, name)

        @staticmethod
        def take(a, idx, axis=None):
            seen.append(np.asarray(idx))
            return jnp.take(a, idx, axis=axis)

    monkeypatch.setattr(jax_hash_mlp, "jnp", Recorder())
    jm.encode(params, x)
    (idx,) = seen
    return idx


def test_levels_cover_both_index_branches():
    tm = HashMLP(**KW)
    jm = jax_hash_mlp.HashMLP(**KW)
    assert [tm.level_resolution(lv) for lv in range(4)] == [jm.level_resolution(lv) for lv in range(4)]
    assert [tm.is_dense(lv) for lv in range(4)] == [True, False, False, False]
    assert tm.growth == jm.growth and tm.table_size == jm.table_size == 512


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_corner_indices_equal_jax(dtype, monkeypatch):
    jm, params, tm = _pair()
    x = _points()
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jx = jnp.asarray(x)
    tx = torch.from_numpy(x)
    if dtype == "bfloat16":
        jparams, jx, tx = _cast_bf16(jparams), jx.astype(jnp.bfloat16), tx.to(torch.bfloat16)
    want = _jax_gather_index(jm, jparams, jx, monkeypatch)
    idx, w = tm.corner_indices(tx)
    assert w.dtype == tx.dtype
    np.testing.assert_array_equal(idx.reshape(-1).numpy(), want)
    # the hashed levels against numpy's uint32 arithmetic (wraparound), in
    # float32 as the encoder computes the corners
    if dtype == "float32":
        T = tm.table_size
        x01 = np.clip((x + np.float32(1)) * np.float32(0.5), 0, 1)
        for level in range(1, 4):
            res = tm.level_resolution(level)
            p0 = np.floor(x01 * np.float32(res)).astype(np.int64)
            c = np.clip(p0 + 1, 0, res).astype(np.uint32)  # the (1, 1, 1) corner
            with np.errstate(over="ignore"):
                h = (c[:, 0] * np.uint32(1)) ^ (c[:, 1] * np.uint32(2654435761)) \
                    ^ (c[:, 2] * np.uint32(805459861))
            np.testing.assert_array_equal(idx[:, level, 7].numpy(), (h % np.uint32(T)) + level * T)


def test_forward_and_gradients_match_jax():
    jm, params, tm = _pair(spread=0.1)
    x = _points()
    target = np.random.default_rng(2).normal(size=len(x)).astype(np.float32)
    want = np.asarray(jm.apply(jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x)))
    got = tm(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1e-6)

    grads = jax.grad(lambda p: jnp.mean((jm.apply(p, jnp.asarray(x)) - target) ** 2))(
        jax.tree_util.tree_map(jnp.asarray, params))
    torch.mean((got - torch.from_numpy(target)) ** 2).backward()
    want_g = params_from_jax(jax.tree_util.tree_map(np.asarray, grads), tm)
    for name, p in tm.named_parameters():
        ref = want_g[name].numpy()
        assert np.abs(p.grad.numpy() - ref).max() <= 1e-5 * np.abs(ref).max(), name
    assert np.count_nonzero(tm.tables.grad.numpy()) > 1000


def test_convert_round_trip():
    _, params, tm = _pair(seed=3)
    back = params_to_numpy(tm)
    assert len(back["tables"]) == 4 and len(back["mlp"]) == 3
    for a, b in zip(back["tables"], params["tables"]):
        np.testing.assert_array_equal(a, b)
    for la, lb in zip(back["mlp"], params["mlp"]):
        assert sorted(la) == sorted(lb) == ["b", "w"]
        for k in la:
            np.testing.assert_array_equal(la[k], lb[k])
    again = HashMLP(**KW)
    again.load_state_dict(params_from_jax(back, again))
    assert all(torch.equal(a, b) for a, b in zip(again.state_dict().values(),
                                                  tm.state_dict().values()))


def _step_moves(precision, lr=1e-2):
    """(loss, (p - p_new) / lr per parameter) of one SGD step on the same
    batch and weights, for JAX and for the port (both moved in float32,
    so the division rounds alike)."""
    jm, params, tm = _pair(spread=0.1)
    rng = np.random.default_rng(4)
    x = rng.uniform(-1, 1, (512, 3)).astype(np.float32)
    r = np.linalg.norm(x, axis=1, keepdims=True)
    y = np.concatenate([r - 0.5, x / r], axis=1).astype(np.float32)
    opt = optax.sgd(lr)
    trainable = {"params": jax.tree_util.tree_map(jnp.asarray, params), "aux": {}}
    jstep = jax.jit(jax_trainer.make_train_step(jm, JaxLoss(), opt, matmul_precision=precision))
    new, _, jloss = jstep(trainable, opt.init(trainable), jnp.asarray(x), jnp.asarray(y),
                          jax.random.PRNGKey(0), 0)
    jmoved = params_from_jax(jax.tree_util.tree_map(np.asarray, new["params"]), tm)
    before = {n: p.detach().clone() for n, p in tm.named_parameters()}
    step = make_train_step(tm, WeightedSmoothL2Loss(), torch.optim.SGD(tm.parameters(), lr=lr),
                           precision)
    loss = step(torch.from_numpy(x), torch.from_numpy(y), 0)
    moves = {n: ((before[n] - p.detach()) / lr).double() for n, p in tm.named_parameters()}
    jmoves = {n: ((before[n] - jmoved[n]) / lr).double() for n in moves}
    return (float(jloss), jmoves), (float(loss), moves)


def test_train_step_float32_matches_jax():
    (jloss, jgrads), (loss, grads) = _step_moves(None)
    assert loss == pytest.approx(jloss, rel=1e-6)
    for name, g in grads.items():
        ref = jgrads[name].double()
        assert (g - ref).abs().max() <= 1e-5 * ref.abs().max(), name


def test_train_step_bfloat16_follows_jax():
    (_, f32), _ = _step_moves(None)
    (jloss, jgrads), (loss, grads) = _step_moves("bfloat16")
    assert loss == pytest.approx(jloss, rel=2e-3)
    for name, g in grads.items():
        ref = f32[name].double()
        scale = ref.abs().max()
        ours, theirs = (g - ref).abs() / scale, (jgrads[name].double() - ref).abs() / scale
        assert ours.max() <= 1.5 * theirs.max() + 1e-6, name
        assert ours.mean() <= 1.5 * theirs.mean() + 1e-7, name
        assert ours.max() >= 0.25 * theirs.max(), name
