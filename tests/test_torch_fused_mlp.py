"""The port's fused forward (plain path on the CPU) against the JAX
package's Pallas kernels in interpret mode, on the same weights.

f32 at the tolerance of tests/test_pallas_mlp.py (2e-5). bf16 rounds at the
same three places in both (coordinates, accumulator before the activation,
activation output), so the two differ only by summation (the JAX kernel's
f32 sums, the port's plain version's exact ones), and where that moves a
sum across a bf16 rounding boundary. Measured on these cases: at most
1.1e-4, one such flip. BF16_TOL = 1e-3 leaves room for one; the JAX test
allows bf16 0.05 against the f32 forward."""

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


@pytest.mark.parametrize("hidden,skip,d_in", [((512,) * 8, (4,), 3), ((256,) * 8, (4,), 3),
                                              ((128,) * 3, (2,), 2)])
def test_tiles_unpack_to_the_jax_weights(hidden, skip, d_in):
    """``FusedNet.tiles`` (the bf16 kernels' weight stages: W^T in 64-row
    chunks x 64-column K blocks, 128-byte swizzled) unpacks to the JAX
    prepare_fused_weights hidden-input matrices bit for bit; the last
    layer's LAST_ROWS columns are all it keeps, and JAX pads the rest with
    zeros. One element is also located from the layout's own formula."""
    jm = JaxImplicitNet(d_in=d_in, hidden_dims=hidden, skip_in=skip, beta=100.0, radius_init=0.5)
    params = jm.init(jax.random.PRNGKey(1))
    tm = ImplicitNet(d_in=d_in, hidden_dims=hidden, skip_in=skip, beta=100.0, radius_init=0.5)
    tm.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    net = fused_mlp.FusedNet(tm, torch.bfloat16)
    jw, spec, _ = pallas_mlp.prepare_fused_weights(jm, params, jnp.bfloat16)
    want, it = [], iter(jw)
    for kind in spec:
        mats = [next(it) for _ in range(2 if kind[0] == "skip" else 1)]
        next(it)  # bias
        if kind[0] != "first":
            want.append(np.asarray(mats[0]).view(np.uint16))
    got, off = [], 0  # unpack: undo the swizzle (its own inverse) and the stage order
    for w in want:
        k, rows = w.shape[0], w.shape[1] if len(got) < len(want) - 1 else fused_mlp.LAST_ROWS
        chunk = min(rows, fused_mlp.CHUNK_N)
        stages = net.tiles[off:off + rows * k].reshape(rows // chunk, k // 64, chunk, 64)
        got.append(fused_mlp.swizzle_128b(stages).permute(0, 2, 1, 3).reshape(rows, k).T.contiguous())
        off += rows * k
    assert off == net.tiles.numel() and len(got) == len(hidden)
    for layer, (g, w) in enumerate(zip(got, want)):
        g = g.view(torch.int16).numpy().view(np.uint16)
        cols = g.shape[1]
        np.testing.assert_array_equal(g, w[:, :cols])
        if layer == len(want) - 1:
            assert cols == fused_mlp.LAST_ROWS and not w[:, cols:].any()
    # element (k, j) of the first hidden-input matrix: chunk c = j // 64 holds
    # W^T rows 64c..64c+63, its K block kb = k // 64 is a (64, 64) stage, and
    # the 16-byte group g = (k % 64) // 8 of row r = j % 64 sits at g ^ (r % 8)
    k, j = 77, 70
    r, kb, c = j % 64, k // 64, j // 64
    k_blocks = want[0].shape[0] // 64
    at = (c * k_blocks + kb) * 64 * 64 + r * 64 + ((((k % 64) // 8) ^ (r % 8)) * 8) + k % 8
    assert net.tiles.view(torch.int16)[at].item() & 0xFFFF == int(want[0][k, j])


@pytest.mark.parametrize("skip,beta", [((2,), 100.0), ((), 0.0)])
def test_bf16_plain_forward_sums_exactly(skip, beta):
    """The bf16 plain forward sums each layer exactly: numpy's float64
    evaluation of the JAX prepare_fused_weights arrays, rounded through f32
    to bf16 at the three points and to f32 at the end, gives the same
    values bit for bit (an f32 sum over K would not: it is checked to
    differ somewhere)."""
    jm, params, tm = _pair(skip, beta, hidden=(256,) * 4)
    net = fused_mlp.FusedNet(tm, torch.bfloat16)
    pts = np.random.default_rng(3).uniform(-1, 1, (4096, 3)).astype(np.float32)
    jw, spec, _ = pallas_mlp.prepare_fused_weights(jm, params, jnp.bfloat16)

    def rnd(a):
        return a.astype(np.float32).astype(jnp.bfloat16).astype(np.float64)

    def forward(dot):
        x = rnd(pts.astype(np.float64))
        h, it = x, iter(jw)
        for layer, kind in enumerate(spec):
            w = [np.asarray(next(it), np.float64) for _ in range(2 if kind[0] == "skip" else 1)]
            b = np.asarray(next(it), np.float64)[0]
            if kind[0] == "first":
                acc = x @ w[0][:3] + b
            elif kind[0] == "skip":
                acc = (dot(h, w[0]) + x @ w[1][:3]) * fused_mlp.INV_SQRT2 + b
            else:
                acc = dot(h, w[0]) + b
            if layer == len(spec) - 1:
                out = acc[:, 0]
                return (np.tanh(out) if beta <= 0 else out).astype(np.float32)
            acc = rnd(acc)
            if beta > 0:
                t = beta * acc
                acc = (np.maximum(t, 0.0) + np.log1p(np.exp(-np.abs(t)))) / beta
            else:
                acc = np.maximum(acc, 0.0)
            h = rnd(acc)

    got = fused_mlp.fused_points(net, torch.from_numpy(pts)).numpy()
    np.testing.assert_array_equal(got, forward(lambda h, w: h @ w))
    f32 = forward(lambda h, w: (h.astype(np.float32) @ w.astype(np.float32)).astype(np.float64))
    assert np.any(got != f32)
