"""The f32 eikonal kernels' split-TF32 arithmetic on the CPU: their weight
stages (``FusedNet.igr_tf32_tiles``) against the JAX package's f32 weights,
the emulation of their products (``fused_igr.fused_value_and_grad_tf32_model``
and ``fused_param_grads_tf32_model``) against the JAX f32 Pallas kernels
(ops/pallas_igr.py) in interpret mode, and the workspace the f32 backward
writes for its dW pass (``fused_igr.images_plain``) through the plain dW pass
(``dw_pass_plain``) against the plain gradients.

The limits are tests/test_pallas_igr.py's: f and grad_x f rtol = atol =
2e-5, parameter gradients rtol 1e-4 / atol 1e-5. Three passes (hi.hi + hi.lo
+ lo.hi) must hold them; one TF32 pass (hi.hi) must not: that is the control
which shows the limits can tell them apart."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdf_representation_tpu.models import ImplicitNet as JaxImplicitNet
from sdf_representation_tpu.ops import pallas_mlp
from sdf_representation_tpu.ops.pallas_igr import make_fused_value_and_grad as jax_make_fused
from sdf_representation_tpu_torch.convert import params_from_jax
from sdf_representation_tpu_torch.models import ImplicitNet
from sdf_representation_tpu_torch.ops import fused_igr, fused_mlp
from sdf_representation_tpu_torch.ops.fused_mlp import FusedNet, split_tf32, swizzle_128b

torch.set_num_threads(2)
F_TOL = 2e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
CASES = [((2,), 100.0), ((2,), 0.0)]
IDS = ["skip_softplus", "skip_relu_tanh"]


def rna_reference(v: np.ndarray) -> np.ndarray:
    """float32 values rounded to a 10-bit mantissa, to nearest with ties
    away from zero, on values (float64, where every step is exact)."""
    v64 = v.astype(np.float64)
    _, e = np.frexp(v64)
    step = np.ldexp(1.0, np.maximum(e - 1, -126) - 10)
    return np.copysign(np.floor(np.abs(v64) / step + 0.5) * step, v64).astype(np.float32)


def split_reference(v: np.ndarray):
    hi = rna_reference(v)
    return hi, rna_reference((v.astype(np.float64) - hi).astype(np.float32))


def _jax_pair(hidden, skip, d_in, beta=100.0, seed=1):
    jm = JaxImplicitNet(d_in=d_in, hidden_dims=hidden, skip_in=skip, beta=beta, radius_init=0.5)
    params = jm.init(jax.random.PRNGKey(seed))
    tm = ImplicitNet(d_in=d_in, hidden_dims=hidden, skip_in=skip, beta=beta, radius_init=0.5)
    tm.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    return jm, params, tm


# ---- (a) the weight stages -----------------------------------------------------

@pytest.mark.parametrize("hidden,skip,d_in", [((512,) * 8, (4,), 3), ((256,) * 8, (4,), 3),
                                              ((128,) * 3, (2,), 2)])
def test_igr_tf32_tiles_unpack_to_the_split_jax_weights(hidden, skip, d_in):
    """``FusedNet.igr_tf32_tiles``: ``tf32_tiles`` (the forward stages, W^T),
    then per layer n_lin - 2 .. 1 the reverse stages, W itself in 64-row
    chunks x 32-column K blocks, K reordered within each 8 by K_ORDER, the hi
    then the lo image of each, 128-byte swizzled: unpacked, the split of the
    JAX prepare_fused_weights f32 matrices bit for bit. One element is also
    located from the layout's own formula."""
    jm, params, tm = _jax_pair(hidden, skip, d_in, seed=2)
    net = FusedNet(tm, torch.float32)
    jw, spec, _ = pallas_mlp.prepare_fused_weights(jm, params, np.float32)
    want, it = [], iter(jw)
    for kind in spec:
        mats = [next(it) for _ in range(2 if kind[0] == "skip" else 1)]
        next(it)  # bias
        if kind[0] != "first":
            want.append(np.asarray(mats[0], np.float32))
    tiles = net.igr_tf32_tiles
    front = net.tf32_tiles.numel()
    assert torch.equal(tiles[:front], net.tf32_tiles)
    order = list(fused_mlp.K_ORDER)
    off = front
    for w in reversed(want[:-1]):  # the reverse stages of layers n_lin - 2 .. 1
        k, n = w.shape
        st = swizzle_128b(tiles[off:off + 2 * k * n].reshape(k // 64, n // 32, 2, 64, 32))
        for half, ref in zip((0, 1), split_reference(w)):
            ordered = st[:, :, half].permute(0, 2, 1, 3).reshape(k, n // 8, 8)
            got = torch.empty_like(ordered)
            got[:, :, order] = ordered
            np.testing.assert_array_equal(got.reshape(k, n).numpy().view(np.uint32), ref.view(np.uint32))
        off += 2 * k * n
    assert off == tiles.numel()
    # element (i, j) of the first reverse layer's W (layer n_lin - 2): chunk
    # i // 64, K block j // 32, row r = i % 64, K slot p = 8 (j % 32 // 8) +
    # K_ORDER.index(j % 8) in 16-byte group (p // 4) ^ (r % 8); the lo image follows
    w = want[-2]
    i, j = 77, w.shape[1] - 3
    r, p = i % 64, 8 * (j % 32 // 8) + order.index(j % 8)
    at = front + ((i // 64) * (w.shape[1] // 32) + j // 32) * 2 * 64 * 32 + r * 32 + ((p // 4) ^ (r % 8)) * 4 + p % 4
    hi, lo = split_reference(w[i:i + 1, j])
    assert tiles[at].item() == hi[0] and tiles[at + 64 * 32].item() == lo[0]


# ---- (b) the emulation against the JAX f32 kernels ---------------------------------

def _emulation_against_jax(skip, beta, passes):
    """(f, grad f) and the parameter gradients of sum(a f + c . grad f) of
    the emulation and of the JAX f32 Pallas kernels (interpret mode) on a
    4x256 net over 256 seeded points -> the largest excess of |diff| over
    each limit (<= 0: within): f, grad f, gradients."""
    jm, params, tm = _jax_pair((256,) * 4, skip, 3, beta=beta, seed=5)
    rng = np.random.default_rng(5)
    x = rng.uniform(-1, 1, (256, 3)).astype(np.float32)
    a = (rng.standard_normal(256) / 256).astype(np.float32)
    c = (rng.standard_normal((256, 3)) / 256).astype(np.float32)
    vag = jax_make_fused(jm, fwd_tile_p=128, bwd_tile_p=128, compute_dtype=jnp.float32, interpret=True)
    (f, g), vjp = jax.vjp(lambda p: vag(p, jnp.asarray(x)), params)
    (gp,) = vjp((jnp.asarray(a), jnp.asarray(c)))
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, gp))
    net = FusedNet(tm, torch.float32)
    xt, at, ct = (torch.from_numpy(t) for t in (x, a, c))
    ef, eg = fused_igr.fused_value_and_grad_tf32_model(net, xt, passes)
    shapes = [w.shape for w, _ in tm.effective_layers()]
    got = fused_igr.unpack_grads(3, shapes, fused_igr.fused_param_grads_tf32_model(net, xt, at, ct, passes))
    names = [name for name, _ in tm.named_parameters()]
    assert len(names) == len(got) and set(names) == set(want)

    def excess(u, v, rtol, atol):
        v = np.asarray(v, np.float64)
        return float((np.abs(np.asarray(u, np.float64) - v) - (atol + rtol * np.abs(v))).max())

    return (excess(ef.numpy(), f, F_TOL, F_TOL), excess(eg.numpy(), g, F_TOL, F_TOL),
            max(excess(t.numpy(), want[name].numpy(), GRAD_RTOL, GRAD_ATOL) for name, t in zip(names, got)))


@pytest.mark.parametrize("skip,beta", CASES, ids=IDS)
def test_three_tf32_passes_hold_the_f32_limits(skip, beta):
    """The f32 kernels' arithmetic, emulated (operands split as the kernels
    split them, products summed in f64), stays within the JAX f32 kernels'
    limits: f and grad f at 2e-5, every gradient at rtol 1e-4 / atol 1e-5."""
    over_f, over_g, over_grads = _emulation_against_jax(skip, beta, 3)
    assert over_f <= 0 and over_g <= 0 and over_grads <= 0, (over_f, over_g, over_grads)


@pytest.mark.parametrize("skip,beta", CASES, ids=IDS)
def test_one_tf32_pass_fails_the_f32_limits(skip, beta):
    """The control: a single TF32 pass (hi.hi) fails the limits on the same
    inputs, both the forward's and the gradients'."""
    over_f, over_g, over_grads = _emulation_against_jax(skip, beta, 1)
    assert max(over_f, over_g) > 0 and over_grads > 0, (over_f, over_g, over_grads)


def test_tf32_models_refuse_what_they_do_not_take():
    _, _, tm = _jax_pair((128,) * 3, (2,), 3)
    x, a, c = torch.zeros(4, 3), torch.zeros(4), torch.zeros(4, 3)
    bf16 = FusedNet(tm, torch.bfloat16)
    with pytest.raises(ValueError, match="f32"):
        fused_igr.fused_value_and_grad_tf32_model(bf16, x)
    with pytest.raises(ValueError, match="f32"):
        fused_igr.fused_param_grads_tf32_model(bf16, x, a, c)
    with pytest.raises(ValueError, match="passes"):
        fused_igr.fused_value_and_grad_tf32_model(FusedNet(tm, torch.float32), x, passes=2)
    with pytest.raises(ValueError, match="f32 kernels"):
        bf16.igr_tf32_tiles


# ---- (c) the f32 backward's workspace and its dW pass --------------------------------

def _f32_case(skip, beta, d_in=3, hidden=(128,) * 3, n=150, seed=4):
    tm = ImplicitNet(d_in=d_in, hidden_dims=hidden, skip_in=skip, beta=beta, radius_init=0.5,
                     generator=torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.uniform(-1, 1, (n, d_in)).astype(np.float32))
    a = torch.from_numpy((rng.standard_normal(n) / n).astype(np.float32))
    c = torch.from_numpy((rng.standard_normal((n, d_in)) / n).astype(np.float32))
    return FusedNet(tm, torch.float32), x, a, c


@pytest.mark.parametrize("skip,beta,d_in,hidden,n", [
    ((2,), 100.0, 3, (128,) * 3, 150), ((), 0.0, 3, (256,) * 2, 64), ((1,), 100.0, 2, (128,) * 2, 1),
    ((), 100.0, 4, (128,), 65), ((2,), 100.0, 3, (384,) * 3, 97),
], ids=["skip", "relu_tanh", "2d_one_point", "one_hidden_4d", "384"])
def test_f32_workspace_through_the_dw_pass_is_the_gradient(skip, beta, d_in, hidden, n):
    """The f32 backward's second pass as planned on the host: ``dw_plan``'s
    jobs (128 x 128 tiles) cover the packed weight buffer once, and run over
    the workspace the first pass writes (``images_plain``: [h; tc] in the
    slot order, [dz; dtcz] as split images, padded points, per-warp db sums)
    they give the plain version's gradients up to the split products' and
    the sums' rounding: dW within 1e-5 and db within 1e-6 of each tensor's
    largest entry."""
    net, x, a, c = _f32_case(skip, beta, d_in, hidden, n)
    jobs = fused_igr.dw_plan(net)
    assert all(len(job) == fused_igr.PLAN_FIELDS_F32 for job in jobs)
    covered = torch.zeros(net.packed[0].numel(), dtype=torch.int32)
    for *_, off, stride, rows, _ in jobs:
        covered.as_strided((rows, 128), (stride, 1), off).add_(1)
    assert bool((covered == 1).all())
    ws, partial = fused_igr.images_plain(net, x, a, c)
    tiles = -(-n // fused_igr.BWD_TILE_P)
    _, total = fused_igr._workspace_sets_f32(len(net.spec), net.h_pad)
    assert ws.dtype == torch.float32 and ws.numel() == total * tiles
    assert partial.shape == (tiles, 4, net.packed[1].numel())
    (stash,) = fused_igr._workspace(net, n, False)  # the forward's: act'(z) over whole CTAs
    assert stash.numel() == (len(net.spec) - 1) * -(-n // fused_igr.FWD_TILE_P) * fused_igr.FWD_TILE_P * net.h_pad
    gw, gb = fused_igr.dw_pass_plain(net, ws, partial)
    got = fused_igr._padded(net, gw, gb)
    want = fused_igr.fused_param_grads_plain(net, x, a, c)
    for layer, (g, w) in enumerate(zip(got, want)):
        for u, v, tol in zip(g, w, (1e-5, 1e-5, 1e-6)):
            if v is None:
                assert u is None
                continue
            u_live = u[: v.shape[0], : v.shape[1]] if v.dim() == 2 else u[: v.shape[0]]
            scale = max(float(v.abs().max()), 1e-30)
            assert float((u_live - v).abs().max()) <= tol * scale, layer
    # the last layer keeps one live column: the rest of its dW and db is zero
    k, width, _, b_off, w_off, _ = net.layout[-1]
    assert not gw[w_off:w_off + k * width].view(k, width)[:, 1:].any()
    assert not gb[b_off + 1:b_off + width].any()


def test_f32_workspace_follows_the_kernels_layout():
    """Elements of the f32 workspace where csrc/fused_igr.cu puts them: in
    tile T, point p's primal (tangent) row at column j of a slot-order set
    (coords, stash) lies in group j // 8, slot 32 (p // 8) + 4 (p % 8) + j %
    8 // 2, component 2 (j % 2) + tangent; in a cot set, K block kb = p // 16
    and K slot 8 (p % 16 // 4) + 4 tangent + p % 4 of row j % 128 of the
    (j // 128)-th 128-column block, the hi image then the lo image, in the
    128-byte swizzle. Points past N are zero, their cotangents too."""
    n = 40
    net, x, a, c = _f32_case((2,), 100.0, n=n)
    ws, partial = fused_igr.images_plain(net, x, a, c)
    sets, _ = fused_igr._workspace_sets_f32(len(net.spec), net.h_pad)
    tiles = partial.shape[0]
    xr, cr, chain = fused_igr._param_grad_chain(net, x, a, c)

    def slot_at(key, T, p, tangent, j):
        base, size = sets[key]
        t = 32 * (p // 8) + 4 * (p % 8) + j % 8 // 2
        return ws[base * tiles + T * size + ((j // 8) * 128 + t) * 4 + 2 * (j % 2) + tangent].item()

    def cot_at(layer, T, p, tangent, j, half):
        base, size = sets["cot", layer]
        kb, kk = p // 16, 8 * (p % 16 // 4) + 4 * tangent + p % 4
        row, nb = j % 128, j // 128
        at = ((nb * 2 + kb) * 2 + half) * 4096 + row * 32 + ((kk // 4) ^ (row % 8)) * 4 + kk % 4
        return ws[base * tiles + T * size + at].item()

    for T in range(tiles):
        for p in range(32):
            point = 32 * T + p
            for j in (0, 1, 2, 3, 7, 63):
                for tangent, src in ((0, x), (1, c)):
                    want = src[point, j].item() if point < n and j < 3 else 0.0
                    assert slot_at("coords", T, p, tangent, j) == want
            h_prev, tc_prev, _, _ = chain[1]  # layer 1's input: hidden layer 0's [h; tc]
            for j in (0, 5, 64, 127):
                for tangent, src in ((0, h_prev), (1, tc_prev)):
                    want = src[point, j].item() if point < n else None
                    if want is not None:
                        assert slot_at(("stash", 0), T, p, tangent, j) == want
            _, _, dz, dtcz = chain[2]
            for j in (0, 9, 100):
                for tangent, src in ((0, dz), (1, dtcz)):
                    if point < n:
                        hi, lo = split_tf32(src[point:point + 1, j])
                        assert cot_at(2, T, p, tangent, j, 0) == hi.item()
                        assert cot_at(2, T, p, tangent, j, 1) == lo.item()
                    else:
                        assert cot_at(2, T, p, tangent, j, 0) == 0.0 == cot_at(2, T, p, tangent, j, 1)
    # per-warp db sums: warp w of tile T sums dz over points 32 T + 8 w .. + 7
    dz0 = chain[0][2]
    b_off = net.layout[0][3]
    assert torch.allclose(partial[0, 1, b_off:b_off + 128], dz0[8:16].sum(dim=0), rtol=0, atol=1e-7)


def test_dw_splits_fill_one_wave(monkeypatch):
    """The f32 dW pass cuts each job's rows into as many parts as keep all
    CTAs in one wave of the card's SMs (and no more parts than tiles)."""
    monkeypatch.setattr(fused_igr, "_sm_count", lambda device: 132)
    assert fused_igr.dw_splits(124, 512, None) == 1   # 8x512: 124 jobs
    assert fused_igr.dw_splits(34, 171, None) == 3    # 8x256: 34 jobs
    assert fused_igr.dw_splits(8, 2, None) == 2
    assert fused_igr.dw_splits(200, 512, None) == 1
