"""The fused (f, grad_x f) op of the port against the JAX package's Pallas
kernels (ops/pallas_igr.py) run in interpret mode on the CPU.

The port's side runs its kernels' plain PyTorch versions, which is what its
wrappers take for CPU tensors (the CUDA kernels themselves are held against
those plain versions on the card: tests/test_torch_cuda_kernels.py and
chip_smoke.py). Same weights (JAX init through ``convert.params_from_jax``),
same numpy-seeded points, ImplicitNet 4x64, N = 200 as in
tests/test_pallas_igr.py.

Tolerances: float32 forward rtol = atol = 2e-5, parameter gradients rtol 1e-4
/ atol 1e-5 (tests/test_pallas_igr.py's). bfloat16 working type: both sides
round at the same points, but the JAX kernel's f32 sums (the port's plain
versions sum exactly, in f64) can round to the neighbouring bf16 value (2^-8
relative), and sigma'(beta z) carries that on with a factor of up to beta /
4; the limits are 5e-3 on f and g (of magnitude ~1) and 1% of each gradient
tensor's largest entry.

The last tests hold what the bf16 CUDA kernels take from the host: their
weight image (``FusedNet.igr_tiles``) against the JAX weights, and the plan of
the backward's dW pass over the workspace its first pass writes."""

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
from sdf_representation_tpu_torch.ops import diffops, fused_igr
from sdf_representation_tpu_torch.ops.fused_mlp import FusedNet, swizzle_128b

torch.set_num_threads(2)
CASES = [((2,), 100.0), ((), 100.0), ((2,), 0.0)]
IDS = ["skip_softplus", "noskip_softplus", "skip_relu_tanh"]
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _setup(skip, beta, dtype="float32", n=200, seed=0):
    jm = JaxImplicitNet(d_in=3, hidden_dims=(64,) * 4, skip_in=skip, beta=beta)
    params = jm.init(jax.random.PRNGKey(seed))
    model = ImplicitNet(d_in=3, hidden_dims=(64,) * 4, skip_in=skip, beta=beta)
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    x = np.random.default_rng(seed).uniform(-1, 1, (n, 3)).astype(np.float32)
    vag = jax_make_fused(jm, fwd_tile_p=128, bwd_tile_p=128,
                         compute_dtype=DTYPES[dtype][1], interpret=True)
    return jm, params, model, x, vag


def _probe_loss(f, g, mean, sin, total):
    return mean(sin(3.0 * f)) + mean((total(g * g, -1) - 1.0) ** 2)


def _jax_grads(vag, params, x):
    def loss(p):
        f, g = vag(p, jnp.asarray(x))
        return _probe_loss(f, g, jnp.mean, jnp.sin, jnp.sum)

    return params_from_jax(jax.tree_util.tree_map(np.asarray, jax.grad(loss)(params)))


def _port_grads(model, x, dtype):
    model.zero_grad()
    xt = torch.from_numpy(x).requires_grad_(True)
    f, g = fused_igr.make_fused_value_and_grad(model, dtype)(xt)
    _probe_loss(f, g, torch.mean, torch.sin, torch.sum).backward()
    return xt, {name: p.grad for name, p in model.named_parameters()}


@pytest.mark.parametrize("skip,beta", CASES, ids=IDS)
def test_forward_matches_pallas_interpret(skip, beta):
    _, params, model, x, vag = _setup(skip, beta)
    f_ref, g_ref = vag(params, jnp.asarray(x))
    f, g = fused_igr.fused_value_and_grad(FusedNet(model, torch.float32), torch.from_numpy(x))
    assert f.shape == (200,) and g.shape == (200, 3) and f.dtype == g.dtype == torch.float32
    np.testing.assert_allclose(f.numpy(), np.asarray(f_ref), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(g.numpy(), np.asarray(g_ref), rtol=2e-5, atol=2e-5)
    # and the shared-matmul derivation is the same function
    f2, g2 = diffops.implicitnet_value_and_grad(model, torch.from_numpy(x))
    np.testing.assert_allclose(f2.detach().numpy(), f.numpy(), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(g2.detach().numpy(), g.numpy(), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("skip,beta", CASES, ids=IDS)
def test_param_grads_match_the_pallas_vjp(skip, beta):
    """grad_theta of a loss using both f and grad_x f: every term of the
    backward, through the port's autograd.Function."""
    _, params, model, x, vag = _setup(skip, beta)
    want = _jax_grads(vag, params, x)
    _, got = _port_grads(model, x, torch.float32)
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(), rtol=1e-4, atol=1e-5,
                                   err_msg=name)


@pytest.mark.parametrize("skip,beta", CASES, ids=IDS)
def test_bfloat16_working_type_matches_pallas_interpret(skip, beta):
    _, params, model, x, vag = _setup(skip, beta, "bfloat16")
    f_ref, g_ref = vag(params, jnp.asarray(x))
    f, g = fused_igr.fused_value_and_grad(FusedNet(model, torch.bfloat16), torch.from_numpy(x))
    np.testing.assert_allclose(f.numpy(), np.asarray(f_ref), atol=5e-3, rtol=0)
    np.testing.assert_allclose(g.numpy(), np.asarray(g_ref), atol=5e-3, rtol=0)
    # it is the bf16 function, not the f32 one
    f32, _ = fused_igr.fused_value_and_grad(FusedNet(model, torch.float32), torch.from_numpy(x))
    assert not torch.equal(f, f32)
    want = _jax_grads(vag, params, x)
    _, got = _port_grads(model, x, torch.bfloat16)
    for name in want:
        limit = 1e-2 * float(want[name].abs().max())
        assert float((got[name] - want[name]).abs().max()) <= limit, name


def test_x_gets_no_gradient():
    """The backward is params-only: x is data (the JAX VJP returns zeros)."""
    _, params, model, x, vag = _setup((2,), 100.0)
    xt, grads = _port_grads(model, x, torch.float32)
    assert xt.grad is None and all(g is not None for g in grads.values())
    dx = jax.grad(lambda xx: jnp.sum(vag(params, xx)[0]))(jnp.asarray(x))
    assert float(jnp.abs(dx).max()) == 0.0


@pytest.mark.parametrize("n", [1, 37, 64, 129])
def test_any_point_count(n):
    """N below a tile and not a tile multiple: rows past N add nothing."""
    _, params, model, x, vag = _setup((2,), 100.0, n=n, seed=3)
    f_ref, g_ref = vag(params, jnp.asarray(x))
    f, g = fused_igr.fused_value_and_grad(FusedNet(model, torch.float32), torch.from_numpy(x))
    assert f.shape == (n,) and g.shape == (n, 3)
    np.testing.assert_allclose(f.numpy(), np.asarray(f_ref), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(g.numpy(), np.asarray(g_ref), rtol=2e-5, atol=2e-5)
    want = _jax_grads(vag, params, x)
    _, got = _port_grads(model, x, torch.float32)
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(), rtol=1e-4, atol=1e-5,
                                   err_msg=name)


def test_unpack_grads_of_a_skip_layer():
    """A skip layer's dW is cat(top[: fan_in - d_in], bottom[: d_in]),
    transposed to the module's (out, in)."""
    d_in, fan_in, fan_out, pad = 3, 10, 5, 128
    top = torch.arange(pad * pad, dtype=torch.float32).reshape(pad, pad)
    bottom = -torch.arange(d_in * pad, dtype=torch.float32).reshape(d_in, pad) - 1
    bias = torch.arange(pad, dtype=torch.float32)
    padded = [(None, bottom, bias), (top, bottom, bias), (top, None, bias)]
    shapes = [torch.Size((fan_out, d_in)), torch.Size((fan_out, fan_in)), torch.Size((1, fan_in))]
    flat = fused_igr.unpack_grads(d_in, shapes, padded)
    assert [tuple(t.shape) for t in flat] == [(5, 3), (5,), (5, 10), (5,), (1, 10), (1,)]
    assert torch.equal(flat[0], bottom[:3, :5].T)
    assert torch.equal(flat[2], torch.cat([top[:7, :5], bottom[:3, :5]]).T)
    assert torch.equal(flat[4], top[:10, :1].T)
    assert torch.equal(flat[3], bias[:5])


def test_mixed_precision_copies_carry_the_gradient_to_the_masters():
    """bf16 copies of the parameters enter the op as arguments; autograd
    carries their gradients back through the cast to the f32 masters."""
    _, _, model, x, _ = _setup((2,), 100.0)
    vag = fused_igr.make_fused_value_and_grad(model, torch.bfloat16)
    layers = [(w.to(torch.bfloat16), b.to(torch.bfloat16)) for w, b in model.effective_layers()]
    f, g = vag(torch.from_numpy(x).to(torch.bfloat16), layers)
    assert f.dtype == g.dtype == torch.float32
    (f.mean() + (g * g).sum(-1).mean()).backward()
    for name, p in model.named_parameters():
        assert p.grad is not None and p.grad.dtype == torch.float32, name
        assert torch.equal(p.grad, p.grad.to(torch.bfloat16).float()), name  # rounded on the way


def test_wrappers_validate_their_inputs():
    _, _, model, x, _ = _setup((2,), 100.0)
    net = FusedNet(model, torch.float32)
    xt = torch.from_numpy(x)
    with pytest.raises(ValueError, match="points must be"):
        fused_igr.fused_value_and_grad(net, xt[:, :2])
    with pytest.raises(ValueError, match="cotangents"):
        fused_igr.fused_param_grads(net, xt, torch.zeros(3), torch.zeros_like(xt))
    before = dict(fused_igr.LAUNCHES)
    fused_igr.fused_param_grads(net, xt, torch.zeros(200), torch.zeros_like(xt))
    assert fused_igr.LAUNCHES == before  # the CPU path launches nothing


# ---- the bf16 tensor-core kernels' host-side layouts -------------------------

def _jax_hidden_mats(jm, params):
    """The JAX prepare_fused_weights hidden-input matrices (W_top of each
    layer but the first), as uint16 bit patterns."""
    jw, spec, _ = pallas_mlp.prepare_fused_weights(jm, params, jnp.bfloat16)
    mats, it = [], iter(jw)
    for kind in spec:
        layer = [next(it) for _ in range(2 if kind[0] == "skip" else 1)]
        next(it)  # bias
        if kind[0] != "first":
            mats.append(np.asarray(layer[0]).view(np.uint16))
    return mats


@pytest.mark.parametrize("hidden,skip,d_in", [((512,) * 8, (4,), 3), ((256,) * 8, (4,), 3),
                                              ((128,) * 3, (2,), 2)])
def test_igr_tiles_unpack_to_the_jax_weights(hidden, skip, d_in):
    """``FusedNet.igr_tiles``: ``tiles`` (the forward stages), then per layer
    n_lin - 2 .. 1 the reverse stages, W itself in 64-row chunks x 64-column
    K blocks, 128-byte swizzled; unpacked, the JAX prepare_fused_weights
    matrices bit for bit. One element is also located from the layout's own
    formula."""
    jm = JaxImplicitNet(d_in=d_in, hidden_dims=hidden, skip_in=skip, beta=100.0, radius_init=0.5)
    params = jm.init(jax.random.PRNGKey(2))
    tm = ImplicitNet(d_in=d_in, hidden_dims=hidden, skip_in=skip, beta=100.0, radius_init=0.5)
    tm.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    net = FusedNet(tm, torch.bfloat16)
    want = _jax_hidden_mats(jm, params)
    image = net.igr_tiles.view(torch.int16)
    front = net.tiles.numel()
    assert torch.equal(image[:front], net.tiles.view(torch.int16))
    off = front
    for w in reversed(want[:-1]):  # the reverse stages of layers n_lin - 2 .. 1
        k, n = w.shape
        stages = image[off:off + k * n].reshape(k // 64, n // 64, 64, 64)
        got = swizzle_128b(stages).permute(0, 2, 1, 3).reshape(k, n)
        np.testing.assert_array_equal(got.numpy().view(np.uint16), w)
        off += k * n
    assert off == image.numel()
    # element (i, j) of the last hidden layer's matrix: chunk i // 64 (the
    # reverse product's output columns), K block j // 64, and the 16-byte
    # group (j % 64) // 8 of row r = i % 64 at group ^ (r % 8)
    w = want[-2]
    i, j = 77, w.shape[1] - 3
    r, n_blocks = i % 64, w.shape[1] // 64
    at = front + ((i // 64) * n_blocks + j // 64) * 64 * 64 + r * 64 + ((((j % 64) // 8) ^ (r % 8)) * 8) + j % 8
    assert image[at].item() & 0xFFFF == int(w[i, j])


def _bf16_case(skip, beta, d_in=3, hidden=(128,) * 3, n=150, seed=4):
    tm = ImplicitNet(d_in=d_in, hidden_dims=hidden, skip_in=skip, beta=beta, radius_init=0.5,
                     generator=torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.uniform(-1, 1, (n, d_in)).astype(np.float32))
    a = torch.from_numpy((rng.standard_normal(n) / n).astype(np.float32))
    c = torch.from_numpy((rng.standard_normal((n, d_in)) / n).astype(np.float32))
    return FusedNet(tm, torch.bfloat16), x, a, c


@pytest.mark.parametrize("skip,beta,d_in,hidden,n", [
    ((2,), 100.0, 3, (128,) * 3, 150), ((), 0.0, 3, (256,) * 2, 64), ((1,), 100.0, 2, (128,) * 2, 1),
    ((), 100.0, 4, (128,), 65), ((2,), 100.0, 3, (384,) * 3, 97),
], ids=["skip", "relu_tanh", "2d_one_point", "one_hidden_4d", "384"])
def test_dw_plan_over_the_workspace_is_the_gradient(skip, beta, d_in, hidden, n):
    """The bf16 backward's second pass as planned on the host: ``dw_plan``'s
    jobs cover the packed weight buffer once, and run over the workspace the
    first pass writes (``images_plain``: its tile row order, padded points,
    image sets) they give the plain version's gradients, up to the order of
    the f32 sums (the bf16 products are exact): dW within 1e-5 and db within
    1e-6 of each tensor's largest entry."""
    net, x, a, c = _bf16_case(skip, beta, d_in, hidden, n)
    jobs = fused_igr.dw_plan(net)
    covered = torch.zeros(net.packed[0].numel(), dtype=torch.int32)
    for *_, off, stride, rows, _ in jobs:
        covered.as_strided((rows, 128), (stride, 1), off).add_(1)
    assert bool((covered == 1).all())
    ws, partial = fused_igr.images_plain(net, x, a, c)
    tiles = -(-n // fused_igr.BWD_CTA_P) * 2
    _, total = fused_igr._workspace_sets(len(net.spec), net.h_pad)
    assert ws.numel() == total * tiles * fused_igr.IMG_BLOCK and partial.shape == (tiles, net.packed[1].numel())
    (stash,) = fused_igr._workspace(net, n, False)  # the forward's: act'(z) over whole CTAs
    assert stash.numel() == (len(net.spec) - 1) * -(-n // fused_igr.FWD_CTA_P) * fused_igr.FWD_CTA_P * net.h_pad
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


def test_workspace_rows_follow_the_tile_order():
    """Tile T's row r holds point 32 T + 8 (r // 16) + r % 8: its x (rounded)
    where r % 16 < 8, its c otherwise, in the [x; c] image's columns 0 ..
    d_in - 1; points past N are zero rows whose cotangents are zero."""
    net, x, a, c = _bf16_case((2,), 100.0, n=40)
    ws, partial = fused_igr.images_plain(net, x, a, c)
    sets, _ = fused_igr._workspace_sets(len(net.spec), net.h_pad)
    tiles = partial.shape[0]

    def block_rows(key, fb=0):
        base, blocks = sets[key]
        img = ws[base * tiles * 4096:(base + blocks) * tiles * 4096].reshape(tiles, blocks, 64, 64)
        return swizzle_128b(img[:, fb]).reshape(tiles * 64, 64).float()

    rows = block_rows("coords")
    for T in range(tiles):
        for r in range(64):
            p = 32 * T + 8 * (r // 16) + r % 8
            src = x if r % 16 < 8 else c
            want = src[p].to(torch.bfloat16).float() if p < 40 else torch.zeros(3)
            assert torch.equal(rows[64 * T + r, :3], want) and not rows[64 * T + r, 3:].any()
    # the padded points (40 .. 63) carry zero cotangents in every layer
    for layer in range(len(net.spec)):
        cot = block_rows(("cot", layer))
        for T in range(tiles):
            for r in range(64):
                if 32 * T + 8 * (r // 16) + r % 8 >= 40:
                    assert not cot[64 * T + r].any()
