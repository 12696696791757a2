"""The f32 fused forward's split-TF32 arithmetic on the CPU: the operand
split (``fused_mlp.split_tf32``) against a numpy reference that rounds by
value, the f32 kernels' weight stages (``FusedNet.tf32_tiles``) against the
JAX package's f32 weights, and the emulation of the kernels' products
(``fused_mlp.forward_tf32_model``) against the JAX f32 Pallas kernel in
interpret mode.

The f32 limit is tests/test_pallas_mlp.py's 2e-5. Three passes (hi.hi +
hi.lo + lo.hi) must hold it at the flagship's width; one TF32 pass (hi.hi)
must not: that is the control which shows the limit can tell them apart."""

import jax
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


def rna_tf32_reference(v: np.ndarray) -> np.ndarray:
    """float32 values rounded to a 10-bit mantissa, to nearest with ties
    away from zero, computed on values (float64, where every step here is
    exact): |v| = m 2^e, the step is 2^(e - 10) (subnormals share the
    exponent -126)."""
    v64 = v.astype(np.float64)
    _, e = np.frexp(v64)
    step = np.ldexp(1.0, np.maximum(e - 1, -126) - 10)
    return np.copysign(np.floor(np.abs(v64) / step + 0.5) * step, v64).astype(np.float32)


def split_reference(v: np.ndarray):
    hi = rna_tf32_reference(v)
    return hi, rna_tf32_reference((v.astype(np.float64) - hi).astype(np.float32))


def _values(kind: str) -> np.ndarray:
    rng = np.random.default_rng(7)
    if kind == "normal":
        return (rng.standard_normal(20000) * 10.0 ** rng.uniform(-30, 30, 20000)).astype(np.float32)
    if kind == "zeros_and_subnormals":
        tiny = np.float32(np.finfo(np.float32).tiny)
        sub = (rng.uniform(-1, 1, 5000) * tiny).astype(np.float32)
        smallest = np.array([0.0, -0.0, 1e-45, -1e-45, tiny, -tiny, tiny * 0.5], np.float32)
        return np.concatenate([smallest, sub])
    if kind == "large":
        return (rng.uniform(-1, 1, 5000) * 1e38).astype(np.float32)
    # ties: the 13 dropped bits exactly half way (0x1000), and one below / above
    bits = rng.integers(0x00800000, 0x7F000000, 3000, dtype=np.int64) & ~0x1FFF
    bits = np.concatenate([bits | 0x1000, bits | 0x0FFF, bits | 0x1001])
    signs = np.where(rng.integers(0, 2, bits.size) == 1, 0x80000000, 0)
    return (bits | signs).astype(np.uint32).view(np.float32)


@pytest.mark.parametrize("kind", ["normal", "zeros_and_subnormals", "large", "ties"])
def test_split_tf32_matches_the_rounding_by_value(kind):
    v = _values(kind)
    hi, lo = fused_mlp.split_tf32(torch.from_numpy(v))
    want_hi, want_lo = split_reference(v)
    np.testing.assert_array_equal(hi.numpy().view(np.uint32), want_hi.view(np.uint32))
    np.testing.assert_array_equal(lo.numpy().view(np.uint32), want_lo.view(np.uint32))
    assert not (hi.numpy().view(np.uint32) & 0x1FFF).any()
    assert not (lo.numpy().view(np.uint32) & 0x1FFF).any()
    v64 = v.astype(np.float64)
    normal = np.abs(v64) >= 2.0 ** -100
    rest = np.abs(v64 - hi.numpy().astype(np.float64) - lo.numpy().astype(np.float64))
    assert (rest[normal] <= 2.0 ** -22 * np.abs(v64[normal])).all()
    if kind == "ties":  # ties go away from zero: the magnitude rounds up
        half = (v.view(np.uint32) & 0x1FFF) == 0x1000
        assert (np.abs(hi.numpy()[half]) > np.abs(v[half])).all()


def _jax_pair(hidden, skip, d_in, beta=100.0, seed=1):
    jm = JaxImplicitNet(d_in=d_in, hidden_dims=hidden, skip_in=skip, beta=beta, radius_init=0.5)
    params = jm.init(jax.random.PRNGKey(seed))
    tm = ImplicitNet(d_in=d_in, hidden_dims=hidden, skip_in=skip, beta=beta, radius_init=0.5)
    tm.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    return jm, params, tm


@pytest.mark.parametrize("hidden,skip,d_in", [((512,) * 8, (4,), 3), ((256,) * 8, (4,), 3),
                                              ((128,) * 3, (2,), 2)])
def test_tf32_tiles_unpack_to_the_split_jax_weights(hidden, skip, d_in):
    """``FusedNet.tf32_tiles`` (per stage the hi then the lo image of 64 W^T
    rows x 32 K, K reordered within each 8 by K_ORDER, 128-byte swizzled)
    unpacks to the split of the JAX prepare_fused_weights f32 hidden-input
    matrices bit for bit; the last layer keeps its first LAST_ROWS columns.
    One element is also located from the layout's own formula."""
    jm, params, tm = _jax_pair(hidden, skip, d_in)
    net = fused_mlp.FusedNet(tm, torch.float32)
    jw, spec, _ = pallas_mlp.prepare_fused_weights(jm, params, np.float32)
    want, it = [], iter(jw)
    for kind in spec:
        mats = [next(it) for _ in range(2 if kind[0] == "skip" else 1)]
        next(it)  # bias
        if kind[0] != "first":
            want.append(np.asarray(mats[0], np.float32))
    tiles = net.tf32_tiles
    order = list(fused_mlp.K_ORDER)
    got_hi, got_lo, off = [], [], 0
    for i, w in enumerate(want):
        k = w.shape[0]
        rows = fused_mlp.LAST_ROWS if i == len(want) - 1 else w.shape[1]
        chunk = min(rows, fused_mlp.CHUNK_N)
        size = 2 * rows * k
        st = fused_mlp.swizzle_128b(tiles[off:off + size].reshape(rows // chunk, k // 32, 2, chunk, 32))
        off += size
        halves = []
        for half in (0, 1):
            wt = st[:, :, half].permute(0, 2, 1, 3).reshape(rows, k // 8, 8)  # W^T, K reordered
            unordered = torch.empty_like(wt)
            unordered[:, :, order] = wt
            halves.append(unordered.reshape(rows, k).T.contiguous().numpy())
        got_hi.append(halves[0])
        got_lo.append(halves[1])
    assert off == tiles.numel() and len(got_hi) == len(hidden)
    for i, w in enumerate(want):
        cols = got_hi[i].shape[1]
        hi, lo = split_reference(w[:, :cols])
        np.testing.assert_array_equal(got_hi[i].view(np.uint32), hi.view(np.uint32))
        np.testing.assert_array_equal(got_lo[i].view(np.uint32), lo.view(np.uint32))
        if i == len(want) - 1:
            assert cols == fused_mlp.LAST_ROWS and not w[:, cols:].any()
    # element (k, j) of the first hidden-input matrix: chunk c = j // 64 and
    # K block kb = k // 32 make stage c * k_blocks + kb (two images of 64 x
    # 32 f32); K slot p = 8 (k % 32 // 8) + K_ORDER.index(k % 8) of row
    # r = j % 64 sits in 16-byte group (p // 4) ^ (r % 8); the lo image follows
    k, j = 77, 70
    r, kb, c = j % 64, k // 32, j // 64
    p = 8 * (k % 32 // 8) + order.index(k % 8)
    k_blocks = want[0].shape[0] // 32
    at = (c * k_blocks + kb) * 2 * 64 * 32 + r * 32 + ((p // 4) ^ (r % 8)) * 4 + p % 4
    hi, lo = split_reference(want[0][k:k + 1, j])
    assert tiles[at].item() == hi[0] and tiles[at + 64 * 32].item() == lo[0]


@pytest.mark.parametrize("beta", [100.0, 0.0])
def test_three_tf32_passes_hold_the_f32_limit_and_one_does_not(beta):
    """At the flagship's width (8x512, skip at 4), with softplus (beta 100)
    and with ReLU and the tanh head (beta 0): the emulated split-TF32
    forward stays within 2e-5 of the JAX f32 kernel (interpret mode) over
    2,048 seeded points, and a single TF32 pass fails that limit."""
    jm, params, tm = _jax_pair((512,) * 8, (4,), 3, beta=beta, seed=3)
    net = fused_mlp.FusedNet(tm, torch.float32)
    pts = np.random.default_rng(11).uniform(-1, 1, (2048, 3)).astype(np.float32)
    ref = np.asarray(pallas_mlp.fused_apply(jm, params, pts, tile_p=256, compute_dtype=np.float32,
                                            interpret=True))
    x = torch.from_numpy(pts)
    three = fused_mlp.forward_tf32_model(net, x, passes=3).numpy()
    one = fused_mlp.forward_tf32_model(net, x, passes=1).numpy()
    assert np.isfinite(three).all() and three.shape == ref.shape
    err3, err1 = np.abs(three - ref).max(), np.abs(one - ref).max()
    assert err3 <= TOL, err3
    assert err1 > TOL, err1
    # the plain f32 forward is the kernels' reference on the card; it agrees too
    assert np.abs(fused_mlp.forward_plain(net, x).numpy() - ref).max() <= TOL


def test_tf32_helpers_refuse_what_they_do_not_take():
    _, _, tm = _jax_pair((128,) * 3, (2,), 3)
    with pytest.raises(ValueError, match="f32"):
        fused_mlp.forward_tf32_model(fused_mlp.FusedNet(tm, torch.bfloat16), torch.zeros(4, 3))
    with pytest.raises(ValueError, match="passes"):
        fused_mlp.forward_tf32_model(fused_mlp.FusedNet(tm, torch.float32), torch.zeros(4, 3), passes=2)
    with pytest.raises(ValueError, match="f32 kernels"):
        fused_mlp.FusedNet(tm, torch.bfloat16).tf32_tiles
