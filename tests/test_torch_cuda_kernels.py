"""The CUDA kernels against their plain versions at shapes the flagship does
not reach: the fused forward at one to four 128-column output groups, skip
and no skip, ReLU, a ragged last grid tile, 2-d points; the exact-SDF streams
at ragged tilings, sparse schedules and unvisited blocks, and sharded over
the card listed several times; the culled signed distance; the fused
(f, grad_x f) kernels and their backward at those widths, at point counts
below a tile and off a tile multiple, and through autograd; the hash
encoding's kernel pair against its plain version, its route and a graph's
capture of it; the bf16 kernels'
outputs bit for bit against digests recorded from the serial schedule of
their layer routine. Needs an NVIDIA card:
a CUDA kernel has no CPU mode, so elsewhere these skip. On the card:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_kernels.py -q

(--noconftest: tests/conftest.py sets JAX up for the JAX package's tests;
these tests need no JAX, and the card's machine lacks flax.)
"""

import hashlib

import pytest
import torch

from sdf_representation_tpu_torch.models import HashMLP, ImplicitNet
from sdf_representation_tpu_torch.geometry.primitives import make_box, make_icosphere
from sdf_representation_tpu_torch.ops import fused_igr as fi
from sdf_representation_tpu_torch.ops import fused_mlp as fm
from sdf_representation_tpu_torch.ops import hash_grid as hg
from sdf_representation_tpu_torch.ops import sdf_exact as se
from sdf_representation_tpu_torch.ops import sdf_streams as ss
from sdf_representation_tpu_torch.ops import sparse_grid as sg

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-3}  # chip_smoke.py's F32_TOL, BF16_TOL


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    from sdf_representation_tpu_torch.utils.device import resolve_device

    return resolve_device()


def _check(got, want, dt):
    torch.cuda.synchronize()
    assert got.shape == want.shape and torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= TOL[dt]


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hidden,skip,beta", [
    (64, (2,), 100.0), (200, (), 100.0), (384, (3,), 0.0), (509, (4,), 100.0),
])
def test_kernels_match_plain(device, hidden, skip, beta, dt):
    gen = torch.Generator().manual_seed(hidden)
    model = ImplicitNet(hidden_dims=(hidden,) * 5, skip_in=skip, beta=beta, radius_init=0.5,
                        generator=gen, device=device)
    net = fm.FusedNet(model, dt)
    pts = (torch.rand(3001, 3, generator=gen) * 2 - 1).to(device)
    _check(fm.fused_points(net, pts), fm.fused_points_plain(net, pts), dt)
    _check(fm.fused_grid(net, 23), fm.fused_grid_plain(net, 23), dt)  # 23^3 % 64 != 0
    n, block = 32, 8
    _, mask, _ = sg.coarse_and_certificate(model, n, block, 1.5, 0.01)
    ids = torch.nonzero(mask).flatten().to(torch.int32)
    count = torch.tensor([ids.numel()], dtype=torch.int32, device=device)
    padded = torch.cat([ids, torch.zeros(5, dtype=torch.int32, device=device)])
    blocks = fm.fused_blocks(net, padded, count, n, block)[: ids.numel()]
    _check(blocks, fm.fused_blocks_plain(net, ids, count, n, block), dt)
    nb = n // block
    dense = fm.fused_grid(net, n).reshape(nb, block, nb, block, nb, block)
    dense = dense.permute(0, 2, 4, 1, 3, 5).reshape(-1, block ** 3)[ids.long()]
    assert torch.equal(blocks, dense)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_two_dimensional_points(device, dt):
    model = ImplicitNet(d_in=2, hidden_dims=(128,) * 3, skip_in=(2,), radius_init=0.5,
                        generator=torch.Generator().manual_seed(1), device=device)
    net = fm.FusedNet(model, dt)
    pts = torch.rand(777, 2, device=device) * 2 - 1
    _check(fm.fused_points(net, pts), fm.fused_points_plain(net, pts), dt)


def test_too_wide_net_is_refused(device):
    model = ImplicitNet(hidden_dims=(640,) * 2, generator=torch.Generator().manual_seed(0),
                        device=device)
    with pytest.raises(ValueError, match="exceeds"):
        fm.fused_points(fm.FusedNet(model, torch.float32), torch.zeros(4, 3, device=device))


@pytest.mark.parametrize("tri_chunk,m,keep_frac", [
    (256, 256, 1.0), (256, 256, 0.6), (200, 300, 1.0), (1024, 8192, 0.5), (16, 40, 1.0),
    (128, 1000, 0.7), (2048, 700, 1.0),
])
def test_streams_match_plain(device, tri_chunk, m, keep_frac):
    """d^2 rtol 1e-5 / atol 1e-7, winners equal but for ties the f64 oracle
    proves, solid angles rtol 1e-4 / atol 1e-3 (tests/test_pallas_streams.py).
    Point counts off the kernels' 512 points a CTA, chunks from 16 to 2048
    triangles (ragged and padded ring stages), a block no step visits and
    the sink row."""
    import numpy as np

    mesh = make_icosphere(3, 0.6) if tri_chunk > 16 else make_box()
    rng = np.random.default_rng(tri_chunk + m)
    n_blocks = 5
    pts = rng.uniform(-1, 1, (n_blocks, m, 3)).astype(np.float32)
    tables, n_faces = se._triangle_tables(mesh.vertices, mesh.faces, tri_chunk)
    keep = rng.uniform(size=(n_blocks, tables["a"].shape[0])) < keep_frac
    keep[:, 0] = True
    keep[3] = False  # one block no step visits
    sb, sc, _ = ss.stream_steps(keep, n_blocks)
    P = torch.from_numpy(pts).to(device)
    ss.reset_launches()
    d2, best = ss.dist_stream(P, sb, sc, tables, tri_chunk)
    w = ss.wind_stream(P, sb, sc, tables, tri_chunk)
    torch.cuda.synchronize()
    assert ss.LAUNCHES == {"dist_stream": 1, "wind_stream": 1, "dist_stream_sharded": 0,
                           "wind_stream_sharded": 0}
    pd2, pbest = ss.dist_stream_plain(P, sb, sc, tables, tri_chunk)
    pw = ss.wind_stream_plain(P, sb, sc, tables, tri_chunk)
    assert torch.isinf(d2[3]).all() and (best[3] == 0).all() and (w[3] == 0).all()
    assert torch.isinf(d2[n_blocks]).all() and (w[n_blocks] == 0).all()
    torch.testing.assert_close(d2, pd2, rtol=1e-5, atol=1e-7)
    torch.testing.assert_close(w, pw, rtol=1e-4, atol=1e-3)
    diff = torch.nonzero(best.flatten() != pbest.flatten()).flatten().cpu().numpy()
    if len(diff):
        q = pts.reshape(-1, 3)[diff].astype(np.float64)  # the sink row never differs
        tri = mesh.vertices[mesh.faces]
        a = tri[best.flatten().cpu().numpy()[diff]]
        b = tri[pbest.flatten().cpu().numpy()[diff]]
        da = np.linalg.norm(q - se.closest_point_on_triangles(q, a), axis=1)
        db = np.linalg.norm(q - se.closest_point_on_triangles(q, b), axis=1)
        np.testing.assert_allclose(da, db, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("mesh_name,tri_chunk", [("box", 128), ("icosphere", 128),
                                                  ("icosphere", 2048)])
def test_stream_ties_repeats_and_rings(device, mesh_name, tri_chunk):
    """Every face twice (faces then the same faces again): the first copy wins
    each tie, as in the plain version. On the box, with points on a 1/64 grid
    (off its faces), every step is exact: d^2 equals the plain version's bit
    for bit and so do the winners. On icosphere(4) doubled: winners lie in
    the first copy and differ from the plain version's only on f64-oracle
    ties, d^2 and solid angles within the stream limits. Two launches of
    each kernel agree bit for bit. The ring holds one chunk of one stage
    (box), 80 chunks of one stage each, or 5 chunks of 16 stages each."""
    import numpy as np

    mesh = make_box() if mesh_name == "box" else make_icosphere(4, 0.6)
    F = len(mesh.faces)
    faces = np.concatenate([mesh.faces, mesh.faces])
    rng = np.random.default_rng(tri_chunk)
    if mesh_name == "box":
        pts = (2 * rng.integers(-48, 48, (2, 700, 3)) + 1) / 64.0
    else:
        pts = rng.uniform(-1, 1, (2, 700, 3))
    pts = pts.astype(np.float32)
    tables, _ = se._triangle_tables(mesh.vertices, faces, tri_chunk)
    sb, sc, _ = ss.stream_steps(np.ones((2, tables["a"].shape[0]), bool), 2)
    P = torch.from_numpy(pts).to(device)
    d2, best = ss.dist_stream(P, sb, sc, tables, tri_chunk)
    w = ss.wind_stream(P, sb, sc, tables, tri_chunk)
    d2b, bestb = ss.dist_stream(P, sb, sc, tables, tri_chunk)
    wb = ss.wind_stream(P, sb, sc, tables, tri_chunk)
    torch.cuda.synchronize()
    assert torch.equal(d2, d2b) and torch.equal(best, bestb) and torch.equal(w, wb)
    pd2, pbest = ss.dist_stream_plain(P, sb, sc, tables, tri_chunk)
    pw = ss.wind_stream_plain(P, sb, sc, tables, tri_chunk)
    assert (best[:2] < F).all() and (pbest[:2] < F).all()
    torch.testing.assert_close(w, pw, rtol=1e-4, atol=1e-3)
    if mesh_name == "box":
        assert torch.equal(d2, pd2) and torch.equal(best, pbest)
        return
    torch.testing.assert_close(d2, pd2, rtol=1e-5, atol=1e-7)
    diff = torch.nonzero(best[:2].flatten() != pbest[:2].flatten()).flatten().cpu().numpy()
    q = pts.reshape(-1, 3)[diff].astype(np.float64)
    tri = mesh.vertices[faces]
    da = np.linalg.norm(q - se.closest_point_on_triangles(q, tri[best[:2].flatten().cpu().numpy()[diff]]), axis=1)
    db = np.linalg.norm(q - se.closest_point_on_triangles(q, tri[pbest[:2].flatten().cpu().numpy()[diff]]), axis=1)
    np.testing.assert_allclose(da, db, rtol=1e-5, atol=1e-6)


def test_signed_distance_on_the_card_matches_the_cpu_path(device):
    import numpy as np

    mesh = make_icosphere(3, 0.5)
    pts = np.random.default_rng(0).uniform(-1, 1, (5000, 3))
    ss.reset_launches()
    got, got_n = se.signed_distance(pts, mesh, tri_chunk=256)
    assert ss.LAUNCHES == {"dist_stream": 1, "wind_stream": 1, "dist_stream_sharded": 0,
                           "wind_stream_sharded": 0}
    want, _ = se.signed_distance(pts, mesh, tri_chunk=256, device="cpu")
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert np.all(np.sign(got) == np.sign(want))
    np.testing.assert_allclose(np.linalg.norm(got_n, axis=1), 1.0, atol=1e-5)


@pytest.mark.parametrize("n_dev", [2, 4])
def test_sharded_streams_on_the_card(device, n_dev):
    """Kernels 6 and 7: the card listed n_dev times holds n_dev shards; the
    results equal one launch over all blocks bit for bit, and the plain
    sharded walk within the stream limits."""
    import numpy as np

    mesh = make_icosphere(3, 0.6)
    rng = np.random.default_rng(n_dev)
    pts = rng.uniform(-1, 1, (8, 512, 3)).astype(np.float32)
    tables, _ = se._triangle_tables(mesh.vertices, mesh.faces, 256)
    keep = rng.uniform(size=(8, tables["a"].shape[0])) < 0.6
    keep[5] = False
    sb, sc, _ = ss.stream_steps(keep, 8)
    P = torch.from_numpy(pts).to(device)
    mesh_devices = (device,) * n_dev
    ss.reset_launches()
    d2, best = ss.dist_stream_sharded(P, sb, sc, tables, 256, mesh_devices)
    w = ss.wind_stream_sharded(P, sb, sc, tables, 256, mesh_devices)
    assert ss.LAUNCHES == {"dist_stream": 0, "wind_stream": 0, "dist_stream_sharded": n_dev,
                           "wind_stream_sharded": n_dev}
    one_d2, one_best = ss.dist_stream(P, sb, sc, tables, 256)
    one_w = ss.wind_stream(P, sb, sc, tables, 256)
    np.testing.assert_array_equal(d2, one_d2[:8].cpu().numpy())
    np.testing.assert_array_equal(best, one_best[:8].cpu().numpy())
    np.testing.assert_array_equal(w, one_w[:8].cpu().numpy())
    pd2, _ = ss.dist_stream_sharded_plain(P, sb, sc, tables, 256, mesh_devices)
    pw = ss.wind_stream_sharded_plain(P, sb, sc, tables, 256, mesh_devices)
    finite = np.isfinite(pd2)
    np.testing.assert_allclose(d2[finite], pd2[finite], rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(w, pw, rtol=1e-4, atol=1e-3)


def test_culled_on_the_card_matches_the_cpu_path(device):
    import numpy as np

    from sdf_representation_tpu_torch.ops import sdf_culled

    mesh = make_icosphere(4, 0.6)
    pts = np.random.default_rng(1).uniform(-1, 1, (20000, 3))
    ss.reset_launches()
    got, _ = sdf_culled.signed_distance_culled(pts, mesh, point_chunk=1024, tri_chunk=128)
    assert ss.LAUNCHES["dist_stream"] == 1 and ss.LAUNCHES["wind_stream"] == 1
    sharded, _ = sdf_culled.signed_distance_culled(pts, mesh, point_chunk=1024, tri_chunk=128,
                                                   devices=(device,) * 4)
    assert ss.LAUNCHES["dist_stream_sharded"] == 4 and ss.LAUNCHES["wind_stream_sharded"] == 4
    np.testing.assert_array_equal(sharded, got)
    want, _ = sdf_culled.signed_distance_culled(pts, mesh, point_chunk=1024, tri_chunk=128,
                                                device="cpu")
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert np.all(np.sign(got) == np.sign(want))


def test_streams_refuse_what_the_kernels_do_not_take(device):
    import numpy as np

    mesh = make_box()
    tables, _ = se._triangle_tables(mesh.vertices, mesh.faces, 16)
    sb, sc, _ = ss.stream_steps(np.ones((1, 1), bool), 1)
    P = torch.zeros(1, 8, 3, device=device)
    with pytest.raises(ValueError, match="contiguous"):
        ss.dist_stream(P.expand(2, 8, 3)[:, ::2], sb, sc, tables, 16)
    with pytest.raises(ValueError, match="outside the table"):
        ss.wind_stream(P, sb, sc + 7, tables, 16)


# ---- the fused (f, grad_x f) kernels and their backward ----------------------

@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hidden,layers,skip,beta,n,d_in", [
    (64, 4, (2,), 100.0, 200, 3), (200, 2, (), 100.0, 17, 3), (384, 3, (1,), 100.0, 1000, 3),
    (509, 5, (4,), 100.0, 3001, 3), (256, 1, (), 100.0, 64, 3), (128, 3, (2,), 100.0, 500, 2),
    (256, 2, (1,), 100.0, 129, 4),
])
def test_igr_kernels_match_plain(device, hidden, layers, skip, beta, n, d_in, dt):
    """f, grad f, and every dW and db against the plain versions, at the four
    padded widths (128, 256, 384, 512) and d_in 2-4. Limits: f32 1e-4 of
    each tensor's largest entry (summation order, carried on by sigma' with
    a factor of up to beta / 4; the split-TF32 products); bf16 max 1e-2 of it and
    mean 1e-3 (a sum in another order can round to the neighbouring bf16
    value)."""
    gen = torch.Generator().manual_seed(hidden + n)
    model = ImplicitNet(d_in=d_in, hidden_dims=(hidden,) * layers, skip_in=skip, beta=beta,
                        radius_init=0.5, generator=gen, device=device)
    net = fm.FusedNet(model, dt)
    x = (torch.rand(n, d_in, generator=gen) * 2 - 1).to(device)
    a = (torch.randn(n, generator=gen) / n).to(device)
    c = (torch.randn(n, d_in, generator=gen) / n).to(device)
    max_tol, mean_tol = (1e-4, 1e-5) if dt == torch.float32 else (1e-2, 1e-3)

    def close(got, want, what):
        scale = max(float(want.abs().max()), 1e-6)
        diff = (got - want).abs() / scale
        assert torch.isfinite(got).all(), what
        assert float(diff.max()) <= max_tol and float(diff.mean()) <= mean_tol, what

    before = dict(fi.LAUNCHES)
    f, g = fi.fused_value_and_grad(net, x)
    grads = fi.fused_param_grads(net, x, a, c)
    torch.cuda.synchronize()
    assert fi.LAUNCHES == {"igr_fwd": before["igr_fwd"] + 1, "igr_bwd": before["igr_bwd"] + 1}
    pf, pg = fi.fused_value_and_grad_plain(net, x)
    close(f, pf, "f")
    close(g, pg, "grad f")
    shapes = [w.shape for w, _ in model.effective_layers()]
    got = fi.unpack_grads(d_in, shapes, grads)
    want = fi.unpack_grads(d_in, shapes, fi.fused_param_grads_plain(net, x, a, c))
    for i, (u, v) in enumerate(zip(got, want)):
        close(u, v, f"gradient {i}")


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hidden", [128, 256, 384, 512])
def test_igr_relu_tanh_head(device, hidden, dt):
    """ReLU + tanh head: step'(z) flips where z changes sign under another
    summation order, which moves grad f at single points by a whole term, so
    grad f and the gradients are held by their mean."""
    gen = torch.Generator().manual_seed(5)
    model = ImplicitNet(hidden_dims=(hidden,) * 4, skip_in=(2,), beta=0.0, radius_init=0.5,
                        generator=gen, device=device)
    net = fm.FusedNet(model, dt)
    x = (torch.rand(2000, 3, generator=gen) * 2 - 1).to(device)
    a = (torch.randn(2000, generator=gen) / 2000).to(device)
    c = (torch.randn(2000, 3, generator=gen) / 2000).to(device)
    f, g = fi.fused_value_and_grad(net, x)
    pf, pg = fi.fused_value_and_grad_plain(net, x)
    assert float((f - pf).abs().max()) <= (2e-5 if dt == torch.float32 else 3e-3)
    assert float((g - pg).abs().mean()) <= 1e-4
    shapes = [w.shape for w, _ in model.effective_layers()]
    got = fi.unpack_grads(3, shapes, fi.fused_param_grads(net, x, a, c))
    want = fi.unpack_grads(3, shapes, fi.fused_param_grads_plain(net, x, a, c))
    for u, v in zip(got, want):
        assert float((u - v).abs().mean()) <= 1e-2 * max(float(v.abs().mean()), 1e-6)


@pytest.mark.parametrize("beta", [100.0, 0.0])
def test_igr_bwd_bf16_is_reproducible(device, beta):
    """The bf16 backward sums dW and db in a fixed order (no atomics): two
    launches on one input give the same gradients bit for bit."""
    gen = torch.Generator().manual_seed(11)
    model = ImplicitNet(hidden_dims=(512,) * 8, skip_in=(4,), beta=beta, radius_init=0.5,
                        generator=gen, device=device)
    net = fm.FusedNet(model, torch.bfloat16)
    x = (torch.rand(4999, 3, generator=gen) * 2 - 1).to(device)
    a = (torch.randn(4999, generator=gen) / 4999).to(device)
    c = (torch.randn(4999, 3, generator=gen) / 4999).to(device)
    one, two = fi.fused_param_grads(net, x, a, c), fi.fused_param_grads(net, x, a, c)
    for p, q in zip(one, two):
        for u, v in zip(p, q):
            assert (u is None and v is None) or torch.equal(u, v)


@pytest.mark.parametrize("hidden,skip,beta,d_in", [(512, (4,), 100.0, 3), (256, (2,), 0.0, 3),
                                                   (128, (1,), 100.0, 2)])
def test_igr_bwd_bf16_passes(device, hidden, skip, beta, d_in):
    """The bf16 backward's two passes on their own: the first pass's
    workspace against ``images_plain`` (bf16 values, equal but where a sum
    in another order rounds to the neighbouring value, 2^-8 relative, which
    later layers carry on: the mean difference within 1e-2 of the mean
    value, where a misplaced row or column reads ~1), and the dW pass on that
    same plain workspace against ``dw_pass_plain`` (bf16 products, exact
    sums: within 1e-5 of each buffer's largest entry)."""
    gen = torch.Generator().manual_seed(hidden)
    model = ImplicitNet(d_in=d_in, hidden_dims=(hidden,) * 5, skip_in=skip, beta=beta,
                        radius_init=0.5, generator=gen, device=device)
    net = fm.FusedNet(model, torch.bfloat16)
    n = 1000
    x = (torch.rand(n, d_in, generator=gen) * 2 - 1).to(device)
    a = (torch.randn(n, generator=gen) / n).to(device)
    c = (torch.randn(n, d_in, generator=gen) / n).to(device)
    _, _, (found_ws, found_partial) = fi._bwd_cuda(net, x, a, c)
    ws, partial = fi.images_plain(net, x, a, c)
    torch.cuda.synchronize()
    diff = (found_ws.float() - ws.float()).abs()
    assert float(diff.mean()) <= 1e-2 * float(ws.float().abs().mean())
    scale = float(partial.abs().max())
    assert float((found_partial - partial).abs().mean()) <= 1e-3 * scale
    gw, gb = fi.dw_pass(net, ws, partial)
    pw, pb = fi.dw_pass_plain(net, ws, partial)
    assert float((gw - pw).abs().max()) <= 1e-5 * float(pw.abs().max())
    assert float((gb - pb).abs().max()) <= 1e-5 * float(pb.abs().max())


@pytest.mark.parametrize("beta", [100.0, 0.0])
def test_igr_bwd_f32_is_reproducible(device, beta):
    """The f32 backward sums dW and db in a fixed order too (its dW pass
    owns tiles of dW and loops over the rows in order; db from per-warp
    partial sums): two launches give the same gradients bit for bit, at N
    = 4,999 (8x512) and at 5,461 (8x256, where the pass cuts each job's rows
    into parts summed in order)."""
    for hidden, n in ((512, 4999), (256, 5461)):
        gen = torch.Generator().manual_seed(11)
        model = ImplicitNet(hidden_dims=(hidden,) * 8, skip_in=(4,), beta=beta, radius_init=0.5,
                            generator=gen, device=device)
        net = fm.FusedNet(model, torch.float32)
        x = (torch.rand(n, 3, generator=gen) * 2 - 1).to(device)
        a = (torch.randn(n, generator=gen) / n).to(device)
        c = (torch.randn(n, 3, generator=gen) / n).to(device)
        one, two = fi.fused_param_grads(net, x, a, c), fi.fused_param_grads(net, x, a, c)
        for p, q in zip(one, two):
            for u, v in zip(p, q):
                assert (u is None and v is None) or torch.equal(u, v)


@pytest.mark.parametrize("hidden,skip,beta,d_in", [(512, (4,), 100.0, 3), (256, (2,), 0.0, 3),
                                                   (128, (1,), 100.0, 2)])
def test_igr_bwd_f32_passes(device, hidden, skip, beta, d_in):
    """The f32 backward's two passes on their own: the first pass's
    workspace ([h; tc] in the slot order, [dz; dtcz] as split images)
    against ``images_plain`` (f32 values that differ by the summation
    order: the mean difference within 1e-2 of the mean value, where a
    misplaced row or column reads ~1; the per-warp db sums within 1e-3 of
    the largest on average), and the dW pass on that same plain workspace
    against ``dw_pass_plain`` (the split-TF32 products summed in f64:
    within 1e-5 of each buffer's largest entry)."""
    gen = torch.Generator().manual_seed(hidden)
    model = ImplicitNet(d_in=d_in, hidden_dims=(hidden,) * 5, skip_in=skip, beta=beta,
                        radius_init=0.5, generator=gen, device=device)
    net = fm.FusedNet(model, torch.float32)
    n = 1000
    x = (torch.rand(n, d_in, generator=gen) * 2 - 1).to(device)
    a = (torch.randn(n, generator=gen) / n).to(device)
    c = (torch.randn(n, d_in, generator=gen) / n).to(device)
    _, _, (found_ws, found_partial) = fi._bwd_cuda(net, x, a, c)
    ws, partial = fi.images_plain(net, x, a, c)
    torch.cuda.synchronize()
    assert float((found_ws - ws).abs().mean()) <= 1e-2 * float(ws.abs().mean())
    assert float((found_partial - partial).abs().mean()) <= 1e-3 * float(partial.abs().max())
    gw, gb = fi.dw_pass(net, ws, partial)
    pw, pb = fi.dw_pass_plain(net, ws, partial)
    assert float((gw - pw).abs().max()) <= 1e-5 * float(pw.abs().max())
    assert float((gb - pb).abs().max()) <= 1e-5 * float(pb.abs().max())


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_igr_sharded_with_empty_shards(device, dt):
    """Three points over the card listed four times: the last shard is
    empty, launches nothing and adds zeros, so the parameter gradients are
    the single-device call's (up to the order of the shards' sum). Freed
    buffers of the gradients' size are filled with NaN first, so that an
    empty shard returning unwritten memory shows."""
    gen = torch.Generator().manual_seed(3)
    model = ImplicitNet(hidden_dims=(256,) * 4, skip_in=(2,), beta=100.0, radius_init=0.5,
                        generator=gen, device=device)
    x = (torch.rand(3, 3, generator=gen) * 2 - 1).to(device)

    def grads(vag):
        model.zero_grad(set_to_none=True)
        f, g = vag(x)
        (f.square().sum() + g.sin().sum()).backward()
        return [p.grad.clone() for p in model.parameters()]

    one = grads(fi.make_fused_value_and_grad(model, dt))
    wbuf, bbuf, _ = fm.FusedNet(model, dt).packed
    poison = [torch.full((k.numel(),), float("nan"), device=device) for k in (wbuf, bbuf) * 4]
    del poison
    before = dict(fi.LAUNCHES)
    four = grads(fi.make_fused_value_and_grad_sharded(model, (device,) * 4, dt))
    assert fi.LAUNCHES == {"igr_fwd": before["igr_fwd"] + 3, "igr_bwd": before["igr_bwd"] + 3}
    for u, v in zip(four, one):
        assert torch.isfinite(u).all()
        torch.testing.assert_close(u, v, rtol=1e-5, atol=1e-6 * float(v.abs().max()))


# The bf16 tensor-core routine of csrc/hopper.cuh adds its 32-deep sums in a
# fixed order, whatever its issue schedule, so its outputs are held bit for
# bit: (hidden width, depth, skip, beta, N), seeded inputs and weights.
BF16_IGR_CASES = {"8x512/n16384": (512, 8, (4,), 100.0, 16384),
                  "8x256/n5461": (256, 8, (4,), 100.0, 5461),
                  "4x512/relu": (512, 4, (2,), 0.0, 4096)}


def _digest(t):
    return hashlib.sha256(t.contiguous().cpu().numpy().tobytes()).hexdigest()[:16]


def bf16_igr_digests(case, device):
    """Digests of the bf16 igr_fwd outputs (f, grad f) and the packed igr_bwd
    outputs (dW, db) of a case of BF16_IGR_CASES."""
    hidden, depth, skip, beta, n = BF16_IGR_CASES[case]
    gen = torch.Generator().manual_seed(hidden + depth + n)
    model = ImplicitNet(hidden_dims=(hidden,) * depth, skip_in=skip, beta=beta, radius_init=0.5,
                        generator=gen, device=device)
    net = fm.FusedNet(model, torch.bfloat16)
    x = (torch.rand(n, 3, generator=gen) * 2 - 1).to(device)
    a = (torch.randn(n, generator=gen) / n).to(device)
    c = (torch.randn(n, 3, generator=gen) / n).to(device)
    f, g = fi.fused_value_and_grad(net, x)
    gw, gb, _ = fi._bwd_cuda(net, x, a, c)
    torch.cuda.synchronize()
    return {"f": _digest(f), "grad_f": _digest(g), "dw": _digest(gw), "db": _digest(gb)}


def bf16_grid_digest(device):
    """Digest of one bf16 fused_grid call at n = 128 on the seeded 8x512 net."""
    model = ImplicitNet(hidden_dims=(512,) * 8, skip_in=(4,), beta=100.0, radius_init=0.5,
                        generator=torch.Generator().manual_seed(128), device=device)
    out = fm.fused_grid(fm.FusedNet(model, torch.bfloat16), 128)
    torch.cuda.synchronize()
    return _digest(out)


# recorded on an NVIDIA H100 80GB HBM3 from commit 3778b76 (the serial
# schedule: each group waited for before its add)
BF16_IGR_DIGESTS = {
    "8x512/n16384": {"f": "f8de6782203c43fb", "grad_f": "26317e9907d72b59", "dw": "eb92889b621cfb03",
                     "db": "2374e33c381522d3"},
    "8x256/n5461": {"f": "77faeeb1e37ee1d0", "grad_f": "26d015763c2829fd", "dw": "a05f1992a2e3eaf2",
                    "db": "fb61d4c5e536c2df"},
    "4x512/relu": {"f": "958a6a2f13f27ce9", "grad_f": "52933652254255cd", "dw": "c1ef766fcd23f13e",
                   "db": "00e976efaafb1757"},
}
BF16_GRID_DIGEST = "41eefb8e032fd399"  # the same commit and card


@pytest.mark.parametrize("case", sorted(BF16_IGR_CASES))
def test_igr_bf16_bit_equal_to_recorded(device, case):
    assert bf16_igr_digests(case, device) == BF16_IGR_DIGESTS[case]


def test_fused_grid_bf16_bit_equal_to_recorded(device):
    assert bf16_grid_digest(device) == BF16_GRID_DIGEST


def test_igr_autograd_on_the_card(device):
    """The autograd.Function on the card: parameter gradients agree with
    autograd through the shared-matmul derivation; x gets none."""
    from sdf_representation_tpu_torch.ops.diffops import implicitnet_value_and_grad

    gen = torch.Generator().manual_seed(9)
    model = ImplicitNet(hidden_dims=(128,) * 3, skip_in=(2,), beta=100.0, radius_init=0.5,
                        generator=gen, device=device)
    x = (torch.rand(777, 3, generator=gen) * 2 - 1).to(device).requires_grad_(True)

    def loss(f, g):
        return torch.mean(torch.sin(3.0 * f)) + torch.mean((torch.sum(g * g, -1) - 1.0) ** 2)

    loss(*fi.make_fused_value_and_grad(model, torch.float32)(x)).backward()
    got = {n: p.grad.clone() for n, p in model.named_parameters()}
    assert x.grad is None
    model.zero_grad()
    loss(*implicitnet_value_and_grad(model, x.detach())).backward()
    for name, p in model.named_parameters():
        scale = float(p.grad.abs().max())
        assert float((got[name] - p.grad).abs().max()) <= 1e-4 * scale, name


def test_igr_refusals(device):
    model = ImplicitNet(hidden_dims=(640,) * 2, skip_in=(), beta=100.0, device=device)
    x = torch.zeros(8, 3, device=device)
    with pytest.raises(ValueError, match="exceeds"):
        fi.fused_value_and_grad(fm.FusedNet(model, torch.float32), x)
    small = ImplicitNet(hidden_dims=(64,) * 2, skip_in=(), beta=100.0, device=device)
    with pytest.raises(ValueError, match="float32"):
        fi.fused_value_and_grad(fm.FusedNet(small, torch.float32), x.double())
    with pytest.raises(ValueError, match="weights are on"):
        fi.fused_value_and_grad(fm.FusedNet(small.cpu(), torch.float32), x)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_dev", [2, 4])
def test_sharded_grid_on_the_card(device, n_dev, dt):
    """Kernel 10: the card listed n_dev times, one fused_grid_tiles launch
    per shard, bit-equal to one fused_grid launch (n = 23: the tiles do not
    divide the shards evenly, the padded tail is dropped); kernel 11: one
    fused_blocks launch per shard, bit-equal to the dense kernel on every
    active block, the count that of the single-device sparse evaluator."""
    from sdf_representation_tpu_torch.ops import sharded_eval

    model = ImplicitNet(hidden_dims=(128,) * 4, skip_in=(2,), radius_init=0.5,
                        generator=torch.Generator().manual_seed(7), device=device)
    mesh = (device,) * n_dev
    fm.reset_launches()
    vol = sharded_eval.sharded_grid_eval(model, 23, mesh, tile_p=128, compute_dtype=dt)
    assert fm.LAUNCHES["sharded_grid"] == n_dev and fm.LAUNCHES["fused_grid"] == 0
    dense = fm.fused_grid_eval(model, 23, compute_dtype=dt)
    assert torch.equal(vol, dense)
    n, block = 64, 8
    fm.reset_launches()
    sparse, count = sharded_eval.sparse_sharded_grid_eval(model, n, mesh, compute_dtype=dt,
                                                          return_count=True)
    assert fm.LAUNCHES["sparse_sharded_blocks"] == n_dev and fm.LAUNCHES["sparse_blocks"] == 0
    _, single = sg.sparse_grid_eval(model, n, compute_dtype=dt, return_count=True)
    assert count == single
    _, mask, _ = sg.coarse_and_certificate(model, n, block, 1.5, 0.01)
    nb = n // block
    dense = fm.fused_grid_eval(model, n, compute_dtype=dt).reshape(nb, block, nb, block, nb, block)
    got = sparse.reshape(nb, block, nb, block, nb, block)
    active = mask.reshape(nb, nb, nb)
    assert torch.equal(got.permute(0, 2, 4, 1, 3, 5)[active], dense.permute(0, 2, 4, 1, 3, 5)[active])


def test_sharded_igr_on_the_card(device):
    """make_fused_value_and_grad_sharded over the card listed 4 times: one
    igr_fwd and one igr_bwd launch per shard; f32 parameter gradients within
    rtol 2e-4 / atol 2e-5 of the single-device op (tests/test_sharding.py)."""
    model = ImplicitNet(hidden_dims=(256,) * 4, skip_in=(2,), radius_init=0.5,
                        generator=torch.Generator().manual_seed(3), device=device)
    x = torch.rand(1001, 3, device=device) * 2 - 1
    a, c = torch.randn(1001, device=device), torch.randn(1001, 3, device=device)
    grads = []
    for vag in (fi.make_fused_value_and_grad(model, torch.float32),
                fi.make_fused_value_and_grad_sharded(model, (device,) * 4, torch.float32)):
        model.zero_grad(set_to_none=True)
        fi.reset_launches()
        f, g = vag(x)
        ((a * f).sum() + (c * g).sum()).backward()
        grads.append([p.grad.clone() for p in model.parameters()])
    assert fi.LAUNCHES == {"igr_fwd": 4, "igr_bwd": 4}
    for one, shd in zip(*grads):
        torch.testing.assert_close(shd, one, rtol=2e-4, atol=2e-5)


def _hash_model(device, n_features=2, seed=4):
    """4 levels of 2^9 rows (resolution 4 dense, 8-32 hashed), tables in +-0.1."""
    model = HashMLP(n_levels=4, n_features=n_features, log2_table_size=9, base_resolution=4,
                    max_resolution=32, hidden_dim=16, num_layers=3,
                    generator=torch.Generator().manual_seed(seed), device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    with torch.no_grad():
        model.tables.uniform_(-0.1, 0.1, generator=gen)
    x = torch.rand(3001, 3, device=device, generator=gen) * 2.1 - 1.05
    x[:3] = torch.tensor([[-1.0, -1, -1], [1, 1, 1], [0, 0, 0]], device=device)
    return model, x


@pytest.mark.parametrize("n_features", [2, 3])
def test_hash_encoding_kernels_match_the_plain_path(device, n_features):
    """hash_encode_fwd / bwd (F = 2 compiled, 3 at run time) against
    encode_plain: features within 1e-6, the tables' gradient within 1e-6 of
    its largest entry (float32 sums in other orders: the corners' FMA chain,
    the atomics)."""
    model, x = _hash_model(device, n_features)
    tables, res = model.tables.detach(), model.resolutions
    up = torch.randn(len(x), 4 * n_features, device=device)
    hg.reset_launches()
    got = hg.encode_fwd_cuda(x, tables, res)
    grad = hg.encode_bwd_cuda(x, up, tuple(tables.shape), res)
    plain_t = tables.clone().requires_grad_(True)
    want = hg.encode_plain(x, plain_t, res)
    want.backward(up)
    torch.cuda.synchronize()
    assert hg.LAUNCHES == {"hash_encode_fwd": 1, "hash_encode_bwd": 1}
    assert (got - want).abs().max().item() <= 1e-6
    assert (grad - plain_t.grad).abs().max().item() <= 1e-6 * plain_t.grad.abs().max().item()


def test_hash_encoding_route_on_the_card(device):
    """Float32 tables and points that need no gradient take the kernels;
    points that need one and bfloat16 tables the plain path; both agree.
    Float64 points with float32 tables raise."""
    model, x = _hash_model(device)
    hg.reset_launches()
    f_kernel = model(x)
    f_plain = model(x.clone().requires_grad_(True))
    torch.func.functional_call(model, {k: v.to(torch.bfloat16) for k, v in model.state_dict().items()},
                               (x.to(torch.bfloat16),))
    assert hg.ROUTE == {"kernel": 1, "plain": 2} and hg.LAUNCHES["hash_encode_fwd"] == 1
    assert (f_kernel - f_plain).abs().max().item() <= 1e-6
    with pytest.raises(ValueError):
        model(x.double())


def test_hash_encoding_in_a_captured_graph(device):
    """Forward and backward captured once: each replay gives the eager
    features and, within the atomics' reordering, the eager gradient."""
    model, x = _hash_model(device)
    up = torch.randn(len(x), 8, device=device)

    def step():
        model.tables.grad = None
        feats = hg.encode(x, model.tables, model.resolutions)
        feats.backward(up)
        return feats.detach(), model.tables.grad

    eager_f, eager_g = (t.clone() for t in step())
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out_f, out_g = step()
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out_f, eager_f)
        assert (out_g - eager_g).abs().max().item() <= 1e-6 * eager_g.abs().max().item()
