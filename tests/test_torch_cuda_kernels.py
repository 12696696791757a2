"""The CUDA kernels against their plain versions at shapes the flagship does
not reach: the fused forward at one to four 128-column output groups, skip
and no skip, ReLU, a ragged last grid tile, 2-d points; the exact-SDF streams
at ragged tilings, sparse schedules and unvisited blocks. Needs an NVIDIA card:
a CUDA kernel has no CPU mode, so elsewhere these skip. On the card:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_kernels.py -q

(--noconftest: tests/conftest.py sets JAX up for the JAX package's tests;
these tests need no JAX, and the card's machine lacks flax.)
"""

import pytest
import torch

from sdf_representation_tpu_torch.models import ImplicitNet
from sdf_representation_tpu_torch.geometry.primitives import make_box, make_icosphere
from sdf_representation_tpu_torch.ops import fused_mlp as fm
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


def test_two_dimensional_points(device):
    model = ImplicitNet(d_in=2, hidden_dims=(128,) * 3, skip_in=(2,), radius_init=0.5,
                        generator=torch.Generator().manual_seed(1), device=device)
    net = fm.FusedNet(model, torch.float32)
    pts = torch.rand(777, 2, device=device) * 2 - 1
    _check(fm.fused_points(net, pts), fm.fused_points_plain(net, pts), torch.float32)


def test_too_wide_net_is_refused(device):
    model = ImplicitNet(hidden_dims=(640,) * 2, generator=torch.Generator().manual_seed(0),
                        device=device)
    with pytest.raises(ValueError, match="exceeds"):
        fm.fused_points(fm.FusedNet(model, torch.float32), torch.zeros(4, 3, device=device))


@pytest.mark.parametrize("tri_chunk,m,keep_frac", [
    (256, 256, 1.0), (256, 256, 0.6), (200, 300, 1.0), (1024, 8192, 0.5), (16, 40, 1.0),
])
def test_streams_match_plain(device, tri_chunk, m, keep_frac):
    """d^2 rtol 1e-5 / atol 1e-7, winners equal but for ties the f64 oracle
    proves, solid angles rtol 1e-4 / atol 1e-3 (tests/test_pallas_streams.py)."""
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
    assert ss.LAUNCHES == {"dist_stream": 1, "wind_stream": 1}
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


def test_signed_distance_on_the_card_matches_the_cpu_path(device):
    import numpy as np

    mesh = make_icosphere(3, 0.5)
    pts = np.random.default_rng(0).uniform(-1, 1, (5000, 3))
    ss.reset_launches()
    got, got_n = se.signed_distance(pts, mesh, tri_chunk=256)
    assert ss.LAUNCHES == {"dist_stream": 1, "wind_stream": 1}
    want, _ = se.signed_distance(pts, mesh, tri_chunk=256, device="cpu")
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert np.all(np.sign(got) == np.sign(want))
    np.testing.assert_allclose(np.linalg.norm(got_n, axis=1), 1.0, atol=1e-5)


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
