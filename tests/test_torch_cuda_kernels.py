"""The fused CUDA kernels against their plain versions at widths and shapes
the flagship does not reach (one to four 128-column output groups, skip and
no skip, ReLU, a ragged last grid tile, 2-d points). Needs an NVIDIA card:
a CUDA kernel has no CPU mode, so elsewhere these skip. On the card:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_kernels.py -q

(--noconftest: tests/conftest.py sets JAX up for the JAX package's tests;
these tests need no JAX, and the card's machine lacks flax.)
"""

import pytest
import torch

from sdf_representation_tpu_torch.models import ImplicitNet
from sdf_representation_tpu_torch.ops import fused_mlp as fm
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
