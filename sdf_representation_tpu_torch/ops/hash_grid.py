"""Instant-NGP's multiresolution hash encoding: the plain version and the
kernel pair of ``csrc/hash_grid.cu``.

``encode(x, tables, resolutions)`` maps (B, 3) points in [-1, 1]^3 to (B,
L*F) features from the (L, T, F) tables: at each level the point's 8 lattice
corners (the row where the level's (res+1)^3 corners fit its T rows, else
the uint32 hash (x * 1) ^ (y * 2654435761) ^ (z * 805459861) mod T),
interpolated trilinearly. It takes one of two routes, and ``ROUTE`` counts
the calls by route:

  ``kernel``  float32 tables on a card, and points that need no gradient
              (reverse- or forward-mode, or under a ``torch.func``
              transform): ``hash_encode_fwd_kernel``, and as its backward
              ``hash_encode_bwd_kernel``, which adds every corner's share of
              the features' gradient into the tables' gradient with float32
              atomics (its last bits vary from run to run). A
              ``torch.autograd.Function`` on the current stream that
              allocates only with ``torch`` and calls the kernels with
              arguments fixed at the call, so a CUDA graph captures it. The
              points must then be float32 (n, 3) on the tables' card: any
              other raises, so such a call never takes the plain route
              unseen.
  ``plain``   every other call: the CPU, bfloat16 tables (the trainer's
              bfloat16 step), and points that need a gradient (the eikonal
              losses' forward-mode passes): ``encode_plain``, one gather of
              the B*L*8 corner rows from the stacked tables, autograd's
              scatter-add as its backward (the JAX package's encode).

Both routes compute the corners with the same float32 arithmetic: x01 =
clip((x + 1) * 0.5, 0, 1), pos = x01 * res, p0 = floor(pos), frac = pos -
p0, weights ((wx * wy) * wz); the kernels sum the 8 weighted rows with FMAs,
the plain version rounds each product, so features differ by float32
rounding.

The kernels launch inside ``span("hash.encode")`` and
``span("hash.encode_grad")`` (``utils.profiling``): on the profiler's clock
in eager calls and warm-up steps. A graph replay runs no host code, so
inside a replay only the kernels' own names show the encoding's time.
``LAUNCHES`` counts launches per kernel (``training/graphs.py`` adds a
replay's to it); ``ROUTE`` counts host calls, so a replay adds nothing.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import torch

from .. import kernels
from ..utils.profiling import span

PRIMES = (1, 2654435761, 805459861)
_MASK32 = 0xFFFFFFFF

# the 8 corner offsets, dx-major (the JAX order)
_OFFSETS = ((0, 0, 0), (0, 0, 1), (0, 1, 0), (0, 1, 1),
            (1, 0, 0), (1, 0, 1), (1, 1, 0), (1, 1, 1))

MAX_LEVELS = 32  # kMaxLevels of csrc/hash_grid.cu
ROUTE = {"kernel": 0, "plain": 0}
LAUNCHES = {"hash_encode_fwd": 0, "hash_encode_bwd": 0}


def reset_launches() -> None:
    for counter in (LAUNCHES, ROUTE):
        for key in counter:
            counter[key] = 0


@functools.lru_cache(maxsize=None)
def _offsets(device) -> torch.Tensor:
    """``_OFFSETS`` as an int64 tensor, made once per device (a copy from
    the host inside a captured training step would synchronise)."""
    return torch.tensor(_OFFSETS, dtype=torch.int64, device=device)


def hash_index(cx: torch.Tensor, cy: torch.Tensor, cz: torch.Tensor, table_size: int) -> torch.Tensor:
    """uint32 (cx * P0) ^ (cy * P1) ^ (cz * P2) mod ``table_size`` of
    non-negative integer corners, computed in int64 (the low 32 bits of the
    products and of their xor are the uint32 ones)."""
    h = (cx.long() * PRIMES[0]) ^ (cy.long() * PRIMES[1]) ^ (cz.long() * PRIMES[2])
    return torch.remainder(h & _MASK32, table_size)


def corner_rows(x: torch.Tensor, resolutions: Sequence[int], table_size: int):
    """(idx (B, L, 8) int64 rows of the stacked (L*T, F) tables, weights
    (B, L, 8) in x's dtype) of every point's 8 corners at every level,
    computed in x's dtype."""
    x01 = torch.clamp((x + 1.0) * 0.5, 0.0, 1.0)
    offs = _offsets(x.device)  # (8, 3)
    T = table_size
    idx_all, w_all = [], []
    for level, res in enumerate(resolutions):
        pos = x01 * res
        p0 = torch.floor(pos).long()
        frac = pos - p0.to(pos.dtype)
        corner = torch.clamp(p0[:, None, :] + offs[None], 0, res)  # (B, 8, 3)
        if (res + 1) ** 3 <= T:
            ci = corner[..., 0] * (res + 1) * (res + 1) + corner[..., 1] * (res + 1) + corner[..., 2]
        else:
            ci = hash_index(corner[..., 0], corner[..., 1], corner[..., 2], T)
        idx_all.append(ci + level * T)
        w = torch.ones_like(frac[:, :1]).expand(-1, 8)
        for axis in range(3):
            pick = offs[None, :, axis] == 1
            w = w * torch.where(pick, frac[:, None, axis], 1.0 - frac[:, None, axis])
        w_all.append(w)
    return torch.stack(idx_all, dim=1), torch.stack(w_all, dim=1)


def encode_plain(x: torch.Tensor, tables: torch.Tensor, resolutions: Sequence[int]) -> torch.Tensor:
    """(B, 3) -> (B, L*F): one gather of B*L*8 rows from the stacked
    tables, weighted and summed over the corners."""
    L, T, F = tables.shape
    idx, w = corner_rows(x, resolutions, T)
    g = tables.reshape(L * T, F)[idx.reshape(-1)].reshape(x.shape[0], L, 8, F)
    return torch.sum(w[..., None] * g, dim=2).reshape(x.shape[0], L * F)


def _needs_grad(t: torch.Tensor) -> bool:
    if t.requires_grad or torch._C._functorch.is_functorch_wrapped_tensor(t):
        return True
    return torch.autograd.forward_ad.unpack_dual(t).tangent is not None


def _on_card(t: torch.Tensor) -> bool:
    return t.is_cuda


def kernel_serves(x: torch.Tensor, tables: torch.Tensor) -> bool:
    """Whether ``encode`` takes the kernel route: float32 tables on a card
    and points that need no gradient."""
    return (_on_card(tables) and tables.dtype == torch.float32 and not _needs_grad(x)
            and not torch._C._functorch.is_functorch_wrapped_tensor(tables))


def _check_points(x: torch.Tensor, tables: torch.Tensor) -> None:
    if not (x.dtype == torch.float32 and x.dim() == 2 and x.shape[1] == 3 and x.device == tables.device):
        raise ValueError(f"the hash encoding kernels take float32 (n, 3) points on {tables.device}, "
                         f"not {x.dtype} {tuple(x.shape)} on {x.device}")


def encode(x: torch.Tensor, tables: torch.Tensor, resolutions: Sequence[int]) -> torch.Tensor:
    """(B, 3) points -> (B, L*F) features, by the kernels where they serve
    (``kernel_serves``), else by ``encode_plain``; counted in ``ROUTE``."""
    if kernel_serves(x, tables):
        _check_points(x, tables)
        ROUTE["kernel"] += 1
        return _Encode.apply(x, tables, tuple(int(r) for r in resolutions))
    ROUTE["plain"] += 1
    return encode_plain(x, tables, resolutions)


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------

@functools.cache
def _lib() -> ctypes.CDLL:
    lib = kernels.load("hash_grid")
    P, I, L, U = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_uint
    for fn in (lib.hash_encode_fwd, lib.hash_encode_bwd):
        fn.argtypes = [P, P, L, I, U, I, P, P, P]
        fn.restype = I
    lib.hash_grid_max_levels.restype = I
    lib.hash_grid_error_string.argtypes = [I]
    lib.hash_grid_error_string.restype = ctypes.c_char_p
    if lib.hash_grid_max_levels() != MAX_LEVELS:
        raise RuntimeError("csrc/hash_grid.cu and ops/hash_grid.py disagree on the most levels")
    return lib


def _check_launch(rc: int, what: str) -> None:
    if rc != 0:
        msg = _lib().hash_grid_error_string(rc).decode()
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc} ({msg})")


def _launch_args(x: torch.Tensor, tables: torch.Tensor, resolutions: Tuple[int, ...]):
    """Validate a launch; returns (n, L, T, F, resolutions as a C array, stream)."""
    L, T, F = tables.shape
    if len(resolutions) != L or not 1 <= L <= MAX_LEVELS:
        raise ValueError(f"{L} levels with {len(resolutions)} resolutions: the kernels take 1 to "
                         f"{MAX_LEVELS}")
    if T & (T - 1) or T > 1 << 31:
        raise ValueError(f"table rows {T}: the kernels take a power of two up to 2^31")
    if not (x.is_contiguous() and tables.is_contiguous()):
        raise ValueError("the kernels take contiguous points and tables")
    res = (ctypes.c_int * L)(*resolutions)
    return x.shape[0], L, T, F, res, torch.cuda.current_stream(x.device).cuda_stream


def encode_fwd_cuda(x: torch.Tensor, tables: torch.Tensor, resolutions: Tuple[int, ...]) -> torch.Tensor:
    """``hash_encode_fwd_kernel``: (n, 3), (L, T, F) float32 on a card -> (n, L*F)."""
    n, L, T, F, res, stream = _launch_args(x, tables, resolutions)
    out = torch.empty((n, L * F), dtype=torch.float32, device=x.device)
    with span("hash.encode"):
        rc = _lib().hash_encode_fwd(x.data_ptr(), tables.data_ptr(), n, L, T, F, res,
                                    out.data_ptr(), stream)
    _check_launch(rc, "hash_encode_fwd")
    LAUNCHES["hash_encode_fwd"] += 1
    return out


def encode_bwd_cuda(x: torch.Tensor, grad_out: torch.Tensor, shape: Tuple[int, int, int],
                    resolutions: Tuple[int, ...]) -> torch.Tensor:
    """``hash_encode_bwd_kernel``: the tables' (L, T, F) gradient of the
    features' gradient ``grad_out`` (n, L*F)."""
    grad = torch.zeros(shape, dtype=torch.float32, device=x.device)
    n, L, T, F, res, stream = _launch_args(x, grad, resolutions)
    with span("hash.encode_grad"):
        rc = _lib().hash_encode_bwd(x.data_ptr(), grad_out.data_ptr(), n, L, T, F, res,
                                    grad.data_ptr(), stream)
    _check_launch(rc, "hash_encode_bwd")
    LAUNCHES["hash_encode_bwd"] += 1
    return grad


class _Encode(torch.autograd.Function):
    """The kernel route; the points get no gradient."""

    @staticmethod
    def forward(ctx, x, tables, resolutions):
        x = x.contiguous()
        ctx.save_for_backward(x)
        ctx.shape, ctx.resolutions = tuple(tables.shape), resolutions
        return encode_fwd_cuda(x, tables.contiguous(), resolutions)

    @staticmethod
    def backward(ctx, grad_out):
        if not ctx.needs_input_grad[1]:
            return None, None, None
        (x,) = ctx.saved_tensors
        return None, encode_bwd_cuda(x, grad_out.contiguous(), ctx.shape, ctx.resolutions), None
