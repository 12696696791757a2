"""Fused ImplicitNet forward — counterpart of sdf_representation_tpu/ops/pallas_mlp.py.

The whole network runs over a tile of points inside one CUDA kernel
(``csrc/fused_mlp.cu``): activations never leave the SM, so device-memory
traffic is the weights (read from L2) plus coordinates in and one f32 out
per point — or only the output for the grid entries, which make their
coordinates from the tile index. Three entries share the kernel body:

  ``fused_points``  (N, d_in) points        <- _fused_apply_padded's pallas_call
  ``fused_grid``    the dense n^3 grid      <- _fused_grid_slab's pallas_call
  ``fused_blocks``  active 8^3 blocks       <- ops/sparse_grid.py refine_blocks

Each wrapper takes its kernel's plain PyTorch version (``*_plain``) when the
tensors lie on the CPU, and launches the kernel or raises when they lie on
a card: there is no fallback. ``LAUNCHES`` counts kernel launches.

Working types, as in the JAX kernel (pallas_mlp.py:90-140): float32 all the
way, or bfloat16, which rounds the input coordinates, each layer's f32
accumulator before the activation and the activation's output to bf16,
with bf16 weights, f32 biases and an f32 last layer. The plain versions
hold bf16 values in f32 tensors and multiply in f32, which is exact for
the products; only the summation order differs from the kernel.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import List, Tuple

import torch

from .. import kernels

LANE = 128           # padding unit of the JAX layout (prepare_fused_weights)
TILE_P = 64          # points per CUDA block (kTileP in csrc/fused_mlp.cu)
MAX_WIDTH = 512      # widest padded layer the CUDA tile holds (kHMax)
MAX_D_IN = 4         # coordinate columns the CUDA tile holds
PLAIN_CHUNK = 65536  # points per plain-path matmul chain
INV_SQRT2 = 1.0 / math.sqrt(2.0)

# kernel launches per wrapper; chip_smoke.py zeroes them around the main path
LAUNCHES = {"fused_points": 0, "fused_grid": 0, "sparse_blocks": 0}


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def prepare_fused_weights(model, compute_dtype=torch.bfloat16, layers=None):
    """Pad/split the weights as pallas_mlp.prepare_fused_weights does.
    ``layers``: per layer (weight (out, in), bias) to take instead of the
    module's own (copies in another type, as a mixed-precision step makes).

    Returns (flat list of tensors, spec, h_pad): per layer an (in, out)
    matrix padded to LANE multiples — split at the concat boundary into
    W_top (h_pad rows) and W_bot (LANE rows) for a skip layer — in
    ``compute_dtype``, then its f32 bias as (1, out_pad). ``spec`` names each
    layer 'first', 'skip' or 'plain'."""
    dims = model.dims
    d_in = model.d_in
    n_lin = len(dims) - 1
    h_pad = _round_up(max(dims[1:-1]) if n_lin > 1 else LANE, LANE)

    def pad_to(a, rows, cols):
        out = torch.zeros((rows, cols), dtype=torch.float32, device=a.device)
        out[: a.shape[0], : a.shape[1]] = a
        return out

    out: List[torch.Tensor] = []
    spec: List[str] = []
    with torch.no_grad():
        for layer, (w, b) in enumerate(model.effective_layers() if layers is None else layers):
            w = w.detach().float().T  # (in, out)
            fan_in = w.shape[0]
            out_pad = h_pad if layer < n_lin - 1 else LANE
            if layer == 0:
                out.append(pad_to(w, LANE, out_pad).to(compute_dtype))
                spec.append("first")
            elif layer in model.skip_in:
                out.append(pad_to(w[: fan_in - d_in], h_pad, out_pad).to(compute_dtype))
                out.append(pad_to(w[fan_in - d_in:], LANE, out_pad).to(compute_dtype))
                spec.append("skip")
            else:
                out.append(pad_to(w, h_pad, out_pad).to(compute_dtype))
                spec.append("plain")
            out.append(pad_to(b.detach().float()[None, :], 1, out_pad))
    return out, tuple(spec), h_pad


class FusedNet:
    """A net's weights prepared once for the fused kernels and their plain
    versions, on the module's device, in ``compute_dtype``."""

    def __init__(self, model, compute_dtype=torch.bfloat16, layers=None):
        if compute_dtype not in (torch.bfloat16, torch.float32):
            raise ValueError(f"compute_dtype must be bfloat16 or float32, got {compute_dtype}")
        self.weights, self.spec, self.h_pad = prepare_fused_weights(model, compute_dtype, layers)
        self.d_in = model.d_in
        self.beta = float(model.beta)
        self.dtype = compute_dtype
        self.device = self.weights[0].device
        # per layer (kind, W_hidden or None, W_coords (d_in rows) or None, bias (out,))
        self.layers = []
        it = iter(self.weights)
        for kind in self.spec:
            if kind == "first":
                w_h, w_x = None, next(it)[: self.d_in]
            elif kind == "skip":
                w_h, w_x = next(it), next(it)[: self.d_in]
            else:
                w_h, w_x = next(it), None
            self.layers.append((kind, w_h, w_x, next(it)[0]))

    @functools.cached_property
    def plain_layers(self):
        """The layers as f32 tensors (bf16 values are exact in f32)."""
        return [
            (kind, None if w_h is None else w_h.float(),
             None if w_x is None else w_x.float(), b)
            for kind, w_h, w_x, b in self.layers
        ]

    @functools.cached_property
    def layout(self) -> List[List[int]]:
        """Per layer the descriptor row the CUDA sources read: [rows of the
        hidden-input matrix, padded output width, skip flag, bias offset,
        offset of the hidden-input matrix or -1, offset of the coordinate-
        input matrix or -1], offsets in elements of the flat buffers."""
        rows = []
        w_off = b_off = 0
        for kind, w_h, w_x, b in self.layers:
            n = b.numel()
            row = [0 if w_h is None else w_h.shape[0], n, int(kind == "skip"), b_off, -1, -1]
            if w_h is not None:
                row[4] = w_off
                w_off += w_h.numel()
            if w_x is not None:
                row[5] = w_off
                w_off += w_x.numel()
            b_off += n
            rows.append(row)
        return rows

    @functools.cached_property
    def packed(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(weights flat in compute_dtype, biases flat f32, int64 descriptor
        (n_lin, 6)) in the layout csrc/fused_mlp.cu reads (``layout``)."""
        mats = [w.reshape(-1) for _, w_h, w_x, _ in self.layers for w in (w_h, w_x) if w is not None]
        biases = [b for *_, b in self.layers]
        return (torch.cat(mats).contiguous(), torch.cat(biases).contiguous(),
                torch.tensor(self.layout, dtype=torch.int64, device=self.device))

    @functools.cached_property
    def transposed(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(W^T of every hidden-to-hidden matrix, flat in compute_dtype; int64
        offsets per layer, -1 where a layer has none) for csrc/fused_igr.cu,
        whose reverse sweeps multiply by W^T and stream rows."""
        mats, offsets, off = [], [], 0
        for layer, (_, w_h, _, _) in enumerate(self.layers):
            if w_h is None or layer == len(self.layers) - 1:
                offsets.append(-1)
            else:
                offsets.append(off)
                mats.append(w_h.T.contiguous().reshape(-1))
                off += w_h.numel()
        flat = torch.cat(mats) if mats else torch.zeros(1, dtype=self.dtype, device=self.device)
        return flat, torch.tensor(offsets, dtype=torch.int64, device=self.device)


# ---------------------------------------------------------------------------
# plain PyTorch versions (the CPU path; on a card only compared against)
# ---------------------------------------------------------------------------

def _working(t: torch.Tensor, dtype) -> torch.Tensor:
    return t.to(dtype).float() if dtype == torch.bfloat16 else t


def forward_plain(net: FusedNet, x: torch.Tensor) -> torch.Tensor:
    """The fused forward (pallas_mlp._make_body) over (M, d_in) f32 points."""
    x = _working(x.float(), net.dtype)
    h = x
    n_lin = len(net.plain_layers)
    for layer, (kind, w_h, w_x, b) in enumerate(net.plain_layers):
        if kind == "first":
            acc = x @ w_x + b
        elif kind == "skip":
            acc = (h @ w_h + x @ w_x) * INV_SQRT2 + b
        else:
            acc = h @ w_h + b
        if layer < n_lin - 1:
            acc = _working(acc, net.dtype)
            if net.beta > 0:
                t = net.beta * acc
                acc = (torch.clamp_min(t, 0.0) + torch.log1p(torch.exp(-t.abs()))) / net.beta
            else:
                acc = torch.clamp_min(acc, 0.0)
            h = _working(acc, net.dtype)
        else:
            h = acc
    if net.beta <= 0:
        h = torch.tanh(h)
    return h[:, 0]


def _plain_chunked(net: FusedNet, coords, total: int) -> torch.Tensor:
    """Run ``forward_plain`` over ``coords(start, stop)`` in chunks whose row
    counts are multiples of TILE_P (matmul shapes then keep each row's
    result independent of its position, so sparse and dense agree)."""
    out = torch.empty(total, dtype=torch.float32, device=net.device)
    for start in range(0, total, PLAIN_CHUNK):
        stop = min(total, start + PLAIN_CHUNK)
        x = coords(start, start + _round_up(stop - start, TILE_P))
        out[start:stop] = forward_plain(net, x)[: stop - start]
    return out


def _step(n: int, device) -> torch.Tensor:
    return torch.tensor(2.0 / (n - 1), dtype=torch.float32, device=device)


def _coords(index: torch.Tensor, step: torch.Tensor) -> torch.Tensor:
    """-1 + step * i in f32, as the kernels compute it (no FMA)."""
    return -1.0 + step * index.float()


def grid_points(n: int, start: int, stop: int, device) -> torch.Tensor:
    """(stop - start, 3) coordinates of flat grid indices [start, stop)."""
    flat = torch.arange(start, stop, dtype=torch.int64, device=device)
    idx = torch.stack([flat // (n * n), (flat // n) % n, flat % n], dim=-1)
    return _coords(idx, _step(n, device))


def block_points(ids: torch.Tensor, n: int, block: int) -> torch.Tensor:
    """(len(ids) * block^3, 3) coordinates of the points of the given
    blocks (flat ids over the (n/block)^3 blocks), block-major."""
    nb = n // block
    ids = ids.long()
    local = torch.arange(block ** 3, dtype=torch.int64, device=ids.device)
    lidx = torch.stack([local // (block * block), (local // block) % block, local % block], -1)
    bidx = torch.stack([ids // (nb * nb), (ids // nb) % nb, ids % nb], -1)
    idx = bidx[:, None, :] * block + lidx[None, :, :]
    return _coords(idx.reshape(-1, 3), _step(n, ids.device))


def fused_points_plain(net: FusedNet, x: torch.Tensor) -> torch.Tensor:
    total = x.shape[0]
    x = x.float()

    def coords(start, stop):
        chunk = x[start:stop]
        if chunk.shape[0] < stop - start:
            chunk = torch.cat([chunk, chunk.new_zeros(stop - start - chunk.shape[0], x.shape[1])])
        return chunk

    return _plain_chunked(net, coords, total)


def fused_grid_plain(net: FusedNet, n: int) -> torch.Tensor:
    return _plain_chunked(net, lambda a, b: grid_points(n, a, b, net.device), n ** 3)


def fused_blocks_plain(net: FusedNet, ids: torch.Tensor, count: torch.Tensor,
                       n: int, block: int) -> torch.Tensor:
    """(k_max, block^3); rows at or past ``count`` are left as garbage-free
    zeros (the kernel leaves them unwritten; callers drop them)."""
    pts = block ** 3
    live = min(int(count), ids.shape[0])
    out = torch.zeros((ids.shape[0], pts), dtype=torch.float32, device=net.device)
    if live:
        x = block_points(ids[:live], n, block)
        out[:live] = _plain_chunked(net, lambda a, b: x[a:b], live * pts).reshape(live, pts)
    return out


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------

@functools.cache
def _lib() -> ctypes.CDLL:
    lib = kernels.load("fused_mlp")
    P, I, L, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib.sdf_mlp_points.argtypes = [P, L, I, P, I, F, I, P, P, P, P]
    lib.sdf_mlp_grid.argtypes = [L, L, I, F, P, I, F, I, P, P, P, P]
    lib.sdf_mlp_blocks.argtypes = [P, P, I, I, I, F, P, I, F, I, P, P, P, P]
    for fn in (lib.sdf_mlp_points, lib.sdf_mlp_grid, lib.sdf_mlp_blocks):
        fn.restype = I
    lib.sdf_mlp_error_string.argtypes = [I]
    lib.sdf_mlp_error_string.restype = ctypes.c_char_p
    if lib.sdf_mlp_tile_points() != TILE_P or lib.sdf_mlp_max_width() != MAX_WIDTH:
        raise RuntimeError("csrc/fused_mlp.cu and ops/fused_mlp.py disagree on the tile shape")
    return lib


def _check_launch(rc: int, what: str) -> None:
    if rc != 0:
        msg = _lib().sdf_mlp_error_string(rc).decode()
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc} ({msg})")


def _cuda_args(net: FusedNet, *tensors: torch.Tensor):
    """Validate a launch and return (weights ptr, biases ptr, desc ptr,
    n_lin, bf16 flag, stream ptr)."""
    if net.device.type != "cuda":
        raise ValueError(f"the net's weights are on {net.device}, the inputs on a card")
    for t in tensors:
        if t.device != net.device:
            raise ValueError(f"tensor on {t.device}, weights on {net.device}")
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")
    if net.h_pad > MAX_WIDTH:
        raise ValueError(f"hidden width {net.h_pad} exceeds the kernel's {MAX_WIDTH}")
    if net.d_in > MAX_D_IN:
        raise ValueError(f"d_in {net.d_in} exceeds the kernel's {MAX_D_IN}")
    wbuf, bbuf, desc = net.packed
    stream = torch.cuda.current_stream(net.device).cuda_stream
    return (wbuf.data_ptr(), bbuf.data_ptr(), desc.data_ptr(), desc.shape[0],
            int(net.dtype == torch.bfloat16), stream)


def fused_points(net: FusedNet, x: torch.Tensor) -> torch.Tensor:
    """(N, d_in) f32 points -> (N,) f32 field values."""
    if x.dim() != 2 or x.shape[1] != net.d_in:
        raise ValueError(f"points must be (N, {net.d_in}), got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return fused_points_plain(net, x)
    if x.dtype != torch.float32:
        raise ValueError(f"points must be float32, got {x.dtype}")
    w, b, desc, n_lin, bf16, stream = _cuda_args(net, x)
    out = torch.empty(x.shape[0], dtype=torch.float32, device=x.device)
    if x.shape[0]:
        with torch.cuda.device(x.device):
            rc = _lib().sdf_mlp_points(x.data_ptr(), x.shape[0], net.d_in, desc, n_lin,
                                       net.beta, bf16, w, b, out.data_ptr(), stream)
        _check_launch(rc, "fused_points")
        LAUNCHES["fused_points"] += 1
    return out


def fused_grid(net: FusedNet, n: int) -> torch.Tensor:
    """The field on the dense n^3 grid over linspace(-1, 1, n), flat
    x*n^2 + y*n + z, as an (n^3,) f32 tensor on the net's device."""
    if net.d_in != 3:
        raise ValueError("grid evaluation needs a 3-d input")
    if net.device.type == "cpu":
        return fused_grid_plain(net, n)
    w, b, desc, n_lin, bf16, stream = _cuda_args(net)
    total = n ** 3
    out = torch.empty(total, dtype=torch.float32, device=net.device)
    with torch.cuda.device(net.device):
        rc = _lib().sdf_mlp_grid(0, -(-total // TILE_P), n, 2.0 / (n - 1), desc, n_lin,
                                 net.beta, bf16, w, b, out.data_ptr(), stream)
    _check_launch(rc, "fused_grid")
    LAUNCHES["fused_grid"] += 1
    return out


def fused_blocks(net: FusedNet, ids: torch.Tensor, count: torch.Tensor,
                 n: int, block: int) -> torch.Tensor:
    """The block^3 points of blocks ``ids[:count]`` (flat over the
    (n/block)^3 blocks) -> (len(ids), block^3) f32. ``count`` is a 1-element
    int32 tensor read on the device (no host sync); rows past it are not
    written."""
    if net.d_in != 3:
        raise ValueError("grid evaluation needs a 3-d input")
    if ids.device.type == "cpu":
        return fused_blocks_plain(net, ids, count, n, block)
    if ids.dtype != torch.int32 or count.dtype != torch.int32 or count.numel() != 1:
        raise ValueError("ids and count must be int32, count one element")
    if block ** 3 % TILE_P:
        raise ValueError(f"block^3 must be a multiple of {TILE_P} (block % 4 == 0)")
    w, b, desc, n_lin, bf16, stream = _cuda_args(net, ids, count)
    out = torch.empty((ids.shape[0], block ** 3), dtype=torch.float32, device=ids.device)
    with torch.cuda.device(ids.device):
        rc = _lib().sdf_mlp_blocks(ids.data_ptr(), count.data_ptr(), ids.shape[0], n // block,
                                   block, 2.0 / (n - 1), desc, n_lin, net.beta, bf16, w, b,
                                   out.data_ptr(), stream)
    _check_launch(rc, "sparse_blocks")
    LAUNCHES["sparse_blocks"] += 1
    return out


# ---------------------------------------------------------------------------
# entry points (pallas_mlp.fused_grid_eval / fused_apply)
# ---------------------------------------------------------------------------

def fused_grid_eval(model, n: int, compute_dtype=torch.bfloat16) -> torch.Tensor:
    """The field on the dense n^3 grid in [-1, 1]^3 (reference ordering) as
    an (n, n, n) f32 tensor on the model's device."""
    return fused_grid(FusedNet(model, compute_dtype), n).reshape(n, n, n)


def fused_apply(model, points, compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Fused forward over arbitrary points (N, d_in) -> (N,) f32."""
    net = FusedNet(model, compute_dtype)
    x = torch.as_tensor(points, dtype=torch.float32, device=net.device).contiguous()
    return fused_points(net, x)
