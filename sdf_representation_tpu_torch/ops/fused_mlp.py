"""Fused ImplicitNet forward — counterpart of sdf_representation_tpu/ops/pallas_mlp.py.

The whole network runs over a tile of points inside one CUDA kernel
(``csrc/fused_mlp.cu``): activations never leave the SM, so device-memory
traffic is the weights (read from L2) plus coordinates in and one f32 out
per point — or only the output for the grid entries, which make their
coordinates from the tile index. Three entries share the kernel body:

  ``fused_points``  (N, d_in) points        <- _fused_apply_padded's pallas_call
  ``fused_grid``    the dense n^3 grid      <- _fused_grid_slab's pallas_call
  ``fused_blocks``  active 8^3 blocks       <- ops/sparse_grid.py refine_blocks

``fused_grid_tiles`` is the grid entry over one shard's slab of tiles, and
``fused_blocks`` with ``counter="sparse_sharded_blocks"`` the blocks entry
over one shard's slice of the active list: the per-device kernels of
ops/sharded_eval.py (``_local_sweep_pallas``, ``_sparse_sharded_device``),
which the port's ops/sharded_eval.py launches once per shard.

Each wrapper takes its kernel's plain PyTorch version (``*_plain``) when the
tensors lie on the CPU, and launches the kernel or raises when they lie on
a card: there is no fallback. ``LAUNCHES`` counts kernel launches.

Working types, as in the JAX kernel (pallas_mlp.py:90-140): float32 all the
way, or bfloat16, which rounds the input coordinates, each layer's f32
accumulator before the activation and the activation's output to bf16,
with bf16 weights, f32 biases and an f32 last layer. On a card both run on
the tensor cores: bf16 products in bf16 (``FusedNet.tiles`` is their weight
layout), f32 ones as three TF32 products of operands split in two halves
(``split_tf32``; ``FusedNet.tf32_tiles`` holds the weights' halves), which
keep the f32 results within 2e-5 of the f32 plain version where one TF32
pass would not (``forward_tf32_model`` emulates both). The plain versions
multiply in f32 in f32 mode; in bf16 mode they compute each layer in f64,
where the bf16 products and their sums are exact, and round at the JAX
body's points: the value every f32 summation order approximates, the same
on every device.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import List, Tuple

import torch

from .. import kernels

LANE = 128           # padding unit of the JAX layout (prepare_fused_weights)
TILE_P = 64          # points per tile, the C interface's unit (kTileP in csrc/fused_mlp.cu)
MAX_WIDTH = 512      # widest padded layer the CUDA tile holds (kHMax)
MAX_D_IN = 4         # coordinate columns the CUDA tile holds
# the bf16 (wgmma) routine's weight stages (csrc/fused_mlp.cu): output
# columns per product, K columns per stage (one 128-byte row of bf16), and
# the last layer's narrow product
CHUNK_N = 64         # kChunkN
K_BLOCK = 64         # kKBlock
LAST_ROWS = 8        # kLastRows
# the f32 (split-TF32) routine's stages: K columns per stage (one 128-byte
# row of f32, kF32KBlock), and the order of K within each 8 in its weight
# images: slot p holds column K_ORDER[p], so that the A fragment a thread
# loads from its accumulator's own values (columns 2q, 2q + 1 of each 8)
# meets its weights
F32_K_BLOCK = 32
K_ORDER = (0, 2, 4, 6, 1, 3, 5, 7)
PLAIN_CHUNK = 65536  # points per plain-path matmul chain
INV_SQRT2 = 1.0 / math.sqrt(2.0)

# kernel launches per wrapper; chip_smoke.py zeroes them around the main path
LAUNCHES = {"fused_points": 0, "fused_grid": 0, "sparse_blocks": 0, "sharded_grid": 0,
            "sparse_sharded_blocks": 0}


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
                _descriptor(tuple(tuple(row) for row in self.layout), self.device))

    @functools.cached_property
    def tiles(self) -> torch.Tensor:
        """The hidden-input matrices (W_top of each layer but the first) in
        the order and the image the bf16 kernels' weight stages take them
        (csrc/fused_mlp.cu): per layer W^T (its output columns as rows; the
        last layer's first LAST_ROWS only), cut into CHUNK_N-row chunks and
        K_BLOCK-column blocks, chunk-major, each stage a (rows, 64) block in
        the 128-byte swizzle. Flat, in compute_dtype: one gather from
        ``packed``'s weights."""
        return self._staged(igr=False)

    @functools.cached_property
    def tf32_tiles(self) -> torch.Tensor:
        """The hidden-input matrices as the f32 (split-TF32) kernels' weight
        stages take them (csrc/fused_mlp.cu): per layer W^T (the last
        layer's first LAST_ROWS rows only), its K axis reordered within each
        8 by K_ORDER, cut into CHUNK_N-row chunks and F32_K_BLOCK-column
        blocks, chunk-major; each stage the hi image, then the lo image
        (``split_tf32``) of its (rows, 32) block in the 128-byte swizzle.
        Flat f32: one gather from ``packed``'s weights, split once."""
        return self._tf32_staged("tf32")

    @functools.cached_property
    def igr_tf32_tiles(self) -> torch.Tensor:
        """The weight stages of the f32 eikonal kernels (csrc/fused_igr.cu),
        in the order both take them: ``tf32_tiles`` (the forward products of
        layers 1 .. n_lin - 1), then per layer n_lin - 2 .. 1 the stages of
        the reverse product dz W^T, whose B operand is W itself, K-major
        over the layer's outputs: W (k, n) with its K axis (n) reordered
        within each 8 by K_ORDER, cut into CHUNK_N-row chunks (the k
        inputs) and F32_K_BLOCK-column blocks, chunk-major, each stage the
        hi then the lo image of its (64, 32) block in the 128-byte swizzle.
        Flat f32: one gather from ``packed``'s weights, split once."""
        return self._tf32_staged("igr_tf32")

    def _tf32_staged(self, kind: str) -> torch.Tensor:
        if self.dtype != torch.float32:
            raise ValueError(f"the {kind} stages are the f32 kernels' weights")
        layout = tuple(tuple(row) for row in self.layout)
        staged = _stage_index(layout, kind, self.device)
        if staged is None:
            return torch.zeros(1, dtype=torch.float32, device=self.device)
        index, is_lo = staged
        hi, lo = split_tf32(self.packed[0].index_select(0, index))
        return torch.where(is_lo, lo, hi)

    @functools.cached_property
    def igr_tiles(self) -> torch.Tensor:
        """The weight stages of the bf16 eikonal kernels (csrc/fused_igr.cu),
        in the order both take them: ``tiles`` (the forward products of
        layers 1 .. n_lin - 1), then per layer n_lin - 2 .. 1 the stages of
        the reverse product dz W^T, whose B operand is W itself, K-major
        over the layer's outputs: W (k, n) cut into CHUNK_N-row chunks
        (the k inputs, the product's output columns) and K_BLOCK-column
        blocks (the n outputs, its K), chunk-major, each a (64, 64) block in
        the 128-byte swizzle. Flat, in compute_dtype: one gather from
        ``packed``'s weights, so it costs a step one launch."""
        return self._staged(igr=True)

    def _staged(self, igr: bool) -> torch.Tensor:
        layout = tuple(tuple(row) for row in self.layout)
        index = _stage_index(layout, "igr" if igr else "bf16", self.device)
        if index is None:
            return torch.zeros(1, dtype=self.dtype, device=self.device)
        return self.packed[0].index_select(0, index)


@functools.lru_cache(maxsize=None)
def _descriptor(layout: Tuple[Tuple[int, ...], ...], device) -> torch.Tensor:
    """``FusedNet.packed``'s int64 descriptor, made once per layout and
    device: a step builds a ``FusedNet`` per call, and a copy from the host
    inside a captured step would be a synchronising copy from pageable
    memory, which a CUDA graph cannot hold."""
    return torch.tensor(layout, dtype=torch.int64, device=device)


@functools.lru_cache(maxsize=None)
def _stage_index(layout: Tuple[Tuple[int, ...], ...], kind: str, device):
    """int32 positions in ``FusedNet.packed``'s weight buffer of the
    elements of ``FusedNet.tiles`` (``kind`` "bf16"), ``FusedNet.igr_tiles``
    ("igr"), ``FusedNet.tf32_tiles`` ("tf32") or ``FusedNet.igr_tf32_tiles``
    ("igr_tf32"), for a net of this ``layout``: the images of the weights'
    own indices. For the f32 kinds also a mask of the elements that take the
    lo half (each position appears twice, in the stage's hi and lo image).
    None where the net has no hidden-input matrix. Made once per layout and
    device."""
    last = len(layout) - 1
    mats = {layer: torch.arange(w_off, w_off + k * n, dtype=torch.int32).view(k, n)
            for layer, (k, n, _, _, w_off, _) in enumerate(layout) if w_off >= 0}
    if not mats:
        return None
    if kind in ("tf32", "igr_tf32"):
        def k_ordered(m):  # the rows (the product's K) reordered within each 8
            k = m.shape[0]
            return m[torch.arange(k).view(k // 8, 8)[:, list(K_ORDER)].reshape(-1)]

        staged = [_layer_stages(k_ordered(m), layer == last, F32_K_BLOCK) for layer, m in mats.items()]
        if kind == "igr_tf32":
            staged += [_layer_stages(k_ordered(mats[layer].T), False, F32_K_BLOCK)
                       for layer in range(last - 1, 0, -1)]
        parts, lo_parts = [], []
        for stages in staged:
            both = torch.stack([swizzle_128b(stages)] * 2, dim=2)  # (chunks, k blocks, hi / lo, rows, 32)
            is_lo = torch.zeros(both.shape, dtype=torch.bool)
            is_lo[:, :, 1] = True
            parts.append(both.reshape(-1))
            lo_parts.append(is_lo.reshape(-1))
        return torch.cat(parts).to(device), torch.cat(lo_parts).to(device)
    parts = [swizzle_128b(_layer_stages(m, layer == last, K_BLOCK)).reshape(-1) for layer, m in mats.items()]
    if kind == "igr":
        parts += [swizzle_128b(_layer_stages(mats[layer].T, False, K_BLOCK)).reshape(-1)
                  for layer in range(last - 1, 0, -1)]
    return torch.cat(parts).to(device)


def swizzle_128b(t: torch.Tensor) -> torch.Tensor:
    """(..., rows, w) -> the same, the 16-byte groups of row r (w / 8
    elements: 8 bf16 for w = 64, 4 f32 for w = 32) put at group index
    g ^ (r % 8): the 128-byte swizzle wgmma and TMA read. Its own inverse."""
    rows, width = t.shape[-2], t.shape[-1]
    groups = t.reshape(*t.shape[:-1], 8, width // 8)
    index = torch.arange(8, device=t.device)[None, :] ^ (torch.arange(rows, device=t.device) % 8)[:, None]
    index = index[..., None].expand(rows, 8, width // 8).expand(*groups.shape)
    return torch.gather(groups, -2, index).reshape(t.shape)


def _layer_stages(w_h: torch.Tensor, last: bool, k_block: int) -> torch.Tensor:
    """A hidden-input matrix (k, n) as its weight stages (chunks, k blocks,
    rows, k_block), unswizzled."""
    k = w_h.shape[0]
    wt = (w_h[:, :LAST_ROWS] if last else w_h).T
    rows = wt.shape[0]
    chunk = min(rows, CHUNK_N)
    return wt.reshape(rows // chunk, chunk, k // k_block, k_block).permute(0, 2, 1, 3)


def split_tf32(t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32 values -> (hi, lo), f32 tensors whose low 13 mantissa bits are
    zero: hi is t rounded to TF32 (10 mantissa bits) to nearest, ties away
    from zero, as cvt.rna.tf32.f32 rounds, and lo the same rounding of
    t - hi, which is exact in f32; |t - hi - lo| <= 2^-22 |t| for normal t.
    Bit arithmetic on int32 views (finite inputs), on any device."""
    def rna(v):
        return ((v.contiguous().view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)

    t = t.float()
    hi = rna(t)
    return hi, rna(t - hi)


# ---------------------------------------------------------------------------
# plain PyTorch versions (the CPU path; on a card only compared against)
# ---------------------------------------------------------------------------

def _working(t: torch.Tensor, dtype) -> torch.Tensor:
    return t.to(dtype).float() if dtype == torch.bfloat16 else t


def _rounded(t: torch.Tensor) -> torch.Tensor:
    """t rounded to f32 and then to bf16, in t's own dtype."""
    return t.float().to(torch.bfloat16).to(t.dtype)


def forward_plain(net: FusedNet, x: torch.Tensor) -> torch.Tensor:
    """The fused forward (pallas_mlp._make_body) over (M, d_in) f32 points.
    f32: f32 matmuls. bf16: each layer in f64 (the bf16 products and their
    sums exact), the coordinates, each layer's accumulator and each
    activation rounded through f32 to bf16, the last layer's value to f32:
    no kernel's summation order, and one arithmetic on every device."""
    bf16 = net.dtype == torch.bfloat16
    work = torch.float64 if bf16 else torch.float32
    x = _rounded(x.to(work)) if bf16 else x.float()
    h = x
    n_lin = len(net.plain_layers)
    for layer, (kind, w_h, w_x, b) in enumerate(net.plain_layers):
        w_h, w_x, b = (None if t is None else t.to(work) for t in (w_h, w_x, b))
        if kind == "first":
            acc = x @ w_x + b
        elif kind == "skip":
            acc = (h @ w_h + x @ w_x) * INV_SQRT2 + b
        else:
            acc = h @ w_h + b
        if layer < n_lin - 1:
            if bf16:
                acc = _rounded(acc)
            if net.beta > 0:
                t = net.beta * acc
                acc = (torch.clamp_min(t, 0.0) + torch.log1p(torch.exp(-t.abs()))) / net.beta
            else:
                acc = torch.clamp_min(acc, 0.0)
            h = _rounded(acc) if bf16 else acc
        else:
            h = acc
    if net.beta <= 0:
        h = torch.tanh(h)
    return h[:, 0].float()


def forward_tf32_model(net: FusedNet, x: torch.Tensor, passes: int = 3) -> torch.Tensor:
    """The f32 forward as the split-TF32 kernels round it, over (M, d_in)
    points: every hidden-input product taken over the TF32 halves of its
    operands (``split_tf32``; passes 3: hi.hi + hi.lo + lo.hi, as the
    kernels issue them; 1: hi.hi, a single TF32 pass), summed in f64 and
    rounded to f32; every other step is ``forward_plain``'s f32. With
    passes=1 it is the control that F32_TOL must reject."""
    if net.dtype != torch.float32:
        raise ValueError("the split-TF32 emulation is of the f32 forward")
    if passes not in (1, 3):
        raise ValueError(f"passes must be 1 or 3, got {passes}")

    def product(h, halves):
        (hh, hl), (wh, wl) = split_tf32(h), halves
        acc = hh.double() @ wh.double()
        if passes == 3:
            acc = acc + hh.double() @ wl.double() + hl.double() @ wh.double()
        return acc.float()

    halves = [None if w_h is None else tuple(t.double() for t in split_tf32(w_h))
              for _, w_h, _, _ in net.plain_layers]
    out = torch.empty(x.shape[0], dtype=torch.float32, device=x.device)
    n_lin = len(net.plain_layers)
    for start in range(0, x.shape[0], PLAIN_CHUNK):
        xc = x[start:start + PLAIN_CHUNK].float()
        h = xc
        for layer, (kind, w_h, w_x, b) in enumerate(net.plain_layers):
            if kind == "first":
                acc = xc @ w_x + b
            elif kind == "skip":
                acc = (product(h, halves[layer]) + xc @ w_x) * INV_SQRT2 + b
            else:
                acc = product(h, halves[layer]) + b
            if layer < n_lin - 1:
                if net.beta > 0:
                    t = net.beta * acc
                    acc = (torch.clamp_min(t, 0.0) + torch.log1p(torch.exp(-t.abs()))) / net.beta
                else:
                    acc = torch.clamp_min(acc, 0.0)
            h = acc
        out[start:start + xc.shape[0]] = (torch.tanh(h) if net.beta <= 0 else h)[:, 0]
    return out


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


def fused_grid_tiles_plain(net: FusedNet, n: int, base_tile: int, n_tiles: int) -> torch.Tensor:
    """(n_tiles * TILE_P,) values of the flat grid indices from base_tile *
    TILE_P on; points past n^3 are left as zeros (the kernel leaves them
    unwritten; callers drop them)."""
    start = base_tile * TILE_P
    out = torch.zeros(n_tiles * TILE_P, dtype=torch.float32, device=net.device)
    live = max(0, min(n ** 3, start + out.numel()) - start)
    if live:
        out[:live] = _plain_chunked(net, lambda a, b: grid_points(n, start + a, start + b, net.device),
                                    live)
    return out


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
    lib.sdf_mlp_points.argtypes = [P, L, I, P, I, F, I, P, P, P, I, P, P]
    lib.sdf_mlp_grid.argtypes = [L, L, I, F, P, I, F, I, P, P, P, I, P, P]
    lib.sdf_mlp_blocks.argtypes = [P, P, I, I, I, F, P, I, F, I, P, P, P, I, P, P]
    for fn in (lib.sdf_mlp_points, lib.sdf_mlp_grid, lib.sdf_mlp_blocks):
        fn.restype = I
    lib.sdf_mlp_error_string.argtypes = [I]
    lib.sdf_mlp_error_string.restype = ctypes.c_char_p
    for fn in (lib.sdf_mlp_tile_points, lib.sdf_mlp_max_width, lib.sdf_mlp_f32_k_block):
        fn.argtypes, fn.restype = [], I
    if (lib.sdf_mlp_tile_points() != TILE_P or lib.sdf_mlp_max_width() != MAX_WIDTH
            or lib.sdf_mlp_f32_k_block() != F32_K_BLOCK):
        raise RuntimeError("csrc/fused_mlp.cu and ops/fused_mlp.py disagree on the tile shape")
    return lib


def _check_launch(rc: int, what: str) -> None:
    if rc != 0:
        msg = _lib().sdf_mlp_error_string(rc).decode()
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc} ({msg})")


def _cuda_args(net: FusedNet, *tensors: torch.Tensor):
    """Validate a launch and return (weights ptr, biases ptr, desc ptr,
    n_lin, bf16 flag, stream ptr, tiles ptr, hidden width). Both types run
    on the tensor cores and stream their weight stages from ``net.tiles``
    (bf16) or ``net.tf32_tiles`` (f32)."""
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
    bf16 = net.dtype == torch.bfloat16
    tiles = (net.tiles if bf16 else net.tf32_tiles).data_ptr()
    return (wbuf.data_ptr(), bbuf.data_ptr(), desc.data_ptr(), desc.shape[0], int(bf16), stream,
            tiles, net.h_pad)


def fused_points(net: FusedNet, x: torch.Tensor) -> torch.Tensor:
    """(N, d_in) f32 points -> (N,) f32 field values."""
    if x.dim() != 2 or x.shape[1] != net.d_in:
        raise ValueError(f"points must be (N, {net.d_in}), got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return fused_points_plain(net, x)
    if x.dtype != torch.float32:
        raise ValueError(f"points must be float32, got {x.dtype}")
    w, b, desc, n_lin, bf16, stream, tiles, width = _cuda_args(net, x)
    out = torch.empty(x.shape[0], dtype=torch.float32, device=x.device)
    if x.shape[0]:
        with torch.cuda.device(x.device):
            rc = _lib().sdf_mlp_points(x.data_ptr(), x.shape[0], net.d_in, desc, n_lin,
                                       net.beta, bf16, w, b, tiles, width, out.data_ptr(), stream)
        _check_launch(rc, "fused_points")
        LAUNCHES["fused_points"] += 1
    return out


def _grid_launch(net: FusedNet, n: int, base_tile: int, n_tiles: int, out: torch.Tensor,
                 what: str) -> None:
    """One grid-entry launch over tiles [base_tile, base_tile + n_tiles),
    written to ``out`` from its start (points past n^3 are not written)."""
    w, b, desc, n_lin, bf16, stream, tiles, width = _cuda_args(net, out)
    with torch.cuda.device(net.device):
        rc = _lib().sdf_mlp_grid(base_tile, n_tiles, n, 2.0 / (n - 1), desc, n_lin,
                                 net.beta, bf16, w, b, tiles, width, out.data_ptr(), stream)
    _check_launch(rc, what)
    LAUNCHES[what] += 1


def fused_grid(net: FusedNet, n: int) -> torch.Tensor:
    """The field on the dense n^3 grid over linspace(-1, 1, n), flat
    x*n^2 + y*n + z, as an (n^3,) f32 tensor on the net's device."""
    if net.d_in != 3:
        raise ValueError("grid evaluation needs a 3-d input")
    if net.device.type == "cpu":
        return fused_grid_plain(net, n)
    total = n ** 3
    out = torch.empty(total, dtype=torch.float32, device=net.device)
    _grid_launch(net, n, 0, -(-total // TILE_P), out, "fused_grid")
    return out


def fused_grid_tiles(net: FusedNet, n: int, base_tile: int, n_tiles: int) -> torch.Tensor:
    """The grid entry over one shard's slab: tiles [base_tile, base_tile +
    n_tiles) of TILE_P flat grid indices -> (n_tiles * TILE_P,) f32, value
    i at flat index base_tile * TILE_P + i. Points past n^3 are not written.
    Counted under ``sharded_grid`` (TPU kernel 10)."""
    if net.d_in != 3:
        raise ValueError("grid evaluation needs a 3-d input")
    if base_tile < 0 or n_tiles < 0:
        raise ValueError(f"base_tile {base_tile} and n_tiles {n_tiles} must not be negative")
    if net.device.type == "cpu":
        return fused_grid_tiles_plain(net, n, base_tile, n_tiles)
    out = torch.empty(n_tiles * TILE_P, dtype=torch.float32, device=net.device)
    _grid_launch(net, n, base_tile, n_tiles, out, "sharded_grid")
    return out


def fused_blocks(net: FusedNet, ids: torch.Tensor, count: torch.Tensor,
                 n: int, block: int, counter: str = "sparse_blocks") -> torch.Tensor:
    """The block^3 points of blocks ``ids[:count]`` (flat over the
    (n/block)^3 blocks) -> (len(ids), block^3) f32. ``count`` is a 1-element
    int32 tensor read on the device (no host sync); rows past it are not
    written. ``counter``: the ``LAUNCHES`` key the launch counts under
    ("sparse_sharded_blocks" for a shard of ops/sharded_eval.py)."""
    if net.d_in != 3:
        raise ValueError("grid evaluation needs a 3-d input")
    if ids.device.type == "cpu":
        return fused_blocks_plain(net, ids, count, n, block)
    if ids.dtype != torch.int32 or count.dtype != torch.int32 or count.numel() != 1:
        raise ValueError("ids and count must be int32, count one element")
    if block ** 3 % TILE_P:
        raise ValueError(f"block^3 must be a multiple of {TILE_P} (block % 4 == 0)")
    w, b, desc, n_lin, bf16, stream, tiles, width = _cuda_args(net, ids, count)
    out = torch.empty((ids.shape[0], block ** 3), dtype=torch.float32, device=ids.device)
    with torch.cuda.device(ids.device):
        rc = _lib().sdf_mlp_blocks(ids.data_ptr(), count.data_ptr(), ids.shape[0], n // block,
                                   block, 2.0 / (n - 1), desc, n_lin, net.beta, bf16, w, b,
                                   tiles, width, out.data_ptr(), stream)
    _check_launch(rc, counter)
    LAUNCHES[counter] += 1
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
