"""Fused (f, grad_x f) of an ImplicitNet with a params-only backward —
counterpart of sdf_representation_tpu/ops/pallas_igr.py.

The eikonal (IGR) losses need (f(x), grad_x f(x)) per point and are then
differentiated w.r.t. the PARAMETERS. ``csrc/fused_igr.cu`` holds the two
kernels:

  ``igr_fwd``  f and grad_x f: the primal forward, then one reverse sweep of
               a single cotangent from the scalar head  <- _fused_vag_fwd
  ``igr_bwd``  grad_theta sum_b [a_b f_b + c_b . grad_x f(x_b)] for the loss's
               cotangents a = dL/df (N,), c = dL/dg (N, d_in): both chains
               rematerialised, one reverse sweep, dW and db summed over the
               points                                   <- _fused_vag_bwd

``FusedValueAndGrad`` ties them into autograd; ``make_fused_value_and_grad``
binds it to a module, and ``make_fused_value_and_grad_sharded`` runs it once
per shard of a mesh for data-parallel training (pallas_igr.py:495-531). The
backward is **params-only**: ``x`` is data and gets no gradient
(differentiating this op w.r.t. ``x`` yields None), as in the JAX package,
whose custom VJP returns a zero cotangent for ``x``.

Each wrapper takes its kernel's plain PyTorch version when the tensors lie
on the CPU, and launches the kernel or raises when they lie on a card: there
is no fallback. ``LAUNCHES`` counts one launch per wrapper call, and
``WORKSPACE_BYTES`` holds each kernel's workspace at its last launch.

Working types, as in the JAX kernels: float32 all the way, or bfloat16:
bf16 weights; ``x`` and ``c`` rounded on entry; the stashed act'(z), act(z)
and tangent rounded; every cotangent rounded before a product with W^T or
into dW; f32 accumulators, biases, ``a``, seeds, db and elementwise backward
arithmetic. The backward recovers act' from the stashed activation,
s = 1 - exp(-beta * h), in the kernel and in the plain version alike. The
plain versions compute in f32 in f32 mode; in bf16 mode they sum every
product in f64, where the bf16 products and their sums are exact, and round
through f32 to bf16 at the JAX kernels' points: the value every f32
summation order approximates, the same on every device (as
fused_mlp.forward_plain).

On a card both types run on the tensor cores: bf16 products in bf16
(``FusedNet.igr_tiles`` is their weight image), f32 ones as three TF32
products of operands split in two halves (``FusedNet.igr_tf32_tiles``;
``fused_value_and_grad_tf32_model`` and ``fused_param_grads_tf32_model``
emulate them, and with one pass the single-TF32 control). The forward
stashes act'(z) (bf16: rounded) in a workspace; the backward writes each
layer's [act(z); tcz s] and [dz; dtcz] to a workspace (``_workspace_sets``,
``_workspace_sets_f32``) and db per tile (f32: per warp) to a partial-sum
buffer, and a second kernel, launched from the same call, owns the tiles of
dW and sums over all points' rows in a fixed order (``dw_plan``), then db
over the tiles: two launches give the same gradients bit for bit, in either
type. ``images_plain`` and ``dw_pass_plain`` are the plain versions of the
backward's two passes (its workspace, and dW from a workspace).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from .. import kernels
from ..models.implicit_net import softplus_beta
from ..parallel.mesh import ProcessMesh, gather, get_mesh, over_ranks, replicate, shard_batch
from .fused_mlp import INV_SQRT2, MAX_D_IN, MAX_WIDTH, FusedNet, _rounded, split_tf32, swizzle_128b

# f32 (the split-TF32 routines of csrc/fused_igr.cu, namespace tf32): one
# 64-row tile per CTA
FWD_TILE_P = 64     # points per CTA, forward (kFwdPts): a row each
BWD_TILE_P = 32     # points per CTA, backward (kBwdPts): a primal and a tangent row each
TILE_ROWS = 64      # tile rows per CTA in both kernels
PLAN_FIELDS_F32 = 11  # int64 per job of the f32 dW pass (kPlan)
# bf16 (the bf16 tensor-core routine, namespace tc)
FWD_CTA_P = 128     # points per CTA, forward (kFwdCtaPts): 64 per consumer warpgroup
BWD_CTA_P = 64      # points per CTA, backward (kBwdCtaPts): two 64-row tiles
TILE_POINTS = 32    # points of a backward tile: a primal and a tangent row each (kTilePts)
IMG_BLOCK = 64 * 64  # elements of one workspace image block (kImgBlock)
PLAN_FIELDS = 10    # int64 per job of the bf16 dW pass (kPlan)

# kernel launches per wrapper; chip_smoke.py zeroes them around the main path
LAUNCHES = {"igr_fwd": 0, "igr_bwd": 0}
# device bytes of each kernel's workspace at its last launch
WORKSPACE_BYTES = {"igr_fwd": 0, "igr_bwd": 0}

# per layer (dW_hidden (k_pad, n_pad) or None, dW_coords (d_in, n_pad) or None, db (n_pad,))
PaddedGrads = List[Tuple[Optional[torch.Tensor], Optional[torch.Tensor], torch.Tensor]]


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


# ---------------------------------------------------------------------------
# plain PyTorch versions (the CPU path; on a card only compared against)
# ---------------------------------------------------------------------------

def _act(z: torch.Tensor, beta: float) -> torch.Tensor:
    return softplus_beta(z, beta) if beta > 0 else torch.clamp_min(z, 0.0)


def _sigma(z: torch.Tensor, beta: float) -> torch.Tensor:
    """act'(z): sigmoid(beta z), or the step for ReLU."""
    return torch.sigmoid(beta * z) if beta > 0 else (z > 0).to(z.dtype)


def _head_layers(net: FusedNet):
    """``net.plain_layers`` with the last layer cut to its one live column."""
    kind, w_h, w_x, b = net.plain_layers[-1]
    if kind != "plain":
        raise ValueError("the last layer must take the hidden activations only")
    return net.plain_layers[:-1] + [(kind, w_h[:, :1], w_x, b[:1])]


def _plain_arith(net: FusedNet):
    """(working dtype, rounding, ``_head_layers`` in that dtype) of the plain
    versions. f32: f32 matmuls, no rounding. bf16: every product summed in
    f64, where the bf16 products and their sums are exact, and rounded
    through f32 to bf16 at the JAX kernels' points: the value every f32
    summation order approximates, the same on every device, and no kernel's
    summation order."""
    if net.dtype == torch.bfloat16:
        work, rnd = torch.float64, _rounded
    else:
        work, rnd = torch.float32, (lambda t: t)
    layers = [(kind, *(None if t is None else t.to(work) for t in (w_h, w_x, b)))
              for kind, w_h, w_x, b in _head_layers(net)]
    return work, rnd, layers


def _matmul(t: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return t @ w


def _tf32_product(passes: int):
    """t @ w as the split-TF32 kernels compute it: over the TF32 halves of
    both operands (``split_tf32``; passes 3: hi.hi + hi.lo + lo.hi, 1: hi.hi,
    a single TF32 pass), summed in f64 and rounded to f32."""
    if passes not in (1, 3):
        raise ValueError(f"passes must be 1 or 3, got {passes}")

    def product(t, w):
        (th, tl), (wh, wl) = split_tf32(t), split_tf32(w)
        acc = th.double() @ wh.double()
        if passes == 3:
            acc = acc + th.double() @ wl.double() + tl.double() @ wh.double()
        return acc.float()

    return product


def fused_value_and_grad_plain(net: FusedNet, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """What ``igr_fwd`` computes, in PyTorch: (f (N,), grad_x f (N, d_in)),
    f32."""
    return _value_and_grad(net, x, _matmul)


def fused_value_and_grad_tf32_model(net: FusedNet, x: torch.Tensor,
                                    passes: int = 3) -> Tuple[torch.Tensor, torch.Tensor]:
    """The f32 ``igr_fwd`` as the split-TF32 kernel rounds it: every product
    of the hidden activations or of the cotangents with a hidden-input
    matrix (the head's included; not the head's reverse step, an outer
    product of one multiply a term) over the TF32 halves of its operands,
    summed in f64 (``_tf32_product``); every other step the plain f32
    version's. passes=1 is the single TF32 pass that the f32 limits must
    reject."""
    if net.dtype != torch.float32:
        raise ValueError("the split-TF32 emulation is of the f32 kernels")
    return _value_and_grad(net, x, _tf32_product(passes))


def _value_and_grad(net: FusedNet, x: torch.Tensor, product) -> Tuple[torch.Tensor, torch.Tensor]:
    work, rnd, layers = _plain_arith(net)
    beta = net.beta
    x = rnd(x.to(work))
    h, stash = x, []
    for layer, (kind, w_h, w_x, b) in enumerate(layers):
        if kind == "first":
            z = x @ w_x + b
        elif kind == "skip":
            z = (product(h, w_h) + x @ w_x) * INV_SQRT2 + b
        else:
            z = product(h, w_h) + b
        if layer < len(layers) - 1:
            stash.append(rnd(_sigma(z, beta)))
            h = rnd(_act(z, beta))
    if beta > 0:
        f, dz = z, torch.ones_like(z)
    else:
        f = torch.tanh(z)
        dz = 1.0 - f * f
    dx = torch.zeros_like(x)
    for layer in range(len(layers) - 1, -1, -1):
        kind, w_h, w_x, _ = layers[layer]
        scale = INV_SQRT2 if kind == "skip" else 1.0
        dz_c = rnd(dz)
        if w_x is not None:
            dx = dx + (dz_c @ w_x.T) * scale
        if layer > 0:
            mm = _matmul if layer == len(layers) - 1 else product
            dz = mm(dz_c, w_h.T) * scale * stash[layer - 1]
    return f[:, 0].float(), dx.float()


def _param_grad_chain(net: FusedNet, x: torch.Tensor, a: torch.Tensor, c: torch.Tensor,
                      live: Optional[int] = None, product=_matmul):
    """The plain backward's values, in ``_plain_arith``'s dtype: (x, c
    rounded, per layer (its input rows h_prev and tc_prev, its cotangents dz
    and dtcz before rounding)). Rows at or past ``live`` get zero seeds (the
    kernels' padded points). ``product(t, w)``: the products with the
    hidden-input matrices but the head's reverse step (``_tf32_product``
    for the split-TF32 emulation)."""
    work, rnd, layers = _plain_arith(net)
    beta = net.beta
    n_lin = len(layers)
    x, c, a = rnd(x.to(work)), rnd(c.to(work)), a.to(work)
    # rematerialise the primal chain h and the c-tangent chain tc
    h, tc, stash = x, c, []
    for layer, (kind, w_h, w_x, b) in enumerate(layers):
        if kind == "first":
            z, tcz = x @ w_x, c @ w_x
        elif kind == "skip":
            z, tcz = (product(h, w_h) + x @ w_x) * INV_SQRT2, (product(tc, w_h) + c @ w_x) * INV_SQRT2
        else:
            z, tcz = product(h, w_h), product(tc, w_h)
        z = z + b  # the bias belongs to the primal chain only
        if layer < n_lin - 1:
            h, tc = rnd(_act(z, beta)), rnd(tcz * _sigma(z, beta))
            stash.append((h, tc))
    # seeds on the last layer's (z, Tcz)
    if beta > 0:
        dz, dtcz = a[:, None], torch.ones_like(z)
    else:  # f = tanh z, g = Tcz (1 - f^2)
        z, tcz = rnd(z), rnd(tcz)
        t = torch.tanh(z)
        fp = 1.0 - t * t
        dz, dtcz = a[:, None] * fp - 2.0 * t * fp * tcz, fp
    if live is not None:
        keep = (torch.arange(x.shape[0], device=x.device) < live)[:, None]
        dz, dtcz = dz * keep, dtcz * keep
    chain = [None] * n_lin
    for layer in range(n_lin - 1, -1, -1):
        kind, w_h, _, _ = layers[layer]
        scale = INV_SQRT2 if kind == "skip" else 1.0
        h_prev, tc_prev = (x, c) if layer == 0 else stash[layer - 1]
        chain[layer] = (h_prev, tc_prev, dz, dtcz)
        if layer > 0:
            mm = _matmul if layer == n_lin - 1 else product
            dh, dtc = mm(rnd(dz), w_h.T) * scale, mm(rnd(dtcz), w_h.T) * scale
            if beta > 0:
                s = 1.0 - torch.exp(-beta * h_prev)  # sigmoid(beta z) from the stashed act(z)
                dz = dh * s + (dtc * tc_prev) * (beta * (1.0 - s))
            else:
                s = (h_prev > 0).to(h_prev.dtype)
                dz = dh * s
            dtcz = dtc * s
    return x, c, chain


def fused_param_grads_plain(net: FusedNet, x: torch.Tensor, a: torch.Tensor,
                            c: torch.Tensor) -> PaddedGrads:
    """What ``igr_bwd`` computes, in PyTorch, step by step: the padded f32
    gradients of sum_b [a_b f_b + c_b . grad_x f(x_b)] w.r.t. every weight
    and bias."""
    return _param_grads(net, x, a, c, None)


def fused_param_grads_tf32_model(net: FusedNet, x: torch.Tensor, a: torch.Tensor, c: torch.Tensor,
                                 passes: int = 3) -> PaddedGrads:
    """The f32 ``igr_bwd`` as the split-TF32 kernels round it: both chains'
    products and the reverse products with the hidden-input matrices as in
    ``fused_value_and_grad_tf32_model``, and each dW (dW_x too) as one
    product of [h; tc]^T and [dz; dtcz] over all rows, over the TF32 halves
    of both, summed in f64; every other step the plain f32 version's."""
    if net.dtype != torch.float32:
        raise ValueError("the split-TF32 emulation is of the f32 kernels")
    return _param_grads(net, x, a, c, _tf32_product(passes))


def _param_grads(net: FusedNet, x: torch.Tensor, a: torch.Tensor, c: torch.Tensor, product) -> PaddedGrads:
    _, rnd, layers = _plain_arith(net)
    x, c, chain = _param_grad_chain(net, x, a, c, product=product or _matmul)
    grads: PaddedGrads = []
    for (kind, w_h, w_x, _), (h_prev, tc_prev, dz, dtcz) in zip(layers, chain):
        scale = INV_SQRT2 if kind == "skip" else 1.0
        dz_c, dtcz_c = rnd(dz), rnd(dtcz)

        def rows_product(u, t):  # [u; t]^T [dz; dtcz]
            if product is None:
                return u.T @ dz_c + t.T @ dtcz_c
            return product(torch.cat([u, t]).T, torch.cat([dz_c, dtcz_c]))

        g_h = None if w_h is None else (rows_product(h_prev, tc_prev) * scale).float()
        g_x = None if w_x is None else (rows_product(x, c) * scale).float()
        grads.append((g_h, g_x, dz.sum(dim=0).float()))
    return grads


# ---------------------------------------------------------------------------
# the backward's workspaces and the plans of its dW pass
# ---------------------------------------------------------------------------

def _workspace_sets(n_lin: int, h_pad: int) -> Tuple[Dict, int]:
    """The image sets of the bf16 backward's workspace (``Sets`` in
    csrc/fused_igr.cu): {("stash", l): [act(z); tcz s] of hidden layer l,
    "coords": [x; c], ("cot", l): the rounded [dz; dtcz] of layer l} ->
    (base, blocks), both in 64 x 64 blocks per tile; and the blocks per
    tile in all. Block fb of tile T of a set lies at element (base * tiles +
    T * blocks + fb) * IMG_BLOCK, each block 64 tile rows x 64 columns in
    the 128-byte swizzle. A tile's row r is point 32 T + 8 (r // 16) + r % 8,
    its primal row where r % 16 < 8, its tangent row otherwise."""
    hb = h_pad // 64
    sets: Dict = {("stash", l): (l * hb, hb) for l in range(n_lin - 1)}
    sets["coords"] = ((n_lin - 1) * hb, 1)
    for l in range(n_lin):
        sets["cot", l] = ((n_lin - 1) * hb + 1 + l * hb, hb if l < n_lin - 1 else 2)
    return sets, 2 * (n_lin - 1) * hb + 3


def _workspace_sets_f32(n_lin: int, h_pad: int) -> Tuple[Dict, int]:
    """The sets of the f32 backward's workspace (``tf32::Sets`` in
    csrc/fused_igr.cu), {("stash", l): [act(z); tcz s] of hidden layer l,
    "coords": [x; c], ("cot", l): [dz; dtcz] of layer l} -> (base, floats
    per tile), base in floats per tile before the set; and the floats per
    tile in all. Tile T of a set starts at float base * tiles + T * size. A
    tile holds 32 points, 32 T .. 32 T + 31. The stash and coords sets are
    64 x width in the slot order (``_slot_image``), the cot sets the dW
    pass's split images (``_cot_image``)."""
    stash = 64 * h_pad
    sets: Dict = {("stash", l): (l * stash, stash) for l in range(n_lin - 1)}
    sets["coords"] = ((n_lin - 1) * stash, 4096)
    base = (n_lin - 1) * stash + 4096
    for l in range(n_lin):
        size = 128 * (h_pad if l < n_lin - 1 else 128)
        sets["cot", l] = (base, size)
        base += size
    return sets, base


@functools.lru_cache(maxsize=None)
def _dw_jobs(layout: Tuple[Tuple[int, ...], ...], d_in: int, h_pad: int) -> Tuple[Tuple[int, ...], ...]:
    sets, _ = _workspace_sets(len(layout), h_pad)
    jobs = []
    for layer, (k, n, skip, _, w_off, wx_off) in enumerate(layout):
        b_base, b_blocks = sets["cot", layer]
        operands = []
        if w_off >= 0:  # dW_h = [h; tc]^T [dz; dtcz] of the layer below
            operands.append((sets["stash", layer - 1], w_off, k))
        if wx_off >= 0:  # dW_x = [x; c]^T [dz; dtcz], d_in rows
            operands.append((sets["coords"], wx_off, d_in))
        for (a_base, a_blocks), off, rows in operands:
            for mb in range(-(-rows // 64)):
                for nb in range(n // 128):
                    jobs.append((a_base, a_blocks, mb, b_base, b_blocks, 2 * nb,
                                 off + 64 * mb * n + 128 * nb, n, min(64, rows - 64 * mb), skip))
    return tuple(jobs)


@functools.lru_cache(maxsize=None)
def _dw_jobs_f32(layout: Tuple[Tuple[int, ...], ...], d_in: int, h_pad: int) -> Tuple[Tuple[int, ...], ...]:
    sets, _ = _workspace_sets_f32(len(layout), h_pad)
    jobs = []
    for layer, (k, n, skip, _, w_off, wx_off) in enumerate(layout):
        b_base, b_size = sets["cot", layer]
        operands = []
        if w_off >= 0:  # dW_h = [h; tc]^T [dz; dtcz] of the layer below
            operands.append((sets["stash", layer - 1], w_off, k))
        if wx_off >= 0:  # dW_x = [x; c]^T [dz; dtcz], d_in rows
            operands.append((sets["coords"], wx_off, d_in))
        for (a_base, a_size), off, rows in operands:
            for mb in range(-(-rows // 128)):
                live = min(128, rows - 128 * mb)
                for nb in range(n // 128):
                    jobs.append((a_base, a_size, 8192 * mb, -(-live // 64), b_base, b_size, 16384 * nb,
                                 off + 128 * mb * n + 128 * nb, n, live, skip))
    return tuple(jobs)


def dw_plan(net: FusedNet) -> Tuple[Tuple[int, ...], ...]:
    """The jobs of the backward's dW pass, one CTA each (``kPlan`` in
    csrc/fused_igr.cu), together covering the packed weight buffer once.
    bf16: a 64 x 128 tile of one layer's dW_h or dW_x, (A set base, A
    blocks per tile, A block (the 64 rows of dW), B set base, B blocks per
    tile, first of the two B blocks, offset of the tile's first element in
    the packed gradient buffer, its row stride, rows written, skip): the sum
    over every workspace tile, in order, of A's 64 rows x 64 columns
    transposed times B's 64 rows x 128 columns, times 1/sqrt(2) where skip.
    f32: a 128 x 128 tile, (A set base, A floats per tile, A offset in the
    tile, A blocks of 64 columns (1 or 2), B set base, B floats per tile, B
    offset in the tile, then as bf16): the same sum over the [h; tc] and
    [dz; dtcz] rows of every tile."""
    jobs = _dw_jobs_f32 if net.dtype == torch.float32 else _dw_jobs
    return jobs(tuple(tuple(r) for r in net.layout), net.d_in, net.h_pad)


@functools.lru_cache(maxsize=None)
def _plan_on(jobs: Tuple[Tuple[int, ...], ...], device) -> torch.Tensor:
    return torch.tensor(jobs, dtype=torch.int64, device=device)


@functools.lru_cache(maxsize=None)
def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def dw_splits(n_jobs: int, tiles: int, device) -> int:
    """Parts the f32 dW pass cuts each job's rows into: as many as keep
    n_jobs x parts CTAs within one wave of the card's SMs (1 at 8x512, 3 at
    8x256 on 132 SMs), at most one per tile. The parts are summed in order,
    so the result depends on the card's SM count, and on nothing else."""
    return max(1, min(_sm_count(device) // n_jobs, tiles))


def _tile_rows(primal: torch.Tensor, tangent: torch.Tensor) -> torch.Tensor:
    """(tiles * 32, w) values of the points' primal and tangent rows ->
    (tiles * 64, w) in the backward's tile row order."""
    tiles, w = primal.shape[0] // TILE_POINTS, primal.shape[1]
    both = torch.stack([primal.reshape(tiles, 4, 8, w), tangent.reshape(tiles, 4, 8, w)], dim=2)
    return both.reshape(tiles * 2 * TILE_POINTS, w)


def _image(rows: torch.Tensor, width: int) -> torch.Tensor:
    """(tiles * 64, <= width) rows -> their image blocks (tiles, width / 64,
    64, 64), zero-padded to ``width`` columns, 128-byte swizzled."""
    rows = torch.nn.functional.pad(rows, (0, width - rows.shape[1]))
    tiles = rows.shape[0] // 64
    return swizzle_128b(rows.reshape(tiles, 64, width // 64, 64).permute(0, 2, 1, 3))


def _slot_image(primal: torch.Tensor, tangent: torch.Tensor, width: int) -> torch.Tensor:
    """(tiles * 32, <= width) f32 primal and tangent rows of the points ->
    (tiles, width / 8, 128, 4), zero-padded to ``width`` columns, in the
    slot order of csrc/hopper.cuh: group g, slot t = 32 w + 4 i + q holds
    point 8 w + i of the tile at columns 8 g + 2 q, + 1 as (primal, tangent,
    primal, tangent)."""
    tiles = primal.shape[0] // TILE_POINTS

    def split(t):  # (tiles, w, i, g, q, e): point 8 w + i, column 8 g + 2 q + e
        t = torch.nn.functional.pad(t.float(), (0, width - t.shape[1]))
        return t.reshape(tiles, 4, 8, width // 8, 4, 2)

    both = torch.stack([split(primal), split(tangent)], dim=-1)  # component 2 e + tangent
    return both.permute(0, 3, 1, 2, 4, 5, 6).reshape(tiles, width // 8, 128, 4)


def _slot_rows(image: torch.Tensor, width: int) -> torch.Tensor:
    """``_slot_image`` inverted: (tiles, width / 8, 128, 4) -> (tiles * 32,
    2, width), each point's primal and tangent row."""
    tiles = image.shape[0]
    t = image.reshape(tiles, width // 8, 4, 8, 4, 2, 2).permute(0, 2, 3, 6, 1, 4, 5)
    return t.reshape(tiles * TILE_POINTS, 2, width)


def _cot_image(dz: torch.Tensor, dtcz: torch.Tensor, width: int) -> torch.Tensor:
    """(tiles * 32, <= width) f32 cotangents of the points' primal and
    tangent rows -> the f32 dW pass's B images (tiles, width / 128, 2 K
    blocks, hi / lo, 128, 32): per 128 columns and 32 K, the hi and the lo
    half (``split_tf32``) of the block transposed (columns as rows), K slot
    8 u + j of K block kb the primal (j < 4) or tangent row of point 16 kb +
    4 u + j % 4, in the 128-byte swizzle."""
    tiles = dz.shape[0] // TILE_POINTS

    def split(t):  # (tiles, kb, u, j, column)
        t = torch.nn.functional.pad(t.float(), (0, width - t.shape[1]))
        return t.reshape(tiles, 2, 4, 4, width)

    k = torch.stack([split(dz), split(dtcz)], dim=3).reshape(tiles, 2, 32, width)
    img = torch.stack(split_tf32(k), dim=2)  # (tiles, kb, hi / lo, K, column)
    img = img.reshape(tiles, 2, 2, 32, width // 128, 128).permute(0, 4, 1, 2, 5, 3)
    return swizzle_128b(img.contiguous())


def _cot_rows(image: torch.Tensor, width: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``_cot_image`` inverted: -> the hi and the lo halves, each (tiles *
    32, 2, width): each point's primal and tangent row."""
    tiles = image.shape[0]
    t = swizzle_128b(image).permute(0, 2, 5, 3, 1, 4)  # (tiles, kb, K, hi / lo, blocks, 128)
    t = t.reshape(tiles, 2, 4, 2, 4, 2, width).permute(0, 1, 2, 4, 3, 5, 6)  # (.., u, j, tangent, hi / lo, col)
    t = t.reshape(tiles * TILE_POINTS, 2, 2, width)
    return t[:, :, 0], t[:, :, 1]


def images_plain(net: FusedNet, x: torch.Tensor, a: torch.Tensor,
                 c: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """What ``igr_bwd`` writes before its dW pass, from the plain backward's
    values: (the workspace of ``_workspace_sets`` (bf16) or
    ``_workspace_sets_f32`` (f32), flat; the f32 sums of dz per tile (bf16:
    (tiles, biases)) or per warp's 8 points (f32: (tiles, 4, biases))).
    Points are padded to whole CTAs with zeros and zero seeds, as in the
    kernel."""
    n = x.shape[0]
    f32 = net.dtype == torch.float32
    cta = BWD_TILE_P if f32 else BWD_CTA_P
    pts = -(-n // cta) * cta
    tiles = pts // TILE_POINTS

    def pad(t):
        return torch.nn.functional.pad(t.float(), (0, 0) * (t.dim() - 1) + (0, pts - n))

    xr, cr, chain = _param_grad_chain(net, pad(x), pad(a), pad(c), live=n)
    n_lin = len(chain)
    ws, partial = (t.zero_() for t in _workspace(net, n, True))
    if f32:
        sets, _ = _workspace_sets_f32(n_lin, net.h_pad)

        def put(key, image):
            base, size = sets[key]
            ws[base * tiles:base * tiles + size * tiles] = image.reshape(-1)

        put("coords", _slot_image(xr, cr, 64))
        for layer, (h_prev, tc_prev, dz, dtcz) in enumerate(chain):
            width, b_off = net.layout[layer][1], net.layout[layer][3]
            if layer > 0:
                put(("stash", layer - 1), _slot_image(h_prev, tc_prev, net.h_pad))
            put(("cot", layer), _cot_image(dz, dtcz, width))
            partial[:, :, b_off:b_off + dz.shape[1]] = dz.reshape(tiles, 4, 8, -1).sum(dim=2)
        return ws, partial
    sets, _ = _workspace_sets(n_lin, net.h_pad)

    def put_bf16(key, rows, width):
        base, blocks = sets[key]
        ws[base * tiles * IMG_BLOCK:(base + blocks) * tiles * IMG_BLOCK] = \
            _image(rows, width).reshape(-1).to(torch.bfloat16)

    put_bf16("coords", _tile_rows(xr, cr), 64)
    for layer, (h_prev, tc_prev, dz, dtcz) in enumerate(chain):
        width, b_off = net.layout[layer][1], net.layout[layer][3]
        if layer > 0:
            put_bf16(("stash", layer - 1), _tile_rows(h_prev, tc_prev), net.h_pad)
        put_bf16(("cot", layer), _tile_rows(_rounded(dz), _rounded(dtcz)), width)
        partial[:, b_off:b_off + dz.shape[1]] = dz.reshape(tiles, TILE_POINTS, -1).sum(dim=1)
    return ws, partial


def dw_pass_plain(net: FusedNet, ws: torch.Tensor, partial: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """What the backward's dW pass computes from a workspace: (the packed
    f32 weight gradients, the f32 bias gradients), each job's tile summed
    over all workspace rows in f64 and rounded to f32, db the partial sums
    over the tiles (and warps). bf16: the products of the bf16 images (exact
    in f64). f32: the three split-TF32 products of [h; tc], split here as the
    kernel splits it, with the hi and lo images of [dz; dtcz]."""
    tiles = partial.shape[0]
    wbuf, _, _ = net.packed
    gw = torch.empty(wbuf.numel(), dtype=torch.float32, device=ws.device)
    if net.dtype == torch.float32:
        for (a_base, a_size, a_off, a_blocks, b_base, b_size, b_off, off, stride, n_rows,
             skip) in dw_plan(net):
            a_img = ws[a_base * tiles:(a_base + a_size) * tiles].reshape(tiles, a_size)
            a_img = a_img[:, a_off:a_off + 4096 * a_blocks].reshape(tiles, 8 * a_blocks, 128, 4)
            b_img = ws[b_base * tiles:(b_base + b_size) * tiles].reshape(tiles, b_size)
            b_img = b_img[:, b_off:b_off + 16384].reshape(tiles, 1, 2, 2, 128, 32)
            ah, al = (t.reshape(-1, 64 * a_blocks).double() for t in split_tf32(_slot_rows(a_img, 64 * a_blocks)))
            bh, bl = (t.reshape(-1, 128).double() for t in _cot_rows(b_img, 128))
            tile = ah.T @ bh + ah.T @ bl + al.T @ bh
            if skip:
                tile = tile * INV_SQRT2
            gw.as_strided((n_rows, 128), (stride, 1), off).copy_(tile[:n_rows])
        return gw, partial.double().sum(dim=(0, 1)).float()

    def rows(base, blocks, first, count):
        img = ws[base * tiles * IMG_BLOCK:(base + blocks) * tiles * IMG_BLOCK]
        img = img.reshape(tiles, blocks, 64, 64)[:, first:first + count]
        return swizzle_128b(img).permute(0, 2, 1, 3).reshape(tiles * 64, count * 64).double()

    for a_base, a_blocks, a_block, b_base, b_blocks, b_block, off, stride, n_rows, skip in dw_plan(net):
        tile = rows(a_base, a_blocks, a_block, 1).T @ rows(b_base, b_blocks, b_block, 2)
        if skip:
            tile = tile * INV_SQRT2
        gw.as_strided((n_rows, 128), (stride, 1), off).copy_(tile[:n_rows])
    return gw, partial.double().sum(dim=0).float()


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------

@functools.cache
def _lib() -> ctypes.CDLL:
    lib = kernels.load("fused_igr")
    P, I, L, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib.sdf_igr_fwd_f32.argtypes = [P, L, I, P, I, I, F, P, P, P, P, P, P, P]
    lib.sdf_igr_bwd_f32.argtypes = [P, P, P, L, I, P, I, I, F, P, P, P, P, P, I, P, I, I, P, P, L, P, P]
    lib.sdf_igr_dw_f32.argtypes = [P, I, I, P, L, P, P, L, P, I, P, P]
    lib.sdf_igr_fwd_bf16.argtypes = [P, L, I, P, I, I, F, P, P, P, P, P, P, P]
    lib.sdf_igr_bwd_bf16.argtypes = [P, P, P, L, I, P, I, I, F, P, P, P, P, P, I, P, I, P, P, P]
    lib.sdf_igr_dw_bf16.argtypes = [P, I, P, L, P, P, I, P, P]
    for fn in (lib.sdf_igr_fwd_f32, lib.sdf_igr_bwd_f32, lib.sdf_igr_dw_f32, lib.sdf_igr_fwd_bf16,
               lib.sdf_igr_bwd_bf16, lib.sdf_igr_dw_bf16):
        fn.restype = I
    lib.sdf_igr_cta_points.argtypes = [I, I]
    lib.sdf_igr_plan_fields.argtypes = [I]
    lib.sdf_igr_error_string.argtypes = [I]
    lib.sdf_igr_error_string.restype = ctypes.c_char_p
    tiles = [lib.sdf_igr_cta_points(bf16, bwd) for bf16 in (0, 1) for bwd in (0, 1)]
    if (tiles != [FWD_TILE_P, BWD_TILE_P, FWD_CTA_P, BWD_CTA_P] or lib.sdf_igr_max_width() != MAX_WIDTH
            or [lib.sdf_igr_plan_fields(bf16) for bf16 in (0, 1)] != [PLAN_FIELDS_F32, PLAN_FIELDS]):
        raise RuntimeError("csrc/fused_igr.cu and ops/fused_igr.py disagree on the tile shape")
    return lib


def _check_launch(rc: int, what: str) -> None:
    if rc != 0:
        msg = _lib().sdf_igr_error_string(rc).decode()
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc} ({msg})")


def _cuda_args(net: FusedNet, *tensors: torch.Tensor):
    """Validate a launch; returns the arguments both kernels share: (weights,
    biases, descriptor, stream)."""
    if net.device.type != "cuda":
        raise ValueError(f"the net's weights are on {net.device}, the inputs on a card")
    for t in tensors:
        if t.device != net.device:
            raise ValueError(f"tensor on {t.device}, weights on {net.device}")
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous float32 tensors")
    if net.h_pad > MAX_WIDTH:
        raise ValueError(f"hidden width {net.h_pad} exceeds the kernel's {MAX_WIDTH}")
    if net.d_in > MAX_D_IN:
        raise ValueError(f"d_in {net.d_in} exceeds the kernel's {MAX_D_IN}")
    if len(net.spec) < 2 or net.spec[0] != "first" or net.spec[-1] != "plain":
        raise ValueError("the kernels need a hidden layer and a last layer without a skip input")
    wbuf, bbuf, desc = net.packed
    return wbuf, bbuf, desc, torch.cuda.current_stream(net.device).cuda_stream


def _workspace(net: FusedNet, n: int, backward: bool) -> Tuple[torch.Tensor, ...]:
    """One launch's workspace at n points, written and read back by the
    kernels. Forward: the stash of act'(z), (hidden layers x whole CTAs x
    h_pad) values, f32 or bf16. Backward: the workspace of
    ``_workspace_sets_f32`` (f32) or ``_workspace_sets`` (bf16), flat, and
    the f32 db partial sums, (tiles, 4 warps, biases) or (tiles, biases)."""
    hidden, dev = len(net.spec) - 1, net.device
    f32 = net.dtype == torch.float32
    if not backward:
        cta = FWD_TILE_P if f32 else FWD_CTA_P
        return (torch.empty(hidden * -(-n // cta) * cta * net.h_pad, dtype=net.dtype, device=dev),)
    n_bias = net.packed[1].numel()
    if f32:
        tiles = -(-n // BWD_TILE_P)
        _, total = _workspace_sets_f32(len(net.spec), net.h_pad)
        return (torch.empty(total * tiles, dtype=torch.float32, device=dev),
                torch.empty((tiles, 4, n_bias), dtype=torch.float32, device=dev))
    tiles = -(-n // BWD_CTA_P) * (BWD_CTA_P // TILE_POINTS)
    _, total = _workspace_sets(len(net.spec), net.h_pad)
    return (torch.empty(total * tiles * IMG_BLOCK, dtype=torch.bfloat16, device=dev),
            torch.empty((tiles, n_bias), dtype=torch.float32, device=dev))


def _record_workspace(kernel: str, work: Sequence[torch.Tensor]) -> None:
    WORKSPACE_BYTES[kernel] = sum(t.numel() * t.element_size() for t in work)


def _check_points(net: FusedNet, x: torch.Tensor) -> None:
    if x.dim() != 2 or x.shape[1] != net.d_in:
        raise ValueError(f"points must be (N, {net.d_in}), got {tuple(x.shape)}")


def fused_value_and_grad(net: FusedNet, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, d_in) f32 points -> (f (N,), grad_x f (N, d_in)), both f32."""
    _check_points(net, x)
    if x.device.type == "cpu":
        return fused_value_and_grad_plain(net, x)
    wbuf, bbuf, desc, stream = _cuda_args(net, x)
    n = x.shape[0]
    f = torch.empty(n, dtype=torch.float32, device=x.device)
    g = torch.empty((n, net.d_in), dtype=torch.float32, device=x.device)
    if n:
        (stash,) = work = _workspace(net, n, False)
        _record_workspace("igr_fwd", work)
        bf16 = net.dtype == torch.bfloat16
        launch = _lib().sdf_igr_fwd_bf16 if bf16 else _lib().sdf_igr_fwd_f32
        tiles = net.igr_tiles if bf16 else net.igr_tf32_tiles
        with torch.cuda.device(x.device):
            rc = launch(x.data_ptr(), n, net.d_in, desc.data_ptr(), len(net.spec), net.h_pad, net.beta,
                        wbuf.data_ptr(), bbuf.data_ptr(), tiles.data_ptr(), stash.data_ptr(), f.data_ptr(),
                        g.data_ptr(), stream)
        _check_launch(rc, "igr_fwd")
        LAUNCHES["igr_fwd"] += 1
    return f, g


def _padded(net: FusedNet, gw: torch.Tensor, gb: torch.Tensor) -> PaddedGrads:
    grads: PaddedGrads = []
    for k, width, _, b_off, w_off, wx_off in net.layout:
        g_h = None if w_off < 0 else gw[w_off:w_off + k * width].view(k, width)
        g_x = None if wx_off < 0 else gw[wx_off:wx_off + net.d_in * width].view(net.d_in, width)
        grads.append((g_h, g_x, gb[b_off:b_off + width]))
    return grads


def fused_param_grads(net: FusedNet, x: torch.Tensor, a: torch.Tensor, c: torch.Tensor) -> PaddedGrads:
    """Padded gradients of sum_b [a_b f_b + c_b . grad_x f(x_b)] w.r.t. every
    weight and bias, per layer (dW_hidden, dW_coords, db), in f32."""
    _check_points(net, x)
    if a.shape != x.shape[:1] or c.shape != x.shape:
        raise ValueError(f"cotangents must be ({x.shape[0]},) and {tuple(x.shape)}, "
                         f"got {tuple(a.shape)} and {tuple(c.shape)}")
    if x.device.type == "cpu":
        return fused_param_grads_plain(net, x, a, c)
    gw, gb, _ = _bwd_cuda(net, x, a, c)
    return _padded(net, gw, gb)


def _bwd_cuda(net: FusedNet, x: torch.Tensor, a: torch.Tensor, c: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor, Tuple[torch.Tensor, ...]]:
    """The backward on a card, ``igr_bwd`` then its dW pass from one C call
    -> (packed f32 weight gradients, f32 bias gradients, the workspace the
    first pass wrote: what ``images_plain`` computes; () at N = 0)."""
    wbuf, bbuf, desc, stream = _cuda_args(net, x, a, c)
    n = x.shape[0]
    if not n:  # an empty shard of a mesh: nothing to launch, nothing to add
        return (torch.zeros(wbuf.numel(), dtype=torch.float32, device=x.device),
                torch.zeros(bbuf.numel(), dtype=torch.float32, device=x.device), ())
    # the dW pass writes every element of both
    gw = torch.empty(wbuf.numel(), dtype=torch.float32, device=x.device)
    gb = torch.empty(bbuf.numel(), dtype=torch.float32, device=x.device)
    ws, partial = work = _workspace(net, n, True)
    plan = _plan_on(dw_plan(net), x.device)
    with torch.cuda.device(x.device):
        if net.dtype == torch.bfloat16:
            _record_workspace("igr_bwd", work)
            rc = _lib().sdf_igr_bwd_bf16(
                x.data_ptr(), a.data_ptr(), c.data_ptr(), n, net.d_in, desc.data_ptr(),
                len(net.spec), net.h_pad, net.beta, wbuf.data_ptr(), bbuf.data_ptr(),
                net.igr_tiles.data_ptr(), ws.data_ptr(), partial.data_ptr(), bbuf.numel(),
                plan.data_ptr(), plan.shape[0], gw.data_ptr(), gb.data_ptr(), stream)
        else:
            splits, split_buf = _split_buffer(net, plan.shape[0], partial.shape[0], gw)
            _record_workspace("igr_bwd", work + (split_buf,) * (splits > 1))
            rc = _lib().sdf_igr_bwd_f32(
                x.data_ptr(), a.data_ptr(), c.data_ptr(), n, net.d_in, desc.data_ptr(),
                len(net.spec), net.h_pad, net.beta, wbuf.data_ptr(), bbuf.data_ptr(),
                net.igr_tf32_tiles.data_ptr(), ws.data_ptr(), partial.data_ptr(), bbuf.numel(),
                plan.data_ptr(), plan.shape[0], splits, split_buf.data_ptr(), gw.data_ptr(), gw.numel(),
                gb.data_ptr(), stream)
    _check_launch(rc, "igr_bwd")
    LAUNCHES["igr_bwd"] += 1
    return gw, gb, work


def _split_buffer(net: FusedNet, n_jobs: int, tiles: int, gw: torch.Tensor) -> Tuple[int, torch.Tensor]:
    """The f32 dW pass's parts per job (``dw_splits``) and the buffer of
    their sums (gw itself, unused, with one part)."""
    splits = dw_splits(n_jobs, tiles, gw.device)
    if splits == 1:
        return 1, gw
    return splits, torch.empty(splits * gw.numel(), dtype=torch.float32, device=gw.device)


def dw_pass(net: FusedNet, ws: torch.Tensor, partial: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The backward's dW pass alone, on a workspace of its first pass (or
    of ``images_plain``): (packed f32 weight gradients, bias gradients), as
    ``dw_pass_plain`` computes them. For checks and timings: no wrapper
    calls it, and ``LAUNCHES`` does not count it."""
    if ws.device.type == "cpu":
        return dw_pass_plain(net, ws, partial)
    wbuf, bbuf, _, stream = _cuda_args(net, partial)
    f32 = net.dtype == torch.float32
    sets, total = (_workspace_sets_f32 if f32 else _workspace_sets)(len(net.spec), net.h_pad)
    tiles = partial.shape[0]
    if (ws.device != net.device or ws.dtype != net.dtype or not ws.is_contiguous()
            or partial.shape[-1] != bbuf.numel() or ws.numel() != total * tiles * (1 if f32 else IMG_BLOCK)):
        raise ValueError("not a backward workspace of this net")
    gw = torch.empty(wbuf.numel(), dtype=torch.float32, device=ws.device)
    gb = torch.empty(bbuf.numel(), dtype=torch.float32, device=ws.device)
    plan = _plan_on(dw_plan(net), ws.device)
    with torch.cuda.device(ws.device):
        if f32:
            splits, split_buf = _split_buffer(net, plan.shape[0], tiles, gw)
            rc = _lib().sdf_igr_dw_f32(plan.data_ptr(), plan.shape[0], splits, ws.data_ptr(), tiles,
                                       split_buf.data_ptr(), gw.data_ptr(), gw.numel(), partial.data_ptr(),
                                       bbuf.numel(), gb.data_ptr(), stream)
        else:
            rc = _lib().sdf_igr_dw_bf16(plan.data_ptr(), plan.shape[0], ws.data_ptr(), tiles, gw.data_ptr(),
                                        partial.data_ptr(), bbuf.numel(), gb.data_ptr(), stream)
    _check_launch(rc, "igr_dw")
    return gw, gb


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------

def unpack_grads(d_in: int, shapes: Sequence[torch.Size], padded: PaddedGrads) -> List[torch.Tensor]:
    """Padded kernel gradients -> [dW_0 (out, in), db_0, dW_1, ...] in the
    module's shapes (``shapes``: each layer's weight shape). A skip layer's
    dW is cat(top[: fan_in - d_in], bottom[: d_in]); the 1/sqrt(2) is inside
    the gradients already (pallas_igr._unpack_grads)."""
    out = []
    for (fan_out, fan_in), (g_h, g_x, g_b) in zip(shapes, padded):
        if g_h is None:
            dw = g_x[:fan_in, :fan_out]
        elif g_x is None:
            dw = g_h[:fan_in, :fan_out]
        else:
            dw = torch.cat([g_h[: fan_in - d_in, :fan_out], g_x[:d_in, :fan_out]], dim=0)
        out += [dw.T, g_b[:fan_out]]
    return out


class FusedValueAndGrad(torch.autograd.Function):
    """(f, grad_x f) = FusedValueAndGrad.apply(x, net, w_0, b_0, w_1, b_1, ...)
    with ``net`` the ``FusedNet`` packed from the module's (out, in) weights,
    which come as flat arguments so that each gets its gradient. ``x`` gets
    none: it is data."""

    @staticmethod
    def forward(ctx, x, net, *params):
        x = x.detach().float().contiguous()
        ctx.net, ctx.x = net, x
        ctx.meta = [(w.shape, w.dtype) for w in params[0::2]]
        return fused_value_and_grad(net, x)

    @staticmethod
    def backward(ctx, a, c):
        padded = fused_param_grads(ctx.net, ctx.x, a.float().contiguous(), c.float().contiguous())
        flat = unpack_grads(ctx.net.d_in, [shape for shape, _ in ctx.meta], padded)
        dtypes = [dtype for _, dtype in ctx.meta for _ in range(2)]
        return (None, None, *[g.to(dt) for g, dt in zip(flat, dtypes)])


def _flat(model, layers) -> List[torch.Tensor]:
    return [t for pair in (model.effective_layers() if layers is None else layers) for t in pair]


def make_fused_value_and_grad(model, compute_dtype: torch.dtype = torch.bfloat16):
    """``vag(x, layers=None) -> (f (N,), grad (N, d_in))`` through the fused
    kernels (their plain versions on the CPU), differentiable w.r.t. the
    parameters only. ``layers``: per layer (weight, bias) to use instead of
    the module's own (the mixed-precision step's bf16 copies).

    A drop-in for ``ops.diffops.implicitnet_value_and_grad`` inside training
    losses; the trainer installs it as the ``_implicitnet_fast`` hook."""

    def vag(x: torch.Tensor, layers=None):
        flat = _flat(model, layers)
        net = FusedNet(model, compute_dtype, layers=list(zip(flat[0::2], flat[1::2])))
        return FusedValueAndGrad.apply(x, net, *flat)

    return vag


def make_fused_value_and_grad_sharded(model, mesh, compute_dtype: torch.dtype = torch.bfloat16):
    """``make_fused_value_and_grad`` over a mesh (pallas_igr.py:495-531):
    ``x`` is cut into ``len(mesh)`` contiguous pieces (``shard_batch``),
    shard d runs the fused op on ``mesh[d]`` with the layers replicated
    there, and (f, grad f) are gathered on ``mesh[0]``. On a card that is
    one ``igr_fwd`` launch per shard and, in backward, one ``igr_bwd``
    launch per shard; autograd sums the shards' parameter gradients (the
    psum of the JAX ``shard_map`` transpose). Each distinct device's weights
    are packed once per call, not once per shard, on the device: the
    packing's one host copy, the layout descriptor, is made once per layout
    and device (``fused_mlp._descriptor``), so a step of this op captures
    as a CUDA graph (training/graphs.py) whose replays launch k ``igr_fwd``
    and k ``igr_bwd`` for k shards.

    Under a ``ProcessMesh`` (one process per card) each rank runs the fused
    op on its rows of ``x`` (one ``igr_fwd`` and, in backward, one
    ``igr_bwd`` launch per rank and call) and (f, grad f) are gathered on
    every rank (``parallel.mesh.over_ranks``); the trainer's all-reduce sums
    the ranks' parameter gradients."""
    if isinstance(mesh, ProcessMesh):
        def vag_ranks(x: torch.Tensor, layers=None):
            flat = _flat(model, layers)
            net = FusedNet(model, compute_dtype, layers=list(zip(flat[0::2], flat[1::2])))
            return over_ranks(lambda xs, ps: FusedValueAndGrad.apply(xs, net, *ps), x, flat, mesh)

        return vag_ranks
    mesh = get_mesh(devices=mesh)

    def vag(x: torch.Tensor, layers=None):
        flat = _flat(model, layers)
        nets, f, g = {}, [], []
        for xs, dev, ps in zip(shard_batch(x, mesh), mesh, replicate(flat, mesh)):
            if dev not in nets:
                nets[dev] = FusedNet(model, compute_dtype, layers=list(zip(ps[0::2], ps[1::2])))
            fs, gs = FusedValueAndGrad.apply(xs, nets[dev], *ps)
            f.append(fs)
            g.append(gs)
        return gather(f, mesh[0]), gather(g, mesh[0])

    return vag
