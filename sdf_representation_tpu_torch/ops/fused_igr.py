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

On a card the bf16 kernels run on the tensor cores (``FusedNet.igr_tiles`` is
their weight image). The forward stashes the rounded act'(z) as bf16 in a
workspace; the backward writes each layer's [act(z); tcz s] and rounded
[dz; dtcz] tiles to a bf16 workspace (``_workspace_sets``) and db per tile to
a partial-sum buffer, and a second kernel, launched from the same call, owns
the tiles of dW and sums over all points' rows in a fixed order
(``dw_plan``), then db over the tiles: two launches give the same gradients
bit for bit. ``images_plain`` and ``dw_pass_plain`` are the plain versions of
the backward's two passes (its workspace, and dW from a workspace). The f32
kernels run on the CUDA cores with an f32 stash, a transposed weight copy
(``FusedNet.transposed``) and dW / db added by atomics, whose order changes
run to run.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from .. import kernels
from ..models.implicit_net import softplus_beta
from ..parallel.mesh import gather, get_mesh, replicate, shard_batch
from .fused_mlp import INV_SQRT2, MAX_D_IN, MAX_WIDTH, FusedNet, _rounded, swizzle_128b

# f32 (the SIMT routine of csrc/fused_igr.cu, namespace simt)
FWD_TILE_P = 64     # points per CUDA block, forward (kRows)
BWD_TILE_P = 32     # points per CUDA block, backward (kBwdPts): two tile rows each
TILE_ROWS = 64      # workspace rows per block in both kernels
# bf16 (the tensor-core routine, namespace tc)
FWD_CTA_P = 128     # points per CTA, forward (kFwdCtaPts): 64 per consumer warpgroup
BWD_CTA_P = 64      # points per CTA, backward (kBwdCtaPts): two 64-row tiles
TILE_POINTS = 32    # points of a backward tile: a primal and a tangent row each (kTilePts)
IMG_BLOCK = 64 * 64  # elements of one workspace image block (kImgBlock)
PLAN_FIELDS = 10    # int64 per job of the dW pass (kPlan)

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


def fused_value_and_grad_plain(net: FusedNet, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """What ``igr_fwd`` computes, in PyTorch: (f (N,), grad_x f (N, d_in)),
    f32."""
    work, rnd, layers = _plain_arith(net)
    beta = net.beta
    x = rnd(x.to(work))
    h, stash = x, []
    for layer, (kind, w_h, w_x, b) in enumerate(layers):
        if kind == "first":
            z = x @ w_x + b
        elif kind == "skip":
            z = (h @ w_h + x @ w_x) * INV_SQRT2 + b
        else:
            z = h @ w_h + b
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
            dz = (dz_c @ w_h.T) * scale * stash[layer - 1]
    return f[:, 0].float(), dx.float()


def _param_grad_chain(net: FusedNet, x: torch.Tensor, a: torch.Tensor, c: torch.Tensor,
                      live: Optional[int] = None):
    """The plain backward's values, in ``_plain_arith``'s dtype: (x, c
    rounded, per layer (its input rows h_prev and tc_prev, its cotangents dz
    and dtcz before rounding)). Rows at or past ``live`` get zero seeds (the
    kernels' padded points)."""
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
            z, tcz = (h @ w_h + x @ w_x) * INV_SQRT2, (tc @ w_h + c @ w_x) * INV_SQRT2
        else:
            z, tcz = h @ w_h, tc @ w_h
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
            dh, dtc = (rnd(dz) @ w_h.T) * scale, (rnd(dtcz) @ w_h.T) * scale
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
    _, rnd, layers = _plain_arith(net)
    x, c, chain = _param_grad_chain(net, x, a, c)
    grads: PaddedGrads = []
    for (kind, w_h, w_x, _), (h_prev, tc_prev, dz, dtcz) in zip(layers, chain):
        scale = INV_SQRT2 if kind == "skip" else 1.0
        dz_c, dtcz_c = rnd(dz), rnd(dtcz)
        g_h = None if w_h is None else ((h_prev.T @ dz_c + tc_prev.T @ dtcz_c) * scale).float()
        g_x = None if w_x is None else ((x.T @ dz_c + c.T @ dtcz_c) * scale).float()
        grads.append((g_h, g_x, dz.sum(dim=0).float()))
    return grads


# ---------------------------------------------------------------------------
# the bf16 backward's workspace and the plan of its dW pass
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


def dw_plan(net: FusedNet) -> Tuple[Tuple[int, ...], ...]:
    """The jobs of the bf16 backward's dW pass, one CTA each (``kPlan`` in
    csrc/fused_igr.cu): a 64 x 128 tile of one layer's dW_h or dW_x,
    (A set base, A blocks per tile, A block, B set base, B blocks per tile,
    first of the two B blocks, offset of the tile's first element in the
    packed gradient buffer, its row stride, rows written, skip). The tile is
    the sum over every workspace tile, in order, of A's 64 rows x 64
    columns transposed times B's 64 rows x 128 columns, times 1/sqrt(2)
    where skip; the jobs cover the packed weight buffer once."""
    return _dw_jobs(tuple(tuple(r) for r in net.layout), net.d_in, net.h_pad)


@functools.lru_cache(maxsize=None)
def _plan_on(jobs: Tuple[Tuple[int, ...], ...], device) -> torch.Tensor:
    return torch.tensor(jobs, dtype=torch.int64, device=device)


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


def images_plain(net: FusedNet, x: torch.Tensor, a: torch.Tensor,
                 c: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """What the bf16 ``igr_bwd`` writes before its dW pass, from the plain
    backward's values: (the bf16 workspace of ``_workspace_sets``, flat; the
    (tiles, biases) f32 sums of each tile's dz). Points are padded to whole
    CTAs with zeros and zero seeds, as in the kernel."""
    if net.dtype != torch.bfloat16:
        raise ValueError("the workspace is the bf16 kernel's")
    n = x.shape[0]
    pts = -(-n // BWD_CTA_P) * BWD_CTA_P
    tiles = pts // TILE_POINTS

    def pad(t):
        return torch.nn.functional.pad(t.float(), (0, 0) * (t.dim() - 1) + (0, pts - n))

    xr, cr, chain = _param_grad_chain(net, pad(x), pad(a), pad(c), live=n)
    n_lin = len(chain)
    sets, _ = _workspace_sets(n_lin, net.h_pad)
    ws, partial = (t.zero_() for t in _workspace(net, n, True))

    def put(key, rows, width):
        base, blocks = sets[key]
        ws[base * tiles * IMG_BLOCK:(base + blocks) * tiles * IMG_BLOCK] = \
            _image(rows, width).reshape(-1).to(torch.bfloat16)

    put("coords", _tile_rows(xr, cr), 64)
    for layer, (h_prev, tc_prev, dz, dtcz) in enumerate(chain):
        width, b_off = net.layout[layer][1], net.layout[layer][3]
        if layer > 0:
            put(("stash", layer - 1), _tile_rows(h_prev, tc_prev), net.h_pad)
        put(("cot", layer), _tile_rows(_rounded(dz), _rounded(dtcz)), width)
        partial[:, b_off:b_off + dz.shape[1]] = dz.reshape(tiles, TILE_POINTS, -1).sum(dim=1)
    return ws, partial


def dw_pass_plain(net: FusedNet, ws: torch.Tensor, partial: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """What the bf16 backward's dW pass computes from a workspace: (the
    packed f32 weight gradients, the f32 bias gradients), each job's tile
    summed over all workspace rows in f64 (the bf16 products and their sums
    exact), db the partial sums over the tiles, then rounded to f32."""
    tiles = partial.shape[0]
    wbuf, _, _ = net.packed
    gw = torch.empty(wbuf.numel(), dtype=torch.float32, device=ws.device)

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
    lib.sdf_igr_fwd_f32.argtypes = [P, L, I, P, P, I, I, F, P, P, P, P, L, P, P, P]
    lib.sdf_igr_bwd_f32.argtypes = [P, P, P, L, I, P, P, I, I, F, P, P, P, P, L, P, P, P]
    lib.sdf_igr_fwd_bf16.argtypes = [P, L, I, P, I, I, F, P, P, P, P, P, P, P]
    lib.sdf_igr_bwd_bf16.argtypes = [P, P, P, L, I, P, I, I, F, P, P, P, P, P, I, P, I, P, P, P]
    lib.sdf_igr_dw_bf16.argtypes = [P, I, P, L, P, P, I, P, P]
    for fn in (lib.sdf_igr_fwd_f32, lib.sdf_igr_bwd_f32, lib.sdf_igr_fwd_bf16, lib.sdf_igr_bwd_bf16,
               lib.sdf_igr_dw_bf16):
        fn.restype = I
    lib.sdf_igr_cta_points.argtypes = [I, I]
    lib.sdf_igr_error_string.argtypes = [I]
    lib.sdf_igr_error_string.restype = ctypes.c_char_p
    tiles = [lib.sdf_igr_cta_points(bf16, bwd) for bf16 in (0, 1) for bwd in (0, 1)]
    if (tiles != [FWD_TILE_P, BWD_TILE_P, FWD_CTA_P, BWD_CTA_P] or lib.sdf_igr_max_width() != MAX_WIDTH
            or lib.sdf_igr_plan_fields() != PLAN_FIELDS):
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
    kernels. f32: the stash, (hidden layers, 64 rows per block, h_pad) f32.
    bf16: forward the stash of act'(z), flat bf16 over whole CTAs; backward
    the image workspace of ``_workspace_sets``, flat bf16, and the (tiles,
    biases) f32 db partial sums."""
    hidden, dev = len(net.spec) - 1, net.device
    if net.dtype != torch.bfloat16:
        rows = -(-n // (BWD_TILE_P if backward else FWD_TILE_P)) * TILE_ROWS
        return (torch.empty((hidden, rows, net.h_pad), dtype=torch.float32, device=dev),)
    if not backward:
        return (torch.empty(hidden * -(-n // FWD_CTA_P) * FWD_CTA_P * net.h_pad, dtype=torch.bfloat16,
                            device=dev),)
    tiles = -(-n // BWD_CTA_P) * (BWD_CTA_P // TILE_POINTS)
    _, total = _workspace_sets(len(net.spec), net.h_pad)
    return (torch.empty(total * tiles * IMG_BLOCK, dtype=torch.bfloat16, device=dev),
            torch.empty((tiles, net.packed[1].numel()), dtype=torch.float32, device=dev))


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
        with torch.cuda.device(x.device):
            if net.dtype == torch.bfloat16:
                rc = _lib().sdf_igr_fwd_bf16(
                    x.data_ptr(), n, net.d_in, desc.data_ptr(), len(net.spec), net.h_pad, net.beta,
                    wbuf.data_ptr(), bbuf.data_ptr(), net.igr_tiles.data_ptr(), stash.data_ptr(),
                    f.data_ptr(), g.data_ptr(), stream)
            else:
                wt, wt_off = net.transposed
                rc = _lib().sdf_igr_fwd_f32(
                    x.data_ptr(), n, net.d_in, desc.data_ptr(), wt_off.data_ptr(), len(net.spec),
                    net.h_pad, net.beta, wbuf.data_ptr(), wt.data_ptr(), bbuf.data_ptr(),
                    stash.data_ptr(), stash.shape[1], f.data_ptr(), g.data_ptr(), stream)
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
    if net.dtype == torch.bfloat16:
        gw, gb, _ = _bwd_bf16(net, x, a, c)
        return _padded(net, gw, gb)
    wbuf, bbuf, desc, stream = _cuda_args(net, x, a, c)
    n = x.shape[0]
    # the kernel adds into these with atomics
    gw = torch.zeros(wbuf.numel(), dtype=torch.float32, device=x.device)
    gb = torch.zeros(bbuf.numel(), dtype=torch.float32, device=x.device)
    if n:
        (stash,) = work = _workspace(net, n, True)
        _record_workspace("igr_bwd", work)
        wt, wt_off = net.transposed
        with torch.cuda.device(x.device):
            rc = _lib().sdf_igr_bwd_f32(
                x.data_ptr(), a.data_ptr(), c.data_ptr(), n, net.d_in, desc.data_ptr(),
                wt_off.data_ptr(), len(net.spec), net.h_pad, net.beta, wbuf.data_ptr(),
                wt.data_ptr(), bbuf.data_ptr(), stash.data_ptr(), stash.shape[1], gw.data_ptr(),
                gb.data_ptr(), stream)
        _check_launch(rc, "igr_bwd")
        LAUNCHES["igr_bwd"] += 1
    return _padded(net, gw, gb)


def _bwd_bf16(net: FusedNet, x: torch.Tensor, a: torch.Tensor, c: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor, Tuple[torch.Tensor, ...]]:
    """The bf16 backward on a card, ``igr_bwd`` then its dW pass from one C
    call -> (packed f32 weight gradients, f32 bias gradients, the workspace
    the first pass wrote: what ``images_plain`` computes; () at N = 0)."""
    wbuf, bbuf, desc, stream = _cuda_args(net, x, a, c)
    n = x.shape[0]
    if not n:  # an empty shard of a mesh: nothing to launch, nothing to add
        return (torch.zeros(wbuf.numel(), dtype=torch.float32, device=x.device),
                torch.zeros(bbuf.numel(), dtype=torch.float32, device=x.device), ())
    # the dW pass writes every element of both
    gw = torch.empty(wbuf.numel(), dtype=torch.float32, device=x.device)
    gb = torch.empty(bbuf.numel(), dtype=torch.float32, device=x.device)
    ws, partial = work = _workspace(net, n, True)
    _record_workspace("igr_bwd", work)
    plan = _plan_on(dw_plan(net), x.device)
    with torch.cuda.device(x.device):
        rc = _lib().sdf_igr_bwd_bf16(
            x.data_ptr(), a.data_ptr(), c.data_ptr(), n, net.d_in, desc.data_ptr(),
            len(net.spec), net.h_pad, net.beta, wbuf.data_ptr(), bbuf.data_ptr(),
            net.igr_tiles.data_ptr(), ws.data_ptr(), partial.data_ptr(), bbuf.numel(),
            plan.data_ptr(), plan.shape[0], gw.data_ptr(), gb.data_ptr(), stream)
    _check_launch(rc, "igr_bwd")
    LAUNCHES["igr_bwd"] += 1
    return gw, gb, work


def dw_pass(net: FusedNet, ws: torch.Tensor, partial: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The bf16 backward's dW pass alone, on a workspace of its first pass
    (or of ``images_plain``): (packed f32 weight gradients, bias gradients),
    as ``dw_pass_plain`` computes them. For checks and timings: no wrapper
    calls it, and ``LAUNCHES`` does not count it."""
    if ws.device.type == "cpu":
        return dw_pass_plain(net, ws, partial)
    wbuf, bbuf, _, stream = _cuda_args(net, partial)
    _, total = _workspace_sets(len(net.spec), net.h_pad)
    if (ws.device != net.device or ws.dtype != torch.bfloat16 or not ws.is_contiguous()
            or partial.shape[1] != bbuf.numel() or ws.numel() != total * partial.shape[0] * IMG_BLOCK):
        raise ValueError("not a bf16 backward workspace of this net")
    gw = torch.empty(wbuf.numel(), dtype=torch.float32, device=ws.device)
    gb = torch.empty(bbuf.numel(), dtype=torch.float32, device=ws.device)
    plan = _plan_on(dw_plan(net), ws.device)
    with torch.cuda.device(ws.device):
        rc = _lib().sdf_igr_dw_bf16(plan.data_ptr(), plan.shape[0], ws.data_ptr(), partial.shape[0],
                                    gw.data_ptr(), partial.data_ptr(), bbuf.numel(), gb.data_ptr(), stream)
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
    are packed once per call, not once per shard."""
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
