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

``FusedValueAndGrad`` ties them into autograd. The backward is
**params-only**: ``x`` is data and gets no gradient (differentiating this op
w.r.t. ``x`` yields None), as in the JAX package, whose custom VJP returns a
zero cotangent for ``x``.

Each wrapper takes its kernel's plain PyTorch version when the tensors lie
on the CPU, and launches the kernel or raises when they lie on a card: there
is no fallback. ``LAUNCHES`` counts kernel launches.

Working types, as in the JAX kernels: float32 all the way, or bfloat16:
bf16 weights; ``x`` and ``c`` rounded on entry; the stashed act'(z), act(z)
and tangent rounded; every cotangent rounded before a product with W^T or
into dW; f32 accumulators, biases, ``a``, seeds, db and elementwise backward
arithmetic. The backward recovers act' from the stashed activation,
s = 1 - exp(-beta * h), in the kernel and in the plain version alike. The
plain versions hold bf16 values in f32 tensors and multiply in f32, which is
exact for the products; only the summation order differs from the kernels
(and the kernel's dW/db sums use atomics, whose order changes run to run).
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Optional, Sequence, Tuple

import torch

from .. import kernels
from ..models.implicit_net import softplus_beta
from .fused_mlp import INV_SQRT2, MAX_D_IN, MAX_WIDTH, FusedNet, _working

FWD_TILE_P = 64  # points per CUDA block, forward (kRows in csrc/fused_igr.cu)
BWD_TILE_P = 32  # points per CUDA block, backward (kBwdPts): two tile rows each
TILE_ROWS = 64   # workspace rows per block in both kernels

# kernel launches per wrapper; chip_smoke.py zeroes them around the main path
LAUNCHES = {"igr_fwd": 0, "igr_bwd": 0}

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
    return torch.sigmoid(beta * z) if beta > 0 else (z > 0).float()


def _head_layers(net: FusedNet):
    """``net.plain_layers`` with the last layer cut to its one live column."""
    kind, w_h, w_x, b = net.plain_layers[-1]
    if kind != "plain":
        raise ValueError("the last layer must take the hidden activations only")
    return net.plain_layers[:-1] + [(kind, w_h[:, :1], w_x, b[:1])]


def fused_value_and_grad_plain(net: FusedNet, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """What ``igr_fwd`` computes, in PyTorch: (f (N,), grad_x f (N, d_in))."""
    def rnd(t):
        return _working(t, net.dtype)

    beta = net.beta
    layers = _head_layers(net)
    x = rnd(x.float())
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
    return f[:, 0], dx


def fused_param_grads_plain(net: FusedNet, x: torch.Tensor, a: torch.Tensor,
                            c: torch.Tensor) -> PaddedGrads:
    """What ``igr_bwd`` computes, in PyTorch, step by step: the padded
    gradients of sum_b [a_b f_b + c_b . grad_x f(x_b)] w.r.t. every weight
    and bias."""
    def rnd(t):
        return _working(t, net.dtype)

    beta = net.beta
    layers = _head_layers(net)
    n_lin = len(layers)
    x, c, a = rnd(x.float()), rnd(c.float()), a.float()
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
    grads: PaddedGrads = [None] * n_lin  # type: ignore[list-item]
    for layer in range(n_lin - 1, -1, -1):
        kind, w_h, w_x, _ = layers[layer]
        scale = INV_SQRT2 if kind == "skip" else 1.0
        h_prev, tc_prev = (x, c) if layer == 0 else stash[layer - 1]
        dz_c, dtcz_c = rnd(dz), rnd(dtcz)
        g_h = None if w_h is None else (h_prev.T @ dz_c + tc_prev.T @ dtcz_c) * scale
        g_x = None if w_x is None else (x.T @ dz_c + c.T @ dtcz_c) * scale
        grads[layer] = (g_h, g_x, dz.sum(dim=0))
        if layer > 0:
            dh, dtc = (dz_c @ w_h.T) * scale, (dtcz_c @ w_h.T) * scale
            if beta > 0:
                s = 1.0 - torch.exp(-beta * h_prev)  # sigmoid(beta z) from the stashed act(z)
                dz = dh * s + (dtc * tc_prev) * (beta * (1.0 - s))
            else:
                s = (h_prev > 0).float()
                dz = dh * s
            dtcz = dtc * s
    return grads


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------

@functools.cache
def _lib() -> ctypes.CDLL:
    lib = kernels.load("fused_igr")
    P, I, L, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib.sdf_igr_fwd.argtypes = [P, L, I, P, P, I, I, F, I, P, P, P, P, L, P, P, P]
    lib.sdf_igr_bwd.argtypes = [P, P, P, L, I, P, P, I, I, F, I, P, P, P, P, L, P, P, P]
    lib.sdf_igr_fwd.restype = lib.sdf_igr_bwd.restype = I
    lib.sdf_igr_error_string.argtypes = [I]
    lib.sdf_igr_error_string.restype = ctypes.c_char_p
    if (lib.sdf_igr_fwd_points() != FWD_TILE_P or lib.sdf_igr_bwd_points() != BWD_TILE_P
            or lib.sdf_igr_max_width() != MAX_WIDTH):
        raise RuntimeError("csrc/fused_igr.cu and ops/fused_igr.py disagree on the tile shape")
    return lib


def _check_launch(rc: int, what: str) -> None:
    if rc != 0:
        msg = _lib().sdf_igr_error_string(rc).decode()
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc} ({msg})")


def _cuda_args(net: FusedNet, *tensors: torch.Tensor):
    """Validate a launch; returns the arguments both kernels share."""
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
    wt, wt_off = net.transposed
    stream = torch.cuda.current_stream(net.device).cuda_stream
    return wbuf, bbuf, desc, wt, wt_off, stream


def _workspace(net: FusedNet, n: int, tile_p: int) -> torch.Tensor:
    """The per-layer stash of one launch: (hidden layers, 64 rows per block,
    h_pad) f32, written and read back by the kernel."""
    rows = -(-n // tile_p) * TILE_ROWS
    return torch.empty((len(net.spec) - 1, rows, net.h_pad), dtype=torch.float32, device=net.device)


def _check_points(net: FusedNet, x: torch.Tensor) -> None:
    if x.dim() != 2 or x.shape[1] != net.d_in:
        raise ValueError(f"points must be (N, {net.d_in}), got {tuple(x.shape)}")


def fused_value_and_grad(net: FusedNet, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, d_in) f32 points -> (f (N,), grad_x f (N, d_in)), both f32."""
    _check_points(net, x)
    if x.device.type == "cpu":
        return fused_value_and_grad_plain(net, x)
    wbuf, bbuf, desc, wt, wt_off, stream = _cuda_args(net, x)
    n = x.shape[0]
    f = torch.empty(n, dtype=torch.float32, device=x.device)
    g = torch.empty((n, net.d_in), dtype=torch.float32, device=x.device)
    if n:
        stash = _workspace(net, n, FWD_TILE_P)
        with torch.cuda.device(x.device):
            rc = _lib().sdf_igr_fwd(
                x.data_ptr(), n, net.d_in, desc.data_ptr(), wt_off.data_ptr(), len(net.spec),
                net.h_pad, net.beta, int(net.dtype == torch.bfloat16), wbuf.data_ptr(),
                wt.data_ptr(), bbuf.data_ptr(), stash.data_ptr(), stash.shape[1],
                f.data_ptr(), g.data_ptr(), stream)
        _check_launch(rc, "igr_fwd")
        LAUNCHES["igr_fwd"] += 1
    return f, g


def fused_param_grads(net: FusedNet, x: torch.Tensor, a: torch.Tensor,
                      c: torch.Tensor) -> PaddedGrads:
    """Padded gradients of sum_b [a_b f_b + c_b . grad_x f(x_b)] w.r.t. every
    weight and bias, per layer (dW_hidden, dW_coords, db), in f32."""
    _check_points(net, x)
    if a.shape != x.shape[:1] or c.shape != x.shape:
        raise ValueError(f"cotangents must be ({x.shape[0]},) and {tuple(x.shape)}, "
                         f"got {tuple(a.shape)} and {tuple(c.shape)}")
    if x.device.type == "cpu":
        return fused_param_grads_plain(net, x, a, c)
    wbuf, bbuf, desc, wt, wt_off, stream = _cuda_args(net, x, a, c)
    n = x.shape[0]
    # the kernel adds into these with atomics: zeroed per launch
    gw = torch.zeros(wbuf.numel(), dtype=torch.float32, device=x.device)
    gb = torch.zeros(bbuf.numel(), dtype=torch.float32, device=x.device)
    if n:
        stash = _workspace(net, n, BWD_TILE_P)
        with torch.cuda.device(x.device):
            rc = _lib().sdf_igr_bwd(
                x.data_ptr(), a.data_ptr(), c.data_ptr(), n, net.d_in, desc.data_ptr(),
                wt_off.data_ptr(), len(net.spec), net.h_pad, net.beta,
                int(net.dtype == torch.bfloat16), wbuf.data_ptr(), wt.data_ptr(), bbuf.data_ptr(),
                stash.data_ptr(), stash.shape[1], gw.data_ptr(), gb.data_ptr(), stream)
        _check_launch(rc, "igr_bwd")
        LAUNCHES["igr_bwd"] += 1
    grads: PaddedGrads = []
    for k, width, _, b_off, w_off, wx_off in net.layout:
        g_h = None if w_off < 0 else gw[w_off:w_off + k * width].view(k, width)
        g_x = None if wx_off < 0 else gw[wx_off:wx_off + net.d_in * width].view(net.d_in, width)
        grads.append((g_h, g_x, gb[b_off:b_off + width]))
    return grads


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
    """(f, grad_x f) = FusedValueAndGrad.apply(x, model, compute_dtype,
    w_0, b_0, w_1, b_1, ...) with the module's (out, in) weights as flat
    arguments, so each gets its gradient. ``x`` gets none: it is data."""

    @staticmethod
    def forward(ctx, x, model, compute_dtype, *params):
        layers = list(zip(params[0::2], params[1::2]))
        net = FusedNet(model, compute_dtype, layers=layers)
        x = x.detach().float().contiguous()
        ctx.net, ctx.x = net, x
        ctx.meta = [(w.shape, w.dtype) for w, _ in layers]
        return fused_value_and_grad(net, x)

    @staticmethod
    def backward(ctx, a, c):
        padded = fused_param_grads(ctx.net, ctx.x, a.float().contiguous(), c.float().contiguous())
        flat = unpack_grads(ctx.net.d_in, [shape for shape, _ in ctx.meta], padded)
        dtypes = [dtype for _, dtype in ctx.meta for _ in range(2)]
        return (None, None, None, *[g.to(dt) for g, dt in zip(flat, dtypes)])


def make_fused_value_and_grad(model, compute_dtype: torch.dtype = torch.bfloat16):
    """``vag(x, layers=None) -> (f (N,), grad (N, d_in))`` through the fused
    kernels (their plain versions on the CPU), differentiable w.r.t. the
    parameters only. ``layers``: per layer (weight, bias) to use instead of
    the module's own (the mixed-precision step's bf16 copies).

    A drop-in for ``ops.diffops.implicitnet_value_and_grad`` inside training
    losses; the trainer installs it as the ``_implicitnet_fast`` hook."""

    def vag(x: torch.Tensor, layers=None):
        if layers is None:
            layers = model.effective_layers()
        flat = [t for pair in layers for t in pair]
        return FusedValueAndGrad.apply(x, model, compute_dtype, *flat)

    return vag

