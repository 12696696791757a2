"""Spatial differential operators on implicit fields — counterpart of
sdf_representation_tpu/ops/diffops.py (reference model/losses.py:283-339).

Every function takes ``model``, any callable mapping (B, d) points to (B,)
values (the module, or a closure over it), and a batch ``x``.

  * per-point gradients and Hessians compose ``torch.func`` transforms
    (``vmap(grad)``, ``vmap(hessian)``) as the JAX package composes
    ``jax.vmap``/``jax.grad``. They need no autograd graph on ``x``, run
    under ``torch.no_grad()`` (``torch.func`` transforms ignore an outer
    ``no_grad``), and stay differentiable w.r.t. the parameters the callable
    closes over, so a loss built on them trains with ``backward()``.
  * ``implicitnet_value_and_grad`` is the hand-derived forward-mode (f, grad f)
    through shared matrix products. It is also the plain counterpart of the
    fused kernel in ops/fused_igr.py: the trainer installs one or the other
    as the ``_implicitnet_fast`` hook that ``sdf_and_gradient_fwd`` consumes.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Tuple

import torch

from ..models.implicit_net import softplus_beta

Apply = Callable[[torch.Tensor], torch.Tensor]


def _single(model: Apply):
    def f_single(pt: torch.Tensor) -> torch.Tensor:
        return model(pt[None, :])[0]

    return f_single


def compute_gradient(model: Apply, x: torch.Tensor) -> torch.Tensor:
    """grad_x f for a batch. x: (B, d) -> (B, d). Reverse mode per point."""
    return torch.func.vmap(torch.func.grad(_single(model)))(x)


def compute_normal(model: Apply, x: torch.Tensor) -> torch.Tensor:
    """The last three components of the input gradient (the surface normal
    direction; reference losses.py:283-296 slices [:, -3:])."""
    return compute_gradient(model, x)[:, -3:]


def sdf_and_gradient(model: Apply, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(f(x), grad_x f(x)) in one pass. x: (B, d) -> ((B,), (B, d))."""
    f_single = _single(model)

    def value_and_grad(pt):
        grad, value = torch.func.grad(lambda p: (f_single(p),) * 2, has_aux=True)(pt)
        return value, grad

    return torch.func.vmap(value_and_grad)(x)


def sdf_and_gradient_fwd(model: Apply, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(f, grad_x f) inside training losses.

    When the callable advertises an ImplicitNet fast path
    (``_implicitnet_fast``, set by the trainer's ``bind_apply``) that is used:
    the shared-matmul derivation, or the fused kernels. Otherwise d forward-
    mode passes (d = x.shape[-1]), one per coordinate."""
    fast = getattr(model, "_implicitnet_fast", None)
    if fast is not None:
        return fast(x)
    vals = model(x)
    cols = []
    for i in range(x.shape[-1]):
        tangent = torch.zeros_like(x)
        tangent[:, i] = 1.0
        cols.append(torch.func.jvp(model, (x,), (tangent,))[1])
    return vals, torch.stack(cols, dim=-1)


def compute_hessian(model: Apply, x: torch.Tensor) -> torch.Tensor:
    """Per-point Hessian. x: (B, d) -> (B, d, d). Forward over reverse."""
    return torch.func.vmap(torch.func.hessian(_single(model)))(x)


def compute_gaussian_curvature(model: Apply, x: torch.Tensor) -> torch.Tensor:
    """det(H) / (1 + |grad f|^2)^2 (cf. reference losses.py:333-339)."""
    grad = compute_gradient(model, x)
    hess = compute_hessian(model, x)
    gn2 = torch.sum(grad * grad, dim=-1)
    return torch.linalg.det(hess) / (1.0 + gn2) ** 2


def implicitnet_value_and_grad(
    model, x: torch.Tensor,
    layers: Optional[Sequence[Tuple[torch.Tensor, torch.Tensor]]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Hand-derived forward-mode (value, input gradient) of an ImplicitNet.

    All d_in tangent directions ride through the same matrix products as
    the primal — a (B, d_in, width) tensor against each layer's weights —
    scaled by act'(z). It builds no graph on ``x`` (so it runs under
    ``no_grad``) and autograd differentiates it w.r.t. the parameters.
    ``layers``: per layer (weight (out, in), bias) to use instead of the
    module's (copies in another type). Returns (values (B,), grads (B, d_in)).
    """
    if layers is None:
        layers = model.effective_layers()
    inp = x
    d_in = model.d_in
    h = x
    # tangent stack: T[b, k, :] = d h / d x_k
    T0 = torch.eye(d_in, dtype=x.dtype, device=x.device).expand(x.shape[0], d_in, d_in)
    T = T0
    n_lin = len(layers)
    inv_sqrt2 = 1.0 / math.sqrt(2.0)
    for layer, (w, b) in enumerate(layers):
        if layer in model.skip_in:
            h = torch.cat([h, inp], dim=-1) * inv_sqrt2
            T = torch.cat([T, T0], dim=-1) * inv_sqrt2
        z = h @ w.T + b
        Tz = T @ w.T
        if layer < n_lin - 1:
            if model.beta > 0:
                act_p = torch.sigmoid(model.beta * z)
                h = softplus_beta(z, model.beta)
            else:
                act_p = (z > 0).to(z.dtype)
                h = torch.clamp_min(z, 0.0)
            T = Tz * act_p[:, None, :]
        else:
            if model.beta <= 0:
                t = torch.tanh(z)
                T = Tz * (1.0 - t * t)[:, None, :]
                z = t
            else:
                T = Tz
            h = z
    return h[..., 0], T[..., 0]
