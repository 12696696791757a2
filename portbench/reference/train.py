"""Plain training of a model family, for the benchmark's comparison.

The network is the family's: a training configuration's ``"reference"`` key
names its module, ``reference/<name>.py`` (``harness/spec.family_module``),
which gives the sizes, the initial parameters and the forward in each mode.
What does not depend on the family is here: the losses (the weighted smooth
L2 of the clamped distance, IGR's loss with its normal and eikonal terms,
and the point-cloud loss mean |f| + lambda mean (|grad f| - 1)^2), Adam
(beta 0.9 / 0.999, eps 1e-8) as Kingma and Ba state it, and the modes.
Gradients by autograd, the eikonal ones by double backward. The losses,
``fit`` and ``validation_loss`` take the family's ``forward(params, x, net,
mode) -> (N,)``.

``mode``, the arithmetic of every matrix product:
  "f32"   float32 with TF32 off: the reference.
  "tf32"  float32 operands through TF32 tensor cores: the control of a
          float32 configuration.
  "fp8"   the control of a bfloat16 configuration, that mode one step down:
          the weights and the activations that enter each product rounded to
          float8 e4m3 (a scale per tensor), and each product rounded so
          before its bias is added; the gradients that flow back through
          them rounded alike (``quantizer``, which the family's forward
          applies). The loss is taken in float32.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional, Sequence

import torch

BETAS, EPS = (0.9, 0.999), 1e-8
MODES = ("f32", "tf32", "fp8")

Forward = Callable[..., torch.Tensor]


def _round_fp8(x: torch.Tensor) -> torch.Tensor:
    scale = (x.detach().abs().amax() / 448.0).clamp_min(1e-30)
    return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale


class _Fp8(torch.autograd.Function):
    """Rounds the value forward and the gradient backward (twice differentiable)."""

    @staticmethod
    def forward(ctx, x):
        return _round_fp8(x)

    @staticmethod
    def backward(ctx, g):
        return _Fp8.apply(g)


def quantizer(mode: str) -> Callable[[torch.Tensor], torch.Tensor]:
    """What a family's forward applies to each operand and product of a
    matrix product: the float8 rounding in "fp8", nothing otherwise."""
    return _Fp8.apply if mode == "fp8" else (lambda t: t)


class arithmetic:
    """TF32 on for "tf32", off otherwise, within the block; restored on exit."""

    def __init__(self, mode: str):
        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
        self.mode = mode

    def __enter__(self):
        self.keep = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = self.mode == "tf32"

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32 = self.keep


def value_and_grad_x(forward: Forward, params, x, net: Dict, mode: str):
    x = x.detach().requires_grad_(True)
    f = forward(params, x, net, mode)
    (g,) = torch.autograd.grad(f.sum(), x, create_graph=True)
    return f, g


def loss(kind: str, forward: Forward, params, batch: Dict[str, torch.Tensor], net: Dict,
         loss_cfg: Dict, mode: str) -> torch.Tensor:
    x = batch["x"]
    if kind == "WeightedSmoothL2Loss":
        d = loss_cfg.get("delta", 0.1)
        true = batch["y"][:, 0].clamp(-d, d)
        pred = forward(params, x, net, mode).clamp(-d, d)
        weight = 1.0 + loss_cfg.get("weight_factor", 0.5) * torch.exp(-true.abs())
        return torch.mean(weight * (true - pred) ** 2)
    if kind == "IGRLOSS":
        d = loss_cfg.get("delta", 0.1)
        f, g = value_and_grad_x(forward, params, x, net, mode)
        true = batch["y"][:, 0].clamp(-d, d)
        sdf = (f.clamp(-d, d) - true) ** 2
        gn = g.norm(dim=-1)
        target = batch["y"][:, 1:4]
        cos = ((g / (gn[:, None] + 1e-12)) * (target / (target.norm(dim=-1, keepdim=True) + 1e-12))).sum(-1)
        near = true.abs() < loss_cfg.get("regularizer_threshold", 1.0)
        reg = torch.where(near, (1.0 - cos) ** 2, torch.full_like(cos, 1e-8))
        eik = torch.where(near, (gn - 1.0) ** 2, torch.full_like(gn, 1e-8))
        return sdf.mean() + loss_cfg.get("tau", 1.0) * reg.mean() + loss_cfg.get("lambda_g", 0.1) * eik.mean()
    if kind == "IGRLOSSPCD":
        surface = forward(params, x, net, mode).abs().mean()
        _, g = value_and_grad_x(forward, params, x[batch["idx"]] + batch["noise"], net, mode)
        return surface + loss_cfg.get("lambda_g", 0.1) * ((g.norm(dim=-1) - 1.0) ** 2).mean()
    raise ValueError(f"no reference for the loss {kind}")


def validation_loss(kind: str, forward: Forward, params, batches: Iterable[Dict], net: Dict,
                    loss_cfg: Dict, mode: str = "f32") -> float:
    """The mean over the batches of each batch's loss, the parameters held."""
    fixed = [p.detach() for p in params]
    with arithmetic(mode):
        values = [float(loss(kind, forward, fixed, b, net, loss_cfg, mode).detach()) for b in batches]
    return sum(values) / len(values)


def fit(kind: str, forward: Forward, params0: Sequence[torch.Tensor], epochs: Sequence[Iterable[Dict]],
        net: Dict, loss_cfg: Dict, lr: float, mode: str = "f32",
        val: Optional[Sequence[Dict]] = None) -> Dict:
    """Adam from ``params0``, one step per batch, epoch after epoch. Per
    epoch: the mean of its steps' losses, the validation loss after it
    (``val``), the parameters after it. Also the
    first step's gradient."""
    with arithmetic(mode):
        params = [p.detach().clone().requires_grad_(True) for p in params0]
        m = [torch.zeros_like(p) for p in params]
        v = [torch.zeros_like(p) for p in params]
        out = {"epoch_losses": [], "val_losses": [], "params": [], "grad1": None}
        t = 0
        for batches in epochs:
            losses = []
            for batch in batches:
                t += 1
                value = loss(kind, forward, params, batch, net, loss_cfg, mode)
                grads = torch.autograd.grad(value, params)
                if out["grad1"] is None:
                    out["grad1"] = [g.detach().clone() for g in grads]
                with torch.no_grad():
                    for p, g, mi, vi in zip(params, grads, m, v):
                        mi.mul_(BETAS[0]).add_(g, alpha=1 - BETAS[0])
                        vi.mul_(BETAS[1]).addcmul_(g, g, value=1 - BETAS[1])
                        m_hat = mi / (1 - BETAS[0] ** t)
                        v_hat = vi / (1 - BETAS[1] ** t)
                        p.sub_(lr * m_hat / (v_hat.sqrt() + EPS))
                losses.append(float(value.detach()))
            out["epoch_losses"].append(sum(losses) / len(losses))
            out["params"].append([p.detach().clone() for p in params])
            if val is not None:
                out["val_losses"].append(validation_loss(kind, forward, params, val, net, loss_cfg, mode))
        return out
