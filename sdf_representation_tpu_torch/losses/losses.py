"""The SDF loss zoo — counterpart of
sdf_representation_tpu/losses/losses.py (reference model/losses.py).

Calling convention (all losses):

    loss(model, x_batch, y_batch, epoch, generator=None, aux=None) -> scalar tensor

where ``model`` is any callable mapping (B, d) points to (B,) predictions
(the module itself, or the trainer's closure over it), y_batch[:, 0] is
the target signed distance and y_batch[:, 1:4] the target normal. ``aux``
carries extra *learnable* scalars (GaussBonnetLoss's Euler characteristic);
``generator`` feeds losses that draw sample points (IGRLOSSPCD), as the JAX
losses take ``aux`` and ``rng``.

The eikonal family (IGRLOSS, IGRLOSSPCD, RegularizedCustomSDFLoss,
GaussBonnetLoss) reads (f, grad_x f) through
``ops.diffops.sdf_and_gradient_fwd``: the callable's ``_implicitnet_fast``
hook where the trainer set one (the fused kernels of ops/fused_igr.py, or the
shared-matmul derivation), else one forward-mode pass per coordinate.

Kept from the JAX package: predictions are (B,) — the reference's (B, 1) vs
(B,) tensors silently broadcast to (B, B) inside several losses; IGRLOSS
normalises the predicted normal per row (``global_norm_quirk`` restores the
reference's division by the whole batch's norm); RegularizedCustomSDFLoss is
the working form of the reference's broken one; GaussBonnetLoss takes its
Euler characteristic through ``aux``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict

import torch

from ..ops.diffops import compute_gaussian_curvature, sdf_and_gradient_fwd


def _sdf(model, x: torch.Tensor) -> torch.Tensor:
    return model(x).reshape(x.shape[0])


@dataclasses.dataclass(frozen=True)
class MSELoss:
    """Plain mean squared error (cf. reference losses.py:19-31)."""

    def __call__(self, model, x_batch, y_batch, epoch, generator=None, aux=None):
        return torch.mean((y_batch[:, 0] - _sdf(model, x_batch)) ** 2)


@dataclasses.dataclass(frozen=True)
class CustomSDFLoss:
    """DeepSDF clamp loss: MSE of clamped prediction vs clamped target
    (cf. reference losses.py:33-48)."""

    delta: float = 0.1

    def __call__(self, model, x_batch, y_batch, epoch, generator=None, aux=None):
        d = self.delta
        pred = torch.clamp(_sdf(model, x_batch), -d, d)
        true = torch.clamp(y_batch[:, 0], -d, d)
        return torch.mean((pred - true) ** 2)


@dataclasses.dataclass(frozen=True)
class WeightedSmoothL2Loss:
    """Near-surface-weighted clamped L2 — the default loss in shipped configs
    (cf. reference losses.py:50-69).

    weight = 1 + weight_factor * exp(-|y_true|)."""

    weight_factor: float = 0.5
    delta: float = 0.1

    def __call__(self, model, x_batch, y_batch, epoch, generator=None, aux=None):
        d = self.delta
        y_true = torch.clamp(y_batch[:, 0], -d, d)
        y_pred = torch.clamp(_sdf(model, x_batch), -d, d)
        err = y_true - y_pred
        weight = 1.0 + self.weight_factor * torch.exp(-torch.abs(y_true))
        return torch.mean(weight * err * err)


@dataclasses.dataclass(frozen=True)
class CombinedLoss:
    """alpha * L1 + (1 - alpha) * weighted-L2 of clamped values
    (cf. reference losses.py:71-94)."""

    weight_factor: float = 0.5
    delta: float = 0.1
    alpha: float = 0.8

    def __call__(self, model, x_batch, y_batch, epoch, generator=None, aux=None):
        d = self.delta
        y_true = torch.clamp(y_batch[:, 0], -d, d)
        y_pred = torch.clamp(_sdf(model, x_batch), -d, d)
        err = y_true - y_pred
        abs_err = torch.abs(err) + 1e-8
        l1 = torch.mean(torch.abs(err))
        weight = 1.0 + self.weight_factor * torch.exp(-torch.abs(y_true) / d)
        l2 = torch.mean(weight * abs_err * abs_err)
        return self.alpha * l1 + (1.0 - self.alpha) * l2


def _unit(v: torch.Tensor) -> torch.Tensor:
    return v / (torch.linalg.norm(v, dim=-1, keepdim=True) + 1e-12)


@dataclasses.dataclass(frozen=True)
class IGRLOSS:
    """Clamped SDF MSE + normal-consistency + eikonal regularisers
    (cf. reference losses.py:96-137).

    Both regularisers only fire where |clamped target| < regularizer_threshold;
    elsewhere they contribute the reference's 1e-8 floor.
    """

    delta: float = 0.1
    tau: float = 1.0
    lambda_g: float = 0.1
    regularizer_threshold: float = 1.0
    # 1.0 reproduces the reference's batch-GLOBAL normal normalisation
    # (losses.py:129); 0.0 (default) normalises per row, which is what cosine
    # similarity requires
    global_norm_quirk: float = 0.0

    def __call__(self, model, x_batch, y_batch, epoch, generator=None, aux=None):
        d = self.delta
        pred_raw, grad = sdf_and_gradient_fwd(model, x_batch)
        normal = grad[:, -3:]
        pred = torch.clamp(pred_raw, -d, d)
        true = torch.clamp(y_batch[:, 0], -d, d)
        sdf_loss = (pred - true) ** 2

        grad_norm = torch.linalg.norm(normal, dim=-1)
        if self.global_norm_quirk > 0:
            unit_normal = normal / (torch.linalg.norm(normal) + 1e-12)
        else:
            unit_normal = normal / (grad_norm[:, None] + 1e-12)
        cos = torch.sum(unit_normal * _unit(y_batch[:, 1:4]), dim=-1)
        near = torch.abs(true) < self.regularizer_threshold
        floor = torch.full((), 1e-8, dtype=cos.dtype, device=cos.device)
        reg = torch.where(near, (1.0 - cos) ** 2, floor)
        eik = torch.where(near, (grad_norm - 1.0) ** 2, floor)
        return (
            torch.mean(sdf_loss)
            + self.tau * torch.mean(reg)
            + self.lambda_g * torch.mean(eik)
        )


@dataclasses.dataclass(frozen=True)
class IGRLOSSPCD:
    """Point-cloud IGR loss: f^2 on surface points + eikonal at perturbed
    points (cf. reference losses.py:138-185)."""

    delta: float = 0.1
    tau: float = 1.0
    lambda_g: float = 0.1
    regularizer_threshold: float = 1.0
    local_sigma: float = 0.01
    global_sigma: float = 0.1

    def get_points(self, generator: torch.Generator, pc_input: torch.Tensor) -> torch.Tensor:
        """Local gaussian perturbations + n/8 global uniform samples
        (cf. reference losses.py:173-185), drawn from ``generator`` (on
        ``pc_input``'s device)."""
        n, dim = pc_input.shape
        kw = dict(generator=generator, device=pc_input.device, dtype=pc_input.dtype)
        local = pc_input + self.local_sigma * torch.randn(pc_input.shape, **kw)
        glob = (torch.rand((n // 8, dim), **kw) * 2.0 - 1.0) * self.global_sigma
        return torch.cat([local, glob], dim=0)

    def at_points(self, model, x_batch, sample_pts) -> torch.Tensor:
        """The loss with its eikonal sample points given."""
        mnfld_loss = torch.mean(_sdf(model, x_batch) ** 2)
        _, grad = sdf_and_gradient_fwd(model, sample_pts)
        grad_norm = torch.linalg.norm(grad[:, -3:], dim=-1)
        return mnfld_loss + self.lambda_g * torch.mean((grad_norm - 1.0) ** 2)

    def __call__(self, model, x_batch, y_batch, epoch, generator=None, aux=None):
        if generator is None:
            generator = torch.Generator(device=x_batch.device).manual_seed(0)
        return self.at_points(model, x_batch, self.get_points(generator, x_batch))


@dataclasses.dataclass(frozen=True)
class RegularizedCustomSDFLoss:
    """Clamped MSE + near-surface normal L2 regulariser: the working form of
    the reference's version (losses.py:186-205), which raises NameError."""

    delta: float = 0.1
    threshold: float = 1.0
    regularizer_weight: float = 100.0

    def __call__(self, model, x_batch, y_batch, epoch, generator=None, aux=None):
        d = self.delta
        pred_raw, grad = sdf_and_gradient_fwd(model, x_batch)
        pred = torch.clamp(pred_raw, -d, d)
        true = torch.clamp(y_batch[:, 0], -d, d)
        sdf_loss = (pred - true) ** 2
        near = torch.abs(true) < self.threshold
        sq = torch.sum((y_batch[:, 1:4] - grad[:, -3:]) ** 2, dim=-1)
        reg = torch.where(near, sq, torch.zeros_like(sq))
        return torch.mean(sdf_loss) + self.regularizer_weight * torch.mean(reg)


@dataclasses.dataclass(frozen=True)
class GaussBonnetLoss:
    """Clamped MSE + near-surface (normal + eikonal + Gauss-Bonnet) terms with
    a learnable Euler characteristic (cf. reference losses.py:206-282), which
    arrives via ``aux['euler_characteristic']`` (``needs_aux`` tells the
    trainer to create and train it; 2.0 without ``aux``). The curvature is
    taken on ``model`` itself, never through the fast path."""

    delta: float = 0.1
    tau: float = 1.0
    lambda_g: float = 0.1
    regularizer_threshold: float = 1.0
    gauss_bonnet_weight: float = 0.1

    needs_aux = ("euler_characteristic",)

    def __call__(self, model, x_batch, y_batch, epoch, generator=None, aux=None):
        euler = aux["euler_characteristic"] if aux is not None else 2.0
        d = self.delta
        pred_raw, grad = sdf_and_gradient_fwd(model, x_batch)
        normal = grad[:, -3:]
        pred = torch.clamp(pred_raw, -d, d)
        true = torch.clamp(y_batch[:, 0], -d, d)
        sdf_loss = (pred - true) ** 2

        grad_norm = torch.linalg.norm(normal, dim=-1)
        unit_normal = normal / (grad_norm[:, None] + 1e-12)
        cos = torch.sum(unit_normal * _unit(y_batch[:, 1:4]), dim=-1)
        curvature = compute_gaussian_curvature(model, x_batch)
        near = torch.abs(true) < self.regularizer_threshold
        terms = (
            self.tau * (1.0 - cos) ** 2
            + self.lambda_g * (grad_norm - 1.0) ** 2
            + self.gauss_bonnet_weight * (curvature - 2.0 * math.pi * euler) ** 2
        )
        reg = torch.where(near, terms, torch.full((), 1e-8, dtype=terms.dtype, device=terms.device))
        return torch.mean(sdf_loss) + torch.mean(reg)


LOSS_REGISTRY: Dict[str, type] = {
    "MSELoss": MSELoss,
    "CustomSDFLoss": CustomSDFLoss,
    "WeightedSmoothL2Loss": WeightedSmoothL2Loss,
    "CombinedLoss": CombinedLoss,
    "IGRLOSS": IGRLOSS,
    "IGRLOSSPCD": IGRLOSSPCD,
    "RegularizedCustomSDFLoss": RegularizedCustomSDFLoss,
    "GaussBonnetLoss": GaussBonnetLoss,
}


def get_loss_class(name: str):
    try:
        return LOSS_REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"Unsupported loss function: {name}. Available: {sorted(LOSS_REGISTRY)}"
        ) from None


def register_loss(name: str, cls) -> None:
    LOSS_REGISTRY[name] = cls
