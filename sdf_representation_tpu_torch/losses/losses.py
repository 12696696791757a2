"""The supervised SDF losses — counterpart of
sdf_representation_tpu/losses/losses.py (reference model/losses.py).

Calling convention (all losses):

    loss(model, x_batch, y_batch, epoch) -> scalar tensor

where ``model`` is any callable mapping (B, d) points to (B,) predictions
(the module itself, or a mixed-precision closure over it), y_batch[:, 0] is
the target signed distance and y_batch[:, 1:4] the target normal.

Kept from the JAX package: predictions are (B,) — the reference's (B, 1) vs
(B,) tensors silently broadcast to (B, B) inside several losses.

The eikonal family (IGRLOSS, IGRLOSSPCD, RegularizedCustomSDFLoss,
GaussBonnetLoss) needs the field's input gradient and its fused kernels;
those are the next slice of the port and raise NotImplementedError here.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch


def _sdf(model, x: torch.Tensor) -> torch.Tensor:
    return model(x).reshape(x.shape[0])


@dataclasses.dataclass(frozen=True)
class MSELoss:
    """Plain mean squared error (cf. reference losses.py:19-31)."""

    def __call__(self, model, x_batch, y_batch, epoch):
        return torch.mean((y_batch[:, 0] - _sdf(model, x_batch)) ** 2)


@dataclasses.dataclass(frozen=True)
class CustomSDFLoss:
    """DeepSDF clamp loss: MSE of clamped prediction vs clamped target
    (cf. reference losses.py:33-48)."""

    delta: float = 0.1

    def __call__(self, model, x_batch, y_batch, epoch):
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

    def __call__(self, model, x_batch, y_batch, epoch):
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

    def __call__(self, model, x_batch, y_batch, epoch):
        d = self.delta
        y_true = torch.clamp(y_batch[:, 0], -d, d)
        y_pred = torch.clamp(_sdf(model, x_batch), -d, d)
        err = y_true - y_pred
        abs_err = torch.abs(err) + 1e-8
        l1 = torch.mean(torch.abs(err))
        weight = 1.0 + self.weight_factor * torch.exp(-torch.abs(y_true) / d)
        l2 = torch.mean(weight * abs_err * abs_err)
        return self.alpha * l1 + (1.0 - self.alpha) * l2


LOSS_REGISTRY: Dict[str, type] = {
    "MSELoss": MSELoss,
    "CustomSDFLoss": CustomSDFLoss,
    "WeightedSmoothL2Loss": WeightedSmoothL2Loss,
    "CombinedLoss": CombinedLoss,
}

_NOT_PORTED = ("IGRLOSS", "IGRLOSSPCD", "RegularizedCustomSDFLoss", "GaussBonnetLoss")


def get_loss_class(name: str):
    if name in LOSS_REGISTRY:
        return LOSS_REGISTRY[name]
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"loss '{name}' needs the field's input gradient: the eikonal (IGR) losses "
            "are slice 3 of the port, see ROADMAP.md"
        )
    raise ValueError(
        f"Unsupported loss function: {name}. Available: {sorted(LOSS_REGISTRY)}"
    )


def register_loss(name: str, cls) -> None:
    LOSS_REGISTRY[name] = cls
