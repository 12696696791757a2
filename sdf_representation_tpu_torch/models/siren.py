"""Siren — sinusoidal-activation MLP (Sitzmann et al. 2020), as a torch module.

Counterpart of sdf_representation_tpu/models/siren.py: hidden layers compute
sin(omega_0 * (x @ W + b)), the last layer is linear. Init: first layer W
uniform in +-1/fan_in, the others in +-sqrt(6/fan_in)/omega_0, zero biases,
from a ``torch.Generator``. Parameters ``layers.{i}.w`` (in, out) and
``layers.{i}.b``, the JAX layout.

Types follow JAX's promotion, which torch's differs from: JAX multiplies by
``jnp.float32(omega_0)``, a float32 array, so under the trainer's bfloat16
cast the first pre-activation widens to float32 there, and every later
``f32 @ bf16`` product runs in float32 on the bfloat16 weights. torch would
keep ``0-d float32 * bf16`` in bfloat16, so the forward widens explicitly
where JAX promotes.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from .hash_mlp import Affine


class Siren(nn.Module):
    def __init__(self, d_in: int = 3, hidden_dims: Sequence[int] = (256,) * 5,
                 omega_0: float = 30.0, generator: torch.Generator | None = None,
                 device: torch.device | str | None = None):
        super().__init__()
        self.d_in = int(d_in)
        self.hidden_dims = tuple(int(h) for h in hidden_dims)
        self.omega_0 = float(omega_0)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        dims = [self.d_in, *self.hidden_dims, 1]
        layers = []
        for i, (fan_in, fan_out) in enumerate(zip(dims, dims[1:])):
            bound = 1.0 / fan_in if i == 0 else math.sqrt(6.0 / fan_in) / self.omega_0
            w = (torch.rand(fan_in, fan_out, generator=generator) * 2 - 1) * bound
            layers.append(Affine(w.to(device), torch.zeros(fan_out, device=device)))
        self.layers = nn.ModuleList(layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        last = len(self.layers) - 1
        for i, layer in enumerate(self.layers):
            dt = torch.promote_types(h.dtype, layer.w.dtype)
            z = h.to(dt) @ layer.w.to(dt) + layer.b.to(dt)
            if i == last:
                return z[..., 0]
            h = torch.sin(z.to(torch.promote_types(dt, torch.float32)) * self.omega_0)
