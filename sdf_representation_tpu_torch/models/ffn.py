"""FeedForwardNetwork — weight-normalised MLP with dropout and a tanh output.

Counterpart of sdf_representation_tpu/models/ffn.py (reference
model/networks.py:186-210): N blocks of [weight-normalised linear -> ReLU ->
dropout] and a weight-normalised output linear + tanh.

The weight norm is explicit, as in the JAX package: per layer ``v`` (in,
out), ``g`` (out,) and ``b`` (out,), and w = g * v / ||v|| with the norm of
each output unit's column taken over the input axis (not
``torch.nn.utils`` weight norm). Under the trainer's bfloat16 step the norm
is taken of the bfloat16 ``v``, as in JAX. Init: v uniform in
+-1/sqrt(fan_in), g = ||v||, b uniform in the same bound, drawn from a
``torch.Generator``.

Dropout runs only when ``train`` is set and a ``generator`` is given (the
JAX ``train`` and ``rng``): the trainer's step passes one seeded from its
own (``training.trainer.bind_apply``), while validation, the audit and
reconstruction call the plain forward. The masks come from that generator,
not from ``jax.random``'s stream: only their distribution (keep with
probability 1 - p, kept values scaled by 1/(1 - p)) is the JAX package's.
"""

from __future__ import annotations

import math

import torch
from torch import nn


class WeightNormLinear(nn.Module):
    def __init__(self, fan_in: int, fan_out: int, generator: torch.Generator, device=None):
        super().__init__()
        bound = 1.0 / math.sqrt(fan_in)
        v = (torch.rand(fan_in, fan_out, generator=generator) * 2 - 1) * bound
        b = (torch.rand(fan_out, generator=generator) * 2 - 1) * bound
        self.v = nn.Parameter(v.to(device))
        self.g = nn.Parameter(torch.linalg.vector_norm(v, dim=0).to(device))
        self.b = nn.Parameter(b.to(device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        norm = torch.linalg.vector_norm(self.v, dim=0, keepdim=True)
        return x @ (self.g * self.v / norm) + self.b


class FeedForwardNetwork(nn.Module):
    def __init__(self, d_in: int = 3, hidden_dim: int = 512, num_layers: int = 8,
                 dropout_rate: float = 0.5, generator: torch.Generator | None = None,
                 device: torch.device | str | None = None):
        super().__init__()
        self.d_in = int(d_in)
        self.hidden_dim = int(hidden_dim)
        self.num_layers = int(num_layers)
        self.dropout_rate = float(dropout_rate)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        fans = [self.d_in] + [self.hidden_dim] * self.num_layers
        self.layers = nn.ModuleList(
            WeightNormLinear(fan_in, fan_out, generator, device)
            for fan_in, fan_out in zip(fans, fans[1:]))
        self.out = WeightNormLinear(fans[-1], 1, generator, device)

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None,
                train: bool = False) -> torch.Tensor:
        """x: (..., d_in) -> (...,). Dropout only when ``train`` and a
        ``generator`` are given."""
        p = self.dropout_rate
        h = x
        for layer in self.layers:
            h = torch.relu(layer(h))
            if train and generator is not None and p > 0.0:
                keep = torch.rand(h.shape, generator=generator, device=h.device) < 1.0 - p
                h = torch.where(keep, h / torch.full((), 1.0 - p, dtype=h.dtype, device=h.device), 0.0)
        return torch.tanh(self.out(h))[..., 0]
