"""ImplicitNet — the skip-in fully-connected SDF network, as a torch module.

Counterpart of sdf_representation_tpu/models/implicit_net.py (reference
model/networks.py:8-112 `ImplicitNet`, :114-179 `ImplicitNetCompatible`).
Semantics kept from the JAX package:

  * dims = [d_in] + hidden*N + [1]; layers feeding a skip layer shrink their
    output by d_in.
  * Skip layer input: concat([h, input], -1) / sqrt(2).
  * Activation: Softplus(beta)/beta computed as JAX does,
    (max(beta*x, 0) + log1p(exp(-|beta*x|))) / beta, with no linear
    threshold; ReLU when beta <= 0, with tanh on the output.
  * Geometric init: last layer weight ~ sqrt(pi)/sqrt(fan_in) + N(0, 1e-5),
    bias = -radius_init; other layers bias 0, weight ~ N(0, sqrt(2)/sqrt(fan_out)).
    Otherwise torch.nn.Linear's default U(-1/sqrt(fan_in), 1/sqrt(fan_in)).
    Both draw from an explicit ``torch.Generator``; the numbers differ from
    ``jax.random`` for the same seed.
  * The forward returns (B,), never (B, 1).

Parameters are ``lin{i}.weight`` (out, in) and ``lin{i}.bias`` — the
reference's state_dict layout, which the JAX package's
export/torch_import.import_torch_state_dict reads — plus ``lip{i}`` (the
Lipschitz bound c of layer i) for the Lipschitz variant.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch
from torch import nn


def softplus(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.softplus: max(x, 0) + log1p(exp(-|x|)), no threshold."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def softplus_beta(x: torch.Tensor, beta: float) -> torch.Tensor:
    return softplus(beta * x) / beta


class ImplicitNet(nn.Module):
    """Skip-in MLP mapping (B, d_in) points -> (B,) signed distance."""

    def __init__(
        self,
        d_in: int = 3,
        hidden_dims: Sequence[int] = (512,) * 8,
        skip_in: Sequence[int] = (),
        beta: float = 100.0,
        geometric_init: bool = True,
        radius_init: float = 1.0,
        lipschitz: bool = False,
        lipschitz_weight: float = 1e-6,
        generator: torch.Generator | None = None,
        device: torch.device | str | None = None,
    ):
        super().__init__()
        self.d_in = int(d_in)
        self.hidden_dims = tuple(int(h) for h in hidden_dims)
        self.skip_in = tuple(int(s) for s in skip_in)
        self.beta = float(beta)
        self.geometric_init = bool(geometric_init)
        self.radius_init = float(radius_init)
        self.lipschitz = bool(lipschitz)
        self.lipschitz_weight = float(lipschitz_weight)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        shapes = self.layer_shapes()
        for layer, (fan_in, fan_out) in enumerate(shapes):
            w, b = self._init_layer(layer, fan_in, fan_out, generator)
            lin = nn.Linear(fan_in, fan_out, device="meta")
            lin.weight = nn.Parameter(w.to(device))
            lin.bias = nn.Parameter(b.to(device))
            setattr(self, f"lin{layer}", lin)
            if self.lipschitz:
                # c starts at softplus^-1(max row sum of |W|), so the initial
                # scaling is exactly 1 (arXiv:2202.08345 §4)
                row_max = w.abs().sum(dim=1).max()
                c = row_max + torch.log(-torch.expm1(-row_max))
                self.register_parameter(f"lip{layer}", nn.Parameter(c.to(device)))

    @property
    def dims(self) -> Tuple[int, ...]:
        return (self.d_in,) + self.hidden_dims + (1,)

    @property
    def num_layers(self) -> int:
        return len(self.dims)

    @property
    def arch(self) -> tuple:
        """Everything that fixes the function's shape (not its weights)."""
        return (type(self).__name__, self.d_in, self.hidden_dims, self.skip_in,
                self.beta, self.lipschitz)

    def layer_shapes(self) -> List[Tuple[int, int]]:
        """(fan_in, fan_out) of every linear layer, accounting for skip-ins."""
        dims = self.dims
        shapes = []
        for layer in range(self.num_layers - 1):
            out_dim = dims[layer + 1]
            if (layer + 1) in self.skip_in:
                out_dim -= self.d_in
            shapes.append((dims[layer], out_dim))
        return shapes

    def _init_layer(self, layer, fan_in, fan_out, gen):
        last = layer == self.num_layers - 2
        if self.geometric_init:
            if last:
                w = math.sqrt(math.pi) / math.sqrt(fan_in) + 1e-5 * torch.randn(
                    fan_out, fan_in, generator=gen)
                b = torch.full((fan_out,), -self.radius_init)
            else:
                w = math.sqrt(2.0) / math.sqrt(fan_out) * torch.randn(
                    fan_out, fan_in, generator=gen)
                b = torch.zeros(fan_out)
        else:
            bound = 1.0 / math.sqrt(fan_in)
            w = (torch.rand(fan_out, fan_in, generator=gen) * 2 - 1) * bound
            b = (torch.rand(fan_out, generator=gen) * 2 - 1) * bound
        return w.float(), b.float()

    def effective_layers(self) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """Per-layer (weight (out, in), bias) with the Lipschitz row
        normalisation baked in (the plain weights otherwise). The forward,
        the fused kernels and exports all read the weights through here."""
        out = []
        for layer in range(self.num_layers - 1):
            lin = getattr(self, f"lin{layer}")
            w = lin.weight
            if self.lipschitz:
                rows = w.abs().sum(dim=1)
                bound = softplus(getattr(self, f"lip{layer}").to(w.dtype))
                scale = torch.clamp_max(bound / torch.clamp_min(rows, 1e-30), 1.0)
                w = w * scale[:, None]
            out.append((w, lin.bias))
        return out

    def export_params(self) -> Dict[str, torch.Tensor]:
        """``lin{i}.weight``/``lin{i}.bias`` with any reparameterisation (the
        Lipschitz row scaling) baked in — what exporters must see."""
        sd = {}
        for layer, (w, b) in enumerate(self.effective_layers()):
            sd[f"lin{layer}.weight"] = w.detach().clone()
            sd[f"lin{layer}.bias"] = b.detach().clone()
        return sd

    def lipschitz_bound(self) -> torch.Tensor:
        """prod_i softplus(c_i): the trainable bound on the net's Lipschitz
        constant (arXiv:2202.08345)."""
        cs = torch.stack([getattr(self, f"lip{i}") for i in range(self.num_layers - 1)])
        return torch.prod(softplus(cs.float()))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (..., d_in) -> (...,) SDF."""
        inp = x
        h = x
        layers = self.effective_layers()
        n_lin = len(layers)
        for layer, (w, b) in enumerate(layers):
            if layer in self.skip_in:
                h = torch.cat([h, inp], dim=-1) / math.sqrt(2.0)
            h = h @ w.T + b
            if layer < n_lin - 1:
                h = softplus_beta(h, self.beta) if self.beta > 0 else torch.relu(h)
            elif self.beta <= 0:
                h = torch.tanh(h)
        return h[..., 0]


def ImplicitNetCompatible(
    d_in: int = 3,
    hidden_dims: Sequence[int] = (512,) * 8,
    skip_in: Sequence[int] = (),
    beta: float = 99.0,
    geometric_init: bool = True,
    radius_init: float = 1.0,
    generator: torch.Generator | None = None,
    device: torch.device | str | None = None,
) -> ImplicitNet:
    """The reference's second copy of the architecture (networks.py:114-179)
    with its default beta = 99; the parameter layout is the same."""
    return ImplicitNet(
        d_in=d_in, hidden_dims=hidden_dims, skip_in=skip_in, beta=beta,
        geometric_init=geometric_init, radius_init=radius_init,
        generator=generator, device=device,
    )
