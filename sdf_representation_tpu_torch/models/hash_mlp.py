"""HashMLP — multiresolution hash encoding + small ReLU MLP, as a torch module.

Counterpart of sdf_representation_tpu/models/hash_mlp.py (Instant-NGP, Müller
et al. 2022): L levels of trainable feature tables, dense where the level's
(res+1)^3 corner lattice fits the table and spatially hashed above, are
interpolated trilinearly at each point; a small ReLU MLP decodes the
concatenated features (and, by default, the point itself).

Kept from the JAX package:

  * the level resolutions round(base * growth^l), growth =
    (max / base)^(1 / (L - 1)), and the table size T = 2^log2_table_size;
  * the hash (x * 1) ^ (y * 2654435761) ^ (z * 805459861) in uint32 with
    wraparound, modulo T. The primes exceed int32 and torch's uint32 lacks
    multiply and xor kernels on some backends, so it is computed in int64
    and masked to 32 bits: the same indices bit for bit;
  * the one fused gather of ``encode``: the B*L*8 corner rows come from the
    stacked (L*T, F) tables in one index (its backward, one scatter-add),
    on the CPU and wherever the kernels do not serve; on a card, float32
    tables and points that need no gradient go through the kernel pair of
    ``ops/hash_grid.py`` (``csrc/hash_grid.cu``) instead;
  * init: tables uniform in +-1e-4, MLP weights uniform in +-1/sqrt(fan_in),
    zero biases, drawn from a ``torch.Generator`` (not ``jax.random``'s
    numbers).

The tables are one parameter ``tables`` of shape (L, T, F), float32; the MLP
is ``mlp.{i}.w`` (in, out) and ``mlp.{i}.b``, the JAX layout.
``convert.py`` maps them to and from the JAX tree
``{"tables": [L x (T, F)], "mlp": [{"w", "b"}]}``. Under the trainer's
bfloat16 step the tables are cast with the other float32 leaves, as the JAX
step's ``_cast_bf16`` casts them, so the corner positions and weights are
then bfloat16 arithmetic, as in JAX.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..ops import hash_grid


class Affine(nn.Module):
    """x @ w + b with w stored (in, out), the JAX layout."""

    def __init__(self, w: torch.Tensor, b: torch.Tensor):
        super().__init__()
        self.w = nn.Parameter(w)
        self.b = nn.Parameter(b)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.w + self.b


class HashMLP(nn.Module):
    """(B, d_in) points in [-1, 1]^d -> (B,) SDF."""

    def __init__(self, d_in: int = 3, n_levels: int = 8, n_features: int = 2,
                 log2_table_size: int = 15, base_resolution: int = 8,
                 max_resolution: int = 256, hidden_dim: int = 64, num_layers: int = 2,
                 include_xyz: bool = True, generator: torch.Generator | None = None,
                 device: torch.device | str | None = None):
        super().__init__()
        self.d_in = int(d_in)
        self.n_levels = int(n_levels)
        self.n_features = int(n_features)
        self.log2_table_size = int(log2_table_size)
        self.base_resolution = int(base_resolution)
        self.max_resolution = int(max_resolution)
        self.hidden_dim = int(hidden_dim)
        self.num_layers = int(num_layers)
        self.include_xyz = bool(include_xyz)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        T, L, F = self.table_size, self.n_levels, self.n_features
        tables = (torch.rand(L, T, F, generator=generator) * 2 - 1) * 1e-4
        self.tables = nn.Parameter(tables.to(device))
        feat_dim = L * F + (self.d_in if self.include_xyz else 0)
        dims = [feat_dim] + [self.hidden_dim] * (self.num_layers - 1) + [1]
        layers = []
        for fan_in, fan_out in zip(dims, dims[1:]):
            bound = 1.0 / math.sqrt(fan_in)
            w = (torch.rand(fan_in, fan_out, generator=generator) * 2 - 1) * bound
            layers.append(Affine(w.to(device), torch.zeros(fan_out, device=device)))
        self.mlp = nn.ModuleList(layers)

    @property
    def growth(self) -> float:
        if self.n_levels == 1:
            return 1.0
        return math.exp((math.log(self.max_resolution) - math.log(self.base_resolution))
                        / (self.n_levels - 1))

    def level_resolution(self, level: int) -> int:
        return int(round(self.base_resolution * self.growth ** level))

    @property
    def table_size(self) -> int:
        return 1 << self.log2_table_size

    def is_dense(self, level: int) -> bool:
        """Whether the level's (res+1)^3 corner lattice fits its table
        (indexed directly) rather than being hashed."""
        return (self.level_resolution(level) + 1) ** 3 <= self.table_size

    @property
    def resolutions(self):
        return tuple(self.level_resolution(level) for level in range(self.n_levels))

    def corner_indices(self, x: torch.Tensor):
        """(idx (B, L, 8) int64 rows of the stacked (L*T, F) tables, weights
        (B, L, 8) in x's dtype) of every point's 8 corners at every level,
        with the JAX arithmetic: x01 = clip((x+1)/2), pos = x01*res,
        p0 = floor(pos), frac = pos - p0, all in x's dtype
        (``ops.hash_grid.corner_rows``)."""
        return hash_grid.corner_rows(x, self.resolutions, self.table_size)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """(B, d_in) -> (B, L*F [+ d_in]) features: ``ops.hash_grid.encode``,
        the kernels on a card for float32 tables and points that need no
        gradient, else one gather of B*L*8 rows from the stacked tables,
        weighted and summed over the corners."""
        feats = hash_grid.encode(x, self.tables, self.resolutions)
        if self.include_xyz:
            feats = torch.cat([feats, x], dim=-1)
        return feats

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.encode(x)
        for i, layer in enumerate(self.mlp):
            h = layer(h)
            if i < len(self.mlp) - 1:
                h = torch.relu(h)
        return h[..., 0]
