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
    stacked (L*T, F) tables in one index (its backward, one scatter-add);
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

import functools
import math

import torch
from torch import nn

PRIMES = (1, 2654435761, 805459861)
_MASK32 = 0xFFFFFFFF

# the 8 corner offsets, dx-major (the JAX order)
_OFFSETS = ((0, 0, 0), (0, 0, 1), (0, 1, 0), (0, 1, 1),
            (1, 0, 0), (1, 0, 1), (1, 1, 0), (1, 1, 1))


@functools.lru_cache(maxsize=None)
def _offsets(device) -> torch.Tensor:
    """``_OFFSETS`` as an int64 tensor, made once per device (a copy from
    the host inside a captured training step would synchronise)."""
    return torch.tensor(_OFFSETS, dtype=torch.int64, device=device)


def hash_index(cx: torch.Tensor, cy: torch.Tensor, cz: torch.Tensor, table_size: int) -> torch.Tensor:
    """uint32 (cx * P0) ^ (cy * P1) ^ (cz * P2) mod ``table_size`` of
    non-negative integer corners, computed in int64 (the low 32 bits of the
    products and of their xor are the uint32 ones)."""
    h = (cx.long() * PRIMES[0]) ^ (cy.long() * PRIMES[1]) ^ (cz.long() * PRIMES[2])
    return torch.remainder(h & _MASK32, table_size)


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

    def corner_indices(self, x: torch.Tensor):
        """(idx (B, L, 8) int64 rows of the stacked (L*T, F) tables, weights
        (B, L, 8) in x's dtype) of every point's 8 corners at every level,
        with the JAX arithmetic: x01 = clip((x+1)/2), pos = x01*res,
        p0 = floor(pos), frac = pos - p0, all in x's dtype."""
        x01 = torch.clamp((x + 1.0) * 0.5, 0.0, 1.0)
        offs = _offsets(x.device)  # (8, 3)
        T = self.table_size
        idx_all, w_all = [], []
        for level in range(self.n_levels):
            res = self.level_resolution(level)
            pos = x01 * res
            p0 = torch.floor(pos).long()
            frac = pos - p0.to(pos.dtype)
            corner = torch.clamp(p0[:, None, :] + offs[None], 0, res)  # (B, 8, 3)
            if self.is_dense(level):
                ci = corner[..., 0] * (res + 1) * (res + 1) + corner[..., 1] * (res + 1) + corner[..., 2]
            else:
                ci = hash_index(corner[..., 0], corner[..., 1], corner[..., 2], T)
            idx_all.append(ci + level * T)
            w = torch.ones_like(frac[:, :1]).expand(-1, 8)
            for axis in range(3):
                pick = offs[None, :, axis] == 1
                w = w * torch.where(pick, frac[:, None, axis], 1.0 - frac[:, None, axis])
            w_all.append(w)
        return torch.stack(idx_all, dim=1), torch.stack(w_all, dim=1)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """(B, d_in) -> (B, L*F [+ d_in]) features: one gather of B*L*8 rows
        from the stacked tables, weighted and summed over the corners."""
        B = x.shape[0]
        L, F = self.n_levels, self.n_features
        idx, w = self.corner_indices(x)
        big = self.tables.reshape(L * self.table_size, F)
        g = big[idx.reshape(-1)].reshape(B, L, 8, F)
        feats = torch.sum(w[..., None] * g, dim=2).reshape(B, L * F)
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
