"""KAN — Kolmogorov-Arnold network with B-spline edge activations, as a torch
module.

Counterpart of sdf_representation_tpu/models/kan.py (reference
model/networks.py:214-490): per layer a knot grid, the Cox-de Boor basis, a
base path (SiLU + linear) plus a spline path, the least-squares
``curve2coeff`` init, the adaptive ``update_grid`` and the L1 + entropy
regularisation.

Kept from the JAX package:

  * the layouts: ``base_w`` (in, out), ``spline_w`` (in, coeff, out),
    ``spline_scaler`` (in, out); the spline path is one contraction
    'bic,ico->bo';
  * the knot grid (in, G + 2k + 1) gets no gradient and no optimizer update
    (JAX stops its gradient): here it is a buffer. It is still a float32 leaf
    of the state, so the trainer's bfloat16 step casts it and ``convert.py``
    carries it;
  * the dispatch on the grid's VALUES: while the stored grid equals
    ``default_grid()`` (compared in float32, so a grid cast to bfloat16
    matches only where its knots survive the cast, as in JAX) and the order
    is 1-3, the closed-form uniform basis runs; otherwise the general
    recursion (after ``update_grid``, or a small grid in bfloat16).

``b_splines_uniform`` returns the dense (B, in, G + k) basis of the JAX
function with the same per-element arithmetic, but builds it from the few
bases that can be non-zero at each input (k + 1 of them, plus a margin)
scattered into zeros, rather than a dozen full-size temporaries: at grid
256 and width 64 each full-size tensor is 66 KB a point.

``curve2coeff``'s systems are underdetermined ((G + 1) x (G + k)) and
``jnp.linalg.lstsq`` returns the minimum-norm solution; on CUDA
``torch.linalg.lstsq`` has only the full-rank ``gels`` driver, so the
systems are solved on the CPU with ``gelsd`` (SVD) in float64 and the
result is returned in float32 on the inputs' device.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import torch
from torch import nn


def b_splines(x: torch.Tensor, grid: torch.Tensor, spline_order: int) -> torch.Tensor:
    """Cox-de Boor recursion for any knot vectors.
    x: (B, in); grid: (in, G + 2k + 1) -> bases (B, in, G + k)."""
    x = x[..., None]
    bases = ((x >= grid[:, :-1]) & (x < grid[:, 1:])).to(x.dtype)
    for k in range(1, spline_order + 1):
        left = (x - grid[:, : -(k + 1)]) / (grid[:, k:-1] - grid[:, : -(k + 1)])
        right = (grid[:, k + 1:] - x) / (grid[:, k + 1:] - grid[:, 1:-k])
        bases = left * bases[:, :, :-1] + right * bases[:, :, 1:]
    return bases


def _cardinal(u: torch.Tensor, k: int) -> torch.Tensor:
    """The cardinal B-spline B_k(u) on integer knots, zero outside
    [0, k + 1): the JAX closed form, operation for operation."""
    inside = (u >= 0) & (u < k + 1)
    uc = torch.clamp(u, 0.0, k + 1.0)
    if k == 1:
        val = 1.0 - torch.abs(uc - 1.0)
    elif k == 2:
        t = uc - torch.floor(uc)
        p0 = 0.5 * t * t
        p1 = 0.5 + t * (1.0 - t)
        p2 = 0.5 * (1.0 - t) ** 2
        piece = torch.floor(uc)
        val = torch.where(piece == 0, p0, torch.where(piece == 1, p1, p2))
    else:
        t = uc - torch.floor(uc)
        s = 1.0 - t
        p0 = t * t * t / 6.0
        p1 = (1.0 + 3.0 * t + 3.0 * t * t - 3.0 * t * t * t) / 6.0
        p2 = (1.0 + 3.0 * s + 3.0 * s * s - 3.0 * s * s * s) / 6.0
        p3 = s * s * s / 6.0
        piece = torch.floor(uc)
        val = torch.where(piece == 0, p0,
                          torch.where(piece == 1, p1, torch.where(piece == 2, p2, p3)))
    return torch.where(inside, val, 0.0)


def b_splines_uniform(x: torch.Tensor, g0: float, h: float, n_bases: int,
                      spline_order: int) -> torch.Tensor:
    """Closed-form B-spline basis on the uniform knots g0 + (j - k) h.
    x: (B, in) -> (B, in, n_bases), the values of JAX's
    ``b_splines_uniform``: basis c is B_k(u) with u = ((x - g0)/h + k) - c,
    computed in x's dtype (c too, as JAX's ``arange(n_bases, dtype)``).

    Only bases whose u lies in [0, k + 1) are non-zero. They are among the
    k + 7 indices around floor((x - g0)/h + k) (a margin of two on each side
    covers the rounding of c to a low-precision type), so u is computed for
    those alone and scattered into zeros: every other entry of the dense
    result is zero in the JAX function as well."""
    k = spline_order
    if k not in (1, 2, 3):
        raise ValueError(f"closed form implemented for k in 1..3, got {k}")
    # g0 and h rounded to x's type first, as JAX's weakly typed scalars are
    # (torch.full: no copy from the host, which a captured step cannot hold)
    v = (x - torch.full((), g0, dtype=x.dtype, device=x.device)) \
        / torch.full((), h, dtype=x.dtype, device=x.device) + k  # (B, in)
    c = torch.floor(v).long()[..., None] + torch.arange(-k - 3, 4, device=x.device)  # (B, in, k+7)
    valid = (c >= 0) & (c < n_bases)
    val = _cardinal(v[..., None] - c.to(x.dtype), k)
    val = torch.where(valid, val, 0.0)
    out = torch.zeros(*x.shape, n_bases, dtype=val.dtype, device=x.device)
    return out.scatter_add_(-1, torch.clamp(c, 0, n_bases - 1), val)


def curve2coeff(x: torch.Tensor, y: torch.Tensor, grid: torch.Tensor,
                spline_order: int) -> torch.Tensor:
    """Least-squares spline coefficients through (x, y): x (B, in), y (B, in,
    out) -> (in, coeff, out), the minimum-norm solution of each input's
    system (SVD, on the CPU)."""
    A = b_splines(x, grid, spline_order).transpose(0, 1)  # (in, B, coeff)
    B = y.transpose(0, 1)  # (in, B, out)
    sol = torch.linalg.lstsq(A.detach().cpu().double(), B.detach().cpu().double(),
                             driver="gelsd").solution
    return sol.to(device=x.device, dtype=torch.float32)


def _kaiming_uniform(generator, shape, fan_in: int, a: float) -> torch.Tensor:
    gain = math.sqrt(2.0 / (1.0 + a * a))
    bound = gain * math.sqrt(3.0 / fan_in)
    return (torch.rand(*shape, generator=generator) * 2 - 1) * bound


class KANLayer(nn.Module):
    """One KANLinear layer (the JAX ``KANLayerSpec`` with its parameters)."""

    def __init__(self, in_features: int, out_features: int, grid_size: int = 5,
                 spline_order: int = 3, scale_noise: float = 0.1, scale_base: float = 1.0,
                 scale_spline: float = 1.0, standalone_scale_spline: bool = True,
                 grid_eps: float = 0.02, grid_range: Tuple[float, float] = (-1.0, 1.0),
                 generator: torch.Generator | None = None,
                 device: torch.device | str | None = None):
        super().__init__()
        self.in_features = int(in_features)
        self.out_features = int(out_features)
        self.grid_size = int(grid_size)
        self.spline_order = int(spline_order)
        self.scale_noise = float(scale_noise)
        self.scale_base = float(scale_base)
        self.scale_spline = float(scale_spline)
        self.standalone_scale_spline = bool(standalone_scale_spline)
        self.grid_eps = float(grid_eps)
        self.grid_range = tuple(float(g) for g in grid_range)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        grid = self.default_grid()
        base_w = _kaiming_uniform(generator, (self.in_features, self.out_features),
                                  self.in_features, math.sqrt(5.0) * self.scale_base)
        noise = ((torch.rand(self.grid_size + 1, self.in_features, self.out_features,
                             generator=generator) - 0.5)
                 * self.scale_noise / self.grid_size)
        interior = grid.T[self.spline_order: -self.spline_order]  # (G+1, in)
        coeff = curve2coeff(interior, noise, grid, self.spline_order)
        if not self.standalone_scale_spline:
            coeff = coeff * self.scale_spline
        self.register_buffer("grid", grid.to(device))
        # uses_closed_form's answer per type of the grid, until the grid changes
        self._closed_form: Dict[torch.dtype, bool] = {}
        self.base_w = nn.Parameter(base_w.to(device))
        self.spline_w = nn.Parameter(coeff.to(device))
        if self.standalone_scale_spline:
            scaler = _kaiming_uniform(generator, (self.in_features, self.out_features),
                                      self.in_features, math.sqrt(5.0) * self.scale_spline)
            self.spline_scaler = nn.Parameter(scaler.to(device))

    def default_grid(self, device=None) -> torch.Tensor:
        """(in, G + 2k + 1) float32 uniform knots over ``grid_range``."""
        g0, g1 = self.grid_range
        h = (g1 - g0) / self.grid_size
        knots = (torch.arange(-self.spline_order, self.grid_size + self.spline_order + 1,
                              dtype=torch.float32, device=device) * h + g0)
        return knots.expand(self.in_features, -1).contiguous()

    def scaled_spline_w(self) -> torch.Tensor:
        if self.standalone_scale_spline:
            return self.spline_w * self.spline_scaler[:, None, :]
        return self.spline_w

    def uses_closed_form(self) -> bool:
        """Whether the stored grid is the default one (compared in float32),
        for an order the closed form covers. Decided once per type of the
        grid (a mixed-precision step's bfloat16 copy rounds the knots) and
        kept until ``update_grid`` or loading changes the grid: the
        comparison reads the device, which a captured training step cannot."""
        dtype = self.grid.dtype
        if dtype not in self._closed_form:
            self._closed_form[dtype] = self.spline_order in (1, 2, 3) and bool(torch.equal(
                self.grid.float(), self.default_grid(self.grid.device)))
        return self._closed_form[dtype]

    def _load_from_state_dict(self, *args, **kwargs):
        self._closed_form.clear()
        super()._load_from_state_dict(*args, **kwargs)

    def bases(self, x: torch.Tensor) -> torch.Tensor:
        if self.uses_closed_form():
            g0, g1 = self.grid_range
            return b_splines_uniform(x, g0, (g1 - g0) / self.grid_size,
                                     self.grid_size + self.spline_order, self.spline_order)
        return b_splines(x, self.grid.to(x.dtype), self.spline_order)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        base = nn.functional.silu(x) @ self.base_w
        spline = torch.einsum("bic,ico->bo", self.bases(x), self.scaled_spline_w())
        return base + spline

    def regularization_loss(self, regularize_activation: float = 1.0,
                            regularize_entropy: float = 1.0) -> torch.Tensor:
        """Mean-|coeff| proxy for the L1 + entropy regulariser."""
        l1 = self.spline_w.abs().mean(dim=1)  # (in, out)
        act = l1.sum()
        prob = l1 / act
        ent = -torch.sum(prob * torch.log(prob + 1e-12))
        return regularize_activation * act + regularize_entropy * ent

    @torch.no_grad()
    def update_grid(self, x: torch.Tensor, margin: float = 0.01) -> None:
        """Adapt the knots to the distribution of x (B, in), refitting the
        spline coefficients to the layer's current spline outputs."""
        batch = x.shape[0]
        G, k = self.grid_size, self.spline_order
        splines = b_splines(x, self.grid, k)
        unreduced = torch.einsum("bic,ico->bio", splines, self.scaled_spline_w())
        x_sorted = torch.sort(x, dim=0).values
        # jnp.linspace(0, batch - 1, G + 1) in float32, truncated to int
        frac = torch.arange(G, dtype=torch.float32) / G
        pick = torch.cat([0.0 * (1 - frac) + float(batch - 1) * frac,
                          torch.tensor([float(batch - 1)])]).long().to(x.device)
        grid_adaptive = x_sorted[pick]
        step = (x_sorted[-1] - x_sorted[0] + 2 * margin) / G
        grid_uniform = (torch.arange(G + 1, dtype=torch.float32, device=x.device)[:, None] * step
                        + x_sorted[0] - margin)
        grid = self.grid_eps * grid_uniform + (1 - self.grid_eps) * grid_adaptive
        lo = grid[:1] - step * torch.arange(k, 0, -1, dtype=torch.float32, device=x.device)[:, None]
        hi = grid[-1:] + step * torch.arange(1, k + 1, dtype=torch.float32, device=x.device)[:, None]
        new_grid = torch.cat([lo, grid, hi], dim=0).T.contiguous()
        self.spline_w.copy_(curve2coeff(x, unreduced, new_grid, k))
        self.grid.copy_(new_grid)
        self._closed_form.clear()


class KAN(nn.Module):
    """A stack of KAN layers; ``layers_hidden`` includes the input and output
    widths, e.g. (3, 64, 64, 1); the reference's default grid_size is 256."""

    def __init__(self, layers_hidden: Sequence[int] = (3, 64, 64, 1), grid_size: int = 256,
                 spline_order: int = 3, scale_noise: float = 0.1, scale_base: float = 1.0,
                 scale_spline: float = 1.0, grid_eps: float = 0.02,
                 grid_range: Tuple[float, float] = (-1.0, 1.0),
                 generator: torch.Generator | None = None,
                 device: torch.device | str | None = None):
        super().__init__()
        self.layers_hidden = tuple(int(w) for w in layers_hidden)
        self.d_in = self.layers_hidden[0]
        self.grid_size = int(grid_size)
        self.spline_order = int(spline_order)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.layers = nn.ModuleList(
            KANLayer(i, o, grid_size=grid_size, spline_order=spline_order,
                     scale_noise=scale_noise, scale_base=scale_base, scale_spline=scale_spline,
                     grid_eps=grid_eps, grid_range=grid_range, generator=generator,
                     device=device)
            for i, o in zip(self.layers_hidden, self.layers_hidden[1:]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        for layer in self.layers:
            h = layer(h)
        return h[..., 0]

    @torch.no_grad()
    def update_grid(self, x: torch.Tensor) -> None:
        h = x
        for layer in self.layers:
            layer.update_grid(h)
            h = layer(h)

    def regularization_loss(self, regularize_activation: float = 1.0,
                            regularize_entropy: float = 1.0) -> torch.Tensor:
        return sum(layer.regularization_loss(regularize_activation, regularize_entropy)
                   for layer in self.layers)
