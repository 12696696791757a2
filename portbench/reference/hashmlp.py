"""HashMLP, Instant-NGP's hash-grid SDF: its plain float32 reference and its
counts of work.

Müller et al. 2022 (arXiv:2201.05989), as NVlabs/instant-ngp's
``configs/sdf/base.json`` sizes it for signed distance fields, and as the
port's INI states it (``[Model]``: ``n_levels``, ``n_features``,
``log2_table_size``, ``base_resolution``, ``max_resolution``,
``include_xyz``; absent, the port's defaults, ``ENCODING``):
``n_levels`` feature tables of ``2**log2_table_size`` rows of
``n_features``; level l at resolution round(base * growth**l), growth =
(max / base)**(1 / (L - 1)); a corner's row is its lattice index where the
level's (res + 1)**3 corners fit the table, else the uint32 hash (x * 1) ^
(y * 2654435761) ^ (z * 805459861) modulo the table's rows; the 8 corners
interpolated trilinearly at x01 = clip((x + 1) / 2, 0, 1); a ReLU MLP of
``max(2, num_hidden_layers)`` affine layers, ``hidden_dim`` wide, reads the
levels' features (and the point, with ``include_xyz``). Departures from the
source, as the port has them: biases in the MLP (tiny-cuda-nn's fused MLP
has none), the port's Adam. Initial parameters as the port draws them from
one ``torch.Generator``: the tables uniform in +-1e-4, then each layer's
weight (fan_in, fan_out) uniform in +-1/sqrt(fan_in), biases zero.

The hash is worked out in numpy's wrapping uint32 arithmetic, not as the
port does it. Modes (``reference.train``): in "tf32" the tables, the corner
weights and every operand of the MLP's products enter rounded to TF32's
10-bit mantissa, since the encoding has no matrix product for TF32 to
round; in "fp8" the tables enter the encoding rounded, and each product of
the MLP is rounded before its bias, as ``reference.implicitnet`` rounds its
own.

Counts (``work``): per point, multiply-adds of the MLP's forward, its dW and
its input cotangent (all but the point's columns), and the corners'
weighted sums forward and their share of the tables' gradient backward.
``hash_bound_s``, the least time of one batch of each encoding kernel
(``hash.encode_roofline`` reads it): forward, the points in, the features
out and each level's corner rows read once, as many rows as 8 x batch
uniform draws from the level's R rows touch on average, R (1 - (1 -
1/R)^(8 batch)), x F x 4 bytes (points bunched at a surface touch fewer, so
the count is the least only for points spread evenly); backward, the
features' gradient and the points in, those rows read and written; the
weighted sums at the float32 peak.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from portbench.harness import counts
from portbench.reference import train as ref_train

TINY = {"hidden_dim": 16, "num_hidden_layers": 3, "n_levels": 4, "log2_table_size": 12,
        "base_resolution": 4, "max_resolution": 32}

# the port's defaults, where the INI sets none
ENCODING = {"n_levels": 8, "n_features": 2, "log2_table_size": 15, "base_resolution": 8,
            "max_resolution": 256, "include_xyz": True}
PRIMES = (1, 2654435761, 805459861)
CORNERS = [(dx, dy, dz) for dx in (0, 1) for dy in (0, 1) for dz in (0, 1)]
KERNELS = ("hash_encode_fwd_kernel", "hash_encode_bwd_kernel")


def _flag(value) -> bool:
    return value if isinstance(value, bool) else str(value).strip().lower() in ("1", "true", "yes", "on")


def net(model: Dict) -> Dict:
    enc = {k: int(model.get(k, v)) for k, v in ENCODING.items() if k != "include_xyz"}
    return {"d_in": int(model["input_dim"]), "hidden": int(model["hidden_dim"]),
            "n_layers": max(2, int(model["num_hidden_layers"])),
            "include_xyz": _flag(model.get("include_xyz", ENCODING["include_xyz"])), **enc}


def _dims(net: Dict) -> List[int]:
    first = net["n_levels"] * net["n_features"] + (net["d_in"] if net["include_xyz"] else 0)
    return [first] + [net["hidden"]] * (net["n_layers"] - 1) + [1]


def resolutions(net: Dict) -> List[int]:
    n, base, top = net["n_levels"], net["base_resolution"], net["max_resolution"]
    growth = 1.0 if n == 1 else math.exp((math.log(top) - math.log(base)) / (n - 1))
    return [int(round(base * growth ** level)) for level in range(n)]


def level_rows(net: Dict) -> List[int]:
    """Rows each level can address: its (res + 1)**3 corners where they fit, else the table's."""
    rows = 1 << net["log2_table_size"]
    return [min((res + 1) ** 3, rows) for res in resolutions(net)]


def distinct_rows(rows: int, draws: int) -> float:
    """How many of ``rows`` rows ``draws`` uniform draws touch on average."""
    return -rows * math.expm1(draws * math.log1p(-1.0 / rows)) if rows > 1 else float(rows)


def init_params(net: Dict, seed: int, device) -> List[torch.Tensor]:
    """[tables (L, T, F), w0 (in, out), b0, w1, b1, ...] float32."""
    gen = torch.Generator().manual_seed(seed)
    shape = (net["n_levels"], 1 << net["log2_table_size"], net["n_features"])
    out = [(torch.rand(shape, generator=gen) * 2 - 1) * 1e-4]
    dims = _dims(net)
    for fan_in, fan_out in zip(dims, dims[1:]):
        out += [(torch.rand(fan_in, fan_out, generator=gen) * 2 - 1) * (1.0 / math.sqrt(fan_in)),
                torch.zeros(fan_out)]
    return [p.float().to(device) for p in out]


def _rows(corner: np.ndarray, res: int, table_rows: int) -> np.ndarray:
    """(N, 3) corners -> (N,) rows of the level's table."""
    if (res + 1) ** 3 <= table_rows:
        return (corner[:, 0] * (res + 1) + corner[:, 1]) * (res + 1) + corner[:, 2]
    c = corner.astype(np.uint32)
    with np.errstate(over="ignore"):
        h = (c[:, 0] * np.uint32(PRIMES[0])) ^ (c[:, 1] * np.uint32(PRIMES[1])) ^ (c[:, 2] * np.uint32(PRIMES[2]))
    return (h % np.uint32(table_rows)).astype(np.int64)


def _round_tf32(t: torch.Tensor) -> torch.Tensor:
    """Round to nearest (ties away) at TF32's 10-bit mantissa."""
    bits = t.detach().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


class _Tf32(torch.autograd.Function):
    """Rounds the value forward; the gradient passes as it is."""

    @staticmethod
    def forward(ctx, x):
        return _round_tf32(x)

    @staticmethod
    def backward(ctx, g):
        return g


def _quantizer(mode: str):
    return _Tf32.apply if mode == "tf32" else ref_train.quantizer(mode)


def forward(params: Sequence[torch.Tensor], x: torch.Tensor, net: Dict, mode: str = "f32") -> torch.Tensor:
    """(N, d_in) -> (N,)"""
    q = _quantizer(mode)
    tables, layers = q(params[0]), params[1:]
    u = torch.clamp((x + 1.0) * 0.5, 0.0, 1.0)
    feats = []
    for level, res in enumerate(resolutions(net)):
        pos = u * res
        low = torch.floor(pos)
        frac = pos - low
        low = low.detach().cpu().numpy().astype(np.int64)
        acc = None
        for offset in CORNERS:
            corner = np.clip(low + np.array(offset), 0, res)
            rows = torch.as_tensor(_rows(corner, res, tables.shape[1]), device=x.device)
            w = math.prod(frac[:, a] if o else 1.0 - frac[:, a] for a, o in enumerate(offset))
            if mode == "tf32":
                w = q(w)
            term = w[:, None] * tables[level][rows]
            acc = term if acc is None else acc + term
        feats.append(acc)
    h = torch.cat(feats + ([x] if net["include_xyz"] else []), dim=-1)
    for i in range(0, len(layers), 2):
        h = q(q(h) @ q(layers[i])) + layers[i + 1]
        if i + 2 < len(layers):
            h = torch.relu(h)
    return h[:, 0]


def hash_bound_s(net: Dict, batch: int) -> Dict[str, float]:
    """The least time of one batch of each encoding kernel, by its name."""
    L, F, d = net["n_levels"], net["n_features"], net["d_in"]
    rows = sum(distinct_rows(r, 8 * batch) for r in level_rows(net)) * F * 4
    points, feats = batch * d * 4, batch * L * F * 4
    ops = 2.0 * batch * 8 * L * F
    return {KERNELS[0]: counts.bound_seconds(ops, points + feats + rows, "float32"),
            KERNELS[1]: counts.bound_seconds(ops, feats + points + 2 * rows, "float32")}


def work(net: Dict, loss: str, batch: int, eikonal_rows: int, precision: Optional[str]) -> Dict:
    """``flops_per_point`` of a supervised step and ``hash_bound_s``."""
    if loss != "WeightedSmoothL2Loss":
        raise ValueError(f"the HashMLP reference counts only the supervised step, not {loss}")
    dims = _dims(net)
    mlp = sum(a * b for a, b in zip(dims, dims[1:]))
    point_cols = net["d_in"] * dims[1] if net["include_xyz"] else 0
    interp = 8 * net["n_levels"] * net["n_features"]
    return {"flops_per_point": 2.0 * (3 * mlp - point_cols + 2 * interp),
            "hash_bound_s": hash_bound_s(net, batch)}
