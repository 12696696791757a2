"""HashMLP, a second model family's plain reference, kept beside the tests:
with it a training cell of another family is made of data files and this
one module, and the harness is not edited (``../test_families.py``).

Instant-NGP's multiresolution hash encoding (Müller et al. 2022, arXiv:
2201.05989) and a small ReLU MLP, at the program's current sizes (its INI
sets only the MLP's): ``n_levels`` feature tables of ``2**log2_table_size``
rows of ``n_features``; level l at resolution round(base * growth**l),
growth = (max / base)**(1 / (L - 1)); a corner's row is its lattice index
where the level's (res + 1)**3 corners fit the table, else the uint32 hash
(x * 1) ^ (y * 2654435761) ^ (z * 805459861) modulo the table's rows; the
8 corners interpolated trilinearly at x01 = clip((x + 1) / 2, 0, 1); the
MLP reads the levels' features and the point. Initial parameters as the
program draws them from one ``torch.Generator``: the tables uniform in
+-1e-4, then each layer's weight (fan_in, fan_out) uniform in
+-1/sqrt(fan_in), biases zero.

The hash is worked out in numpy's wrapping uint32 arithmetic, not as the
program does it. In "fp8" the tables enter the encoding rounded, and each
product of the MLP is rounded before its bias, as ``reference.implicitnet``
rounds its own.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from portbench.reference import train as ref_train

TINY = {"hidden_dim": 16, "num_hidden_layers": 2}

# the program's defaults: its INI reader passes none of them through
ENCODING = {"n_levels": 8, "n_features": 2, "log2_table_size": 15, "base_resolution": 8,
            "max_resolution": 256}
PRIMES = (1, 2654435761, 805459861)
CORNERS = [(dx, dy, dz) for dx in (0, 1) for dy in (0, 1) for dz in (0, 1)]


def net(model: Dict) -> Dict:
    return {"d_in": int(model["input_dim"]), "hidden": int(model["hidden_dim"]),
            "n_layers": max(2, int(model["num_hidden_layers"])), **ENCODING}


def _dims(net: Dict) -> List[int]:
    return [net["n_levels"] * net["n_features"] + net["d_in"]] + [net["hidden"]] * (net["n_layers"] - 1) + [1]


def _resolutions(net: Dict) -> List[int]:
    n, base, top = net["n_levels"], net["base_resolution"], net["max_resolution"]
    growth = 1.0 if n == 1 else math.exp((math.log(top) - math.log(base)) / (n - 1))
    return [int(round(base * growth ** level)) for level in range(n)]


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


def forward(params: Sequence[torch.Tensor], x: torch.Tensor, net: Dict, mode: str = "f32") -> torch.Tensor:
    """(N, d_in) -> (N,)"""
    q = ref_train.quantizer(mode)
    tables, layers = q(params[0]), params[1:]
    u = torch.clamp((x + 1.0) * 0.5, 0.0, 1.0)
    feats = []
    for level, res in enumerate(_resolutions(net)):
        pos = u * res
        low = torch.floor(pos)
        frac = pos - low
        low = low.detach().cpu().numpy().astype(np.int64)
        acc = None
        for offset in CORNERS:
            corner = np.clip(low + np.array(offset), 0, res)
            rows = torch.as_tensor(_rows(corner, res, tables.shape[1]), device=x.device)
            w = math.prod(frac[:, a] if o else 1.0 - frac[:, a] for a, o in enumerate(offset))
            term = w[:, None] * tables[level][rows]
            acc = term if acc is None else acc + term
        feats.append(acc)
    h = torch.cat(feats + [x], dim=-1)
    for i in range(0, len(layers), 2):
        h = q(q(h) @ q(layers[i])) + layers[i + 1]
        if i + 2 < len(layers):
            h = torch.relu(h)
    return h[:, 0]


def work(net: Dict, loss: str, batch: int, eikonal_rows: int, precision: Optional[str]) -> Dict:
    """``flops_per_point`` of a supervised step: the MLP forward, its dW and
    its input cotangent (all but the point's columns), and the corners'
    weighted sums forward and their tables' gradient."""
    if loss != "WeightedSmoothL2Loss":
        raise ValueError(f"the HashMLP reference counts only the supervised step, not {loss}")
    dims = _dims(net)
    mlp = sum(a * b for a, b in zip(dims, dims[1:]))
    interp = 8 * net["n_levels"] * net["n_features"]
    return {"flops_per_point": 2.0 * (3 * mlp - net["d_in"] * dims[1] + 2 * interp)}
