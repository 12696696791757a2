"""ImplicitNet, the model family of a training configuration without a
``"reference"`` key: its plain float32 reference and its counts of work.

The network of Gropp et al., Implicit Geometric Regularization (arXiv:
2002.10099), as the DeepSDF / IGR code writes it: layers of widths
``[d_in] + hidden * n + [1]``, the layer that a skip feeds returns ``width -
d_in`` features, the skip layer reads ``concat(h, x) / sqrt(2)``, Softplus
with beta between layers, geometric initialisation (weights ~ N(0, sqrt(2) /
sqrt(fan_out)), the last layer's sqrt(pi) / sqrt(fan_in) + N(0, 1e-5), its
bias -1), drawn layer by layer from ``torch.Generator().manual_seed(seed)``.

What a family module gives the harness (``harness/train_cell.py``); a family
imports nothing of the program:
  ``net(model_section)``     the sizes, from the INI's ``[Model]`` section.
  ``init_params(net, seed, device)``  float32 leaves in the program's
                             ``named_parameters()`` order and layout, drawn
                             as the program draws them from the seed.
  ``forward(params, x, net, mode)``   (N, d_in) -> (N,) in the modes of
                             ``reference.train``.
  ``work(net, loss, batch, eikonal_rows, precision)``  ``flops_per_point``
                             and what the family's per-layer readers read.
  ``TINY``                   ``[Model]`` values that cut it to CPU size.

Counts: multiply-adds (MACs) per point and per linear layer, fan_in x
fan_out, over ``layer_shapes``; an operation is 2 per MAC. What a step
needs is counted, once: operations that a kernel recomputes (the eikonal
backward re-runs both forward chains) are not, so a share of a peak never
rewards recomputing.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from portbench.harness import counts
from portbench.reference import train as ref_train

TINY = {"hidden_dim": 32, "num_hidden_layers": 4, "skip_connection": 2}

Shapes = Sequence[Tuple[int, int]]


def net(model: Dict) -> Dict:
    skip = (int(model["skip_connection"]),) if int(model["skip_connection"]) else ()
    return {"d_in": int(model["input_dim"]), "hidden": int(model["hidden_dim"]),
            "n_hidden": int(model["num_hidden_layers"]), "skip": skip, "beta": float(model["beta"])}


def layer_shapes(d_in: int, hidden: int, n_hidden: int, skip: Sequence[int]):
    """(fan_in, fan_out) per layer; the layer that a skip feeds gives width - d_in."""
    dims = [d_in] + [hidden] * n_hidden + [1]
    return [(dims[i], dims[i + 1] - (d_in if i + 1 in skip else 0)) for i in range(len(dims) - 1)]


def _shapes(net: Dict):
    return layer_shapes(net["d_in"], net["hidden"], net["n_hidden"], net["skip"])


def init_params(net: Dict, seed: int, device) -> List[torch.Tensor]:
    """[W0, b0, W1, b1, ...] float32, geometric initialisation."""
    gen = torch.Generator().manual_seed(seed)
    shapes = _shapes(net)
    out = []
    for i, (fan_in, fan_out) in enumerate(shapes):
        if i == len(shapes) - 1:
            w = math.sqrt(math.pi) / math.sqrt(fan_in) + 1e-5 * torch.randn(fan_out, fan_in, generator=gen)
            b = torch.full((fan_out,), -1.0)
        else:
            w = math.sqrt(2.0) / math.sqrt(fan_out) * torch.randn(fan_out, fan_in, generator=gen)
            b = torch.zeros(fan_out)
        out += [w.float().to(device), b.float().to(device)]
    return out


def forward(params: Sequence[torch.Tensor], x: torch.Tensor, net: Dict, mode: str = "f32") -> torch.Tensor:
    """(N, d_in) -> (N,)"""
    q = ref_train.quantizer(mode)
    skip, beta = net["skip"], net["beta"]
    h = x
    n = len(params) // 2
    for i in range(n):
        if i in skip:
            h = torch.cat([h, x], dim=-1) / math.sqrt(2.0)
        z = q(q(h) @ q(params[2 * i]).T) + params[2 * i + 1]
        if i < n - 1:
            bz = beta * z
            h = (torch.clamp_min(bz, 0.0) + torch.log1p(torch.exp(-bz.abs()))) / beta
        else:
            h = z
    return h[:, 0]


# -- counts ---------------------------------------------------------------------


def macs(shapes: Shapes) -> int:
    """Multiply-adds of one forward pass of one point."""
    return sum(fan_in * fan_out for fan_in, fan_out in shapes)


def supervised_macs(shapes: Shapes) -> int:
    """Forward, then backward: dW of every layer and dh below the first."""
    m = macs(shapes)
    return 3 * m - shapes[0][0] * shapes[0][1]


def eikonal_fwd_macs(shapes: Shapes) -> int:
    """f and grad_x f: the forward chain and one reverse sweep of the head's cotangent."""
    return 2 * macs(shapes)


def eikonal_bwd_macs(shapes: Shapes) -> int:
    """The parameters' gradient of a . f + c . grad_x f: dW from both chains,
    the cotangent of the forward chain below the first layer, that of the
    sweep's chain above the head."""
    m = macs(shapes)
    first, last = shapes[0][0] * shapes[0][1], shapes[-1][0] * shapes[-1][1]
    return 4 * m - first - last


def eikonal_step_macs(shapes: Shapes) -> int:
    return eikonal_fwd_macs(shapes) + eikonal_bwd_macs(shapes)


def step_flops_per_point(loss: str, shapes: Shapes, batch: int, eikonal_rows: int) -> float:
    """Model operations of one training step, per training point of its batch."""
    if loss == "IGRLOSS":
        return 2.0 * eikonal_step_macs(shapes)
    if loss == "IGRLOSSPCD":
        return 2.0 * (supervised_macs(shapes) + eikonal_step_macs(shapes) * eikonal_rows / batch)
    return 2.0 * supervised_macs(shapes)


def _weight_bytes(shapes: Shapes, weight_bytes: int) -> int:
    """Weights in the working type, float32 biases."""
    return sum(fi * fo * weight_bytes + fo * 4 for fi, fo in shapes)


def igr_fwd_cost(shapes: Shapes, n: int, weight_bytes: int = 2) -> Tuple[float, float]:
    """(operations, bytes) of kernel 8 on n points: float32 x in, the weights
    once, float32 f and grad_x f out."""
    d = shapes[0][0]
    return 2.0 * n * eikonal_fwd_macs(shapes), float(n * d * 4 + _weight_bytes(shapes, weight_bytes)
                                                     + n * (1 + d) * 4)


def igr_bwd_cost(shapes: Shapes, n: int, weight_bytes: int = 2) -> Tuple[float, float]:
    """(operations, bytes) of kernel 9 on n points: x, a and c in, the weights
    once, float32 dW and db out."""
    d = shapes[0][0]
    params = sum(fi * fo + fo for fi, fo in shapes)
    return 2.0 * n * eikonal_bwd_macs(shapes), float(n * (2 * d + 1) * 4
                                                     + _weight_bytes(shapes, weight_bytes) + params * 4)


def work(net: Dict, loss: str, batch: int, eikonal_rows: int, precision: Optional[str]) -> Dict:
    """``shapes``, ``flops_per_point``, and where the bfloat16 step runs the
    eikonal kernels 8-9 (``igr_roofline`` reads it), ``igr_bound_s_per_step``:
    both kernels' least time on ``eikonal_rows`` points."""
    shapes = _shapes(net)
    out = {"shapes": shapes, "flops_per_point": step_flops_per_point(loss, shapes, batch, eikonal_rows)}
    if precision == "bfloat16" and loss in ("IGRLOSS", "IGRLOSSPCD"):
        fwd = igr_fwd_cost(shapes, eikonal_rows)
        bwd = igr_bwd_cost(shapes, eikonal_rows)
        out["igr_bound_s_per_step"] = counts.bound_seconds(*fwd) + counts.bound_seconds(*bwd)
    return out
