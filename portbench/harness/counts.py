"""Operations and bytes of the work, from shapes, and the card's published peaks.

Peaks: NVIDIA H100 SXM data sheet, dense rates at its 700 W limit.

Multiply-adds (MACs) are counted per point and per linear layer, fan_in x
fan_out, over the ImplicitNet's ``layer_shapes``; an operation is 2 per MAC.
What a step needs is counted, once: operations that a kernel recomputes (the
eikonal backward re-runs both forward chains) are not, so a share of a peak
never rewards recomputing.
"""

from __future__ import annotations

from typing import Sequence, Tuple

from ..reference.train import layer_shapes  # noqa: F401  (the shapes both count and run)

PEAK_FLOPS = {"bfloat16": 989e12, "tf32": 495e12, "float32": 67e12}
PEAK_BYTES_PER_S = 3.35e12

Shapes = Sequence[Tuple[int, int]]


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


def bound_seconds(ops: float, nbytes: float, peak: str = "bfloat16") -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(ops / PEAK_FLOPS[peak], nbytes / PEAK_BYTES_PER_S)
