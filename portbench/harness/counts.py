"""The card's published peaks, and the least time a piece of work could take.

Peaks: NVIDIA H100 SXM data sheet, dense rates at its 700 W limit.

A training configuration's model family counts its own operations and bytes
from its shapes (``work`` of its module under ``reference/``); the readers
hold them against these peaks.
"""

from __future__ import annotations

PEAK_FLOPS = {"bfloat16": 989e12, "tf32": 495e12, "float32": 67e12}
PEAK_BYTES_PER_S = 3.35e12


def bound_seconds(ops: float, nbytes: float, peak: str = "bfloat16") -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(ops / PEAK_FLOPS[peak], nbytes / PEAK_BYTES_PER_S)
