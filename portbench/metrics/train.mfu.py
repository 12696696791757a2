"""train.mfu: the training step's share of the card's bfloat16 peak, in %.

The step's model operations per training point (``harness.counts``: forward
and backward, and for the eikonal losses f, grad_x f and their parameters'
gradient, nothing recomputed counted) times the points stepped, over the
trainer's ``training_loop`` span in the trace, over 989 TFLOP/s.
"""

from portbench.harness import counts


def read(r):
    span = r.device_span()
    if span is None:
        return None
    lo, hi = span
    flops = r.work["flops_per_point"] * r.window["points"]
    return 100.0 * flops / ((hi - lo) / 1e6) / counts.PEAK_FLOPS["bfloat16"]
