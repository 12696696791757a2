"""igr_roofline: kernels 8-9 (the eikonal forward and backward of
csrc/fused_igr.cu) against their bound, in %.

The bound of a step is, for each of the two kernels, the larger of its
needed operations over the bfloat16 peak and its bytes (inputs, the
weights once, outputs) over the memory bandwidth (``harness.counts``); its
time is the summed device time of ``igr_fwd_kernel``, ``igr_bwd_kernel`` and
``igr_dw_kernel`` in the ``training_loop`` span. None where they did not run.
"""

PATTERN = r"igr_(fwd|bwd|dw)_kernel"
PER_STEP = ("igr_fwd_kernel", "igr_bwd_kernel", "igr_dw_kernel")


def read(r):
    span = r.device_span()
    if span is None or "igr_bound_s_per_step" not in r.work:
        return None
    lo, hi = span
    micros, n = r.trace.kernel_time(PATTERN, lo, hi)
    if not n:
        return None
    return 100.0 * r.work["igr_bound_s_per_step"] * r.window["steps"] / (micros / 1e6)
