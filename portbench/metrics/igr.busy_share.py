"""igr.busy_share: kernels 8-9's device time as a share of the card's busy
time in the ``training_loop`` span, in %. None where they did not run."""

PATTERN = r"igr_(fwd|bwd|dw)_kernel"
PER_STEP = ("igr_fwd_kernel", "igr_bwd_kernel", "igr_dw_kernel")


def read(r):
    span = r.device_span()
    if span is None:
        return None
    lo, hi = span
    micros, n = r.trace.kernel_time(PATTERN, lo, hi)
    busy = r.trace.busy(lo, hi)
    return 100.0 * micros / busy if n and busy else None
