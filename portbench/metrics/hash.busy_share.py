"""hash.busy_share: the hash encoding's kernel pair's device time
(``hash_encode_fwd_kernel``, ``hash_encode_bwd_kernel``) as a share of the
card's busy time in the ``training_loop`` span, in %. None where they did
not run."""

PATTERN = r"hash_encode_(fwd|bwd)_kernel"
PER_STEP = ("hash_encode_bwd_kernel",)


def read(r):
    span = r.device_span()
    if span is None:
        return None
    lo, hi = span
    micros, n = r.trace.kernel_time(PATTERN, lo, hi)
    busy = r.trace.busy(lo, hi)
    return 100.0 * micros / busy if n and busy else None
