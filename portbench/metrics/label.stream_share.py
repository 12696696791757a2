"""label.stream_share: the exact-SDF streams (kernels 4-5 of
csrc/sdf_streams.cu, ``dist_kernel`` and ``wind_kernel``, which the culled
method launches too) as a share of the card's busy time in the window's
span, in %. None where they did not run."""

PATTERN = r"\b(dist|wind)_kernel\b"


def read(r):
    span = r.device_span()
    if span is None:
        return None
    lo, hi = span
    micros, n = r.trace.kernel_time(PATTERN, lo, hi)
    busy = r.trace.busy(lo, hi)
    return 100.0 * micros / busy if n and busy else None
