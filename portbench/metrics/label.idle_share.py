"""label.idle_share: the share of the window's span (the benchmark's own
``bench_window`` around the passes) in which nothing ran on the card, in %."""


def read(r):
    span = r.device_span()
    if span is None:
        return None
    lo, hi = span
    return 100.0 * (1.0 - r.trace.busy(lo, hi) / (hi - lo))
