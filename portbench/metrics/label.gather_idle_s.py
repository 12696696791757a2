"""label.gather_idle_s: seconds a pass in which the card sat idle under the
port's ``sdf.gather`` spans (the labels unsorted, copied to the host and
cast to float64) and ``sampler.frame`` spans (each frame's columns stacked),
inside the window's ``bench_window`` span, over the window's passes. None
where the program opens no such span."""

from portbench.harness import spans

NAMES = ("sdf.gather", "sampler.frame")


def read(r):
    window = r.device_span()
    if window is None:
        return None
    lo, hi = window
    under = spans.named(r.trace, lambda n: n in NAMES, lo, hi)
    if not under:
        return None
    return spans.idle(r.trace, under, lo, hi) / 1e6 / r.window["epochs"]
