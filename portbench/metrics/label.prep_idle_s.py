"""label.prep_idle_s: seconds a pass in which the card sat idle under the
port's ``sdf.prepare_mesh`` spans (the face sort, the triangle tables and
the chunk geometry: work that depends on the mesh alone, made again by each
labelling call), inside the window's ``bench_window`` span, over the
window's passes. None where the program opens no such span."""

from portbench.harness import spans


def read(r):
    window = r.device_span()
    if window is None:
        return None
    lo, hi = window
    under = spans.named(r.trace, lambda n: n == "sdf.prepare_mesh", lo, hi)
    if not under:
        return None
    return spans.idle(r.trace, under, lo, hi) / 1e6 / r.window["epochs"]
