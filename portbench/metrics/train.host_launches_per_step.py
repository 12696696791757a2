"""train.host_launches_per_step: the host's launches of kernels, copies and
sets outside CUDA-graph replays in the ``training_loop`` span, per training
step of the window."""


def read(r):
    span = r.device_span()
    if span is None:
        return None
    lo, hi = span
    launches, _graphs = r.trace.host_launches(lo, hi)
    return launches / r.window["steps"]
