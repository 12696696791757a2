"""train.idle_share: the share of the trainer's ``training_loop`` span in
which nothing ran on the card, in % (busy: the union of its operations)."""


def read(r):
    span = r.device_span()
    if span is None:
        return None
    lo, hi = span
    return 100.0 * (1.0 - r.trace.busy(lo, hi) / (hi - lo))
