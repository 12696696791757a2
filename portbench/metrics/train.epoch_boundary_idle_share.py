"""train.epoch_boundary_idle_share: the card-idle time in the trainer's
``training_loop`` span that lies under no ``train.steps`` or
``train.validate`` span (the epochs' replays), as a share of the
``training_loop`` span, in %: the idle of the epoch and block boundaries
(the best-epoch snapshot, the host read, the loss log, the checkpoints).
``train.idle_share`` less this is the idle between replays inside the
epochs. None where the program opens no such span."""

from portbench.harness import spans

STEPS = ("train.steps", "train.validate")


def read(r):
    window = r.device_span()
    if window is None:
        return None
    lo, hi = window
    steps = spans.named(r.trace, lambda n: n in STEPS, lo, hi)
    if not steps:
        return None
    boundary = spans.subtract([(lo, hi)], steps)
    return 100.0 * spans.idle(r.trace, boundary, lo, hi) / (hi - lo)
