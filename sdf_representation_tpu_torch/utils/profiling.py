"""Tracing and spans — counterpart of sdf_representation_tpu/utils/profiling.py.

  * span(name, stages=None, key=None): a named range of the program on the
    profiler's clock. It opens ``torch.profiler.record_function(name)`` only
    while a profiler records (the check costs a fraction of a microsecond,
    an unguarded range about ten), so a trace can name the stage the host
    was in when the card sat idle. With ``stages`` it also writes the
    block's host seconds into ``stages[key or name]``: the modules'
    ``LAST_STAGE_SECONDS`` are written this way. Names are dotted by layer
    (``sampler.*``, ``sdf.*``, ``train.*``); ``portbench/metrics`` reads them.
  * trace(log_dir): a ``torch.profiler`` window around a code block; CPU
    activity, and CUDA activity where a card is present. It writes one
    Chrome trace (``*.pt.trace.json``) into log_dir, which Perfetto,
    chrome://tracing and TensorBoard's profiler plugin open. A window whose
    host put work on the card but whose trace holds no device event raises
    ``NoDeviceEvents`` (``check_device_events``) instead of handing back a
    trace that would read as an idle card.
  * force(x): waits for the device of the first tensor of a nested
    dict / list / tuple (torch returns before the card finishes).
  * debug_nans(): anomaly detection in autograd (the JAX package's
    jax_debug_nans switch; the reference called
    torch.autograd.set_detect_anomaly unconditionally, executor.py:159).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch

_profiler_enabled = torch._C._autograd._profiler_enabled


class span:
    """``with span("sdf.gather"): ...``: a profiler range named ``name``
    where a profiler records, and the block's host seconds in
    ``stages[key or name]`` where ``stages`` is given. Spans nest."""

    __slots__ = ("name", "stages", "key", "_range", "_t0")

    def __init__(self, name: str, stages: Optional[dict] = None, key: Optional[str] = None):
        self.name, self.stages, self.key = name, stages, key
        self._range = None

    def __enter__(self) -> "span":
        if _profiler_enabled():
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        if self.stages is not None:
            self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        if self.stages is not None:
            self.stages[self.key or self.name] = time.perf_counter() - self._t0
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None


# the CUDA runtime and driver calls that put work on the card
_DEVICE_WORK = ("cudaLaunchKernel", "cuLaunchKernel", "cudaGraphLaunch", "cudaMemcpy", "cudaMemset")


class NoDeviceEvents(RuntimeError):
    """A profiler window's host put work on the card, and its trace holds
    none of the card's events."""


def check_device_events(events) -> None:
    """Raise ``NoDeviceEvents`` where ``events`` (a window's profiler
    events: ``name()``, ``device_type()``) hold a runtime call that put work
    on the card and no event of the card itself."""
    launched = on_card = 0
    for event in events:
        if event.device_type() == torch.autograd.DeviceType.CUDA:
            on_card += 1
        elif event.name().startswith(_DEVICE_WORK):
            launched += 1
    if launched and not on_card:
        raise NoDeviceEvents(f"torch.profiler recorded {launched} launches on the host and no event "
                             "on the card in this window: its trace would read as an idle card")


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler trace around a code block; yields the profiler. With
    a card, raises ``NoDeviceEvents`` after a window whose trace lost the
    card's events (``check_device_events``)."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof
    if ProfilerActivity.CUDA in activities:
        check_device_events(prof.profiler.kineto_results.events())


def _leaves(x):
    if isinstance(x, dict):
        for v in x.values():
            yield from _leaves(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _leaves(v)
    else:
        yield x


def force(x) -> None:
    """Wait for the work behind the first tensor leaf of ``x`` (its device
    synchronized; a CPU tensor is already computed)."""
    for leaf in _leaves(x):
        if isinstance(leaf, torch.Tensor):
            if leaf.device.type == "cuda":
                torch.cuda.synchronize(leaf.device)
            return


def debug_nans(enable: bool = True) -> None:
    torch.autograd.set_detect_anomaly(enable)
