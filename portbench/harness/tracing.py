"""The traced run: a ``torch.profiler`` window, and what is read from it.

The profiler records the host's operations and, through CUPTI, every
operation on the card, also those a CUDA-graph replay runs. The events are
read in memory (nothing is written to disk) into plain ``Event`` rows with
times in microseconds. A window whose host put work on the card and whose
trace holds no event of the card raises ``NoDeviceEvents``: such a trace
would read as an idle card.

Busy time is the union of the intervals of the card's operations (kernels,
copies, sets); idle is the rest of a span. A host launch is a runtime or
driver call that launches a kernel, a copy or a set outside a graph; a graph
launch is counted apart.

A trace can also lose part of the card's events: whole graph replays were
seen missing in dense traces. ``lost`` finds such a window: a launch of a
kernel or a graph on the host whose correlation id no operation of the card
carries, and kernels that every step runs alike whose count in the span is
not a whole multiple of the steps. The runner then traces the window again.
"""

from __future__ import annotations

import contextlib
import re
from typing import Iterator, List, NamedTuple, Optional, Sequence, Tuple

DEVICE = ("kernel", "gpu_memcpy", "gpu_memset")
HOST = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
LAUNCH = re.compile(r"cu(da)?(LaunchKernel|Memcpy|Memset)")
GRAPH_LAUNCH = re.compile(r"cu(da)?GraphLaunch")
NAME_CHARS = 120  # a breakdown keeps this much of an operation's name


class Event(NamedTuple):
    name: str
    cat: str
    start: float  # microseconds
    end: float
    tid: int
    corr: int = 0  # the profiler's correlation id: a launch and what it ran share it


class NoDeviceEvents(RuntimeError):
    """The host put work on the card and the trace holds none of the card's events."""


def check_device_events(events: Sequence[Event]) -> None:
    launched = sum(1 for e in events if e.cat in ("cuda_runtime", "cuda_driver")
                   and (LAUNCH.match(e.name) or GRAPH_LAUNCH.match(e.name)))
    on_card = sum(1 for e in events if e.cat in DEVICE)
    if launched and not on_card:
        raise NoDeviceEvents(f"the profiler recorded {launched} launches on the host and no "
                             "operation on the card: its trace would read as an idle card")


class Recording:
    events: List[Event]


@contextlib.contextmanager
def record(cuda: bool = True) -> Iterator[Recording]:
    """Profile the block; on exit ``recording.events`` holds its events."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    out = Recording()
    with profile(activities=activities) as prof:
        yield out
    out.events = events_of(prof.profiler.kineto_results.events())
    if cuda:
        check_device_events(out.events)


def _category(name: str, on_card: bool, annotation: bool) -> str:
    if not on_card:
        if annotation:
            return "user_annotation"
        return "cuda_runtime" if name.startswith(("cuda", "cu")) else "cpu_op"
    if annotation:
        return "gpu_user_annotation"
    if name.startswith("Memcpy"):
        return "gpu_memcpy"
    if name.startswith("Memset"):
        return "gpu_memset"
    return "kernel"


def events_of(raw) -> List[Event]:
    """Plain rows of the profiler's events. The category comes from the side
    (host or card), the name, and whether the event is an annotation: a
    card-side event that bears a host event's name is the card's copy of a
    ``record_function`` range, not an operation."""
    import torch

    raw = list(raw)
    cuda = torch.autograd.DeviceType.CUDA
    host_names = {e.name() for e in raw if e.device_type() != cuda}
    out = []
    for e in raw:
        on_card = e.device_type() == cuda
        flagged = getattr(e, "is_user_annotation", None)
        annotation = (flagged() if flagged is not None else False) or (on_card and e.name() in host_names)
        out.append(Event(e.name(), _category(e.name(), on_card, annotation), e.start_ns() / 1e3,
                         e.end_ns() / 1e3, int(e.start_thread_id()), _correlation(e, on_card)))
    return out


def _correlation(e, on_card: bool) -> int:
    """The id that ties a launch on the host to what it ran on the card."""
    for name in ("correlation_id", "linked_correlation_id"):
        get = getattr(e, name, None)
        value = int(get()) if get is not None else 0
        if value > 0:
            return value
    return 0


def lost(trace: "Trace", lo: float, hi: float, steps: int,
         per_step: Sequence[str] = ()) -> List[str]:
    """What the card's events in [lo, hi) lack, in words; empty where
    nothing is seen missing. ``per_step``: patterns of kernels that each step
    runs the same number of times."""
    out = []
    on_card = {e.corr for e in trace.events if e.cat in DEVICE and e.corr}
    launches = [e for e in trace.events if e.cat in ("cuda_runtime", "cuda_driver") and lo <= e.start < hi
                and e.corr and (GRAPH_LAUNCH.match(e.name) or e.name.startswith(("cudaLaunchKernel",
                                                                                "cuLaunchKernel")))]
    missing = [e for e in launches if e.corr not in on_card]
    if missing and len(missing) < len(launches):  # none matched: the ids are not recorded
        graphs = sum(1 for e in missing if GRAPH_LAUNCH.match(e.name))
        out.append(f"{len(missing)} of {len(launches)} launches ran nothing on the card "
                   f"({graphs} of them graph launches)")
    for pattern in per_step:
        _, n = trace.kernel_time(pattern, lo, hi)
        if n % max(1, steps):
            out.append(f"{n} kernels {pattern!r} in {steps} steps")
    return out


def union(intervals: Sequence[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            if b > merged[-1][1]:
                merged[-1] = (merged[-1][0], b)
        else:
            merged.append((a, b))
    return merged


class Trace:
    """Events of one traced window, read over a span of it."""

    def __init__(self, events: Sequence[Event]):
        self.events = list(events)

    def spans(self, name: str) -> List[Tuple[float, float]]:
        return sorted((e.start, e.end) for e in self.events
                      if e.cat in ("user_annotation", "cpu_op") and e.name == name)

    def span(self, name: str) -> Tuple[float, float]:
        """The whole of the annotations named ``name``: first start to last end."""
        found = self.spans(name)
        if not found:
            raise LookupError(f"the trace holds no span {name!r}")
        return found[0][0], max(b for _, b in found)

    def device_ops(self, lo: float, hi: float) -> List[Event]:
        """The card's operations that start inside [lo, hi), cut at hi."""
        return [e._replace(end=min(e.end, hi)) for e in self.events
                if e.cat in DEVICE and lo <= e.start < hi]

    def busy(self, lo: float, hi: float) -> float:
        """Microseconds in which an operation ran on the card."""
        return sum(b - a for a, b in union([(e.start, e.end) for e in self.device_ops(lo, hi)]))

    def kernel_time(self, pattern: str, lo: float, hi: float) -> Tuple[float, int]:
        """(summed microseconds, count) of the kernels whose name matches."""
        found = [e for e in self.device_ops(lo, hi) if e.cat == "kernel" and re.search(pattern, e.name)]
        return sum(e.end - e.start for e in found), len(found)

    def host_launches(self, lo: float, hi: float) -> Tuple[int, int]:
        """(launches outside graphs, graph launches) the host made in [lo, hi)."""
        calls = [e.name for e in self.events
                 if e.cat in ("cuda_runtime", "cuda_driver") and lo <= e.start < hi]
        return (sum(1 for n in calls if LAUNCH.match(n)),
                sum(1 for n in calls if GRAPH_LAUNCH.match(n)))

    def top_ops(self, lo: float, hi: float, k: int = 10) -> List[List]:
        """The k operations on the card that took most time: [[name, seconds]]."""
        total = {}
        for e in self.device_ops(lo, hi):
            name = e.name[:NAME_CHARS]
            total[name] = total.get(name, 0.0) + (e.end - e.start)
        return [[n, t / 1e6] for n, t in sorted(total.items(), key=lambda kv: -kv[1])[:k]]

    def idle_gaps(self, lo: float, hi: float, k: int = 10,
                  tid: Optional[int] = None) -> List[List]:
        """The k longest stretches of [lo, hi) with nothing on the card, each
        named by the innermost host operation under way at its middle (on
        thread ``tid``, where given): [[name, seconds]]."""
        busy = union([(e.start, e.end) for e in self.device_ops(lo, hi)])
        gaps, at = [], lo
        for a, b in busy:
            if a > at:
                gaps.append((at, a))
            at = max(at, b)
        if hi > at:
            gaps.append((at, hi))
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:k]
        host = [e for e in self.events if e.cat in HOST and (tid is None or e.tid == tid)]
        out = []
        for a, b in gaps:
            mid = (a + b) / 2
            under = [e for e in host if e.start <= mid < e.end]
            name = max(under, key=lambda e: e.start).name if under else "(no host operation)"
            out.append([name[:NAME_CHARS], (b - a) / 1e6])
        return out

    def thread_of(self, span_name: str) -> Optional[int]:
        for e in self.events:
            if e.cat in ("user_annotation", "cpu_op") and e.name == span_name:
                return e.tid
        return None
