"""Card-idle time under the program's spans, read from a traced window.

The port names its stages with profiler ranges (``utils/profiling.span``:
``sampler.*``, ``sdf.*``, ``train.*``) on the clock of the card's events. A
reader takes the union of the spans it names inside a window and measures
how long nothing ran on the card there. The card's operations are clipped
at both ends of the window, so one that starts before an interval and runs
into it counts as busy there (``Trace.busy`` counts only the operations
that start inside its span). Where the program opens no such span (a
version without them), ``named`` is empty and the reader returns None.
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

from .tracing import DEVICE, Trace, union

Interval = Tuple[float, float]
SPAN_CATS = ("user_annotation", "cpu_op")


def named(trace: Trace, match: Callable[[str], bool], lo: float, hi: float) -> List[Interval]:
    """The union of the host's spans whose name ``match``es, clipped to [lo, hi)."""
    return union([(max(e.start, lo), min(e.end, hi)) for e in trace.events
                  if e.cat in SPAN_CATS and e.start < hi and e.end > lo and match(e.name)])


def busy(trace: Trace, lo: float, hi: float) -> List[Interval]:
    """The union of the card's operations, each clipped to [lo, hi)."""
    return union([(max(e.start, lo), min(e.end, hi)) for e in trace.events
                  if e.cat in DEVICE and e.start < hi and e.end > lo])


def measure(intervals: Sequence[Interval]) -> float:
    return sum(b - a for a, b in intervals)


def subtract(keep: Sequence[Interval], cut: Sequence[Interval]) -> List[Interval]:
    """``keep`` less ``cut``, both unions (sorted, disjoint)."""
    out: List[Interval] = []
    j = 0
    for a, b in keep:
        while j < len(cut) and cut[j][1] <= a:
            j += 1
        k, at = j, a
        while k < len(cut) and cut[k][0] < b:
            if cut[k][0] > at:
                out.append((at, cut[k][0]))
            at = max(at, cut[k][1])
            k += 1
        if at < b:
            out.append((at, b))
    return out


def idle(trace: Trace, intervals: Sequence[Interval], lo: float, hi: float) -> float:
    """Microseconds of ``intervals`` (a union inside [lo, hi)) with nothing on the card."""
    return measure(subtract(intervals, busy(trace, lo, hi)))
