"""One run of one cell: set-up, the window, the check, the result line.

``setup_s`` runs from the process's start (``run.py`` reads the clock
before any import) to the end of set-up. With ``--trace 1`` the window is
recorded by the profiler, and its length is the mix's ``trace_seconds``:
the per-layer metrics are read from that window. A trace that lost part of
the card's events (``tracing.lost``) is taken again, up to
``TRACE_ATTEMPTS`` times in all; the run fails where none is whole. Once the
window has closed the card's peak memory is read, the program's state is
dropped, and the reference runs.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import sys
import tempfile
import time
from typing import Dict, Optional

import torch

from . import compare, result, spec, tracing
from .label_cell import LabelCell
from .train_cell import TrainCell

ENTRIES = {"train": TrainCell, "label": LabelCell}
TRACE_ATTEMPTS = 3


@dataclasses.dataclass
class Reading:
    """What a metric's reader reads."""

    cell: spec.Cell
    setup_s: float
    window: Dict
    work: Dict
    trace: Optional[tracing.Trace] = None

    def span(self):
        """(lo, hi) microseconds of the window's span in the trace."""
        return self.trace.span(self.work["span"])

    def device_span(self):
        """The span, where the trace holds operations of the card in it; else None."""
        if self.trace is None:
            return None
        lo, hi = self.span()
        return (lo, hi) if self.trace.device_ops(lo, hi) else None


def make_entry(cell: spec.Cell, seed: int, device: str, run_dir: str):
    return ENTRIES[cell.traffic["entry"]](cell, seed, device, run_dir)


def run(cell: spec.Cell, seed: int, seconds: float, trace: bool, device: str, t0: float,
        entry_hook=None) -> Dict:
    """The result line's fields. ``entry_hook(entry)`` may change the entry
    before set-up (the tests break the program underneath with it)."""
    run_dir = tempfile.mkdtemp(prefix="portbench-", dir=os.environ.get("TMPDIR"))
    try:
        entry = make_entry(cell, seed, device, run_dir)
        if entry_hook is not None:
            entry_hook(entry)
        entry.setup()
        cuda = torch.device(device).type == "cuda"
        if cuda:
            torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        print(f"set-up {setup_s:.3f} s, stages: "
              + ", ".join(f"{k} {v:.3f}" for k, v in getattr(entry, "stages", {}).items()),
              file=sys.stderr, flush=True)
        n = entry.epochs_for(float(cell.traffic["trace_seconds"]) if trace else seconds)
        work = entry.work()
        trace_obj = None
        if trace:
            window, trace_obj = _traced_window(entry, n, cell, work, cuda)
        else:
            window = entry.window(n)
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        entry.release()
        reading = Reading(cell, setup_s, window, work, trace_obj)
        device_info = {"platform": "gpu" if cuda else "cpu",
                       "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                       "count": cell.chips, "memory_peak_bytes": int(peak)}
        breakdown = None
        if trace:
            metrics = _read(cell.per_layer, reading)
            lo, hi = reading.span()
            device_info.update(busy_s=reading.trace.busy(lo, hi) / 1e6, window_s=(hi - lo) / 1e6)
            tid = reading.trace.thread_of(work["span"])
            breakdown = {"device_ops": reading.trace.top_ops(lo, hi),
                         "idle_gaps": reading.trace.idle_gaps(lo, hi, tid=tid)}
        else:
            metrics = _read(cell.end_to_end, reading)
        numbers = entry.check()
        correct, checks = compare.judge(numbers, cell.limits)
        return {"correct": correct, "attempted": window["steps"], "failed": window["failed"],
                "metrics": metrics, "device": device_info, "checks": checks,
                "breakdown": breakdown}
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)


def _traced_window(entry, n: int, cell: spec.Cell, work: Dict, cuda: bool):
    """The window under the profiler, taken again where the trace lost events."""
    per_step = [p for m in cell.per_layer for p in getattr(spec.metric_module(m["name"]), "PER_STEP", ())]
    for attempt in range(1, TRACE_ATTEMPTS + 1):
        with tracing.record(cuda=cuda) as rec:
            window = entry.window(n)
        trace = tracing.Trace(rec.events)
        if not cuda:
            return window, trace
        lo, hi = trace.span(work["span"])
        missing = tracing.lost(trace, lo, hi, window["steps"], per_step)
        print(f"trace {attempt}: {len(trace.events)} events, "
              + ("; ".join(missing) if missing else "nothing seen missing"), file=sys.stderr, flush=True)
        if not missing:
            return window, trace
    raise tracing.NoDeviceEvents(f"{TRACE_ATTEMPTS} traces of the window all lost events of the card")


def _read(metrics, reading: Reading) -> Dict[str, Dict]:
    out = {}
    for m in metrics:
        value = spec.metric_reader(m["name"])(reading)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def main(args, t0: float) -> int:
    cell = spec.resolve(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}: no result",
              file=sys.stderr)
        return 2
    out = run(cell, args.seed, float(args.seconds), bool(args.trace), "cuda", t0)
    found = result.forbidden_modules()
    if found:
        print(f"the run loaded {found}: the benchmark measures the port alone; no result",
              file=sys.stderr)
        return 3
    result.print_checks(out["checks"])
    print(result.line(out["correct"], out["attempted"], out["failed"], out["metrics"],
                      out["device"], out["checks"], out["breakdown"]), flush=True)
    return 0
