"""The benchmark's readers of the port's spans and cull counter
(``portbench/metrics``, ``portbench/harness/spans.py``) on hand-built traces
with known busy and idle stretches, and the interval arithmetic under them.

Times are microseconds. A card operation that starts before a span and runs
into it counts as busy inside the span."""

import sys
import types

import pytest

from portbench.harness import runner, spans, spec
from portbench.harness.tracing import Event, Trace

HOST, CARD = 1, 7


def _span(name, a, b):
    return Event(name, "user_annotation", a, b, HOST)


def _kernel(a, b, name="dist_kernel"):
    return Event(name, "kernel", a, b, CARD)


def _reading(events, span_name, window):
    return runner.Reading(cell=None, setup_s=1.0, window=window, work={"span": span_name},
                          trace=Trace(events))


def _label_trace():
    """Two passes in a 0-1000 window. Pass 1 (0-400): prep 0-100 (idle
    but for a kernel 80-120 that runs into the streams), streams 100-300
    busy to 280 and idle under no innermost span after, gather 300-350
    idle, 350-400 under no stage. Pass 2 (500-900):
    draw 500-600 idle, prep 600-650 idle, streams 650-850 busy, a frame
    850-900 idle. 400-500 lies between the passes."""
    events = [_span("bench_window", 0, 1000),
              _span("label_pass", 0, 400), _span("label_pass", 500, 900),
              _span("sampler.label", 0, 400),
              _span("sdf.culled", 0, 350), _span("sdf.prepare_mesh", 0, 100),
              _span("sdf.culled.streams", 100, 300), _span("sdf.gather", 300, 350),
              _span("sampler.draw", 500, 600),
              _span("sampler.label", 600, 900), _span("sdf.dense", 600, 850),
              _span("sdf.prepare_mesh", 600, 650), _span("sampler.frame", 850, 900),
              Event("aten::copy_", "cpu_op", 310, 340, HOST),
              _kernel(80, 120), _kernel(120, 280), _kernel(650, 850, "wind_kernel")]
    return events


def _read(name, reading):
    return spec.metric_reader(name)(reading)


def test_interval_arithmetic():
    assert spans.subtract([(0, 10), (20, 30)], [(5, 25)]) == [(0, 5), (25, 30)]
    assert spans.subtract([(0, 10)], [(-5, 2), (4, 6), (9, 12)]) == [(2, 4), (6, 9)]
    assert spans.subtract([(0, 10)], []) == [(0, 10)] and spans.subtract([], [(0, 1)]) == []
    assert spans.measure([(0, 2.5), (3, 4)]) == 3.5
    t = Trace([_kernel(-10, 5), _kernel(8, 30), _kernel(12, 14)])
    # clipped at both ends, where Trace.busy drops the one that started before
    assert spans.busy(t, 0, 20) == [(0, 5), (8, 20)] and t.busy(0, 20) == 12
    assert spans.idle(t, [(0, 10), (15, 20)], 0, 20) == 3


def test_label_prep_idle_reads_the_idle_under_the_mesh_work_per_pass():
    r = _reading(_label_trace(), "bench_window", {"epochs": 2})
    # pass 1: 0-80 idle (80-100 busy); pass 2: 600-650 idle
    assert _read("label.prep_idle_s", r) == pytest.approx((80 + 50) / 1e6 / 2)


def test_label_gather_idle_reads_the_gather_and_the_frames_per_pass():
    r = _reading(_label_trace(), "bench_window", {"epochs": 2})
    assert _read("label.gather_idle_s", r) == pytest.approx((50 + 50) / 1e6 / 2)


def test_label_idle_unnamed_share_is_the_idle_under_no_innermost_span():
    r = _reading(_label_trace(), "bench_window", {"epochs": 2})
    # idle in the passes: 0-80, 280-400, 500-650, 850-900 = 400; under no
    # innermost span (the spans of whole calls and stages do not name): 280-300, 350-400
    assert _read("label.idle_unnamed_share", r) == pytest.approx(100.0 * 70 / 400)


@pytest.mark.parametrize("name", ["label.prep_idle_s", "label.gather_idle_s",
                                  "label.idle_unnamed_share"])
def test_a_label_reader_gives_none_without_the_programs_spans_or_a_card(name):
    bare = [e for e in _label_trace() if not e.name.startswith(("sampler.", "sdf."))]
    assert _read(name, _reading(bare, "bench_window", {"epochs": 2})) is None
    hostonly = [e for e in _label_trace() if e.cat != "kernel"]
    assert _read(name, _reading(hostonly, "bench_window", {"epochs": 2})) is None


def _train_trace():
    """training_loop 0-100: epoch 1's steps 0-30 (busy 2-30), validation
    30-40 (busy 30-38), the snapshot and block end 40-55 (busy 40-42);
    epoch 2's steps 55-85 (busy 55-84), the checkpoint 85-100 idle."""
    return [_span("training_loop", 0, 100), _span("train.steps", 0, 30),
            _span("train.validate", 30, 40), _span("train.snapshot", 40, 45),
            _span("train.block_end", 45, 55), _span("train.steps", 55, 85),
            _span("train.checkpoint", 85, 100),
            _kernel(2, 30, "gemm"), _kernel(30, 38, "gemm"), _kernel(40, 42, "where"),
            _kernel(55, 84, "gemm")]


def test_epoch_boundary_idle_share_is_the_idle_outside_the_replays():
    r = _reading(_train_trace(), "training_loop", {"steps": 4})
    # outside steps and validation: 40-55 (idle 13) and 85-100 (idle 15)
    share = _read("train.epoch_boundary_idle_share", r)
    assert share == pytest.approx(28.0)
    # inside the replays: 0-2, 38-40, 84-85 idle; the whole idle share holds both
    assert _read("train.idle_share", r) == pytest.approx(33.0) and share <= 33.0
    bare = [e for e in _train_trace() if not e.name.startswith("train.")]
    assert _read("train.epoch_boundary_idle_share", _reading(bare, "training_loop", {})) is None


@pytest.mark.parametrize("pairs, want", [({"considered": 400, "kept": 100}, 25.0),
                                         ({"considered": 0, "kept": 0}, None)])
def test_cull_kept_share_reads_the_programs_counter(monkeypatch, pairs, want):
    name = "sdf_representation_tpu_torch.ops.sdf_culled"
    monkeypatch.setitem(sys.modules, name, types.SimpleNamespace(CULL_PAIRS=pairs))
    got = _read("label.cull_kept_share", _reading([], "bench_window", {"epochs": 1}))
    assert got == (pytest.approx(want) if want is not None else None)
    monkeypatch.setitem(sys.modules, name, types.SimpleNamespace())  # a program without it
    assert _read("label.cull_kept_share", _reading([], "bench_window", {"epochs": 1})) is None
