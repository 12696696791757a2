"""CPU tests of the benchmark's machinery: cells by name, the result line,
the counts, the trace reader, and no fallback to the CPU."""

import json
import math
import os
import re
import subprocess
import sys
import time

import pytest

from portbench.harness import counts, result, runner, spec, tracing
from portbench.reference import implicitnet
from portbench.harness.tracing import Event, Trace

ROOT = spec.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def bench():
    return spec.load_benchmark()


def test_benchmark_json_keeps_the_contract_shape():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["portbench"] and b["command"] == ["python3", "portbench/run.py"]
    assert 1 <= b["run_seconds"] <= 51
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert c["file"].startswith("portbench/") and (ROOT / c["file"]).exists()
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0 < m["bound"] <= 0.25
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in b["per_layer"]:
        assert m["moves"] in e2e and m["source"] in ("device_trace", "program_span", "program_counter",
                                                      "host_clock")
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    pairs = [(w["config"], w["traffic"]) for w in b["workloads"]]
    assert len(set(pairs)) == len(pairs) and all(w["chips"] in (1, 4) for w in b["workloads"])
    assert all(len(w["why"]) <= 200 for w in b["workloads"])


@pytest.mark.parametrize("name", [w["name"] for w in spec.load_benchmark()["workloads"]])
def test_every_cell_resolves_its_files_by_name(name):
    cell = spec.resolve(name)
    assert cell.config and cell.traffic["entry"] in runner.ENTRIES and cell.limits
    e2e = [m["name"] for m in cell.end_to_end]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer and all(m["moves"] in e2e for m in cell.per_layer)
    for m in cell.end_to_end + cell.per_layer:
        assert callable(spec.metric_reader(m["name"]))


def test_macs_equal_the_hand_counts():
    big = implicitnet.layer_shapes(3, 512, 8, (4,))
    small = implicitnet.layer_shapes(3, 256, 8, (4,))
    assert implicitnet.macs(big) == 3 * 512 + 2 * 512 * 512 + 512 * 509 + 4 * 512 * 512 + 512 == 1_835_520
    assert implicitnet.macs(small) == 459_008
    assert implicitnet.supervised_macs(big) == 3 * 1_835_520 - 1536
    assert implicitnet.eikonal_step_macs(big) == 6 * 1_835_520 - 1536 - 512
    ops, nbytes = implicitnet.igr_fwd_cost(big, 16384)
    assert ops == 2 * 16384 * 2 * 1_835_520
    weights = sum(fi * fo * 2 + fo * 4 for fi, fo in big)
    assert nbytes == 16384 * 3 * 4 + weights + 16384 * 4 * 4
    ops, nbytes = implicitnet.igr_bwd_cost(big, 16384)
    params = sum(fi * fo + fo for fi, fo in big)
    assert nbytes == 16384 * 7 * 4 + weights + params * 4
    assert counts.bound_seconds(989e12, 0.0) == 1.0


def _synthetic():
    """A span of 100 us: kernels at 10-30 and 20-40 (overlapping) and 60-70,
    a copy at 80-85; two launches, one graph launch, one copy call."""
    return Trace([
        Event("training_loop", "user_annotation", 0.0, 100.0, 1),
        Event("aten::mm", "cpu_op", 5.0, 12.0, 1),
        Event("cudaLaunchKernel", "cuda_runtime", 6.0, 7.0, 1),
        Event("cudaGraphLaunch", "cuda_runtime", 8.0, 9.0, 1),
        Event("cudaLaunchKernel", "cuda_runtime", 54.0, 55.0, 1),
        Event("cudaMemcpyAsync", "cuda_runtime", 56.0, 57.0, 1),
        Event("aten::item", "cpu_op", 40.0, 59.0, 1),
        Event("gemm_kernel", "kernel", 10.0, 30.0, 7),
        Event("igr_fwd_kernel<128>", "kernel", 20.0, 40.0, 7),
        Event("gemm_kernel", "kernel", 60.0, 70.0, 7),
        Event("Memcpy DtoH", "gpu_memcpy", 80.0, 85.0, 7),
        Event("late_kernel", "kernel", 150.0, 160.0, 7),
    ])


def test_trace_reader_on_a_synthetic_trace():
    t = _synthetic()
    lo, hi = t.span("training_loop")
    assert (lo, hi) == (0.0, 100.0)
    assert t.busy(lo, hi) == 30.0 + 10.0 + 5.0
    assert t.host_launches(lo, hi) == (3, 1)
    assert t.kernel_time(r"igr_(fwd|bwd|dw)_kernel", lo, hi) == (20.0, 1)
    top = t.top_ops(lo, hi)
    assert top[0] == ["gemm_kernel", 30e-6] and len(top) == 3
    gaps = t.idle_gaps(lo, hi, tid=1)
    assert gaps[0] == ["aten::item", 20e-6]  # 40-60, mid 50: aten::item holds it
    assert sorted(g[1] for g in gaps) == pytest.approx([10e-6, 10e-6, 15e-6, 20e-6])
    reading = runner.Reading(cell=None, setup_s=1.0, work={"span": "training_loop",
                                                           "flops_per_point": 1e6},
                             window={"points": 989e6, "steps": 2, "seconds": 1.0}, trace=t)
    idle = spec.metric_reader("train.idle_share")(reading)
    assert idle == pytest.approx(55.0)
    assert spec.metric_reader("train.host_launches_per_step")(reading) == 1.5
    assert spec.metric_reader("train.mfu")(reading) == pytest.approx(100.0 * 989e12 / 100e-6 / 989e12)


def test_a_trace_that_lost_a_replay_or_a_steps_kernel_is_seen():
    events = [Event("training_loop", "user_annotation", 0.0, 100.0, 1),
              Event("cudaGraphLaunch", "cuda_runtime", 1.0, 2.0, 1, 11),
              Event("cudaGraphLaunch", "cuda_runtime", 30.0, 31.0, 1, 12),
              Event("cudaLaunchKernel", "cuda_runtime", 60.0, 61.0, 1, 13)]
    on_card = [Event("igr_fwd_kernel", "kernel", 3.0, 9.0, 7, 11),
               Event("igr_bwd_kernel", "kernel", 9.0, 19.0, 7, 11),
               Event("igr_fwd_kernel", "kernel", 32.0, 39.0, 7, 12),
               Event("igr_bwd_kernel", "kernel", 39.0, 49.0, 7, 12),
               Event("add_kernel", "kernel", 62.0, 64.0, 7, 13)]
    whole = Trace(events + on_card)
    per_step = ("igr_fwd_kernel", "igr_bwd_kernel")
    assert tracing.lost(whole, 0.0, 100.0, 2, per_step) == []
    lost_replay = Trace(events + on_card[:2] + on_card[4:])
    found = tracing.lost(lost_replay, 0.0, 100.0, 2, per_step)
    assert "1 of 3 launches" in found[0] and "1 of them graph" in found[0] and len(found) == 3
    lost_kernel = Trace(events + on_card[:3] + on_card[4:])
    assert tracing.lost(lost_kernel, 0.0, 100.0, 2, per_step) == ["1 kernels 'igr_bwd_kernel' in 2 steps"]
    # no correlation recorded at all: the launches cannot be matched, only counted
    bare = Trace([e._replace(corr=0) for e in events + on_card])
    assert tracing.lost(bare, 0.0, 100.0, 2, per_step) == []


def test_a_window_that_lost_the_cards_events_raises():
    with pytest.raises(tracing.NoDeviceEvents):
        tracing.check_device_events([Event("cudaLaunchKernel", "cuda_runtime", 0.0, 1.0, 1)])
    tracing.check_device_events([Event("aten::add", "cpu_op", 0.0, 1.0, 1)])


def test_result_line_has_exactly_the_contract_keys():
    plain = json.loads(result.line(True, 3, 0, {"setup_s": {"value": 1.5, "unit": "s"}},
                                   {"platform": "gpu"}, [{"name": "x", "value": 0.0, "limit": 1.0}]))
    assert list(plain) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    traced = json.loads(result.line(False, 3, 1, {}, {}, [], {"device_ops": [], "idle_gaps": []}))
    assert list(traced) == ["correct", "attempted", "failed", "metrics", "device", "breakdown", "checks"]
    assert json.loads(result.line(True, 0, 0, {}, {}, [{"name": "x", "value": math.inf, "limit": 1.0}]))


def test_a_tiny_run_on_the_cpu_prints_a_whole_line(tiny_cell):
    cell = tiny_cell("implicitnet-8x512.train-sup")
    out = runner.run(cell, 2**31 + 17, 1.0, True, "cpu", time.perf_counter())
    assert out["correct"] and out["attempted"] > 0 and out["failed"] == 0
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert out["device"]["platform"] == "cpu"
    # no device in the trace: no device metric is made up from the CPU
    assert not any(k in out["metrics"] for k in ("train.mfu", "train.idle_share"))
    line = json.loads(result.line(out["correct"], out["attempted"], out["failed"], out["metrics"],
                                  out["device"], out["checks"], out["breakdown"]))
    names = {c["name"] for c in line["checks"]}
    assert names <= set(cell.limits)
    assert {"points_err", "sdf_err", "normals_off", "loss_gap", "best_gap",
            "steps.loss_gap", "steps.val_gap", "steps.change_gap"} <= names


def test_no_card_means_no_result_and_a_failing_exit():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.run([sys.executable, "portbench/run.py", "--workload", "implicitnet-8x512.train-sup",
                           "--seed", "5", "--seconds", "1", "--trace", "0"],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert not any(line.startswith("{") for line in proc.stdout.splitlines())


def test_judge_compares_every_number_with_a_limit_and_skips_only_those_named():
    from portbench.harness import compare

    ok, checks = compare.judge({"a": 1.0, "b": 5.0}, {"a": 2.0, "not_compared": {"b": "why"}})
    assert ok and [c["name"] for c in checks] == ["a"]
    assert not compare.judge({"a": math.nan}, {"a": 2.0})[0]
    with pytest.raises(KeyError):
        compare.judge({"a": 1.0, "c": 0.0}, {"a": 2.0})
