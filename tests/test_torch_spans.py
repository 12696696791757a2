"""The port's spans (``utils/profiling.span``) and its cull counter, on the CPU.

``span`` opens a profiler range only while a profiler records, nests, and
writes its block's host seconds into a stage dict. Under a CPU profiler a
small labelling pass that takes both exact-SDF methods records the
sampler's and the methods' spans nested as the trace readers of
``portbench/metrics`` expect, with the ``LAST_STAGE_SECONDS`` keys kept. A
tiny eager run of each trainer shows one ``train.steps`` span an epoch
inside ``training_loop`` and none per step. ``sdf_culled.CULL_PAIRS`` sums
over calls and resets with its own reset."""

import inspect

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from sdf_representation_tpu_torch.configgen import Configuration
from sdf_representation_tpu_torch.geometry.primitives import make_icosphere
from sdf_representation_tpu_torch.ops import sdf_culled, sdf_exact
from sdf_representation_tpu_torch.ops import sdf_streams as ss
from sdf_representation_tpu_torch.sampling import sampler
from sdf_representation_tpu_torch.training import PointCloudTrainer, Trainer
from sdf_representation_tpu_torch.utils import profiling
from tests.test_torch_pcd_trainer import _cloud, _config
from tests.test_trainer import sphere_dataset, tiny_config

torch.set_num_threads(2)
CULLED_STAGES = ("host_prep", "coarse_bound", "cull", "streams", "dipole", "refine")


def _spans(prof, prefixes=("sampler.", "sdf.", "train.", "training_loop", "outer", "inner")):
    """(name, start, end) of the profiler's ranges whose name starts with one of ``prefixes``."""
    return [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
            if e.name.startswith(prefixes)]


def _inside(child, parents):
    return any(p[1] <= child[1] and child[2] <= p[2] for p in parents)


def _named(spans, name):
    return [s for s in spans if s[0] == name]


def test_span_opens_no_range_without_a_profiler(monkeypatch):
    opened = []
    monkeypatch.setattr(torch.profiler, "record_function", lambda name: opened.append(name))
    with profiling.span("outer"):
        with profiling.span("inner"):
            pass
    assert opened == []


def test_span_opens_nested_ranges_under_a_profiler():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("outer"):
            with profiling.span("inner"):
                torch.ones(4).sum()
            with profiling.span("inner"):
                pass
    spans = _spans(prof)
    (outer,) = _named(spans, "outer")
    inner = _named(spans, "inner")
    assert len(inner) == 2 and all(_inside(s, [outer]) for s in inner)


@pytest.mark.parametrize("key", [None, "sample"])
def test_span_writes_its_host_seconds_under_the_key_or_the_name(key):
    stages = {"kept": 1.0}
    with profiling.span("sampler.draw", stages, key):
        x = sum(range(1000))
    assert x and stages["kept"] == 1.0
    assert set(stages) == {"kept", key or "sampler.draw"} and stages[key or "sampler.draw"] >= 0.0


def test_span_closes_its_range_when_the_block_raises():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with pytest.raises(ValueError):
            with profiling.span("outer", {}):
                raise ValueError("inside")
        with profiling.span("inner"):
            pass
    spans = _spans(prof)
    (outer,), (inner,) = _named(spans, "outer"), _named(spans, "inner")
    assert outer[2] <= inner[1]


@pytest.fixture(scope="module")
def labelling_pass():
    """A labelling pass of icosphere(3) under a CPU profiler: the surface and
    narrow-band points (2,560 each) through the culled method, the 300
    uniform points through the dense one."""
    mesh = make_icosphere(subdivisions=3, radius=0.6)
    plain = sdf_exact.signed_distance

    def labels(points, mesh, device=None):
        if len(points) > 1000:
            return plain(points, mesh, device=device, method="culled", tri_chunk=64,
                         point_chunk=512)
        return plain(points, mesh, device=device, method="dense")

    sampler.LAST_STAGE_SECONDS.clear()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sampler, "signed_distance", labels)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            frames = sampler.generate_signed_distance_data(mesh, 300, 2, 2, 0.1, seed=3,
                                                           device="cpu")
    return frames, _spans(prof), dict(sampler.LAST_STAGE_SECONDS), dict(sdf_culled.LAST_STAGE_SECONDS)


def test_a_labelling_pass_records_the_sampler_spans(labelling_pass):
    frames, spans, stages, _ = labelling_pass
    assert [len(f) for f in frames] == [300, 2560, 2560]
    (draw,), (label,) = _named(spans, "sampler.draw"), _named(spans, "sampler.label")
    assert draw[2] <= label[1]
    frame = _named(spans, "sampler.frame")
    assert len(frame) == 3 and all(_inside(s, [label]) for s in frame)
    assert set(stages) == {"sample", "label"} and stages["label"] > 0.0


def test_a_labelling_pass_records_both_methods_and_their_stages(labelling_pass):
    _, spans, _, culled_stages = labelling_pass
    (label,) = _named(spans, "sampler.label")
    culled, dense = _named(spans, "sdf.culled"), _named(spans, "sdf.dense")
    assert len(culled) == 2 and len(dense) == 1
    assert all(_inside(s, [label]) for s in culled + dense)
    for stage in CULLED_STAGES:
        found = _named(spans, f"sdf.culled.{stage}")
        assert len(found) == 2 and all(_inside(s, culled) for s in found), stage
    assert set(culled_stages) == set(CULLED_STAGES)
    host_prep, refine = _named(spans, "sdf.culled.host_prep"), _named(spans, "sdf.culled.refine")
    # the shared spans: mesh work, uploads and the labels back, in both methods
    for name, per_call, parents in (("sdf.prepare_mesh", 1, host_prep), ("sdf.gather", 1, refine)):
        found = _named(spans, name)
        assert len(found) == 3 * per_call and all(_inside(s, parents + dense) for s in found), name
        assert sum(_inside(s, dense) for s in found) == per_call
    # the points and the triangles, each call
    uploads = _named(spans, "sdf.upload")
    assert sum(_inside(s, dense) for s in uploads) == 2 and sum(_inside(s, culled) for s in uploads) == 4
    # each span names one call's work: nothing of one method inside the other
    assert not any(_inside(s, dense) for s in _named(spans, "sdf.culled.cull"))


def test_the_streams_schedule_opens_its_span_on_the_launch_path_only():
    # the CPU takes the plain streams: no packing for the kernels, no span
    blocks = torch.zeros((1, 8, 3))
    tables, _ = sdf_exact._triangle_tables(np.eye(3), np.array([[0, 1, 2]]), 4)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        ss.dist_stream(blocks, np.array([0], np.int32), np.array([0], np.int32), tables, 4)
    assert _named(_spans(prof), "sdf.streams.schedule") == []


def _trainer_spans(train):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        train()
    return _spans(prof)


def _assert_epoch_spans(spans, epochs, blocks, per_epoch):
    (loop,) = _named(spans, "training_loop")
    steps = _named(spans, "train.steps")
    assert len(steps) == epochs and all(_inside(s, [loop]) for s in steps)
    ours = [s for s in spans if s[0].startswith("train.")]
    assert all(_inside(s, [loop]) for s in ours)
    # one range an epoch or a block: never one a step or a validation batch
    assert len(ours) == per_epoch * epochs + 2 * blocks
    assert not any(_inside(s, steps) for s in ours if s[0] != "train.steps")


def test_the_labelled_trainer_opens_one_steps_span_an_epoch(tmp_path):
    tiny_config(tmp_path, epochs=4, checkpointing=2)
    cfg = Configuration(str(tmp_path / "c.ini"))
    cfg.epochs_per_call = 2
    trainer = Trainer(cfg, device="cpu")
    dataset = sphere_dataset(n=4000)  # 7 steps of 512 and a validation batch an epoch
    spans = _trainer_spans(lambda: trainer.train(dataset, eager=True))
    _assert_epoch_spans(spans, epochs=4, blocks=2, per_epoch=3)
    assert len(_named(spans, "train.validate")) == len(_named(spans, "train.snapshot")) == 4
    assert len(_named(spans, "train.block_end")) == len(_named(spans, "train.checkpoint")) == 2


def test_the_point_cloud_trainer_opens_one_steps_span_an_epoch(tmp_path):
    trainer = PointCloudTrainer(Configuration(_config(tmp_path, epochs=3, checkpointing=2)),
                                device="cpu")
    spans = _trainer_spans(lambda: trainer.train(_cloud(), eager=True))  # 4 steps an epoch
    _assert_epoch_spans(spans, epochs=3, blocks=3, per_epoch=1)
    assert len(_named(spans, "train.block_end")) == len(_named(spans, "train.checkpoint")) == 3


def test_the_cull_counter_sums_over_calls_and_resets_by_itself():
    mesh = make_icosphere(subdivisions=2, radius=0.6)
    pts = np.random.default_rng(1).uniform(-1, 1, (1500, 3))
    sdf_culled.reset_cull_pairs()
    assert sdf_culled.CULL_PAIRS == {"considered": 0, "kept": 0}
    calls = []
    for n in (1500, 700):
        sdf_culled.signed_distance_culled(pts[:n], mesh, point_chunk=256, tri_chunk=32,
                                          device="cpu")
        c = sdf_culled.LAST_COUNTS
        calls.append((c["blocks"] * c["dist_chunks"], c["sum_kd"]))
    assert sdf_culled.CULL_PAIRS == {"considered": calls[0][0] + calls[1][0],
                                     "kept": calls[0][1] + calls[1][1]}
    assert 0 < sdf_culled.CULL_PAIRS["kept"] <= sdf_culled.CULL_PAIRS["considered"]
    ss.reset_launches()  # the streams' counters are apart
    assert sdf_culled.CULL_PAIRS["considered"] == calls[0][0] + calls[1][0]
    sdf_culled.reset_cull_pairs()
    assert set(sdf_culled.CULL_PAIRS.values()) == {0}


def test_the_culled_method_waits_for_no_card():
    # its stages are host seconds; a trace gives the card's share of each
    assert "synchronize" not in inspect.getsource(sdf_culled)
    mesh = make_icosphere(subdivisions=2, radius=0.6)
    pts = np.random.default_rng(2).uniform(-1, 1, (600, 3))
    sdf_culled.signed_distance_culled(pts, mesh, point_chunk=256, tri_chunk=32, device="cpu")
    assert set(sdf_culled.LAST_STAGE_SECONDS) == set(CULLED_STAGES)
