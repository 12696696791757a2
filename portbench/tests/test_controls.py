"""The comparison that decides ``correct`` fails what it must, at a size a
CPU holds: the control (the reference one precision below, put in the
program's place), the faults planted in the reference's place, and the
faults planted in the program underneath a whole run.

The cells are the shipped ones, those of the labelled trainer that the
harness holds for a later cell, and a cell of a second model family
(``conftest.SECOND_FAMILY``), cut to CPU size (``conftest.cut``); the
limits are the tiny cells' float32 ones. On the card the same readings, at
each cell's own size, set the shipped limits (``calibrate.py``)."""

import time

import numpy as np
import pytest
import torch

from portbench import calibrate
from portbench.harness import compare, runner, spec
from portbench.tests.conftest import HARNESS_ONLY, SECOND_FAMILY

CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]] + HARNESS_ONLY + [SECOND_FAMILY]
TRAIN = [c for c in CELLS if ".train-" in c]


@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_where_the_program_passes(tiny_cell, name):
    cell = tiny_cell(name)
    seed = 2**31 + 5
    out = calibrate.readings(cell, seed, ["program", "control"], "cpu")
    assert compare.judge(out["program"], cell.limits)[0], out["program"]
    assert not compare.judge(out["control"], cell.limits)[0], out["control"]


LABELLED = [c for c in TRAIN if not c.endswith(".train-pcd")]


@pytest.mark.parametrize("name", LABELLED)
def test_the_familys_float8_forward_fails_the_training_numbers(tiny_cell, tmp_path, name):
    """A tiny labelled cell steps in float32, whose control on a CPU (no
    TF32) fails by its labels alone: the family's forward one step below
    bfloat16 fails the training numbers by itself."""
    cell = tiny_cell(name)
    entry = runner.make_entry(cell, 2**31 + 41, "cpu", str(tmp_path / "run"))
    entry.setup()
    entry.release()
    numbers = entry.train_numbers(entry.reference_fit("fp8"))
    assert not compare.judge(numbers, cell.limits)[0], numbers


@pytest.mark.parametrize("name", TRAIN)
def test_each_fault_in_the_references_place_fails(tiny_cell, name):
    cell = tiny_cell(name)
    out = calibrate.readings(cell, 77, ["fault_half", "fault_unchanged", "fault_altered"], "cpu")
    for variant, numbers in out.items():
        assert not compare.judge(numbers, cell.limits)[0], (variant, numbers)


def _state_unchanged(monkeypatch, entry):
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)


def _half_batch(monkeypatch, entry):
    if entry.pointcloud:
        from sdf_representation_tpu_torch.training import pcd_trainer

        original = pcd_trainer.pcd_loss

        def half(apply, model, xb, idx, noise, grad_lambda, mesh=None):
            n = xb.shape[0] // 2
            keep = idx < n
            return original(apply, model, xb[:n], idx[keep], noise[keep], grad_lambda, mesh)

        monkeypatch.setattr(pcd_trainer, "pcd_loss", half)
        return
    from sdf_representation_tpu_torch.losses import losses

    cls = losses.get_loss_class(entry.loss_name)
    original = cls.__call__

    def half(self, model, x, y, epoch, generator=None, aux=None):
        n = x.shape[0] // 2
        return original(self, model, x[:n], y[:n], epoch, generator=generator, aux=aux)

    monkeypatch.setattr(cls, "__call__", half)


def _answer_altered(monkeypatch, entry):
    if getattr(entry, "pointcloud", False):
        from sdf_representation_tpu_torch.training import pcd_trainer

        original = pcd_trainer.pcd_loss
        monkeypatch.setattr(pcd_trainer, "pcd_loss", lambda *a, **k: original(*a, **k) * 1.01)
        return
    from sdf_representation_tpu_torch.sampling import sampler

    original = sampler._label

    def altered(points, mesh, device=None):
        frame = original(points, mesh, device)
        frame.values[::7, 3] += 0.05
        return frame

    monkeypatch.setattr(sampler, "_label", altered)


def _labels_half_missing(monkeypatch, entry):
    from sdf_representation_tpu_torch.sampling import sampler

    original = sampler.signed_distance

    def half(points, mesh, **kw):
        sdf, normals = original(points, mesh, **kw)
        sdf = np.array(sdf)
        sdf[len(sdf) // 2:] = 0.0
        return sdf, normals

    monkeypatch.setattr(sampler, "signed_distance", half)


FAULTS = [(name, fault) for name in TRAIN for fault in (_state_unchanged, _half_batch, _answer_altered)]
FAULTS += [("implicitnet-8x512.label", _answer_altered), ("implicitnet-8x512.label", _labels_half_missing)]


@pytest.mark.parametrize("name,fault", FAULTS, ids=[f"{n}-{f.__name__}" for n, f in FAULTS])
def test_a_run_with_the_program_broken_underneath_is_not_correct(tiny_cell, monkeypatch, name, fault):
    cell = tiny_cell(name)
    out = runner.run(cell, 4242, 1.0, False, "cpu", time.perf_counter(),
                     entry_hook=lambda entry: fault(monkeypatch, entry))
    assert not out["correct"], out["checks"]
