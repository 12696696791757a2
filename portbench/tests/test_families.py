"""The seam between the harness and a training configuration's model family
(``spec.family_module``): the family's initial parameters are the program's,
its counts are the hand counts, and a cell of a second family, whose module
lives beside the tests, runs through the harness as it stands
(``test_controls.py`` holds it to the same controls and faults)."""

import math
import time

import pytest
import torch

from portbench.harness import data, runner, spec
from portbench.reference import implicitnet
from portbench.tests.conftest import FAMILY_DIR, SECOND_FAMILY, second_family_cell

SHIPPED_TRAIN = ["implicitnet-8x512.train-igr", "implicitnet-8x256.train-pcd"]


def _entry(name, monkeypatch, tmp_path, seed=2**31 + 3):
    """The cell ``name`` at its own size, not set up."""
    if name == SECOND_FAMILY:
        monkeypatch.setattr(spec, "FAMILIES", FAMILY_DIR)
        cell = second_family_cell(tmp_path)
    else:
        cell = spec.resolve(name)
    return runner.make_entry(cell, seed, "cpu", str(tmp_path / "run"))


@pytest.mark.parametrize("name", SHIPPED_TRAIN + [SECOND_FAMILY])
def test_init_params_equal_the_programs_initial_parameters(name, monkeypatch, tmp_path):
    entry = _entry(name, monkeypatch, tmp_path)
    program = [p.detach() for _, p in entry._trainer(str(tmp_path / "trainer")).model.named_parameters()]
    mine = entry.family.init_params(entry.net(), data.init_seed(entry.seed), "cpu")
    assert len(mine) == len(program)
    for a, b in zip(mine, program):
        assert a.dtype == torch.float32 and a.shape == b.shape and torch.equal(a, b)


def test_work_gives_the_hand_counts(monkeypatch, tmp_path):
    big, small = 1_835_520, 459_008  # MACs of one forward pass of 8x512 and 8x256, skip at 4
    igr = _entry("implicitnet-8x512.train-igr", monkeypatch, tmp_path)
    igr.prepare()
    work = igr.work()
    assert work["shapes"] == implicitnet.layer_shapes(3, 512, 8, (4,))
    assert (work["batch"], work["loss"], work["span"]) == (16384, "IGRLOSS", "training_loop")
    assert work["flops_per_point"] == 2.0 * (6 * big - 3 * 512 - 512)
    fwd_s = 2.0 * 16384 * 2 * big / 989e12
    bwd_s = 2.0 * 16384 * (4 * big - 3 * 512 - 512) / 989e12
    assert work["igr_bound_s_per_step"] == pytest.approx(fwd_s + bwd_s, rel=1e-12)
    pcd = _entry("implicitnet-8x256.train-pcd", monkeypatch, tmp_path / "pcd")
    pcd.prepare()
    work = pcd.work()
    assert work["shapes"] == implicitnet.layer_shapes(3, 256, 8, (4,))
    eik = 16384 // 3  # the eikonal term's rows of a point-cloud batch
    assert work["flops_per_point"] == pytest.approx(
        2.0 * (3 * small - 3 * 256 + (6 * small - 3 * 256 - 256) * eik / 16384), rel=1e-12)
    assert "igr_bound_s_per_step" not in work  # float32: kernels 8-9 do not run


def test_a_family_is_named_by_its_configuration():
    assert spec.family_module({}).__file__ == implicitnet.__file__
    assert spec.family_module({"reference": "implicitnet"}).__file__ == implicitnet.__file__
    with pytest.raises(FileNotFoundError):
        spec.family_module({"reference": "no_such_family"})


def test_a_second_family_runs_through_the_harness_as_it_stands(tiny_cell):
    cell = tiny_cell(SECOND_FAMILY)
    assert cell.config["ini"]["Model"]["model"] == "HashMLP"
    out = runner.run(cell, 2**31 + 29, 1.0, False, "cpu", time.perf_counter())
    assert out["correct"] and out["attempted"] > 0 and out["failed"] == 0, out["checks"]
    assert math.isfinite(out["metrics"]["train_points_per_s"]["value"])


# every number that a tiny run of each cell compares, as the harness gave it
# before the family seam (float.hex): the seam moved code, not arithmetic
RECORDED = {
    "implicitnet-8x256.train-pcd": {
        "change_gap": "0x1.9cba442006202p-23",
        "loss_gap": "0x1.b0b94f3a9b0c9p-26",
        "steps.change_gap": "0x1.63867ae41b7c8p-24",
        "steps.grad1_gap": "0x1.5a919372f3ff1p-25",
        "steps.loss_gap": "0x0.0p+0",
    },
    "implicitnet-8x512.label": {
        "normals_off": "0x1.0000000000000p+1",
        "points_err": "0x0.0p+0",
        "sdf_err": "0x1.13dc3e0000100p-12",
    },
    "implicitnet-8x512.train-igr": {
        "best_gap": "0x1.dc136b37a77f3p-26",
        "loss_gap": "0x1.3a6d3bb93859fp-24",
        "normals_off": "0x1.0000000000000p+1",
        "points_err": "0x0.0p+0",
        "sdf_err": "0x1.65e3c80049752p-15",
        "steps.change_gap": "0x1.2d7d8778941dap-21",
        "steps.loss_gap": "0x1.08f4b64184056p-24",
        "steps.val_gap": "0x1.518d8b725b907p-24",
    },
    "implicitnet-8x512.train-sup": {
        "best_gap": "0x0.0p+0",
        "loss_gap": "0x1.600e5a839f18bp-25",
        "normals_off": "0x1.0000000000000p+1",
        "points_err": "0x0.0p+0",
        "sdf_err": "0x1.65e3c80049752p-15",
        "steps.change_gap": "0x1.6b87be9137380p-23",
        "steps.loss_gap": "0x1.f8aa659a4901dp-24",
        "steps.val_gap": "0x1.016fdf3247d82p-24",
    },
}


@pytest.mark.parametrize("name", sorted(RECORDED))
def test_the_tiny_readings_are_those_recorded(tiny_cell, name):
    out = runner.run(tiny_cell(name), 2**31 + 101, 1.0, False, "cpu", time.perf_counter())
    assert {c["name"]: float(c["value"]).hex() for c in out["checks"]} == RECORDED[name]
