"""Tiny cells for the CPU tests: the shipped configurations and mixes at
small sizes (a coarse impeller, a 4x32 net, batches of 64)."""

import copy
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench.harness import spec  # noqa: E402

LIMITS = {"points_err": 0.0, "sdf_err": 2e-4, "normals_off": 2.0, "loss_gap": 1e-5,
          "best_gap": 1e-5, "change_gap": 1e-4, "steps.loss_gap": 1e-5, "steps.val_gap": 1e-5,
          "steps.grad1_gap": 1e-4, "steps.change_gap": 1e-4}


# cells of the shipped configurations and mixes that BENCHMARK.json does not
# list (PERF.md says why): the labelled trainer's path of the harness
HARNESS_ONLY = ["implicitnet-8x512.train-sup"]


def tiny(name: str) -> spec.Cell:
    """The cell ``name`` cut to CPU size: float32 steps (the CPU has no
    bfloat16 path to hold to the bfloat16 limits), the same code. A cell of
    ``HARNESS_ONLY`` is put together from its configuration and mix."""
    if name in HARNESS_ONLY:
        config, traffic = name.split(".", 1)
        cell = spec.assemble(spec.load_benchmark(), name, config, traffic)
    else:
        cell = spec.resolve(name)
    cell = copy.deepcopy(cell)
    cfg = cell.config
    cfg["geometry"]["resolution"] = 14
    ini = cfg["ini"]
    ini["Model"].update(hidden_dim=32, num_hidden_layers=4, skip_connection=2)
    ini["Training"].update(batch_size=64)
    # float32 on the CPU: the labelled steps by name; the point-cloud trainer
    # runs float32 there whatever it names, and naming bfloat16 picks the
    # float8 control (a CPU has no TF32 to be the control of float32)
    precision = "bfloat16" if cell.traffic.get("trainer") == "pointcloud" else "default"
    ini["TPU"] = {**ini.get("TPU", {}), "train_matmul_precision": precision}
    if ini["Sampling"]["uniform_points"]:
        ini["Sampling"].update(uniform_points=200, surface=1, narrowband=1)
    cell.traffic["nominal_points_per_s"] = 1.0
    cell.traffic["trace_seconds"] = 1
    if "cloud_per_face" in cell.traffic:
        cell.traffic["cloud_per_face"] = 1
    if "check" in cell.traffic:
        cell.traffic["check"] = {"passes": 2, "rows_per_pass": 128}
    cell.limits = dict(LIMITS)
    return cell


@pytest.fixture
def tiny_cell():
    return tiny
