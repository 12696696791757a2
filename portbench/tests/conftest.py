"""Tiny cells for the CPU tests: the shipped configurations and mixes at
small sizes (a coarse impeller, the family's ``TINY`` net, batches of 64)."""

import copy
import json
import os
import sys
from pathlib import Path

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

# a cell of a second model family, made as a later configuration would be
# made: a configuration file whose "reference" names the family, a shipped
# mix, and the family's module, which lives beside the tests (``families/``)
# where a configuration of the benchmark has it under ``reference/``
FAMILY_DIR = Path(__file__).resolve().parent / "families"
SECOND_FAMILY = "hashmlp-3x64.train-sup"


def hashmlp_config() -> dict:
    """The port's HashMLP at the sizes of ``configs/mesh_sdf_hash.ini`` (a
    3x64 MLP, lr 0.005), on the flagship's shape, points and schedule."""
    config = json.loads((spec.BENCH_DIR / "configs" / "implicitnet-8x512.json").read_text())
    config["reference"] = "hashmlp"
    config["ini"]["Model"] = {"model": "HashMLP", "hidden_dim": 64, "num_hidden_layers": 3, "input_dim": 3,
                              "skip_connection": 4, "beta": 100, "geometric_init": "True"}
    config["ini"]["Training"]["lr"] = 0.005
    return config


def second_family_cell(directory: Path) -> spec.Cell:
    """``SECOND_FAMILY`` put together by ``spec.assemble`` from its
    configuration, written into ``directory``, and listed, as a later
    ``BENCHMARK.json`` would list it, in the ``workloads`` of every metric
    of the point-cloud cell (those of any trainer): ``BENCHMARK.json``
    gains nothing."""
    config_name, traffic = SECOND_FAMILY.split(".", 1)
    path = directory / f"{config_name}.json"
    path.write_text(json.dumps(hashmlp_config()))
    bench = spec.load_benchmark()
    bench["configs"].append({"name": config_name, "source": "configs/mesh_sdf_hash.ini", "file": str(path),
                             "reduced": [], "why": "a second model family"})
    for metric in bench["end_to_end"] + bench["per_layer"]:
        if "implicitnet-8x256.train-pcd" in metric.get("workloads", ()):
            metric["workloads"].append(SECOND_FAMILY)
    return spec.assemble(bench, SECOND_FAMILY, config_name, traffic)


def tiny(name: str) -> spec.Cell:
    """The cell ``name`` cut to CPU size. A cell of ``HARNESS_ONLY`` is put
    together from its configuration and mix."""
    if name in HARNESS_ONLY:
        config, traffic = name.split(".", 1)
        return cut(spec.assemble(spec.load_benchmark(), name, config, traffic))
    return cut(spec.resolve(name))


def cut(cell: spec.Cell) -> spec.Cell:
    """A copy of ``cell`` at CPU size: its family's ``TINY`` net, float32
    steps (the CPU has no bfloat16 path to hold to the bfloat16 limits), the
    same code."""
    cell = copy.deepcopy(cell)
    cfg = cell.config
    cfg["geometry"]["resolution"] = 14
    ini = cfg["ini"]
    ini["Model"].update(spec.family_module(cfg).TINY)
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
def tiny_cell(monkeypatch, tmp_path):
    """``tiny``, and ``SECOND_FAMILY`` cut alike, its family found beside the tests."""
    def make(name: str) -> spec.Cell:
        if name != SECOND_FAMILY:
            return tiny(name)
        monkeypatch.setattr(spec, "FAMILIES", FAMILY_DIR)
        return cut(second_family_cell(tmp_path))

    return make
