"""Cells by name: ``BENCHMARK.json`` and the data files under ``portbench/``.

A cell (a ``workloads`` entry) names a configuration, whose file is
``configs/<config>.json`` as ``BENCHMARK.json`` lists it, and a traffic mix,
``traffic/<traffic>.json``. Its limits for ``correct`` are
``limits/<cell>.json``. A per-layer metric is read by ``metrics/<name>.py``,
whose ``read(reading)`` returns a number or None. A training
configuration's model family is the plain reference that its file's
``"reference"`` key names, ``reference/<name>.py`` (``implicitnet`` where
the key is absent). Adding a cell, a configuration, a family, a mix or a
metric adds files and entries; nothing here changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent
FAMILIES = BENCH_DIR / "reference"
DEFAULT_FAMILY = "implicitnet"


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: Dict
    traffic_name: str
    traffic: Dict
    limits: Dict
    end_to_end: List[Dict]
    per_layer: List[Dict]


def load_benchmark(root: Path = ROOT) -> Dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _applies(metric: Dict, cell: str, reported: List[str]) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves") in reported if "moves" in metric else True


def resolve(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json``."""
    bench = load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: {sorted(cells)}")
    w = cells[name]
    return assemble(bench, name, w["config"], w["traffic"], int(w["chips"]), root)


def assemble(bench: Dict, name: str, config: str, traffic: str, chips: int = 1,
             root: Path = ROOT) -> Cell:
    """A cell of a listed configuration and a mix, by their names; its
    limits where ``limits/<name>.json`` holds them."""
    (cfg,) = [c for c in bench["configs"] if c["name"] == config]
    end_to_end = [m for m in bench["end_to_end"] if _applies(m, name, [])]
    reported = [m["name"] for m in end_to_end]
    per_layer = [m for m in bench["per_layer"] if _applies(m, name, reported)]
    limits = BENCH_DIR / "limits" / f"{name}.json"
    return Cell(
        name=name, chips=chips, config_name=config,
        config=json.loads((root / cfg["file"]).read_text()), traffic_name=traffic,
        traffic=json.loads((BENCH_DIR / "traffic" / f"{traffic}.json").read_text()),
        limits=json.loads(limits.read_text()) if limits.exists() else {},
        end_to_end=end_to_end, per_layer=per_layer)


def _load(path: Path, module_name: str):
    spec = importlib.util.spec_from_file_location(module_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def metric_module(name: str):
    """``metrics/<name>.py``: its ``read``, and ``PER_STEP``, the patterns of
    kernels that each training step runs alike, where it reads such kernels."""
    return _load(BENCH_DIR / "metrics" / f"{name}.py", f"portbench_metric_{name.replace('.', '_')}")


def family_module(config: Dict):
    """The plain reference of a configuration's model family (``FAMILIES``
    / ``<config["reference"]>.py``): its ``net``, ``init_params``,
    ``forward``, ``work`` and ``TINY``, as ``reference/implicitnet.py`` says."""
    name = config.get("reference", DEFAULT_FAMILY)
    path = FAMILIES / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no model family {name!r}: {path} is not there")
    return _load(path, f"portbench_family_{name.replace('.', '_')}")


def metric_reader(name: str) -> Callable:
    """``read`` of ``metrics/<name>.py``."""
    return metric_module(name).read
