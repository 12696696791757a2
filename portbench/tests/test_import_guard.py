"""The benchmark measures the port alone: no module that a run loads is JAX
or the JAX package, and the reference imports nothing of the program.

Names are compared by their top-level part, whole: the port's name begins
with the JAX package's."""

import ast
import json
import subprocess
import sys

import pytest

from portbench.harness import result, spec

REFERENCE = spec.BENCH_DIR / "reference"

# a tiny run of one cell on the CPU in a fresh interpreter, then its modules
RUN_CELL = """
import json, sys, time
sys.path.insert(0, {tests!r})
from conftest import tiny
from portbench.harness import runner, spec
cell = tiny({name!r})
runner.run(cell, 99, 1.0, {trace!r}, "cpu", time.perf_counter())
for m in cell.end_to_end + cell.per_layer:
    spec.metric_reader(m["name"])
print(json.dumps(sorted(sys.modules)))
"""


def _modules(code: str):
    proc = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("name", [w["name"] for w in spec.load_benchmark()["workloads"]])
def test_a_run_of_each_cell_loads_no_jax(name):
    modules = _modules(RUN_CELL.format(tests=str(spec.BENCH_DIR / "tests"), name=name,
                                       trace=name.endswith("train-sup")))
    assert "sdf_representation_tpu_torch" in {m.split(".")[0] for m in modules}
    assert result.forbidden_modules(modules) == []


def test_the_guard_compares_whole_top_level_names():
    assert result.forbidden_modules(["sdf_representation_tpu_torch.ops", "jaxtyping"]) == []
    assert result.forbidden_modules(["sdf_representation_tpu.ops", "jax.numpy"]) == [
        "jax", "sdf_representation_tpu"]


# what a module under reference/ may import: the standard library's plain
# parts, numpy, torch, and the benchmark's own plain modules (another
# reference module, the table of peaks)
PLAIN = ("__future__", "math", "typing", "numpy", "torch")
BENCHMARK = ("portbench.reference", "portbench.harness.counts")


@pytest.mark.parametrize("path", sorted(REFERENCE.glob("*.py")), ids=lambda p: p.stem)
def test_the_reference_imports_nothing_of_the_program(path):
    """Every module under reference/, a family added later too: loaded by its
    file, as the harness loads a family, in a fresh interpreter."""
    code = ("import json, sys\nfrom portbench.harness import spec\n"
            f"spec._load(spec.FAMILIES / {path.name!r}, 'guarded')\n"
            "print(json.dumps(sorted(sys.modules)))")
    tops = {m.split(".")[0] for m in _modules(code)}
    assert not tops & {"sdf_representation_tpu_torch", "sdf_representation_tpu", "jax", "jaxlib", "flax"}
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            assert node.level == 0, (path, "a module loaded by its file has no package: import absolutely")
            names = [f"{node.module}.{a.name}" for a in node.names]
        else:
            continue
        for n in names:
            assert n.split(".")[0] in PLAIN or n.startswith(BENCHMARK), (path, n)
