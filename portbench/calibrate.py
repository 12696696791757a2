"""Readings that the limits of ``correct`` are set from, at a cell's own size.

    python3 portbench/calibrate.py --workload <cell> --seeds <n> [<n> ...] \\
        --variants program control fault_half fault_unchanged fault_altered

Each variant gives the numbers that a run compares, on each seed:

  program          the port, as a run drives it: set-up with its steps, a
                   window of the checked epochs and one more (a labelling
                   cell: set-up and three passes); its numbers are the lower
                   readings.
  control          the reference put in the program's place, one precision
                   below the configuration's: the forward of the cell's
                   model family (``spec.family_module``) in float8 e4m3 for
                   a bfloat16 configuration, TF32 for a float32 one (the
                   modes of ``reference.train``); labels of points rounded
                   to bfloat16, worked out in bfloat16.
  fault_half       training: the reference's steps on half of each batch,
                   the mean taken over the rest.
  fault_unchanged  training: the reference's steps at a rate of 0, so that
                   every step returns its state unchanged.
  fault_altered    one answer altered where it is produced: the first label
                   of each checked batch (a labelling cell: of the rows
                   kept) moved by 0.05; a point-cloud step's loss reported
                   1% high (each reported loss, in the window and the steps).

The training variants run through the cell's model family, as the check's
reference does, and follow the program's own inputs (its labels, its
cloud). One JSON line per variant and seed goes to standard output. The
test ``tests/test_controls.py`` runs the same at a size a CPU holds.
"""

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from portbench.harness import compare, runner, spec  # noqa: E402
from portbench.harness.label_cell import LabelCell  # noqa: E402
from portbench.harness.train_cell import CHECK_EPOCHS, LABELLED_BATCHES, TrainCell  # noqa: E402

ALTER = 0.05
LOWER_MODE = {"bfloat16": "fp8"}  # any other configuration trains in float32: TF32 below it


def _bf16(a: np.ndarray) -> np.ndarray:
    return torch.as_tensor(a).to(torch.bfloat16).double().numpy()


def _label_variant(entry: TrainCell, variant: str):
    """The label numbers of the checked rows with the reference in the program's place."""
    rows = entry.labelled_rows()
    x = entry.reference_points(rows)
    sdf, normals = entry.reference_labels(x)
    y = np.column_stack([sdf, normals])
    xv, yv = x, y
    if variant == "control":
        xv = _bf16(x)
        yv = np.column_stack(entry.reference_labels(xv, dtype=torch.bfloat16))
    elif variant == "fault_altered":
        yv = y.copy()
        yv[np.arange(LABELLED_BATCHES) * entry.batch, 0] += ALTER
    yv = yv.astype(np.float32)
    return compare.label_numbers(yv[:, 0], yv[:, 1:4], sdf, normals, points_p=xv.astype(np.float32),
                                 points_r=x.astype(np.float32))


def train_readings(entry: TrainCell, variants):
    precision = entry.sections.get("TPU", {}).get("train_matmul_precision")
    out = {}
    for variant in variants:
        numbers = {} if entry.pointcloud else _label_variant(entry, variant)
        if variant == "control":
            outputs = entry.reference_fit(LOWER_MODE.get(precision, "tf32"))
        elif variant == "fault_half":
            outputs = entry.reference_fit("f32", half=True)
        elif variant == "fault_unchanged":
            outputs = entry.reference_fit("f32", lr=0.0)
        elif variant == "fault_altered":
            outputs = entry.reference_fit("f32", scale=1.01) if entry.pointcloud else entry.truth()
        else:
            raise ValueError(f"no variant {variant}")
        numbers.update(entry.train_numbers(outputs))
        out[variant] = numbers
    return out


def label_readings(entry: LabelCell, variants):
    out = {}
    for variant in variants:
        points_r = entry.reference_points()
        sdf, normals = entry.reference_labels(points_r)
        if variant == "control":
            p = _bf16(points_r)
            s, n = entry.reference_labels(p, dtype=torch.bfloat16)
        elif variant == "fault_altered":
            p, s, n = points_r, sdf.copy(), normals
            s[0] += ALTER
        else:
            raise ValueError(f"{variant} does not apply to a labelling cell")
        out[variant] = compare.label_numbers(s, n, sdf, normals, points_p=p, points_r=points_r)
    return out


def readings(cell, seed: int, variants, device: str):
    run_dir = tempfile.mkdtemp(prefix="portbench-cal-", dir=os.environ.get("TMPDIR"))
    try:
        return _readings(runner.make_entry(cell, seed, device, run_dir), cell, variants)
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)


def _readings(entry, cell, variants):
    out = {}
    rest = [v for v in variants if v != "program"]
    if isinstance(entry, LabelCell):
        if "program" in variants:
            entry.setup()
            entry.window(int(cell.traffic["check"]["passes"]))
            entry.release()
            out["program"] = entry.check()
        elif rest:
            entry.prepare()
            entry.keep_rows(int(cell.traffic["check"]["passes"]))
        out.update(label_readings(entry, rest))
        return out
    # a training cell: the program's inputs come from its set-up, whatever the variant
    entry.setup()
    if "program" in variants:
        entry.window(CHECK_EPOCHS + 1)
        entry.release()
        out["program"] = entry.check()
    else:
        entry.release()
    out.update(train_readings(entry, rest))
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--variants", nargs="+", default=["program", "control", "fault_half",
                                                       "fault_unchanged", "fault_altered"])
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA card: the readings are the card's", file=sys.stderr)
        return 2
    cell = spec.resolve(args.workload)
    for seed in args.seeds:
        t0 = time.perf_counter()
        for variant, numbers in readings(cell, seed, args.variants, "cuda").items():
            print(json.dumps({"cell": args.workload, "variant": variant, "seed": seed,
                              "numbers": numbers, "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
