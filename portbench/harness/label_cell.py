"""A labelling cell: the port's sampler labels the shape, pass after pass.

A pass is ``sampling.sampler.generate_signed_distance_data`` of the
configuration's ``[Sampling]`` counts, in memory: the host draws the points, the card
labels them with exact signed distance, sign and normal (the port's
``method="auto"`` rule). Pass ``i`` of a run draws from seed ``seed * 4096 +
i``, so every pass labels other points of the same counts. Set-up makes the
shape and runs one pass (pass -1) that builds the kernels; the window runs
as many whole passes as the mix's nominal rate fills ``--seconds`` with.

After each pass the benchmark keeps, for the passes and rows that the seed
draws, the rows the pass returned. Once the window has closed, the reference
draws those passes' points again and labels the kept rows itself.
"""

from __future__ import annotations

import math
import time
from typing import Dict, List

import numpy as np
import torch

from . import compare, data
from ..reference import sampling as ref_sampling
from ..reference import sdf as ref_sdf

PASS_SEEDS = 4096


class LabelCell:
    def __init__(self, cell, seed: int, device: str, run_dir: str):
        self.cell, self.seed, self.device = cell, int(seed), torch.device(device)
        s = {**cell.config["ini"], **cell.traffic.get("ini", {})}["Sampling"]
        self.counts = {"uniform": s["uniform_points"], "surface": s["surface"],
                       "narrow": s["narrowband"], "width": s["narrowband_width"]}
        self.kept: Dict[int, np.ndarray] = {}
        self.picks: Dict[int, np.ndarray] = {}
        self.stage_seconds: List[Dict] = []

    def pass_seed(self, i: int) -> int:
        return (self.seed % (1 << 50)) * PASS_SEEDS + i + 1

    def prepare(self) -> None:
        """The shape and the counts; no pass."""
        from sdf_representation_tpu_torch.geometry.mesh_io import Mesh

        self.vertices, self.faces = data.stand_in(self.cell.config["geometry"])
        self.mesh = Mesh(self.vertices, self.faces)
        c = self.counts
        self.points_per_pass = (int(c["uniform"]) + len(self.faces) * int(c["surface"])
                                + len(self.faces) * min(int(c["surface"]), int(c["narrow"])))

    def setup(self) -> None:
        t0 = time.perf_counter()
        self.prepare()
        t1 = time.perf_counter()
        self._pass(-1)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.stages = {"shape": t1 - t0, "first_pass": time.perf_counter() - t1}

    def _pass(self, i: int):
        from sdf_representation_tpu_torch.sampling import sampler

        c = self.counts
        return sampler.generate_signed_distance_data(
            self.mesh, int(c["uniform"]), int(c["surface"]), int(c["narrow"]), float(c["width"]),
            seed=self.pass_seed(i), device=self.device)

    def epochs_for(self, seconds: float) -> int:
        """Whole passes in the window."""
        return max(1, math.ceil(seconds * float(self.cell.traffic["nominal_points_per_s"])
                                / self.points_per_pass))

    def keep_rows(self, passes: int) -> None:
        """The checked passes (the last always) and their rows, drawn from the seed."""
        rng = np.random.default_rng([self.seed % (1 << 63), 11])
        check = self.cell.traffic["check"]
        n_checked = min(passes, int(check["passes"]))
        chosen = set(rng.choice(passes - 1, size=n_checked - 1, replace=False).tolist()) if passes > 1 else set()
        chosen.add(passes - 1)
        rows = min(int(check["rows_per_pass"]), self.points_per_pass)
        self.picks = {i: np.sort(rng.choice(self.points_per_pass, size=rows, replace=False))
                      for i in sorted(chosen)}

    def window(self, passes: int) -> Dict:
        from sdf_representation_tpu_torch.sampling import sampler

        self.keep_rows(passes)
        failed = 0
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        with torch.profiler.record_function("bench_window"):
            for i in range(passes):
                with torch.profiler.record_function("label_pass"):
                    frames = self._pass(i)
                self.stage_seconds.append(dict(sampler.LAST_STAGE_SECONDS))
                values = np.concatenate([f.values for f in frames])
                if len(values) != self.points_per_pass or not np.isfinite(values[:, 3:]).all():
                    failed += 1
                if i in self.picks:
                    self.kept[i] = values[self.picks[i]].copy()
                del frames, values
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        seconds = time.perf_counter() - t0
        return {"seconds": seconds, "epochs": passes, "points": passes * self.points_per_pass,
                "steps": passes, "failed": failed}

    def release(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def work(self) -> Dict:
        return {"span": "bench_window", "stage_seconds": self.stage_seconds}

    def reference_points(self) -> np.ndarray:
        """The checked passes' kept rows' points, drawn again by the reference."""
        c = self.counts
        out = []
        for i, pick in self.picks.items():
            parts = ref_sampling.draw_points(self.vertices, self.faces, int(c["uniform"]),
                                             int(c["surface"]), int(c["narrow"]), float(c["width"]),
                                             self.pass_seed(i))
            # the sampler returns the uniform, surface and narrow-band frames in that order
            out.append(np.concatenate(parts)[pick])
        return np.concatenate(out)

    def reference_labels(self, points: np.ndarray, dtype=torch.float64):
        return ref_sdf.signed_distance(points, self.vertices, self.faces, device=self.device, dtype=dtype)

    def check(self) -> Dict[str, float]:
        points_r = self.reference_points()
        rows_p = np.concatenate([self.kept[i] for i in self.picks])
        sdf, normals = self.reference_labels(points_r)
        return compare.label_numbers(rows_p[:, 3], rows_p[:, 4:7], sdf, normals,
                                     points_p=rows_p[:, :3], points_r=points_r)
