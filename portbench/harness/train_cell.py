"""A training cell: the port's trainer fits the configuration's net.

Set-up makes the inputs: the shape and the program's labels of it (the
port's sampler, in memory, with the port's split), or the benchmark's point
cloud. It then warms the card with a trainer of the same configuration and
seed that runs ``STEPS`` epochs of the same ``train`` call on one batch of
the data (the first batch of the window's first epoch, with the whole
validation set): one step an epoch, which its history and checkpoints show
step by step. That builds and loads every kernel the window runs, at its
shapes. Last it builds the window's trainer (``Trainer`` for labelled
points, ``PointCloudTrainer`` for a point cloud), its weights from the
seed.

The window is one ``train`` call of that trainer on the whole dataset, from
its initialisation, with the configuration's settings, for a fixed number of
epochs: as many as the mix's nominal rate fills ``--seconds`` with (the work
depends on the seconds asked for and the seed, never on a clock). Its time
is the host clock around the call, which ends in a synchronize: it holds the
trainer's capture of its step (one per call), every step, the validation
batches, each block's host read and checkpoint writes.

The check, once the window has closed, follows the window's first
``CHECK_EPOCHS`` epochs: the reference, the plain model of the
configuration's family (``spec.family_module``), makes the initial weights
from the seed and takes the same steps in float32, batch for batch, the
rows of each drawn by the trainer's seeding rule, on the rows the window
trained on. It compares each epoch's mean loss and, for labelled points,
the checkpoint that the window kept as its best; for the point cloud, the parameters that
the window's checkpoint of its first epoch holds. The window shows its state only once an epoch, and over an epoch the
trajectories of two sound runs part about as far as a lower precision or
half a batch moves them; so the reference also follows the set-up's steps
one by one (``steps.`` numbers): each step's loss, the validation loss
after it, the first gradient and the change after the steps, where the
checkpoints hold them (``compare``).

A labelled epoch holds about two million rows, which the reference cannot
label in a run (its float64 labelling takes about 4.5 s for 49,152 rows),
so it follows the window's steps on the program's labels, and checks that
labelling by itself: it draws the points of the first epoch's first three
batches again and labels them in float64.
"""

from __future__ import annotations

import configparser
import gc
import math
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from . import compare, data, spec
from ..reference import sampling as ref_sampling
from ..reference import sdf as ref_sdf
from ..reference import train as ref_train

LABELLED_BATCHES = 3  # the batches of the first epoch whose labels are checked
STEPS = 3  # the set-up's steps, one an epoch, that the reference follows one by one
CHECK_EPOCHS = 1  # the window's epochs that the reference follows: later ones part by chaos
LOCAL_SIGMA = 1e-4  # the point-cloud trainer's noise on its eikonal points


def _ini(sections: Dict[str, Dict], run_dir: str, name: str) -> str:
    parser = configparser.ConfigParser()
    parser.optionxform = str
    files = {"geometry": os.path.join(run_dir, "none"), "directory": run_dir, "name": name}
    for section, values in {"Files": files, **sections}.items():
        parser[section] = {k: str(v) for k, v in values.items()}
    os.makedirs(run_dir, exist_ok=True)
    path = os.path.join(run_dir, "config.ini")
    with open(path, "w") as f:
        parser.write(f)
    return path


def _merged(config: Dict, traffic: Dict) -> Dict[str, Dict]:
    """The configuration's INI sections; a mix's section replaces the whole section."""
    return {**config["ini"], **traffic.get("ini", {})}


class TrainCell:
    def __init__(self, cell, seed: int, device: str, run_dir: str):
        self.cell, self.seed, self.device, self.run_dir = cell, int(seed), torch.device(device), run_dir
        self.stages: Dict[str, float] = {}
        self.sections = _merged(cell.config, cell.traffic)
        self.pointcloud = cell.traffic["trainer"] == "pointcloud"
        self.loss_name = self.sections["Loss"]["loss_function"]
        self.family = spec.family_module(cell.config)
        self.result: Optional[Dict] = None
        self._truth: Optional[Dict] = None

    # -- set-up ---------------------------------------------------------------

    def prepare(self) -> None:
        """The inputs both sides share: the shape, the batch, the cloud."""
        self.vertices, self.faces = data.stand_in(self.cell.config["geometry"])
        self.batch = int(self.sections["Training"]["batch_size"])
        if self.pointcloud:
            self.cloud = data.point_cloud(self.vertices, self.faces,
                                          int(self.cell.traffic["cloud_per_face"]), self.seed)

    def _lap(self, name: str) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.stages[name] = now - self._t
        self._t = now

    def _trainer(self, run_dir: str):
        from sdf_representation_tpu_torch.configgen.config_reader import Configuration

        if self.pointcloud:
            from sdf_representation_tpu_torch.training.pcd_trainer import PointCloudTrainer as T
        else:
            from sdf_representation_tpu_torch.training.trainer import Trainer as T
        config = Configuration(_ini(self.sections, run_dir, self.cell.config["name"]))
        return T(config, device=self.device, init_seed=data.init_seed(self.seed))

    def setup(self) -> None:
        self.stages, self._t = {}, time.perf_counter()
        self.prepare()
        self._lap("shape")
        if not self.pointcloud:
            self.dataset = self._label(self.sections["Sampling"])
            self._lap("program_labels")
        if self.n_train() < self.batch:
            raise ValueError(f"{self.n_train()} training rows hold no batch of {self.batch}")
        self.step_rows = self.permutation(0, self.n_train())[0].cpu().numpy()
        steps = self._trainer(os.path.join(self.run_dir, "steps"))
        self.steps_params0 = [p.detach().clone() for p in steps.model.parameters()]
        steps.config.epochs = STEPS
        self.steps_result = steps.train(self.step_inputs())
        self.steps_kept = self._kept(steps)
        del steps
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        self._lap("steps")
        self.trainer = self._trainer(self.run_dir)
        self.params0 = [p.detach().clone() for p in self.trainer.model.parameters()]
        self._lap("trainer")

    def _label(self, sampling: Dict):
        """The port's sampler labels the shape; the port's split, in memory."""
        from sdf_representation_tpu_torch.data.dataset import SDFDataset, split_indices
        from sdf_representation_tpu_torch.sampling import sampler

        frames = sampler.generate_signed_distance_data(
            self._mesh(), int(sampling["uniform_points"]), int(sampling["surface"]),
            int(sampling["narrowband"]), float(sampling["narrowband_width"]),
            seed=self.seed % (1 << 63), device=self.device)
        values = np.concatenate([f.values for f in frames if len(f) > 1], axis=0)
        x, y = values[:, :-4].astype(np.float32), values[:, -4:].astype(np.float32)
        train, val = split_indices(len(x), float(sampling["train_test_split"]))
        return SDFDataset(np.ascontiguousarray(x[train]), np.ascontiguousarray(y[train]),
                          np.ascontiguousarray(x[val]), np.ascontiguousarray(y[val]))

    def _mesh(self):
        from sdf_representation_tpu_torch.geometry.mesh_io import Mesh

        return Mesh(self.vertices, self.faces)

    def inputs(self):
        return self.cloud if self.pointcloud else self.dataset

    def step_inputs(self):
        """One batch of the data: the first batch of the window's first epoch."""
        rows = self.step_rows
        if self.pointcloud:
            return np.ascontiguousarray(self.cloud[rows])
        from sdf_representation_tpu_torch.data.dataset import SDFDataset

        ds = self.dataset
        return SDFDataset(np.ascontiguousarray(ds.train_x[rows]), np.ascontiguousarray(ds.train_y[rows]),
                          ds.val_x, ds.val_y)

    def n_train(self) -> int:
        return len(self.cloud) if self.pointcloud else self.dataset.n_train

    # -- window ---------------------------------------------------------------

    def points_per_epoch(self) -> int:
        return self.steps_per_epoch() * self.batch

    def steps_per_epoch(self) -> int:
        return self.n_train() // self.batch

    def epochs_for(self, seconds: float) -> int:
        return max(CHECK_EPOCHS, math.ceil(
            seconds * float(self.cell.traffic["nominal_points_per_s"]) / self.points_per_epoch()))

    def window(self, epochs: int) -> Dict:
        """One ``train`` call of ``epochs`` epochs; host seconds to its end.
        The first call's history and checkpoints are kept for the check."""
        self.trainer.config.epochs = epochs
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        with torch.profiler.record_function("bench_window"):
            result = self.trainer.train(self.inputs())
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        seconds = time.perf_counter() - t0
        if result["epochs_run"] != epochs:
            raise RuntimeError(f"the window ran {result['epochs_run']} epochs, not {epochs}")
        history = result["losses"] if self.pointcloud else result["train_losses"]
        if self.result is None:
            self.result = result
            self.kept = self._kept(self.trainer)
        return {"seconds": seconds, "epochs": epochs, "points": epochs * self.points_per_epoch(),
                "steps": epochs * self.steps_per_epoch(),
                "failed": sum(1 for v in history[-epochs:] if not math.isfinite(v))}

    def _kept(self, trainer) -> Dict:
        """What a ``train`` call's checkpoints hold: the point-cloud trainer's
        state after its first epoch (``model_epoch0.ckpt``) and at its end
        (``best_model.ckpt``, its final save); the labelled trainer's best
        epoch."""
        from sdf_representation_tpu_torch.training import checkpoint as ckpt

        names = [n for n, _ in trainer.model.named_parameters()]
        models = trainer.model_save_path

        def read(name):
            state = ckpt.load_checkpoint(os.path.join(models, name))
            moments = state["optimizer"]["state"]
            return {"epoch": int(state["epoch"]), "params": [state["model"][n] for n in names],
                    "moment": [moments[i]["exp_avg"] for i in sorted(moments)]}

        if self.pointcloud:
            return {"first": read("model_epoch0.ckpt"), "last": read("best_model.ckpt")}
        return {"best": read("best_model.ckpt")}

    def release(self) -> None:
        """Drop the program's state before the reference runs (the inputs stay)."""
        self.trainer = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the per-layer context -------------------------------------------------

    def work(self) -> Dict:
        """Counts of the work, for the per-layer readers: the family's, and
        the step's batch, loss and span."""
        eik_rows = max(1, self.batch // 3) if self.pointcloud else self.batch
        precision = self.sections.get("TPU", {}).get("train_matmul_precision")
        return {"batch": self.batch, "loss": self.loss_name, "span": "training_loop",
                **self.family.work(self.net(), self.loss_name, self.batch, eik_rows, precision)}

    # -- the check -------------------------------------------------------------

    def net(self) -> Dict:
        return self.family.net(self.sections["Model"])

    def loss_cfg(self) -> Dict:
        return {k: float(v) for k, v in self.sections["Loss"].items() if k != "loss_function"}

    def permutation(self, epoch: int, n: int) -> torch.Tensor:
        """(steps, batch) rows of an epoch over n rows by the trainers' seeding
        rule: a permutation on the device seeded from (init_seed + 1, epoch),
        the partial batch dropped."""
        s, dev, b = data.init_seed(self.seed), self.device, self.batch
        gen = torch.Generator(device=dev).manual_seed(((s + 1) << 32) + epoch)
        perm = torch.randperm(n, generator=gen, device=dev)
        return perm[:n // b * b].reshape(-1, b)

    def labelled_rows(self) -> np.ndarray:
        """Training rows of the first epoch's first batches, whose labels are checked."""
        return self.permutation(0, self.n_train())[:LABELLED_BATCHES].reshape(-1).cpu().numpy()

    def reference_points(self, rows: np.ndarray) -> np.ndarray:
        """Training rows' points as the reference draws them and splits them."""
        s = self.sections["Sampling"]
        parts = ref_sampling.draw_points(self.vertices, self.faces, int(s["uniform_points"]),
                                         int(s["surface"]), int(s["narrowband"]),
                                         float(s["narrowband_width"]), self.seed % (1 << 63))
        points = np.concatenate([p for p in parts if len(p) > 1])
        train, _ = ref_sampling.split(len(points), float(s["train_test_split"]))
        return points[train[rows]]

    def reference_labels(self, x: np.ndarray, dtype=torch.float64):
        return ref_sdf.signed_distance(x, self.vertices, self.faces, device=self.device, dtype=dtype)

    def epochs(self, rows: Optional[np.ndarray], n_epochs: int, half: bool = False) -> List:
        """The batches of the first epochs over the training rows ``rows``
        (None: all), on the device, as the trainer's steps see them; ``half``:
        each batch's first half only."""
        dev, b = self.device, self.batch
        keep = b // 2 if half else b
        if self.pointcloud:
            x, y = self.cloud, None
        else:
            x, y = self.dataset.train_x, self.dataset.train_y
        if rows is not None:
            x, y = x[rows], (None if y is None else y[rows])
        x = torch.as_tensor(np.ascontiguousarray(x), device=dev)
        y = None if y is None else torch.as_tensor(np.ascontiguousarray(y), device=dev)
        s = data.init_seed(self.seed)
        n_sub = max(1, b // 3)

        def batches(epoch):
            for k, idx_rows in enumerate(self.permutation(epoch, len(x))):
                if y is not None:
                    yield {"x": x[idx_rows[:keep]], "y": y[idx_rows[:keep]]}
                    continue
                # the step's draws: its subsample and noise, from (init_seed + 1, epoch, step)
                gen = torch.Generator(device=dev).manual_seed(((s + 1) << 44) + ((epoch + 1) << 20) + k)
                idx = torch.randperm(b, generator=gen, device=dev)[:n_sub]
                noise = LOCAL_SIGMA * torch.randn((n_sub, 3), dtype=torch.float32, generator=gen,
                                                  device=dev)
                if half:
                    kept = idx < keep
                    idx, noise = idx[kept], noise[kept]
                yield {"x": x[idx_rows[:keep]], "idx": idx, "noise": noise}

        return [batches(e) for e in range(n_epochs)]

    def validation(self) -> Optional[List[Dict]]:
        """The labelled trainer's validation batches: min(batch, n_val) rows
        each, in order, the remainder dropped."""
        if self.pointcloud or not self.dataset.n_val:
            return None
        dev, n = self.device, self.dataset.n_val
        vb = min(self.batch, n)
        x = torch.as_tensor(self.dataset.val_x, device=dev)
        y = torch.as_tensor(self.dataset.val_y, device=dev)
        return [{"x": x[i * vb:(i + 1) * vb], "y": y[i * vb:(i + 1) * vb]} for i in range(n // vb)]

    def reference_fit(self, mode: str = "f32", lr: Optional[float] = None, half: bool = False,
                      scale: float = 1.0) -> Dict:
        """The reference's (or, in another mode, the control's) run of the
        window's first epochs and of the set-up's steps, in the terms of
        ``compare.train_numbers``: ``window`` and ``steps``. ``scale``
        multiplies the losses it reports."""
        net, forward = self.net(), self.family.forward
        params0 = self.family.init_params(net, data.init_seed(self.seed), self.device)
        rate = float(self.sections["Training"]["lr"]) if lr is None else lr
        val = self.validation()
        out = {}
        for part, rows, n_epochs in (("window", None, CHECK_EPOCHS),
                                     ("steps", self.step_rows, STEPS)):
            fit = ref_train.fit(self.loss_name, forward, params0, self.epochs(rows, n_epochs, half),
                                net, self.loss_cfg(), rate, mode, val)
            change = [[p - q for p, q in zip(ps, params0)] for ps in fit["params"]]
            res = {"epoch_losses": [v * scale for v in fit["epoch_losses"]], "grad1": fit["grad1"]}
            if val is not None:
                res["val_losses"] = [v * scale for v in fit["val_losses"]]
                k = int(np.argmin(fit["val_losses"]))
                if part == "window":
                    res["best"] = (res["val_losses"][k], ref_train.validation_loss(
                        self.loss_name, forward, fit["params"][k], val, net, self.loss_cfg()))
                else:
                    res["change"] = change[k]
            elif part == "window":
                res["change"] = change[0]
            else:
                res["change"] = change[-1]
            out[part] = res
        return out

    def truth(self) -> Dict:
        if self._truth is None:
            self._truth = self.reference_fit("f32")
        return self._truth

    def program_outputs(self) -> Dict:
        """The window's and the set-up steps' own outputs, in the reference's terms."""
        dev, e = self.device, CHECK_EPOCHS

        def change(state, params0):
            return [p.to(dev) - q for p, q in zip(state["params"], params0)]

        if self.pointcloud:
            first = self.steps_kept["first"]
            return {"window": {"epoch_losses": self.result["losses"][:e],
                               "change": change(self.kept["first"], self.params0)},
                    "steps": {"epoch_losses": self.steps_result["losses"],
                              "grad1": [m.to(dev) / (1 - ref_train.BETAS[0]) for m in first["moment"]],
                              "change": change(self.steps_kept["last"], self.steps_params0)}}
        vals = self.result["val_losses"]
        best_state, best = self.kept["best"], None
        if best_state["epoch"] == int(np.argmin(vals)):
            best = (vals[best_state["epoch"]], ref_train.validation_loss(
                self.loss_name, self.family.forward, [p.to(dev) for p in best_state["params"]],
                self.validation(), self.net(), self.loss_cfg()))
        step_vals, kept = self.steps_result["val_losses"], self.steps_kept["best"]
        return {"window": {"epoch_losses": self.result["train_losses"][:e], "val_losses": vals[:e],
                           "best": best},
                "steps": {"epoch_losses": self.steps_result["train_losses"], "val_losses": step_vals,
                          "change": (change(kept, self.steps_params0)
                                     if kept["epoch"] == int(np.argmin(step_vals)) else None)}}

    def label_numbers(self) -> Dict[str, float]:
        """The program's labels of the checked rows against the reference's."""
        rows = self.labelled_rows()
        x = self.reference_points(rows)
        sdf, normals = self.reference_labels(x)
        px, py = self.dataset.train_x[rows], self.dataset.train_y[rows]
        # the dataset holds float32 rows: the reference's points, so rounded, are equal
        return compare.label_numbers(py[:, 0], py[:, 1:4], sdf, normals, points_p=px,
                                     points_r=x.astype(np.float32))

    def shown(self) -> Dict[str, tuple]:
        """What the program's history and checkpoints show of each part."""
        if self.pointcloud:
            return {"window": ("epoch_losses", "change"), "steps": ("epoch_losses", "grad1", "change")}
        return {"window": ("epoch_losses", "best"), "steps": ("epoch_losses", "val_losses", "change")}

    def train_numbers(self, outputs: Dict) -> Dict[str, float]:
        """``outputs`` (the program's, or a variant's in its place) against the reference."""
        truth, numbers = self.truth(), {}
        for part, keys in self.shown().items():
            mine = {k: v for k, v in outputs[part].items() if k in keys}
            for k, v in compare.train_numbers(mine, truth[part]).items():
                numbers[k if part == "window" else f"steps.{k}"] = v
        return numbers

    def check(self) -> Dict[str, float]:
        """The numbers compared, program against reference."""
        numbers = {} if self.pointcloud else self.label_numbers()
        numbers.update(self.train_numbers(self.program_outputs()))
        return numbers
