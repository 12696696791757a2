"""Point-cloud (IGR) trainer — surface points only, no SDF labels.

Counterpart of sdf_representation_tpu/training/pcd_trainer.py (the
reference's misnamed DistributedExecutor, executor/executordistributed.py:
it is not data-parallel training but the IGR point-cloud trainer that
``[Sampling] distributed = True`` selects). Semantics kept:

  * input: ``<config.geometry>/surface.csv``, columns 0-2 (raw points; the
    first line is a header, rows that are not numbers are dropped)
  * per batch: mean |f(x)| + lambda_g * eikonal at perturbed points, the
    perturbed points being batch // 3 rows drawn by permutation plus
    N(0, local_sigma = 1e-4) noise (executordistributed.py:108-123); the
    Lipschitz variant adds its bound's penalty
  * Adam; "best" every int(1.5 * checkpointing) epochs, model_epoch{E}.ckpt
    every ``checkpointing`` epochs (:95-107), and a final save so short runs
    leave a checkpoint

Under ``mesh`` the forward and the eikonal term's fast path run sharded
(``bind_apply``; JAX pcd_trainer.py:53-98) while the subsample ``idx`` and
the noise stay whole-batch draws on ``mesh[0]``. Under a process group
(``parallel.mesh.ProcessMesh``) every rank draws them whole from the same
generator, runs the forward on its rows, and rank 0 writes the files, as
in the labelled trainer.

A loop like ``Trainer.train``: the cloud lives on the device, every epoch
draws a permutation from a generator seeded from (init_seed + 1, epoch),
every step reseeds it from (init_seed + 1, epoch, step); losses stay on the
device within an epoch: one host read per epoch. On a card every step is one
replay of a CUDA graph (training/graphs.py), the subsample and the noise
drawn inside it from the step's registered generator, under the labelled
trainer's rule (``graphs.captures``: one device, a mesh of one card, or a
process group over NCCL, where every rank seeds the generator alike); under
a mesh of distinct cards or a gloo group, on the CPU, or with
``train(eager=True)``, the step runs as a plain call. The JAX trainer has no
multi-epoch block here, and neither has this one.

The eikonal term's (f, grad_x f) runs through the fused kernels of
ops/fused_igr.py under the labelled trainer's rule (``use_fused_igr``: an
ImplicitNet); every other family (Siren, built for this loss, among them)
takes the forward-mode passes of ``sdf_and_gradient_fwd``, as in JAX.
The JAX trainer runs the model here with no rng, so FFN dropout is off.
Unlike the labelled step, this one hands the float32 parameters to the
kernel, which rounds them to its bfloat16 working type itself, and the
manifold term mean |f| runs through the ordinary float32 module forward
(pcd_trainer.py:72-76 of the JAX package). With the bfloat16 working type
the kernel also rounds the points, whose spacing near 0.5 (~2e-3) is wider
than the 1e-4 perturbation: kept for parity.

A checkpoint is ``{"model", "optimizer", "epoch", "losses"}``; it has the
``"model"`` and ``"epoch"`` of the labelled trainer's, so ``load_model`` and
reconstruction (``ppo = True, reconstruct = True`` with ``distributed =
False`` and the same run directory) read it unchanged.
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..ops.diffops import sdf_and_gradient_fwd
from ..parallel.mesh import ProcessMesh, allreduce_grads, count_once
from ..utils.profiling import span
from . import checkpoint as ckpt
from . import graphs
from .trainer import LAST_RUN, Trainer, bind_apply, use_fused_igr


def pcd_loss(apply, model, xb: torch.Tensor, idx: torch.Tensor, noise: torch.Tensor,
             grad_lambda: float, mesh=None) -> torch.Tensor:
    """mean |f(xb)| + grad_lambda * mean (|grad f| - 1)^2 at xb[idx] + noise,
    plus the Lipschitz bound's penalty for that variant (its gradient from
    rank 0 only under a ``ProcessMesh``)."""
    surface_loss = torch.mean(torch.abs(apply(xb)))
    _, grads = sdf_and_gradient_fwd(apply, xb[idx] + noise)
    grad_norm = torch.linalg.norm(grads[:, -3:], dim=-1)
    value = surface_loss + grad_lambda * torch.mean((grad_norm - 1.0) ** 2)
    if getattr(model, "lipschitz", False) and model.lipschitz_weight > 0:
        # arXiv:2202.08345 eq. 7, as in make_train_step
        value = value + model.lipschitz_weight * count_once(model.lipschitz_bound(), mesh)
    return value


class PointCloudTrainer(Trainer):
    def __init__(self, config, device=None, mesh=None, init_seed: int = 0,
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__(config, device=device, mesh=mesh, init_seed=init_seed,
                         compute_dtype=compute_dtype)
        self.local_sigma = 1e-4
        self.grad_lambda = float(getattr(config.make_loss(), "lambda_g", 0.1))

    def _load_points(self) -> np.ndarray:
        path = os.path.join(self.config.geometry, "surface.csv")
        try:
            pts = np.loadtxt(path, delimiter=",", skiprows=1, usecols=(0, 1, 2), ndmin=2)
        except ValueError:  # some row is not numbers: parse row by row and drop those
            rows = []
            with open(path) as f:
                next(f, None)
                for line in f:
                    try:
                        rows.append([float(v) for v in line.split(",")[:3]])
                    except ValueError:
                        continue
            pts = np.array([r for r in rows if len(r) == 3], dtype=np.float64).reshape(-1, 3)
        return pts[np.isfinite(pts).all(axis=1)].astype(np.float32)

    def _make_step(self, optimizer: torch.optim.Optimizer, batch: int):
        """(xb, generator) -> loss (a detached scalar tensor): one update."""
        model = self.model
        n_sub = max(1, batch // 3)
        group = isinstance(self.mesh, ProcessMesh)
        apply = bind_apply(model, None,
                           use_fused_igr(model, self.config.train_matmul_precision), self.mesh)

        def step(xb: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
            kw = dict(generator=generator, device=xb.device)
            idx = torch.randperm(xb.shape[0], **kw)[:n_sub]
            noise = self.local_sigma * torch.randn((n_sub, xb.shape[1]), dtype=xb.dtype, **kw)
            optimizer.zero_grad(set_to_none=True)
            value = pcd_loss(apply, model, xb, idx, noise, self.grad_lambda, self.mesh)
            if value.requires_grad or not group:  # a rank whose terms all count on rank 0
                value.backward()
            if group:
                allreduce_grads(list(model.parameters()))
            optimizer.step()
            return value.detach()

        return step

    def train(self, points: Optional[np.ndarray] = None, *, eager: bool = False) -> Dict[str, Any]:
        """``eager``: run every step as a plain call where a card would
        replay a graph (the reference the graph is held against)."""
        c = self.config
        t_load = time.time()
        if points is None:
            points = self._load_points()
        X = torch.from_numpy(np.ascontiguousarray(points, dtype=np.float32)).to(self.device)
        n = X.shape[0]
        if n == 0:
            raise ValueError("the point cloud is empty")
        batch = min(c.batchsize, n)
        n_batches = max(1, n // batch)

        optimizer = graphs.make_adam(self.model.parameters(), c.lr, self.device)
        start_epoch = 0
        losses_hist: list = []
        best_path = os.path.join(self.model_save_path, "best_model.ckpt")
        self._after_rank0()  # a checkpoint to resume from is read after rank 0
        if c.contd and os.path.exists(best_path):
            state = ckpt.load_checkpoint(best_path)
            self.model.load_state_dict(state["model"])
            graphs.load_optimizer_state(optimizer, state["optimizer"])
            start_epoch = int(state["epoch"]) + 1
            losses_hist = list(state["losses"])
            print(f"Resumed from {best_path} at epoch {start_epoch}")

        def state_at(epoch: int) -> Dict[str, Any]:
            return {"model": self.model.state_dict(), "optimizer": optimizer.state_dict(),
                    "epoch": epoch, "losses": list(losses_hist)}

        step = self._make_step(optimizer, batch)
        runner = graphs.StepRunner(lambda idx, epoch, gen: step(X[idx], gen), self.device)
        captured = self._captures(eager)
        t_capture = time.perf_counter()
        if captured:
            runner.capture(torch.arange(batch, device=self.device),
                           lambda: graphs.state_tensors(self.model, {}, optimizer))
            torch.cuda.synchronize(self.device)
        capture_s = time.perf_counter() - t_capture
        log = os.path.join(self.train_path, "train_loss.txt")
        t_start = time.time()
        final_epoch = max(start_epoch - 1, 0)  # a resume with nothing left keeps its epoch
        # the loop's window in a torch.profiler trace (chip_smoke.py and
        # portbench/metrics read it); the spans inside are per epoch, never per step
        with span("training_loop"):
            for epoch in range(start_epoch, c.epochs):
                final_epoch = epoch
                with span("train.steps"):
                    loss = self._run_epoch(runner, epoch, n, batch)
                with span("train.block_end"):
                    train_loss = float(loss)  # the epoch's one host read
                    losses_hist.append(train_loss)
                    if self.writes:
                        with open(log, "a") as f:
                            f.write(f"Epoch {epoch + 1}/{c.epochs}: train loss {train_loss}\n")
                if not self.writes:
                    continue
                with span("train.checkpoint"):
                    if epoch % int(1.5 * c.checkpointing) == 0:
                        ckpt.save_checkpoint(best_path, state_at(epoch))
                    if epoch % c.checkpointing == 0:
                        ckpt.save_checkpoint(
                            os.path.join(self.model_save_path, f"model_epoch{epoch}.ckpt"),
                            state_at(epoch))
                        self._plot_losses(losses_hist, losses_hist)
        if self.writes:  # final save so short runs always leave a checkpoint
            ckpt.save_checkpoint(best_path, state_at(final_epoch))

        elapsed = time.time() - t_start
        n_epochs_run = max(0, c.epochs - start_epoch)
        throughput = n_batches * batch * n_epochs_run / max(elapsed, 1e-9)
        print(f"Training done: {n_epochs_run} epochs, {elapsed:.1f}s, {throughput:,.0f} points/sec")
        LAST_RUN.clear()
        LAST_RUN.update(load_seconds=t_start - t_load, epochs_run=n_epochs_run, seconds=elapsed,
                        points_per_sec=throughput, graphed=captured, capture_s=capture_s)
        return {"losses": losses_hist, "last_epoch": final_epoch, "epochs_run": n_epochs_run,
                "points_per_sec": throughput}

    def run(self):
        return self.train()
