"""Training executor of the port.

Counterpart of sdf_representation_tpu/training/trainer.py (reference
executor/executor.py:23-499): the run-directory tree, sampling, supervised
training, checkpoints and the mode dispatch of ``run``.

  * the whole dataset lives on the device; every epoch draws a permutation
    from an explicit ``torch.Generator`` on the device seeded from
    (init_seed + 1, epoch), so the schedule depends on nothing else; partial
    final batches are dropped.
  * ``torch.optim.Adam`` (optax's ``adam`` defaults: b1 0.9, b2 0.999,
    eps 1e-8 outside the root — the same update); ``lr_step`` / ``lr_gamma``
    give a staircase per ``lr_step`` epochs.
  * validation runs in float32 on min(batch, n_val)-sized batches; the best
    validation epoch is kept as best_model.ckpt; early stop on
    ``min_epochs`` / ``patience``; model_epoch{E}.ckpt every ``checkpointing``
    epochs; checkpoints carry optimizer and scheduler state through resume.
  * losses stay on the device within an epoch: one host read per epoch.
  * a loss's learnable scalars (``needs_aux``: GaussBonnetLoss's Euler
    characteristic, initial value 2.0) are parameters beside the model's:
    given to Adam, saved in the checkpoints under ``"aux"`` (a key that
    checkpoints of the other losses do not have).
  * every step gets a ``torch.Generator`` on the device seeded from
    (init_seed + 1, epoch, step) for losses that draw points (IGRLOSSPCD);
    validation seeds it with 0.

Not carried over from the JAX trainer: its jitted multi-epoch block
(``epochs_per_call``), which exists to amortise dispatch latency there; the
key is read and ignored. The matrix products of the supervised step are
library matmuls here as they are XLA's there: that step has no hand-written
kernel in either package. The eikonal (IGR) step does: (f, grad_x f) and its
parameter gradients run through the hand-written kernels of
ops/fused_igr.py under the JAX package's rule (``use_fused_igr``):
``train_matmul_precision = bfloat16``, not the Lipschitz variant, and the
model on a card. There the fast path IS the kernel (a build or launch
failure raises). In every other configuration it is
``ops.diffops.implicitnet_value_and_grad`` under torch autograd, which is
what the JAX package leaves to XLA. Validation always takes the latter, in
float32, as the JAX package's does.

``train_matmul_precision``:
  None            float32 everywhere.
  "bfloat16"      float32 master weights and optimizer state; forward and
                  backward run on bfloat16 copies of the parameters and
                  inputs, the loss in float32. The forward noise of this mode
                  can hold the clamp-family losses on their all-clipped
                  plateau at lr >= 1e-4 (measured in the JAX package).
  "bfloat16_mxu"  float32 tensors whose matrix products may use reduced-
                  precision tensor-core passes
                  (``torch.set_float32_matmul_precision("medium")``), set for
                  the step and restored after it: per-product rounding
                  instead of stored-activation rounding.
"""

from __future__ import annotations

import contextlib
import math
import os
import time
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..configgen.config_reader import Configuration
from ..data.dataset import SDFDataset, load_data
from ..ops.diffops import implicitnet_value_and_grad
from ..ops.fused_igr import make_fused_value_and_grad
from ..utils.device import resolve_device
from ..utils.files import create_directory
from . import checkpoint as ckpt

PRECISIONS = (None, "bfloat16", "bfloat16_mxu")

# the last ``Trainer.train``: seconds up to the dataset on the device, epochs
# run, seconds in the epoch loop (closed by the last epoch's host read),
# points per second over those seconds
LAST_RUN: dict = {}


@contextlib.contextmanager
def _matmul_precision(precision: Optional[str]):
    """Reduced-precision float32 matmul passes for "bfloat16_mxu", restored
    on exit (the global switch is never left changed)."""
    if precision != "bfloat16_mxu":
        yield
        return
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("medium")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(before)


def use_fused_igr(model, precision: Optional[str]) -> bool:
    """Whether the eikonal fast path is the fused kernels: mixed precision
    asked for, not the Lipschitz variant (the kernels' backward yields weight
    and bias gradients only), and the model on a card (the JAX package's rule,
    trainer.py:147-153, with "on a card" for "the backend is not the CPU")."""
    device = next(model.parameters()).device
    return precision == "bfloat16" and not model.lipschitz and device.type == "cuda"


def bind_apply(model, precision: Optional[str] = None,
               fused_igr: bool = False) -> Callable[[torch.Tensor], torch.Tensor]:
    """The forward a training step differentiates: the module, or for
    "bfloat16" the module run on bfloat16 copies of its float32 master
    parameters and of its input, its output widened back to float32.

    The callable advertises the (f, grad_x f) fast path that
    ``ops.diffops.sdf_and_gradient_fwd`` consumes as ``_implicitnet_fast``:
    the fused kernels (``fused_igr``) or the shared-matmul derivation; for
    "bfloat16" it too runs on bfloat16 copies of the parameters and of ``x``
    and widens its outputs."""
    if fused_igr:
        fast = make_fused_value_and_grad(model)
    else:
        def fast(x, layers=None):
            return implicitnet_value_and_grad(model, x, layers)

    if precision != "bfloat16":
        def apply(x: torch.Tensor) -> torch.Tensor:
            return model(x)

        apply._implicitnet_fast = fast
        return apply

    def apply(x: torch.Tensor) -> torch.Tensor:
        params = {k: (v.to(torch.bfloat16) if v.dtype == torch.float32 else v)
                  for k, v in model.named_parameters()}
        out = torch.func.functional_call(model, params, (x.to(torch.bfloat16),))
        return out.to(torch.float32)

    def fast_mixed(x: torch.Tensor):
        layers = [(w.to(torch.bfloat16), b.to(torch.bfloat16))
                  for w, b in model.effective_layers()]
        value, grad = fast(x.to(torch.bfloat16), layers)
        return value.to(torch.float32), grad.to(torch.float32)

    apply._implicitnet_fast = fast_mixed
    return apply


def make_train_step(model, loss_fn, optimizer: torch.optim.Optimizer,
                    precision: Optional[str] = None, aux=None) -> Callable:
    """(x, y, epoch, generator=None) -> loss (a detached scalar tensor on the
    device): one optimizer update on the batch. ``aux``: the loss's learnable
    scalars (the optimizer must hold them too)."""
    if precision not in PRECISIONS:
        raise ValueError(f"train_matmul_precision must be one of {PRECISIONS}, got {precision!r}")
    apply = bind_apply(model, precision, use_fused_igr(model, precision))
    lipschitz = model.lipschitz and model.lipschitz_weight > 0

    def step(xb: torch.Tensor, yb: torch.Tensor, epoch: int, generator=None) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        with _matmul_precision(precision):
            value = loss_fn(apply, xb, yb, epoch, generator=generator, aux=aux)
            if lipschitz:
                # arXiv:2202.08345 eq. 7: alpha * prod softplus(c_i)
                value = value + model.lipschitz_weight * model.lipschitz_bound()
            value.backward()
        optimizer.step()
        return value.detach()

    return step


class Trainer:
    """Sampling -> training -> checkpointing for one config, and the
    checkpoints' consumers (reconstruction, the accuracy audit).

    ``device``: None runs on the card (and raises without one); "cpu" runs
    the plain PyTorch path. ``compute_dtype`` is the working type of the
    fused evaluation kernels (bfloat16, as in the JAX package's TPU path, or
    float32); training precision is the config's ``train_matmul_precision``.
    """

    def __init__(self, config: Configuration, device=None, init_seed: int = 0,
                 compute_dtype: torch.dtype = torch.bfloat16):
        self.config = config
        self.device = resolve_device(device)
        if self.device.type == "cuda" and not config.use_pallas:
            raise ValueError(
                "use_pallas = False selects the plain PyTorch path, which the "
                "port runs only on the CPU (pass device='cpu')"
            )
        self.init_seed = init_seed
        self.compute_dtype = compute_dtype
        self.geometry_name = config.name

        c = config
        self.main_path = create_directory(
            os.path.join(c.directory, f"r_{self.geometry_name}")
        )
        self.data_path = create_directory(
            os.path.join(
                self.main_path,
                f"config_uniform{c.uniform_points},surface_{c.surface},"
                f"narrowband_{c.narrowband},narrowband_width_{c.narrowband_width}",
            )
        )
        with open(os.path.join(self.data_path, "info.txt"), "w") as f:
            f.write(
                f"config_uniform{c.uniform_points},surface_{c.surface},"
                f"narrowband_{c.narrowband},narrowband_width_{c.narrowband_width}"
            )
        self.model_path = create_directory(
            os.path.join(
                self.data_path,
                f"{c.model_name},hidden_dim_{c.hidden_dim},"
                f"num_hidden_layers_{c.num_hidden_layers},"
                f"skip_connection_{c.skip_connection},beta_{c.beta},"
                f"geometric_init_{c.geometric_init}",
            )
        )
        self.loss_path = create_directory(
            os.path.join(self.model_path, f"loss_{c.loss_name}")
        )
        self.train_path = create_directory(
            os.path.join(
                self.loss_path,
                f"lr_{c.lr},epochs_{c.epochs},min_epochs_{c.minepochs},"
                f"batch_size_{c.batchsize}",
            )
        )
        self.model_save_path = create_directory(os.path.join(self.train_path, "models"))
        self.postprocess_save_path = create_directory(
            os.path.join(self.train_path, "postprocess")
        )
        self.plot_save_path = create_directory(os.path.join(self.train_path, "plots"))

        self.model = config.make_model(
            generator=torch.Generator().manual_seed(init_seed), device=self.device
        )
        self._plot_skip_said = False
        # the loss's learnable scalars (``needs_aux``), made by ``train``
        self.aux: Dict[str, torch.nn.Parameter] = {}

    # -- sampling ----------------------------------------------------------

    def rescale(self) -> str:
        from ..geometry.rescale import rescale_file

        self.rescaled_path = os.path.join(
            self.main_path, self.geometry_name + "_rescaled.stl"
        )
        return rescale_file(self.config.geometry, self.rescaled_path)

    def sampling(self) -> None:
        """Sample and label the training points unless their CSVs exist
        (cf. Executor.sampling, executor.py:86-111)."""
        c = self.config
        if "pcd" in c.name:
            return
        if any(
            os.path.exists(os.path.join(self.data_path, f))
            for f in ("uniform.csv", "surface.csv", "narrow.csv")
        ):
            return
        if c.two_dim:
            raise NotImplementedError(
                "the 2-D circle mode (two_dim = True) is not ported yet: see ROADMAP.md"
            )
        from ..sampling import sampler

        t0 = time.perf_counter()
        geometry_path = self.rescale() if c.rescale else c.geometry
        t1 = time.perf_counter()
        uniform, surface, narrow = sampler.generate_signed_distance_data(
            geometry_path, c.uniform_points, c.surface, c.narrowband,
            c.narrowband_width, device=self.device,
        )
        t2 = time.perf_counter()
        uniform.to_csv(os.path.join(self.data_path, "uniform.csv"))
        surface.to_csv(os.path.join(self.data_path, "surface.csv"))
        narrow.to_csv(os.path.join(self.data_path, "narrow.csv"))
        sampler.LAST_STAGE_SECONDS.update(rescale=t1 - t0, write_csv=time.perf_counter() - t2)

    # -- training ----------------------------------------------------------

    def _make_optimizer(self) -> Tuple[torch.optim.Optimizer, Optional[Any]]:
        """(Adam, scheduler): the scheduler, stepped once per epoch, halves
        (``lr_gamma``) the rate every ``lr_step`` epochs; None without
        ``lr_step``."""
        c = self.config
        optimizer = torch.optim.Adam([*self.model.parameters(), *self.aux.values()], lr=c.lr,
                                     betas=(0.9, 0.999), eps=1e-8)
        scheduler = None
        if c.lr_step and c.lr_step > 0:
            scheduler = torch.optim.lr_scheduler.StepLR(
                optimizer, step_size=c.lr_step, gamma=c.lr_gamma)
        return optimizer, scheduler

    def _epoch_batches(self, epoch: int, n_train: int, batch: int) -> torch.Tensor:
        """(n_batches, batch) row indices of one epoch: a device permutation
        seeded from (init_seed + 1, epoch), the partial batch dropped."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(((self.init_seed + 1) << 32) + epoch)
        n_batches = max(1, n_train // batch)
        perm = torch.randperm(n_train, generator=gen, device=self.device)
        return perm[: n_batches * batch].reshape(n_batches, batch)

    def _step_seed(self, epoch: int, step: int) -> int:
        """Seed of one step's generator: (init_seed + 1, epoch, step)."""
        return ((self.init_seed + 1) << 44) + ((epoch + 1) << 20) + step

    def _validate(self, loss_fn, Xv, Yv, batch: int, epoch: int) -> Optional[torch.Tensor]:
        """Mean float32 loss over min(batch, n_val)-sized validation batches
        (the remainder dropped); None without validation data."""
        n_val = Xv.shape[0]
        if n_val == 0:
            return None
        vb = min(batch, n_val)
        n_vbatches = max(1, n_val // vb)
        apply = bind_apply(self.model)
        gen = torch.Generator(device=self.device)
        losses = []
        with torch.no_grad():
            for i in range(n_vbatches):
                gen.manual_seed(0)
                losses.append(loss_fn(apply, Xv[i * vb:(i + 1) * vb], Yv[i * vb:(i + 1) * vb],
                                      epoch, generator=gen, aux=self.aux))
        return torch.stack(losses).mean()

    def train(self, dataset: Optional[SDFDataset] = None) -> Dict[str, Any]:
        c = self.config
        loss_fn = c.make_loss()
        t_load = time.time()
        if dataset is None:
            self.sampling()
            dataset = load_data(self.data_path, c)

        dev = self.device
        X = torch.from_numpy(dataset.train_x).to(dev)
        Y = torch.from_numpy(dataset.train_y).to(dev)
        Xv = torch.from_numpy(dataset.val_x).to(dev)
        Yv = torch.from_numpy(dataset.val_y).to(dev)

        self.aux = {name: torch.nn.Parameter(torch.tensor(2.0, device=dev))
                    for name in getattr(loss_fn, "needs_aux", ())}
        optimizer, scheduler = self._make_optimizer()
        start_epoch = 0
        train_losses: list = []
        val_losses: list = []
        best_val = float("inf")

        best_path = os.path.join(self.model_save_path, "best_model.ckpt")
        if c.contd and os.path.exists(best_path):
            state = ckpt.load_checkpoint(best_path)
            self.model.load_state_dict(state["model"])
            with torch.no_grad():
                for name, value in state.get("aux", {}).items():
                    self.aux[name].copy_(value)
            if "optimizer" in state:  # optimizer state resumes
                optimizer.load_state_dict(state["optimizer"])
                if scheduler is not None and state.get("scheduler") is not None:
                    scheduler.load_state_dict(state["scheduler"])
            start_epoch = int(state["epoch"]) + 1
            train_losses = list(state.get("train_losses", []))
            val_losses = list(state.get("val_losses", []))
            best_val = float(state.get("best_val", math.inf))
            print(f"Resumed from {best_path} at epoch {start_epoch}")

        batch = min(c.batchsize, dataset.n_train)
        step = make_train_step(self.model, loss_fn, optimizer, c.train_matmul_precision,
                               aux=self.aux)
        step_gen = torch.Generator(device=dev)
        loss_log = os.path.join(self.train_path, "train_loss.txt")
        epochs_no_improve = 0
        points_per_epoch = (dataset.n_train // batch) * batch

        def state_at(epoch: int) -> Dict[str, Any]:
            aux = {name: p.detach().clone() for name, p in self.aux.items()}
            return {
                "model": self.model.state_dict(),
                **({"aux": aux} if aux else {}),
                "epoch": epoch,
                "optimizer": optimizer.state_dict(),
                "scheduler": None if scheduler is None else scheduler.state_dict(),
                "train_losses": list(train_losses),
                "val_losses": list(val_losses),
                "best_val": best_val,
            }

        t_start = time.time()
        final_epoch = start_epoch - 1
        for epoch in range(start_epoch, c.epochs):
            final_epoch = epoch
            losses = []
            for i, idx in enumerate(self._epoch_batches(epoch, dataset.n_train, batch)):
                step_gen.manual_seed(self._step_seed(epoch, i))
                losses.append(step(X[idx], Y[idx], epoch, step_gen))
            if scheduler is not None:
                scheduler.step()
            train_loss = torch.stack(losses).mean()
            val_loss = self._validate(loss_fn, Xv, Yv, batch, epoch)
            # the epoch's one host read
            train_loss, val_loss = torch.stack(
                [train_loss, train_loss if val_loss is None else val_loss]).tolist()
            train_losses.append(train_loss)
            val_losses.append(val_loss)
            with open(loss_log, "a") as f:
                f.write(f"{epoch} {train_loss} {val_loss}\n")
            if val_loss < best_val:
                best_val = val_loss
                epochs_no_improve = 0
                ckpt.save_checkpoint(best_path, state_at(epoch))
            else:
                epochs_no_improve += 1
            if (epoch + 1) % c.checkpointing == 0:
                ckpt.save_checkpoint(
                    os.path.join(self.model_save_path, f"model_epoch{epoch}.ckpt"),
                    state_at(epoch),
                )
                self._plot_losses(train_losses, val_losses)
            if epoch >= c.minepochs and epochs_no_improve >= c.patience:
                print(f"Early stopping at epoch {epoch}")
                break

        elapsed = time.time() - t_start
        n_epochs_run = final_epoch - start_epoch + 1
        throughput = points_per_epoch * n_epochs_run / max(elapsed, 1e-9)
        print(
            f"Training done: {n_epochs_run} epochs, {elapsed:.1f}s, "
            f"{throughput:,.0f} points/sec"
        )
        self._plot_losses(train_losses, val_losses)
        LAST_RUN.update(load_seconds=t_start - t_load, epochs_run=n_epochs_run, seconds=elapsed,
                        points_per_sec=throughput)
        return {
            "train_losses": train_losses,
            "val_losses": val_losses,
            "best_val": best_val,
            "epochs_run": n_epochs_run,
            "points_per_sec": throughput,
            "last_epoch": final_epoch,
        }

    # -- checkpoint loading -------------------------------------------------

    def load_model(self, best: bool = True) -> Tuple[Dict[str, torch.Tensor], int]:
        """Load best_model.ckpt (``best``) or the newest model_epoch*.ckpt
        into ``self.model``; returns (state_dict, epoch)."""
        best_path = os.path.join(self.model_save_path, "best_model.ckpt")
        newest = ckpt.latest_epoch_checkpoint(self.model_save_path)
        if best and os.path.exists(best_path) or newest is None:
            if not os.path.exists(best_path):
                raise FileNotFoundError(f"No checkpoint found in {self.model_save_path}")
            state = ckpt.load_checkpoint(best_path)
            epoch = int(state["epoch"])
        else:
            state = ckpt.load_checkpoint(newest[0])
            epoch = newest[1]
        self.model.load_state_dict(state["model"])
        return state["model"], epoch

    # -- plots -------------------------------------------------------------

    def _plot_losses(self, train_losses, val_losses) -> None:
        """loss_curve.png where matplotlib is installed; one line where not."""
        try:
            import matplotlib
        except ImportError:
            if not self._plot_skip_said:
                print("loss plot skipped: matplotlib is not installed")
                self._plot_skip_said = True
            return
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots()
        ax.plot(train_losses, label="train")
        ax.plot(val_losses, label="val")
        ax.set_xlabel("epoch")
        ax.set_ylabel("loss")
        ax.set_yscale("log")
        ax.legend()
        fig.savefig(os.path.join(self.plot_save_path, "loss_curve.png"), dpi=100)
        plt.close(fig)

    # -- mode dispatch (cf. Executor.run, executor.py:481-499) -------------

    def run(self):
        c = self.config
        if c.samplingonly:
            return self.sampling()
        if c.ppo:
            if c.reconstruct:
                from ..evaluations.reconstruct import reconstruct_only

                return reconstruct_only(self, compute_dtype=self.compute_dtype)
            from ..evaluations.post_process import post_process

            return post_process(self)
        if c.two_dim:
            raise NotImplementedError(
                "the 2-D circle mode (two_dim = True) is not ported yet: see ROADMAP.md"
            )
        return self.train()
