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
  * ``epochs_per_call`` epochs and their validation run as one block, as
    the JAX trainer's multi-epoch call does (its trainer.py:566-665): the
    best-validation epoch's parameters, ``aux`` scalars, optimizer and
    scheduler state are kept on the device within the block
    (``graphs.BestSnapshot``), the host reads the losses once per block, then
    writes the loss log, ``best_model.ckpt`` from that snapshot (its epoch and
    history), ``model_epoch{E}.ckpt`` at the JAX cadence ``(block_end %
    checkpointing) < block or block >= checkpointing``, and on an early stop
    inside a block adopts the device's best, as JAX does; a final partial
    block ends at ``epochs``. The trajectory does not depend on the block:
    ``epochs_per_call = k`` gives the losses and parameters of ``k = 1``.
  * on a card every training step and every validation batch is one
    replay of a CUDA graph (training/graphs.py: the JAX trainer's jitted
    epoch): with one device, under a mesh whose entries all name one card
    (the whole sharded step), and under a process group over NCCL (each
    rank its own step, the collectives inside it). Under a mesh of distinct
    cards in one process or a gloo group, with ``debug_nans``, on the CPU,
    or when ``train(eager=True)`` asks, the same step runs as a plain call
    (``graphs.captures``). Adam is ``capturable`` on a card either way
    (``graphs.make_adam``).
  * a loss's learnable scalars (``needs_aux``: GaussBonnetLoss's Euler
    characteristic, initial value 2.0) are parameters beside the model's:
    given to Adam, saved in the checkpoints under ``"aux"`` (a key that
    checkpoints of the other losses do not have).
  * every step gets a ``torch.Generator`` on the device seeded from
    (init_seed + 1, epoch, step) for losses that draw points (IGRLOSSPCD);
    validation seeds it with 0.

The matrix products of the supervised step are library matmuls here as
they are XLA's there: that step has no hand-written kernel in either
package. The eikonal (IGR) step of an ImplicitNet does:
(f, grad_x f) and its parameter gradients run through the hand-written
kernels of ops/fused_igr.py under the JAX package's rule
(``use_fused_igr``): ``train_matmul_precision = bfloat16``, not the
Lipschitz variant, and the model on a card. There the fast path IS the
kernel (a build or launch failure raises). In every other configuration it
is ``ops.diffops.implicitnet_value_and_grad`` under torch autograd, which is
what the JAX package leaves to XLA. Validation always takes the latter, in
float32, as the JAX package's does. The other families (HashMLP,
FeedForwardNetwork, Siren, KAN) have no fast path in either package: their
(f, grad_x f) is forward-mode passes, as ``jax.jvp`` serves them there.

``train_matmul_precision``:
  None            float32 everywhere.
  "bfloat16"      float32 master weights and optimizer state; forward and
                  backward run on bfloat16 copies of every float32 leaf of
                  the model's state (parameters and buffers: hash tables,
                  KAN knot grids) and of the inputs, the loss in float32.
                  The forward noise of this mode can hold the clamp-family
                  losses on their all-clipped plateau at lr >= 1e-4
                  (measured in the JAX package).
  "bfloat16_mxu"  float32 tensors whose matrix products may use reduced-
                  precision tensor-core passes
                  (``torch.set_float32_matmul_precision("medium")``), set for
                  the step and restored after it: per-product rounding
                  instead of stored-activation rounding.
  the other names ``jax.default_matmul_precision`` takes, mapped onto
  ``torch.set_float32_matmul_precision`` for the step and restored after
  it: "float32" and "highest" -> "highest", "tensorfloat32" and "high" ->
  "high"; "default" leaves the setting as it is. Any other name raises,
  as it does in JAX.

``[TPU] debug_nans = True`` turns on ``torch.autograd.set_detect_anomaly``
(the JAX Trainer's ``jax_debug_nans``, the reference's anomaly detection):
a backward that makes a NaN raises.
"""

from __future__ import annotations

import copy
import inspect
import math
import os
import time
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..configgen.config_reader import Configuration
from ..data.dataset import SDFDataset, load_data
from ..models.implicit_net import ImplicitNet
from ..ops.diffops import implicitnet_value_and_grad
from ..ops.fused_igr import make_fused_value_and_grad, make_fused_value_and_grad_sharded
from ..parallel.mesh import (ProcessMesh, allreduce_grads, count_once, gather, get_mesh,
                             over_ranks, replicate, shard_batch)
from ..parallel.multihost import process_count
from ..utils.device import matmul_precision, resolve_device
from ..utils.files import create_directory
from ..utils.profiling import span
from . import checkpoint as ckpt
from . import graphs

# train_matmul_precision names besides None and "bfloat16" (the mixed-
# precision step), each with the torch float32 matmul precision its step
# runs under (None: the setting is left as it is)
_TORCH_PRECISION = {"bfloat16_mxu": "medium", "float32": "highest", "highest": "highest",
                    "tensorfloat32": "high", "high": "high", "default": None}
PRECISIONS = (None, "bfloat16", *_TORCH_PRECISION)

# the last ``Trainer.train`` / ``PointCloudTrainer.train``: seconds up to the
# dataset on the device, epochs run, seconds in the epoch loop (closed by the
# last host read), points per second over those seconds, whether the steps
# were graph replays and the seconds their capture took (before the loop)
LAST_RUN: dict = {}


def _matmul_precision(precision: Optional[str]):
    """The float32 matmul precision a ``train_matmul_precision`` name asks
    for (``_TORCH_PRECISION``), restored on exit (the global switch is never
    left changed)."""
    return matmul_precision(_TORCH_PRECISION.get(precision))


def use_fused_igr(model, precision: Optional[str]) -> bool:
    """Whether the eikonal fast path is the fused kernels: an ImplicitNet
    (the kernels compute its forward), mixed precision asked for, not the
    Lipschitz variant (the kernels' backward yields weight and bias
    gradients only), and the model on a card (the JAX package's rule,
    trainer.py:147-153, with "on a card" for "the backend is not the CPU")."""
    device = next(model.parameters()).device
    return (isinstance(model, ImplicitNet) and precision == "bfloat16"
            and not model.lipschitz and device.type == "cuda")


def takes_train(model) -> bool:
    """Whether the model's forward takes ``train`` (FFN dropout): the step
    then runs it with ``train=True`` and the step's generator (JAX
    trainer.py:69-70)."""
    return "train" in inspect.signature(model.forward).parameters


def bind_apply(model, precision: Optional[str] = None, fused_igr: bool = False,
               mesh=None, generator: Optional[torch.Generator] = None,
               masks: Optional[graphs.DropoutMasks] = None
               ) -> Callable[[torch.Tensor], torch.Tensor]:
    """The forward a training step differentiates: the module, or for
    "bfloat16" the module run on bfloat16 copies of every float32 leaf of
    its state (parameters and buffers, as JAX's ``_cast_bf16`` casts every
    float32 leaf: hash tables, KAN knot grids) and of its input, its output
    widened back to float32. A model whose forward takes ``train`` (FFN
    dropout) runs with ``train=True`` when a ``generator`` is given (the
    step's; validation passes none, and the JAX apply drops nothing without
    an rng): every call of the returned forward draws the same masks, as
    the JAX step's apply is a function of its rng, so the value and the
    forward-mode passes of an eikonal loss see one network. A step that is
    bound once and run many times passes ``masks`` instead
    (``graphs.DropoutMasks``, reseeded per step), which a graph can hold.

    For an ImplicitNet the callable advertises the (f, grad_x f) fast path
    that ``ops.diffops.sdf_and_gradient_fwd`` consumes as
    ``_implicitnet_fast``: the fused kernels (``fused_igr``) or the
    shared-matmul derivation; for "bfloat16" it too runs on bfloat16 copies
    of the parameters and of ``x`` and widens its outputs. Other families
    advertise none and take the forward-mode passes, as ``jax.jvp`` serves
    them in the JAX package.

    Under a ``mesh`` of more than one entry (JAX trainer.py:51-94) the batch
    is cut over the mesh (``parallel.mesh.shard_batch``): each shard runs the
    module through ``torch.func.functional_call`` on the state replicated to
    its device, and the fast path per shard (the sharded fused op, or the
    derivation on the replicated layers); the outputs gather on
    ``mesh[0]``, and autograd sums the shards' parameter gradients there. A
    batch smaller than the mesh (a per-point transform's single row) runs
    whole on ``mesh[0]``.

    Under a ``ProcessMesh`` (one process per card over a process group)
    the module and the fast path run on this rank's rows of the batch and
    their outputs are gathered on every rank (``parallel.mesh.over_ranks``);
    a batch smaller than the group runs whole on every rank, its parameter
    gradient counted from rank 0 only. Dropout draws its masks from the same
    seed on every rank, as each shard does under a mesh of one process."""
    mixed = precision == "bfloat16"
    group = isinstance(mesh, ProcessMesh)
    sharded = not group and mesh is not None and len(mesh) > 1
    # every call of one step's forward draws the same masks (JAX's apply is a
    # function of its rng), from a stream apart from the loss's draws: the
    # step generator's seed with its top bit flipped
    if not takes_train(model):
        masks = None
    elif masks is None and generator is not None:
        masks = graphs.DropoutMasks(generator.device)
        masks.reseed(generator.initial_seed() ^ (1 << 63))

    def kwargs() -> dict:
        gen = None if masks is None else masks.next()
        return {} if gen is None else {"generator": gen, "train": True}

    def cast(t: torch.Tensor) -> torch.Tensor:
        return t.to(torch.bfloat16) if mixed and t.dtype == torch.float32 else t

    def state() -> Dict[str, torch.Tensor]:
        return {k: cast(v) for k, v in (*model.named_parameters(), *model.named_buffers())}

    def whole(x: torch.Tensor) -> torch.Tensor:
        if not mixed:
            return model(x, **kwargs())
        return torch.func.functional_call(model, state(), (x,), kwargs())

    forward = whole
    if group:
        def forward(x: torch.Tensor) -> torch.Tensor:
            leaves = state()
            return over_ranks(lambda xs, ps: torch.func.functional_call(
                model, dict(zip(leaves, ps)), (xs,), kwargs()), x, list(leaves.values()), mesh)
    elif sharded:
        def forward(x: torch.Tensor) -> torch.Tensor:
            if x.shape[0] < len(mesh):
                return whole(x)
            leaves = state()
            reps = replicate(list(leaves.values()), mesh)
            return gather([torch.func.functional_call(model, dict(zip(leaves, ps)), (xs,),
                                                      kwargs())
                           for xs, ps in zip(shard_batch(x, mesh), reps)], mesh[0])

    def apply(x: torch.Tensor) -> torch.Tensor:
        if not mixed:
            return forward(x)
        return forward(x.to(torch.bfloat16)).to(torch.float32)

    if not isinstance(model, ImplicitNet):
        return apply

    if fused_igr:
        fast = (make_fused_value_and_grad_sharded(model, mesh) if sharded or group
                else make_fused_value_and_grad(model))
    elif group:
        def fast(x, layers=None):
            flat = [t for pair in (model.effective_layers() if layers is None else layers)
                    for t in pair]
            return over_ranks(lambda xs, ps: implicitnet_value_and_grad(
                model, xs, list(zip(ps[0::2], ps[1::2]))), x, flat, mesh)
    elif sharded:
        def fast(x, layers=None):
            flat = [t for pair in (model.effective_layers() if layers is None else layers)
                    for t in pair]
            parts = [implicitnet_value_and_grad(model, xs, list(zip(ps[0::2], ps[1::2])))
                     for xs, ps in zip(shard_batch(x, mesh), replicate(flat, mesh))]
            return gather([v for v, _ in parts], mesh[0]), gather([g for _, g in parts], mesh[0])
    else:
        def fast(x, layers=None):
            return implicitnet_value_and_grad(model, x, layers)

    if not mixed:
        apply._implicitnet_fast = fast
        return apply

    def fast_mixed(x: torch.Tensor):
        layers = [(w.to(torch.bfloat16), b.to(torch.bfloat16))
                  for w, b in model.effective_layers()]
        value, grad = fast(x.to(torch.bfloat16), layers)
        return value.to(torch.float32), grad.to(torch.float32)

    apply._implicitnet_fast = fast_mixed
    return apply


def make_train_step(model, loss_fn, optimizer: torch.optim.Optimizer,
                    precision: Optional[str] = None, aux=None, mesh=None) -> Callable:
    """(x, y, epoch, generator=None) -> loss (a detached scalar tensor on the
    device): one optimizer update on the batch. ``aux``: the loss's learnable
    scalars (the optimizer must hold them too). ``generator``: the step's
    draws, for the loss (IGRLOSSPCD's points) and the model (FFN dropout),
    as the JAX step hands both its ``rng``. ``mesh``: the forward runs
    sharded (``bind_apply``) while the loss is taken on ``mesh[0]`` over the
    whole gathered batch, with the step's one generator: a sharded step's
    loss, and any points the loss draws, are the single-device step's, as
    XLA's global-batch semantics make them in the JAX package.

    Under a ``ProcessMesh`` every rank takes that loss on the gathered
    batch; the terms every rank computes whole (the Lipschitz bound, the
    loss's ``aux`` scalars) keep their gradients on rank 0 only
    (``count_once``), and one all-reduce sums the gradients before the
    update, so every rank makes the same update.

    ``step.body`` is the same step without reseeding the dropout masks
    (``step.masks``, None for a model without dropout): what
    ``graphs.StepRunner`` captures, the masks reseeded apart."""
    if precision not in PRECISIONS:
        raise ValueError(f"train_matmul_precision must be one of {PRECISIONS}, got {precision!r}")
    fused = use_fused_igr(model, precision)
    masks = (graphs.DropoutMasks(next(model.parameters()).device) if takes_train(model)
             else None)
    apply = bind_apply(model, precision, fused, mesh, masks=masks)
    lipschitz = getattr(model, "lipschitz", False) and model.lipschitz_weight > 0
    params = [p for g in optimizer.param_groups for p in g["params"]]
    group = isinstance(mesh, ProcessMesh)

    def body(xb: torch.Tensor, yb: torch.Tensor, epoch, generator=None) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        with _matmul_precision(precision):
            value = loss_fn(apply, xb, yb, epoch, generator=generator,
                            aux=None if aux is None else {k: count_once(v, mesh)
                                                          for k, v in aux.items()})
            if lipschitz:
                # arXiv:2202.08345 eq. 7: alpha * prod softplus(c_i)
                value = value + model.lipschitz_weight * count_once(model.lipschitz_bound(), mesh)
            if value.requires_grad or not group:  # a rank whose terms all count on rank 0
                value.backward()
        if group:
            allreduce_grads(params)
        optimizer.step()
        return value.detach()

    def step(xb: torch.Tensor, yb: torch.Tensor, epoch: int, generator=None) -> torch.Tensor:
        if masks is not None:
            masks.reseed(None if generator is None else generator.initial_seed() ^ (1 << 63))
        return body(xb, yb, epoch, generator)

    # what a graph captures (training/graphs.py): the step without its
    # reseeding, and the dropout generators it reseeds
    step.body, step.masks = body, masks
    return step


class Trainer:
    """Sampling -> training -> checkpointing for one config, and the
    checkpoints' consumers (reconstruction, the accuracy audit).

    ``device``: None runs on the card (and raises without one); "cpu" runs
    the plain PyTorch path. ``mesh``: a tuple of devices
    (``parallel.mesh.get_mesh``) over which training and validation shard
    their batches (data-parallel, one process; JAX trainer.py:391-393); the
    master parameters, the optimizer state and the data live on ``mesh[0]``,
    which ``device``, if given, must be. Under a process group ``mesh`` is
    its ``ProcessMesh`` (``parallel.mesh.process_mesh``; one device per
    rank, the rank's own): ``[TPU] mesh_devices``, where set, counts the
    devices of every rank, as ``jax.devices()`` does after
    ``jax.distributed.initialize``, so it must equal the group's size. Rank 0
    then writes every file (info.txt, the sampled CSVs, the loss log,
    checkpoints, the plot) and runs labelling, the audit and
    reconstruction; the other ranks wait at a barrier before they read
    what it wrote. ``compute_dtype`` is the working
    type of the fused evaluation kernels (bfloat16, as in the JAX package's
    TPU path, or float32); training precision is the config's
    ``train_matmul_precision``.
    """

    def __init__(self, config: Configuration, device=None, mesh=None, init_seed: int = 0,
                 compute_dtype: torch.dtype = torch.bfloat16):
        self.config = config
        if isinstance(mesh, ProcessMesh):
            if device is not None and get_mesh(devices=[device])[0] != mesh.device:
                raise ValueError(f"device {device} is not this rank's device {mesh.device}")
            if config.mesh_devices and config.mesh_devices != len(mesh):
                raise ValueError(
                    f"mesh_devices = {config.mesh_devices} under a process group of "
                    f"{len(mesh)} ranks: it counts the devices of every rank, one each")
            device = mesh.device
        elif mesh is not None:
            mesh = get_mesh(devices=mesh)
            if len(mesh) > 1 and process_count() > 1:
                raise ValueError("under a process group each rank drives one device: "
                                 "pass parallel.mesh.process_mesh(), not a tuple of devices")
            if device is not None and get_mesh(devices=[device])[0] != mesh[0]:
                raise ValueError(f"device {device} is not the mesh's first device {mesh[0]}")
            device = mesh[0]
        self.mesh = mesh
        self.device = resolve_device(device)
        if self.device.type == "cuda" and not config.use_pallas:
            raise ValueError(
                "use_pallas = False selects the plain PyTorch path, which the "
                "port runs only on the CPU (pass device='cpu')"
            )
        self.init_seed = init_seed
        self.compute_dtype = compute_dtype
        self.geometry_name = config.name
        if config.debug_nans:
            torch.autograd.set_detect_anomaly(True)

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
        if self.writes:
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

    @property
    def writes(self) -> bool:
        """Whether this process writes the run's files: rank 0 under a
        process group, always without one."""
        return not isinstance(self.mesh, ProcessMesh) or self.mesh.rank == 0

    def _after_rank0(self) -> None:
        """Under a process group, wait until every rank (rank 0 done with
        its writes) arrives; nothing without one."""
        if isinstance(self.mesh, ProcessMesh):
            torch.distributed.barrier()

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
        from ..sampling import sampler

        if c.two_dim:
            # the analytic circle at z = 0 (JAX trainer.py:468-475)
            sampler.generate_points_circle(c.uniform_points, c.surface, c.narrowband,
                                           c.narrowband_width, save_path=self.data_path)
            return

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
        """(Adam, scheduler): Adam as ``graphs.make_adam`` makes it
        (capturable on a card); the scheduler, stepped once per epoch,
        halves (``lr_gamma``) the rate every ``lr_step`` epochs; None
        without ``lr_step``."""
        c = self.config
        optimizer = graphs.make_adam([*self.model.parameters(), *self.aux.values()], c.lr,
                                     self.device)
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

    def _captures(self, eager: bool) -> bool:
        """``graphs.captures`` for this trainer's device, mesh, group and
        config: whether its steps and validation batches are graph replays."""
        backend = (torch.distributed.get_backend() if isinstance(self.mesh, ProcessMesh)
                   else None)
        return graphs.captures(self.device, self.mesh, backend, self.config.debug_nans, eager)

    def _run_epoch(self, runner: graphs.StepRunner, epoch: int, n_train: int,
                   batch: int) -> torch.Tensor:
        """One epoch's steps -> their mean loss (a 0-d tensor on the device),
        the per-step losses summed in step order."""
        rows = self._epoch_batches(epoch, n_train, batch)
        losses = torch.empty(rows.shape[0], dtype=torch.float32, device=self.device)
        for i in range(rows.shape[0]):
            losses[i] = runner(rows[i], epoch, self._step_seed(epoch, i))
        return losses.mean()

    def train(self, dataset: Optional[SDFDataset] = None, *, eager: bool = False) -> Dict[str, Any]:
        """Train for the config's epochs in blocks of ``epochs_per_call``.
        ``eager``: run every step and validation batch as a plain call where
        a card would replay a graph (the reference the tests and
        chip_smoke.py hold the graphs against)."""
        c = self.config
        loss_fn = c.make_loss()
        t_load = time.time()
        if dataset is None and self.writes:
            self.sampling()
        # the other ranks read the CSVs, and a checkpoint to resume from, after rank 0
        self._after_rank0()
        if dataset is None:
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
                graphs.load_optimizer_state(optimizer, state["optimizer"])
                if scheduler is not None and state.get("scheduler") is not None:
                    scheduler.load_state_dict(state["scheduler"])
            start_epoch = int(state["epoch"]) + 1
            train_losses = list(state.get("train_losses", []))
            val_losses = list(state.get("val_losses", []))
            best_val = float(state.get("best_val", math.inf))
            print(f"Resumed from {best_path} at epoch {start_epoch}")

        batch = min(c.batchsize, dataset.n_train)
        step = make_train_step(self.model, loss_fn, optimizer, c.train_matmul_precision,
                               aux=self.aux, mesh=self.mesh)
        runner = graphs.StepRunner(lambda idx, e, g: step.body(X[idx], Y[idx], e, g), dev,
                                   step.masks)
        validate = None
        if dataset.n_val:
            # min(batch, n_val)-sized validation batches, the remainder dropped
            vb = min(batch, dataset.n_val)
            apply = bind_apply(self.model, mesh=self.mesh)

            def val_body(idx, epoch, generator):
                with torch.no_grad():
                    return loss_fn(apply, Xv[idx], Yv[idx], epoch, generator=generator, aux=self.aux)

            validate = graphs.ValRunner(
                val_body, torch.arange(dataset.n_val // vb * vb, device=dev).view(-1, vb))
        captured = self._captures(eager)
        t_capture = time.perf_counter()
        if captured:
            runner.capture(torch.arange(batch, device=dev),
                           lambda: graphs.state_tensors(self.model, self.aux, optimizer))
            if validate is not None:
                validate.capture()
            torch.cuda.synchronize(dev)
        capture_s = time.perf_counter() - t_capture
        loss_log = os.path.join(self.train_path, "train_loss.txt")
        epochs_no_improve = 0
        points_per_epoch = (dataset.n_train // batch) * batch
        epochs_per_call = max(1, c.epochs_per_call)

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

        def host_record() -> Dict[str, Any]:
            """What the device snapshot does not hold: a rate kept as a float
            (CPU) and the scheduler's state, per epoch."""
            return {"lr": [None if isinstance(g["lr"], torch.Tensor) else g["lr"]
                           for g in optimizer.param_groups],
                    "scheduler": None if scheduler is None else copy.deepcopy(scheduler.state_dict())}

        def best_state(snap: graphs.BestSnapshot, k: int, epoch: int, tl: list, vl: list):
            """The block's best epoch ``k`` from the device snapshot."""
            best = snap.swap({"model": self.model.state_dict(keep_vars=True), "aux": dict(self.aux),
                              "optimizer": optimizer.state_dict()})
            for group, lr in zip(best["optimizer"]["param_groups"], snap.host[k]["lr"]):
                if lr is not None:
                    group["lr"] = lr
            return {"model": best["model"], **({"aux": best["aux"]} if self.aux else {}),
                    "epoch": epoch, "optimizer": best["optimizer"],
                    "scheduler": snap.host[k]["scheduler"], "train_losses": tl,
                    "val_losses": vl, "best_val": best_val}

        t_start = time.time()
        final_epoch = start_epoch - 1
        snap: Optional[graphs.BestSnapshot] = None
        epoch0, stop = start_epoch, False
        # the loop's window in a torch.profiler trace (chip_smoke.py and
        # portbench/metrics read it); the spans inside are per epoch and per
        # block, never per step or validation batch
        with span("training_loop"):
            while epoch0 < c.epochs and not stop:
                # one block (JAX trainer.py:585-667): its epochs on the device,
                # then one host read of its losses and best epoch
                block = min(epochs_per_call, c.epochs - epoch0)
                tls, vls = [], []
                for k in range(block):
                    epoch = epoch0 + k
                    with span("train.steps"):
                        train_loss = self._run_epoch(runner, epoch, dataset.n_train, batch)
                        if scheduler is not None:
                            scheduler.step()
                    if validate is None:
                        val_loss = train_loss
                    else:
                        with span("train.validate"):
                            val_loss = validate(epoch)
                    with span("train.snapshot"):
                        if snap is None:  # Adam's state exists after the first step
                            snap = graphs.BestSnapshot(
                                graphs.state_tensors(self.model, self.aux, optimizer))
                        if k == 0:
                            snap.start(best_val)
                        snap.offer(k, val_loss, host_record())
                    tls.append(train_loss)
                    vls.append(val_loss)
                with span("train.block_end"):
                    read = torch.cat([torch.stack(tls), torch.stack(vls),
                                      snap.idx.to(torch.float32).reshape(1)]).tolist()
                    tl_vec, vl_vec, best_k = read[:block], read[block:2 * block], int(read[-1])

                    lines = []
                    for k in range(block):
                        epoch = epoch0 + k
                        final_epoch = epoch
                        train_losses.append(tl_vec[k])
                        val_losses.append(vl_vec[k])
                        lines.append(f"{epoch} {tl_vec[k]} {vl_vec[k]}\n")
                        if vl_vec[k] < best_val:
                            best_val = vl_vec[k]
                            epochs_no_improve = 0
                        else:
                            epochs_no_improve += 1
                        if epoch >= c.minepochs and epochs_no_improve >= c.patience:
                            print(f"Early stopping at epoch {epoch}")
                            stop = True
                            break
                    if self.writes:
                        with open(loss_log, "a") as f:
                            f.writelines(lines)
                with span("train.checkpoint"):
                    if best_k >= 0:
                        # the device kept the block's best epoch (it compares the
                        # same float32 losses as the host loop, so every improvement
                        # the host saw is one): save THAT state. After an early stop
                        # inside the block it may come from an epoch after the stop
                        # (JAX trainer.py:624-657): adopt it, with the history
                        # reaching its epoch
                        best_val = vl_vec[best_k]
                        hist_end = max(final_epoch - epoch0, best_k) + 1
                        kept = len(train_losses) - (final_epoch - epoch0 + 1)
                        if self.writes:
                            ckpt.save_checkpoint(best_path, best_state(
                                snap, best_k, epoch0 + best_k,
                                train_losses[:kept] + tl_vec[:hist_end],
                                val_losses[:kept] + vl_vec[:hist_end]))
                    block_end = epoch0 + block
                    if (((block_end % c.checkpointing) < block or block >= c.checkpointing)
                            and self.writes):
                        ckpt.save_checkpoint(
                            os.path.join(self.model_save_path, f"model_epoch{final_epoch}.ckpt"),
                            state_at(final_epoch),
                        )
                        self._plot_losses(train_losses, val_losses)
                epoch0 = block_end

        elapsed = time.time() - t_start
        n_epochs_run = final_epoch - start_epoch + 1
        throughput = points_per_epoch * n_epochs_run / max(elapsed, 1e-9)
        print(
            f"Training done: {n_epochs_run} epochs, {elapsed:.1f}s, "
            f"{throughput:,.0f} points/sec"
        )
        if self.writes:
            self._plot_losses(train_losses, val_losses)
        LAST_RUN.clear()
        LAST_RUN.update(load_seconds=t_start - t_load, epochs_run=n_epochs_run, seconds=elapsed,
                        points_per_sec=throughput, graphed=captured, capture_s=capture_s,
                        epochs_per_call=epochs_per_call)
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
        """Under a process group, labelling, the audit, reconstruction and
        the 2-D contour run on rank 0 while the other ranks wait."""
        c = self.config
        if c.samplingonly or c.ppo:
            result = self._rank0_mode() if self.writes else None
            self._after_rank0()
            return result
        result = self.train()
        if c.two_dim:
            from ..evaluations.two_dim import two_dim_contour

            if self.writes:
                two_dim_contour(self)
            self._after_rank0()
        return result

    def _rank0_mode(self):
        c = self.config
        if c.samplingonly:
            return self.sampling()
        if c.reconstruct:
            from ..evaluations.reconstruct import reconstruct_only

            return reconstruct_only(self, compute_dtype=self.compute_dtype)
        from ..evaluations.post_process import post_process

        return post_process(self)
