"""The device-resident epoch of the port's trainers: every training step
and every validation batch one replay of a CUDA graph, and the best epoch
of an ``epochs_per_call`` block kept on the device.

Counterpart of the JAX trainer's ``make_epoch_fn``, ``make_val_fn`` and
``make_multi_epoch_fn`` (sdf_representation_tpu/training/trainer.py:202-376).
There an epoch is one jitted call (a permutation, then a ``lax.scan`` over
its steps), and a block of ``epochs_per_call`` epochs with their validation
is one call, so that the host's dispatch stays off the steps. Here one step
(forward, loss, backward and the Adam update) is captured once as a
``torch.cuda.CUDAGraph`` and replayed once per batch (``StepRunner``), and
one validation batch likewise (``ValRunner``):

  * between two replays the host copies the batch's index row into the
    graph's static index, reseeds the step's generators and copies the loss
    out of the graph's static output: a few launches a step outside the
    graph. Every generator the step draws from is registered with the graph
    (``CUDAGraph.register_generator_state``), so a replay after
    ``manual_seed(s)`` draws what the eager step draws after it.
  * an epoch is not one graph: every step reseeds its generator from
    (init_seed + 1, epoch, step), and a seed is set on the host, between
    replays. The epoch's permutation stays a few eager launches.
  * under the graph the loss gets ``epoch`` as a 0-d int64 tensor on the
    device, filled before the epoch's first replay (the JAX step gets it
    traced); eagerly it gets the int.
  * a capture first runs the step ``WARMUP`` times on a side stream (the
    kernels' libraries load, the caches of ops/fused_*.py fill, cuBLAS
    picks its kernels, Adam makes its state) and then puts every tensor of
    the training state back as it was, zeroing the state the warm-up made
    (a fresh Adam's moments and step are zeros), so the first replay is the
    first step.
  * replays do not call the kernels' wrappers, so ``Graph.replay`` adds the
    launches its capture recorded to their counters (``LAUNCHES`` of
    ops/fused_igr.py, ops/fused_mlp.py and ops/sdf_streams.py); the capture
    launches nothing and counts nothing, the warm-up's launches count.

The sharded steps are captured too (``captures`` is the rule): under a
mesh whose entries all name one card the whole sharded step, every shard's
launches in one graph; under a process group over NCCL each rank its own
step, the collectives (``parallel.mesh``: the rows' gather, the gradients'
all-reduce) inside the graph. Every rank replays the same step, so the
collectives are issued in the same order on every rank; the warm-up's
eager steps create the NCCL communicator before the capture.

The same runners run the step as a plain call where nothing was captured:
on the CPU, under a mesh of distinct cards in one process or a gloo group,
with ``debug_nans``, or when the caller asks (the trainers' ``eager``
keyword). That eager run is the plain version the tests and chip_smoke.py
hold the graph against. A capture or a replay that fails raises; nothing
falls back to the eager step.

On a card the trainers' Adam is ``capturable`` with its rate a device
tensor (``make_adam``), graphed or eager, so that both run the same
arithmetic; ``StepLR`` fills that tensor in place between epochs.
``BestSnapshot`` is the block's ``best_tr`` / ``best_st`` / ``best_idx``.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

from ..ops import fused_igr, fused_mlp, sdf_streams
from ..parallel.mesh import ProcessMesh

WARMUP = 3  # eager calls of a step before its capture
# the kernels' launch counters that replays add to
COUNTERS = (fused_igr.LAUNCHES, fused_mlp.LAUNCHES, sdf_streams.LAUNCHES)


def captures(device, mesh, backend: Optional[str], debug_nans: bool, eager: bool) -> bool:
    """Whether a trainer's training steps and validation batches run as
    CUDA-graph replays: on a card (``device``, the trainer's) alone, under a
    mesh whose entries all name that card, or under a ``ProcessMesh`` whose
    group's ``backend`` is NCCL; unless ``eager`` (the caller asks) or
    ``debug_nans``. Where it does not capture for a reason of its own it
    prints one line that says why. Decided before any capture: a capture
    that fails raises, it never selects the eager step."""
    if eager:
        return False
    why = None
    if torch.device(device).type != "cuda":
        why = "the CPU has no CUDA graphs"
    elif isinstance(mesh, ProcessMesh) and backend != "nccl":
        why = (f"a {backend} process group stages every CUDA tensor through the host, outside "
               "any stream")
    elif mesh is not None and not isinstance(mesh, ProcessMesh) and len(set(mesh)) > 1:
        why = ("a mesh of distinct cards in one process: a graph's memory pool and its capture "
               "belong to one device, and the shards' copies cross devices")
    elif debug_nans:
        why = "debug_nans reads every backward on the host"
    if why is not None:
        print(f"training steps run eagerly: {why}")
    return why is None


def make_adam(params, lr: float, device: torch.device) -> torch.optim.Adam:
    """The trainers' Adam (optax's ``adam`` defaults: b1 0.9, b2 0.999, eps
    1e-8 outside the root). On a card ``capturable``, its rate a float32
    tensor on the device that a graph reads at every replay; on the CPU,
    where Adam cannot be capturable, the rate is a float."""
    if torch.device(device).type == "cuda":
        lr = torch.tensor(lr, dtype=torch.float32, device=device)
        return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8, capturable=True)
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)


def load_optimizer_state(optimizer: torch.optim.Optimizer, state: Dict[str, Any]) -> None:
    """``optimizer.load_state_dict(state)`` from a checkpoint written on
    either device, keeping this optimizer's own rate tensors (the loaded
    rate filled in: a graph holds their addresses) and ``capturable``
    flags, each ``step`` where Adam keeps it: on the parameter's device
    when capturable, on the host when not."""
    own = [(group["lr"], group.get("capturable", False)) for group in optimizer.param_groups]
    optimizer.load_state_dict(state)
    for group, (lr, capturable) in zip(optimizer.param_groups, own):
        loaded = float(group["lr"])
        if isinstance(lr, torch.Tensor):
            lr.fill_(loaded)
            group["lr"] = lr
        else:
            group["lr"] = loaded
        group["capturable"] = capturable
        for p in group["params"]:
            st = optimizer.state.get(p, {})
            if "step" in st:
                st["step"] = st["step"].to(dtype=torch.float32,
                                           device=p.device if capturable else "cpu")


def state_tensors(model, aux: Dict[str, torch.Tensor], optimizer) -> List[torch.Tensor]:
    """Every tensor of the training state, in a fixed order: the model's
    parameters and buffers, the loss's ``aux`` scalars, each group's rate
    where it is a tensor, and the optimizer's per-parameter state."""
    out = [*model.state_dict(keep_vars=True).values(), *aux.values()]
    for group in optimizer.param_groups:
        if isinstance(group["lr"], torch.Tensor):
            out.append(group["lr"])
        for p in group["params"]:
            out += [v for v in optimizer.state.get(p, {}).values() if isinstance(v, torch.Tensor)]
    return out


class DropoutMasks:
    """The generators of a step's dropout masks (FFN). Each forward call of
    a step (the value, and each forward-mode pass of an eikonal loss) draws
    from a generator of its own, all seeded with the step's mask seed, so
    every call draws the same masks, as JAX's apply is a function of its
    rng. The generators persist from step to step (``reseed``), so a graph
    can hold them; no seed (``reseed(None)``) drops nothing."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.pool: List[torch.Generator] = []
        self.seed: Optional[int] = None
        self.calls = 0

    def reseed(self, seed: Optional[int]) -> None:
        self.seed, self.calls = seed, 0
        if seed is not None:
            for gen in self.pool:
                gen.manual_seed(seed)

    def rewind(self) -> None:
        """The next call takes the first generator again (a new step; its
        seeds set apart from the capture, on the host)."""
        self.calls = 0

    def next(self) -> Optional[torch.Generator]:
        """The generator of this forward call; None without a seed."""
        if self.seed is None:
            return None
        if self.calls == len(self.pool):
            self.pool.append(torch.Generator(device=self.device).manual_seed(self.seed))
        self.calls += 1
        return self.pool[self.calls - 1]


class Graph:
    """``fn()`` captured once, after ``WARMUP`` eager calls on a side stream;
    ``replay()`` runs it on the current stream and returns its output (the
    same tensors every time). ``generators()``: every generator ``fn``
    draws from besides the default one, read after the warm-up."""

    def __init__(self, fn: Callable[[], Any], generators: Callable[[], Sequence[torch.Generator]]):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(WARMUP):
                fn()
        torch.cuda.current_stream().wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        for gen in generators():
            self.graph.register_generator_state(gen)
        before = [dict(counter) for counter in COUNTERS]
        with torch.cuda.graph(self.graph):
            self.output = fn()
        self.launches = [{k: counter[k] - was.get(k, 0) for k in counter}
                         for counter, was in zip(COUNTERS, before)]
        for counter, was in zip(COUNTERS, before):
            counter.update(was)

    def replay(self):
        self.graph.replay()
        for counter, added in zip(COUNTERS, self.launches):
            for k, n in added.items():
                counter[k] += n
        return self.output


class StepRunner:
    """One call of ``body(idx, epoch, generator)`` per call: a training step
    on the rows ``idx``, or a validation batch. ``runner(idx, epoch, seed)``
    seeds the generator (and ``masks``, the step's dropout generators, if
    any) and returns the body's 0-d loss on the device; a captured runner
    replays its graph instead and overwrites that tensor at its next replay
    (copy it out first)."""

    def __init__(self, body: Callable, device, masks: Optional[DropoutMasks] = None):
        self.body = body
        self.masks = masks
        self.generator = torch.Generator(device=device)
        self.graph: Optional[Graph] = None

    def seed(self, seed: int) -> None:
        """The call's seed: its generator's, and its masks' with the top bit
        flipped (a stream apart from the loss's draws)."""
        self.generator.manual_seed(seed)
        if self.masks is not None:
            self.masks.reseed(seed ^ (1 << 63))

    def capture(self, idx: torch.Tensor, tensors: Callable[[], List[torch.Tensor]]) -> None:
        """Capture the body at rows like ``idx``; ``tensors()`` lists the
        training state the body changes (``state_tensors``; none for
        validation), which is put back after the warm-up, the state the
        warm-up made zeroed."""
        self.idx = idx.clone()
        self.epoch = torch.zeros((), dtype=torch.int64, device=idx.device)
        self._epoch: Optional[int] = None
        saved = {id(t): (t, t.detach().clone()) for t in tensors()}
        self.seed(0)

        def fn():
            if self.masks is not None:
                self.masks.rewind()
            return self.body(self.idx, self.epoch, self.generator)

        self.graph = Graph(fn, lambda: [self.generator, *(self.masks.pool if self.masks else ())])
        with torch.no_grad():
            for t in tensors():
                kept = saved.get(id(t))
                if kept is None:
                    t.zero_()
                else:
                    t.copy_(kept[1])

    def __call__(self, idx: torch.Tensor, epoch: int, seed: int) -> torch.Tensor:
        self.seed(seed)
        if self.graph is None:
            return self.body(idx, epoch, self.generator)
        self.idx.copy_(idx)
        if epoch != self._epoch:
            self.epoch.fill_(epoch)
            self._epoch = epoch
        return self.graph.replay()


class ValRunner:
    """Mean validation loss over fixed batches, ``rows`` (n_batches, batch)
    of indices, the generator seeded with 0 before each batch (the JAX
    validation hands every batch PRNGKey(0)): ``body(idx, epoch,
    generator)`` is one batch's loss, without grad, run by a ``StepRunner``."""

    def __init__(self, body: Callable, rows: torch.Tensor):
        self.rows = rows
        self.batch = StepRunner(body, rows.device)

    def capture(self) -> None:
        self.batch.capture(self.rows[0], lambda: [])

    def __call__(self, epoch: int) -> torch.Tensor:
        losses = torch.empty(self.rows.shape[0], dtype=torch.float32, device=self.rows.device)
        for i in range(self.rows.shape[0]):
            losses[i] = self.batch(self.rows[i], epoch, 0)
        return losses.mean()


class BestSnapshot:
    """The best-validation epoch of a block, kept on the device: JAX's
    ``best_tr`` / ``best_st`` / ``best_idx`` (trainer.py:326-333). A copy of
    every state tensor (``state_tensors``) that ``offer`` overwrites with
    the current values where an epoch's validation loss beats the best so
    far, and each epoch's host record (the scheduler's state, a rate held
    as a float) for the epoch it keeps. Nothing is read on the host before
    the block ends."""

    def __init__(self, tensors: List[torch.Tensor]):
        self.tensors = tensors
        self.copies = [t.detach().clone() for t in tensors]
        device = tensors[0].device
        self.val = torch.full((), math.inf, dtype=torch.float32, device=device)
        self.idx = torch.full((), -1, dtype=torch.int64, device=device)
        self.host: List[Any] = []

    def start(self, best_val: float) -> None:
        """A new block against the best validation loss so far."""
        self.val.fill_(best_val)
        self.idx.fill_(-1)
        self.host = []

    def offer(self, k: int, val_loss: torch.Tensor, host: Any) -> None:
        """Epoch ``k`` of the block ended with ``val_loss`` (a 0-d tensor)."""
        better = val_loss < self.val
        torch.where(better, val_loss, self.val, out=self.val)
        self.idx.masked_fill_(better, k)
        for copy, t in zip(self.copies, self.tensors):
            torch.where(better, t.detach(), copy, out=copy)
        self.host.append(host)

    def swap(self, live: Any) -> Any:
        """``live`` (dicts, lists and tuples holding state tensors: a
        ``state_dict(keep_vars=True)``, an optimizer's ``state_dict()``) with
        every state tensor replaced by its copy."""
        copies = {id(t): c for t, c in zip(self.tensors, self.copies)}

        def sub(x):
            if isinstance(x, torch.Tensor):
                return copies.get(id(x), x)
            if isinstance(x, dict):
                return {k: sub(v) for k, v in x.items()}
            if isinstance(x, (list, tuple)):
                return type(x)(sub(v) for v in x)
            return x

        return sub(live)
