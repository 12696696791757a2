"""Device meshes — counterpart of sdf_representation_tpu/parallel/mesh.py.

In the port a mesh is an ordered tuple of ``torch.device``s: one data axis,
one shard per entry. Entries need not be distinct: a card listed twice holds
two shards, and ``("cpu",) * 8`` is the CPU tests' counterpart of the JAX
tests' eight virtual CPU devices.

One process drives every device, as the JAX package's one controller drives
its mesh under ``shard_map``: it launches each shard's work on the shard's
device, gathers the results on the mesh's first device, and leaves the sum
of the shards' parameter gradients to autograd (``replicate``). This is not
``torch.distributed``: NCCL refuses a communicator that holds one card twice,
and a card listed several times is how a one-card machine runs the sharded
paths.

Under an initialised process group (parallel/multihost.py: one process per
card) the trainers' data axis is a ``ProcessMesh``: the group's ranks, one
device each, as ``Mesh(jax.devices())`` spans every host after
``jax.distributed.initialize``. Each rank runs the forward on its rows of
the batch (``tensor_split``'s pieces, as ``shard_batch`` cuts them) and
``gather_rows`` hands every rank the whole batch's outputs, so each takes
the one loss of the whole batch; ``allreduce_grads`` then sums the
parameter gradients. A term that every rank computes whole would reach
that sum once per rank: ``count_once`` keeps its gradient on rank 0 only.

A step made of these is captured as a CUDA graph under NCCL
(training/graphs.py): each collective is one all_reduce of a device tensor
whose shape the step fixes, with no host read or copy around it, and
``over_ranks`` and ``count_once`` branch only on shapes and the rank, so
every replay issues the same collectives in the same order on every rank.
Under gloo, which stages CUDA tensors through the host, the step stays
eager.

Users: the sharded streams (``ops/sdf_streams.py``), the sharded grid
evaluators (``ops/sharded_eval.py``), the sharded fused eikonal op
(``ops/fused_igr.make_fused_value_and_grad_sharded``) and the trainers'
``mesh=``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

Mesh = Tuple[torch.device, ...]


def _device(d) -> torch.device:
    """``d`` as a torch.device; a card without an index is the current one,
    so that "cuda" and "cuda:0" name one device."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def get_mesh(n_devices: Optional[int] = None,
             devices: Optional[Iterable] = None) -> Mesh:
    """The first ``n_devices`` (default: all) of ``devices`` (default: every
    card) as a mesh (JAX mesh.py:22-28). Raises where no card is present and
    none is named."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; name the devices, "
                               "e.g. devices=('cpu',) * 8")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    mesh = tuple(_device(d) for d in devices)
    if n_devices is not None:
        mesh = mesh[:n_devices]
    if not mesh:
        raise ValueError("a mesh needs at least one device")
    mesh_kind(mesh)
    return mesh


def mesh_kind(mesh: Sequence) -> str:
    """"cuda" or "cpu": a mesh is all cards or all CPU (ValueError else)."""
    kinds = {torch.device(d).type for d in mesh}
    if len(kinds) != 1 or not kinds <= {"cpu", "cuda"}:
        raise ValueError(f"a mesh is all cards or all CPU, got {sorted(kinds)}")
    return kinds.pop()


def shard_batch(x: torch.Tensor, mesh: Optional[Sequence]) -> List[torch.Tensor]:
    """The batch axis cut into ``len(mesh)`` contiguous pieces whose sizes
    differ by at most one, piece d on ``mesh[d]``; ``[x]`` without a mesh
    (data_sharding / shard_batch, JAX mesh.py:31-44). The JAX package pads
    the batch to a multiple of the device count instead; its pad rows carry
    zero cotangent, so both give the same result."""
    if mesh is None:
        return [x]
    return [piece.to(d) for piece, d in zip(torch.tensor_split(x, len(mesh)), mesh)]


def replicate(tensors: Sequence[torch.Tensor], mesh: Sequence) -> List[List[torch.Tensor]]:
    """Per mesh entry, the tensors on its device: one differentiable copy
    per distinct device (``t.to(d)`` is ``t`` itself on ``t``'s device), so
    entries that repeat a device share it. Backward, autograd adds every
    shard's gradient into the originals: the psum of the JAX ``shard_map``
    transpose over replicated parameters."""
    copies: Dict[torch.device, List[torch.Tensor]] = {}
    out = []
    for d in mesh:
        d = torch.device(d)
        if d not in copies:
            copies[d] = [t.to(d) for t in tensors]
        out.append(copies[d])
    return out


def gather(pieces: Sequence[torch.Tensor], device) -> torch.Tensor:
    """The pieces concatenated along the first axis on ``device``
    (differentiable: gradients flow back to each piece's device)."""
    return torch.cat([p.to(device) for p in pieces])


# ---------------------------------------------------------------------------
# the data axis over a process group
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ProcessMesh:
    """The data axis over an initialised process group: ``size`` ranks, one
    device each; ``device`` is this rank's, ``rank`` its place."""

    device: torch.device
    rank: int
    size: int

    def __len__(self) -> int:
        return self.size

    def rows(self, n: int) -> Tuple[int, int]:
        return rank_rows(n, self.rank, self.size)


def rank_rows(n: int, rank: int, size: int) -> Tuple[int, int]:
    """[start, stop) of rank ``rank``'s rows of an n-row batch over ``size``
    ranks: piece ``rank`` of ``torch.tensor_split(range(n), size)``."""
    per, extra = divmod(n, size)
    start = rank * per + min(rank, extra)
    return start, start + per + (rank < extra)


def process_mesh(device=None) -> ProcessMesh:
    """The initialised group's data axis, this rank on ``device`` (default:
    the one ``multihost.initialize_multihost`` chose)."""
    from . import multihost

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("no process group: call multihost.initialize_multihost() first")
    device = device if device is not None else multihost.LOCAL_DEVICE
    if device is None:
        raise RuntimeError("name this rank's device, or make the group with "
                           "multihost.initialize_multihost()")
    return ProcessMesh(_device(device), dist.get_rank(), dist.get_world_size())


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, local, n_rows, start):
        out = local.new_zeros((n_rows, *local.shape[1:]))
        out[start:start + local.shape[0]] = local
        dist.all_reduce(out)
        ctx.rows = (start, start + local.shape[0])
        return out

    @staticmethod
    def backward(ctx, grad):
        start, stop = ctx.rows
        return grad[start:stop], None, None


def gather_rows(local: torch.Tensor, n_rows: int) -> torch.Tensor:
    """This rank's rows (``rank_rows``) of an (n_rows, ...) batch
    gathered into the whole batch on every rank: a zero-filled buffer with
    this rank's rows written in, summed over the ranks by one all_reduce
    (adding exact zeros is exact, so every rank holds the same bits; gloo
    has no all_gather of CUDA tensors). Backward hands this rank the
    incoming gradient's rows of its own, with no reduction: every rank
    holds the same loss, so the same cotangent."""
    start, _ = rank_rows(n_rows, dist.get_rank(), dist.get_world_size())
    return _GatherRows.apply(local, n_rows, start)


def count_once(t: torch.Tensor, mesh) -> torch.Tensor:
    """``t``, a term every rank computes whole, with its gradient kept on
    rank 0 only, so that ``allreduce_grads`` counts it once."""
    return t.detach() if isinstance(mesh, ProcessMesh) and mesh.rank else t


def over_ranks(fn: Callable, x: torch.Tensor, params: Sequence[torch.Tensor],
               mesh: ProcessMesh):
    """``fn(x, params)`` (a tensor or a tuple of them, row i from x[i]) over
    the group: ``fn`` on this rank's rows, the output gathered
    (``gather_rows``). A batch of fewer rows than max(2, ranks) runs whole
    on every rank (a per-point transform's single row, which no collective
    can take under vmap), its parameter gradient from rank 0's run only."""
    n = x.shape[0]
    if n < max(2, mesh.size):
        return fn(x, [count_once(p, mesh) for p in params])
    start, stop = mesh.rows(n)
    out = fn(x[start:stop], params)
    if isinstance(out, tuple):
        return tuple(gather_rows(o, n) for o in out)
    return gather_rows(out, n)


def allreduce_grads(params: Sequence[torch.Tensor]) -> None:
    """Sum the parameters' gradients over the ranks: one flat SUM
    all_reduce. A parameter this rank did not differentiate adds zeros, and
    every parameter leaves with a gradient."""
    flat = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1)
                      for p in params])
    dist.all_reduce(flat)
    for p, g in zip(params, torch.split(flat, [p.numel() for p in params])):
        p.grad = g.view_as(p)
