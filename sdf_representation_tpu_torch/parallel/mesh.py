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
paths. Multi-process training is the counterpart of parallel/multihost.py,
not of this module.

Users: the sharded streams (``ops/sdf_streams.py``), the sharded grid
evaluators (``ops/sharded_eval.py``), the sharded fused eikonal op
(``ops/fused_igr.make_fused_value_and_grad_sharded``) and the trainers'
``mesh=``.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import torch

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
