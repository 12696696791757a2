"""One process per card — counterpart of sdf_representation_tpu/parallel/multihost.py.

The JAX package spans hosts with ``jax.distributed.initialize``: after it,
``jax.devices()`` lists every host's devices and the trainers' mesh, with
its gradient psums, spans them. Here the counterpart is a
``torch.distributed`` process group with one process (rank) per card, over
NCCL (gloo for the CPU): call ``initialize_multihost()`` once per process
before any computation. Under an initialised group the command line trains
on the group's data axis (``parallel.mesh.process_mesh``): each rank takes
its rows of every batch, and the ranks exchange rows and gradients with
all-reduces. Labelling, the audit, reconstruction and every file write run
on rank 0.

A launch, one process per card:

    JAX_COORDINATOR=host0:1234 NPROC=8 PROC_ID=$i python launch.py cfg.ini

or, under torchrun (which sets MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK
and LOCAL_RANK), ``torchrun --nproc-per-node 8 launch.py cfg.ini``, with
``launch.py``:

    import sys
    from sdf_representation_tpu_torch import cli
    from sdf_representation_tpu_torch.parallel.multihost import initialize_multihost
    initialize_multihost()
    sys.exit(cli.main(sys.argv[1:]))
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

# this rank's device, as initialize_multihost chose it
LOCAL_DEVICE: Optional[torch.device] = None


def _env(*names: str) -> Optional[str]:
    """The first of ``names`` set to a non-empty value in the environment."""
    for name in names:
        value = os.environ.get(name)
        if value:
            return value
    return None


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    backend: Optional[str] = None,
    device=None,
) -> None:
    """``torch.distributed.init_process_group`` with explicit or
    environment-provided settings: the arguments, else JAX's names
    (JAX_COORDINATOR / NPROC / PROC_ID, with JAX's precedence:
    ``process_id=0`` is honoured), else what a launcher such as torchrun
    supplies (MASTER_ADDR:MASTER_PORT / WORLD_SIZE / RANK).

    ``coordinator_address`` is ``host:port`` (``tcp://`` is prepended) or a
    URL such as ``file:///path``. ``device`` is this rank's device; default
    ``cuda:LOCAL_RANK`` (LOCAL_RANK from the environment, 0 without it),
    which must exist. ``backend`` defaults to NCCL for a card and gloo for
    the CPU."""
    global LOCAL_DEVICE
    addr = coordinator_address or _env("JAX_COORDINATOR")
    if not addr and _env("MASTER_ADDR") and _env("MASTER_PORT"):
        addr = f"{_env('MASTER_ADDR')}:{_env('MASTER_PORT')}"
    n = num_processes or _env("NPROC", "WORLD_SIZE")
    pid = process_id if process_id is not None else _env("PROC_ID", "RANK")
    if not addr or not n or pid is None:
        raise ValueError("initialize_multihost needs a coordinator address, a process count "
                         "and a process id: pass them, or set JAX_COORDINATOR / NPROC / "
                         "PROC_ID or MASTER_ADDR, MASTER_PORT / WORLD_SIZE / RANK")
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass device='cpu' to run the "
                               "ranks on the CPU")
        device = torch.device("cuda", int(_env("LOCAL_RANK") or 0))
    device = torch.device(device)
    if device.type == "cuda":
        index = torch.cuda.current_device() if device.index is None else device.index
        if not 0 <= index < torch.cuda.device_count():
            raise ValueError(f"{device} does not exist: {torch.cuda.device_count()} card(s)")
        device = torch.device("cuda", index)
        torch.cuda.set_device(device)
    init_method = addr if "://" in addr else f"tcp://{addr}"
    dist.init_process_group(backend or ("nccl" if device.type == "cuda" else "gloo"),
                            init_method=init_method, world_size=int(n), rank=int(pid))
    LOCAL_DEVICE = device


def auto_initialize() -> bool:
    """Initialise iff the environment asks for it (JAX_COORDINATOR set, or a
    launcher's WORLD_SIZE above 1); True if done. A failed initialisation
    prints one line and returns False, as in JAX."""
    if _env("JAX_COORDINATOR") or int(_env("WORLD_SIZE") or 1) > 1:
        try:
            initialize_multihost()
            return True
        except Exception as exc:  # already initialised / one process
            print(f"multihost init skipped: {exc}")
    return False


def process_count() -> int:
    """Ranks in the process group; 1 without one."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def process_index() -> int:
    """This process's rank; 0 without a process group."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def host_shard(total: int) -> slice:
    """This process's contiguous shard of ``total`` items (e.g. geometry
    files or grid slabs) — the host-side analog of the data axis."""
    n = process_count()
    i = process_index()
    per = -(-total // n)
    return slice(i * per, min(total, (i + 1) * per))
