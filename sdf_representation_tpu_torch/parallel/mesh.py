"""Device meshes — counterpart of sdf_representation_tpu/parallel/mesh.py.

In the port a mesh is an ordered tuple of ``torch.device``s: one data axis,
one shard per entry. The sharded streams (``ops/sdf_streams.py``
``dist_stream_sharded``, ``wind_stream_sharded``) give entry ``d`` the
``d``-th contiguous range of point blocks. Entries need not be distinct: a
card listed twice holds two shards, and ``("cpu",) * 8`` is the CPU tests'
counterpart of the JAX tests' eight virtual CPU devices.
"""

from __future__ import annotations

from typing import Iterable, Optional, Tuple

import torch


def get_mesh(n_devices: Optional[int] = None,
             devices: Optional[Iterable] = None) -> Tuple[torch.device, ...]:
    """The first ``n_devices`` (default: all) of ``devices`` (default: every
    card) as a mesh. Raises where no card is present and none is named."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; name the devices, "
                               "e.g. devices=('cpu',) * 8")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    mesh = tuple(torch.device(d) for d in devices)
    if n_devices is not None:
        mesh = mesh[:n_devices]
    if not mesh:
        raise ValueError("a mesh needs at least one device")
    return mesh
