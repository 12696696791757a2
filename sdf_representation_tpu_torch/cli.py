"""Command line: ``python -m sdf_representation_tpu_torch <config.ini>``.

Mirrors the JAX package's ``python main.py <config.ini>`` (main.py:8-42),
with the reference's INI schema. It runs on the card unless ``--device cpu``
is given. Modes, as in the JAX package: ``samplingonly = True`` samples and
labels the training points; ``ppo = True`` reconstructs a mesh
(``reconstruct = True``) or audits the field's accuracy on the dense grid
(``reconstruct = False``) from the run's checkpoints; otherwise it samples
if needed, trains and writes checkpoints. ``distributed = True`` selects the
point-cloud (IGR) trainer, which fits the field to bare surface points
(``<geometry>/surface.csv``). ``[TPU] mesh_devices = N > 1`` trains
data-parallel over the first N cards (one on a one-card machine), or over
the CPU listed N times with ``--device cpu``.

Under a process group (one process per card: call
``parallel.multihost.initialize_multihost()`` and then ``main``; see that
module's docstring for a launcher) every mode trains over the group's ranks
(``parallel.mesh.process_mesh``), ``--device`` names this rank's device,
``mesh_devices``, where set, must equal the number of ranks, and rank 0
writes the files and runs labelling, the audit and reconstruction. ``main``
does not initialise a group itself, as the JAX package's does not.
"""

from __future__ import annotations

import argparse

import torch

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m sdf_representation_tpu_torch")
    parser.add_argument("config", help="INI file (the reference schema)")
    parser.add_argument("--device", default=None,
                        help="torch device; default: the card (raises without one)")
    parser.add_argument("--compute-dtype", choices=sorted(_DTYPES), default="bfloat16",
                        help="working type of the fused evaluation kernels on the card; "
                             "on the CPU, reconstruction and the audit evaluate in float32")
    args = parser.parse_args(argv)
    print(f"Running with config file: {args.config}")

    from .configgen import Configuration
    from .parallel.mesh import get_mesh, process_mesh
    from .training import PointCloudTrainer, Trainer

    config = Configuration(args.config)
    mesh = None
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        # the data axis spans the group's ranks (JAX: jax.devices() after initialize)
        mesh = process_mesh(args.device)
    elif config.mesh_devices and config.mesh_devices > 1:
        # JAX cli.py:24-30; with --device cpu the CPU listed mesh_devices times
        cpu = args.device is not None and torch.device(args.device).type == "cpu"
        mesh = get_mesh(config.mesh_devices, devices=("cpu",) * config.mesh_devices if cpu else None)
    trainer_cls = PointCloudTrainer if config.distributed else Trainer
    trainer_cls(config, device=args.device, mesh=mesh,
                compute_dtype=_DTYPES[args.compute_dtype]).run()
    return 0
