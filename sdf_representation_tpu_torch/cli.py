"""Command line: ``python -m sdf_representation_tpu_torch <config.ini>``.

Mirrors the JAX package's ``python main.py <config.ini>`` (main.py:8-42),
with the reference's INI schema. It runs on the card unless ``--device cpu``
is given. Only reconstruction (``ppo = True, reconstruct = True``) is
ported; the other modes raise NotImplementedError.
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
                        help="working type of the fused kernels")
    args = parser.parse_args(argv)
    print(f"Running with config file: {args.config}")

    from .configgen import Configuration
    from .training import Trainer

    config = Configuration(args.config)
    if config.distributed:
        raise NotImplementedError(
            "the point-cloud (IGR) trainer is slice 3 of the port, see ROADMAP.md"
        )
    Trainer(config, device=args.device, compute_dtype=_DTYPES[args.compute_dtype]).run()
    return 0
