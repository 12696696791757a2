"""Export CLI: trained checkpoint -> native formats. Counterpart of
``python -m sdf_representation_tpu.export``.

    python -m sdf_representation_tpu_torch.export <config.ini> <out_dir>
        [--quantize] [--no-onnx] [--torchscript] [--fixtures N] [--device cpu]

Loads the best checkpoint of the run described by config.ini (same directory
convention as training, ``Trainer(config).load_model(best=True)``) and writes
model.sdfw (+ model.onnx and model_quant.onnx, optional model_int8.sdfw and
implicit_model.pt, parity fixtures) for the native consumers — the role of
running utils/inference_conversion.py in the reference. It runs on the card
unless ``--device cpu`` is given, and raises with no card and no device.
"""

from __future__ import annotations

import argparse
import os
import time


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m sdf_representation_tpu_torch.export",
                                description="Export a trained model for native consumers.")
    p.add_argument("config", help="config.ini of the trained run")
    p.add_argument("out_dir", help="output directory")
    p.add_argument("--quantize", action="store_true", help="also write int8 .sdfw (v2)")
    p.add_argument("--no-onnx", action="store_true")
    p.add_argument("--torchscript", action="store_true",
                   help="also write implicit_model.pt (LibTorch consumers)")
    p.add_argument("--fixtures", type=int, default=64,
                   help="parity fixture point count (0 = skip)")
    p.add_argument("--device", default=None,
                   help="torch device; default: the card (raises without one)")
    args = p.parse_args(argv)

    from ..configgen import Configuration
    from ..training import Trainer
    from .conversion import LAST_STAGE_SECONDS, save_for_native, write_parity_fixtures

    LAST_STAGE_SECONDS.clear()
    t0 = time.perf_counter()
    trainer = Trainer(Configuration(args.config), device=args.device)
    _, epoch = trainer.load_model(best=True)
    LAST_STAGE_SECONDS["load"] = time.perf_counter() - t0
    print(f"loaded checkpoint from epoch {epoch}")

    paths = save_for_native(args.out_dir, trainer.model, onnx=not args.no_onnx)
    if args.quantize:
        from .quantize import save_sdfw_quantized

        t0 = time.perf_counter()
        paths["sdfw_int8"] = save_sdfw_quantized(
            os.path.join(args.out_dir, "model_int8.sdfw"), trainer.model)
        LAST_STAGE_SECONDS["sdfw_int8"] = time.perf_counter() - t0
    if args.torchscript:
        from .torchscript_export import save_as_torchscript

        t0 = time.perf_counter()
        pt, _, _ = save_as_torchscript(args.out_dir, trainer.model,
                                       n_fixture=max(args.fixtures, 1))
        paths["torchscript"] = pt
        LAST_STAGE_SECONDS["torchscript"] = time.perf_counter() - t0
    if args.fixtures > 0:
        paths.update(write_parity_fixtures(args.out_dir, trainer.model, args.fixtures))
    for k, v in paths.items():
        print(f"{k}: {v}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
