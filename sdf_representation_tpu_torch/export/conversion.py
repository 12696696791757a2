"""Export orchestration: a trained port module -> native formats + parity
fixtures. Counterpart of sdf_representation_tpu/export/conversion.py.

Role of reference utils/inference_conversion.py:23-110: rebuild the
compatible architecture, export (TorchScript/ONNX there; .sdfw/ONNX here) and
write random input/output CSV fixtures so the independent C++ runtime can be
diffed elementwise (the reference's difference.csv shows ~1e-7 — the same
bar applies to native/parity_main).

``LAST_STAGE_SECONDS`` holds the host-clock seconds of the stages of the
last export (``save_for_native``, ``write_parity_fixtures`` and the entry
point's other stages each set their own keys).
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..ops.diffops import sdf_and_gradient
from ..utils.device import matmul_precision
from .native_format import save_sdfw
from .onnx_export import save_as_onnx
from .onnx_lint import lint_onnx

LAST_STAGE_SECONDS: dict = {}


def save_for_native(out_dir: str, model, onnx: bool = True, quantized: bool = True) -> dict:
    """model.sdfw, and with ``onnx`` model.onnx and (``quantized``) the
    int8-weight model_quant.onnx, each ONNX file refused unless the
    ORT-strictness lint passes it. Returns {kind: path}."""
    os.makedirs(out_dir, exist_ok=True)
    t0 = time.perf_counter()
    paths = {"sdfw": save_sdfw(os.path.join(out_dir, "model.sdfw"), model)}
    LAST_STAGE_SECONDS["sdfw"] = time.perf_counter() - t0
    if not onnx:
        return paths
    t0 = time.perf_counter()
    paths["onnx"] = save_as_onnx(os.path.join(out_dir, "model.onnx"), model)
    LAST_STAGE_SECONDS["onnx"] = time.perf_counter() - t0
    if quantized:
        # the reference's quantize_save step (utils/inference_conversion.py:
        # 113-114): a small int8-weight ONNX artifact next to the f32 one
        t0 = time.perf_counter()
        paths["onnx_quant"] = save_as_onnx(os.path.join(out_dir, "model_quant.onnx"), model,
                                           quantize=True)
        LAST_STAGE_SECONDS["onnx_quant"] = time.perf_counter() - t0
    # structural (ORT-load-strictness) lint: a model.onnx that would be
    # rejected by Ort::Session must never leave the exporter
    t0 = time.perf_counter()
    for key in ("onnx", "onnx_quant"):
        if key not in paths:
            continue
        problems = lint_onnx(paths[key])
        if problems:
            raise RuntimeError(
                f"exported {os.path.basename(paths[key])} failed the "
                "ORT-strictness lint:\n  " + "\n  ".join(problems)
            )
    LAST_STAGE_SECONDS["lint"] = time.perf_counter() - t0
    return paths


def write_parity_fixtures(out_dir: str, model, n_points: int = 64, seed: int = 0) -> dict:
    """input.csv / output.csv / gradient.csv for the C++ parity harness
    (cf. inference_conversion.py:56-64 and ops/conversion_test fixtures).

    (f, grad f) come from the module's own float32 forward through
    ``ops.diffops.sdf_and_gradient`` on the module's device with the
    float32 matrix products at full precision (TF32 off): this is the
    reference the C++ runtime is diffed against at ~1e-7, so it never runs
    in bf16 nor through a fused kernel."""
    os.makedirs(out_dir, exist_ok=True)
    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1, 1, (n_points, model.d_in)).astype(np.float32)
    device = next(model.parameters()).device
    with matmul_precision("highest"):
        vals, grads = sdf_and_gradient(model, torch.from_numpy(pts).to(device))
    vals = vals.detach().cpu().numpy().astype(np.float64)
    grads = grads.detach().cpu().numpy().astype(np.float64)

    inp_path = os.path.join(out_dir, "input.csv")
    np.savetxt(inp_path, pts, delimiter=",", fmt="%.9g")
    out_path = os.path.join(out_dir, "output.csv")
    np.savetxt(out_path, vals[:, None], delimiter=",", fmt="%.9g")
    grad_path = os.path.join(out_dir, "gradient.csv")
    np.savetxt(grad_path, grads, delimiter=",", fmt="%.9g")
    LAST_STAGE_SECONDS["fixtures"] = time.perf_counter() - t0
    return {"input": inp_path, "output": out_path, "gradient": grad_path}
