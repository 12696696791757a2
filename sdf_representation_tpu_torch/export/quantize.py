"""Int8 weight quantization for exported models — counterpart of
sdf_representation_tpu/export/quantize.py.

Role of the reference's ``quantize_save`` (reference
utils/inference_conversion.py:113-114 — onnxruntime dynamic quantization:
int8 weights, float compute). Same scheme here, no onnxruntime needed:
per-output-channel symmetric int8 weights + float32 scales, stored in the
.sdfw container as version 2 (tensor dtype + scale vector in the directory);
biases stay float32. The C++ runtime (sdfnet.hpp) and the Python reader both
dequantize at load, so inference math is unchanged f32 — the file is ~4x
smaller and mirrors ORT's dynamic-quant behavior.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from .native_format import (arch_header, export_layers, read_sdfw, state_dict_from_layers,
                            write_container)

VERSION_Q = 2


def quantize_layers(layers: List[Dict[str, np.ndarray]]) -> List[Dict[str, np.ndarray]]:
    """Per-output-channel symmetric int8 quantization of ``export_layers``'
    (in, out) weights: ``[{"wq", "scale", "b"}, ...]``."""
    out = []
    for layer in layers:
        w = np.asarray(layer["w"], np.float32)  # (in, out)
        scale = np.maximum(np.abs(w).max(axis=0), 1e-12) / 127.0  # (out,)
        q = np.clip(np.round(w / scale), -127, 127).astype(np.int8)
        out.append(
            {"wq": q, "scale": scale.astype(np.float32),
             "b": np.asarray(layer["b"], np.float32)}
        )
    return out


def dequantize_layers(qlayers) -> List[Dict[str, np.ndarray]]:
    return [{"w": layer["wq"].astype(np.float32) * layer["scale"][None, :], "b": layer["b"]}
            for layer in qlayers]


def save_sdfw_quantized(path: str, model) -> str:
    """Serialise with int8 weights (format version 2)."""
    tensors = []
    blobs = []
    for i, layer in enumerate(quantize_layers(export_layers(model))):
        tensors.append(
            {"name": f"layers.{i}.w", "shape": list(layer["wq"].shape),
             "dtype": "int8", "scale": layer["scale"].tolist()}
        )
        blobs.append(np.ascontiguousarray(layer["wq"]).tobytes())
        tensors.append(
            {"name": f"layers.{i}.b", "shape": list(layer["b"].shape),
             "dtype": "float32"}
        )
        blobs.append(np.ascontiguousarray(layer["b"]).tobytes())
    return write_container(path, VERSION_Q, arch_header(model), tensors, blobs)


def load_sdfw_any(path: str) -> Tuple[dict, Dict[str, torch.Tensor]]:
    """Read v1 (float32) or v2 (int8-quantized) .sdfw; always returns the
    arch and a dequantized float32 state_dict of the port's layout."""
    _, arch, layers = read_sdfw(path)
    return arch, state_dict_from_layers(layers)
