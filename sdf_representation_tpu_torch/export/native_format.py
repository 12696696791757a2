"""`.sdfw` — the native weight format consumed by the C++ runtime.

Counterpart of sdf_representation_tpu/export/native_format.py (the role of
the reference's TorchScript export, reference
utils/inference_conversion.py:23-64 `save_as_libtorch`): a trained net
serialised for an independent native runtime, parity-checked to ~1e-7.
`.sdfw` is a dependency-free container any C++ program can read:

  bytes 0..3   magic  "SDFW"
  bytes 4..7   version (u32 LE)
  bytes 8..11  header length H (u32 LE)
  bytes 12..   JSON header (arch + tensor directory), then raw tensor bytes
               (float32 LE, row-major, in directory order)

JSON header:
  {"arch": {"d_in":3, "hidden_dims":[...], "skip_in":[...], "beta":100.0},
   "tensors": [{"name":"layers.0.w", "shape":[3,512]}, ...]}

The file stores each weight as (in, out), the JAX package's layout; the
port's module keeps ``lin{i}.weight`` as (out, in), so the writers here
transpose (``export_layers``) and ``load_sdfw`` transposes back. A port
module and the JAX package's ImplicitNet with the same weights give the
same bytes.
"""

from __future__ import annotations

import json
import struct
from typing import Dict, List, Tuple

import numpy as np
import torch

MAGIC = b"SDFW"
VERSION = 1


def export_layers(model) -> List[Dict[str, np.ndarray]]:
    """``[{"w": (in, out), "b": (out,)}, ...]`` float32 numpy arrays of the
    module's ``export_params()`` (the Lipschitz row scaling baked in): the
    layout every writer of this package serialises."""
    sd = model.export_params()
    return [{"w": sd[f"lin{i}.weight"].cpu().numpy().T.astype(np.float32),
             "b": sd[f"lin{i}.bias"].cpu().numpy().astype(np.float32)}
            for i in range(model.num_layers - 1)]


def arch_header(model) -> dict:
    return {
        "d_in": model.d_in,
        "hidden_dims": list(model.hidden_dims),
        "skip_in": list(model.skip_in),
        "beta": float(model.beta),
    }


def write_container(path: str, version: int, arch: dict, tensors: list, blobs: list) -> str:
    hjson = json.dumps({"arch": arch, "tensors": tensors}).encode("utf-8")
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(struct.pack("<I", version))
        f.write(struct.pack("<I", len(hjson)))
        f.write(hjson)
        for blob in blobs:
            f.write(blob)
    return path


def save_sdfw(path: str, model) -> str:
    """Serialise a port ImplicitNet to .sdfw."""
    tensors = []
    blobs = []
    for i, layer in enumerate(export_layers(model)):
        for key in ("w", "b"):
            arr = np.ascontiguousarray(layer[key])
            tensors.append({"name": f"layers.{i}.{key}", "shape": list(arr.shape)})
            blobs.append(arr.tobytes())
    return write_container(path, VERSION, arch_header(model), tensors, blobs)


def state_dict_from_layers(layers: List[Dict[str, np.ndarray]]) -> Dict[str, torch.Tensor]:
    """``[{"w": (in, out), "b"}]`` -> the port's ``lin{i}.weight`` (out, in)
    / ``lin{i}.bias`` state_dict."""
    sd = {}
    for i, layer in enumerate(layers):
        sd[f"lin{i}.weight"] = torch.from_numpy(np.ascontiguousarray(layer["w"].T))
        sd[f"lin{i}.bias"] = torch.from_numpy(np.ascontiguousarray(layer["b"]))
    return sd


def read_sdfw(path: str) -> Tuple[int, dict, List[Dict[str, np.ndarray]]]:
    """(version, arch, ``[{"w": (in, out), "b"}]`` float32 layers) of a v1
    (float32) or v2 (int8 weights, dequantized here) file."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != MAGIC:
        raise ValueError(f"Not an SDFW file: {path}")
    version, hlen = struct.unpack("<II", data[4:12])
    header = json.loads(data[12 : 12 + hlen].decode("utf-8"))
    off = 12 + hlen
    layers: list = []
    for t in header["tensors"]:
        shape = tuple(t["shape"])
        count = int(np.prod(shape))
        if t.get("dtype", "float32") == "int8":
            arr = np.frombuffer(data, dtype=np.int8, count=count, offset=off)
            off += count
            arr = arr.reshape(shape).astype(np.float32) * np.asarray(
                t["scale"], np.float32
            )[None, :]
        else:
            arr = np.frombuffer(data, dtype="<f4", count=count, offset=off)
            off += count * 4
            arr = arr.reshape(shape).copy()
        li = int(t["name"].split(".")[1])
        key = t["name"].split(".")[2]
        while len(layers) <= li:
            layers.append({})
        layers[li][key] = arr
    return version, header["arch"], layers


def load_sdfw(path: str) -> Tuple[dict, Dict[str, torch.Tensor]]:
    """Returns (arch dict, the port's state_dict) of a version 1 file:
    ``ImplicitNet(**arch)`` takes the state_dict with ``load_state_dict``."""
    version, arch, layers = read_sdfw(path)
    if version != VERSION:
        raise ValueError(f"Unsupported SDFW version {version}")
    return arch, state_dict_from_layers(layers)
