"""Import reference (PyTorch) checkpoints into the port — counterpart of
sdf_representation_tpu/export/torch_import.py.

The reference's Executor pickles dicts holding torch ``state_dict``s with
keys ``lin{i}.weight`` / ``lin{i}.bias`` (ImplicitNet, reference
model/networks.py:77) or ``layers.{i}.weight`` (ImplicitNetCompatible,
:114-179), optionally prefixed ``module.`` by DataParallel (reference
executor.py:301-345 strips it). The port's ImplicitNet keeps the
reference's own ``lin{i}`` layout, (out, in), so ``import_torch_state_dict``
only strips the prefix and renames ``layers.{i}`` to ``lin{i}``; nothing
is transposed.

Loading the files. The reference writes model_epoch{E}.pkl with
``torch.save`` (a zip archive) and best_model.pkl with plain
``pickle.dump`` (executor.py:248-257). Neither needs ``weights_only=False``:
the zip form holds tensors, dicts, ints and floats (and possibly numpy
scalars, allowed by name), which ``torch.load(weights_only=True)`` reads;
the plain form is read by an unpickler that admits only the five globals a
pickled state dict uses, with each tensor's storage read back by
``torch.load(weights_only=True)`` again. A checkpoint is a file from
outside the program, so no code in it runs: a file that needs any other
global is refused.
"""

from __future__ import annotations

import collections
import io
import pickle
import re
from typing import Dict, Optional, Tuple

import numpy as np
import torch

_NUMPY_SCALAR = np.float64(0).__reduce__()[0]  # numpy's scalar(dtype, bytes) constructor
_NUMPY_GLOBALS = [_NUMPY_SCALAR, np.dtype] + [type(np.dtype(t)) for t in
                                               (np.float64, np.float32, np.int64, np.int32)]


def import_torch_state_dict(state_dict: Dict) -> Dict[str, torch.Tensor]:
    """Reference state_dict -> the port's ``lin{i}.weight`` / ``lin{i}.bias``
    float32 state_dict."""
    layers: Dict[int, Dict[str, torch.Tensor]] = {}
    pat = re.compile(r"^(?:module\.)?(?:lin(\d+)|layers\.(\d+))\.(weight|bias)$")
    for key, tensor in state_dict.items():
        m = pat.match(key)
        if not m:
            continue
        idx = int(m.group(1) if m.group(1) is not None else m.group(2))
        layers.setdefault(idx, {})[m.group(3)] = torch.as_tensor(tensor).detach().to(
            device="cpu", dtype=torch.float32)
    if not layers:
        raise ValueError(
            "No lin{i}/layers.{i} weight keys found; not an ImplicitNet "
            f"state_dict (keys: {sorted(state_dict)[:8]}...)"
        )
    out = {}
    for i in range(max(layers) + 1):
        if set(layers.get(i, {})) != {"weight", "bias"}:
            raise ValueError(f"Layer {i} incomplete in state_dict")
        out[f"lin{i}.weight"] = layers[i]["weight"]
        out[f"lin{i}.bias"] = layers[i]["bias"]
    return out


def infer_architecture(state_dict: Dict[str, torch.Tensor], d_in: int = 3) -> Tuple[tuple, tuple]:
    """Recover (hidden_dims, skip_in) from imported layer shapes: a layer
    whose fan_out is d_in short of the next fan_in feeds a skip."""
    n = len(state_dict) // 2
    hidden = []
    skip = []
    for i in range(n - 1):
        fan_out = state_dict[f"lin{i}.weight"].shape[0]
        next_in = state_dict[f"lin{i + 1}.weight"].shape[1]
        if next_in == fan_out + d_in:
            skip.append(i + 1)
            hidden.append(fan_out + d_in)
        else:
            hidden.append(fan_out)
    return tuple(hidden), tuple(skip)


def _storage_from_bytes(b: bytes):
    return torch.load(io.BytesIO(b), weights_only=True)


class _StateDictUnpickler(pickle.Unpickler):
    """Plain pickle of a checkpoint dict, admitting only what a pickled
    state dict needs (see the module's docstring)."""

    _ALLOWED = {
        ("collections", "OrderedDict"): collections.OrderedDict,
        ("torch._utils", "_rebuild_tensor_v2"): torch._utils._rebuild_tensor_v2,
        ("torch.storage", "_load_from_bytes"): _storage_from_bytes,
        ("numpy", "dtype"): np.dtype,
        ("numpy.core.multiarray", "scalar"): _NUMPY_SCALAR,
        ("numpy._core.multiarray", "scalar"): _NUMPY_SCALAR,
    }

    def find_class(self, module, name):
        try:
            return self._ALLOWED[module, name]
        except KeyError:
            raise pickle.UnpicklingError(
                f"{module}.{name} is not part of a checkpoint's state dict") from None


def load_reference_checkpoint(path: str, map_key: Optional[str] = None):
    """Read a reference checkpoint file and import its model weights.

    Reference formats (executor.py:237-257):
      best_model.pkl     {"epoch", "model_state_dict", "optimizer_state_dict",
                          "loss", "val_loss", ...}
      model_epoch{E}.pkl {"epoch", "model_state_dict"}

    Returns (the port's state_dict, epoch); tensors load onto the CPU.
    """
    try:
        with torch.serialization.safe_globals(_NUMPY_GLOBALS):
            blob = torch.load(path, map_location="cpu", weights_only=True)
    except (RuntimeError, pickle.UnpicklingError):
        # best_model.pkl: plain pickle.dump, which torch.load refuses
        with open(path, "rb") as fh:
            blob = _StateDictUnpickler(fh).load()
    if isinstance(blob, dict) and not any(
        isinstance(v, torch.Tensor) for v in blob.values()
    ):
        epoch = int(blob.get("epoch", 0))
        state = blob.get(map_key or "model_state_dict")
        if state is None:
            for v in blob.values():
                if isinstance(v, dict) and any("weight" in kk for kk in v):
                    state = v
                    break
        if state is None:
            raise ValueError(f"No state_dict found in {path}")
    else:
        state, epoch = blob, 0
    return import_torch_state_dict(state), epoch
