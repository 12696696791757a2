"""Checkpoints of the port: ``torch.save`` / ``torch.load(weights_only=True)``.

Same file names and cadence as sdf_representation_tpu/training/checkpoint.py
(reference executor/executor.py:209-234):

  best_model.ckpt           on every validation improvement
  model_epoch{E}.ckpt       every ``checkpointing`` epochs

The FORMAT differs: the JAX package writes flax msgpack, which the port
does not read (the card's machine has no flax). A port checkpoint
is a dict ``{"model": state_dict, "epoch": int, ...}`` of tensors and plain
Python values, so ``weights_only=True`` loads it without unpickling code.
Weights move between the two packages through ``convert.params_from_jax``.
"""

from __future__ import annotations

import glob
import os
import re
from typing import Any, Dict, Optional, Tuple

import torch


def save_checkpoint(path: str, state: Dict[str, Any]) -> None:
    """Write ``state`` atomically (tmp file + rename)."""
    tmp = path + ".tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str, map_location="cpu") -> Dict[str, Any]:
    return torch.load(path, map_location=map_location, weights_only=True)


def latest_epoch_checkpoint(model_dir: str) -> Optional[Tuple[str, int]]:
    """Newest model_epoch*.ckpt by epoch number (not file mtime)."""
    best = None
    for c in glob.glob(os.path.join(model_dir, "model_epoch*.ckpt")):
        m = re.search(r"model_epoch(\d+)\.ckpt$", c)
        if m:
            e = int(m.group(1))
            if best is None or e > best[1]:
                best = (c, e)
    return best
