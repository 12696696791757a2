"""Device selection for the port's entry points.

The entry points run on the card unless the caller names the CPU; with no
card and no device named they raise instead of quietly running on the CPU.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch


def resolve_device(device: torch.device | str | None = None) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU"
            )
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda":
        # float32 matrix products stay full float32 (TF32 keeps ~3 digits)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return device


@contextlib.contextmanager
def matmul_precision(setting: Optional[str]):
    """torch's float32 matrix-product precision set to ``setting`` for the
    block and restored after it ("highest": full float32, TF32 off); None
    leaves it as it is."""
    if setting is None:
        yield
        return
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision(setting)
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(before)
