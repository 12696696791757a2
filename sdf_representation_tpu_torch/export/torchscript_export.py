"""TorchScript export — serve the port's models to the reference's LibTorch
consumers. Counterpart of sdf_representation_tpu/export/torchscript_export.py.

Role of the reference's ``save_as_libtorch``
(reference utils/inference_conversion.py:23-64: rebuild
``ImplicitNetCompatible``, remap ``lin{i}`` -> ``layers.{i}`` keys,
``torch.jit.script(...).save("implicit_model.pt")``, write random
input.csv/output.csv parity fixtures). A user with the reference's C++
harnesses (ops/conversion_test/test_loading.cpp:18 loads the .pt and
computes input gradients) can consume models trained by the port.

The scripted module is a re-statement of ImplicitNet semantics (skip concat
/ sqrt(2), Softplus(beta) or ReLU+tanh — reference model/networks.py:114-179)
with the reference's ``layers.{i}`` names: that class is the contract with
LibTorch consumers, and it is the JAX package's class, filled here from the
port module's ``export_params()`` on the CPU. ``import_torchscript`` reads a
.pt (this package's or the reference's) back into a port ImplicitNet.
"""

# NOTE: no `from __future__ import annotations` here — it stringifies the
# class-body annotation TorchScript needs to resolve (`skip_in: list[int]`).
import math
import os
from typing import List, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F  # noqa: N812 (resolved by the scripter)


class ImplicitNetCompatibleTorch(nn.Module):
    """Scriptable twin of reference ImplicitNetCompatible
    (model/networks.py:114-179)."""

    # class-level annotation: TorchScript cannot infer the element type of an
    # EMPTY list (no-skip models); it resolves the builtin generic, not
    # typing.List
    skip_in: list[int]

    def __init__(self, shapes: List[Tuple[int, int]], skip_in: List[int], beta: float):
        super().__init__()
        self.layers = nn.ModuleList([nn.Linear(fi, fo) for fi, fo in shapes])
        self.skip_in = list(skip_in)
        self.beta: float = float(beta)
        self.n_lin: int = len(shapes)
        self.inv_sqrt2: float = 1.0 / math.sqrt(2.0)

    def forward(self, x):
        inp = x
        h = x
        i = 0
        for lin in self.layers:
            if i in self.skip_in:
                h = torch.cat([h, inp], dim=-1) * self.inv_sqrt2
            h = lin(h)
            if i < self.n_lin - 1:
                if self.beta > 0.0:
                    h = F.softplus(h * self.beta) / self.beta
                else:
                    h = F.relu(h)
            elif self.beta <= 0.0:
                h = torch.tanh(h)
            i = i + 1
        return h


def build_torch_module(model) -> ImplicitNetCompatibleTorch:
    """The scriptable twin of a port ImplicitNet, on the CPU, in eval mode."""
    sd = model.export_params()
    n = model.num_layers - 1
    shapes = [(int(sd[f"lin{i}.weight"].shape[1]), int(sd[f"lin{i}.weight"].shape[0]))
              for i in range(n)]
    net = ImplicitNetCompatibleTorch(shapes, list(model.skip_in), model.beta)
    with torch.no_grad():
        for i, lin in enumerate(net.layers):
            lin.weight.copy_(sd[f"lin{i}.weight"].cpu())
            lin.bias.copy_(sd[f"lin{i}.bias"].cpu())
    net.eval()
    return net


def save_as_torchscript(out_dir: str, model, n_fixture: int = 100,
                        seed: int = 0) -> Tuple[str, str, str]:
    """Export implicit_model.pt + input.csv/output.csv parity fixtures
    (fixture convention of reference inference_conversion.py:56-64).

    Returns (pt_path, input_csv_path, output_csv_path)."""
    os.makedirs(out_dir, exist_ok=True)
    scripted = torch.jit.script(build_torch_module(model))
    pt_path = os.path.join(out_dir, "implicit_model.pt")
    scripted.save(pt_path)

    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1.0, 1.0, (n_fixture, model.d_in)).astype(np.float32)
    with torch.no_grad():
        out = scripted(torch.from_numpy(pts)).numpy()
    in_path = os.path.join(out_dir, "input.csv")
    out_path = os.path.join(out_dir, "output.csv")
    np.savetxt(in_path, pts, delimiter=",", fmt="%.8g")
    np.savetxt(out_path, out, delimiter=",", fmt="%.8g")
    return pt_path, in_path, out_path


def eval_torchscript(pt_path: str, points: np.ndarray, gradients: bool = False):
    """Load implicit_model.pt on the CPU and evaluate (the role of the
    reference C++ harness ops/conversion_test/test_loading.cpp — SDF values
    and, when ``gradients``, autograd input gradients)."""
    scripted = torch.jit.load(pt_path, map_location="cpu")
    x = torch.from_numpy(np.asarray(points, np.float32))
    if not gradients:
        with torch.no_grad():
            return scripted(x).numpy().reshape(len(points))
    x.requires_grad_(True)
    y = scripted(x)
    (grad,) = torch.autograd.grad(y.sum(), x)
    return y.detach().numpy().reshape(len(points)), grad.numpy()


def import_torchscript(pt_path: str, device=None):
    """Round-trip: a .pt (this package's or the reference's) -> a port
    ImplicitNet with its weights, on ``device`` (None: the card, as every
    entry point; "cpu" names the CPU). The architecture is inferred from the
    layer shapes (d_in from the first layer's fan-in) and beta is the
    scripted module's ``beta``."""
    from ..models.implicit_net import ImplicitNet
    from ..utils.device import resolve_device
    from .torch_import import import_torch_state_dict, infer_architecture

    scripted = torch.jit.load(pt_path, map_location="cpu")
    sd = import_torch_state_dict(dict(scripted.state_dict()))
    d_in = int(sd["lin0.weight"].shape[1])
    hidden, skip = infer_architecture(sd, d_in)
    model = ImplicitNet(d_in=d_in, hidden_dims=hidden, skip_in=skip, beta=float(scripted.beta),
                        device=resolve_device(device))
    model.load_state_dict(sd)
    return model
