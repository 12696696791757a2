"""Weights carried across between the JAX package and the port.

The JAX ImplicitNet keeps its parameters as the pytree
``{"layers": [{"w": (in, out), "b": (out,), ("c": ())}, ...]}``; the port's
module keeps ``lin{i}.weight`` (out, in), ``lin{i}.bias`` and, for the
Lipschitz variant, ``lip{i}``. A JAX gradient pytree has the layout of the
params, and the JAX trainer's ``trainable`` adds the losses' learnable scalars
under ``"aux"``. All functions take and give numpy arrays on the JAX side, so
the port never imports JAX.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def params_from_jax(tree) -> Dict[str, torch.Tensor]:
    """JAX ImplicitNet params (numpy or array-likes) -> the port's state_dict.
    A JAX gradient pytree has the same layout, so this also names gradients
    as the port's parameters, (out, in), to compare with ``.grad``."""
    sd = {}
    for i, layer in enumerate(tree["layers"]):
        w = np.asarray(layer["w"], np.float32)
        sd[f"lin{i}.weight"] = torch.from_numpy(w.T.copy())
        sd[f"lin{i}.bias"] = torch.from_numpy(np.array(layer["b"], np.float32))
        if "c" in layer:
            sd[f"lip{i}"] = torch.from_numpy(np.array(layer["c"], np.float32))
    return sd


def aux_from_jax(trainable) -> Dict[str, torch.Tensor]:
    """The learnable scalars of a JAX ``trainable``
    (``trainable["aux"]["euler_characteristic"]``) -> the port's checkpoint
    entry ``"aux"``."""
    return {name: torch.tensor(float(np.asarray(value)), dtype=torch.float32)
            for name, value in trainable.get("aux", {}).items()}


def params_to_numpy(module) -> dict:
    """The port's ImplicitNet -> the JAX params pytree, as numpy arrays."""
    layers = []
    for i in range(module.num_layers - 1):
        lin = getattr(module, f"lin{i}")
        entry = {
            "w": lin.weight.detach().cpu().numpy().T.copy(),
            "b": lin.bias.detach().cpu().numpy().copy(),
        }
        if module.lipschitz:
            entry["c"] = getattr(module, f"lip{i}").detach().cpu().numpy().copy()
        layers.append(entry)
    return {"layers": layers}
