"""Weights carried across between the JAX package and the port.

The JAX ImplicitNet keeps its parameters as the pytree
``{"layers": [{"w": (in, out), "b": (out,), ("c": ())}, ...]}``; the port's
module keeps ``lin{i}.weight`` (out, in), ``lin{i}.bias`` and, for the
Lipschitz variant, ``lip{i}``. The other families keep the JAX tree's own
layout under dotted names (a list entry by its index):

  HashMLP             {"tables": [L x (T, F)], "mlp": [{"w", "b"}]}; the port
                      stacks the tables into one (L, T, F) ``tables``
  FeedForwardNetwork  {"layers": [{"v", "g", "b"}], "out": {"v", "g", "b"}}
  Siren               {"layers": [{"w", "b"}]} (the ImplicitNet keys: which
                      layout applies is the model's, so pass it)
  KAN                 {"layers": [{"grid", "base_w", "spline_w",
                      "spline_scaler"}]}; ``grid`` is a buffer of the port's
                      module, carried as the other leaves

A JAX gradient pytree has the layout of the params, and the JAX trainer's
``trainable`` adds the losses' learnable scalars under ``"aux"``. All
functions take and give numpy arrays on the JAX side, so the port never
imports JAX.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .models.implicit_net import ImplicitNet


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        for key, value in tree.items():
            yield from _flatten(value, f"{prefix}{key}.")
    elif isinstance(tree, (list, tuple)):
        for i, value in enumerate(tree):
            yield from _flatten(value, f"{prefix}{i}.")
    else:
        yield prefix[:-1], np.asarray(tree, np.float32)


def params_from_jax(tree, model=None) -> Dict[str, torch.Tensor]:
    """JAX params (numpy or array-likes) -> the port's state_dict for
    ``model``'s family (an ImplicitNet's when ``model`` is None). A JAX
    gradient pytree has the same layout, so this also names gradients as
    the port's parameters (an ImplicitNet's (out, in)) to compare with
    ``.grad``."""
    if model is not None and not isinstance(model, ImplicitNet):
        tree = dict(tree)
        if "tables" in tree:  # HashMLP: one stacked (L, T, F) parameter
            tree["tables"] = np.stack([np.asarray(t, np.float32) for t in tree["tables"]])
        return {name: torch.from_numpy(arr.copy()) for name, arr in _flatten(tree)}
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
    """The port's model -> the JAX params pytree of its family, as numpy
    arrays."""
    if not isinstance(module, ImplicitNet):
        tree: dict = {}
        for name, value in module.state_dict().items():
            *path, leaf = name.split(".")
            node = tree
            for key in path:
                node = node.setdefault(key, {})
            node[leaf] = value.detach().cpu().numpy().copy()
        if "tables" in tree:
            tree["tables"] = list(tree["tables"])
        return _lists(tree)
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


def _lists(node):
    """Dicts keyed "0".."n-1" (a list's entries under dotted names) -> lists."""
    if not isinstance(node, dict):
        return node
    node = {key: _lists(value) for key, value in node.items()}
    if node and all(key.isdigit() for key in node):
        return [node[str(i)] for i in range(len(node))]
    return node
