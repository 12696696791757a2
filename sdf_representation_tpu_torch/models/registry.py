"""Model registry (counterpart of sdf_representation_tpu/models/registry.py).

Only the ImplicitNet family is ported so far; the other names raise
NotImplementedError and point at their ROADMAP.md entry."""

from .implicit_net import ImplicitNet, ImplicitNetCompatible

MODEL_REGISTRY = {
    "ImplicitNet": ImplicitNet,
    "ImplicitNetCompatible": ImplicitNetCompatible,
}

_NOT_PORTED = ("FeedForwardNetwork", "KAN", "HashMLP", "Siren")


def get_model_class(name: str):
    if name in MODEL_REGISTRY:
        return MODEL_REGISTRY[name]
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"model '{name}' is not ported to torch yet: ROADMAP.md, queue 1, "
            "'Other model families'"
        )
    raise ValueError(f"Unknown model '{name}'. Available: {sorted(MODEL_REGISTRY)}")
