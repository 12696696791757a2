"""Model registry (counterpart of sdf_representation_tpu/models/registry.py):
an explicit, extensible map from the INI's ``[Model] model`` name to a
class, in place of the reference's getattr on a module (reference
configgen/config_reader.py:19)."""

from .ffn import FeedForwardNetwork
from .hash_mlp import HashMLP
from .implicit_net import ImplicitNet, ImplicitNetCompatible
from .kan import KAN
from .siren import Siren

MODEL_REGISTRY = {
    "ImplicitNet": ImplicitNet,
    "ImplicitNetCompatible": ImplicitNetCompatible,
    "FeedForwardNetwork": FeedForwardNetwork,
    "KAN": KAN,
    "HashMLP": HashMLP,
    "Siren": Siren,
}


def get_model_class(name: str):
    try:
        return MODEL_REGISTRY[name]
    except KeyError:
        raise ValueError(f"Unknown model '{name}'. Available: {sorted(MODEL_REGISTRY)}") from None


def register_model(name: str, cls) -> None:
    MODEL_REGISTRY[name] = cls
