from .ffn import FeedForwardNetwork
from .hash_mlp import HashMLP
from .implicit_net import ImplicitNet, ImplicitNetCompatible
from .kan import KAN
from .registry import MODEL_REGISTRY, get_model_class, register_model
from .siren import Siren

__all__ = [
    "ImplicitNet",
    "ImplicitNetCompatible",
    "FeedForwardNetwork",
    "KAN",
    "HashMLP",
    "Siren",
    "MODEL_REGISTRY",
    "get_model_class",
    "register_model",
]
