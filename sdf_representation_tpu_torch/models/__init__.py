from .implicit_net import ImplicitNet, ImplicitNetCompatible
from .registry import get_model_class

__all__ = ["ImplicitNet", "ImplicitNetCompatible", "get_model_class"]
