from .config_reader import Configuration

__all__ = ["Configuration"]
