from .base import ModelConfig, get_config, list_archs, register
from . import api, layers

__all__ = ["ModelConfig", "get_config", "list_archs", "register", "api",
           "layers"]
