"""Config registry of the port: the dense GQA architectures it serves."""

from .base import MLAConfig, ModelConfig, MoEConfig, SSMConfig, XLSTMConfig
from .registry import ALIASES, ARCHS, get_config, list_archs

__all__ = [
    "MLAConfig", "ModelConfig", "MoEConfig", "SSMConfig", "XLSTMConfig",
    "ALIASES", "ARCHS", "get_config", "list_archs",
]
