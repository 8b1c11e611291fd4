"""Config registry of the port: the reference's architectures and shape
presets."""

from .base import MLAConfig, ModelConfig, MoEConfig, SSMConfig, XLSTMConfig
from .registry import ALIASES, ARCHS, get_config, list_archs
from .shapes import SHAPES, ShapeSpec, cell_status

__all__ = [
    "MLAConfig", "ModelConfig", "MoEConfig", "SSMConfig", "XLSTMConfig",
    "ALIASES", "ARCHS", "get_config", "list_archs",
    "SHAPES", "ShapeSpec", "cell_status",
]
