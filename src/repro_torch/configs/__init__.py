"""Architecture configs of the port (only what is ported is registered)."""

from repro_torch.configs.base import ArchConfig, ShapeSpec, SHAPES
from repro_torch.configs.registry import get_config, list_configs

__all__ = ["ArchConfig", "ShapeSpec", "SHAPES", "get_config", "list_configs"]
