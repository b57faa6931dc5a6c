from .config import Config, ConfigDict
from .device import resolve_device
from .registry import (BACKBONES, DATASETS, HEADS, LOSSES, NECKS, SAMPLERS,
                       SEGMENTORS, Registry, build_from_cfg)

__all__ = ["Config", "ConfigDict", "resolve_device", "Registry",
           "build_from_cfg", "BACKBONES", "DATASETS", "HEADS", "LOSSES",
           "NECKS", "SAMPLERS", "SEGMENTORS"]
