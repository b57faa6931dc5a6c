from .config import Config, ConfigDict
from .device import resolve_device
from .registry import (BACKBONES, DATASETS, HEADS, LOSSES, NECKS, RULES,
                       SAMPLERS, SEGMENTORS, Registry, build_from_cfg)
from .sweep import SweepLog, sweep_key

__all__ = ["Config", "ConfigDict", "resolve_device", "Registry",
           "build_from_cfg", "BACKBONES", "DATASETS", "HEADS", "LOSSES",
           "NECKS", "RULES", "SAMPLERS", "SEGMENTORS", "SweepLog",
           "sweep_key"]
