from . import losses  # noqa: F401  (registers loss classes)
from .arch_util import (backbone_max_arch, canonical_arch, encode_arch,
                        model_max_arch)
from .backbones import DynamicResNet
from .builder import build_backbone, build_head, build_loss, build_segmentor
from .decode_heads import DynamicFCNHead, DynamicPSPHead
from .segmentors import DynamicEncoderDecoder

__all__ = ["DynamicResNet", "DynamicPSPHead", "DynamicFCNHead",
           "DynamicEncoderDecoder", "build_backbone", "build_head",
           "build_loss", "build_segmentor", "backbone_max_arch",
           "model_max_arch", "canonical_arch", "encode_arch"]
