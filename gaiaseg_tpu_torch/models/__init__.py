from . import losses  # noqa: F401  (registers loss classes)
from .arch_util import (backbone_max_arch, canonical_arch, encode_arch,
                        model_max_arch)
from .backbones import DynamicResNet, ElasticTransformer
from .builder import (build_backbone, build_head, build_loss, build_neck,
                      build_segmentor)
from .decode_heads import (DepthwiseSeparableASPPHead, DynamicASPPHead,
                           DynamicFCNHead, DynamicPSPHead, DynamicUPerHead)
from .necks import DynamicMultiLevelNeck
from .segmentors import DynamicEncoderDecoder

__all__ = ["DynamicResNet", "ElasticTransformer", "DynamicMultiLevelNeck",
           "DynamicPSPHead", "DynamicFCNHead", "DynamicUPerHead",
           "DynamicASPPHead", "DepthwiseSeparableASPPHead",
           "DynamicEncoderDecoder", "build_backbone", "build_neck",
           "build_head", "build_loss", "build_segmentor",
           "backbone_max_arch", "model_max_arch", "canonical_arch",
           "encode_arch"]
