from . import losses  # noqa: F401  (registers loss classes)
from .arch_util import (backbone_max_arch, canonical_arch, encode_arch,
                        model_max_arch)
from .backbones import (BEiT, DynamicConvNeXt, DynamicResNet,
                        ElasticConvformer, ElasticTransformer)
from .builder import (build_backbone, build_head, build_loss, build_neck,
                      build_segmentor, fill_img_size)
from .decode_heads import (DepthwiseSeparableASPPHead, DynamicASPPHead,
                           DynamicFCNHead, DynamicPSPHead, DynamicUPerHead)
from .necks import DynamicMultiLevelNeck
from .segmentors import DynamicDistiller, DynamicEncoderDecoder

__all__ = ["BEiT", "DynamicConvNeXt", "DynamicResNet", "ElasticConvformer",
           "ElasticTransformer",
           "DynamicMultiLevelNeck",
           "DynamicPSPHead", "DynamicFCNHead", "DynamicUPerHead",
           "DynamicASPPHead", "DepthwiseSeparableASPPHead",
           "DynamicEncoderDecoder", "DynamicDistiller", "build_backbone",
           "build_neck", "build_head", "build_loss", "build_segmentor",
           "fill_img_size",
           "backbone_max_arch", "model_max_arch", "canonical_arch",
           "encode_arch"]
