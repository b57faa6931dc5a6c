from . import losses  # noqa: F401  (registers loss classes)
from .arch_util import (backbone_max_arch, canonical_arch, encode_arch,
                        model_max_arch)
from .backbones import (BEiT, DynamicConvNeXt, DynamicResNet,
                        ElasticConvformer, ElasticMixViT, ElasticTransformer)
from .builder import (build_backbone, build_head, build_loss, build_neck,
                      build_segmentor, fill_img_size)
from .decode_heads import (DepthwiseSeparableASPPHead, DynamicASPPHead,
                           DynamicFCNHead, DynamicPSPHead, DynamicUPerHead,
                           SegFormerHead)
from .necks import DynamicMultiLevelNeck
from .segmentors import DynamicDistiller, DynamicEncoderDecoder

__all__ = ["BEiT", "DynamicConvNeXt", "DynamicResNet", "ElasticConvformer",
           "ElasticMixViT", "ElasticTransformer",
           "DynamicMultiLevelNeck",
           "DynamicPSPHead", "DynamicFCNHead", "DynamicUPerHead",
           "DynamicASPPHead", "DepthwiseSeparableASPPHead", "SegFormerHead",
           "DynamicEncoderDecoder", "DynamicDistiller", "build_backbone",
           "build_neck", "build_head", "build_loss", "build_segmentor",
           "fill_img_size",
           "backbone_max_arch", "model_max_arch", "canonical_arch",
           "encode_arch"]
