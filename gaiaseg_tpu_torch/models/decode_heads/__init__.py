from .aspp_head import DepthwiseSeparableASPPHead, DynamicASPPHead
from .fcn_head import DynamicFCNHead
from .psp_head import DynamicPSPHead
from .segformer_head import SegFormerHead
from .uper_head import DynamicUPerHead

__all__ = ["DynamicPSPHead", "DynamicFCNHead", "DynamicUPerHead",
           "DynamicASPPHead", "DepthwiseSeparableASPPHead", "SegFormerHead"]
