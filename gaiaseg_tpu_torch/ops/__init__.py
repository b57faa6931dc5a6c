from .blocks import DynBottleneck, DynConvModule
from .dynamic_layers import DynBatchNorm, DynConv2d, frozen_bn_stats
from .resize import adaptive_avg_pool2d, resize_bilinear

__all__ = ["DynConv2d", "DynBatchNorm", "frozen_bn_stats", "DynConvModule",
           "DynBottleneck", "resize_bilinear", "adaptive_avg_pool2d"]
