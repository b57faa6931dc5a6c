from .blocks import DynBottleneck, DynConvModule
from .dynamic_layers import DynBatchNorm, DynConv2d
from .resize import adaptive_avg_pool2d, resize_bilinear

__all__ = ["DynConv2d", "DynBatchNorm", "DynConvModule", "DynBottleneck",
           "resize_bilinear", "adaptive_avg_pool2d"]
