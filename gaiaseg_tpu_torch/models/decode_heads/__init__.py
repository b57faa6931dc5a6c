from .fcn_head import DynamicFCNHead
from .psp_head import DynamicPSPHead

__all__ = ["DynamicPSPHead", "DynamicFCNHead"]
