"""Hand-written CUDA kernels (sources in ``gaiaseg_tpu_torch/csrc``), their
ctypes bindings, launch counters and plain torch versions: ``resize_ce``
(K1, K2), ``flash_attention`` (K3, K4, K5) and ``crop_counts`` (RandomCrop's
window counts)."""
from .build import LAUNCHES, reset_launches
from .resize_ce import (fused_resize_ce, fused_resize_ce_reference,
                        supports_fused_resize_ce)

__all__ = ["LAUNCHES", "reset_launches", "fused_resize_ce",
           "fused_resize_ce_reference", "supports_fused_resize_ce"]
