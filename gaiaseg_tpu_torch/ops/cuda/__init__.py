"""Hand-written CUDA kernels (sources in ``gaiaseg_tpu_torch/csrc``), their
ctypes bindings, launch counters and plain torch versions."""
from .resize_ce import (LAUNCHES, fused_resize_ce, fused_resize_ce_reference,
                        reset_launches, supports_fused_resize_ce)

__all__ = ["LAUNCHES", "reset_launches", "fused_resize_ce",
           "fused_resize_ce_reference", "supports_fused_resize_ce"]
