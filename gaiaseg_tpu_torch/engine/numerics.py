"""Numerics of the port on the card: full-float32 matmuls, bf16 autocast.

The JAX model computes in bf16 with float32 parameters (``dtype=bfloat16``);
the port does so under ``torch.autocast`` on CUDA and in float32 on the CPU.
"""
from __future__ import annotations

from typing import Dict

import torch


def configure_numerics() -> Dict[str, bool]:
    """float32 matmuls and convs in full float32 (no TF32): the loss's width
    interpolation stays exact; convs run in bf16 under autocast anyway."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return {"cuda.matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
            "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32}


def autocast(device: torch.device):
    """bf16 autocast on CUDA (the JAX model's ``dtype=bfloat16``); a no-op
    on the CPU, where the port computes in float32."""
    return torch.autocast(device.type, dtype=torch.bfloat16,
                          enabled=device.type == "cuda")
