"""Device selection for the port's entry points.

Entry points default to ``cuda`` and run on the CPU only when the caller
asks for it. A request for ``cuda`` on a machine without a card raises; it
never drops to the CPU quietly.
"""
from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} was asked for but torch sees no CUDA "
            "device; pass device='cpu' to run on the CPU")
    return dev
