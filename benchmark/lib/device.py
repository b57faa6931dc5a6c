"""The card: presence, name, power limit and memory peak."""
from __future__ import annotations

import subprocess
import sys
from typing import Any, Dict


def require_cards(n: int) -> None:
    """Exit (code 3, no result) unless CUDA sees ``n`` cards or more: the
    benchmark never falls back to the CPU."""
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs on the card only",
              file=sys.stderr)
        raise SystemExit(3)
    if torch.cuda.device_count() < n:
        print(f"the cell asks for {n} cards, CUDA sees "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        raise SystemExit(3)


def power_limit() -> str:
    """``nvidia-smi``'s power limit of card 0, or '' where it is absent."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20, check=False).stdout
    except (OSError, subprocess.TimeoutExpired):
        return ""
    return out.strip().splitlines()[0] if out.strip() else ""


def device_info(count: int = 1, device=None) -> Dict[str, Any]:
    import torch
    if device is not None and device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0, "power_limit": ""}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": int(count),
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(0)),
            "power_limit": power_limit()}
