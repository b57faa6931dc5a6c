"""The frozen multiply-accumulate counter: conv, linear and attention MACs
a forward pass needs, worked out from the arch and the input shape alone.

It never counts from what ran, so a change that drops work cannot raise a
utilisation read against it. Each component's count lives in its part
(``reference/parts/<name>.py``, ``macs``), on the helpers here. Norms,
activations, pools, resizes and the loss are not counted; attention counts
``QK^T`` and ``PV``. ``heads`` picks the decode head alone (inference) or the
decode and auxiliary heads (training). A training step is three forward
passes' worth: ``6 * MACs`` operations; a forward pass ``2 * MACs``.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

from ..reference import parts


def _out(size: int, k: int, s: int, p: int, d: int = 1) -> int:
    return (size + 2 * p - d * (k - 1) - 1) // s + 1


def _conv(hw: Tuple[int, int], cin: int, cout: int, k: int) -> int:
    return hw[0] * hw[1] * cin * cout * k * k


def model_macs(model_cfg: Dict[str, Any], arch: Dict[str, Any],
               hw: Tuple[int, int], train: bool) -> int:
    """MACs of one image of ``hw`` through the segmentor at ``arch`` (the
    auxiliary head too when ``train``), each component counted by the part
    of its config type (``reference/parts/``)."""
    bb = model_cfg["backbone"]
    macs, feats = parts.get(bb["type"], "backbone").macs(
        bb, arch["backbone"], hw)
    neck = model_cfg.get("neck")
    if neck:
        neck_macs, feats = parts.get(neck["type"], "neck").macs(neck, feats)
        macs += neck_macs
    heads = [model_cfg["decode_head"]]
    aux = model_cfg.get("auxiliary_head")
    if train and aux:
        heads += aux if isinstance(aux, (list, tuple)) else [aux]
    for head in heads:
        macs += parts.get(head["type"], "head").macs(head, feats)
    return macs
