"""Label-space surgery: remap classifier weights between label spaces.

Port of ``gaiaseg_tpu/engine/label_surgery.py`` (gaiavision
``FCMapLabelSurgeon`` / ``LabelMapping``, referenced by the reference's
``tools/extract_subnet.py:28-29``): given a mapping from new label ids to
old ones, rebuild the 1x1 ``conv_seg`` classifier so an extracted subnet
predicts the new label space directly. The port's weight is OIHW
``[C, ch, kh, kw]``, so the class axis is 0.
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch


def remap_classifier(state_dict: Dict[str, torch.Tensor],
                     label_mapping: Sequence[int],
                     prefix: str = "decode_head.conv_seg",
                     init_scale: float = 0.0) -> Dict[str, torch.Tensor]:
    """A copy of ``state_dict`` with the classifier at ``prefix`` remapped.

    ``label_mapping[i]`` is the source class of new class ``i``, or -1 for
    a fresh class: zeros, or with ``init_scale > 0`` a weight of
    ``init_scale``-scaled normal noise and a zero bias. The noise is the
    JAX function's: one ``np.random.RandomState(0)`` draw of the HWIO
    kernel's ``[kh, kw, ch]`` per fresh class, in class order.
    """
    weight = state_dict[f"{prefix}.weight"]
    _, c_in, kh, kw = weight.shape
    new_weight = weight.new_zeros((len(label_mapping), c_in, kh, kw))
    rng = np.random.RandomState(0)
    for i, src in enumerate(label_mapping):
        if src >= 0:
            new_weight[i] = weight[src]
        elif init_scale > 0:      # float64 draw, rounded to the dtype
            noise = rng.randn(kh, kw, c_in) * init_scale
            new_weight[i] = torch.from_numpy(noise).permute(2, 0, 1)
    out = dict(state_dict)
    out[f"{prefix}.weight"] = new_weight
    bias = state_dict.get(f"{prefix}.bias")
    if bias is not None:
        new_bias = bias.new_zeros(len(label_mapping))
        for i, src in enumerate(label_mapping):
            if src >= 0:
                new_bias[i] = bias[src]
        out[f"{prefix}.bias"] = new_bias
    return out
