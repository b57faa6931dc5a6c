"""Weights from the seed, made on the card in one draw.

Every parameter is named as in the port's ``state_dict`` (the published
mmseg/timm layout), so the plain reference, which lays out its own
parameters under the same names, receives the same values. A conv weight
``[O, I, kh, kw]`` is normal with std ``sqrt(2 / (O * kh * kw))`` (fan-out,
as the port's init), a head's classifier ``conv_seg`` with std 0.01
(mmseg's init of it), a linear ``[O, I]`` with std ``I ** -0.5``, a
``[1, N, C]`` embedding with std 0.02; one-dimensional parameters are
constants (weights, the norm scales, 1; biases 0), but for the norm scales
a configuration draws (``scales``: each the absolute value of a normal
draw times the pattern's std).
"""
from __future__ import annotations

import fnmatch
import math
from typing import Dict, Iterable, Mapping, Optional, Tuple

import torch

Spec = Tuple[str, Tuple[int, ...]]

WEIGHTS_STREAM = 1       # sub-streams of one seed
RECORDS_STREAM = 2
PROGRAM_STREAM = 3


def stream_seed(seed: int, stream: int) -> int:
    """A generator seed per use of one ``--seed`` (any size)."""
    return (int(seed) * 1_000_003 + int(stream)) % (1 << 63)


CLASSIFIER_STD = 0.01    # mmseg's normal_init of a head's conv_seg


def weight_std(shape: Tuple[int, ...], name: str = "",
               scales: Optional[Mapping[str, float]] = None
               ) -> Optional[float]:
    """The std of a drawn parameter, None for a constant one."""
    if len(shape) == 1:
        return next((float(s) for pat, s in (scales or {}).items()
                     if fnmatch.fnmatchcase(name, pat)), None)
    if name.endswith("conv_seg.weight"):
        return CLASSIFIER_STD
    if len(shape) == 4:
        return math.sqrt(2.0 / (shape[0] * shape[2] * shape[3]))
    if len(shape) == 2:
        return shape[1] ** -0.5
    if len(shape) == 3:
        return 0.02
    return None


def seeded_weights(specs: Iterable[Spec], seed: int, device: torch.device,
                   scales: Optional[Mapping[str, float]] = None
                   ) -> Dict[str, torch.Tensor]:
    """float32 tensors on ``device`` for ``specs`` (``(name, shape)``),
    drawn in the order of the names from one generator seeded from
    ``seed``. A norm scale whose name matches a pattern of ``scales``
    (``fnmatch``) is drawn as ``|N(0, 1)| * std``: the flagship's
    bottlenecks' last scales, small as a trained residual branch's are, so
    that every branch carries gradient from the first step."""
    specs = sorted((n, tuple(int(d) for d in s)) for n, s in specs)
    drawn = [(n, s) for n, s in specs
             if weight_std(s, n, scales) is not None]
    total = sum(math.prod(s) for _, s in drawn)
    gen = torch.Generator(device=device)
    gen.manual_seed(stream_seed(seed, WEIGHTS_STREAM))
    flat = torch.randn(total, generator=gen, device=device,
                       dtype=torch.float32)
    out, off = {}, 0
    for name, shape in specs:
        std = weight_std(shape, name, scales)
        if std is None:
            out[name] = torch.full(shape, 1.0 if name.endswith("weight")
                                   else 0.0, device=device)
            continue
        n = math.prod(shape)
        out[name] = flat[off:off + n].view(shape).mul_(std)
        if len(shape) == 1:
            out[name].abs_()
        off += n
    return out


@torch.no_grad()
def load_seeded_weights(model: torch.nn.Module, seed: int,
                        scales: Optional[Mapping[str, float]] = None
                        ) -> None:
    """Overwrite every parameter of ``model`` with the seed's weights."""
    params = list(model.named_parameters())
    device = params[0][1].device
    weights = seeded_weights([(n, p.shape) for n, p in params], seed, device,
                             scales)
    for name, p in params:
        p.copy_(weights[name])
