"""The distiller's frozen-teacher weights: ``load_teacher_checkpoint``.

Port of ``gaiaseg_tpu/engine/train.py:303-375``. Two kinds of ``.pth``
file, told apart by their keys (JAX tells them apart by format):

- **A teacher file of the port**: its keys carry the teacher subtrees
  (``t_backbone.*``, ``t_neck.*``, ``t_decode_head.*``), as
  ``tools/make_teacher_ckpt.py`` writes them or as a distiller's own
  checkpoint holds them. Every teacher entry of the model, BN statistics
  included, must be in it.
- **A reference teacher segmentor** in the official layout:
  ``backbone.*`` (or a bare backbone's keys) goes to ``t_backbone`` and
  ``decode_head.*`` to ``t_decode_head`` (``neck.*`` to ``t_neck``; the
  auxiliary head is left behind). A BEiT backbone takes the
  keys JAX's ``beit_state_dict_to_params`` maps (the patch embed, the cls
  token, the blocks with their separate q/v biases or a fused qkv bias
  whose k third is dropped, the shared or per-block tables resampled to
  the model's window) and the FPN adapters' deconvs (``fpn1.0``,
  ``fpn1.3``, ``fpn2.0``: torch's ``ConvTranspose2d`` layout in the file
  and in the port), and skips the rest. ``fpn1.1`` is a BN in the
  reference and a LayerNorm here (as in JAX), so no official file can fill
  it: it keeps its init, with a warning when the teacher has a decode
  head, which was trained on the reference's adapters. JAX loads none of
  the adapters (ROADMAP C15). A DynamicResNet teacher takes its keys as
  they are
  (JAX passes them through its BEiT converter, which maps none: ROADMAP
  C13). Decode-head keys
  without a teacher head raise, as does a teacher head without them: a
  fresh head would corrupt ``distill_loss_seg`` silently.
"""
from __future__ import annotations

import logging
from typing import Dict

import torch

from ..models.backbones.beit import BEiT
from ..models.segmentors.dynamic_distiller import TEACHER_PREFIXES
from ..parallel.mesh import shard_state_dict
from .ckpt_surgery import surgery_beit_checkpoint

logger = logging.getLogger("gaiaseg_tpu_torch")


# the FPN adapters' slots whose official and port layouts agree
_BEIT_DECONVS = ("fpn1.0.", "fpn1.3.", "fpn2.0.")


def _beit_keys(sd: Dict[str, torch.Tensor], window) -> Dict[str,
                                                           torch.Tensor]:
    """The entries of an official BEiT state dict that JAX's converter
    maps, with the port's names (a fused qkv bias split into q and v),
    and the FPN adapters' deconvs."""
    if window[0] != window[1]:
        raise NotImplementedError(f"table surgery for a {window} grid: "
                                  "square windows only (as in JAX)")
    sd = surgery_beit_checkpoint(sd, window[0])
    out = {}
    for k, v in sd.items():
        if k.startswith(("patch_embed.proj.", "rel_pos_bias.")
                        + _BEIT_DECONVS) or k == "cls_token":
            out[k] = v
        elif k.startswith("blocks."):
            if k.endswith("attn.qkv.bias"):
                d = v.shape[0] // 3
                pre = k[:-len("qkv.bias")]
                out[pre + "q_bias"], out[pre + "v_bias"] = v[:d], v[2 * d:]
            else:
                out[k] = v
    return out


@torch.no_grad()
def load_teacher_checkpoint(path: str, model) -> Dict[str, list]:
    """Load the teacher of the distiller ``model`` from ``path`` in place;
    returns ``{'loaded': [...], 'kept_init': [...]}`` (state-dict keys)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(ckpt, dict):
        ckpt = ckpt.get("state_dict", ckpt.get("model", ckpt))
    sd = {k[len("module."):] if k.startswith("module.") else k: v
          for k, v in ckpt.items()}
    own = {k: v for k, v in model.state_dict().items()
           if k.split(".", 1)[0] in TEACHER_PREFIXES}
    if any(k.startswith("t_backbone.") for k in sd):
        src = {k: v for k, v in sd.items() if k in own}
        missing = sorted(set(own) - set(src))
        if missing:
            raise KeyError(f"teacher checkpoint {path} lacks {len(missing)} "
                           f"teacher entries of the model, e.g. {missing[:4]}")
        kind = "port teacher file"
    else:
        has_head = any(k.startswith("decode_head.") for k in sd)
        if has_head and model.t_decode_head is None:
            raise ValueError(
                f"teacher checkpoint {path} carries decode_head.* keys but "
                "the distiller has no teacher_decode_head configured")
        if model.t_decode_head is not None and not has_head:
            raise ValueError(
                f"teacher checkpoint {path} has no decode_head.* keys but "
                "the distiller computes distill_loss_seg from "
                "t_decode_head: supply a full teacher segmentor checkpoint "
                "or a teacher file with the t_decode_head entries")
        # as JAX: every key but the heads' and the neck's is the
        # backbone's, ``backbone.`` prefixed or bare
        heads = ("decode_head.", "auxiliary_head.", "neck.")
        part = {k[len("backbone."):] if k.startswith("backbone.") else k: v
                for k, v in sd.items() if not k.startswith(heads)}
        if isinstance(model.t_backbone, BEiT):
            part = _beit_keys(part, model.t_backbone.window)
            skipped = sorted(k for k in part if "t_backbone." + k not in own)
            if skipped:
                logger.info("teacher checkpoint %s: %d BEiT entries the "
                            "teacher has no slot for, skipped as JAX skips "
                            "them (%s...)", path, len(skipped), skipped[:3])
            part = {k: v for k, v in part.items() if k not in skipped}
        src = {"t_backbone." + k: v for k, v in part.items()}
        for old in ("neck.", "decode_head."):
            src.update({"t_" + k: v for k, v in sd.items()
                        if k.startswith(old)})
        unknown = sorted(set(src) - set(own))
        if unknown:
            raise KeyError(f"teacher checkpoint {path}: {len(unknown)} "
                           f"entries the teacher does not have, e.g. "
                           f"{unknown[:4]}")
        kind = "official-layout teacher segmentor"
    src = shard_state_dict(model, src)     # a sharded teacher: its shards
    for k, v in src.items():
        if tuple(v.shape) != tuple(own[k].shape):
            raise ValueError(f"teacher checkpoint {path}: {k} is "
                             f"{tuple(v.shape)}, the model's "
                             f"{tuple(own[k].shape)}")
        own[k].copy_(v)
    kept = sorted(set(own) - set(src))
    # a decode head trained on features the file cannot rebuild
    log = logger.warning if kept and model.t_decode_head is not None \
        else logger.info
    log("loaded the teacher from %s (%s): %d entries, %d kept at init%s",
        path, kind, len(src), len(kept), f" ({kept[:3]}...)" if kept else "")
    return {"loaded": sorted(src), "kept_init": kept}
