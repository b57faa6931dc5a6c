"""Single-image inference API.

Port of ``gaiaseg_tpu/engine/inference.py`` (the reference's
``gaiaseg/apis/inference.py``): ``init_segmentor`` builds the model from a
config and loads a ``.pth`` checkpoint with its CLASSES / PALETTE,
``inference_segmentor`` runs one image through the test pipeline's
normalization and the ``test_cfg`` mode, ``show_result`` overlays the
palette (no display needed).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from ..data.datasets import CITYSCAPES_PALETTE
from ..data.pipeline_cfg import parse_test_pipeline
from ..data.transforms import prepare_eval_batch
from ..models.arch_util import encode_arch, model_max_arch
from ..models.builder import build_segmentor, fill_img_size
from ..utils.config import Config
from ..utils.device import resolve_device
from .checkpoint import load_checkpoint
from .numerics import autocast


class Segmentor:
    """A model in eval mode with its MAX arch, config, device, CLASSES and
    PALETTE."""

    def __init__(self, model, max_arch: Dict[str, Any], cfg,
                 device: torch.device, classes=None, palette=None):
        self.model = model
        self.max_arch = max_arch
        self.cfg = cfg
        self.device = device
        self.CLASSES = classes
        self.PALETTE = palette

    def arch(self, meta: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        return encode_arch(self.max_arch, meta)


def init_segmentor(config: Union[str, Config],
                   checkpoint: Optional[str] = None, device="cuda",
                   seed: int = 0) -> Segmentor:
    """The config's segmentor (weights from ``seed``, then ``checkpoint``'s
    when given) on ``device``, in eval mode."""
    device = resolve_device(device)
    cfg = Config.fromfile(config) if isinstance(config, str) else config
    torch.manual_seed(seed)
    model = build_segmentor(fill_img_size(cfg),
                            test_cfg=cfg["model"].get("test_cfg"))
    model.to(device)
    classes = palette = None
    if checkpoint:
        meta = load_checkpoint(checkpoint, model)
        classes, palette = meta.get("CLASSES"), meta.get("PALETTE")
    model.eval()
    return Segmentor(model, model_max_arch(cfg["model"]), cfg, device,
                     classes, palette)


@torch.no_grad()
def inference_segmentor(seg: Segmentor, img: Union[str, np.ndarray],
                        arch_meta: Optional[Dict[str, Any]] = None
                        ) -> np.ndarray:
    """The per-pixel class map ``[H, W]`` int32 of one RGB image (a path or
    an ``[H, W, 3]`` uint8 array) at the arch of ``arch_meta`` (MAX when
    None)."""
    if isinstance(img, str):
        from PIL import Image
        with Image.open(img) as im:
            img = np.asarray(im.convert("RGB"), np.uint8)
    pipe = parse_test_pipeline(
        ((seg.cfg.get("data") or {}).get("test") or {}).get("pipeline"))
    dtype = torch.bfloat16 if seg.device.type == "cuda" else torch.float32
    x = prepare_eval_batch(torch.from_numpy(np.ascontiguousarray(img[None]))
                           .to(seg.device), pipe.mean, pipe.std, dtype=dtype)
    with autocast(seg.device):
        pred = seg.model.simple_test(x, seg.arch(arch_meta))
    return pred[0].cpu().numpy().astype(np.int32)


def show_result(img: np.ndarray, seg_map: np.ndarray, palette=None,
                opacity: float = 0.5,
                out_file: Optional[str] = None) -> np.ndarray:
    """``img`` blended with the palette colour of each pixel's class."""
    palette = np.asarray(palette if palette is not None
                         else CITYSCAPES_PALETTE, np.uint8)
    color = palette[np.clip(seg_map, 0, len(palette) - 1)]
    blend = (img.astype(np.float32) * (1 - opacity)
             + color.astype(np.float32) * opacity).astype(np.uint8)
    if out_file:
        from PIL import Image
        Image.fromarray(blend).save(out_file)
    return blend
