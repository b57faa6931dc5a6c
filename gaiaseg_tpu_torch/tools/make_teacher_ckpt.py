"""Turn a trained segmentor checkpoint into a distiller teacher file.

Port of ``tools/make_teacher_ckpt.py`` in the port's format: the student
entries of a ``.pth`` checkpoint (``backbone.*``, ``decode_head.*``,
``neck.*``) are renamed to the distiller's frozen-teacher subtrees
(``t_backbone.*``, ``t_decode_head.*``, ``t_neck.*``); the auxiliary head
and the optimizer state are left behind. ``engine/teacher.py
load_teacher_checkpoint`` reads the result, BN statistics included. This
is the self-distillation path: a trained supernet (run at its MAX arch)
teaches a fresh one.

    python -m gaiaseg_tpu_torch.tools.make_teacher_ckpt trained.pth teacher.pth
"""
from __future__ import annotations

import argparse
import os
import os.path as osp
from typing import Dict

import torch

_REMAP = {"backbone.": "t_backbone.", "decode_head.": "t_decode_head.",
          "neck.": "t_neck."}


def convert(src_path: str, dst_path: str) -> Dict[str, torch.Tensor]:
    """Write the teacher file; returns its state dict."""
    ckpt = torch.load(src_path, map_location="cpu", weights_only=False)
    sd = ckpt.get("state_dict", ckpt) if isinstance(ckpt, dict) else ckpt
    out = {}
    for k, v in sd.items():
        k = k[len("module."):] if k.startswith("module.") else k
        for old, new in _REMAP.items():
            if k.startswith(old):
                out[new + k[len(old):]] = v
    if not any(k.startswith("t_backbone.") for k in out):
        raise ValueError(f"{src_path} has no student entries "
                         f"{sorted(_REMAP)}; keys start with "
                         f"{sorted({k.split('.')[0] for k in sd})}")
    meta = dict(ckpt.get("meta") or {}) if isinstance(ckpt, dict) else {}
    os.makedirs(osp.dirname(osp.abspath(dst_path)), exist_ok=True)
    torch.save({"meta": {**meta, "teacher_of": osp.basename(src_path)},
                "state_dict": out}, dst_path)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("src", help="a trained segmentor checkpoint (.pth)")
    p.add_argument("dst", help="the teacher file to write (.pth)")
    args = p.parse_args(argv)
    out = convert(args.src, args.dst)
    print(f"teacher checkpoint written: {args.dst} ({len(out)} entries: "
          f"{sorted({k.split('.')[0] for k in out})})")
    return out


if __name__ == "__main__":
    main()
