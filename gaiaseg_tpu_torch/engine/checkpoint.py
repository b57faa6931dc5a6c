"""Checkpoints: reference-layout ``.pth`` files, ``latest.pth``, subnet names.

Port of ``gaiaseg_tpu/engine/checkpoint.py``. The JAX package writes msgpack
pytrees; the port writes what mmcv's ``CheckpointHook`` writes and the
reference tools read: ``{"meta": ..., "state_dict": ..., "optimizer": ...}``
in one ``torch.save`` file. ``meta`` carries ``iter``, ``CLASSES``,
``PALETTE`` and ``max_arch`` (JAX ``engine/train.py:994-999``). The JAX
package's own ``engine/torch_convert.py`` ``load_torch_segmentor`` reads
these files.

- ``resume_from`` restores weights, BN statistics, the optimizer state and
  the iteration; ``load_from`` only the weights (mmcv's split).
- Loading is ``strict=False``: missing and unexpected keys are logged, as
  mmcv's ``load_checkpoint`` logs them, so reference ``.pth`` files load as
  they are.
- A file is written under a temporary name and renamed into place, and
  ``latest.pth`` is a symlink swapped in the same way, so a crash leaves
  either the old file or the new one.
- A model sharded over a ``model`` axis (``parallel.mesh.shard_state``) is
  saved at full shapes: every rank gathers its parameters and optimizer
  state (``write=False`` on all but the writer), so the file is the one a
  single process writes, under the same names. Loading cuts each full
  entry to the rank's shard, so a file loads at any K, or with none.
"""
from __future__ import annotations

import logging
import os
import os.path as osp
from typing import Any, Dict, Optional

import torch

from ..archspace.meta import meta_hash
from ..parallel.mesh import (gather_optimizer_state, gather_state_dict,
                             shard_optimizer_state, shard_state_dict)
from ..parallel.tensor_parallel import is_sharded

logger = logging.getLogger("gaiaseg_tpu_torch")
LATEST = "latest.pth"


def _to_cpu(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def save_checkpoint(path: str, model, optimizer=None,
                    meta: Optional[Dict[str, Any]] = None,
                    write: bool = True) -> None:
    """Write ``model``'s state dict, ``optimizer``'s state and ``meta`` to
    ``path`` (via a temporary file in the same directory). A sharded
    model's state is gathered first, a collective: every rank calls this,
    and those with ``write=False`` only join the gathers."""
    sharded = is_sharded(model)
    if not (write or sharded):
        return
    sd = gather_state_dict(model) if sharded else model.state_dict()
    osd = None
    if optimizer is not None:
        osd = gather_optimizer_state(optimizer) if sharded \
            else optimizer.state_dict()
    if not write:
        return
    os.makedirs(osp.dirname(osp.abspath(path)), exist_ok=True)
    ckpt = {"meta": dict(meta or {}), "state_dict": _to_cpu(sd)}
    if osd is not None:
        ckpt["optimizer"] = _to_cpu(osd)
    tmp = f"{path}.tmp{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            torch.save(ckpt, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        if osp.exists(tmp):
            os.remove(tmp)


def load_checkpoint(path: str, model, optimizer=None, strict: bool = False,
                    map_location="cpu") -> Dict[str, Any]:
    """Load ``path`` into ``model`` (and ``optimizer`` when given and the
    file holds its state); returns the checkpoint's ``meta``. A bare state
    dict, or one under ``state_dict`` with DataParallel's ``module.``
    prefix, loads too."""
    ckpt = torch.load(path, map_location=map_location, weights_only=False)
    sd = ckpt.get("state_dict", ckpt) if isinstance(ckpt, dict) else ckpt
    if all(k.startswith("module.") for k in sd):
        sd = {k[len("module."):]: v for k, v in sd.items()}
    res = model.load_state_dict(shard_state_dict(model, sd), strict=strict)
    if res.missing_keys:
        logger.warning("%s: missing keys in source state_dict: %s", path,
                       ", ".join(res.missing_keys))
    if res.unexpected_keys:
        logger.warning("%s: unexpected keys in source state_dict: %s", path,
                       ", ".join(res.unexpected_keys))
    if optimizer is not None and isinstance(ckpt, dict) \
            and "optimizer" in ckpt:
        optimizer.load_state_dict(shard_optimizer_state(optimizer,
                                                        ckpt["optimizer"]))
    return dict(ckpt.get("meta") or {}) if isinstance(ckpt, dict) else {}


def latest_checkpoint(work_dir: str) -> Optional[str]:
    link = osp.join(work_dir, LATEST)
    return link if osp.exists(link) else None


def update_latest(work_dir: str, ckpt_path: str) -> None:
    """Point ``work_dir/latest.pth`` at ``ckpt_path`` (relative, so the
    directory can move)."""
    link = osp.join(work_dir, LATEST)
    tmp = link + ".tmp"
    if osp.lexists(tmp):
        os.remove(tmp)
    os.symlink(osp.relpath(osp.abspath(ckpt_path), osp.abspath(work_dir)),
               tmp)
    os.replace(tmp, link)


def subnet_ckpt_name(meta: Dict[str, Any]) -> str:
    """``md5(json(meta))[:8].pth``: the reference extract_subnet's name
    (JAX ``checkpoint.py:58``, with the port's suffix)."""
    return f"{meta_hash(meta)}.pth"
