"""Supernet training: the train step and a short loop.

Port of ``gaiaseg_tpu/engine/train.py``: per iteration one arch from the
sandwich sampler, the LR schedule set on the host, one optimizer step (SGD
or AdamW, with the config's global-norm gradient clip) of
``forward_train``, losses logged. The batches come as in the JAX loop: a
``BatchLoader`` in the JAX package's order, the config's train pipeline
applied on the device (``data/transforms.py``) by a prefetch thread, and
epoch-based schedules resolved against the dataset's length.

The step has the semantics of the JAX ``make_train_step(update_stats=True)``
(``engine/train.py:72``): BN running stats update on EVERY step (torch BN in
train mode). The JAX hot loop instead takes "silent" steps that leave them
alone and recalibrates before eval; that choice comes back with the port's
BN-calibration slice.

Numerics on the card follow the JAX model: bf16 compute with float32
parameters (``torch.autocast`` on CUDA), float32 on the CPU. Every
parameter gets a gradient on every step (zeros where the subnet does not
reach it), so weight decay and momentum move all of them as optax does.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..archspace.samplers import build_model_sampler
from ..data.datasets import build_dataset
from ..data.device_cache import DeviceCachedDataset
from ..data.loader import BatchLoader, device_prefetch
from ..data.pipeline_cfg import parse_train_pipeline
from ..data.staging import DeviceFeed, take
from ..data.transforms import (augment_batch, draw_augment_params,
                               gather_augment_batch)
from ..models.arch_util import encode_arch, model_max_arch
from ..utils.device import resolve_device
from .optim import build_lr_schedule, build_optimizer, clip_grad_norm, \
    grad_clip_norm, scale_lr, set_learning_rate


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


def prepare_batch(samples: Sequence[Dict[str, np.ndarray]],
                  norm: Dict[str, Any], device: torch.device):
    """Samples of ``{'img': HxWx3 uint8, 'gt': HxW}`` -> normalized
    ``[N,3,H,W]`` float32 image and ``[N,H,W]`` int32 label on ``device``."""
    img = torch.from_numpy(np.stack([s["img"] for s in samples]))
    gt = torch.from_numpy(np.stack([s["gt"] for s in samples])
                          .astype(np.int32))
    mean = torch.tensor(norm["mean"], dtype=torch.float32, device=device)
    std = torch.tensor(norm["std"], dtype=torch.float32, device=device)
    img = img.to(device).permute(0, 3, 1, 2).float()
    img = (img - mean[None, :, None, None]) / std[None, :, None, None]
    return img.contiguous(), gt.to(device)


def train_step(model, optimizer: torch.optim.Optimizer, img: torch.Tensor,
               gt: torch.Tensor, arch: Dict[str, Any],
               generator: Optional[torch.Generator] = None,
               max_norm: Optional[float] = None) -> Dict[str, torch.Tensor]:
    """One optimizer step of ``model.forward_train`` at ``arch`` (the model
    is in train mode), the gradients first clipped to the global norm
    ``max_norm`` when it is given. Returns the detached losses (and the
    gradient norm before clipping)."""
    optimizer.zero_grad(set_to_none=False)
    with autocast(img.device):
        total, logs = model.forward_train(img, gt, arch, generator)
    total.backward()
    for p in model.parameters():
        if p.grad is None:   # outside this subnet: decay + moments only
            p.grad = torch.zeros_like(p)
    out = {"loss": total.detach(), **{k: v.detach() for k, v in logs.items()}}
    if max_norm is not None:
        out["grad_norm"] = clip_grad_norm(model.parameters(), max_norm)
    optimizer.step()
    return out


def _max_iters(cfg) -> int:
    runner = cfg.get("runner") or {}
    if runner.get("max_iters"):
        return int(runner["max_iters"])
    if cfg.get("total_iters"):
        return int(cfg["total_iters"])
    return int(runner.get("max_epochs", 1)) * 1000


def resolve_epoch_schedule(cfg, n_samples: int, global_batch: int):
    """mmcv EpochBasedRunner semantics -> this loop's iter domain (a copy
    of ``gaiaseg_tpu/engine/train.py:389``).

    The reference fast-finetune schedules are written in epochs
    (schedule_ft1x.py: step=[9,12] epochs, warmup_by_epoch,
    total_epochs=13; schedule_all_42e.py: step=[32,38,41],
    total_epochs=42). Returns (max_iters, lr_config) with epoch counts
    scaled by iters-per-epoch, or (None, lr_config) when the config is
    already iter-based (runner.max_iters / total_iters present or no
    epoch count given).
    """
    runner = cfg.get("runner") or {}
    epochs = cfg.get("total_epochs") or runner.get("max_epochs")
    lrc = dict(cfg.get("lr_config") or {})
    if not epochs or runner.get("max_iters") or cfg.get("total_iters"):
        return None, lrc
    ipe = max(int(n_samples) // max(int(global_batch), 1), 1)
    if lrc.get("by_epoch", True) and \
            str(lrc.get("policy", "")).lower() == "step":
        lrc["step"] = [int(s) * ipe for s in lrc.get("step", [])]
        lrc["by_epoch"] = False
    if lrc.pop("warmup_by_epoch", False):
        lrc["warmup_iters"] = int(lrc.get("warmup_iters", 1)) * ipe
    return int(epochs) * ipe, lrc


def base_scale_of(pipe, dataset) -> float:
    """The factor of ``Resize(img_scale, keep_ratio)`` that maps the
    dataset's native size onto ``img_scale`` (1 for Cityscapes at
    (2048, 1024)); the ratio range multiplies it."""
    if pipe.img_scale is None or len(dataset) == 0:
        return 1.0
    h, w = dataset[0]["img"].shape[:2]
    tw, th = pipe.img_scale  # mmcv (w, h)
    return min(max(th, tw) / max(h, w), min(th, tw) / min(h, w))


def make_train_feed(dataset, pipe, batch_size: int, num_classes: int,
                    device: torch.device, seed: int = 0, depth: int = 4):
    """The loop's batches: ``(img, gt, event)`` items (``staging.take``
    hands them to the consumer's stream), prepared ``depth`` ahead by a
    prefetch thread. The records come from a
    ``BatchLoader`` (shuffled by epoch, drop_last, infinite, in the JAX
    package's order); the thread draws each batch's augmentation
    parameters from a CPU generator seeded by ``seed`` (in batch order, so
    the draws do not depend on timing), uploads the records as uint8
    (labels too when ``num_classes <= 255``) and runs ``augment_batch`` on
    the device. A device-cached dataset is read in place
    (``gather_augment_batch``): only indices and parameters are uploaded.
    On the card the augment is captured as a CUDA graph at the first batch
    and replayed for the others (fixed shapes: the loader drops the
    tail), so the thread launches a few operations a batch, not the
    augment's ~200, while the train step launches its own.
    bf16 images on the card, float32 on the CPU."""
    cache = dataset if isinstance(dataset, DeviceCachedDataset) else None
    loader = BatchLoader(dataset, batch_size, shuffle=True, seed=seed,
                         drop_last=True, infinite=True,
                         index_only=cache is not None)
    base = base_scale_of(pipe, dataset)
    ratio_range = (pipe.ratio_range[0] * base, pipe.ratio_range[1] * base)
    feed = DeviceFeed(device)
    gen = torch.Generator().manual_seed(seed)
    norm, graph = {}, {}
    kw = dict(crop_size=tuple(pipe.crop_size),
              cat_max_ratio=pipe.cat_max_ratio, num_classes=num_classes,
              photometric=pipe.photometric, seg_pad_val=pipe.seg_pad_val,
              dtype=torch.bfloat16 if device.type == "cuda"
              else torch.float32)

    def augment(dev):
        if cache is not None:
            return gather_augment_batch(cache.imgs, cache.gts, dev["idx"],
                                        dev, norm["mean"], norm["std"], **kw)
        return augment_batch(dev["img"], dev["gt"], dev, norm["mean"],
                             norm["std"], **kw)

    def prep(batch):
        params = draw_augment_params(gen, len(batch["idx"]), ratio_range,
                                     pipe.flip_prob)
        if cache is not None:
            arrays = {"idx": np.asarray(batch["idx"], np.int64), **params}
        else:
            gt = np.asarray(batch["gt"])
            if gt.dtype != np.uint8 and num_classes <= 255:
                gt = gt.astype(np.uint8)
            arrays = {"img": np.asarray(batch["img"]), "gt": gt, **params}
        with feed.side_stream():
            if not norm:        # made once, on the stream that reads them
                norm.update(mean=torch.tensor(pipe.mean, device=device),
                            std=torch.tensor(pipe.std, device=device))
            if not feed.cuda:
                out = augment(feed.upload(arrays))
                return out["img"], out["gt"], None
            if not graph:       # the first batch: warm, then capture
                static = feed.upload(arrays)
                augment(static)
                graph.update(zip(("graph", "out"),
                                 feed.capture(lambda: augment(static))),
                             static=static)
            else:
                feed.upload(arrays, out=graph["static"])
            graph["graph"].replay()
            out = graph["out"]
            return out["img"].clone(), out["gt"].clone(), feed.done()

    return device_prefetch(iter(loader), prep, depth=depth)


def train_segmentor(model, cfg, *, device="cuda", train_dataset=None,
                    train_sampler=None, max_iters: Optional[int] = None,
                    seed: int = 0,
                    log: Optional[Callable[[str], None]] = None
                    ) -> List[Dict[str, Any]]:
    """Train ``model`` per ``cfg``; returns one record per iteration:
    arch name, losses, lr, ``data_ms`` (how long the loop waited for the
    next batch: the prefetch queue, then the batch's device work) and the
    synchronized ``step_ms``."""
    device = resolve_device(device)
    model.to(device).train()
    data_cfg = cfg.get("data") or {}
    if train_dataset is None:
        train_dataset = build_dataset(data_cfg["train"], device=device)
    if train_sampler is None and cfg.get("train_sampler"):
        train_sampler = build_model_sampler(cfg["train_sampler"])
    pipe = parse_train_pipeline((data_cfg.get("train") or {})
                                .get("pipeline"))
    batch_size = int(data_cfg.get("samples_per_gpu", 2))
    epoch_iters, lr_config = resolve_epoch_schedule(
        cfg, len(train_dataset), batch_size)
    max_iters = max_iters or epoch_iters or _max_iters(cfg)

    opt_cfg = dict(cfg.get("optimizer") or {"type": "SGD", "lr": 0.01})
    opt_cfg["lr"] = scale_lr(opt_cfg.get("lr", 0.01), batch_size,
                             cfg.get("lr_scaler"))
    schedule = build_lr_schedule(lr_config, opt_cfg["lr"], max_iters)
    optimizer = build_optimizer(model.parameters(), opt_cfg)
    max_norm = grad_clip_norm(cfg.get("optimizer_config"))
    max_arch = model_max_arch(cfg["model"])
    generator = torch.Generator(device=device)
    generator.manual_seed(seed)
    batches = make_train_feed(train_dataset, pipe, batch_size,
                              model.num_classes, device, seed,
                              int(cfg.get("device_prefetch", 4)))

    history = []
    try:
        for it in range(max_iters):
            t0 = time.perf_counter()
            img, gt, ready = next(batches)
            take((img, gt), ready)
            meta = train_sampler.sample() if train_sampler is not None \
                else {}
            arch = encode_arch(max_arch, meta)
            lr = schedule(it)
            set_learning_rate(optimizer, lr)
            t1 = time.perf_counter()
            logs = train_step(model, optimizer, img, gt, arch, generator,
                              max_norm)
            vals = {k: float(v) for k, v in logs.items()}  # syncs the step
            t2 = time.perf_counter()
            del img, gt
            rec = {"iter": it + 1, "arch": meta.get("name", "random"),
                   "lr": lr, **vals, "data_ms": (t1 - t0) * 1e3,
                   "step_ms": (t2 - t1) * 1e3}
            history.append(rec)
            if log is not None:
                log(f"iter {it + 1}/{max_iters} arch={rec['arch']} "
                    f"loss={vals['loss']:.4f} lr={lr:.3e} "
                    f"step={rec['step_ms']:.1f}ms "
                    f"data={rec['data_ms']:.1f}ms")
    finally:
        batches.close()     # stops the prefetch thread, drops staged batches
    return history
