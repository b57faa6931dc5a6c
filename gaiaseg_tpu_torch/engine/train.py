"""Supernet training: the train step and a short loop.

Port of ``gaiaseg_tpu/engine/train.py``: per iteration one arch from the
sandwich sampler, the LR schedule set on the host, one optimizer step (SGD
or AdamW, with the config's global-norm gradient clip) of
``forward_train``, losses logged.

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
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from ..archspace.samplers import build_model_sampler
from ..data.datasets import build_dataset
from ..models.arch_util import encode_arch, model_max_arch
from ..utils.device import resolve_device
from .optim import build_lr_schedule, build_optimizer, clip_grad_norm, \
    grad_clip_norm, scale_lr, set_learning_rate

DEFAULT_NORM = dict(mean=[123.675, 116.28, 103.53],
                    std=[58.395, 57.12, 57.375])


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


def _batches(dataset, batch_size: int, seed: int) -> Iterator[List[Dict]]:
    """Shuffled, drop-last, endless batches of samples."""
    rng = np.random.RandomState(seed)
    while True:
        order = rng.permutation(len(dataset))
        for i in range(0, len(order) - batch_size + 1, batch_size):
            yield [dataset[int(k)] for k in order[i:i + batch_size]]


def train_segmentor(model, cfg, *, device="cuda", train_dataset=None,
                    train_sampler=None, max_iters: Optional[int] = None,
                    seed: int = 0,
                    log: Optional[Callable[[str], None]] = None
                    ) -> List[Dict[str, Any]]:
    """Train ``model`` per ``cfg``; returns one record per iteration:
    arch name, losses, lr, host data ms and the synchronized step ms."""
    device = resolve_device(device)
    model.to(device).train()
    data_cfg = cfg.get("data") or {}
    if train_dataset is None:
        train_dataset = build_dataset(data_cfg["train"])
    if train_sampler is None and cfg.get("train_sampler"):
        train_sampler = build_model_sampler(cfg["train_sampler"])
    batch_size = int(data_cfg.get("samples_per_gpu", 2))
    max_iters = max_iters or _max_iters(cfg)

    opt_cfg = dict(cfg.get("optimizer") or {"type": "SGD", "lr": 0.01})
    opt_cfg["lr"] = scale_lr(opt_cfg.get("lr", 0.01), batch_size,
                             cfg.get("lr_scaler"))
    schedule = build_lr_schedule(cfg.get("lr_config"), opt_cfg["lr"],
                                 max_iters)
    optimizer = build_optimizer(model.parameters(), opt_cfg)
    max_norm = grad_clip_norm(cfg.get("optimizer_config"))
    max_arch = model_max_arch(cfg["model"])
    norm = dict(cfg.get("img_norm_cfg") or DEFAULT_NORM)
    generator = torch.Generator(device=device)
    generator.manual_seed(seed)
    batches = _batches(train_dataset, batch_size, seed)

    history = []
    for it in range(max_iters):
        t0 = time.perf_counter()
        img, gt = prepare_batch(next(batches), norm, device)
        meta = train_sampler.sample() if train_sampler is not None else {}
        arch = encode_arch(max_arch, meta)
        lr = schedule(it)
        set_learning_rate(optimizer, lr)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t1 = time.perf_counter()
        logs = train_step(model, optimizer, img, gt, arch, generator,
                          max_norm)
        vals = {k: float(v) for k, v in logs.items()}   # syncs the step
        t2 = time.perf_counter()
        rec = {"iter": it + 1, "arch": meta.get("name", "random"),
               "lr": lr, **vals, "data_ms": (t1 - t0) * 1e3,
               "step_ms": (t2 - t1) * 1e3}
        history.append(rec)
        if log is not None:
            log(f"iter {it + 1}/{max_iters} arch={rec['arch']} "
                f"loss={vals['loss']:.4f} lr={lr:.3e} "
                f"step={rec['step_ms']:.1f}ms data={rec['data_ms']:.1f}ms")
    return history
