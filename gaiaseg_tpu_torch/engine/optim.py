"""SGD + LR schedule from mmcv-style configs.

Port of ``gaiaseg_tpu/engine/optim.py`` for the flagship schedule: SGD with
momentum and weight decay, the ``lr_scaler`` rule and the poly/step/fixed
schedules, evaluated on the host and set into the optimizer every step.
AdamW and ``grad_clip`` wait for a later slice.

The JAX chain ``add_decayed_weights(wd) -> trace(momentum) ->
scale_by_learning_rate`` is torch SGD with ``weight_decay`` and
``momentum``: ``m = g + wd*p + momentum*m``, ``p -= lr*m``.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, Optional

import torch


def scale_lr(base_lr: float, global_batch: int, scaler_cfg: Optional[Dict]
             ) -> float:
    """linear => per-sample lr * global batch; power => * sqrt(batch)."""
    if not scaler_cfg:
        return base_lr
    policy = scaler_cfg.get("policy", scaler_cfg.get("type", "linear"))
    per_sample = scaler_cfg.get("base_lr", base_lr)
    if policy == "linear":
        return per_sample * global_batch
    if policy in ("power", "sqrt"):
        return per_sample * (global_batch ** 0.5)
    raise ValueError(f"unknown lr_scaler policy {policy!r}")


def build_lr_schedule(lr_config: Optional[Dict], base_lr: float,
                      max_iters: int) -> Callable[[int], float]:
    cfg = dict(lr_config or {})
    policy = cfg.get("policy", "fixed").lower()
    warmup = cfg.get("warmup")
    warmup_iters = int(cfg.get("warmup_iters", 0))
    warmup_ratio = float(cfg.get("warmup_ratio", 0.1))

    if policy == "poly":
        power = float(cfg.get("power", 0.9))
        min_lr = float(cfg.get("min_lr", 0.0))

        def main(step):
            p = min(max(1.0 - float(step) / max(max_iters, 1), 0.0), 1.0)
            return min_lr + (base_lr - min_lr) * (p ** power)
    elif policy == "step":
        steps = sorted(int(s) for s in cfg.get("step", []))
        gamma = float(cfg.get("gamma", 0.1))

        def main(step):
            return base_lr * gamma ** sum(float(step) >= s for s in steps)
    elif policy in ("fixed", "constant"):
        def main(step):
            return base_lr
    else:
        raise ValueError(f"unknown lr policy {policy!r}")

    if warmup:
        def schedule(step):
            w = step / max(warmup_iters, 1)
            warm = base_lr * (warmup_ratio + (1 - warmup_ratio) * w)
            return warm if step < warmup_iters else main(step)
        return schedule
    return main


def build_optimizer(params: Iterable[torch.nn.Parameter],
                    optimizer_cfg: Dict[str, Any],
                    optimizer_config: Optional[Dict[str, Any]] = None
                    ) -> torch.optim.Optimizer:
    cfg = dict(optimizer_cfg)
    opt_type = cfg.pop("type", "SGD").lower()
    if opt_type != "sgd" or (optimizer_config or {}).get("grad_clip"):
        raise NotImplementedError(
            f"optimizer {opt_type!r} / grad_clip wait for a later slice of "
            "the port (SGD only)")
    return torch.optim.SGD(params, lr=float(cfg.pop("lr", 0.01)),
                           momentum=float(cfg.pop("momentum", 0.0)),
                           weight_decay=float(cfg.pop("weight_decay", 0.0)),
                           nesterov=bool(cfg.pop("nesterov", False)))


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = float(lr)
