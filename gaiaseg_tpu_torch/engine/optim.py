"""SGD / Adam / AdamW, gradient clipping, frozen stages and the LR schedule
from mmcv-style configs.

Port of ``gaiaseg_tpu/engine/optim.py``: SGD with momentum and weight decay,
Adam or AdamW, ``grad_clip``, the ``lr_scaler`` rule and the poly/step/fixed
schedules with linear warmup, evaluated on the host and set into the
optimizer every step.

- The JAX chain ``add_decayed_weights(wd) -> trace(momentum) ->
  scale_by_learning_rate`` is torch SGD with ``weight_decay`` and
  ``momentum``: ``m = g + wd*p + momentum*m``, ``p -= lr*m``.
- ``scale_by_adam(b1, b2, eps) -> add_decayed_weights(wd) ->
  scale_by_learning_rate`` is ``torch.optim.AdamW`` with the same betas,
  eps and decay on every parameter: ``p -= lr * (m_hat / (sqrt(v_hat) +
  eps) + wd * p)``.
- ``type='Adam'`` is the JAX chain's ``scale_by_adam()`` at its defaults
  (b1 0.9, b2 0.999, eps 1e-8) with no weight decay: the config's
  ``betas``, ``eps`` and ``weight_decay`` are ignored, as in JAX.
  ``torch.optim.Adam`` with ``weight_decay=0`` computes that update.
- The backbone's ``frozen_stages`` (``freeze_labels``) are JAX's
  ``optax.masked(set_to_zero)`` after the whole chain: the frozen
  parameters keep their gradients, which count in the clip's global norm
  and are summed over the ranks, but the optimizer never holds them, so
  no decay or momentum moves them (``trainable_parameters``).
- A ``DynamicDistiller``'s teacher (``t_backbone``, ``t_neck``,
  ``t_decode_head``; JAX ``freeze_labels`` :104-108) is outside the
  optimizer too. Its parameters take no gradient at all (``requires_grad``
  off), so they enter neither the clip's norm nor the all-reduce: JAX's
  are exact zeros there (``stop_gradient``), which add nothing.
- ``clip_by_global_norm`` (first in the chain) is ``clip_grad_norm``
  below, not ``torch.nn.utils.clip_grad_norm_``: optax scales by
  ``max_norm / norm`` and only when ``norm >= max_norm``; torch scales by
  ``max_norm / (norm + 1e-6)`` whenever that is below 1. Under tensor
  parallelism the norm is the whole model's: the sharded parameters'
  squared norms summed over the model group, the replicated ones once.
- Under tensor parallelism the optimizer holds the shards
  (``parallel.mesh.shard_state`` first), so SGD's momentum and Adam's
  moments are shard-shaped, as JAX's mirror the parameter's sharding.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, List, Optional, Set

import torch

from ..parallel.distributed import model_parallel
from ..parallel.tensor_parallel import grad_sq_norm


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


def freeze_labels(model_cfg: Optional[Dict[str, Any]]) -> Set[str]:
    """Top-level backbone submodule names whose parameters take no update
    (JAX ``freeze_labels``, the reference's ``frozen_stages``): with
    ``frozen_stages >= 0`` the stem (``conv1``/``bn1`` or the deep
    ``stem``) and ``layer1`` .. ``layer{frozen_stages}``."""
    fs = int(((model_cfg or {}).get("backbone") or {})
             .get("frozen_stages", -1))
    if fs < 0:
        return set()
    return {"conv1", "bn1", "stem"} | {f"layer{i}" for i in range(1, fs + 1)}


def trainable_parameters(model: torch.nn.Module,
                         model_cfg: Optional[Dict[str, Any]]
                         ) -> List[torch.nn.Parameter]:
    """The parameters an optimizer steps: all but the frozen stages' and
    those that take no gradient (a ``DynamicDistiller``'s teacher)."""
    frozen = freeze_labels(model_cfg)
    return [p for name, p in model.named_parameters()
            if p.requires_grad and not (name.startswith("backbone.")
                                        and name.split(".")[1] in frozen)]


def build_optimizer(params: Iterable[torch.nn.Parameter],
                    optimizer_cfg: Dict[str, Any]) -> torch.optim.Optimizer:
    """SGD, Adam or AdamW; the config's ``optimizer_config.grad_clip`` is
    applied by the train step (``grad_clip_norm``, ``clip_grad_norm``)."""
    cfg = dict(optimizer_cfg)
    opt_type = cfg.pop("type", "SGD").lower()
    lr = float(cfg.pop("lr", 0.01))
    wd = float(cfg.pop("weight_decay", 0.0))
    if opt_type == "sgd":
        return torch.optim.SGD(params, lr=lr,
                               momentum=float(cfg.pop("momentum", 0.0)),
                               weight_decay=wd,
                               nesterov=bool(cfg.pop("nesterov", False)))
    if opt_type == "adamw":
        betas = cfg.pop("betas", (0.9, 0.999))
        return torch.optim.AdamW(params, lr=lr,
                                 betas=(float(betas[0]), float(betas[1])),
                                 eps=float(cfg.pop("eps", 1e-8)),
                                 weight_decay=wd)
    if opt_type == "adam":
        return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=0.0)
    raise ValueError(f"unknown optimizer {opt_type!r}")


def grad_clip_norm(optimizer_config: Optional[Dict[str, Any]]
                   ) -> Optional[float]:
    """``optimizer_config.grad_clip.max_norm``, or None without clipping."""
    clip = (optimizer_config or {}).get("grad_clip")
    return float(clip["max_norm"]) if clip else None


@torch.no_grad()
def clip_grad_norm(params: Iterable[torch.nn.Parameter],
                   max_norm: float) -> torch.Tensor:
    """optax ``clip_by_global_norm`` in place: every gradient times
    ``max_norm / norm`` when the global norm is at least ``max_norm``.
    Returns the norm before clipping (no host sync), in float32 (float64
    for float64 gradients)."""
    params = [p for p in params if p.grad is not None]
    grads = [p.grad for p in params]
    if model_parallel()[1] > 1:
        norm = grad_sq_norm(params).sqrt()
    else:
        norm = torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(g.to(torch.promote_types(
                g.dtype, torch.float32))) for g in grads]))
    scale = torch.where(norm < max_norm, torch.ones_like(norm),
                        max_norm / norm)
    torch._foreach_mul_(grads, scale)
    return norm


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = float(lr)
