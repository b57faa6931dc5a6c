"""The first steps of supernet training, followed plainly.

From the seed's weights, records and draws, ``follow`` runs the steps a
train cell's program runs first: each step's batch (the records in the
loader's order through the train pipeline), its arch (the config's
sandwich sampler), the loss of the decode and auxiliary heads (dropout
drawn from a generator seeded as the program's), the backward pass, the
global-norm clip, and the config's optimizer at each step's learning rate.
It returns each step's loss, each parameter's first gradient as the
optimizer takes it (after the clip), and each parameter's change over the
steps. Batch norm in these steps normalizes with the batch's statistics
and updates no running statistic (the program's steps between log
boundaries). ``full_step_stats`` works out what the first full step (the
last of the first log window) does to the running statistics, from the
parameters before it: the steps before it are followed by ``follow`` in
kind (the first of them), not one by one.
"""
from __future__ import annotations

import sys
from typing import Any, Dict, List

import numpy as np
import torch

from . import augment as aug
from . import nets
from . import schedule


BN_MOMENTUM = 0.1      # mmcv's: running = 0.9 running + 0.1 batch
RUNNING_INIT = {"running_mean": 0.0, "running_var": 1.0}


def batches(records, cfg: Dict[str, Any], batch: int, seed: int,
            n_steps: int, num_classes: int, only=None):
    """The first ``n_steps`` augmented batches: (float32 images, labels);
    with ``only``, just the batches of those steps."""
    imgs, gts = records
    pipe = cfg["pipe"]
    base = aug.base_scale(imgs.shape[1], imgs.shape[2], pipe["img_scale"])
    ratio = aug.ratio_of(base, pipe["ratio_range"])
    gen = torch.Generator().manual_seed(seed)
    order = schedule.record_order(len(imgs), batch, seed)
    out = []
    for step in range(n_steps):
        idx = next(order)
        draws = schedule.augment_draws(gen, batch, ratio, pipe["flip_prob"])
        if only is not None and step not in only:
            continue
        xs, ys = [], []
        for j, r in enumerate(idx):
            p = {k: v[j] for k, v in draws.items()}
            x, y = aug.augment(torch.from_numpy(imgs[r]),
                               torch.from_numpy(gts[r]), p,
                               tuple(pipe["crop_size"]),
                               pipe["cat_max_ratio"], num_classes,
                               pipe["mean"], pipe["std"],
                               pipe["photometric"])
            xs.append(x)
            ys.append(y)
        out.append((torch.stack(xs), torch.stack(ys)))
    return out


def _clip(grads: List[torch.Tensor], max_norm) -> None:
    if max_norm is None:
        return
    norm = torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g) for g in grads]))
    if norm >= max_norm:
        for g in grads:
            g.mul_(max_norm / norm)


class _Optimizer:
    """SGD with momentum and decoupled-in-the-gradient weight decay, or
    AdamW (decay applied to the weights), as the configs state them."""

    def __init__(self, opt_cfg: Dict[str, Any]):
        self.cfg = dict(opt_cfg)
        self.kind = self.cfg["type"].lower()
        self.state: Dict[str, Dict[str, torch.Tensor]] = {}
        self.t = 0

    @torch.no_grad()
    def step(self, params, grads, lr: float) -> None:
        self.t += 1
        wd = float(self.cfg.get("weight_decay", 0.0))
        for (name, p), g in zip(params.items(), grads):
            st = self.state.setdefault(name, {})
            if self.kind == "sgd":
                d = g + wd * p
                mom = float(self.cfg.get("momentum", 0.0))
                buf = d.clone() if "buf" not in st else st["buf"] * mom + d
                st["buf"] = buf
                p.sub_(lr * buf)
            elif self.kind == "adamw":
                b1, b2 = self.cfg.get("betas", (0.9, 0.999))
                eps = float(self.cfg.get("eps", 1e-8))
                p.mul_(1 - lr * wd)
                m = st.get("m", torch.zeros_like(p)) * b1 + (1 - b1) * g
                v = st.get("v", torch.zeros_like(p)) * b2 + (1 - b2) * g * g
                st["m"], st["v"] = m, v
                m_hat = m / (1 - b1 ** self.t)
                v_hat = v / (1 - b2 ** self.t)
                p.sub_(lr * m_hat / (v_hat.sqrt() + eps))
            else:
                raise ValueError(self.kind)


def follow(cfg: Dict[str, Any], weights: Dict[str, torch.Tensor], records,
           seed: int, n_steps: int, device: torch.device,
           numerics: nets.Numerics, half_batch: bool = False
           ) -> Dict[str, Any]:
    """``cfg``: the run's plain config values (``model``, ``optimizer``,
    ``lr_config``, ``runner``, ``lr_scaler``, ``train_sampler``, ``pipe``,
    ``batch``, ``max_norm``). Returns ``losses`` [n_steps], ``grad_norms``
    and ``change_norms`` {name: float}. ``half_batch`` plants a fault:
    each step sees the first half of its batch only (its dropout drawn for
    the whole batch, as a step that drops rows after drawing would)."""
    model_cfg = cfg["model"]
    P = nets.as_params(weights, True)
    P0 = {k: v.detach().clone() for k, v in P.items()}
    names = sorted(P)
    metas = schedule.sampler_metas(cfg["train_sampler"], n_steps)
    template = schedule.max_arch(model_cfg)
    num_classes = int(model_cfg["decode_head"]["num_classes"])
    data = batches(records, cfg, cfg["batch"], seed, n_steps, num_classes)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    opt = _Optimizer(cfg["optimizer"])
    losses, grad_norms, largest = [], {}, {}
    for it in range(n_steps):
        img, gt = (t.to(device) for t in data[it])
        if half_batch:
            img, gt = img[:len(img) // 2], gt[:len(gt) // 2]
        arch = schedule.arch_of(template, metas[it])
        with numerics.autocast(device):
            loss = nets.train_loss(numerics, P, img, gt, arch, model_cfg,
                                   gen)
        grads = torch.autograd.grad(loss, [P[n] for n in names],
                                    allow_unused=True)
        grads = [torch.zeros_like(P[n]) if g is None else g.detach()
                 for n, g in zip(names, grads)]
        _clip(grads, cfg.get("max_norm"))
        norms = {n: float(torch.linalg.vector_norm(g))
                 for n, g in zip(names, grads)}
        if it == 0:
            grad_norms = norms
        largest = {n: max(largest.get(n, 0.0), v) for n, v in norms.items()}
        opt.step({n: P[n] for n in names}, grads,
                 schedule.lr_at(cfg, it, cfg["batch"]))
        losses.append(float(loss.detach()))
        del loss, grads
    change = {n: float(torch.linalg.vector_norm(P[n].detach() - P0[n]))
              for n in names}
    return {"losses": losses, "grad_norms": grad_norms,
            "change_norms": change, "largest_grads": largest}


@torch.no_grad()
def full_step_stats(cfg: Dict[str, Any], weights: Dict[str, torch.Tensor],
                    records, seed: int, step: int, device: torch.device,
                    numerics: nets.Numerics, half_batch: bool = False
                    ) -> Dict[str, torch.Tensor]:
    """The change of every running statistic in the full step ``step``
    from ``weights``, the parameters before it: the step's batch and arch
    through the model in train mode, each batch norm's statistics (mean,
    unbiased variance) moving the running ones, untouched since their init
    (mean 0, variance 1), by ``BN_MOMENTUM``; channels and norms outside
    the arch do not move. ``{buffer name: change}`` (float32, host)."""
    model_cfg = cfg["model"]
    P = nets.as_params(weights, False)
    meta = schedule.sampler_metas(cfg["train_sampler"], step + 1)[step]
    arch = schedule.arch_of(schedule.max_arch(model_cfg), meta)
    num_classes = int(model_cfg["decode_head"]["num_classes"])
    img, gt = (t.to(device) for t in batches(
        records, cfg, cfg["batch"], seed, step + 1, num_classes,
        only={step})[0])
    if half_batch:
        img = img[:len(img) // 2]
    stats: Dict[str, Any] = {}
    with numerics.autocast(device):
        feats = nets.features(numerics, P, img, arch, model_cfg, True, stats)
        nets.head_logits(numerics, P, feats, model_cfg, True, stats, None,
                         aux=True)
    out = {}
    for name in nets.bn_names(model_cfg):
        for key, init in RUNNING_INIT.items():
            delta = torch.zeros(P[name + ".weight"].shape[0])
            if name in stats:
                got = stats[name][0 if key == "running_mean" else 1]
                delta[:len(got)] = BN_MOMENTUM * (got.float().cpu() - init)
            out[f"{name}.{key}"] = delta
    return out


def compare(prog: Dict[str, Any], ref: Dict[str, Any],
            detail: bool = False) -> Dict[str, Any]:
    """The numbers a train cell is judged by (its workload file's
    ``limits`` pick them):

    - ``loss``: the largest gap of a step's loss, as a share of the
      reference's;
    - ``grad``: the first gradient's norms by the worst leaf, the gap of
      the two norms over the larger of the reference leaf's norm and the
      median leaf's;
    - ``update``: the same of the parameters' change over the steps, over
      the leaves whose largest reference gradient over the steps is at
      least a thousandth of the median leaf's (the others move by
      round-off alone: a bias feeding a batch norm);
    - ``bn_stats``: the running statistics' change in the first full step
      by the worst buffer, the norm of the difference (channel by channel:
      the statistics are what eval reads) over the larger of the
      reference buffer's norm and the median moving buffer's;
    - ``grad_median``: the median leaf's gap of ``grad``, steady where the
      worst leaf's swings from seed to seed.

    ``detail`` adds each leaf's and buffer's gap (``leaves``)."""
    loss = max(abs(p - r) / abs(r) for p, r in zip(prog["losses"],
                                                   ref["losses"]))

    def gaps(key, names):
        med = float(np.median([ref[key][n] for n in names]))
        return {n: abs(prog[key][n] - ref[key][n]) /
                max(ref[key][n], med, 1e-30) for n in names}

    def worst(key, names):
        return max(gaps(key, names).values())

    names = sorted(ref["grad_norms"])
    largest = ref["largest_grads"]
    gmed = float(np.median([largest[n] for n in names]))
    moving = [n for n in names if largest[n] >= 1e-3 * gmed]
    if len(moving) < len(names):
        print("update leaves left out (their reference gradient is "
              "nought): " + ", ".join(n for n in names if n not in moving),
              file=sys.stderr)
    for key, keys in (("grad_norms", names), ("change_norms", moving)):
        med = float(np.median([ref[key][n] for n in keys]))
        worst3 = sorted(keys, key=lambda n: -abs(prog[key][n] - ref[key][n])
                        / max(ref[key][n], med, 1e-30))[:3]
        print(f"{key} worst leaves (program, reference; median {med:.4g}): "
              + ", ".join(f"{n} {prog[key][n]:.4g} {ref[key][n]:.4g}"
                          for n in worst3), file=sys.stderr)
    ref_d, prog_d = ref["stats_delta"], prog["stats_delta"]
    if set(prog_d) != set(ref_d):
        raise ValueError("the program's running statistics are not the "
                         "reference's: " + str(sorted(set(prog_d) ^
                                                      set(ref_d))))
    ref_n = {k: float(torch.linalg.vector_norm(v)) for k, v in ref_d.items()}
    smed = float(np.median([v for v in ref_n.values() if v > 0] or [0.0]))
    diff = {k: float(torch.linalg.vector_norm(prog_d[k] - ref_d[k]))
            / max(ref_n[k], smed, 1e-30) for k in ref_d}
    worst_bn = sorted(diff, key=lambda k: -diff[k])[:3]
    print(f"stats_delta worst buffers (gap, reference norm; median "
          f"{smed:.4g}): " + ", ".join(f"{k} {diff[k]:.4g} {ref_n[k]:.4g}"
                                       for k in worst_bn), file=sys.stderr)
    grad = gaps("grad_norms", names)
    out = {"loss": loss, "grad": max(grad.values()),
           "grad_median": float(np.median(list(grad.values()))),
           "update": worst("change_norms", moving),
           "bn_stats": max(diff.values())}
    if detail:
        out["leaves"] = {"grad": grad,
                         "update": gaps("change_norms", moving),
                         "bn_stats": diff}
    return out
