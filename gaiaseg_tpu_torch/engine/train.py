"""Supernet training: the train step and the loop around it.

Port of ``gaiaseg_tpu/engine/train.py``: per iteration one arch from the
sandwich sampler, the LR schedule set on the host, one optimizer step (SGD,
Adam or AdamW, with the config's global-norm gradient clip; the backbone's
frozen stages outside the optimizer) of
``forward_train``. The batches come as in the JAX loop: a ``BatchLoader``
in the JAX package's order, the config's train pipeline applied on the
device (``data/transforms.py``) by a prefetch thread, and epoch-based
schedules resolved against the dataset's length. Around the step, as in
JAX: silent steps between log boundaries (BN statistics left alone, no
read-back), log windows, the two-phase val workflow, BN calibration before
checkpoints and evals, ``.pth`` checkpoints with resume, and the in-loop
cross-arch eval.

Numerics on the card follow the JAX model: bf16 compute with float32
parameters (``torch.autocast`` on CUDA), float32 on the CPU. Every
parameter gets a gradient on every step (zeros where the subnet does not
reach it), so weight decay and momentum move all of them as optax does.

Under a process group of W ranks (``parallel.distributed``) each rank
takes its contiguous part of every global batch of W·B, with the
augmentation drawn for the whole global batch; the arch comes from rank 0;
BN and the loss span the ranks and the gradients are summed before the
update, so the run computes what one process does at batch W·B (JAX's
``global_batch``), which also scales the LR and the epoch schedule. Rank 0
alone writes checkpoints, ``history.json`` and log lines.

``model_parallel`` K > 1 in the config (JAX ``engine/train.py:445-448``)
lays the W ranks out as a ``data x model`` mesh (``parallel.mesh``) and
shards the model's parameters over the model axis before the optimizer is
built (``shard_state``, JAX's ``tp_spec`` and its ``1 << 16`` gate); the
checkpoints and a teacher file load into the shards. The global batch
stays ``samples_per_gpu`` x W, sharded over the data axis only: each data
index reads ``samples_per_gpu`` x K samples and its K model ranks read the
same ones. BN, the loss and the
gradient all-reduce span the data axis; the replicated parameters'
gradients are made equal over the model axis, and the clip's norm is the
whole model's. Checkpoints are gathered to full shapes.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import json
import logging
import os
import os.path as osp
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..archspace.samplers import build_model_sampler
from ..data.datasets import build_dataset
from ..data.device_cache import DeviceCachedDataset
from ..data.loader import BatchLoader, device_prefetch
from ..data.pipeline_cfg import parse_test_pipeline, parse_train_pipeline
from ..data.staging import DeviceFeed, take
from ..data.transforms import (augment_batch, draw_augment_params,
                               gather_augment_batch, prepare_eval_batch)
from ..models.arch_util import encode_arch, model_max_arch
from ..ops.dynamic_layers import frozen_bn_stats
from ..parallel.distributed import (all_reduce_grads, barrier,
                                    broadcast_object, data_parallel,
                                    is_main_process, model_parallel,
                                    sum_over_ranks)
from ..parallel.mesh import DEFAULT_MIN_SIZE, make_mesh, shard_state
from ..parallel.tensor_parallel import sync_replicated_grads
from ..utils.device import resolve_device
from ..utils.tracing import (Recorder, profiling, read_allocator, set_step,
                             span)
from .calibrate import bn_stats, calibrate_bn, load_bn_stats
from .checkpoint import (latest_checkpoint, load_checkpoint, save_checkpoint,
                         update_latest)
from .evaluate import cross_arch_evaluate
from .numerics import autocast, configure_numerics  # noqa: F401
from .optim import build_lr_schedule, build_optimizer, clip_grad_norm, \
    grad_clip_norm, scale_lr, set_learning_rate, trainable_parameters
from .teacher import load_teacher_checkpoint


logger = logging.getLogger("gaiaseg_tpu_torch")
# the spans the log line adds up as ``upd=`` (a step) and ``feed=`` (the
# feed thread's work, a batch)
UPDATE_SPANS = ("train.zero_grad", "train.grad_sync", "train.zero_fill",
                "train.clip", "train.optimizer")
FEED_SPANS = ("feed.prep", "feed.read", "feed.params", "feed.upload",
              "feed.augment")
_LAST: Dict[str, Any] = {}     # the history of the latest train_segmentor


def last_history() -> Optional[Dict[str, List[Dict[str, Any]]]]:
    """The history of the latest ``train_segmentor`` call in this process
    (None before any), as far as it got: its rows stay readable after the
    loop has ended by an exception (from ``iter_hook``, say)."""
    return _LAST.get("history")


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
               max_norm: Optional[float] = None,
               update_stats: bool = True) -> Dict[str, torch.Tensor]:
    """One optimizer step of ``model.forward_train`` at ``arch`` (the model
    is in train mode), the gradients first clipped to the global norm
    ``max_norm`` when it is given. Returns the detached losses (and the
    gradient norm before clipping); nothing is read back to the host.
    ``update_stats=False`` is the JAX silent step: BN normalizes with the
    batch statistics as always, and no running statistic changes. Across
    ranks the losses are this rank's shares of the global means, and the
    gradients are summed over the ranks (in flat buckets) before the
    zero-fill and the clip. Every parameter of ``model`` that takes a
    gradient counts in the clip's norm, those the optimizer does not hold
    (frozen stages) too; a distiller's teacher takes none. Under tensor
    parallelism the replicated parameters take model index 0's gradients
    first, and the sums run over the data axis. Each phase is a span
    (``train.zero_grad``, ``train.forward``, ``train.backward``,
    ``train.grad_sync``, ``train.zero_fill``, ``train.clip``,
    ``train.optimizer``) inside the span ``train.step``: the host's time
    to issue it, any wait inside it included."""
    with span("train.step"):
        with span("train.zero_grad"):
            # across ranks the gradients start unset, so the reduction
            # carries only those this arch reaches (elastic depth leaves
            # whole blocks without)
            model.zero_grad(set_to_none=data_parallel()[1] > 1)
            params = [p for p in model.parameters() if p.requires_grad]
        with span("train.forward"):
            stats = contextlib.nullcontext() if update_stats \
                else frozen_bn_stats(model)
            with stats, autocast(img.device):
                total, logs = model.forward_train(img, gt, arch, generator)
            out = {"loss": total.detach(),
                   **{k: v.detach() for k, v in logs.items()}}
        with span("train.backward"):
            total.backward()
            del total, logs     # the graph's teardown, on this span
        with span("train.grad_sync"):
            sync_replicated_grads(params)
            all_reduce_grads(params)
        with span("train.zero_fill"):
            for p in params:
                if p.grad is None:   # outside the subnet: decay + moments
                    p.grad = torch.zeros_like(p)
        if max_norm is not None:
            with span("train.clip"):
                out["grad_norm"] = clip_grad_norm(params, max_norm)
        with span("train.optimizer"):
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
                    device: torch.device, seed: int = 0, depth: int = 4,
                    first_iter: int = 0):
    """The loop's batches: ``(img, gt, event)`` items (``staging.take``
    hands them to the consumer's stream), prepared ``depth`` ahead by a
    prefetch thread. The records come from a
    ``BatchLoader`` (shuffled by epoch, drop_last, infinite, in the JAX
    package's order); the thread draws each batch's augmentation
    parameters from a CPU generator seeded by ``seed`` (in batch order, so
    the draws do not depend on timing). Across W ranks ``batch_size`` is
    this rank's part: the loader runs over global batches of W·B and reads
    the rank's contiguous part, and every rank draws the parameters of the
    whole global batch and keeps its rows, so each sample is augmented as
    in one process at batch W·B. The thread uploads the records as uint8
    (labels too when ``num_classes <= 255``) and runs ``augment_batch`` on
    the device. A device-cached dataset is read in place
    (``gather_augment_batch``): only indices and parameters are uploaded.
    On the card the augment is captured as a CUDA graph at the first batch
    and replayed for the others (fixed shapes: the loader drops the
    tail), so the thread launches a few operations a batch, not the
    augment's ~200, while the train step launches its own.
    bf16 images on the card, float32 on the CPU. Each batch's work is the
    span ``feed.prep`` of the prefetch thread, with the children
    ``feed.read`` (the loader), ``feed.params`` (the draws),
    ``feed.upload`` (its wait for a staging slot included) and
    ``feed.augment`` (the graph's capture or replay, the copies out);
    the spans carry the index of the batch, counted from ``first_iter``:
    the iteration that consumes it."""
    cache = dataset if isinstance(dataset, DeviceCachedDataset) else None
    rank, world = data_parallel()
    rows = slice(rank * batch_size, (rank + 1) * batch_size)
    loader = BatchLoader(dataset, batch_size * world, shuffle=True,
                         seed=seed, drop_last=True, infinite=True,
                         index_only=cache is not None,
                         batch_part=(rank, world))
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

    source = iter(loader)

    def prep(step):
        set_step(step)
        with span("feed.prep"):
            with span("feed.read"):
                batch = next(source)
            with span("feed.params"):
                params = draw_augment_params(gen, batch_size * world,
                                             ratio_range, pipe.flip_prob)
                if world > 1:
                    params = {k: v[rows] for k, v in params.items()}
                if cache is not None:
                    arrays = {"idx": np.asarray(batch["idx"], np.int64),
                              **params}
                else:
                    gt = np.asarray(batch["gt"])
                    if gt.dtype != np.uint8 and num_classes <= 255:
                        gt = gt.astype(np.uint8)
                    arrays = {"img": np.asarray(batch["img"]), "gt": gt,
                              **params}
            with feed.side_stream():
                if not norm:    # made once, on the stream that reads them
                    norm.update(mean=torch.tensor(pipe.mean, device=device),
                                std=torch.tensor(pipe.std, device=device))
                with span("feed.upload"):
                    dev = feed.upload(arrays, out=graph.get("static"))
                with span("feed.augment"):
                    if not feed.cuda:
                        out = augment(dev)
                        return out["img"], out["gt"], None
                    if not graph:   # the first batch: warm, then capture
                        augment(dev)
                        graph.update(zip(("graph", "out"),
                                         feed.capture(lambda: augment(dev))),
                                     static=dev)
                    graph["graph"].replay()
                    out = graph["out"]
                    return out["img"].clone(), out["gt"].clone(), feed.done()

    return device_prefetch(itertools.count(first_iter), prep, depth=depth)


@dataclasses.dataclass
class TrainState:
    """What ``train_segmentor`` trained: the model (weights and BN
    statistics), its optimizer and the number of iterations done."""
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int


def _loop_intervals(cfg, silent_steps: bool):
    """(checkpoint interval, eval interval, BN-calibration batches before a
    checkpoint, before an eval): JAX ``engine/train.py:575-580, 620-621``.
    Whenever the loop takes silent steps, both calibrate 8 batches at the
    MAX anchor unless ``{checkpoint_config,evaluation}.calibrate_bn`` says
    otherwise (0 turns it off)."""
    ckpt_cfg = dict(cfg.get("checkpoint_config") or {})
    eval_cfg = dict(cfg.get("evaluation") or {})
    default = 8 if silent_steps else 0
    ck, ev = ckpt_cfg.get("calibrate_bn"), eval_cfg.get("calibrate_bn")
    return (int(ckpt_cfg.get("interval", 8000)),
            int(eval_cfg.get("interval", 8000)),
            default if ck is None else int(ck),
            default if ev is None else int(ev))


def _json_default(obj):
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    return float(obj)


def train_segmentor(model, cfg, *, work_dir: Optional[str] = None,
                    device="cuda", train_dataset=None, val_dataset=None,
                    train_sampler=None, val_sampler=None,
                    max_iters: Optional[int] = None, seed: int = 0,
                    resume_from: Optional[str] = None,
                    load_from: Optional[str] = None,
                    log: Optional[Callable[[str], None]] = None,
                    iter_hook: Optional[Callable[[int], None]] = None
                    ) -> Tuple[TrainState, Dict[str, List[Dict[str, Any]]]]:
    """Train ``model`` per ``cfg`` (JAX ``engine/train.py:431-1034``, one
    step per dispatch); returns ``(state, history)``.

    - Resume: ``resume_from``, or ``auto_resume`` with a ``latest.pth`` in
      ``work_dir``, restores weights, BN statistics, the optimizer and the
      iteration; ``load_from`` only the weights. As in JAX the data order,
      the sampler and the dropout generator restart from ``seed``.
    - Steps: a full step (BN statistics updated) when ``(it + 1) %
      log_config.interval == 0``, a silent one otherwise. The host reads the
      device once per log window: ``history["loss"]`` gets one row per
      window with the mean decode loss of its full steps, the last full
      step's component losses, ``img_per_sec`` (sync to sync), the last
      step's ``arch`` and ``lr``, the window's ``data_ms`` (the loop's
      waits for batches) and ``step_ms`` (the rest, up to the sync),
      ``spans`` (each span's self ms a step; the feed thread's a batch),
      ``counts`` (each counter's change a step, ``feed.batches`` the
      batches the feed's spans cover) and ``profiled`` (a profiler
      recorded in one of its steps). At interval 1 every step is a window
      and a synchronized full step.
    - Val workflow: with ``workflow`` ``[('train', N), ('val', M)]`` and a
      val set, every N iterations M val batches go through
      ``forward_train`` in eval mode under ``torch.no_grad()`` at archs
      drawn from a sampler of their own; ``history["val_loss"]`` gets their
      mean decode loss.
    - Every ``checkpoint_config.interval`` iterations and at the end, the
      BN statistics are calibrated at the MAX arch when the loop takes
      silent steps and ``work_dir/iter_{it}.pth`` is written, with
      ``latest.pth`` pointing at it (``work_dir=None``: no files). Every
      ``evaluation.interval`` iterations, with a val set and a
      ``val_sampler``, ``cross_arch_evaluate`` scores the val anchors in the
      test pipeline's mode (calibrated for that eval only, unless the
      checkpoint just did it) into ``history["eval"]``.

    ``history`` (keys ``loss``, ``eval``, ``val_loss``) is also written to
    ``work_dir/history.json``. ``iter_hook(it)`` is called before each
    iteration ``it`` and once after the last (the CLI's ``--profile``).
    """
    device = resolve_device(device)
    model.to(device).train()
    mesh = make_mesh(int(cfg.get("model_parallel", 1) or 1))
    shard_state(model, mesh, DEFAULT_MIN_SIZE)
    tp = model_parallel()[1]
    world = data_parallel()[1] * tp
    main = is_main_process()
    if not main:
        log = None
    data_cfg = cfg.get("data") or {}
    if train_dataset is None:
        train_dataset = build_dataset(data_cfg["train"], device=device)
    if val_dataset is None and data_cfg.get("val"):
        try:
            val_dataset = build_dataset(data_cfg["val"], device=device)
        except FileNotFoundError:
            val_dataset = None
    if val_dataset is not None and len(val_dataset) == 0:
        val_dataset = None
    if train_sampler is None and cfg.get("train_sampler"):
        train_sampler = build_model_sampler(cfg["train_sampler"])
    if val_sampler is None and cfg.get("val_sampler"):
        val_sampler = build_model_sampler(cfg["val_sampler"])
    pipe = parse_train_pipeline((data_cfg.get("train") or {})
                                .get("pipeline"))
    test_pipe = parse_test_pipeline((data_cfg.get("val") or {})
                                    .get("pipeline"))
    batch_size = int(data_cfg.get("samples_per_gpu", 2))
    global_batch = batch_size * world     # JAX: samples_per_gpu x devices
    epoch_iters, lr_config = resolve_epoch_schedule(
        cfg, len(train_dataset), global_batch)
    max_iters = max_iters or epoch_iters or _max_iters(cfg)

    opt_cfg = dict(cfg.get("optimizer") or {"type": "SGD", "lr": 0.01})
    opt_cfg["lr"] = scale_lr(opt_cfg.get("lr", 0.01), global_batch,
                             cfg.get("lr_scaler"))
    schedule = build_lr_schedule(lr_config, opt_cfg["lr"], max_iters)
    optimizer = build_optimizer(trainable_parameters(model, cfg["model"]),
                                opt_cfg)
    max_norm = grad_clip_norm(cfg.get("optimizer_config"))
    max_arch = model_max_arch(cfg["model"])
    if work_dir is not None and main:
        os.makedirs(work_dir, exist_ok=True)
    start = 0
    if resume_from is None and cfg.get("auto_resume") and work_dir:
        resume_from = latest_checkpoint(work_dir)
    if resume_from:
        start = int(load_checkpoint(resume_from, model, optimizer)["iter"])
        _say(log, f"resumed from {resume_from} at iteration {start}")
    elif load_from:
        load_checkpoint(load_from, model)
        _say(log, f"loaded weights from {load_from}")
    teacher_ckpt = cfg.get("teacher_checkpoint") \
        or (cfg.get("model") or {}).get("teacher_ckpt")
    if teacher_ckpt and hasattr(model, "t_backbone") and not resume_from:
        if osp.exists(str(teacher_ckpt)):
            load_teacher_checkpoint(str(teacher_ckpt), model)
            _say(log, f"loaded the teacher from {teacher_ckpt}")
        else:
            logger.warning("teacher_checkpoint %s not found; the teacher "
                           "keeps its init", teacher_ckpt)

    log_interval = int((cfg.get("log_config") or {}).get("interval", 50))
    ckpt_interval, eval_interval, ckpt_calib, eval_calib = _loop_intervals(
        cfg, silent_steps=log_interval > 1)
    workflow = list(cfg.get("workflow") or [("train", 1)])
    wf_train = next((int(n) for m, n in workflow if m == "train"), 1)
    wf_val = next((int(n) for m, n in workflow if m == "val"), 0)
    val_phase = None
    if wf_val and val_dataset is not None:
        val_phase = _ValPhase(model, val_dataset, batch_size * tp, test_pipe,
                              cfg.get("train_sampler"), max_arch, device,
                              wf_val)
    max_enc = encode_arch(max_arch)

    def calibrate(num_batches: int) -> None:
        """BN statistics re-estimated at the MAX arch from train records
        (in batches of the global batch's size)."""
        calibrate_bn(model, train_dataset, max_enc, num_batches=num_batches,
                     batch_size=global_batch, test_params=test_pipe,
                     device=device)

    meta_classes = list(getattr(train_dataset, "CLASSES", None) or [])

    generator = torch.Generator(device=device)
    generator.manual_seed(seed)
    history: Dict[str, List[Dict[str, Any]]] = {"loss": [], "eval": [],
                                                "val_loss": []}
    _LAST["history"] = history
    batches = make_train_feed(train_dataset, pipe, batch_size * tp,
                              model.num_classes, device, seed,
                              int(cfg.get("device_prefetch", 4)), start)
    # the feed's thread starts at the first batch, after the recorder
    read_allocator(device)
    window = _Window(time.perf_counter(), device, Recorder())
    it = start
    try:
        while it < max_iters:
            if iter_hook is not None:
                iter_hook(it)
            window.profiled |= profiling()
            set_step(it)
            t0 = time.perf_counter()
            with span("feed.wait"):     # take's device.drain inside it
                img, gt, ready = next(batches)
                take((img, gt), ready)
            with span("train.arch"):
                meta = broadcast_object(train_sampler.sample()) \
                    if train_sampler is not None else {}
                arch = encode_arch(max_arch, meta)
                lr = schedule(it)
                set_learning_rate(optimizer, lr)
            t1 = time.perf_counter()
            full = (it + 1) % log_interval == 0
            logs = train_step(model, optimizer, img, gt, arch, generator,
                              max_norm, update_stats=full)
            del img, gt
            window.step(t1 - t0, time.perf_counter() - t1,
                        logs if full else None, meta.get("name", "random"),
                        lr)
            it += 1
            if val_phase is not None and it % wf_train == 0:
                history["val_loss"].append({"iter": it,
                                            "loss": val_phase.run()})
            if it % log_interval == 0:
                row = window.close(it, log_interval * global_batch)
                history["loss"].append(row)
                sp = row["spans"]
                _say(log, f"iter {it}/{max_iters} arch={row['arch']} "
                     f"loss={row['loss']:.4f} lr={row['lr']:.3e} "
                     f"{row['img_per_sec']:.1f} img/s "
                     f"step={row['step_ms']:.1f}ms "
                     f"data={row['data_ms']:.1f}ms "
                     f"wait={sp.get('feed.wait', 0.0):.1f}ms "
                     f"drain={sp.get('device.drain', 0.0):.1f}ms "
                     f"fwd={sp.get('train.forward', 0.0):.1f}ms "
                     f"bwd={sp.get('train.backward', 0.0):.1f}ms "
                     f"upd={sum(sp.get(k, 0.0) for k in UPDATE_SPANS):.1f}ms "
                     f"feed={sum(sp.get(k, 0.0) for k in FEED_SPANS):.1f}ms")
            calibrated = False
            if work_dir is not None and (it % ckpt_interval == 0
                                         or it == max_iters):
                if ckpt_calib:
                    with span("train.calibrate_bn") as t:
                        calibrate(ckpt_calib)
                    _say(log, f"calibrated BN ({ckpt_calib} batches, MAX) "
                         f"in {t.seconds:.4f}s")
                    calibrated = ckpt_calib >= eval_calib
                path = osp.join(work_dir, f"iter_{it}.pth")
                with span("train.checkpoint") as t:
                    save_checkpoint(path, model, optimizer, meta={
                        "iter": it, "CLASSES": meta_classes,
                        "PALETTE": getattr(train_dataset, "PALETTE", None),
                        "max_arch": max_arch}, write=main)
                    if main:
                        update_latest(work_dir, path)
                if main:
                    _say(log, f"saved {path} ({osp.getsize(path) / 1e6:.1f}"
                         f" MB) in {t.seconds:.4f}s")
                barrier()
            if val_dataset is not None and val_sampler is not None and \
                    it % eval_interval == 0:
                saved = None
                if eval_calib and not calibrated:
                    saved = bn_stats(model)   # eval-only statistics
                    calibrate(eval_calib)
                try:
                    res = cross_arch_evaluate(model, val_sampler,
                                              val_dataset, max_arch,
                                              test_params=test_pipe,
                                              device=device)
                finally:
                    if saved is not None:
                        load_bn_stats(model, saved)
                history["eval"].append({"iter": it, "metrics": res})
                _say(log, f"iter {it} cross-arch eval: " + ", ".join(
                    f"{k} mIoU={v['mIoU']:.4f} ({v['seconds']:.2f}s)"
                    for k, v in res.items()))
        if iter_hook is not None:
            iter_hook(it)
    finally:
        batches.close()     # stops the prefetch thread, drops staged batches
        window.recorder.stop()
    if work_dir is not None and main:
        with open(osp.join(work_dir, "history.json"), "w") as f:
            json.dump(history, f, indent=2, default=_json_default)
    barrier()
    return TrainState(model, optimizer, it), history


def _say(log, msg: str) -> None:
    if log is not None:
        log(msg)


class _Window:
    """The loop's log window: host times, the full steps' device losses
    (read once, at its end), the last step's arch and LR, and the spans
    and counters of its steps (``recorder``)."""

    def __init__(self, t_start: float, device: torch.device,
                 recorder: Recorder):
        self.t_last = t_start
        self.device, self.recorder = device, recorder
        self.data_s = self.step_s = 0.0
        self.steps, self.profiled = 0, False
        self.losses, self.comp = [], {}

    def step(self, data_s: float, step_s: float, logs, arch: str,
             lr: float) -> None:
        self.data_s += data_s
        self.step_s += step_s
        self.steps += 1
        self.arch, self.lr = arch, lr
        if logs is not None:
            self.losses.append(logs["decode.loss_seg"])
            self.comp = {k: v for k, v in logs.items()
                         if "loss" in k and k != "loss"}

    def close(self, it: int, images: int) -> Dict[str, Any]:
        """Sync the device, then read the clock (JAX ``_sync_window_clock``);
        the row of the window that ends at iteration ``it``. Across ranks
        the losses are summed: each rank's is its share of the global
        mean. The sync and the allocator's counters, read after it, are the
        span ``train.close``; the row's ``spans`` and ``counts`` are the
        recorder's reduction of the window (``Recorder.window``), and
        ``profiled`` says whether a profiler recorded in any of its
        steps."""
        with span("train.close"):
            t_sync = time.perf_counter()
            names = list(self.comp)
            vals = sum_over_ranks(torch.stack(
                self.losses + [self.comp[k] for k in names]).float()) \
                .cpu().tolist() if self.losses else []
            read_allocator(self.device)
            t_now = time.perf_counter()
        self.step_s += t_now - t_sync
        spans, counts = self.recorder.window(it, self.steps)
        n = len(self.losses)
        row = {"iter": it,
               "loss": sum(vals[:n]) / n if n else float("nan"),
               "img_per_sec": images / max(t_now - self.t_last, 1e-9),
               **dict(zip(names, vals[n:])),
               "arch": self.arch, "lr": self.lr,
               "data_ms": self.data_s * 1e3, "step_ms": self.step_s * 1e3,
               "spans": spans, "counts": counts, "profiled": self.profiled}
        self.t_last = t_now
        self.data_s = self.step_s = 0.0
        self.steps, self.profiled = 0, False
        self.losses, self.comp = [], {}
        return row


class _ValPhase:
    """The val workflow's loss batches (JAX ``engine/train.py:626-679``):
    val records in order (infinite, the tail wrapped), normalized with the
    test pipeline, at archs drawn from a sampler built anew from the train
    sampler's config (the val draws do not consume the train sampler's).
    Across ranks each reads its part of every global batch, the arch comes
    from rank 0 and the loss is the global batch's mean."""

    def __init__(self, model, dataset, batch_size, test_pipe, sampler_cfg,
                 max_arch, device, n_batches):
        self.model, self.max_arch, self.device = model, max_arch, device
        self.n_batches = n_batches
        rank, world = data_parallel()
        self.batches = iter(BatchLoader(dataset, batch_size * world,
                                        shuffle=False, drop_last=False,
                                        infinite=True, prefetch=0,
                                        batch_part=(rank, world)))
        self.sampler = build_model_sampler(sampler_cfg) if sampler_cfg \
            else None
        self.mean = torch.tensor(test_pipe.mean, device=device)
        self.std = torch.tensor(test_pipe.std, device=device)
        self.dtype = torch.bfloat16 if device.type == "cuda" \
            else torch.float32
        # the dropout (and pairwise window) of a train-mode val phase
        self.generator = torch.Generator(device=device)
        self.generator.manual_seed(1)

    @torch.no_grad()
    def run(self) -> float:
        """The mean decode loss of the phase's batches. In eval mode, but
        for a model whose class says ``eval_mode_val = False`` (the
        distiller: JAX runs its ``forward_train`` as the step does, with
        batch statistics left unchanged and dropout)."""
        losses = []
        eval_mode = getattr(self.model, "eval_mode_val", True)
        mode = contextlib.nullcontext() if eval_mode \
            else frozen_bn_stats(self.model)
        if eval_mode:
            self.model.eval()
        try:
            with mode:
                for _ in range(self.n_batches):
                    losses.append(self._batch_loss())
        finally:
            self.model.train()
        return sum(losses) / len(losses)

    def _batch_loss(self) -> float:
        batch = next(self.batches)
        img = prepare_eval_batch(
            torch.from_numpy(np.asarray(batch["img"])).to(self.device),
            self.mean, self.std, dtype=self.dtype)
        gt = torch.from_numpy(np.asarray(batch["gt"], np.int32)) \
            .to(self.device)
        meta = broadcast_object(self.sampler.sample()) \
            if self.sampler is not None else None
        with autocast(self.device):
            _, logs = self.model.forward_train(
                img, gt, encode_arch(self.max_arch, meta), self.generator)
        return float(sum_over_ranks(logs["decode.loss_seg"].float()))
