"""Train cells: supernet training as the train CLI runs it.

Set-up is the CLI's (``configure_numerics``, ``cudnn.benchmark`` from the
config, ``build_segmentor(fill_img_size(cfg))``), then the seed's weights
on the card and the seed's records (``lib/records.py``), cached on the card
when the traffic says ``device_cache``. With ``cudnn.benchmark`` on, one
forward and backward pass at every pair of neighbouring widths the sampler
can draw autotunes each conv shape the window can meet.

One ``gaiaseg_tpu_torch.engine.train_segmentor`` call then runs at the
config's log interval, with archs from the config's ``train_sampler``, and
``iter_hook`` marks the phases:

1. steps ``0 .. check_steps - 1``: the parameters before them, the first
   gradient (read from the optimizer's state after its first step) and
   each step's loss are recorded for the comparison with the plain
   reference (``reference/train.py``);
2. up to ``warm_steps``: warm-up, through the first log window, whose last
   step is the first full one (BN's running statistics updated): the
   parameters before it and the running statistics' change in it are
   recorded;
3. the timed window: whole sandwich cycles until ``--seconds`` have passed,
   opened and closed by a device sync;
4. with ``--trace 1``, ``profile_cycles`` more cycles under
   ``torch.profiler`` recording the device alone (the busy time, the
   device operations), then one cycle recording the host too (what it did
   in the idle gaps).

The loop is then stopped from ``iter_hook``. After the window the
program's state is freed and the reference follows the first steps in
float32 from the same weights, records and draws, and works out the full
step's statistics from the parameters the program held before it.
"""
from __future__ import annotations

import gc
import re
import sys
import time
from typing import Any, Dict, List, Optional

import torch
from torch.optim.optimizer import register_optimizer_step_post_hook

from ..lib import macs as mac_count
from ..lib.device import device_info
from ..lib.records import Records, make_records
from ..lib.result import Check, Run
from ..lib.trace import Span
from ..lib.weights import load_seeded_weights, seeded_weights
from ..reference import nets
from ..reference import train as ref_train
from .common import Marks, draw_dtype, program_config, sync, warm_archs

LOG_ROW = re.compile(r"^iter (\d+)/\d+ .* data=([0-9.]+)ms")


class _Stop(Exception):
    """Raised from ``iter_hook`` to end the loop after the window."""


class _Recorder:
    """The config's sampler, recording what it hands the loop."""

    def __init__(self, sampler):
        self.sampler, self.metas = sampler, []

    def sample(self):
        meta = self.sampler.sample()
        self.metas.append(meta)
        return meta


def run(config: Dict[str, Any], traffic: Dict[str, Any],
        workload: Dict[str, Any], seed: int, seconds: float, trace: bool,
        t_start: float, device: Optional[torch.device] = None) -> Run:
    """One run of a train cell on ``device`` (the card by default; the
    tests drive a tiny config on the CPU, never traced). ``workload``: the
    cell's own file (``limits``, ``rate_metric``)."""
    from gaiaseg_tpu_torch.archspace.samplers import build_model_sampler
    from gaiaseg_tpu_torch.data.device_cache import DeviceCachedDataset
    from gaiaseg_tpu_torch.engine import configure_numerics, train_segmentor
    from gaiaseg_tpu_torch.models import build_segmentor, fill_img_size

    device = device or torch.device("cuda", 0)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    cfg = program_config(config)
    configure_numerics()
    torch.backends.cudnn.benchmark = bool(cfg.get("cudnn_benchmark", False))
    torch.manual_seed(seed)
    marks = Marks(t_start)
    model = build_segmentor(fill_img_size(cfg)).to(device)
    marks("model built")
    load_seeded_weights(model, seed, config.get("norm_scales"))
    model_cfg = cfg.to_dict()["model"]
    classes = int(model_cfg["decode_head"]["num_classes"])
    imgs, gts = make_records(int(traffic["records"]),
                             tuple(traffic["record_hw"]), classes, seed,
                             device, zero_label=traffic.get("zero_label",
                                                            False))
    dataset = Records(imgs, gts, classes)
    if traffic.get("device_cache", True):
        dataset = DeviceCachedDataset(dataset, device)
    marks("weights and records")
    batch = int(cfg["data"]["samples_per_gpu"])
    crop = tuple(traffic["crop"])
    if torch.backends.cudnn.benchmark:
        _autotune(model, model_cfg, cfg, batch, crop, classes, device)
        marks("convs autotuned")

    sampler = _Recorder(build_model_sampler(cfg["train_sampler"]))
    cycle = int(traffic["cycle"])
    n_check = int(traffic["check_steps"])
    warm = int(traffic["warm_steps"])
    log_interval = int((cfg.get("log_config") or {}).get("interval", 50))
    full = log_interval - 1      # the first step that updates BN statistics
    if warm <= full:
        raise ValueError(f"warm_steps {warm} must pass the first full step "
                         f"{full}")
    params = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    st: Dict[str, Any] = {"losses": [], "rows": []}
    forward_train = model.forward_train

    def recording_forward(img, gt, arch, generator=None, compute_acc=False):
        total, logs = forward_train(img, gt, arch, generator, compute_acc)
        if "span" in st:
            st["valid"].append(((gt != 255).sum(), tuple(gt.shape)))
        else:
            st["losses"].append(total.detach().float())
        return total, logs

    def first_step(optimizer, args, kwargs):
        st["hook"].remove()
        st["grad_norms"] = _first_grad_norms(optimizer, params, st["p0"])

    def hook(it: int) -> None:
        now = time.perf_counter
        if it == 0:
            st["p0"] = {n: p.detach().clone() for n, p in params}
            model.forward_train = recording_forward
            st["hook"] = register_optimizer_step_post_hook(first_step)
        elif it == n_check:
            st["change_norms"] = torch.stack([
                torch.linalg.vector_norm(p.detach() - st["p0"][n])
                for n, p in params]).cpu().tolist()
            del st["p0"]
            del model.forward_train
        elif it == full:
            st["full_params"] = {n: p.detach().to("cpu", copy=True)
                                 for n, p in model.named_parameters()}
            st["stats0"] = _running_stats(model)
        elif it == full + 1:
            st["stats_delta"] = {k: v - st["stats0"][k] for k, v in
                                 _running_stats(model).items()}
        if it == warm:
            sync(device)
            st["it0"], st["t0"] = it, now()
            st["setup_s"] = st["t0"] - t_start
            marks(f"{it} steps")
        elif it > warm and "t1" not in st and (it - warm) % cycle == 0 \
                and now() - st["t0"] >= seconds:
            sync(device)
            st["it1"], st["t1"] = it, now()
            if not trace:
                raise _Stop
            st["span"], st["span_it0"] = Span(device, host=False), it
            st["valid"], st["logits"] = [], []
            st["handles"] = [h.register_forward_hook(
                lambda m, i, out: st["logits"].append(tuple(out.shape)))
                for h in _heads(model)]
            model.forward_train = recording_forward
        elif "span" in st and it == st["span_it0"] + \
                cycle * int(traffic["profile_cycles"]):
            st["span_out"] = st["span"].close()
            st["span_steps"] = it - st["span_it0"]
            for h in st.pop("handles"):
                h.remove()
            del model.forward_train
            st["host_span"], st["host_it0"] = Span(device), it
        elif "host_span" in st and it == st["host_it0"] + cycle:
            st["host_out"] = st["host_span"].close()
            raise _Stop

    try:
        train_segmentor(model, cfg, work_dir=None, device=device,
                        train_dataset=dataset, train_sampler=sampler,
                        seed=seed, log=st["rows"].append, iter_hook=hook)
        raise RuntimeError("the loop ended before the window closed")
    except _Stop:
        pass
    for h in st.get("handles", []):
        h.remove()
    if "forward_train" in vars(model):
        del model.forward_train
    info = device_info(1, device)
    window_s = st["t1"] - st["t0"]
    steps = st["it1"] - st["it0"]
    window_metas = sampler.metas[st["it0"]:st["it1"]]
    e2e = {workload["rate_metric"]: steps * batch / window_s,
           "setup_s": st["setup_s"]}
    rows = [(int(m.group(1)), float(m.group(2))) for m in
            map(LOG_ROW.match, st["rows"]) if m]
    in_window = [d for i, d in rows if st["it0"] < i <= st["it1"]]
    losses_logged = [r for r in st["rows"] if "loss=nan" in r
                     or "loss=inf" in r]
    readings: Dict[str, Any] = {"kind": "train"}
    if in_window:
        readings["data_ms_per_step"] = sum(in_window) / (
            len(in_window) * log_interval)
    readings["window_s"] = window_s
    readings["window_flops"] = sum(
        6 * batch * mac_count.model_macs(model_cfg, _arch(model_cfg, m),
                                         crop, train=True)
        for m in window_metas)
    breakdown = None
    if trace:
        span = st["span_out"]
        readings.update(span=span, span_images=st["span_steps"] * batch,
                        ce_launches=_ce_launches(st))
        info.update(busy_s=span["busy_s"], window_s=span["wall_s"])
        breakdown = {"device_ops": span["top"],
                     "idle_gaps": st["host_out"]["idle_gaps"]}
        print("idle share of the cycle with host events recorded: "
              f"{1 - st['host_out']['busy_s'] / st['host_out']['wall_s']:.4f}"
              f" (device alone: {1 - span['busy_s'] / span['wall_s']:.4f})",
              file=sys.stderr)
    prog = {"losses": [float(v) for v in st["losses"][:n_check]],
            "grad_norms": dict(zip([n for n, _ in params],
                                   st["grad_norms"])),
            "change_norms": dict(zip([n for n, _ in params],
                                     st["change_norms"])),
            "stats_delta": st["stats_delta"]}
    full_params = st["full_params"]
    del model, dataset, st, params
    gc.collect()
    torch.cuda.empty_cache()
    checks, readings["gaps"] = _check(
        cfg, model_cfg, traffic, workload, (imgs, gts), seed, prog,
        full_params, full, device, config.get("norm_scales"))
    return Run(e2e=e2e, readings=readings, checks=checks,
               attempted=steps, failed=len(losses_logged), device=info,
               breakdown=breakdown)


def _heads(model) -> List[torch.nn.Module]:
    heads = [model.decode_head]
    aux = model.auxiliary_head
    if aux is not None:
        heads += list(aux) if isinstance(aux, torch.nn.ModuleList) else [aux]
    return heads


def _ce_launches(st) -> List[Dict[str, Any]]:
    """Each head's loss in the profiled span: its logits' and labels'
    shapes and the labels' valid pixels (one K1 and one K2 launch each)."""
    per_step = len(st["logits"]) // max(len(st["valid"]), 1)
    out = []
    for k, (n_valid, label) in enumerate(st["valid"]):
        for logit in st["logits"][k * per_step:(k + 1) * per_step]:
            out.append({"logit": list(logit), "label": list(label),
                        "n_valid": int(n_valid)})
    return out


def _running_stats(model) -> Dict[str, torch.Tensor]:
    """Every running mean and variance, copied to the host."""
    return {n: b.detach().to("cpu", torch.float32, copy=True)
            for n, b in model.named_buffers()
            if n.endswith(("running_mean", "running_var"))}


def _first_grad_norms(optimizer, params, p0) -> List[float]:
    """Each parameter's first gradient as the optimizer took it (after the
    clip), from its state after one step: SGD's momentum buffer is then
    ``g + wd * p``, AdamW's first moment ``(1 - b1) * g``. A parameter
    with no state reads NaN, which no limit passes."""
    group = optimizer.param_groups[0]
    norms = []
    for name, p in params:
        state = optimizer.state.get(p, {})
        if state.get("momentum_buffer") is not None:
            g = state["momentum_buffer"] - group["weight_decay"] * p0[name]
        elif "exp_avg" in state:
            g = state["exp_avg"] / (1 - group["betas"][0])
        else:
            g = torch.full((1,), float("nan"), device=p.device)
        norms.append(torch.linalg.vector_norm(g))
    return torch.stack(norms).cpu().tolist()


def _arch(model_cfg, meta):
    from ..reference import schedule
    return schedule.arch_of(schedule.max_arch(model_cfg), meta)


def _autotune(model, model_cfg, cfg, batch, crop, classes, device) -> None:
    """One forward and backward pass (BN statistics left alone, no
    optimizer step) at each arch of ``warm_archs``: cuDNN autotunes every
    conv shape the sampler's widths give."""
    from gaiaseg_tpu_torch.engine.numerics import autocast
    from gaiaseg_tpu_torch.models import encode_arch, model_max_arch
    from gaiaseg_tpu_torch.ops.dynamic_layers import frozen_bn_stats
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    img = torch.randn((batch, 3) + crop, generator=gen, device=device,
                      dtype=draw_dtype(device))
    gt = torch.randint(0, classes, (batch,) + crop, generator=gen,
                       device=device, dtype=torch.int32)
    max_arch = model_max_arch(model_cfg)
    for meta in warm_archs(cfg["train_sampler"]):
        with frozen_bn_stats(model), autocast(device):
            total, _ = model.forward_train(img, gt, encode_arch(max_arch,
                                                                meta), gen)
        total.backward()
        model.zero_grad(set_to_none=True)
    sync(device)


def _plain_numerics():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = False


def reference_run(cfg, model_cfg, traffic, records, seed, device,
                  precision: str = "float32", half_batch: bool = False,
                  scales=None, fault=None):
    """The reference's first steps (TF32 off) from the seed's weights."""
    _plain_numerics()
    plain = reference_config(cfg, model_cfg, traffic)
    weights = seeded_weights(nets.param_specs(model_cfg), seed, device,
                             scales)
    return ref_train.follow(plain, weights, records, seed,
                            int(traffic["check_steps"]), device,
                            nets.Numerics(precision, draw_dtype(device),
                                          fault), half_batch)


def reference_stats(cfg, model_cfg, traffic, records, seed, weights, step,
                    device, precision: str = "float32",
                    half_batch: bool = False):
    """The running statistics' change in the full step ``step``, worked
    out from ``weights``, the parameters before it (TF32 off)."""
    _plain_numerics()
    plain = reference_config(cfg, model_cfg, traffic)
    return ref_train.full_step_stats(
        plain, {k: v.to(device) for k, v in weights.items()}, records, seed,
        step, device, nets.Numerics(precision, draw_dtype(device)),
        half_batch)


def _check(cfg, model_cfg, traffic, workload, records, seed, prog,
           full_params, full, device, scales):
    """The reference's first steps and full step in float32, compared."""
    ref = reference_run(cfg, model_cfg, traffic, records, seed, device,
                        scales=scales)
    ref["stats_delta"] = reference_stats(cfg, model_cfg, traffic, records,
                                         seed, full_params, full, device)
    gaps = ref_train.compare(prog, ref)
    print(f"losses: program {prog['losses']} reference {ref['losses']}",
          file=sys.stderr)
    limits = workload["limits"]
    return [Check(k, gaps[k], float(limits[k])) for k in limits], gaps


def reference_config(cfg, model_cfg, traffic) -> Dict[str, Any]:
    """The plain values the reference reads from the run's config."""
    d = cfg.to_dict()
    pipe = {"img_scale": None, "ratio_range": (1.0, 1.0), "crop_size":
            tuple(traffic["crop"]), "cat_max_ratio": 1.0, "flip_prob": 0.0,
            "photometric": False, "mean": (123.675, 116.28, 103.53),
            "std": (58.395, 57.12, 57.375)}
    for op in d["data"]["train"]["pipeline"]:
        t = op["type"]
        if t == "Resize":
            pipe["img_scale"] = op.get("img_scale")
            pipe["ratio_range"] = tuple(op.get("ratio_range", (1.0, 1.0)))
        elif t == "RandomCrop":
            pipe["cat_max_ratio"] = float(op.get("cat_max_ratio", 1.0))
        elif t == "RandomFlip":
            pipe["flip_prob"] = float(op.get("prob", 0.5))
        elif t == "PhotoMetricDistortion":
            pipe["photometric"] = True
        elif t == "Normalize":
            pipe["mean"], pipe["std"] = tuple(op["mean"]), tuple(op["std"])
    clip = (d.get("optimizer_config") or {}).get("grad_clip")
    return {"model": model_cfg, "optimizer": d["optimizer"],
            "lr_config": d["lr_config"], "runner": d["runner"],
            "lr_scaler": d.get("lr_scaler"),
            "train_sampler": d["train_sampler"], "pipe": pipe,
            "batch": int(d["data"]["samples_per_gpu"]),
            "max_norm": float(clip["max_norm"]) if clip else None}

