#!/usr/bin/env python
"""Where the train loop's data feed costs step time, on one card.

    python -m gaiaseg_tpu_torch.tools.probe_feed [--size H W] [--rounds 2]

Builds the flagship supernet (random weights, seed 0) and synthetic records
of ``--size`` kept on the card (as ``chip_smoke.py`` phase ``train`` does at
512x1024; 1024x2048 is the size of the ``data`` phase), and runs two
sandwich cycles (16 iterations, batch 8, the config's train pipeline) of
one loop in each mode, in turns (A B C C B A per round):

- ``fixed``: batches augmented beforehand; the loop times the step alone;
- ``inline``: the loop's own thread augments the next batch on its own
  stream right before the step (no prefetch thread, no side stream); the
  augment's device time is in ``data_ms``;
- ``feed``: the train loop's feed (``engine/train.py make_train_feed``: a
  prefetch thread, a side stream, depth 4), as ``train_segmentor`` runs it.

Each step runs at lr 0, so every mode sees the same weights. It prints the
warm cycle's (iterations 9-16) step ms, data ms and img/s per mode and
turn; then torch.profiler traces of one warm cycle in ``feed`` and in
``inline`` mode: device busy time per stream, how long the two streams
overlap, and the side stream's kernels by time; and the augment of one
batch alone, by kernel. Writes ``chiprun_out/probe_feed.json``. Needs a
CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import torch  # noqa: E402

REPO = Path(__file__).resolve().parents[2]
FLAGSHIP = REPO / "configs" / "local_examples" / "train_supernet" / \
    "pspnet_ar50to101v2_gsync.py"
ITERS = 16          # two sandwich cycles; the second is the warm one
BATCH = 8


def setup(size):
    from gaiaseg_tpu_torch.data import build_dataset, parse_train_pipeline
    from gaiaseg_tpu_torch.engine import configure_numerics
    from gaiaseg_tpu_torch.models import build_segmentor
    from gaiaseg_tpu_torch.utils import Config
    configure_numerics()
    cfg = Config.fromfile(str(FLAGSHIP))
    cfg.merge_from_dict({
        "data.train": {"type": "SyntheticDataset", "size": list(size),
                       "length": 16, "num_classes": 19, "seed": 0,
                       "cells": 8, "device_cache": True},
        "data.samples_per_gpu": BATCH})
    torch.manual_seed(0)
    model = build_segmentor(cfg["model"]).cuda().train()
    ds = build_dataset(cfg["data"]["train"], device="cuda")
    return cfg, model, ds, parse_train_pipeline(cfg["data"]["train"]
                                                ["pipeline"])


def inline_batches(ds, pipe, seed=0):
    """The feed's batches made in the calling thread, on its stream."""
    from gaiaseg_tpu_torch.data import BatchLoader
    from gaiaseg_tpu_torch.data.transforms import (draw_augment_params,
                                                   gather_augment_batch,
                                                   params_to)
    from gaiaseg_tpu_torch.engine.train import base_scale_of
    base = base_scale_of(pipe, ds)
    rr = (pipe.ratio_range[0] * base, pipe.ratio_range[1] * base)
    gen = torch.Generator().manual_seed(seed)
    mean = torch.tensor(pipe.mean, device="cuda")
    std = torch.tensor(pipe.std, device="cuda")
    loader = BatchLoader(ds, BATCH, shuffle=True, seed=seed, drop_last=True,
                         infinite=True, index_only=True, prefetch=0)
    for batch in loader:
        params = params_to(draw_augment_params(gen, BATCH, rr,
                                               pipe.flip_prob), "cuda")
        idx = torch.as_tensor(batch["idx"], device="cuda")
        out = gather_augment_batch(
            ds.imgs, ds.gts, idx, params, mean, std,
            crop_size=tuple(pipe.crop_size),
            cat_max_ratio=pipe.cat_max_ratio, num_classes=19,
            photometric=pipe.photometric, seg_pad_val=pipe.seg_pad_val)
        yield out["img"], out["gt"], None


def run(mode, cfg, model, ds, pipe):
    """One pass of ITERS iterations; per-iteration step and data ms."""
    from gaiaseg_tpu_torch.archspace import build_model_sampler
    from gaiaseg_tpu_torch.data.staging import take
    from gaiaseg_tpu_torch.engine import (build_optimizer, grad_clip_norm,
                                          train_step)
    from gaiaseg_tpu_torch.engine.train import make_train_feed
    from gaiaseg_tpu_torch.models import encode_arch, model_max_arch
    if mode == "feed":
        source = make_train_feed(ds, pipe, BATCH, 19, torch.device("cuda"))
    else:
        source = inline_batches(ds, pipe)
        if mode == "fixed":
            made = [next(source) for _ in range(ITERS)]
            source.close()
            source = iter(made)
    sampler = build_model_sampler(cfg["train_sampler"])
    max_arch = model_max_arch(cfg["model"])
    opt = build_optimizer(model.parameters(), dict(cfg["optimizer"], lr=0.0))
    max_norm = grad_clip_norm(cfg.get("optimizer_config"))
    out = []
    try:
        for _ in range(ITERS):
            torch.cuda.current_stream().synchronize()
            t0 = time.perf_counter()
            img, gt, ready = next(source)
            take((img, gt), ready)
            torch.cuda.current_stream().synchronize()
            t1 = time.perf_counter()
            arch = encode_arch(max_arch, sampler.sample())
            float(train_step(model, opt, img, gt, arch,
                             max_norm=max_norm)["loss"])
            t2 = time.perf_counter()
            out.append({"data_ms": (t1 - t0) * 1e3,
                        "step_ms": (t2 - t1) * 1e3})
    finally:
        if hasattr(source, "close"):
            source.close()
    return out


def summary(recs):
    warm = recs[ITERS // 2:]
    step = sum(r["step_ms"] for r in warm)
    data = sum(r["data_ms"] for r in warm)
    return {"step_ms": [round(r["step_ms"], 2) for r in warm],
            "data_ms": [round(r["data_ms"], 2) for r in warm],
            "device_img_per_s": BATCH * len(warm) / (step / 1e3),
            "wall_img_per_s": BATCH * len(warm) / ((step + data) / 1e3)}


def streams(trace_path):
    """Device busy time per stream, their overlap and kernels by time on
    each stream, from a chrome trace."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    spans = {}
    names = {}
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in ("kernel", "gpu_memcpy",
                                                      "gpu_memset"):
            continue
        s = e.get("args", {}).get("stream")
        a, d = float(e["ts"]), float(e["dur"])
        spans.setdefault(s, []).append((a, a + d))
        k = (s, e["name"][:80])
        ms, n = names.get(k, (0.0, 0))
        names[k] = (ms + d / 1e3, n + 1)

    def union(iv):
        tot, last = 0.0, None
        for a, b in sorted(iv):
            if last is None or a > last:
                tot, last = tot + (b - a), b
            elif b > last:
                tot, last = tot + (b - last), b
        return tot / 1e3

    busy = {str(s): union(iv) for s, iv in spans.items()}
    total = union([iv for v in spans.values() for iv in v])
    top = sorted(((ms, n, s, name) for (s, name), (ms, n) in names.items()),
                 reverse=True)
    return {"busy_ms_by_stream": busy, "busy_ms_union": total,
            "overlap_ms": sum(busy.values()) - total,
            "launches": sum(n for _, n in names.values()),
            "top": [(round(ms, 3), n, str(s), name) for ms, n, s, name
                    in top[:25]]}


def profiled(fn, tmp, tag):
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    path = os.path.join(tmp, f"{tag}.json")
    prof.export_chrome_trace(path)
    res = streams(path)
    res["wall_ms"] = wall
    return res


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--size", type=int, nargs=2, default=(512, 1024))
    p.add_argument("--rounds", type=int, default=2)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("probe_feed needs a CUDA card")
    from gaiaseg_tpu_torch.data.transforms import (draw_augment_params,
                                                   gather_augment_batch,
                                                   params_to)
    cfg, model, ds, pipe = setup(tuple(args.size))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"[probe_feed] {smi}; records "
          f"{args.size[0]}x{args.size[1]} on the card, crop "
          f"{tuple(pipe.crop_size)}, batch {BATCH}, {ITERS} iterations a run")
    result = {"size": list(args.size), "nvidia_smi": smi, "turns": []}
    run("fixed", cfg, model, ds, pipe)             # cuDNN and kernels warm
    for r in range(args.rounds):
        for mode in ("fixed", "inline", "feed", "feed", "inline", "fixed"):
            s = summary(run(mode, cfg, model, ds, pipe))
            result["turns"].append(dict(s, mode=mode, round=r))
            print(f"[probe_feed] round {r} {mode:6s}: device "
                  f"{s['device_img_per_s']:.2f} img/s, wall "
                  f"{s['wall_img_per_s']:.2f}; step ms {s['step_ms']}; "
                  f"data ms {s['data_ms']}")
    with tempfile.TemporaryDirectory() as tmp:
        for mode in ("feed", "inline"):
            res = profiled(lambda: run(mode, cfg, model, ds, pipe), tmp,
                           mode)
            result[f"profile_{mode}"] = res
            print(f"[probe_feed] profile {mode} (16 iterations): wall "
                  f"{res['wall_ms']:.1f} ms; device busy by stream "
                  f"{ {k: round(v, 1) for k, v in res['busy_ms_by_stream'].items()} }"
                  f"; union {res['busy_ms_union']:.1f}; streams overlap "
                  f"{res['overlap_ms']:.1f} ms")
        idx = torch.arange(BATCH, device="cuda")
        params = params_to(draw_augment_params(
            torch.Generator().manual_seed(0), BATCH, (0.5, 2.0), 0.5),
            "cuda")
        mean = torch.tensor(pipe.mean, device="cuda")
        std = torch.tensor(pipe.std, device="cuda")

        def augment():
            gather_augment_batch(ds.imgs, ds.gts, idx, params, mean, std,
                                 crop_size=tuple(pipe.crop_size),
                                 cat_max_ratio=pipe.cat_max_ratio,
                                 num_classes=19)
        augment()
        res = profiled(augment, tmp, "augment")
        result["profile_augment"] = res
        print(f"[probe_feed] one augment: device busy "
              f"{res['busy_ms_union']:.3f} ms over {res['launches']} kernels "
              "and copies; the largest:")
        for ms, n, _, name in res["top"][:12]:
            print(f"[probe_feed]   {ms:8.3f} ms x{n:<3d} {name}")
    os.makedirs(REPO / "chiprun_out", exist_ok=True)
    with open(REPO / "chiprun_out" / "probe_feed.json", "w") as f:
        json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main()
