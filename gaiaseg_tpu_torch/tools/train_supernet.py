#!/usr/bin/env python
"""Supernet training CLI of the port (one GPU, or one process per GPU).

    python -m gaiaseg_tpu_torch.tools.train_supernet CONFIG --max-iters 8
    # data parallel over the 8 cards of a host (each rank takes
    # samples_per_gpu samples; the LR scales by the global batch)
    python -m torch.distributed.run --nproc_per_node 8 \
        -m gaiaseg_tpu_torch.tools.train_supernet CONFIG
    # or with the JAX package's flags, one command per process
    python -m gaiaseg_tpu_torch.tools.train_supernet CONFIG \
        --coordinator HOST:PORT --num-processes 2 --process-id 0
    # go on from the last checkpoint of a run (weights, BN statistics,
    # optimizer, iteration)
    python -m gaiaseg_tpu_torch.tools.train_supernet CONFIG \
        --work-dir WD --resume-from WD/latest.pth
    # tensor parallelism: 8 ranks as 4 data x 2 model (the parameters and
    # their optimizer state sharded over each pair of ranks)
    python -m torch.distributed.run --nproc_per_node 8 \
        -m gaiaseg_tpu_torch.tools.train_supernet CONFIG --model-parallel 2
    # a torch.profiler trace of the first 4 iterations in WORK_DIR/trace
    python -m gaiaseg_tpu_torch.tools.train_supernet CONFIG --profile 4
    # a packed file (gaiaseg_tpu_torch.tools.pack_dataset), kept on the card
    python -m gaiaseg_tpu_torch.tools.train_supernet CONFIG --cfg-options \
        data.train.type=PackedDataset data.train.path=train.gsegpack \
        data.train.device_cache=true

Loads the config (``_base_`` merging, ``--cfg-options`` dot-key overrides),
builds the segmentor and runs ``train_segmentor``, which writes its
checkpoints (``iter_{N}.pth``, ``latest.pth``) and ``history.json`` into
``--work-dir`` (default ``work_dirs/<config name>``). ``--resume-from``
restores a checkpoint's weights, BN statistics, optimizer state and
iteration; ``--load-from`` only its weights. The train data is the config's
``data.train``: a file dataset (Cityscapes, ADE20K, custom directories), a
``PackedDataset``, or ``SyntheticDataset``; ``device_cache`` stages it on
the card when it fits the budget. The config's train pipeline runs on the
card. Runs on ``cuda`` unless ``--device cpu`` is given; the device is
resolved before anything else, so a missing card fails first.

Under a process group (torchrun's environment, or ``--num-processes`` > 1
with ``--coordinator`` and ``--process-id``) each rank takes
``cuda:LOCAL_RANK`` and the ``nccl`` backend, or ``gloo`` with ``--device
cpu``; ``--dist-backend`` chooses. Rank 0 writes the checkpoints, the
history and the log lines. ``--model-parallel K`` (the config's
``model_parallel``) lays the ranks out as a ``data x model`` mesh and
shards the parameters over groups of K ranks (``parallel.mesh``); the
world size must be a multiple of K. ``--profile N`` writes a
``torch.profiler`` trace of the first N train iterations (host and, on
the card, device activity) to ``WORK_DIR/trace/rank{R}.json``.
"""
from __future__ import annotations

import argparse
import json
import os.path as osp
import sys

if __package__ in (None, ""):
    sys.path.insert(0, osp.join(osp.dirname(osp.abspath(__file__)), "..",
                                ".."))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Train a segmentation supernet "
                                            "(PyTorch/CUDA port)")
    p.add_argument("config")
    p.add_argument("--work-dir", default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--resume-from", default=None)
    p.add_argument("--load-from", default=None)
    p.add_argument("--max-iters", type=int, default=None)
    p.add_argument("--device", default="cuda")
    p.add_argument("--cfg-options", nargs="+", default=[],
                   help="key=value deep-merge overrides (dot keys; values "
                        "parsed as JSON where they parse)")
    p.add_argument("--model-parallel", type=int, default=None,
                   help="tensor-parallel size over the model mesh axis "
                        "(overrides cfg.model_parallel; default pure DP)")
    p.add_argument("--profile", type=int, default=0, metavar="N",
                   help="a torch.profiler trace of N train iterations into "
                        "WORK_DIR/trace")
    add_distributed_args(p)
    return p.parse_args(argv)


def add_distributed_args(p: argparse.ArgumentParser) -> None:
    """The JAX CLI's process flags, plus the backend."""
    p.add_argument("--coordinator", default=None, metavar="HOST:PORT")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--dist-backend", choices=("nccl", "gloo"), default=None,
                   help="default: nccl on cuda, gloo with --device cpu")


def setup_distributed(args, device):
    """Join the process group the arguments or torchrun's environment
    describe; returns this rank's device (``cuda:LOCAL_RANK`` on the
    card). One process: ``device`` as it is."""
    from gaiaseg_tpu_torch.parallel import (current_backend,
                                            initialize_distributed,
                                            local_rank, process_count,
                                            process_index)
    import torch
    backend = args.dist_backend or ("gloo" if device.type == "cpu"
                                    else "nccl")
    if not initialize_distributed(args.coordinator, args.num_processes,
                                  args.process_id, backend=backend):
        return device
    if device.type == "cuda":
        device = torch.device("cuda", local_rank())
        torch.cuda.set_device(device)
    print(f"process group: backend {current_backend()}, rank "
          f"{process_index()} of {process_count()}, device {device}",
          flush=True)
    return device


def cfg_options_to_dict(pairs):
    out = {}
    for kv in pairs:
        k, v = kv.split("=", 1)
        try:
            v = json.loads(v)
        except json.JSONDecodeError:
            pass
        out[k] = v
    return out


def main(argv=None):
    args = parse_args(argv)
    from gaiaseg_tpu_torch.parallel import shutdown_distributed
    from gaiaseg_tpu_torch.utils import resolve_device

    device = setup_distributed(args, resolve_device(args.device))
    try:
        return _train(args, device)
    finally:
        shutdown_distributed()


def _train(args, device):
    import torch

    from gaiaseg_tpu_torch.engine import configure_numerics, train_segmentor
    from gaiaseg_tpu_torch.models import build_segmentor, fill_img_size
    from gaiaseg_tpu_torch.utils import Config

    configure_numerics()
    cfg = Config.fromfile(args.config)
    if args.cfg_options:
        cfg.merge_from_dict(cfg_options_to_dict(args.cfg_options))
    if args.model_parallel:
        cfg["model_parallel"] = int(args.model_parallel)
    torch.backends.cudnn.benchmark = bool(cfg.get("cudnn_benchmark", False))
    torch.manual_seed(args.seed)
    work_dir = args.work_dir or osp.join(
        "work_dirs", osp.splitext(osp.basename(args.config))[0])
    model = build_segmentor(fill_img_size(cfg)).to(device)
    hook = _profile_hook(args.profile, osp.join(work_dir, "trace"), device) \
        if args.profile else None
    _, history = train_segmentor(
        model, cfg, work_dir=work_dir, device=device,
        max_iters=args.max_iters, seed=args.seed,
        resume_from=args.resume_from or cfg.get("resume_from"),
        load_from=args.load_from or cfg.get("load_from"), log=print,
        iter_hook=hook)
    if hook is not None:
        hook.close()        # a run shorter than N iterations
    return history


def _profile_hook(n_iters, trace_dir, device):
    """An ``iter_hook`` that profiles the first ``n_iters`` iterations the
    loop runs and writes the trace to ``trace_dir/rank{R}.json`` (at
    iteration ``n_iters``, or at ``close()``)."""
    import os
    import torch
    from gaiaseg_tpu_torch.parallel import process_index
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    state = {}

    def close():
        if "prof" not in state or state.get("done"):
            return
        state["done"] = True
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        state["prof"].stop()
        os.makedirs(trace_dir, exist_ok=True)
        path = osp.join(trace_dir, f"rank{process_index()}.json")
        state["prof"].export_chrome_trace(path)
        print(f"profiler trace of {state['iters']} iterations written to "
              f"{path}", flush=True)

    def hook(it):
        if "prof" not in state:
            state.update(start=it, iters=0)
            state["prof"] = torch.profiler.profile(activities=acts)
            state["prof"].start()
        state["iters"] = it - state["start"]
        if state["iters"] >= n_iters:
            close()
    hook.close = close
    return hook


if __name__ == "__main__":
    main()
