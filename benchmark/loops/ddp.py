"""Data-parallel train cells: supernet training across ranks, one process
a card, as ``torchrun`` starts it.

The run's process starts ``traffic["ranks"]`` rank processes with
torchrun's environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR``, ``MASTER_PORT``); each joins the process group through
the port's own ``initialize_distributed`` (``nccl``, rank r on card r) and
runs ``train_segmentor`` at ``traffic["samples_per_gpu"]`` a rank, set up
as ``loops/train.py`` sets up its one process: the seed's weights and
records on every rank, cuDNN's autotune, the config's sandwich, the same
phases marked from ``iter_hook``. The ranks' batch adds up to the
configuration's ``samples_per_gpu``, the global batch the plain reference
follows; the port draws augmentation, dropout and the arch for the global
batch, so the ranks together compute what one process does at it.

- Checked steps: every rank records its share of each step's loss, and
  the shares are summed over the ranks; rank 0 records the first gradient
  (summed over the ranks, from its optimizer's state), the change over the
  checked steps, the parameters before the first full step and the
  running statistics' change in it.
- The window: rank 0 opens and closes it by a device sync; at each cycle's
  end its clock decides, for every rank, whether the window closes. The
  rate is the global batch's images over rank 0's seconds.
- With ``--trace 1``, rank 0 profiles ``profile_cycles`` cycles (device
  alone) and one more with the host; from the first it also reads the
  device ms a step in which an NCCL kernel runs and no other kernel does
  (``allreduce_exposed_ms``).

Rank 0 writes what it recorded to a file; once every rank has exited, the
run's process compares it with the plain reference at the global batch
(``loops/train.py``'s ``_check``). Every rank, once its window has closed,
exits with ``FORBIDDEN_EXIT`` where ``jax``, ``jaxlib``, ``flax`` or the
JAX package is loaded in it, as ``run.py`` checks its own process. A rank
that fails ends the others and the run, the rendezvous and every
collective time out after ``RANK_TIMEOUT_S``, and a rank whose parent
process is gone ends itself.

``device`` (the tests: the CPU; or gloo ranks sharing one card) puts
every rank on that device under ``gloo``.
"""
from __future__ import annotations

import json
import os
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
from typing import Any, Dict, List, Optional

import torch
from torch.optim.optimizer import register_optimizer_step_post_hook

from ..lib import macs as mac_count
from ..lib.device import device_info
from ..lib.records import Records, make_records
from ..lib.result import Run, forbidden_modules
from ..lib.spec import ROOT
from ..lib.trace import Span
from ..lib.weights import load_seeded_weights
from .common import Marks, program_config, sync
from .train import (LOG_ROW, _arch, _autotune, _ce_launches, _check,
                    _first_grad_norms, _heads, _Recorder, _running_stats,
                    _Stop)

RANK_TIMEOUT_S = 300.0     # the rendezvous and every collective
RANKS_DEADLINE_S = 1800.0  # the ranks' whole run
NCCL = "nccl"
FORBIDDEN_EXIT = 4         # a rank that loaded JAX or the JAX package


def run(config: Dict[str, Any], traffic: Dict[str, Any],
        workload: Dict[str, Any], seed: int, seconds: float, trace: bool,
        t_start: float, device: Optional[torch.device] = None,
        entry: Optional[str] = None) -> Run:
    """One run of a data-parallel train cell. ``entry``: a Python file the
    ranks run in place of this module (it calls ``rank_main``), for the
    tests' planted faults."""
    cfg = program_config(config)
    ranks, per_rank = int(traffic["ranks"]), int(traffic["samples_per_gpu"])
    if ranks * per_rank != int(cfg["data"]["samples_per_gpu"]):
        raise ValueError(f"{ranks} ranks x {per_rank} samples is not the "
                         f"configuration's global batch "
                         f"{cfg['data']['samples_per_gpu']}")
    with tempfile.TemporaryDirectory(prefix="ddp_") as tmp:
        job = {"config": config, "traffic": traffic, "workload": workload,
               "seed": int(seed), "seconds": float(seconds),
               "trace": bool(trace), "t_start": float(t_start),
               "device": None if device is None else str(device),
               "parent": os.getpid(), "out": os.path.join(tmp, "rank0.pt")}
        job_path = os.path.join(tmp, "job.json")
        with open(job_path, "w") as f:
            json.dump(job, f)
        _run_ranks(ranks, job_path, entry)
        # written by rank 0 of this run, in this run's own directory
        out = torch.load(job["out"], map_location="cpu", weights_only=False)
    device = device or torch.device("cuda", 0)
    model_cfg = cfg.to_dict()["model"]
    classes = int(model_cfg["decode_head"]["num_classes"])
    records = make_records(int(traffic["records"]),
                           tuple(traffic["record_hw"]), classes, seed,
                           device, zero_label=traffic.get("zero_label",
                                                          False))
    checks, out["readings"]["gaps"] = _check(
        cfg, model_cfg, traffic, workload, records, seed, out["prog"],
        out["full_params"], out["full"], device, config.get("norm_scales"))
    return Run(e2e=out["e2e"], readings=out["readings"], checks=checks,
               attempted=out["attempted"], failed=out["failed"],
               device=out["device"], breakdown=out["breakdown"])


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return int(s.getsockname()[1])


def _run_ranks(ranks: int, job_path: str, entry: Optional[str]) -> None:
    """Start the ranks, wait for all of them, and end the others as soon as
    one fails, the deadline passes, or this process is told to stop."""
    cmd = [sys.executable] + ([entry] if entry else
                              ["-m", "benchmark.loops.ddp"]) + [job_path]
    base = dict(os.environ, MASTER_ADDR="localhost",
                MASTER_PORT=str(_free_port()), WORLD_SIZE=str(ranks),
                PYTHONPATH=os.pathsep.join(
                    [ROOT] + [p for p in [os.environ.get("PYTHONPATH")]
                              if p]))
    procs: List[subprocess.Popen] = []
    stop = {}

    def on_term(signum, frame):
        stop["signal"] = signum
    old = signal.signal(signal.SIGTERM, on_term) \
        if threading.current_thread() is threading.main_thread() else None
    try:
        for r in range(ranks):
            procs.append(subprocess.Popen(
                cmd, cwd=ROOT, stdout=sys.stderr.fileno(),
                env=dict(base, RANK=str(r), LOCAL_RANK=str(r))))
        deadline = time.monotonic() + RANKS_DEADLINE_S
        while True:
            codes = [p.poll() for p in procs]
            bad = [(r, c) for r, c in enumerate(codes) if c not in (None, 0)]
            if bad:
                raise RuntimeError(f"rank {bad[0][0]} exited with code "
                                   f"{bad[0][1]}")
            if all(c == 0 for c in codes):
                return
            if stop:
                raise SystemExit(128 + stop["signal"])
            if time.monotonic() > deadline:
                raise RuntimeError(f"the ranks ran past {RANKS_DEADLINE_S} "
                                   "s")
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.terminate()
        for p in procs:
            try:
                p.wait(timeout=15)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        if old is not None:
            signal.signal(signal.SIGTERM, old)


def _watch_parent(pid: int) -> None:
    """End this rank when the process that started it is gone."""
    def watch():
        while os.getppid() == pid:
            time.sleep(1.0)
        os._exit(3)
    threading.Thread(target=watch, daemon=True).start()


def rank_main(job_path: str) -> None:
    """One rank: join the group, train, (rank 0) write the record, and
    exit with ``FORBIDDEN_EXIT`` where a forbidden module was loaded."""
    from gaiaseg_tpu_torch.parallel import (barrier, initialize_distributed,
                                            local_rank, process_index,
                                            shutdown_distributed)
    with open(job_path) as f:
        job = json.load(f)
    _watch_parent(int(job["parent"]))
    on_device = job["device"] is not None
    initialize_distributed(backend="gloo" if on_device else NCCL,
                           timeout_s=RANK_TIMEOUT_S)
    try:
        device = torch.device(job["device"]) if on_device else \
            torch.device("cuda", local_rank())
        out = _train_rank(job, device)
        if process_index() == 0:
            torch.save(out, job["out"])
        barrier()
    finally:
        shutdown_distributed()
    found = forbidden_modules(sys.modules)
    if found:
        print(f"rank {os.environ['RANK']} loaded " + ", ".join(found)
              + ": the benchmark measures the PyTorch port alone",
              file=sys.stderr)
        sys.exit(FORBIDDEN_EXIT)


def _train_rank(job: Dict[str, Any], device: torch.device) -> Dict[str, Any]:
    from gaiaseg_tpu_torch.archspace.samplers import build_model_sampler
    from gaiaseg_tpu_torch.data.device_cache import DeviceCachedDataset
    from gaiaseg_tpu_torch.engine import configure_numerics, train_segmentor
    from gaiaseg_tpu_torch.models import build_segmentor, fill_img_size
    from gaiaseg_tpu_torch.parallel import (broadcast_object, process_count,
                                            process_index, sum_over_ranks)
    config, traffic = job["config"], job["traffic"]
    seed, seconds, trace = job["seed"], job["seconds"], job["trace"]
    main, world = process_index() == 0, process_count()
    if device.type == "cuda":
        torch.cuda.set_device(device)
    cfg = program_config(config)
    global_batch = int(cfg["data"]["samples_per_gpu"])
    batch = int(traffic["samples_per_gpu"])
    cfg.merge_from_dict({"data.samples_per_gpu": batch})
    configure_numerics()
    torch.backends.cudnn.benchmark = bool(cfg.get("cudnn_benchmark", False))
    torch.manual_seed(seed)
    marks = Marks(job["t_start"]) if main else (lambda what: None)
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
    crop = tuple(traffic["crop"])
    if torch.backends.cudnn.benchmark:
        _autotune(model, model_cfg, cfg, batch, crop, classes, device)
        marks("convs autotuned")

    sampler = _Recorder(build_model_sampler(cfg["train_sampler"]))
    cycle = int(traffic["cycle"])
    n_check = int(traffic["check_steps"])
    warm = int(traffic["warm_steps"])
    profile = int(traffic["profile_cycles"])
    log_interval = int((cfg.get("log_config") or {}).get("interval", 50))
    full = log_interval - 1
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
            model.forward_train = recording_forward
            if main:
                st["p0"] = {n: p.detach().clone() for n, p in params}
                st["hook"] = register_optimizer_step_post_hook(first_step)
        elif it == n_check:
            # each rank's loss is its share of the global mean
            st["losses"] = sum_over_ranks(torch.stack(st["losses"])) \
                .cpu().tolist()
            del model.forward_train
            if main:
                st["change_norms"] = torch.stack([
                    torch.linalg.vector_norm(p.detach() - st["p0"][n])
                    for n, p in params]).cpu().tolist()
                del st["p0"]
        elif it == full and main:
            st["full_params"] = {n: p.detach().to("cpu", copy=True)
                                 for n, p in model.named_parameters()}
            st["stats0"] = _running_stats(model)
        elif it == full + 1 and main:
            st["stats_delta"] = {k: v - st["stats0"][k] for k, v in
                                 _running_stats(model).items()}
        if it == warm:
            sync(device)
            st["it0"], st["t0"] = it, now()
            st["setup_s"] = st["t0"] - job["t_start"]
            marks(f"{it} steps")
        elif it > warm and "t1" not in st and (it - warm) % cycle == 0 \
                and broadcast_object(now() - st["t0"] >= seconds):
            sync(device)
            st["it1"], st["t1"] = it, now()
            st["stop"] = it + (cycle * (profile + 1) if trace else 0)
            if trace and main:
                st["span"], st["span_it0"] = Span(device, host=False), it
                st["valid"], st["logits"] = [], []
                st["handles"] = [h.register_forward_hook(
                    lambda m, i, out: st["logits"].append(tuple(out.shape)))
                    for h in _heads(model)]
                model.forward_train = recording_forward
        elif "span" in st and it == st["span_it0"] + cycle * profile:
            span = st["span"]
            st["span_out"] = dict(span.close(), allreduce_exposed_s=(
                exposed_collective_s(span.prof.events())))
            st["span_steps"] = it - st["span_it0"]
            for h in st.pop("handles"):
                h.remove()
            del model.forward_train
            st["host_span"], st["host_it0"] = Span(device), it
        elif "host_span" in st and it == st["host_it0"] + cycle:
            st["host_out"] = st["host_span"].close()
        if it == st.get("stop"):
            raise _Stop

    try:
        train_segmentor(model, cfg, work_dir=None, device=device,
                        train_dataset=dataset, train_sampler=sampler,
                        seed=seed, log=st["rows"].append, iter_hook=hook)
        raise RuntimeError("the loop ended before the window closed")
    except _Stop:
        pass
    if not main:
        return {}
    window_s = st["t1"] - st["t0"]
    steps = st["it1"] - st["it0"]
    info = device_info(world, device)
    readings: Dict[str, Any] = {"kind": "train", "window_s": window_s}
    rows = [float(m.group(2)) for m in map(LOG_ROW.match, st["rows"])
            if m and st["it0"] < int(m.group(1)) <= st["it1"]]
    if rows:
        readings["data_ms_per_step"] = sum(rows) / (len(rows) * log_interval)
    # rank 0's own work: its batch, so ``mfu.train`` reads one card's share
    readings["window_flops"] = sum(
        6 * batch * mac_count.model_macs(model_cfg, _arch(model_cfg, m),
                                         crop, train=True)
        for m in sampler.metas[st["it0"]:st["it1"]])
    breakdown = None
    if trace:
        span = st["span_out"]
        readings.update(span=span, span_images=st["span_steps"] * batch,
                        ce_launches=_ce_launches(st))
        if span["allreduce_exposed_s"] is not None:
            readings["allreduce_exposed_ms"] = 1e3 * span[
                "allreduce_exposed_s"] / st["span_steps"]
        info.update(busy_s=span["busy_s"], window_s=span["wall_s"])
        breakdown = {"device_ops": span["top"],
                     "idle_gaps": st["host_out"]["idle_gaps"]}
    return {"e2e": {job["workload"]["rate_metric"]:
                    steps * global_batch / window_s,
                    "setup_s": st["setup_s"]},
            "readings": readings, "attempted": steps,
            "failed": sum("loss=nan" in r or "loss=inf" in r
                          for r in st["rows"]),
            "device": info, "breakdown": breakdown,
            "prog": {"losses": st["losses"][:n_check],
                     "grad_norms": dict(zip([n for n, _ in params],
                                            st["grad_norms"])),
                     "change_norms": dict(zip([n for n, _ in params],
                                              st["change_norms"])),
                     "stats_delta": st["stats_delta"]},
            "full_params": st["full_params"], "full": full}


def exposed_collective_s(events) -> Optional[float]:
    """Seconds of the device's kernels in which an NCCL kernel ran and no
    other kernel did: the union of the NCCL kernels' intervals less its
    overlap with the union of the others'. None where no NCCL kernel ran
    (gloo)."""
    from torch.autograd import DeviceType
    nccl, other = [], []
    for e in events:
        if e.device_type != DeviceType.CUDA or \
                getattr(e, "is_user_annotation", False):
            continue
        (nccl if "nccl" in e.name.lower() else other).append(
            (e.time_range.start, e.time_range.end))
    if not nccl:
        return None
    busy = _union(other)
    total = 0.0
    for a, b in _union(nccl):
        total += b - a - sum(max(0.0, min(b, d) - max(a, c))
                             for c, d in busy if c < b and d > a)
    return total / 1e6


def _union(spans) -> List[List[float]]:
    merged: List[List[float]] = []
    for a, b in sorted(spans):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


if __name__ == "__main__":
    rank_main(sys.argv[1])
