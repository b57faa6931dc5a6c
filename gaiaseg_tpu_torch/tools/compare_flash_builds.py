#!/usr/bin/env python
"""Compare builds of the flash-attention kernels on one card, in turns.

    python -m gaiaseg_tpu_torch.tools.compare_flash_builds csrc DIR [DIR ...]

Each argument names a variant of ``csrc/flash_attention.cu``: ``csrc`` is
the package's own source, any other argument a directory holding a
``flash_attention.cu`` and the headers it includes. All builds compile at
once with the package's nvcc flags (into ``_build/compare/``); for each,
the ptxas report of the bf16 kernels is printed (registers, spills, and
ptxas' wgmma serialisation warnings). Then K3, K4 and K5 of every build
are held against their plain versions in bf16 (outputs within 2e-2 of
max|ref|, K3's m and l within 1e-4, and bit-equal over two launches) at
the ViT shape [8, 1024, 12] and at N = 3, 64, 129, 200, 1025, 1088, and
timed at the ViT shape in alternating turns (A B .. B A, ``--rounds``
times): the mean of 50 launches back to back (queued behind a spin on the
card, so the host's enqueue time is excluded), and the median of 30
launches each after a 64 MB write that evicts L2. SDPA's forward and
backward are timed at the start and end of each round. Prints one line
per build and writes
``chiprun_out/compare_flash_builds.json``. Needs a CUDA card; exits
non-zero on a failed build or check.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
from pathlib import Path

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from gaiaseg_tpu_torch.ops.cuda import build  # noqa: E402
from gaiaseg_tpu_torch.ops.cuda import flash_attention as fa  # noqa: E402

VIT = (8, 1024, 12)
CHECK_SHAPES = ((1, 3, 1), (2, 64, 3), (2, 129, 3), (1, 200, 2),
                (1, 1088, 2), (2, 1025, 12), VIT)
BF16_RTOL = 2e-2
STAT_RTOL = 1e-4
# the bf16 kernels' device functions
REPORTED = ("fwd_wgmma", "bwd_dkv_wgmma", "bwd_dq_wgmma")


def compile_all(names, source="flash_attention", reported=REPORTED):
    """Build ``<source>.cu`` of every variant at once:
    {name: (library path, ptxas lines of the device functions whose names
    contain one of ``reported``, each led by the function's name)}."""
    out_dir = build.BUILD_DIR / "compare"
    procs = {}
    for name in names:
        src = (build.CSRC_DIR if name == "csrc" else Path(name)) \
            / f"{source}.cu"
        lib = out_dir / re.sub(r"\W", "_", name) / f"lib{source}.so"
        lib.parent.mkdir(parents=True, exist_ok=True)
        procs[name] = (subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    built = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc exited {proc.returncode}\n{log}")
        keep, cur = [], None
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                cur = build.kernel_name(m.group(1)) \
                    if any(k in m.group(1) for k in reported) else None
            elif cur and ("registers" in line or "spill" in line):
                keep.append(f"{cur}: {line.strip()}")
            if re.search(r"\(C75\d\d\)", line) and any(k in line
                                                       for k in reported):
                keep.append(line.strip())
        built[name] = (lib, keep)
    return built


def inputs(b, n, h, seed):
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    q = torch.randn(b, n, h, 64, generator=g, device="cuda") * 0.125
    kv = torch.randn(b, n, 2, h, 64, generator=g, device="cuda")
    do = torch.randn(b, n, h, 64, generator=g, device="cuda")
    kv = kv.to(torch.bfloat16)
    return q.to(torch.bfloat16), kv[:, :, 0], kv[:, :, 1], \
        do.to(torch.bfloat16)


def check(lib_of, names):
    """Worst error / max|ref| of o, m, l, dk, dv, dq per build; raises on a
    miss."""
    worst = {n: 0.0 for n in names}
    tols = (BF16_RTOL, STAT_RTOL, STAT_RTOL, BF16_RTOL, BF16_RTOL, BF16_RTOL)
    for shape in CHECK_SHAPES:
        q, k, v, do = inputs(*shape, seed=1)
        o, m, l = fa.flash_fwd_reference(q, k, v)
        di = fa.attention_di(o, do)
        refs = (o, m, l, *fa.flash_bwd_dkv_reference(q, k, v, do, m, l, di),
                fa.flash_bwd_dq_reference(q, k, v, do, m, l, di))
        for name in names:
            fa._lib = lib_of[name]
            runs = [(*fa.flash_fwd(q, k, v),
                     *fa.flash_bwd_dkv(q, k, v, do, m, l, di),
                     fa.flash_bwd_dq(q, k, v, do, m, l, di)) for _ in (0, 1)]
            torch.cuda.synchronize()
            for got, again, ref, tol in zip(*runs, refs, tols):
                scale = float(ref.float().abs().max())
                err = float((got.float() - ref.float()).abs().max())
                if err > tol * scale or not torch.equal(got, again):
                    raise SystemExit(f"{name} {shape}: max|d| {err:.3e} vs "
                                     f"max|ref| {scale:.3e}, bit-equal "
                                     f"{torch.equal(got, again)}")
                worst[name] = max(worst[name], err / max(scale, 1e-30))
    return worst


def back_to_back_ms(fn, iters=50):
    """Mean ms of ``iters`` launches queued behind a ~10 ms spin on the
    card, so that the host's time to enqueue them is not in the reading."""
    for _ in range(3):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in (0, 1))
    torch.cuda.synchronize()
    torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def flushed_ms(fn, flush, iters=30):
    for _ in range(3):
        fn()
    times = []
    for _ in range(iters):
        flush.zero_()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in (0, 1))
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[iters // 2]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("builds", nargs="+")
    p.add_argument("--rounds", type=int, default=2)
    p.add_argument("--no-check", action="store_true",
                   help="time only: for builds that are wrong on purpose "
                        "(a part left out to see what it costs)")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("compare_flash_builds: needs a CUDA card", file=sys.stderr)
        return 1
    built = compile_all(args.builds)
    lib_of = {}
    for name, (path, report) in built.items():
        lib = fa.bind(ctypes.CDLL(str(path)))
        lib_of[name] = lambda lib=lib: lib
        print(f"== {name}")
        for line in report:
            print(f"   {line}")
    worst = {n: float("nan") for n in args.builds} if args.no_check \
        else check(lib_of, args.builds)
    q, k, v, do = inputs(*VIT, seed=5)
    o, m, l = fa.flash_fwd_reference(q, k, v)
    di = fa.attention_di(o, do)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    qt, kt, vt = (x.detach().transpose(1, 2).requires_grad_()
                  for x in (q, k, v))
    out = F.scaled_dot_product_attention(qt, kt, vt, scale=1.0)
    dot = do.transpose(1, 2)

    def sdpa_bwd():
        torch.autograd.grad(out, (qt, kt, vt), dot, retain_graph=True)

    def sdpa_fwd():
        with torch.no_grad():
            F.scaled_dot_product_attention(qt, kt, vt, scale=1.0)

    def time_sdpa():
        for key, fn in (("forward", sdpa_fwd), ("backward", sdpa_bwd)):
            sdpa_ms[f"{key} back-to-back"].append(back_to_back_ms(fn))
            sdpa_ms[f"{key} flushed"].append(flushed_ms(fn, flush))

    kernels = {"K3": lambda: fa.flash_fwd(q, k, v),
               "K4": lambda: fa.flash_bwd_dkv(q, k, v, do, m, l, di),
               "K5": lambda: fa.flash_bwd_dq(q, k, v, do, m, l, di)}
    res = {n: {f"{kernel} {how}": [] for kernel in kernels
               for how in ("back-to-back", "flushed")} for n in args.builds}
    sdpa_ms = {f"{key} {how}": [] for key in ("forward", "backward")
               for how in ("back-to-back", "flushed")}
    order = args.builds + args.builds[::-1]
    for _ in range(args.rounds):
        time_sdpa()
        for name in order:
            fa._lib = lib_of[name]
            for kernel, fn in kernels.items():
                res[name][f"{kernel} back-to-back"].append(
                    back_to_back_ms(fn))
                res[name][f"{kernel} flushed"].append(flushed_ms(fn, flush))
        time_sdpa()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"on {smi}; ms per launch at [8, 1024, 12, 64] bf16, every turn")
    for name in args.builds:
        print(f"{name}: worst err/max|ref| {worst[name]:.2e}")
        for key, vals in res[name].items():
            print(f"   {key:<16} " + " ".join(f"{x:.4f}" for x in vals))
    for key, vals in sdpa_ms.items():
        print(f"SDPA {key:<24} " + " ".join(f"{x:.4f}" for x in vals))
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "compare_flash_builds.json"),
              "w") as f:
        json.dump({"nvidia_smi": smi, "builds": args.builds,
                   "ptxas": {n: r for n, (_, r) in built.items()},
                   "worst_rel_err": worst, "ms": res, "sdpa_ms": sdpa_ms},
                  f, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
