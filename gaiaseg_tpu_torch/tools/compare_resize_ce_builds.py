#!/usr/bin/env python
"""Compare builds of the fused upsample+CE backward kernel (K2) on one card.

    python -m gaiaseg_tpu_torch.tools.compare_resize_ce_builds csrc DIR ...

Each argument names a variant of ``csrc/resize_ce.cu``: ``csrc`` is the
package's own source, any other argument a directory holding a
``resize_ce.cu`` and the headers it includes. All builds compile at once
with the package's nvcc flags (into ``_build/compare/``) and their ptxas
lines for K2's device functions are printed. K2 of every build is held
against its plain version (within 1e-4 of max|ref|, bit-equal over two
launches) at the flagship's two losses ([8, 19, 16, 32] and [8, 19, 32, 64]
logits against 512x1024 labels), the ViT's two, and a 150-class case, and
timed at the flagship's two in alternating turns (A B .. B A, ``--rounds``
times): the mean of 50 launches back to back (queued behind a spin on the
card) and the median of 30 launches each after a 64 MB write that evicts
L2. Prints every turn and writes
``chiprun_out/compare_resize_ce_builds.json``. Needs a CUDA card; exits
non-zero on a failed build or check.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import torch  # noqa: E402

from gaiaseg_tpu_torch.ops.cuda import resize_ce as rc  # noqa: E402
from gaiaseg_tpu_torch.tools.compare_flash_builds import (  # noqa: E402
    back_to_back_ms, compile_all, flushed_ms)

# [N, C, h, w] logits -> [N, H, W] labels
TIMED = {"decode": (8, 19, 16, 32, 512, 1024),
         "aux": (8, 19, 32, 64, 512, 1024)}
CHECKED = {**TIMED, "vit_decode": (8, 19, 128, 128, 512, 512),
           "vit_aux": (8, 19, 32, 32, 512, 512),
           "c150": (2, 150, 6, 10, 24, 40)}
GRAD_RTOL = 1e-4
REPORTED = ("bwd_kernel", "bwd_tile")


def inputs(shape, seed):
    """mid, label, scale and the label height of one loss."""
    n, c, h, w, H, W = shape
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    logits = torch.randn(n, c, h, w, generator=g, device="cuda")
    label = torch.randint(0, c, (n, H, W), generator=g, device="cuda",
                          dtype=torch.int32)
    label[torch.rand(n, H, W, generator=g, device="cuda") < 0.1] = 255
    mid = rc.width_interp(logits, W)
    scale = (1.0 / (label != 255).sum().clamp_min(1).float()).reshape(1)
    return mid, label, scale, H


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("builds", nargs="+")
    p.add_argument("--rounds", type=int, default=2)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("compare_resize_ce_builds: needs a CUDA card", file=sys.stderr)
        return 1
    built = compile_all(args.builds, "resize_ce", REPORTED)
    lib_of = {}
    for name, (path, report) in built.items():
        lib = rc.bind(ctypes.CDLL(str(path)))
        lib_of[name] = lambda lib=lib: lib
        print(f"== {name}")
        for line in report:
            print(f"   {line}")
    worst = {n: 0.0 for n in args.builds}
    for case, shape in CHECKED.items():
        mid, label, scale, H = inputs(shape, seed=1)
        ref = rc.resize_ce_grad_mid_reference(mid, label, scale, H)
        top = float(ref.abs().max())
        for name in args.builds:
            rc._lib = lib_of[name]
            got, again = (rc.resize_ce_grad_mid(mid, label, scale, H)
                          for _ in (0, 1))
            err = float((got - ref).abs().max())
            if err > GRAD_RTOL * top or not torch.equal(got, again):
                raise SystemExit(f"{name} {case}: max|d| {err:.3e} vs "
                                 f"max|ref| {top:.3e}, bit-equal "
                                 f"{torch.equal(got, again)}")
            worst[name] = max(worst[name], err / top)
    cases = {case: inputs(shape, seed=7) for case, shape in TIMED.items()}
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    res = {n: {f"{case} {how}": [] for case in cases
               for how in ("back-to-back", "flushed")} for n in args.builds}
    for _ in range(args.rounds):
        for name in args.builds + args.builds[::-1]:
            rc._lib = lib_of[name]
            for case, (mid, label, scale, H) in cases.items():
                def fn():
                    rc.resize_ce_grad_mid(mid, label, scale, H)
                res[name][f"{case} back-to-back"].append(back_to_back_ms(fn))
                res[name][f"{case} flushed"].append(flushed_ms(fn, flush))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"on {smi}; K2 ms per launch at the flagship's losses, every turn")
    for name in args.builds:
        print(f"{name}: worst err/max|ref| {worst[name]:.2e}")
        for key, vals in res[name].items():
            print(f"   {key:<20} " + " ".join(f"{x:.4f}" for x in vals))
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "compare_resize_ce_builds.json"),
              "w") as f:
        json.dump({"nvidia_smi": smi, "builds": args.builds,
                   "ptxas": {n: r for n, (_, r) in built.items()},
                   "worst_rel_err": worst, "ms": res}, f, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
