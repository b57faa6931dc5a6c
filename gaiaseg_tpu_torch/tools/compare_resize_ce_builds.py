#!/usr/bin/env python
"""Compare builds of the fused upsample+CE kernels (K1, K2) on one card.

    python -m gaiaseg_tpu_torch.tools.compare_resize_ce_builds csrc DIR ...

Each argument names a variant of ``csrc/resize_ce.cu``: ``csrc`` is the
package's own source, any other argument a directory holding a
``resize_ce.cu`` and the headers it includes. All builds compile at once
with the package's nvcc flags (into ``_build/compare/``) and their ptxas
lines for K1's and K2's device functions are printed. Every build is held
against the plain versions at the flagship's two losses ([8, 19, 16, 32]
and [8, 19, 32, 64] logits against 512x1024 labels), the ViT's two at 19
and at 150 classes, 21, 59 and 171 classes at the ViT's decode shape and a
small 150-class case: K1's loss within 1e-5 relative and its valid count
equal, K2 within 1e-4 of max|ref|, and each bit-equal over two launches.
Then K1 and K2 are timed at the flagship's two losses, the ViT cell's two
(batch 16, 150 classes: the any-C instances) and 21, 59 and 171 classes at
its decode shape, in alternating turns (A B .. B A, ``--rounds`` times):
the mean of 50 launches back to back (queued behind a spin on the card)
and the median of 30 launches each after a 64 MB write that evicts L2;
``F.cross_entropy(F.interpolate)``, the library call K1 replaces, at the
start and end of each round; ``--no-check`` times builds that are wrong on
purpose (a part left out to see what it costs).
Prints every turn and writes ``chiprun_out/compare_resize_ce_builds.json``.
Needs a CUDA card; exits non-zero on a failed build or check.
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
import torch.nn.functional as F  # noqa: E402

from gaiaseg_tpu_torch.ops.cuda import resize_ce as rc  # noqa: E402
from gaiaseg_tpu_torch.tools.compare_flash_builds import (  # noqa: E402
    back_to_back_ms, compile_all, flushed_ms)

# [N, C, h, w] logits -> [N, H, W] labels: the flagship's two losses, the
# ViT cell's two (any-C instances), other class counts at its decode shape
TIMED = {"decode": (8, 19, 16, 32, 512, 1024),
         "aux": (8, 19, 32, 64, 512, 1024),
         "vit_decode150": (16, 150, 128, 128, 512, 512),
         "vit_aux150": (16, 150, 32, 32, 512, 512),
         "c21": (16, 21, 128, 128, 512, 512),
         "c59": (16, 59, 128, 128, 512, 512),
         "c171": (16, 171, 128, 128, 512, 512)}
CHECKED = {**TIMED, "vit_decode": (8, 19, 128, 128, 512, 512),
           "vit_aux": (8, 19, 32, 32, 512, 512),
           "c150": (2, 150, 6, 10, 24, 40)}
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
# K1's and K2's device functions (both instances of each)
REPORTED = ("fwd_tile", "bwd_tile")


def inputs(shape, seed):
    """logits, mid, label, scale and the label height of one loss."""
    n, c, h, w, H, W = shape
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    logits = torch.randn(n, c, h, w, generator=g, device="cuda")
    label = torch.randint(0, c, (n, H, W), generator=g, device="cuda",
                          dtype=torch.int32)
    label[torch.rand(n, H, W, generator=g, device="cuda") < 0.1] = 255
    mid = rc.width_interp(logits, W)
    scale = (1.0 / (label != 255).sum().clamp_min(1).float()).reshape(1)
    return logits, mid, label, scale, H


def use(lib):
    """Route the wrappers to ``lib``; K1's workspaces start from zero."""
    rc._lib = lambda: lib
    rc._WORKSPACES.clear()


def check(libs):
    """Worst K1 loss rel and K2 err/max|ref| per build; raises on a miss."""
    worst = {n: {"k1_loss_rel": 0.0, "k2_rel": 0.0} for n in libs}
    for case, shape in CHECKED.items():
        _, mid, label, scale, H = inputs(shape, seed=1)
        rls, rws = rc.resize_ce_sums_reference(mid, label, H)
        ref = rc.resize_ce_grad_mid_reference(mid, label, scale, H)
        top = float(ref.abs().max())
        for name, lib in libs.items():
            use(lib)
            sums, again = (torch.stack(rc.resize_ce_sums(mid, label, H))
                           for _ in (0, 1))
            rel = abs(float(sums[0] / sums[1]) - float(rls / rws)) \
                / float(rls / rws)
            if rel > LOSS_RTOL or float(sums[1]) != float(rws) \
                    or not torch.equal(sums, again):
                raise SystemExit(f"{name} {case}: K1 loss rel {rel:.3e}, "
                                 f"count {float(sums[1])} vs {float(rws)}, "
                                 f"bit-equal {torch.equal(sums, again)}")
            got, again = (rc.resize_ce_grad_mid(mid, label, scale, H)
                          for _ in (0, 1))
            err = float((got - ref).abs().max())
            if err > GRAD_RTOL * top or not torch.equal(got, again):
                raise SystemExit(f"{name} {case}: K2 max|d| {err:.3e} vs "
                                 f"max|ref| {top:.3e}, bit-equal "
                                 f"{torch.equal(got, again)}")
            w = worst[name]
            w["k1_loss_rel"] = max(w["k1_loss_rel"], rel)
            w["k2_rel"] = max(w["k2_rel"], err / top)
    return worst


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("builds", nargs="+")
    p.add_argument("--rounds", type=int, default=2)
    p.add_argument("--no-check", action="store_true",
                   help="time only: for builds that are wrong on purpose")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("compare_resize_ce_builds: needs a CUDA card", file=sys.stderr)
        return 1
    built = compile_all(args.builds, "resize_ce", REPORTED)
    libs = {}
    for name, (path, report) in built.items():
        libs[name] = rc.bind(ctypes.CDLL(str(path)))
        print(f"== {name}")
        for line in report:
            print(f"   {line}")
    worst = {n: {"k1_loss_rel": float("nan"), "k2_rel": float("nan")}
             for n in libs} if args.no_check else check(libs)
    cases = {case: inputs(shape, seed=7) for case, shape in TIMED.items()}
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    res = {n: {f"{k} {case} {how}": [] for k in ("K1", "K2")
               for case in cases for how in ("back-to-back", "flushed")}
           for n in args.builds}
    lib_ms = {f"{case} {how}": [] for case in cases
              for how in ("back-to-back", "flushed")}

    def time_library():
        for case, (logits, _, label, _, H) in cases.items():
            label64 = label.long()

            def fn():
                F.cross_entropy(F.interpolate(logits, (H, label.shape[2]),
                                              mode="bilinear",
                                              align_corners=False),
                                label64, ignore_index=255)
            with torch.no_grad():
                lib_ms[f"{case} back-to-back"].append(back_to_back_ms(fn))
                lib_ms[f"{case} flushed"].append(flushed_ms(fn, flush))

    for _ in range(args.rounds):
        time_library()
        for name in args.builds + args.builds[::-1]:
            use(libs[name])
            for case, (_, mid, label, scale, H) in cases.items():
                for k, fn in (
                        ("K1", lambda: rc.resize_ce_sums(mid, label, H)),
                        ("K2", lambda: rc.resize_ce_grad_mid(mid, label,
                                                             scale, H))):
                    res[name][f"{k} {case} back-to-back"].append(
                        back_to_back_ms(fn))
                    res[name][f"{k} {case} flushed"].append(
                        flushed_ms(fn, flush))
        time_library()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"on {smi}; ms per launch, every turn")
    for name in args.builds:
        print(f"{name}: worst K1 loss rel {worst[name]['k1_loss_rel']:.2e}, "
              f"K2 err/max|ref| {worst[name]['k2_rel']:.2e}")
        for key, vals in res[name].items():
            print(f"   {key:<30} " + " ".join(f"{x:.4f}" for x in vals))
    for key, vals in lib_ms.items():
        print(f"F.cross_entropy(F.interpolate) {key:<20} "
              + " ".join(f"{x:.4f}" for x in vals))
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "compare_resize_ce_builds.json"),
              "w") as f:
        json.dump({"nvidia_smi": smi, "builds": args.builds,
                   "ptxas": {n: r for n, (_, r) in built.items()},
                   "worst": worst, "ms": res, "library_ms": lib_ms}, f,
                  indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
