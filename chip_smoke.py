#!/usr/bin/env python3
"""On-card smoke of the PyTorch/CUDA port (gaiaseg_tpu_torch) on one GPU.

    python3 chip_smoke.py            # every phase, as a check of the port
    python3 chip_smoke.py build kernels   # only the named phases
    python3 chip_smoke.py flash_kernels   # just K3-K5 (built on first use)

Phases, each printing its own lines; any failure exits non-zero:

1. device   the card (nvidia-smi name and power limit), torch/CUDA versions,
            the TF32 settings.
2. build    nvcc builds every kernel of ``gaiaseg_tpu_torch/csrc`` and prints
            each kernel's registers and spills from ptxas and any wgmma
            serialisation warning; the bf16 attention kernels (K3, K4, K5)
            and the two instances each of K1 and K2 must not spill.
3. kernels  K1 (``resize_ce_fwd``) and K2 (``resize_ce_bwd``) against their
            plain torch versions at the flagship and the ViT loss shapes
            (float32 and bf16 logits), the test shapes, 150 classes (the
            any-C instances), all-ignored labels; K1 and K2 run twice must
            agree bit for bit; then their times (CUDA events, L2 flushed,
            medians) beside the plain version, the library call and the
            bound.
4. segmentor  the flagship segmentor's loss and gradients through the
            kernels equal the unfused F.interpolate + CE chain (float32).
5. train    8 full-width iterations of the flagship supernet config
            (``configs/local_examples/train_supernet/pspnet_ar50to101v2_
            gsync.py``), one sandwich cycle, bf16 autocast, synthetic
            512x1024 records kept on the card (``device_cache``) through
            the config's train pipeline (Resize
            to img_scale with ratio 0.5-2, RandomCrop 512x1024 with
            cat_max_ratio 0.75, flip, photometric distortion, on the card,
            prefetched), batch 8; K1 and K2 must each launch twice per
            iteration (decode and aux loss). Then the identical cycle again
            for warm step times, one profiled MAX step (device time by
            kernel, idle share), and the least time of each step over three
            warm cycles (the host's clock spreads; the minimum does not).
6. data     the data pipeline at full width: 32 synthetic records of
            Cityscapes' 1024x2048 packed into a .gsegpack; the card's
            ``augment_batch`` of 8 of them against the CPU's with the same
            drawn parameters (labels equal, image within 2e-5); the
            augment's and the upload's device ms per batch; then one
            flagship sandwich cycle (8 iterations, batch 8) from the packed
            file and one from the device cache, each cold and again warm:
            finite losses, the sandwich sequence, K1 and K2 16 launches
            each; device and wall img/s, data_ms, peak memory per route.
7. eval     whole-mode ``simple_test`` at the val anchors R50/R77/R101 on
            two synthetic 1024x2048 images, read through the loader and
            the prefetch thread, confusion-matrix mIoU.
8. flash_kernels  K3 (``flash_fwd``), K4 (``flash_bwd_dkv``) and K5
            (``flash_bwd_dq``) against their plain torch versions at the ViT
            shape [8, 1024, 12, 64] in bf16 and float32, at N = 1025, 200
            (ragged tails), 1088 (a half-empty last 128-row block), 64 (one
            tile) and 129 (a block with one real row) and on all-zero
            q/k/v; each run twice must agree bit for bit. Then their times
            beside the plain version, SDPA and the bound, K3 beside SDPA's
            forward and the port's whole attention backward
            (``attention_di`` + K4 + K5) beside SDPA's backward, in turns.
9. vit_segmentor  the elastic-ViT segmentor's loss and gradients through
            the flash kernels equal the dense attention route (bf16, a
            batch of 8); two planted faults in dq (zeroed, halved) must
            fail that check.
10. vit_train  one sandwich cycle (MAX, MIN, 2 random) of the elastic-ViT
            UPerNet supernet (``configs/_dynamic_/models/upernet_elastic_
            vit.py`` with ``with_cls_token=False``, so the flash gate opens)
            at full width, synthetic 512x512 records kept on the card
            through ADE20K's train pipeline (512x512 crops), batch 8, AdamW
            + clip;
            K3-K5 must each launch once per active layer, K1/K2 twice per
            iteration. Then the cycle again for warm times, a profiled
            MAX step, and the least step times over three warm cycles.
11. vit_eval  whole-mode eval at the val anchors MIN and MAX on four
            synthetic 512x512 images; K3 launches once per active layer per
            forward.

It then prints the ``kernels`` JSON line, the nvidia-smi line and, last,
``{"ok": true, "device": {...}}``. Details go to
``chiprun_out/chip_smoke.json``. There is no fallback: without a CUDA card,
or without the rest of the repository beside this file, it exits non-zero
and prints no result.
"""
from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
FLAGSHIP = os.path.join(REPO, "configs", "local_examples", "train_supernet",
                        "pspnet_ar50to101v2_gsync.py")
OUT_DIR = os.path.join(REPO, "chiprun_out")
VIT = os.path.join(REPO, "configs", "_dynamic_", "models",
                   "upernet_elastic_vit.py")
PHASES = ("device", "build", "kernels", "segmentor", "train", "data",
          "eval", "flash_kernels", "vit_segmentor", "vit_train", "vit_eval")
FLASH_KERNELS = ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")
# device functions of csrc/*.cu, as ptxas and the profiler name them
REPO_KERNELS = ("fwd_tile", "fwd_tile_any", "bwd_tile", "bwd_tile_any",
                "fwd_wgmma", "bwd_dkv_wgmma", "bwd_dq_wgmma", "fwd_f32",
                "bwd_dkv_f32", "bwd_dq_f32")
# must not spill, by source (a template's instances all count)
NO_SPILL = {"resize_ce": ("fwd_tile", "fwd_tile_any", "bwd_tile",
                          "bwd_tile_any"),
            "flash_attention": ("fwd_wgmma", "bwd_dkv_wgmma", "bwd_dq_wgmma")}
VIT_ITERS = 4     # one sandwich cycle: MAX, MIN, 2 random
ADE20K = os.path.join(REPO, "configs", "_dynamic_", "datasets", "ade20k.py")
# the data phase: Cityscapes-sized synthetic records packed into a file, the
# flagship pipeline (1024x2048 -> 512x1024 crops), batch 8
DATA_RECORDS, DATA_SIZE, DATA_BATCH = 32, (1024, 2048), 8
DATA_CACHE_GB = 1.0       # device_cache budget, above the file's 0.27 GB
AUG_ATOL = 2e-5           # card vs CPU augment, normalized image (the CPU
                          # parity tests' tolerance against JAX)
# images of the flash-vs-dense check: the train step's batch. The worst
# tensors are the PSP branches pooled to 1x1 .. 3x3, where one ReLU that
# flips between the routes moves 1 / (positions x images) of a gradient: at 2
# images that alone reads 0.07-0.14 whatever the forward kernel, at 8 images
# 0.03, while the planted faults read 0.50 and 0.88 (this script, H100)
VIT_CHECK_BATCH = 8

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, float32 non-tensor FLOP/s
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
# operations per (valid pixel, class) counted for the bound: K1 blends two
# taps (3), max (1), subtract + exp + add (3); K2 also p*scale, -onehot and
# the 2-row adjoint (2 FMA = 4 ops) -> 7 + 7. Per valid pixel: log, pick,
# two adds (4).
OPS_FWD_PER_CLASS, OPS_BWD_PER_CLASS, OPS_PER_PIXEL = 7, 14, 4

# dense bf16 tensor-core rate; operations per (q row, key, head-dim lane) of
# each attention kernel: K3 S = QK^T and O = PV (2 products, 2 ops each);
# K4 S^T, dP^T, dV, dK (4 products); K5 S, dP, dQ (3 products)
PEAK_BF16_FLOPS = 989e12
OPS_FLASH_FWD, OPS_FLASH_DKV, OPS_FLASH_DQ = 4, 8, 6
VIT_ATTN_SHAPE = (8, 1024, 12)   # [B, N, H] of the ViT train step, D = 64

# flash kernels against their plain versions, as a share of max|ref|:
# float32 outputs differ only in summation order; bf16 outputs are rounded
# to bf16 (half an ulp is 2^-9) and the kernels round P (forward) and P, dS
# (backward) to bf16 as tensor-core operands where the plain backward keeps
# them float32; m and l are float32 in both.
FLASH_F32_RTOL = 1e-4
FLASH_BF16_RTOL = 2e-2
FLASH_STAT_RTOL = 1e-4
# ViT segmentor, flash route vs dense route under bf16 autocast: the dense
# route rounds the logits QK^T to bf16 before its float32 softmax (as the
# JAX module does), the kernels keep them float32, so the routes differ by
# bf16 roundings through 12 layers; measured next to the dense bf16 route's
# own distance from float32 and to planted faults in dq, which must exceed
# the gradient tolerance (all printed by the phase)
VIT_LOSS_RTOL = 1e-2
VIT_GRAD_RTOL = 1e-1
F32_LOSS_RTOL = 1e-5    # loss: float32 sums of the same terms
F32_GRAD_RTOL = 1e-4    # grad: max|d| <= 1e-4 * max|ref| (exp/sum order)
BF16_GRAD_RTOL = 1e-2   # grad returned in bf16: one bf16 ulp is 2^-8
SEG_GRAD_RTOL = 1e-3    # per-parameter grads after backprop through the
                        # whole float32 network (cuDNN sums in its order)


class SmokeFailure(Exception):
    pass


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise SmokeFailure(msg)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


# --------------------------------------------------------------------- #
def phase_device(ctx):
    import torch
    from gaiaseg_tpu_torch.engine import configure_numerics
    ctx["nvidia_smi"] = nvidia_smi_line()
    ctx["tf32"] = configure_numerics()
    print(f"[device] {ctx['nvidia_smi']} | torch {torch.__version__} "
          f"cuda {torch.version.cuda} | python {sys.version.split()[0]}")
    print(f"[device] tf32 {ctx['tf32']}")


def _ptxas(log: str) -> dict:
    """{kernel: registers, static shared memory, spill bytes} from nvcc's
    ``-Xptxas=-v`` output."""
    from gaiaseg_tpu_torch.ops.cuda.build import kernel_name
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            cur = out.setdefault(kernel_name(m.group(1)), {})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            cur["static_smem"] = int(m.group(1)) if m else 0
    return out


def phase_build(ctx):
    from gaiaseg_tpu_torch.ops.cuda import build
    t0 = time.perf_counter()
    res = build.build()
    secs = time.perf_counter() - t0
    ctx["build_seconds"] = secs
    ctx["ptxas"] = {}
    for name, r in res.items():
        print(f"[build] {name}: {r['path']} ({r['seconds']:.1f}s)")
        kernels = _ptxas(r["log"])
        ctx["ptxas"].update(kernels)
        for k, v in kernels.items():
            print(f"[build]   {k}: {v.get('registers')} registers, "
                  f"{v.get('static_smem')} B static smem, spills "
                  f"{v.get('spill_stores')} B stored / {v.get('spill_loads')}"
                  " B loaded")
        serialised = sorted(set(re.findall(r"\(C75\d\d\)[^\n]*", r["log"])))
        ctx.setdefault("ptxas_warnings", {})[name] = serialised
        for line in serialised:
            print(f"[build]   ptxas warning {line[:160]}")
    for source, names in NO_SPILL.items():
        if not res[source]["log"]:           # found built, not built now
            continue
        for k in names:
            found = {n: v for n, v in ctx["ptxas"].items()
                     if n.split("<")[0] == k}
            check(found and all(v.get("spill_stores") == 0
                                and v.get("spill_loads") == 0
                                for v in found.values()),
                  f"build: {k} spills or is missing from ptxas' output: "
                  f"{found}")
    print(f"[build] all kernels built in {secs:.1f}s")


# --------------------------------------------------------------------- #
def _inputs(shape, dtype, seed, ignore_frac=0.1):
    import torch
    n, c, h, w, H, W = shape
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    logits = torch.randn(n, c, h, w, generator=g, device="cuda").to(dtype)
    label = torch.randint(0, c, (n, H, W), generator=g, device="cuda",
                          dtype=torch.int32)
    drop = torch.rand(n, H, W, generator=g, device="cuda") < ignore_frac
    label[drop] = 255
    return logits, label


def _max_abs(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def _check_case(name, shape, dtype, seed, errs, log):
    """K1, K2 and the autograd path against the plain versions; the case's
    readings are appended to ``log``."""
    import torch
    from gaiaseg_tpu_torch.ops.cuda import resize_ce as rc
    n, c, h, w, H, W = shape
    logits, label = _inputs(shape, dtype, seed)
    mid = rc.width_interp(logits, W)
    ls, ws = rc.resize_ce_sums(mid, label, H)
    check(all(torch.equal(x, y) for x, y in
              zip((ls, ws), rc.resize_ce_sums(mid, label, H))),
          f"{name}: K1 launched twice on the same inputs gives different "
          "bits")
    rls, rws = rc.resize_ce_sums_reference(mid, label, H)
    loss, rloss = ls / ws.clamp_min(1), rls / rws.clamp_min(1)
    check(float(ws) == float(rws), f"{name}: valid count {ws} != {rws}")
    rel = abs(float(loss) - float(rloss)) / max(abs(float(rloss)), 1e-30)
    check(rel <= F32_LOSS_RTOL, f"{name}: K1 loss rel err {rel:.2e}")
    scale = (1.0 / rws.clamp_min(1)).reshape(1)
    gmid = rc.resize_ce_grad_mid(mid, label, scale, H)
    check(torch.equal(gmid, rc.resize_ce_grad_mid(mid, label, scale, H)),
          f"{name}: K2 launched twice on the same inputs gives different "
          "bits")
    rg = rc.resize_ce_grad_mid_reference(mid, label, scale, H)
    gerr, gmax = _max_abs(gmid, rg), float(rg.abs().max())
    check(gerr <= F32_GRAD_RTOL * gmax,
          f"{name}: K2 grad max|d| {gerr:.2e} vs max|ref| {gmax:.2e}")
    errs["resize_ce_fwd"] = max(errs["resize_ce_fwd"],
                                abs(float(loss) - float(rloss)))
    errs["resize_ce_bwd"] = max(errs["resize_ce_bwd"], gerr)
    # end to end through the autograd Function
    x = logits.detach().requires_grad_()
    lk = rc.fused_resize_ce(x, label, (H, W))
    gk, = torch.autograd.grad(lk, x)
    xr = logits.detach().requires_grad_()
    lr = rc.fused_resize_ce_reference(xr, label, (H, W))
    gr, = torch.autograd.grad(lr, xr)
    lk, lr = lk.detach(), lr.detach()
    e2e = abs(float(lk) - float(lr)) / max(abs(float(lr)), 1e-30)
    grad_rtol = F32_GRAD_RTOL if dtype == torch.float32 else BF16_GRAD_RTOL
    g2 = _max_abs(gk, gr)
    check(e2e <= F32_LOSS_RTOL and gk.dtype == dtype
          and g2 <= grad_rtol * float(gr.float().abs().max()),
          f"{name}: fused_resize_ce loss rel {e2e:.2e}, grad max|d| {g2:.2e}")
    log.append({"case": name, "shape": list(shape), "dtype": str(dtype)[6:],
                "k1_loss_rel": rel, "k2_max_abs": gerr, "k2_max_ref": gmax,
                "autograd_loss_rel": e2e, "autograd_grad_max_abs": g2})
    print(f"[kernels] {name:<22} {str(dtype)[6:]:<8} loss {float(loss):.6f} "
          f"rel {rel:.1e} | K2 max|d| {gerr:.1e} (max|ref| {gmax:.1e}) | "
          f"autograd loss rel {e2e:.1e} grad max|d| {g2:.1e} | K1, K2 "
          "twice: bit-equal")


def _time_ms(fn, flush, iters=20, warmup=3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        flush.zero_()   # evict the 50 MB L2: the step finds labels cold
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    times.sort()
    return times[len(times) // 2]


def _bound(mid, label, fwd: bool) -> dict:
    """Least time on the card: each input read once, each output written
    once, over HBM rate; the operations the valid pixels need over the
    float32 rate. The larger one bounds."""
    n, h, c, W = mid.shape
    n_valid = int((label != 255).sum())
    per_class = OPS_FWD_PER_CLASS if fwd else OPS_BWD_PER_CLASS
    ops = n_valid * (per_class * c + OPS_PER_PIXEL)
    nbytes = mid.numel() * 4 + label.numel() * 4 + (8 if fwd else
                                                     mid.numel() * 4)
    return {"bytes_ms": 1e3 * nbytes / PEAK_BYTES_PER_S,
            "ops_ms": 1e3 * ops / PEAK_F32_FLOPS}


def _time_case(name, shape, timings):
    import torch
    import torch.nn.functional as F
    from gaiaseg_tpu_torch.ops.cuda import resize_ce as rc
    n, c, h, w, H, W = shape
    logits, label = _inputs(shape, torch.float32, seed=7)
    mid = rc.width_interp(logits, W)
    rls, rws = rc.resize_ce_sums_reference(mid, label, H)
    scale = (1.0 / rws.clamp_min(1)).reshape(1)
    label64 = label.long()
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    x = logits.detach().requires_grad_()
    lib_loss = F.cross_entropy(
        F.interpolate(x, (H, W), mode="bilinear", align_corners=False),
        label64, ignore_index=255)

    def lib_bwd():
        x.grad = None
        lib_loss.backward(retain_graph=True)

    def lib_fwd():
        with torch.no_grad():
            F.cross_entropy(F.interpolate(logits, (H, W), mode="bilinear",
                                          align_corners=False),
                            label64, ignore_index=255)

    row = {
        "resize_ce_fwd": dict(
            ms=_time_ms(lambda: rc.resize_ce_sums(mid, label, H), flush),
            plain_ms=_time_ms(
                lambda: rc.resize_ce_sums_reference(mid, label, H), flush),
            library_ms=_time_ms(lib_fwd, flush),
            **_bound(mid, label, True)),
        "resize_ce_bwd": dict(
            ms=_time_ms(lambda: rc.resize_ce_grad_mid(mid, label, scale, H),
                        flush),
            plain_ms=_time_ms(lambda: rc.resize_ce_grad_mid_reference(
                mid, label, scale, H), flush),
            library_ms=_time_ms(lib_bwd, flush),
            **_bound(mid, label, False)),
    }
    for k, v in row.items():
        v["bound_ms"] = max(v["bytes_ms"], v["ops_ms"])
        print(f"[kernels] time {name:<7} {k}: kernel {v['ms']:.4f} ms | "
              f"plain {v['plain_ms']:.4f} ms | library {v['library_ms']:.4f}"
              f" ms | bound: bytes {v['bytes_ms']:.4f} ms, operations "
              f"{v['ops_ms']:.4f} ms")
    timings[name] = row


def phase_kernels(ctx):
    import torch
    from gaiaseg_tpu_torch.ops.cuda import resize_ce as rc
    # [N, C, h, w] logits -> [N, H, W] labels; flagship crop 512x1024, C=19
    flagship = {"decode": (8, 19, 16, 32, 512, 1024),
                "aux": (8, 19, 32, 64, 512, 1024)}
    # the ViT path's losses: UPer logits at 128x128 (row factor 4) and FCN
    # aux logits at 32x32 (row factor 16), crop 512x512
    vit = {"vit_decode": (8, 19, 128, 128, 512, 512),
           "vit_aux": (8, 19, 32, 32, 512, 512)}
    test_shapes = {"test0": (2, 19, 8, 8, 32, 32),
                   "test1": (1, 7, 4, 6, 16, 20),
                   "test2": (2, 5, 3, 3, 12, 9),
                   # 150 classes (ADE20K): the any-C instances
                   "c150": (2, 150, 6, 10, 24, 40)}
    errs = {"resize_ce_fwd": 0.0, "resize_ce_bwd": 0.0}
    log = ctx["kernel_checks"] = []
    for name, shape in {**flagship, **vit}.items():
        for dtype in (torch.float32, torch.bfloat16):
            _check_case(name, shape, dtype, seed=1, errs=errs, log=log)
    for name, shape in test_shapes.items():
        _check_case(name, shape, torch.float32, seed=2, errs=errs, log=log)
    # all ignored: exactly zero loss and zero gradient
    logits, label = _inputs(flagship["aux"], torch.float32, 3)
    label.fill_(255)
    x = logits.detach().requires_grad_()
    loss = rc.fused_resize_ce(x, label, (512, 1024))
    g, = torch.autograd.grad(loss, x)
    loss = float(loss.detach())
    check(loss == 0.0 and float(g.abs().max()) == 0.0,
          f"all-ignored: loss {loss}, max|grad| {float(g.abs().max())}")
    print("[kernels] all-ignored labels: loss 0, grad 0")
    torch.cuda.synchronize()
    ctx["max_abs_err"] = errs
    timings = {}
    for name, shape in flagship.items():
        _time_case(name, shape, timings)
    ctx["kernel_timings"] = timings


# --------------------------------------------------------------------- #
def _attn_inputs(b, n, h, dtype, seed, zeros=False):
    """q (pre-scaled, contiguous), k and v as views into one [B, N, 2, H,
    64] tensor (the layout the fused qkv projection gives), dO."""
    import torch
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    q = torch.randn(b, n, h, 64, generator=g, device="cuda") * 0.125
    kv = torch.randn(b, n, 2, h, 64, generator=g, device="cuda")
    do = torch.randn(b, n, h, 64, generator=g, device="cuda")
    if zeros:
        q, kv = q.zero_(), kv.zero_()
    kv = kv.to(dtype)
    return q.to(dtype), kv[:, :, 0], kv[:, :, 1], do.to(dtype)


def _check_flash(name, shape, dtype, seed, errs, log, zeros=False):
    """K3, K4 and K5 against their plain versions on the same inputs; every
    output within its tolerance of max|ref|; each launched again on the
    same inputs gives the same bits. Each output's max|d| and max|ref| are
    appended to ``log``."""
    import torch
    from gaiaseg_tpu_torch.ops.cuda import flash_attention as fa
    q, k, v, do = _attn_inputs(*shape, dtype, seed, zeros)
    o, m, l = fa.flash_fwd(q, k, v)
    check(all(torch.equal(x, y) for x, y in
              zip((o, m, l), fa.flash_fwd(q, k, v))),
          f"{name} {str(dtype)[6:]}: K3 launched twice on the same inputs "
          "gives different bits")
    ro, rm, rl = fa.flash_fwd_reference(q, k, v)
    di = fa.attention_di(ro, do)           # both backward paths get ref's
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, rm, rl, di)
    dq = fa.flash_bwd_dq(q, k, v, do, rm, rl, di)
    dk2, dv2 = fa.flash_bwd_dkv(q, k, v, do, rm, rl, di)
    dq2 = fa.flash_bwd_dq(q, k, v, do, rm, rl, di)
    check(torch.equal(dk, dk2) and torch.equal(dv, dv2)
          and torch.equal(dq, dq2),
          f"{name} {str(dtype)[6:]}: K4/K5 launched twice on the same inputs "
          "give different bits")
    rdk, rdv = fa.flash_bwd_dkv_reference(q, k, v, do, rm, rl, di)
    rdq = fa.flash_bwd_dq_reference(q, k, v, do, rm, rl, di)
    bf16 = dtype == torch.bfloat16
    out_tol = FLASH_BF16_RTOL if bf16 else FLASH_F32_RTOL
    line = []
    for key, got, ref, tol, kernel in (
            ("o", o, ro, out_tol, "flash_fwd"),
            ("m", m, rm, FLASH_STAT_RTOL, "flash_fwd"),
            ("l", l, rl, FLASH_STAT_RTOL, "flash_fwd"),
            ("dq", dq, rdq, out_tol, "flash_bwd_dq"),
            ("dk", dk, rdk, out_tol, "flash_bwd_dkv"),
            ("dv", dv, rdv, out_tol, "flash_bwd_dkv")):
        err, scale = _max_abs(got, ref), float(ref.float().abs().max())
        check(got.shape == ref.shape and err <= tol * max(scale, 1e-30)
              or (scale == 0 and err == 0),
              f"{name} {str(dtype)[6:]}: {key} max|d| {err:.3e} vs max|ref| "
              f"{scale:.3e} (tolerance {tol} of max|ref|)")
        if key in ("o", "dq", "dk", "dv"):
            errs[kernel] = max(errs.get(kernel, 0.0), err)
        log.append({"case": name, "shape": list(shape),
                    "dtype": str(dtype)[6:], "output": key, "max_abs": err,
                    "max_ref": scale})
        line.append(f"{key} {err:.1e}/{scale:.1e}")
    print(f"[flash_kernels] {name:<14} {str(dtype)[6:]:<8} max|d|/max|ref| "
          + " ".join(line) + " | K3/K4/K5 twice: bit-equal")


def _flash_bounds(b, n, h):
    """Least time of each kernel at [B, N, H, 64] bf16: operations over the
    bf16 tensor-core rate, bytes (each input read once, each output
    written once) over HBM rate."""
    pairs = b * h * n * n * 64
    tensor = b * n * h * 64 * 2                 # one bf16 [B, N, H, 64]
    stat = b * h * n * 4                        # one float32 [B, H, N]
    rows = {"flash_fwd": (OPS_FLASH_FWD * pairs, 4 * tensor + 2 * stat),
            "flash_bwd_dkv": (OPS_FLASH_DKV * pairs, 6 * tensor + 3 * stat),
            "flash_bwd_dq": (OPS_FLASH_DQ * pairs, 5 * tensor + 3 * stat)}
    return {k: {"ops_ms": 1e3 * ops / PEAK_BF16_FLOPS,
                "bytes_ms": 1e3 * nbytes / PEAK_BYTES_PER_S}
            for k, (ops, nbytes) in rows.items()}


def phase_flash_kernels(ctx):
    import torch
    import torch.nn.functional as F
    from gaiaseg_tpu_torch.ops.cuda import flash_attention as fa
    errs = {}
    log = ctx["flash_checks"] = []
    full = VIT_ATTN_SHAPE
    for dtype in (torch.bfloat16, torch.float32):
        _check_flash("vit", full, dtype, 1, errs, log)
        _check_flash("cls-token", (2, 1025, 12), dtype, 2, errs, log)
        _check_flash("n200", (1, 200, 2), dtype, 3, errs, log)
        _check_flash("n1088", (1, 1088, 2), dtype, 6, errs, log)
        _check_flash("n64", (2, 64, 3), dtype, 7, errs, log)
        _check_flash("n129", (2, 129, 3), dtype, 8, errs, log)
    _check_flash("zeros", (2, 1024, 12), torch.bfloat16, 4, errs, log,
                 zeros=True)
    q, k, v, _ = _attn_inputs(2, 1024, 12, torch.bfloat16, 4, zeros=True)
    check(float(fa.flash_fwd(q, k, v)[0].abs().max()) == 0.0,
          "zeros: flash_fwd output is not zero")
    torch.cuda.synchronize()
    ctx["flash_max_abs_err"] = errs

    # times at the ViT shape, bf16: kernel, plain version, SDPA
    q, k, v, do = _attn_inputs(*full, torch.bfloat16, 5)
    o, m, l = fa.flash_fwd(q, k, v)
    di = fa.attention_di(o, do)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    qt, kt, vt = (x.detach().transpose(1, 2).requires_grad_()
                  for x in (q, k, v))
    lib_out = F.scaled_dot_product_attention(qt, kt, vt, scale=1.0)
    dot = do.transpose(1, 2)

    def lib_fwd():
        with torch.no_grad():
            F.scaled_dot_product_attention(qt, kt, vt, scale=1.0)

    def lib_bwd():
        torch.autograd.grad(lib_out, (qt, kt, vt), dot, retain_graph=True)

    lib_bwd_ms = _time_ms(lib_bwd, flush)
    bounds = _flash_bounds(*full)
    rows = {
        "flash_fwd": dict(
            ms=_time_ms(lambda: fa.flash_fwd(q, k, v), flush),
            plain_ms=_time_ms(lambda: fa.flash_fwd_reference(q, k, v), flush),
            library_ms=_time_ms(lib_fwd, flush)),
        "flash_bwd_dkv": dict(
            ms=_time_ms(lambda: fa.flash_bwd_dkv(q, k, v, do, m, l, di),
                        flush),
            plain_ms=_time_ms(lambda: fa.flash_bwd_dkv_reference(
                q, k, v, do, m, l, di), flush),
            library_ms=lib_bwd_ms),
        "flash_bwd_dq": dict(
            ms=_time_ms(lambda: fa.flash_bwd_dq(q, k, v, do, m, l, di),
                        flush),
            plain_ms=_time_ms(lambda: fa.flash_bwd_dq_reference(
                q, k, v, do, m, l, di), flush),
            library_ms=lib_bwd_ms),
    }
    for name, r in rows.items():
        r.update(bounds[name])
        r["bound_ms"] = max(r["ops_ms"], r["bytes_ms"])
        print(f"[flash_kernels] time {name}: kernel {r['ms']:.4f} ms | plain "
              f"{r['plain_ms']:.4f} ms | SDPA {r['library_ms']:.4f} ms | "
              f"bound: operations {r['ops_ms']:.4f} ms, bytes "
              f"{r['bytes_ms']:.4f} ms ({r['bound_ms'] / r['ms']:.1%} "
              "reached)")
    ctx["flash_timings"] = rows

    # K3 beside SDPA's forward, in turns SDPA, port, port, SDPA
    fwd_turns = {"sdpa": [], "port": []}
    for who, fn in (("sdpa", lib_fwd), ("port", lambda: fa.flash_fwd(q, k, v)),
                    ("port", lambda: fa.flash_fwd(q, k, v)),
                    ("sdpa", lib_fwd)):
        fwd_turns[who].append(_time_ms(fn, flush))
    ctx["flash_forward"] = {"port_ms": fwd_turns["port"],
                            "sdpa_ms": fwd_turns["sdpa"]}
    print(f"[flash_kernels] time forward in turns: K3 "
          f"{fwd_turns['port'][0]:.4f} / {fwd_turns['port'][1]:.4f} ms, SDPA "
          f"forward {fwd_turns['sdpa'][0]:.4f} / {fwd_turns['sdpa'][1]:.4f} "
          f"ms (port / SDPA "
          f"{sum(fwd_turns['port']) / sum(fwd_turns['sdpa']):.3f})")

    # like for like: SDPA's backward includes its own rowsum(dO * O) pass,
    # so the port's is attention_di + K4 + K5, as _FlashAttention.backward
    # runs it; timed in turns SDPA, port, port, SDPA
    def port_bwd():
        d = fa.attention_di(o, do)
        fa.flash_bwd_dkv(q, k, v, do, m, l, d)
        fa.flash_bwd_dq(q, k, v, do, m, l, d)

    turns = {"sdpa": [], "port": []}
    for who, fn in (("sdpa", lib_bwd), ("port", port_bwd), ("port", port_bwd),
                    ("sdpa", lib_bwd)):
        turns[who].append(_time_ms(fn, flush))
    di_ms = _time_ms(lambda: fa.attention_di(o, do), flush)
    port_ms, sdpa_ms = (sum(turns[w]) / 2 for w in ("port", "sdpa"))
    ctx["flash_backward"] = {"port_ms": turns["port"],
                             "sdpa_ms": turns["sdpa"],
                             "attention_di_ms": di_ms}
    print(f"[flash_kernels] time whole backward (dq, dk, dv from q, k, v, o, "
          f"dO): port attention_di + K4 + K5 {turns['port'][0]:.4f} / "
          f"{turns['port'][1]:.4f} ms, SDPA backward {turns['sdpa'][0]:.4f} / "
          f"{turns['sdpa'][1]:.4f} ms (port / SDPA {port_ms / sdpa_ms:.3f}); "
          f"attention_di alone {di_ms:.4f} ms")


# --------------------------------------------------------------------- #
def _flagship_cfg():
    from gaiaseg_tpu_torch.utils import Config
    cfg = Config.fromfile(FLAGSHIP)
    cfg.merge_from_dict({
        # kept on the card: the step's readings carry no host-side
        # generation of synthetic records (phase data reads a file)
        "data.train": {"type": "SyntheticDataset", "size": [512, 1024],
                       "length": 16, "num_classes": 19, "seed": 0,
                       "cells": 8, "device_cache": True},
        "data.samples_per_gpu": 8,
        "cudnn_benchmark": False,
    })
    return cfg


def _build_model(cfg):
    import torch
    from gaiaseg_tpu_torch.models import build_segmentor
    torch.manual_seed(0)
    return build_segmentor(cfg["model"]).cuda()


def phase_segmentor(ctx):
    """Loss + grads through the kernels == the unfused chain (float32)."""
    import torch
    from gaiaseg_tpu_torch.engine import prepare_batch
    from gaiaseg_tpu_torch.data import SyntheticDataset
    from gaiaseg_tpu_torch.models import encode_arch, model_max_arch
    cfg = _flagship_cfg()
    model = _build_model(cfg).eval()   # running stats, no dropout
    ds = SyntheticDataset(length=2, size=(128, 256), num_classes=19, seed=5,
                          cells=8)
    img, gt = prepare_batch([ds[0], ds[1]], cfg["img_norm_cfg"], "cuda")
    gt[:, :8] = 255
    arch = encode_arch(model_max_arch(cfg["model"]),
                       cfg["train_sampler"]["model_samplers"][0]
                       ["anchors"][4])   # R50
    res = {}
    for fused in (None, False):
        model.fused_loss = fused
        model.zero_grad(set_to_none=True)
        total, _ = model.forward_train(img, gt, arch)
        total.backward()
        res[fused] = (float(total.detach()), {k: p.grad.clone() for k, p in
                                     model.named_parameters()
                                     if p.grad is not None})
    (lk, gk), (lp, gp) = res[None], res[False]
    rel = abs(lk - lp) / abs(lp)
    worst = max(float((gk[k] - gp[k]).abs().max())
                / max(float(gp[k].abs().max()), 1e-30) for k in gp)
    check(rel <= F32_LOSS_RTOL and set(gk) == set(gp)
          and worst <= SEG_GRAD_RTOL,
          f"segmentor: loss rel {rel:.2e}, worst grad rel {worst:.2e}")
    print(f"[segmentor] R50 128x256 float32: fused loss {lk:.6f} vs unfused "
          f"{lp:.6f} (rel {rel:.1e}); worst per-tensor grad max|d|/max|ref| "
          f"{worst:.1e} over {len(gp)} tensors")


STEADY_CYCLES = 3   # warm cycles behind the per-step minimum


def _steady_step_ms(model, cfg, warm, tag):
    """The least step time of each position of the cycle over ``warm`` and
    STEADY_CYCLES - 1 further identical cycles. The host's clock around a
    step carries whatever else the shared host was doing (one step in ten
    reads 1.2-3x its usual time), and a cycle's img/s moves 15% with it;
    the minimum is what the card and this process need."""
    from gaiaseg_tpu_torch.engine import train_segmentor
    cycles = [warm] + [train_segmentor(model, cfg, device="cuda",
                                       max_iters=len(warm), seed=0)
                       for _ in range(STEADY_CYCLES - 1)]
    best = [min(c[i]["step_ms"] for c in cycles) for i in range(len(warm))]
    rate = 8 * len(best) / (sum(best) / 1e3)
    print(f"[{tag}] least step ms over {STEADY_CYCLES} warm cycles: "
          + ", ".join(f"{r['arch']} {ms:.1f}" for r, ms in zip(warm, best))
          + f": {rate:.2f} img/s (each cycle: " + ", ".join(
              f"{8 * len(c) / (sum(r['step_ms'] for r in c) / 1e3):.2f}"
              for c in cycles) + ")")
    return {"least_step_ms": best, "least_img_per_s": rate}


def phase_train(ctx):
    import torch
    from gaiaseg_tpu_torch.engine import train_segmentor
    from gaiaseg_tpu_torch.ops.cuda import LAUNCHES, reset_launches
    cfg = _flagship_cfg()
    torch.backends.cudnn.benchmark = bool(cfg.get("cudnn_benchmark"))
    model = _build_model(cfg)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[train] flagship supernet: {n_params / 1e6:.2f} M parameters, "
          "stem 64, widths 80/160/320/640, depths 4/6/29/4, PSP + FCN aux")
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    history = train_segmentor(model, cfg, device="cuda", max_iters=8,
                              seed=0, log=lambda s: print(f"[train] {s}"))
    launches = dict(LAUNCHES)
    ctx["launches"] = launches
    ctx["model"] = model
    ctx["cfg"] = cfg
    names = [r["arch"] for r in history]
    check(names == ["MAX", "MIN", "R101", "R77", "R50"] + ["random"] * 3,
          f"train: arch sequence {names}")
    check(all(math.isfinite(r["loss"]) for r in history),
          f"train: non-finite loss in {[r['loss'] for r in history]}")
    for k in ("resize_ce_fwd", "resize_ce_bwd"):
        check(launches[k] == 2 * len(history),
              f"train: {k} launched {launches[k]} times in {len(history)} "
              "iterations (want 2 per iteration)")
    # the identical cycle again (same seed: same archs, same batches) with
    # cuDNN's per-shape set-up done: the warm step times
    warm = train_segmentor(model, cfg, device="cuda", max_iters=8, seed=0)
    ctx["train_warm"] = warm

    def img_per_s(hist, key):
        return 8 * len(hist) / (sum(r[key] for r in hist) / 1e3)

    ctx["train"] = {
        "history": history, "warm_history": warm,
        "cold_img_per_s": img_per_s(history, "step_ms"),
        "warm_img_per_s": img_per_s(warm, "step_ms"),
        "warm_wall_img_per_s": 8 * len(warm) / (sum(
            r["step_ms"] + r["data_ms"] for r in warm) / 1e3),
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    ctx["profile"] = _profile_max_step(model, cfg, warm, "train")
    t = ctx["train"]
    print(f"[train] launches {launches} over {len(history)} iterations")
    print("[train] warm cycle step ms: " + ", ".join(
        f"{r['arch']} {r['step_ms']:.1f}" for r in warm))
    cold, hot = t["cold_img_per_s"], t["warm_img_per_s"]
    print(f"[train] device step img/s over the cycle: first {cold:.2f}, "
          f"warm {hot:.2f}; warm with the data wait "
          f"{t['warm_wall_img_per_s']:.2f}; on {ctx['nvidia_smi']}; peak "
          f"memory {t['peak_mem_gb']:.2f} GB")
    t.update(_steady_step_ms(model, cfg, warm, "train"))


def _data_route(model, cfg, tag):
    """Two identical sandwich cycles of the flagship from ``cfg``'s train
    data: the first cold with its launch counts, then the warm one."""
    import torch
    from gaiaseg_tpu_torch.engine import train_segmentor
    from gaiaseg_tpu_torch.ops.cuda import LAUNCHES, reset_launches
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    cold = train_segmentor(model, cfg, device="cuda", max_iters=8, seed=0,
                           log=lambda s: print(f"[data] {tag} {s}"))
    launches = dict(LAUNCHES)
    warm = train_segmentor(model, cfg, device="cuda", max_iters=8, seed=0)
    names = [r["arch"] for r in cold]
    check(names == ["MAX", "MIN", "R101", "R77", "R50"] + ["random"] * 3,
          f"data {tag}: arch sequence {names}")
    check(all(math.isfinite(r["loss"]) for r in cold + warm),
          f"data {tag}: non-finite loss in "
          f"{[r['loss'] for r in cold + warm]}")
    for k in ("resize_ce_fwd", "resize_ce_bwd"):
        check(launches[k] == 16, f"data {tag}: {k} launched {launches[k]} "
              "times in the 8-iteration cycle (want 16)")
    data_ms = sorted(r["data_ms"] for r in warm)
    step_s = sum(r["step_ms"] for r in warm) / 1e3
    wall_s = step_s + sum(data_ms) / 1e3
    out = {"launches": launches, "cold_history": cold, "warm_history": warm,
           "device_img_per_s": DATA_BATCH * len(warm) / step_s,
           "wall_img_per_s": DATA_BATCH * len(warm) / wall_s,
           "data_ms_median": data_ms[len(data_ms) // 2],
           "data_ms_max": data_ms[-1],
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    print(f"[data] {tag}: warm cycle device {out['device_img_per_s']:.2f} "
          f"img/s, wall with the data wait {out['wall_img_per_s']:.2f} img/s;"
          f" data_ms median {out['data_ms_median']:.2f}, largest "
          f"{out['data_ms_max']:.2f}; peak memory {out['peak_mem_gb']:.2f} "
          f"GB; launches {launches}")
    return out


def _cuda_ms(fn, reps=10, warmup=2) -> float:
    """Mean ms of ``fn`` on the current stream (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_data(ctx):
    """The data pipeline at full width: Cityscapes-sized records in a
    .gsegpack, the card's augment against the CPU's, one flagship sandwich
    cycle from the file and one from the device cache."""
    import shutil
    import tempfile
    import numpy as np
    import torch
    from gaiaseg_tpu_torch.data import (PackedDataset, SyntheticDataset,
                                        pack_dataset, parse_train_pipeline)
    from gaiaseg_tpu_torch.data import transforms as tf
    from gaiaseg_tpu_torch.data.staging import DeviceFeed
    from gaiaseg_tpu_torch.engine.train import base_scale_of
    tmp = tempfile.mkdtemp(prefix="gseg_data_")
    try:
        path = os.path.join(tmp, "cityscapes_synthetic.gsegpack")
        t0 = time.perf_counter()
        pack_dataset(SyntheticDataset(length=DATA_RECORDS, size=DATA_SIZE,
                                      num_classes=19, seed=0, cells=8), path)
        pack_s = time.perf_counter() - t0
        ds = PackedDataset(path)
        print(f"[data] packed {len(ds)} records {ds.h}x{ds.w} "
              f"({os.path.getsize(path) / 1e6:.1f} MB) in {pack_s:.1f}s")
        cfg = _flagship_cfg()
        cfg.merge_from_dict({"data.train": {"type": "PackedDataset",
                                            "path": path,
                                            "device_cache": False},
                             "data.samples_per_gpu": DATA_BATCH})
        train_cfg = cfg["data"]["train"]
        pipe = parse_train_pipeline(train_cfg["pipeline"])
        base = base_scale_of(pipe, ds)
        check(base == 1.0 and tuple(pipe.crop_size) == (512, 1024)
              and pipe.cat_max_ratio == 0.75 and pipe.photometric,
              f"data: flagship pipeline {pipe} (base scale {base})")

        # the card's augment against the CPU's, same records and parameters
        batch = ds.read_batch(np.arange(DATA_BATCH))
        params = tf.draw_augment_params(
            torch.Generator().manual_seed(0), DATA_BATCH,
            tuple(r * base for r in pipe.ratio_range), pipe.flip_prob)
        kw = dict(crop_size=tuple(pipe.crop_size),
                  cat_max_ratio=pipe.cat_max_ratio, num_classes=19,
                  photometric=True)
        img, gt = torch.from_numpy(batch["img"]), torch.from_numpy(batch["gt"])
        t0 = time.perf_counter()
        want = tf.augment_batch(img, gt, params, pipe.mean, pipe.std,
                                dtype=torch.float32, **kw)
        cpu_s = time.perf_counter() - t0
        dimg, dgt = img.cuda(), gt.cuda()
        dparams = tf.params_to(params, "cuda")
        got = tf.augment_batch(dimg, dgt, dparams, pipe.mean, pipe.std,
                               dtype=torch.float32, **kw)
        err = float((got["img"].cpu() - want["img"]).abs().max())
        labels_equal = torch.equal(got["gt"].cpu(), want["gt"])
        print(f"[data] augment of {DATA_BATCH} records 1024x2048 -> 512x1024:"
              f" card vs CPU labels equal {labels_equal}, image max|d| "
              f"{err:.2e} (tolerance {AUG_ATOL}); CPU {cpu_s:.2f}s")
        check(labels_equal and err <= AUG_ATOL,
              f"data: card augment vs CPU: labels equal {labels_equal}, "
              f"image max|d| {err:.2e}")

        # the augment's device time and the upload's, per batch
        mean = torch.tensor(pipe.mean, device="cuda")
        std = torch.tensor(pipe.std, device="cuda")
        aug_ms = _cuda_ms(lambda: tf.augment_batch(dimg, dgt, dparams, mean,
                                                   std, **kw))
        idx = torch.arange(DATA_BATCH, device="cuda")
        gather_ms = _cuda_ms(lambda: tf.gather_augment_batch(
            dimg, dgt, idx, dparams, mean, std, **kw))
        nbytes = batch["img"].nbytes + batch["gt"].nbytes
        pinned = [torch.from_numpy(batch[k]).pin_memory()
                  for k in ("img", "gt")]
        on_card = [torch.empty_like(t, device="cuda") for t in pinned]
        h2d_ms = _cuda_ms(lambda: [d.copy_(h, non_blocking=True)
                                   for d, h in zip(on_card, pinned)])
        feed = DeviceFeed("cuda")
        host = {"img": batch["img"], "gt": batch["gt"]}
        stage = []
        for _ in range(5):      # host copy into the pinned ring + the upload
            t0 = time.perf_counter()
            with feed.side_stream():
                feed.upload(host)
            feed.stream.synchronize()
            stage.append((time.perf_counter() - t0) * 1e3)
        stage_ms = sorted(stage)[len(stage) // 2]
        print(f"[data] per batch of {DATA_BATCH}: augment {aug_ms:.3f} ms "
              f"(from the cache in place {gather_ms:.3f} ms); upload of "
              f"{nbytes / 1e6:.1f} MB from pinned memory {h2d_ms:.3f} ms "
              f"({nbytes / h2d_ms / 1e6:.2f} GB/s), with the host's copy "
              f"into the pinned ring {stage_ms:.3f} ms (host clock, median "
              f"of 5); on {ctx['nvidia_smi']}")

        model = ctx.get("model") or _build_model(cfg)
        torch.backends.cudnn.benchmark = bool(cfg.get("cudnn_benchmark"))
        routes = {"packed": _data_route(model, cfg, "packed")}
        cfg.merge_from_dict({"data.train.device_cache": DATA_CACHE_GB})
        routes["cached"] = _data_route(model, cfg, "cached")
        ctx["data"] = {"records": DATA_RECORDS, "size": list(DATA_SIZE),
                       "batch": DATA_BATCH, "pack_seconds": pack_s,
                       "file_mb": os.path.getsize(path) / 1e6,
                       "augment_card_vs_cpu_max_abs": err,
                       "augment_ms": aug_ms, "gather_augment_ms": gather_ms,
                       "upload_ms": h2d_ms, "staged_upload_ms": stage_ms,
                       "upload_bytes": nbytes,
                       "routes": routes}
        del ds
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _profile_max_step(model, cfg, warm, tag):
    """Where one warm MAX-arch train step spends the card's time: device
    time by kernel from torch.profiler, and the idle share of the step's
    wall time (profiler on, so the wall time carries its overhead). The
    step is the config's optimizer (at lr 0) and gradient clip."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from gaiaseg_tpu_torch.data import build_dataset
    from gaiaseg_tpu_torch.engine import (build_optimizer, grad_clip_norm,
                                          prepare_batch, train_step)
    from gaiaseg_tpu_torch.models import encode_arch, model_max_arch
    ds = build_dataset(cfg["data"]["train"])
    img, gt = prepare_batch([ds[i] for i in range(8)], cfg["img_norm_cfg"],
                            "cuda")
    arch = encode_arch(model_max_arch(cfg["model"]))
    opt = build_optimizer(model.parameters(), dict(cfg["optimizer"], lr=0.0))
    max_norm = grad_clip_norm(cfg.get("optimizer_config"))
    train_step(model, opt, img, gt, arch, max_norm=max_norm)      # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        train_step(model, opt, img, gt, arch, max_norm=max_norm)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    # device activity only (kernels, copies, sets): the CPU ops that
    # launched them carry the same time again
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA or \
                getattr(e, "is_user_annotation", False):
            continue
        t_start, t_end = e.time_range.start, e.time_range.end
        spans.append((t_start, t_end))
        ms, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + (t_end - t_start) / 1e3, n + 1)
    busy, last = 0.0, None
    for a, b in sorted(spans):       # union of the device intervals
        if last is None or a > last:
            busy += (b - a) / 1e3
            last = b
        elif b > last:
            busy += (b - last) / 1e3
            last = b
    rows = sorted(((ms, n, name) for name, (ms, n) in by_name.items()),
                  reverse=True)
    warm_ms = next(r["step_ms"] for r in warm if r["arch"] == "MAX")
    ours = {}
    for ms, n, name in rows:           # the repo's kernels, however small
        m = re.match(r"(?:void )?\(anonymous namespace\)::(\w+)", name)
        if m and m.group(1) in REPO_KERNELS:
            ms0, n0 = ours.get(m.group(1), (0.0, 0))
            ours[m.group(1)] = (ms0 + ms, n0 + n)
    out = {"profiled_wall_ms": wall_ms, "device_busy_ms": busy,
           "unprofiled_step_ms": warm_ms, "top": rows[:15],
           "repo_kernels": ours}
    if busy == 0:
        print(f"[{tag}] profiler: no device time seen")
        return out
    print(f"[{tag}] profile MAX step: device busy {busy:.1f} ms; step "
          f"{warm_ms:.1f} ms unprofiled (idle share {1 - busy / warm_ms:.3f})"
          f", {wall_ms:.1f} ms profiled")
    for ms, count, name in rows[:12]:
        print(f"[{tag}]   {ms:8.2f} ms  x{count:<4d} {name[:90]}")
    print(f"[{tag}] the repo's kernels in that step: " + ", ".join(
        f"{k} {ms:.3f} ms x{n} ({ms / n:.4f} a launch)"
        for k, (ms, n) in ours.items()))
    return out


def phase_eval(ctx):
    import torch
    from gaiaseg_tpu_torch.archspace import build_model_sampler
    from gaiaseg_tpu_torch.data import SyntheticDataset
    from gaiaseg_tpu_torch.engine import evaluate_arch
    from gaiaseg_tpu_torch.models import encode_arch, model_max_arch
    from gaiaseg_tpu_torch.ops.cuda import LAUNCHES, reset_launches
    cfg = ctx.get("cfg") or _flagship_cfg()
    model = (ctx.get("model") or _build_model(cfg)).eval()
    ds = SyntheticDataset(length=2, size=(1024, 2048), num_classes=19,
                          seed=1, cells=8)
    max_arch = model_max_arch(cfg["model"])
    reset_launches()
    results = {}
    for meta in build_model_sampler(cfg["val_sampler"]).traverse():
        arch = encode_arch(max_arch, meta)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = evaluate_arch(model, ds, arch, cfg["img_norm_cfg"], "cuda")
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        check(math.isfinite(res["mIoU"]) and 0.0 <= res["mIoU"] <= 1.0,
              f"eval {meta['name']}: mIoU {res['mIoU']}")
        results[meta["name"]] = {"mIoU": res["mIoU"], "aAcc": res["aAcc"],
                                 "seconds": dt}
        print(f"[eval] {meta['name']}: mIoU {res['mIoU']:.4f} aAcc "
              f"{res['aAcc']:.4f} on 2 images 1024x2048 in {dt:.2f}s")
    with torch.no_grad(), torch.autocast("cuda", dtype=torch.bfloat16):
        img = torch.zeros(1, 3, 1024, 2048, device="cuda")
        pred = model.simple_test(img, encode_arch(max_arch, meta))
    check(tuple(pred.shape) == (1, 1024, 2048), f"eval: shape {pred.shape}")
    ctx["eval"] = results
    ctx["eval_launches"] = dict(LAUNCHES)   # whole inference runs no kernel
    ctx.pop("model", None)                  # free the card for the ViT


# --------------------------------------------------------------------- #
def _vit_cfg():
    from gaiaseg_tpu_torch.utils import Config
    cfg = Config.fromfile(VIT)
    ade = Config.fromfile(ADE20K)
    cfg.merge_from_dict({
        # the flash gate needs N % 128 == 0: 32x32 patches of a 512x512
        # crop are 1024 tokens, 1025 with the cls token
        "model.backbone.with_cls_token": False,
        # ADE20K's train pipeline (512x512 crops; 19-class synthetic data)
        "data.train": {"type": "SyntheticDataset", "size": [512, 512],
                       "length": 16, "num_classes": 19, "seed": 0,
                       "cells": 8, "pipeline": ade["train_pipeline"],
                       "device_cache": True},
        "data.samples_per_gpu": 8,
        "img_norm_cfg": {"mean": [123.675, 116.28, 103.53],
                         "std": [58.395, 57.12, 57.375], "to_rgb": True},
        "model.test_cfg.mode": "whole",   # slide inference waits
    })
    return cfg


def _set_flash(model, on: bool) -> None:
    from gaiaseg_tpu_torch.models.backbones.elastic_transformer import \
        ElasticMHA
    for m in model.modules():
        if isinstance(m, ElasticMHA):
            m.use_flash = on


def phase_vit_segmentor(ctx):
    """The ViT segmentor's loss and every gradient through the flash
    kernels equal the dense attention route (bf16 autocast, eval-mode BN,
    no dropout); the float32 dense route is printed beside them. Two
    planted faults (K5's dq zeroed, dq halved) must fail the same check."""
    import contextlib
    import torch
    from gaiaseg_tpu_torch.data import SyntheticDataset
    from gaiaseg_tpu_torch.engine import prepare_batch
    from gaiaseg_tpu_torch.models import encode_arch, model_max_arch
    from gaiaseg_tpu_torch.ops.cuda import LAUNCHES, reset_launches
    from gaiaseg_tpu_torch.ops.cuda import flash_attention as fa

    @contextlib.contextmanager
    def dq_scaled(scale):
        """The autograd backward's dq multiplied by ``scale`` (None: no
        fault)."""
        real = fa.flash_bwd_dq
        if scale is not None:
            fa.flash_bwd_dq = lambda *args: real(*args) * scale
        try:
            yield
        finally:
            fa.flash_bwd_dq = real

    cfg = _vit_cfg()
    model = _build_model(cfg).eval()
    ds = SyntheticDataset(length=VIT_CHECK_BATCH, size=(512, 512),
                          num_classes=19, seed=5, cells=8)
    img, gt = prepare_batch([ds[i] for i in range(VIT_CHECK_BATCH)],
                            cfg["img_norm_cfg"], "cuda")
    gt[:, :8] = 255
    arch = encode_arch(model_max_arch(cfg["model"]))
    res = {}
    faults = {"dq x0": 0.0, "dq x0.5": 0.5}
    for route, flash, bf16, fault in (
            ("flash", True, True, None), ("dense", False, True, None),
            ("dense f32", False, False, None),
            *((f"flash, {k}", True, True, s) for k, s in faults.items())):
        _set_flash(model, flash)
        model.zero_grad(set_to_none=True)
        reset_launches()
        with torch.autocast("cuda", dtype=torch.bfloat16, enabled=bf16):
            total, _ = model.forward_train(img, gt, arch)
        with dq_scaled(fault):
            total.backward()
        torch.cuda.synchronize()
        res[route] = (float(total.detach()), dict(LAUNCHES), {
            k: p.grad.float().clone() for k, p in model.named_parameters()
            if p.grad is not None})
    _set_flash(model, True)
    check(all(res["flash"][1][k] == 12 for k in FLASH_KERNELS)
          and not any(res["dense"][1][k] for k in FLASH_KERNELS),
          f"vit_segmentor: flash launches {res['flash'][1]}, dense "
          f"{res['dense'][1]}")

    def dist(a, b):
        """(loss rel, worst per-tensor grad max|d|/max|ref|, its tensor)"""
        (la, _, ga), (lb, _, gb) = res[a], res[b]
        check(set(ga) == set(gb), f"vit_segmentor: {a} and {b} reach "
              "different parameters")
        worst = max((float((ga[k] - gb[k]).abs().max())
                     / max(float(gb[k].abs().max()), 1e-30), k) for k in gb)
        return abs(la - lb) / abs(lb), worst[0], worst[1]

    def per_tensor(a, b):
        ga, gb = res[a][2], res[b][2]
        return {k: float((ga[k] - gb[k]).abs().max())
                / max(float(gb[k].abs().max()), 1e-30) for k in gb}

    spread = sorted(per_tensor("flash", "dense").items(),
                    key=lambda kv: -kv[1])
    rel, worst, name = dist("flash", "dense")
    ref_rel, ref_worst, ref_name = dist("dense", "dense f32")
    planted = {k: dist(f"flash, {k}", "dense")[1:] for k in faults}
    ctx["vit_segmentor"] = {"loss": {k: v[0] for k, v in res.items()},
                            "flash_vs_dense": [rel, worst, name],
                            "dense_vs_f32": [ref_rel, ref_worst, ref_name],
                            "planted_vs_dense": planted,
                            "flash_vs_dense_per_tensor": dict(spread)}
    print(f"[vit_segmentor] MAX {VIT_CHECK_BATCH}x512x512 bf16: loss flash {res['flash'][0]:.6f}"
          f" dense {res['dense'][0]:.6f} (rel {rel:.2e}); worst per-tensor "
          f"grad max|d|/max|ref| {worst:.2e} ({name}) over "
          f"{len(res['dense'][2])} tensors; dense bf16 vs dense float32: loss "
          f"rel {ref_rel:.2e}, grads {ref_worst:.2e} ({ref_name})")
    print("[vit_segmentor] flash vs dense, the five worst tensors: "
          + ", ".join(f"{k} {v:.2e}" for k, v in spread[:5])
          + f"; median {spread[len(spread) // 2][1]:.2e}; worst in the "
          "backbone " + next(f"{k} {v:.2e}" for k, v in spread
                             if k.startswith("backbone.")))
    for k, (w, n) in planted.items():
        print(f"[vit_segmentor] planted fault {k}: worst per-tensor grad "
              f"max|d|/max|ref| {w:.2e} ({n})")
    check(rel <= VIT_LOSS_RTOL and worst <= VIT_GRAD_RTOL,
          f"vit_segmentor: flash vs dense loss rel {rel:.2e}, worst grad "
          f"{worst:.2e} (tolerances {VIT_LOSS_RTOL}, {VIT_GRAD_RTOL})")
    check(all(w > VIT_GRAD_RTOL for w, _ in planted.values()),
          f"vit_segmentor: a planted fault passes the gradient tolerance "
          f"{VIT_GRAD_RTOL}: {planted}")


def phase_vit_train(ctx):
    import torch
    from gaiaseg_tpu_torch.archspace import build_model_sampler
    from gaiaseg_tpu_torch.engine import train_segmentor
    from gaiaseg_tpu_torch.models import encode_arch, model_max_arch
    from gaiaseg_tpu_torch.ops.cuda import LAUNCHES, reset_launches
    torch.cuda.empty_cache()
    cfg = _vit_cfg()
    torch.backends.cudnn.benchmark = False
    model = _build_model(cfg)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[vit_train] elastic-ViT supernet: {n_params / 1e6:.2f} M "
          "parameters, embed 768, depth 12, 12 heads, FFN 3072, patch 16, "
          "neck 768 x4, UPer 512 + FCN aux 256, AdamW + clip 1.0")
    # the cycle's archs: a fresh sampler draws what train_segmentor's will
    sampler = build_model_sampler(cfg["train_sampler"])
    metas = [sampler.sample() for _ in range(VIT_ITERS)]
    max_arch = model_max_arch(cfg["model"])
    depths = [encode_arch(max_arch, m)["backbone"]["encoder"]["depth"]
              for m in metas]
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    history = train_segmentor(model, cfg, device="cuda", max_iters=VIT_ITERS,
                              seed=0, log=lambda s: print(f"[vit_train] {s}"))
    launches = dict(LAUNCHES)
    ctx["vit_launches"] = launches
    names = [r["arch"] for r in history]
    check(names == [m.get("name", "random") for m in metas]
          == ["MAX", "MIN", "random", "random"],
          f"vit_train: arch sequence {names}")
    check(all(math.isfinite(r["loss"]) for r in history),
          f"vit_train: non-finite loss in {[r['loss'] for r in history]}")
    for k in FLASH_KERNELS:
        check(launches[k] == sum(depths),
              f"vit_train: {k} launched {launches[k]} times, want the sum of "
              f"the active depths {depths} = {sum(depths)}")
    for k in ("resize_ce_fwd", "resize_ce_bwd"):
        check(launches[k] == 2 * len(history),
              f"vit_train: {k} launched {launches[k]} times in "
              f"{len(history)} iterations (want 2 per iteration)")
    warm = train_segmentor(model, cfg, device="cuda", max_iters=VIT_ITERS,
                           seed=0)

    def img_per_s(hist):
        return 8 * len(hist) / (sum(r["step_ms"] for r in hist) / 1e3)

    t = ctx["vit_train"] = {
        "history": history, "warm_history": warm, "depths": depths,
        "cold_img_per_s": img_per_s(history),
        "warm_img_per_s": img_per_s(warm),
        "warm_wall_img_per_s": 8 * len(warm) / (sum(
            r["step_ms"] + r["data_ms"] for r in warm) / 1e3),
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    ctx["vit_profile"] = _profile_max_step(model, cfg, warm, "vit_train")
    ctx["vit_model"], ctx["vit_cfg"] = model, cfg
    print(f"[vit_train] launches {launches} over {len(history)} iterations "
          f"(active depths {depths})")
    print("[vit_train] warm cycle step ms: " + ", ".join(
        f"{r['arch']} {r['step_ms']:.1f}" for r in warm))
    print(f"[vit_train] device step img/s over the cycle: first "
          f"{t['cold_img_per_s']:.2f}, warm {t['warm_img_per_s']:.2f}; warm "
          f"with the data wait {t['warm_wall_img_per_s']:.2f}; on "
          f"{ctx['nvidia_smi']}; peak memory {t['peak_mem_gb']:.2f} GB")
    t.update(_steady_step_ms(model, cfg, warm, "vit_train"))


def phase_vit_eval(ctx):
    import torch
    from gaiaseg_tpu_torch.archspace import build_model_sampler
    from gaiaseg_tpu_torch.data import SyntheticDataset
    from gaiaseg_tpu_torch.engine import evaluate_arch
    from gaiaseg_tpu_torch.models import encode_arch, model_max_arch
    from gaiaseg_tpu_torch.ops.cuda import LAUNCHES, reset_launches
    cfg = ctx.get("vit_cfg") or _vit_cfg()
    model = (ctx.get("vit_model") or _build_model(cfg)).eval()
    ds = SyntheticDataset(length=4, size=(512, 512), num_classes=19, seed=1,
                          cells=8)
    max_arch = model_max_arch(cfg["model"])
    results = {}
    for meta in build_model_sampler(cfg["val_sampler"]).traverse():
        arch = encode_arch(max_arch, meta)
        depth = arch["backbone"]["encoder"]["depth"]
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = evaluate_arch(model, ds, arch, cfg["img_norm_cfg"], "cuda")
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = dict(LAUNCHES)
        check(math.isfinite(res["mIoU"]) and 0.0 <= res["mIoU"] <= 1.0,
              f"vit_eval {meta['name']}: mIoU {res['mIoU']}")
        check(launches["flash_fwd"] == depth * len(ds)
              and launches["flash_bwd_dkv"] == launches["flash_bwd_dq"] == 0,
              f"vit_eval {meta['name']}: launches {launches}, want flash_fwd "
              f"{depth} per forward x {len(ds)} images and no backward")
        results[meta["name"]] = {"mIoU": res["mIoU"], "aAcc": res["aAcc"],
                                 "seconds": dt, "launches": launches}
        print(f"[vit_eval] {meta['name']}: mIoU {res['mIoU']:.4f} aAcc "
              f"{res['aAcc']:.4f} on {len(ds)} images 512x512 in {dt:.2f}s; "
              f"flash_fwd {launches['flash_fwd']} launches (depth {depth})")
    ctx["vit_eval"] = results


# --------------------------------------------------------------------- #
REPLACES = {
    "resize_ce_fwd": "gaiaseg_tpu/ops/pallas/resize_ce.py:109 (_fwd_kernel "
                     "via _sums :175)",
    "resize_ce_bwd": "gaiaseg_tpu/ops/pallas/resize_ce.py:128 (_bwd_kernel "
                     "via _frc_bwd :237)",
    "flash_fwd": "gaiaseg_tpu/ops/pallas/flash_attention.py:33 (_fa_kernel "
                 "via _flash_fwd :80)",
    "flash_bwd_dkv": "gaiaseg_tpu/ops/pallas/flash_attention_bwd.py:29 "
                     "(_dkv_kernel via flash_attention_bwd :109)",
    "flash_bwd_dq": "gaiaseg_tpu/ops/pallas/flash_attention_bwd.py:72 "
                    "(_dq_kernel via flash_attention_bwd :159)",
}


def kernels_line(ctx):
    """One entry per kernel. K1/K2: times per flagship train step (its
    decode-loss and aux-loss launches added), launches from the flagship
    train run. K3-K5: times per launch at the ViT train shape, launches
    from the ViT train cycle."""
    out = []
    timings = ctx.get("kernel_timings", {})
    for k in ("resize_ce_fwd", "resize_ce_bwd"):
        rows = [t[k] for t in timings.values()]

        def total(field):
            return sum(r[field] for r in rows) if rows else None
        ops_ms, bytes_ms = total("ops_ms"), total("bytes_ms")
        out.append({
            "name": k, "route": "cuda",
            "source": "gaiaseg_tpu_torch/csrc/resize_ce.cu",
            "replaces": REPLACES[k],
            "launches": ctx.get("launches", {}).get(k),
            "max_abs_err": ctx.get("max_abs_err", {}).get(k),
            "ms": total("ms"), "plain_ms": total("plain_ms"),
            "bound_ms": total("bound_ms") if rows else None,
            "bound_by": None if not rows else (
                "operations" if ops_ms > bytes_ms else "bytes"),
            "library_ms": total("library_ms"),
        })
    timings = ctx.get("flash_timings", {})
    for k in FLASH_KERNELS:
        r = timings.get(k, {})
        out.append({
            "name": k, "route": "cuda",
            "source": "gaiaseg_tpu_torch/csrc/flash_attention.cu",
            "replaces": REPLACES[k],
            "launches": ctx.get("vit_launches", {}).get(k),
            "max_abs_err": ctx.get("flash_max_abs_err", {}).get(k),
            "ms": r.get("ms"), "plain_ms": r.get("plain_ms"),
            "bound_ms": r.get("bound_ms"),
            "bound_by": None if not r else (
                "operations" if r["ops_ms"] > r["bytes_ms"] else "bytes"),
            "library_ms": r.get("library_ms"),
        })
    return {"kernels": out}


def main(argv) -> int:
    phases = argv or list(PHASES)
    bad = [p for p in phases if p not in PHASES]
    if bad:
        print(f"unknown phases {bad}; choose from {PHASES}", file=sys.stderr)
        return 2
    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke: no torch ({e})", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device; the port's smoke runs "
              "only on the card", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    try:
        import gaiaseg_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port package is missing beside this file "
              f"({e})", file=sys.stderr)
        return 1
    for path in (FLAGSHIP, VIT, ADE20K):
        if not os.path.isfile(path):
            print(f"chip_smoke: config missing: {path}", file=sys.stderr)
            return 1
    ctx = {}
    if "device" not in phases:
        phases = ["device"] + phases
    for p in phases:
        t0 = time.perf_counter()
        try:
            globals()[f"phase_{p}"](ctx)
        except SmokeFailure as e:
            print(f"[{p}] FAIL: {e}")
            return 1
        torch.cuda.synchronize()
        print(f"[{p}] ok in {time.perf_counter() - t0:.1f}s")
    os.makedirs(OUT_DIR, exist_ok=True)
    line = kernels_line(ctx)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump({"nvidia_smi": ctx["nvidia_smi"], "tf32": ctx["tf32"],
                   "build_seconds": ctx.get("build_seconds"),
                   "ptxas": ctx.get("ptxas"),
                   "ptxas_warnings": ctx.get("ptxas_warnings"),
                   "kernel_timings": ctx.get("kernel_timings"),
                   "kernel_checks": ctx.get("kernel_checks"),
                   "flash_checks": ctx.get("flash_checks"),
                   "launches": ctx.get("launches"),
                   "train": ctx.get("train"), "profile": ctx.get("profile"),
                   "eval": ctx.get("eval"),
                   "flash_timings": ctx.get("flash_timings"),
                   "flash_forward": ctx.get("flash_forward"),
                   "flash_backward": ctx.get("flash_backward"),
                   "flash_max_abs_err": ctx.get("flash_max_abs_err"),
                   "vit_segmentor": ctx.get("vit_segmentor"),
                   "vit_launches": ctx.get("vit_launches"),
                   "vit_train": ctx.get("vit_train"),
                   "vit_profile": ctx.get("vit_profile"),
                   "vit_eval": ctx.get("vit_eval"),
                   "data": ctx.get("data"),
                   "kernels": line["kernels"]}, f, indent=2, default=str)
    print(json.dumps(line))
    print(ctx["nvidia_smi"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
