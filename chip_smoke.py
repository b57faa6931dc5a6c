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
7. eval     ``evaluate`` (whole mode, the flagship's test_cfg) at the val
            anchors R50/R77/R101 on two synthetic 1024x2048 images, read
            through the loader and the prefetch thread, confusion-matrix
            mIoU.
8. loop     the flagship workflow around the step at full width: 16
            iterations at log interval 8 (silent steps between), the val
            workflow [('train', 8), ('val', 1)] on two 1024x2048 records,
            BN calibration and a checkpoint at 8 and 16, the cross-arch eval
            at 16; K1 2 x 16 + 2 x 2 launches, K2 2 x 16; a fresh model
            resumed from iter_8.pth bit-equal to the file (weights, BN
            statistics, momentum) and run on to 16 at the same LRs; then
            ``tools/test_supernet.py`` on iter_16.pth (the val anchors and
            two draws, --vmap 5 --bn-calibrate 2), its last subnet equal to
            ``evaluate`` alone on the statistics calibration gives it.
9. subnets  the subnet half of the NAS workflow on the flagship at full
            width: ``tools/count_flops.py`` on the flagship FLOPs sampler,
            shard 0 of 16 (37,316 of its 597,051 subnets; subnets/s on the
            host) and the flagship rules over it (a non-empty selection);
            a supernet .pth from seed 0 with BN calibrated at MAX over 2
            batches; ``tools/extract_subnet.py`` for R50, R101 and
            RSPECIFIC (files md5(meta)[:8].pth, MB and seconds), each
            subnet's parameter count equal to the analytic one and its
            float32 logits on a 512x1024 image within 1e-4 of max|ref| of
            the supernet's at its arch; ``tools/finetune_supernet.py`` (the
            ft2e schedule) on the first 2 rule-selected subnets for 4
            iterations each, K1 and K2 16 launches each, finite losses and
            mIoU, seconds per subnet split into steps, checkpoint and eval;
            the second subnet's first loss equal to that subnet fine-tuned
            alone from the checkpoint; a rerun that skips both and launches
            nothing.
10. deeplab the DeepLabV3+ supernet (``configs/_dynamic_/models/
            deeplabv3plus_ar50to101v2.py``: widths 80/160/320/640, depths
            4/6/29/4, output stride 8, separable ASPP 512 at 12/24/36, c1
            48, FCN aux) and the v1c PSP supernet (deep stem 32/32/64) at
            full width: K1 and K2 at this path's loss shapes (decode logits
            128x256, row factor 4; aux 64x128, factor 8) against their
            plain versions in float32 and bf16, each twice bit-equal, and
            their times; one flagship sandwich cycle of the DeepLabV3+
            supernet at batch 8 (K1 and K2 16 launches each), the warm
            cycle, the least step times over three warm cycles, a profiled
            MAX step, peak memory; its slide eval at R50 (crop 512x1024,
            stride 341x683: 9 windows of two 1024x2048 records), seconds an
            image in bf16 and the float32 mIoU within 1e-4 of the CPU's on
            the same weights and records; one v1c MAX step (K1/K2 2/2);
            extraction of the DeepLabV3+ R50 and of R50v1c and R101v1c
            (``configs/local_examples/extract_subnet/psp_ar50to101_v1c_
            extract.py``), each subnet's float32 logits on a 512x1024 image
            bit-equal to the supernet's at its arch and its parameters
            equal to the analytic count (the backbone's for DeepLabV3+,
            whose head the FLOPs sweep does not count); MB, FLOPs.
11. ddp     data parallelism on the one card (NCCL refuses two ranks on one
            device): 2 ranks over gloo sharing cuda:0, each at 4 of the
            flagship's batch of 8: one float32 MAX step (autocast and TF32
            off) against one process's batch-8 step from the same weights
            (loss within 1e-5 relative, each gradient within 1e-3 of its
            max); one bf16 sandwich cycle through ``train_segmentor`` (K1
            and K2 16 launches on each rank, the gradient all-reduce's ms
            and MB a step, one checkpoint from rank 0, weights, BN
            statistics and momenta equal on both ranks by checksums); a
            sharded eval of two 1024x2048 records at R50 equal to one
            process's. Then ``python -m torch.distributed.run
            --nproc_per_node 1`` of the train CLI on the flagship for 8
            iterations: an NCCL group of world size 1, finite losses.
12. flash_kernels  K3 (``flash_fwd``), K4 (``flash_bwd_dkv``) and K5
            (``flash_bwd_dq``) against their plain torch versions at the ViT
            shape [8, 1024, 12, 64] in bf16 and float32, at N = 1025, 200
            (ragged tails), 1088 (a half-empty last 128-row block), 64 (one
            tile) and 129 (a block with one real row) and on all-zero
            q/k/v; each run twice must agree bit for bit. Then their times
            beside the plain version, SDPA and the bound, K3 beside SDPA's
            forward and the port's whole attention backward
            (``attention_di`` + K4 + K5) beside SDPA's backward, in turns.
13. vit_segmentor  the elastic-ViT segmentor's loss and gradients through
            the flash kernels equal the dense attention route (bf16, a
            batch of 8); two planted faults in dq (zeroed, halved) must
            fail that check.
14. vit_train  one sandwich cycle (MAX, MIN, 2 random) of the elastic-ViT
            UPerNet supernet (``configs/_dynamic_/models/upernet_elastic_
            vit.py`` with ``with_cls_token=False``, so the flash gate opens)
            at full width, synthetic 512x512 records kept on the card
            through ADE20K's train pipeline (512x512 crops), batch 8, AdamW
            + clip;
            K3-K5 must each launch once per active layer, K1/K2 twice per
            iteration. Then the cycle again for warm times, a profiled
            MAX step, and the least step times over three warm cycles.
15. vit_eval  the config's slide mode (crop 512, stride 341: 1 x 3 windows
            of four synthetic 512x1024 images, one forward an image) at the
            val anchors MIN and MAX, then flip, multi-scale (0.75, 1.0) and
            whole runs at MAX, seconds an image each; flash_fwd launches
            once a layer a forward, K4/K5 never. Then the slide logits
            (float32, flash off) within 1e-4 of max|ref| of a slide built
            from each window's whole inference.

The train phases (``train``, ``data``, ``vit_train``) run at log interval
1: every step is a full step (BN statistics updated) and synchronized, so
its time is the step's.

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
          "eval", "loop", "subnets", "deeplab", "ddp", "flash_kernels",
          "vit_segmentor", "vit_train", "vit_eval")
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
        # every step a full, synchronized one: each row is one step
        "log_config.interval": 1,
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
                                       max_iters=len(warm), seed=0)[1]["loss"]
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
                              seed=0, log=lambda s: print(f"[train] {s}")
                              )[1]["loss"]
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
    warm = train_segmentor(model, cfg, device="cuda", max_iters=8,
                           seed=0)[1]["loss"]
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
                           log=lambda s: print(f"[data] {tag} {s}")
                           )[1]["loss"]
    launches = dict(LAUNCHES)
    warm = train_segmentor(model, cfg, device="cuda", max_iters=8,
                           seed=0)[1]["loss"]
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


def _test_params(cfg):
    """The Normalize mean and std of the config's test pipeline (the ViT's
    model-only config has none: its ``img_norm_cfg``)."""
    from gaiaseg_tpu_torch.data import (TestPipelineParams,
                                        parse_test_pipeline)
    val = (cfg.get("data") or {}).get("val")
    if val and val.get("pipeline"):
        return parse_test_pipeline(val["pipeline"])
    norm = cfg["img_norm_cfg"]
    return TestPipelineParams(mean=tuple(norm["mean"]),
                              std=tuple(norm["std"]))


def phase_eval(ctx):
    import torch
    from gaiaseg_tpu_torch.archspace import build_model_sampler
    from gaiaseg_tpu_torch.data import SyntheticDataset
    from gaiaseg_tpu_torch.engine import evaluate
    from gaiaseg_tpu_torch.models import encode_arch, model_max_arch
    from gaiaseg_tpu_torch.ops.cuda import LAUNCHES, reset_launches
    cfg = ctx.get("cfg") or _flagship_cfg()
    model = (ctx.get("model") or _build_model(cfg)).eval()
    ds = SyntheticDataset(length=2, size=(1024, 2048), num_classes=19,
                          seed=1, cells=8)
    max_arch = model_max_arch(cfg["model"])
    test_params = _test_params(cfg)
    reset_launches()
    results = {}
    for meta in build_model_sampler(cfg["val_sampler"]).traverse():
        arch = encode_arch(max_arch, meta)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = evaluate(model, ds, arch, test_params=test_params,
                       device="cuda")
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
    ctx.pop("model", None)                  # free the card for the loop


# the loop phase: the flagship workflow around the step
LOOP_ITERS, LOOP_LOG, LOOP_CKPT, LOOP_EVAL = 16, 8, 8, 16
LOOP_VAL_RECORDS, LOOP_SUBNETS, LOOP_CALIB = 2, 5, 2


def _loop_cfg():
    """The flagship config at log interval 8 (silent steps between), a
    checkpoint every 8 iterations, the cross-arch eval at 16 and the val
    workflow [('train', 8), ('val', 1)]; val data: synthetic 1024x2048
    records through the config's test pipeline."""
    cfg = _flagship_cfg()
    cfg.merge_from_dict({
        "data.val": {"type": "SyntheticDataset", "size": [1024, 2048],
                     "length": LOOP_VAL_RECORDS, "num_classes": 19,
                     "seed": 1, "cells": 8},
        "runner.max_iters": LOOP_ITERS,
        "log_config.interval": LOOP_LOG,
        "checkpoint_config.interval": LOOP_CKPT,
        "evaluation.interval": LOOP_EVAL,
        "workflow": [["train", LOOP_CKPT], ["val", 1]],
    })
    return cfg


def _seconds(lines, pattern):
    return [float(m.group(1)) for m in map(re.compile(pattern).search, lines)
            if m]


def _cpu_state(sd):
    return {k: v.detach().cpu() for k, v in sd.items()}


def phase_loop(ctx):
    """The flagship supernet workflow around the step at full width:
    16 iterations with silent steps, two checkpoints (BN calibrated), the
    val workflow, the cross-arch eval; a resume from the first checkpoint;
    then test_supernet on the last one."""
    import shutil
    import tempfile
    import torch
    from gaiaseg_tpu_torch.archspace import build_model_sampler
    from gaiaseg_tpu_torch.data import build_dataset
    from gaiaseg_tpu_torch.engine import (calibrate_bn, evaluate,
                                          init_segmentor, train_segmentor)
    from gaiaseg_tpu_torch.ops.cuda import LAUNCHES, reset_launches
    from gaiaseg_tpu_torch.tools import test_supernet
    cfg = _loop_cfg()
    torch.backends.cudnn.benchmark = False
    tmp = tempfile.mkdtemp(prefix="gseg_loop_")
    out = ctx["loop"] = {}
    try:
        wd = os.path.join(tmp, "run")
        lines = []

        def log(msg):
            lines.append(msg)
            print(f"[loop] {msg}")

        model = _build_model(cfg)
        reset_launches()
        t0 = time.perf_counter()
        state, _ = train_segmentor(model, cfg, work_dir=wd, device="cuda",
                                   seed=0, log=log)
        torch.cuda.synchronize()
        out["seconds"] = time.perf_counter() - t0
        launches = out["launches"] = dict(LAUNCHES)
        ckpts = {n: os.path.join(wd, f"iter_{n}.pth")
                 for n in range(LOOP_CKPT, LOOP_ITERS + 1, LOOP_CKPT)}
        latest = os.path.join(wd, "latest.pth")
        check(state.step == LOOP_ITERS
              and all(os.path.isfile(p) for p in ckpts.values())
              and os.path.islink(latest) and os.path.realpath(latest)
              == os.path.realpath(ckpts[LOOP_ITERS]),
              f"loop: step {state.step}, files {sorted(os.listdir(wd))}")
        with open(os.path.join(wd, "history.json")) as f:
            hist = json.load(f)
        out["history"] = hist
        anchors = [m["name"] for m in
                   build_model_sampler(cfg["val_sampler"]).traverse()]
        check(len(hist["loss"]) == LOOP_ITERS // LOOP_LOG
              and all(math.isfinite(r["loss"]) for r in hist["loss"]),
              f"loop: loss windows {hist['loss']}")
        check(len(hist["val_loss"]) == LOOP_ITERS // LOOP_CKPT
              and all(math.isfinite(r["loss"]) for r in hist["val_loss"]),
              f"loop: val_loss rows {hist['val_loss']}")
        check(len(hist["eval"]) == 1
              and sorted(hist["eval"][0]["metrics"]) == sorted(anchors)
              and all(math.isfinite(m["mIoU"]) for m in
                      hist["eval"][0]["metrics"].values()),
              f"loop: eval rows {hist['eval']}")
        n_val = LOOP_ITERS // LOOP_CKPT
        want = {"resize_ce_fwd": 2 * LOOP_ITERS + 2 * n_val,
                "resize_ce_bwd": 2 * LOOP_ITERS}
        check(all(launches[k] == v for k, v in want.items()),
              f"loop: launches {launches}, want {want} (decode + aux each "
              f"train step, K1 alone in each of the {n_val} val batches)")
        calib_s = _seconds(lines, r"calibrated BN .* in ([\d.]+)s")
        save = [(float(m.group(1)), float(m.group(2))) for m in map(
            re.compile(r"saved .* \(([\d.]+) MB\) in ([\d.]+)s").search,
            lines) if m]
        check(len(calib_s) == len(ckpts) and len(save) == len(ckpts),
              f"loop: {len(calib_s)} calibrations and {len(save)} "
              f"checkpoint writes for {len(ckpts)} checkpoints")
        out.update(calibrate_seconds=calib_s, checkpoint_mb_seconds=save,
                   eval_seconds={k: v["seconds"] for k, v in
                                 hist["eval"][0]["metrics"].items()})
        print(f"[loop] {LOOP_ITERS} iterations in {out['seconds']:.1f}s: "
              f"BN calibration ({cfg['data']['samples_per_gpu']} x 8 "
              "records 512x1024 at MAX) " + ", ".join(
                  f"{x:.2f}s" for x in calib_s) + "; checkpoint writes "
              + ", ".join(f"{mb:.1f} MB in {x:.2f}s" for mb, x in save)
              + "; cross-arch eval on 2 images 1024x2048: " + ", ".join(
                  f"{k} {v:.2f}s" for k, v in out["eval_seconds"].items())
              + f"; on {ctx['nvidia_smi']}")
        del model, state
        torch.cuda.empty_cache()

        # resume from the first checkpoint: a fresh model (other weights)
        # comes back with what was saved, then goes on to the end
        saved = torch.load(ckpts[LOOP_CKPT], map_location="cpu",
                           weights_only=False)
        torch.manual_seed(1)
        from gaiaseg_tpu_torch.models import build_segmentor
        fresh = build_segmentor(cfg["model"]).cuda()
        wd2 = os.path.join(tmp, "resumed")
        back, _ = train_segmentor(fresh, cfg, work_dir=wd2, device="cuda",
                                  seed=0, resume_from=ckpts[LOOP_CKPT],
                                  max_iters=LOOP_CKPT)
        sd = _cpu_state(fresh.state_dict())
        mom = [_cpu_state(st)["momentum_buffer"] for st in
               back.optimizer.state_dict()["state"].values()]
        mom_saved = [st["momentum_buffer"] for st in
                     saved["optimizer"]["state"].values()]
        check(back.step == LOOP_CKPT and set(sd) == set(saved["state_dict"])
              and all(torch.equal(sd[k], v)
                      for k, v in saved["state_dict"].items())
              and len(mom) == len(mom_saved) > 0
              and all(torch.equal(a, b) for a, b in zip(mom, mom_saved)),
              "loop: the resumed model's weights, BN statistics or momentum "
              "differ from the checkpoint's")
        del saved
        _, hist2 = train_segmentor(fresh, cfg, work_dir=wd2, device="cuda",
                                   seed=0, resume_from=ckpts[LOOP_CKPT],
                                   log=lambda s: print(f"[loop] resumed {s}"))
        lrs = [r["lr"] for r in hist2["loss"]]
        want_lrs = [r["lr"] for r in hist["loss"] if r["iter"] > LOOP_CKPT]
        check(lrs == want_lrs and hist2["loss"][-1]["iter"] == LOOP_ITERS,
              f"loop: resumed LRs {lrs}, unbroken {want_lrs}")
        print(f"[loop] resumed from iter_{LOOP_CKPT}.pth: weights, BN "
              f"statistics and {len(mom)} momentum buffers bit-equal to the "
              f"file; ran to {LOOP_ITERS} at the unbroken run's LRs {lrs}")
        del fresh, back
        shutil.rmtree(wd2, ignore_errors=True)
        torch.cuda.empty_cache()

        # test_supernet on the last checkpoint: the val anchors and two
        # draws of the train sampler, 5 subnets a pass, BN calibrated
        sampler = build_model_sampler(cfg["train_sampler"])
        draws = [sampler.sample() for _ in range(8)][5:7]
        space = list(build_model_sampler(cfg["val_sampler"]).traverse()) \
            + draws
        space_path = os.path.join(tmp, "space.json")
        with open(space_path, "w") as f:
            json.dump(space, f)
        opts = [f"data.{k}={json.dumps(cfg['data'][k])}"
                for k in ("train", "val")]
        t0 = time.perf_counter()
        rows = test_supernet.main([
            FLAGSHIP, ckpts[LOOP_ITERS], "--model-space", space_path,
            "--work-dir", os.path.join(tmp, "ts"),
            "--vmap", str(LOOP_SUBNETS), "--bn-calibrate", str(LOOP_CALIB),
            "--cfg-options", *opts])
        torch.cuda.synchronize()
        ts_s = time.perf_counter() - t0
        with open(os.path.join(tmp, "ts", "test_supernet",
                               "metrics.json")) as f:
            written = json.load(f)
        mious = [r["metric"]["metric"]["mIoU"] for r in written]
        check(len(written) == len(space) == LOOP_SUBNETS == len(rows)
              and all(math.isfinite(x) for x in mious),
              f"loop: test_supernet wrote {len(written)} rows, mIoU {mious}")
        # the last subnet (a random draw) scored alone on the statistics
        # calibration gives it
        seg = init_segmentor(cfg, ckpts[LOOP_ITERS], device="cuda")
        arch = seg.arch(written[-1])
        tp = _test_params(cfg)
        calibrate_bn(seg.model, build_dataset(cfg["data"]["train"], "cuda"),
                     arch, num_batches=LOOP_CALIB, test_params=tp)
        alone = evaluate(seg.model, build_dataset(cfg["data"]["val"], "cuda"),
                         arch, test_params=tp, device="cuda")
        got = written[-1]["metric"]["metric"]
        check(all(got[k] == alone[k] for k in ("mIoU", "mAcc", "aAcc")),
              f"loop: test_supernet --vmap gave {got}, evaluate alone "
              f"{ {k: alone[k] for k in ('mIoU', 'mAcc', 'aAcc')} }")
        out["test_supernet"] = {"seconds": ts_s, "mIoU": mious}
        print(f"[loop] test_supernet --vmap {LOOP_SUBNETS} --bn-calibrate "
              f"{LOOP_CALIB} on iter_{LOOP_ITERS}.pth: {len(written)} "
              f"subnets in {ts_s:.1f}s, mIoU "
              + " ".join(f"{x:.4f}" for x in mious)
              + f"; the last one scored alone: mIoU {alone['mIoU']:.4f} "
              "(equal)")
        del seg
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# the subnets phase: count, filter, extract and fine-tune on the flagship
FLOPS_CFG = os.path.join(REPO, "configs", "local_examples", "count_flops",
                         "psp_ar50to101v2_flops.py")
RULES_CFG = os.path.join(REPO, "configs", "_dynamic_", "rules",
                         "ar50to101v2_rules.py")
EXTRACT_CFGS = [os.path.join(REPO, "configs", "local_examples",
                             "extract_subnet", name)
                for name in ("psp_ar50to101_extract.py",
                             "psp_specific_extract.py")]
FT_CFG = os.path.join(REPO, "configs", "local_examples", "fast_finetune",
                      "psp_ar50to101v2_ft.py")
FLOPS_SHARDS, FLOPS_SHARD_ROWS = 16, 37316   # round-robin shard 0 of 597,051
SUBNET_CALIB = 2          # BN batches at MAX before the supernet .pth
SUBNET_IMAGE = (512, 1024)
SUBNET_RTOL = 1e-4        # extracted subnet vs the supernet at its arch,
                          # float32 with TF32 off (cuDNN picks other conv
                          # algorithms for the narrower shapes)
FT_SUBNETS, FT_ITERS = 2, 4


def _ft_seconds(lines, name):
    """(train s, eval s) of subnet ``name`` from finetune_supernet's line."""
    pat = re.compile(rf"\] {name} mIoU=\S+ \(train ([\d.]+)s, eval "
                     r"([\d.]+)s\)")
    found = [tuple(map(float, m.groups())) for m in map(pat.search, lines)
             if m]
    check(len(found) == 1, f"subnets: no timing line for {name}")
    return found[0]


def phase_subnets(ctx):
    """The subnet half of the NAS workflow on the flagship at full width:
    the analytic FLOPs sweep (shard 0 of 16) and the flagship rules, the
    extraction of R50 / R101 / RSPECIFIC from a calibrated supernet .pth
    (each against its analytic parameter count and the supernet at its
    arch), and the fast-finetune of two rule-selected subnets (K1/K2 16
    launches each, a rerun that skips both, the second subnet's first loss
    equal to that subnet fine-tuned alone)."""
    import shutil
    import tempfile
    import torch
    from gaiaseg_tpu_torch.archspace import (ModelSpace, build_model_sampler,
                                             build_sample_rule, fold_dict,
                                             get_model_complexity_info,
                                             meta_hash)
    from gaiaseg_tpu_torch.data import build_dataset
    from gaiaseg_tpu_torch.engine import (calibrate_bn, configure_numerics,
                                          save_checkpoint, train_segmentor)
    from gaiaseg_tpu_torch.models import (build_segmentor, encode_arch,
                                          model_max_arch)
    from gaiaseg_tpu_torch.models.arch_util import canonical_arch
    from gaiaseg_tpu_torch.ops.cuda import LAUNCHES, reset_launches
    from gaiaseg_tpu_torch.tools import (count_flops, extract_subnet,
                                         finetune_supernet)
    from gaiaseg_tpu_torch.tools.train_supernet import cfg_options_to_dict
    from gaiaseg_tpu_torch.utils import Config
    smi = ctx["nvidia_smi"]
    out = ctx["subnets"] = {}
    configure_numerics()
    torch.backends.cudnn.benchmark = False
    tmp = tempfile.mkdtemp(prefix="gseg_subnets_")
    try:
        # 1. the FLOPs sweep and the rules (host only)
        flops_dir = os.path.join(tmp, "flops")
        n, secs = count_flops.main([
            FLOPS_CFG, "--work-dir", flops_dir, "--shard-id", "0",
            "--num-shards", str(FLOPS_SHARDS)],
            log=lambda s: print(f"[subnets] count_flops {s}"))
        with open(os.path.join(flops_dir, "flops.json")) as f:
            rows = json.load(f)
        check(n == len(rows) == FLOPS_SHARD_ROWS,
              f"subnets: count_flops wrote {n} / {len(rows)} rows, want "
              f"{FLOPS_SHARD_ROWS}")
        band = sum(135e9 <= r["overhead"]["flops"] <= 140e9 for r in rows)
        selected = ModelSpace.load(rows).apply_rule(build_sample_rule(
            Config.fromfile(RULES_CFG)["model_sampling_rules"])).pack()
        check(len(selected) >= FT_SUBNETS,
              f"subnets: the flagship rules selected {len(selected)}")
        out["count_flops"] = {"subnets": n, "seconds": secs,
                              "subnets_per_s": n / secs, "in_band": band,
                              "selected": len(selected)}
        print(f"[subnets] count_flops: shard 0 of {FLOPS_SHARDS} of the "
              f"597,051-subnet flagship space (all traversed): {n} subnets "
              f"in {secs:.2f}s on the host, {n / secs:.0f} subnets/s; {band} "
              f"in the 135-140 GFLOPs band, the rules select "
              f"{len(selected)}; on {smi}")

        # the supernet: seed 0, BN statistics calibrated at MAX
        cfg = _flagship_cfg()
        model = _build_model(cfg)
        max_arch = model_max_arch(cfg["model"])
        train_cfg = cfg["data"]["train"]
        calibrate_bn(model, build_dataset(train_cfg, device="cuda"),
                     encode_arch(max_arch), num_batches=SUBNET_CALIB,
                     batch_size=cfg["data"]["samples_per_gpu"],
                     test_params=_test_params(cfg))
        ckpt = os.path.join(tmp, "supernet.pth")
        save_checkpoint(ckpt, model, meta={"iter": 0, "max_arch": max_arch})
        model.eval()
        print(f"[subnets] supernet .pth (seed 0, BN calibrated at MAX over "
              f"{SUBNET_CALIB} batches): {os.path.getsize(ckpt) / 1e6:.1f} "
              "MB")

        # 2. extraction, each subnet against the analytic count and the
        # supernet at its arch on one synthetic image (float32, TF32 off)
        img = torch.randn(1, 3, *SUBNET_IMAGE, generator=torch.Generator()
                          .manual_seed(0)).cuda()
        out["extract"] = []
        for path in EXTRACT_CFGS:
            ecfg = Config.fromfile(path)
            written = extract_subnet.main([
                path, ckpt, "--work-dir", os.path.join(tmp, "subnets"),
                "--smoke-size", *map(str, SUBNET_IMAGE)])
            names = [m.get("name") for m in
                     build_model_sampler(ecfg["train_sampler"]).traverse()]
            check([r["name"] for r in written] == names,
                  f"subnets: extracted {[r['name'] for r in written]}, want "
                  f"{names}")
            for row in written:
                check(os.path.basename(row["path"])
                      == f"{meta_hash(row['meta'])}.pth",
                      f"subnets: file name {row['path']}")
                saved = torch.load(row["path"], map_location="cuda",
                                   weights_only=False)
                sub_cfg = saved["meta"]["model_cfg"]
                sub = build_segmentor(sub_cfg).cuda()
                sub.load_state_dict(saved["state_dict"], strict=True)
                n_params = sum(p.numel() for p in sub.parameters())
                arch = canonical_arch(max_arch, row["meta"])
                want = get_model_complexity_info(
                    ecfg["model"], arch, (3, *SUBNET_IMAGE))["params"]
                with torch.no_grad():
                    got = sub.eval()(img, encode_arch(model_max_arch(
                        sub_cfg)))
                    ref = model(img, encode_arch(max_arch, row["meta"]))
                err = float((got - ref).abs().max())
                scale = float(ref.abs().max())
                check(n_params == want and torch.isfinite(got).all()
                      and err <= SUBNET_RTOL * scale,
                      f"subnets: {row['name']}: {n_params} parameters "
                      f"(analytic {want:.0f}), logits max|d| {err:.2e} of "
                      f"max|ref| {scale:.2e}")
                out["extract"].append({
                    "name": row["name"], "file": os.path.basename(row["path"]),
                    "mb": row["mb"], "seconds": row["seconds"],
                    "params": n_params, "max_abs_err": err,
                    "max_abs_ref": scale})
                print(f"[subnets] extract {row['name']}: "
                      f"{os.path.basename(row['path'])} {row['mb']:.1f} MB in "
                      f"{row['seconds']:.2f}s (slice, build, "
                      f"{SUBNET_IMAGE[0]}x{SUBNET_IMAGE[1]} smoke forward, "
                      f"write); {n_params} parameters = analytic; "
                      f"logits vs the supernet at the arch (float32) max|d| "
                      f"{err:.2e} of max|ref| {scale:.2e}; on {smi}")
                del saved, sub
        del model
        torch.cuda.empty_cache()

        # 3. fast-finetune: the first rule-selected subnets, 4 iterations
        # each, synthetic train (512x1024, on the card) and val (1024x2048)
        space = os.path.join(tmp, "space.json")
        with open(space, "w") as f:
            json.dump(selected[:FT_SUBNETS], f)
        opts = ["model_sampling_rules=null",
                f"data.train={json.dumps(train_cfg)}",
                "data.val=" + json.dumps({
                    "type": "SyntheticDataset", "size": [1024, 2048],
                    "length": LOOP_VAL_RECORDS, "num_classes": 19, "seed": 1,
                    "cells": 8}),
                f"data.samples_per_gpu={cfg['data']['samples_per_gpu']}",
                "log_config.interval=1"]
        argv = [FT_CFG, ckpt, "--model-space", space, "--work-dir",
                os.path.join(tmp, "ft"), "--max-iters", str(FT_ITERS),
                "--cfg-options", *opts]
        lines = []

        def log(msg):
            lines.append(msg)
            print(f"[subnets] finetune {msg}")

        reset_launches()
        t0 = time.perf_counter()
        rows = finetune_supernet.main(argv, log=log)
        torch.cuda.synchronize()
        ft_s = time.perf_counter() - t0
        launches = dict(LAUNCHES)
        want = {"resize_ce_fwd": FT_SUBNETS * FT_ITERS * 2,
                "resize_ce_bwd": FT_SUBNETS * FT_ITERS * 2}
        check(all(launches[k] == v for k, v in want.items()),
              f"subnets: finetune launches {launches}, want {want} (decode "
              "+ aux each step; the eval runs no loss)")
        mious = [r["metric"]["fastft_metric"]["mIoU"] for r in rows]
        check(len(rows) == FT_SUBNETS and all(map(math.isfinite, mious)),
              f"subnets: fastft_metrics.json rows {len(rows)}, mIoU {mious}")
        per = []
        for i in range(FT_SUBNETS):
            with open(os.path.join(tmp, "ft", f"subnet_{i}",
                                   "history.json")) as f:
                hist = json.load(f)["loss"]
            check(len(hist) == FT_ITERS
                  and all(r["arch"] == f"subnet_{i}" for r in hist)
                  and all(math.isfinite(r["loss"]) for r in hist),
                  f"subnets: subnet_{i} history {hist}")
            train_s, eval_s = _ft_seconds(lines, f"subnet_{i}")
            save = _seconds([x for x in lines
                             if f"subnet_{i}{os.sep}iter_" in x],
                            r"saved .* in ([\d.]+)s")
            steps_s = sum(r["step_ms"] + r["data_ms"] for r in hist) / 1e3
            per.append({"train_s": train_s, "steps_s": steps_s,
                        "checkpoint_s": save[0], "eval_s": eval_s,
                        "first_loss": hist[0]["loss"],
                        "losses": [r["loss"] for r in hist]})
            print(f"[subnets] finetune subnet_{i}: {train_s:.2f}s in the "
                  f"loop ({FT_ITERS} steps {steps_s:.2f}s, final checkpoint "
                  f"{save[0]:.2f}s, the rest the load_from), eval of "
                  f"{LOOP_VAL_RECORDS} images 1024x2048 {eval_s:.2f}s; "
                  f"losses " + " ".join(f"{x:.4f}" for x in per[-1]["losses"])
                  + f", mIoU {mious[i]:.4f}; on {smi}")
        out["finetune"] = {"seconds": ft_s, "launches": launches,
                           "subnets": per, "mIoU": mious}

        # the second subnet alone, from a fresh model and a fresh load of
        # the checkpoint: its first loss is the sweep's
        ftcfg = Config.fromfile(FT_CFG)
        ftcfg.merge_from_dict(cfg_options_to_dict(opts))
        anchor = dict(selected[1])
        torch.manual_seed(1)
        fresh = build_segmentor(ftcfg["model"]).cuda()
        alone = train_segmentor(
            fresh, ftcfg, device="cuda", train_sampler=build_model_sampler(
                dict(type="anchor", anchors=[dict(fold_dict(anchor),
                                                  name="subnet_1")])),
            max_iters=1, seed=0, load_from=ckpt)[1]["loss"][0]["loss"]
        check(alone == per[1]["first_loss"],
              f"subnets: subnet_1's first loss {per[1]['first_loss']!r} in "
              f"the sweep, {alone!r} alone")
        del fresh
        torch.cuda.empty_cache()

        # a rerun finds both done: nothing trained, no kernel launched
        reset_launches()
        again = finetune_supernet.main(argv, log=log)
        check(again == rows and not any(LAUNCHES.values())
              and sum("already finetuned" in x for x in lines) == FT_SUBNETS,
              f"subnets: the rerun launched {dict(LAUNCHES)}")
        print(f"[subnets] finetune of {FT_SUBNETS} subnets in {ft_s:.1f}s: "
              f"K1/K2 {launches['resize_ce_fwd']}/{launches['resize_ce_bwd']}"
              f" launches; subnet_1 alone from the checkpoint: first loss "
              f"{alone:.6f} (equal); the rerun skipped both, launching "
              f"nothing; on {smi}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# --------------------------------------------------------------------- #
# the deeplab phase: the DeepLabV3+ and v1c supernets at full width
DEEPLAB = os.path.join(REPO, "configs", "_dynamic_", "models",
                       "deeplabv3plus_ar50to101v2.py")
V1C = os.path.join(REPO, "configs", "_dynamic_", "models",
                   "pspnet_ar50to101_v1c.py")
V1C_EXTRACT = os.path.join(REPO, "configs", "local_examples",
                           "extract_subnet", "psp_ar50to101_v1c_extract.py")
DEEPLAB_BATCH = 8
# K1/K2 at the DeepLabV3+ losses: decode logits at the c1 level (128x256,
# row factor 4), aux logits at output stride 8 (64x128, row factor 8)
DEEPLAB_LOSSES = {"dl_decode": (8, 19, 128, 256, 512, 1024),
                  "dl_aux": (8, 19, 64, 128, 512, 1024)}
SLIDE_RECORDS, SLIDE_SIZE = 2, (1024, 2048)   # crop 512x1024, 9 windows
SLIDE_MIOU_ATOL = 1e-4     # float32 slide mIoU, card vs CPU: the same
                           # sums in another order flip only near-ties


def _model_cfg(path, base):
    """``base`` (the flagship's train setup) with ``path``'s model."""
    import copy
    from gaiaseg_tpu_torch.utils import Config
    cfg = copy.deepcopy(base)
    cfg["model"] = Config.fromfile(path)["model"]
    return cfg


def _float32_slide_eval(model, ds, arch, test_params, device):
    """``evaluate``'s confusion-matrix mIoU in float32 (the card's own
    ``evaluate`` feeds bf16 images under autocast), one record at a time
    through the model's test mode (slide)."""
    import torch
    from gaiaseg_tpu_torch.data import SegEvaluator
    from gaiaseg_tpu_torch.data.transforms import prepare_eval_batch
    mean = torch.tensor(test_params.mean, device=device)
    std = torch.tensor(test_params.std, device=device)
    evaluator = SegEvaluator(model.num_classes)
    with torch.no_grad(), torch.autocast(device.type, enabled=False):
        for i in range(len(ds)):
            rec = ds[i]
            img = prepare_eval_batch(
                torch.from_numpy(rec["img"][None]).to(device), mean, std,
                dtype=torch.float32)
            gt = torch.from_numpy(rec["gt"][None].astype("int64")).to(device)
            evaluator.update(model.simple_test(img, arch), gt)
    return dict(evaluator.evaluate(), confusion=evaluator.confusion())


def _float32_logits(model, img, arch):
    import torch
    with torch.no_grad(), torch.autocast("cuda", enabled=False):
        return model.whole_inference(img, arch).float()


def phase_deeplab(ctx):
    """The DeepLabV3+ supernet (``configs/_dynamic_/models/deeplabv3plus_
    ar50to101v2.py``: output stride 8, separable ASPP 512 at dilations
    12/24/36, c1 48, FCN aux) and the v1c PSP supernet at full width:
    K1/K2 at this path's loss shapes; one flagship sandwich cycle of the
    DeepLabV3+ supernet (K1/K2 16/16), warm step times, a profiled MAX
    step, peak memory; its slide eval at R50 (float32 mIoU equal to the
    CPU's); one v1c MAX step; extraction of R50v1c, R101v1c and a
    DeepLabV3+ R50 bit-equal to the supernets at the arch; the analytic
    FLOPs and parameters of both configs."""
    import torch
    from gaiaseg_tpu_torch.archspace import (build_model_sampler,
                                             get_model_complexity_info)
    from gaiaseg_tpu_torch.data import SyntheticDataset, build_dataset
    from gaiaseg_tpu_torch.engine import (build_optimizer, configure_numerics,
                                          evaluate, extract_subnet,
                                          prepare_batch, train_segmentor,
                                          train_step)
    from gaiaseg_tpu_torch.models import (build_segmentor, encode_arch,
                                          model_max_arch)
    from gaiaseg_tpu_torch.models.arch_util import canonical_arch
    from gaiaseg_tpu_torch.ops.cuda import LAUNCHES, reset_launches
    from gaiaseg_tpu_torch.utils import Config
    smi = ctx["nvidia_smi"]
    out = ctx["deeplab"] = {}
    configure_numerics()
    torch.backends.cudnn.benchmark = False

    # 1. K1/K2 at this path's loss shapes against their plain versions
    errs = {"resize_ce_fwd": 0.0, "resize_ce_bwd": 0.0}
    checks = out["kernel_checks"] = []
    for name, shape in DEEPLAB_LOSSES.items():
        for dtype in (torch.float32, torch.bfloat16):
            _check_case(name, shape, dtype, seed=1, errs=errs, log=checks)
    timings = out["kernel_timings"] = {}
    for name, shape in DEEPLAB_LOSSES.items():
        _time_case(name, shape, timings)
    out["max_abs_err"] = errs

    # 2. one sandwich cycle of the DeepLabV3+ supernet, then warm cycles
    base = _flagship_cfg()
    base["data"]["samples_per_gpu"] = DEEPLAB_BATCH
    cfg = _model_cfg(DEEPLAB, base)
    model = _build_model(cfg)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[deeplab] DeepLabV3+ supernet: {n_params / 1e6:.2f} M parameters"
          ", stem 64, widths 80/160/320/640, depths 4/6/29/4, output stride "
          "8, separable ASPP 512 at 12/24/36, c1 48, FCN aux; batch "
          f"{DEEPLAB_BATCH} of 512x1024")
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    cold = train_segmentor(model, cfg, device="cuda", max_iters=8, seed=0,
                           log=lambda s: print(f"[deeplab] {s}"))[1]["loss"]
    launches = out["launches"] = dict(LAUNCHES)
    names = [r["arch"] for r in cold]
    check(names == ["MAX", "MIN", "R101", "R77", "R50"] + ["random"] * 3,
          f"deeplab: arch sequence {names}")
    check(all(math.isfinite(r["loss"]) for r in cold),
          f"deeplab: non-finite loss in {[r['loss'] for r in cold]}")
    for k in ("resize_ce_fwd", "resize_ce_bwd"):
        check(launches[k] == 2 * len(cold),
              f"deeplab: {k} launched {launches[k]} times in {len(cold)} "
              "iterations (want 2 per iteration)")
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    warm = train_segmentor(model, cfg, device="cuda", max_iters=8,
                           seed=0)[1]["loss"]
    out["cold_history"], out["warm_history"] = cold, warm
    print(f"[deeplab] launches {launches} over {len(cold)} iterations; peak "
          f"memory {out['peak_mem_gb']:.2f} GB; on {smi}")
    print("[deeplab] first cycle step ms: " + ", ".join(
        f"{r['arch']} {r['step_ms']:.1f}" for r in cold))
    out.update(_steady_step_ms(model, cfg, warm, "deeplab"))
    out["profile"] = _profile_max_step(model, cfg, warm, "deeplab")

    # 3. slide eval at R50: the card (bf16, timed), then float32 on the
    # card and on the CPU with the same weights and records
    model.eval()
    max_arch = model_max_arch(cfg["model"])
    anchors = {m["name"]: m for m in build_model_sampler(
        cfg["val_sampler"]).traverse()}
    r50 = encode_arch(max_arch, anchors["R50"])
    ds = SyntheticDataset(length=SLIDE_RECORDS, size=SLIDE_SIZE,
                          num_classes=19, seed=1, cells=8)
    test_params = _test_params(cfg)
    evaluate(model, ds, r50, test_params=test_params, device="cuda",
             max_batches=1)                      # cuDNN's set-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bf16 = evaluate(model, ds, r50, test_params=test_params, device="cuda")
    torch.cuda.synchronize()
    slide_s = (time.perf_counter() - t0) / SLIDE_RECORDS
    f32 = {"cuda": _float32_slide_eval(model, ds, r50, test_params,
                                       torch.device("cuda"))}
    cpu_model = build_segmentor(cfg["model"]).eval()
    cpu_model.load_state_dict({k: v.cpu() for k, v in
                               model.state_dict().items()})
    t0 = time.perf_counter()
    f32["cpu"] = _float32_slide_eval(cpu_model, ds, r50, test_params,
                                     torch.device("cpu"))
    cpu_s = time.perf_counter() - t0
    del cpu_model
    d_miou = abs(f32["cuda"]["mIoU"] - f32["cpu"]["mIoU"])
    differ = int((f32["cuda"]["confusion"] != f32["cpu"]["confusion"]).sum())
    check(all(math.isfinite(r["mIoU"]) for r in (bf16, *f32.values()))
          and d_miou <= SLIDE_MIOU_ATOL,
          f"deeplab: slide mIoU float32 card {f32['cuda']['mIoU']} vs CPU "
          f"{f32['cpu']['mIoU']}")
    out["slide"] = {"s_per_image": slide_s, "mIoU_bf16": bf16["mIoU"],
                    "mIoU_f32_cuda": f32["cuda"]["mIoU"],
                    "mIoU_f32_cpu": f32["cpu"]["mIoU"],
                    "confusion_cells_differ": differ, "cpu_s": cpu_s}
    print(f"[deeplab] slide eval R50 (crop 512x1024, stride 341x683, 9 "
          f"windows) on {SLIDE_RECORDS} records of 1024x2048: "
          f"{slide_s:.3f} s an image (bf16), mIoU {bf16['mIoU']:.4f}; "
          f"float32 mIoU card {f32['cuda']['mIoU']:.6f} vs CPU "
          f"{f32['cpu']['mIoU']:.6f} (|d| {d_miou:.1e}, {differ} confusion "
          f"cells differ; CPU {cpu_s:.1f}s)")

    # 4. extraction of a DeepLabV3+ subnet, bit-equal to the supernet
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    img = torch.randn(1, 3, *SUBNET_IMAGE, generator=g, device="cuda")
    extracted = out["extract"] = []

    def extract(tag, model, cfg, meta):
        arch = canonical_arch(model_max_arch(cfg["model"]), meta)
        t0 = time.perf_counter()
        sub_cfg, sub_sd, _ = extract_subnet(cfg["model"], model.state_dict(),
                                            meta)
        sub = build_segmentor(sub_cfg).cuda().eval()
        sub.load_state_dict(sub_sd, strict=True)
        secs = time.perf_counter() - t0
        got = _float32_logits(sub, img, encode_arch(model_max_arch(sub_cfg)))
        ref = _float32_logits(model, img, encode_arch(
            model_max_arch(cfg["model"]), meta))
        err = float((got - ref).abs().max())
        mb = sum(t.numel() * t.element_size() for t in sub_sd.values()) / 1e6
        n_sub = sum(p.numel() for p in sub.parameters())
        only_bb = "ASPP" in cfg["model"]["decode_head"]["type"]
        want = get_model_complexity_info(cfg["model"], arch,
                                         (3, *SUBNET_IMAGE), only_bb)
        n_check = sum(p.numel() for p in sub.backbone.parameters()) \
            if only_bb else n_sub
        check(err == 0.0 and torch.isfinite(got).all()
              and n_check == want["params"],
              f"deeplab: extracted {tag} logits max|d| {err:.2e} from the "
              f"supernet's; {n_check} parameters, analytic {want['params']}")
        extracted.append({"name": tag, "mb": mb, "seconds": secs,
                          "params": n_sub, "flops": want["flops"],
                          "max_abs_err": err})
        print(f"[deeplab] extract {tag}: {mb:.1f} MB, {n_sub / 1e6:.2f} M "
              f"parameters, {want['flops'] / 1e9:.1f} GFLOPs"
              f"{' (backbone)' if only_bb else ''} at "
              f"{SUBNET_IMAGE[0]}x{SUBNET_IMAGE[1]}, in {secs:.2f}s; float32"
              " logits bit-equal to the supernet's at the arch")
        del sub

    extract("DeepLabV3+ R50", model, cfg, anchors["R50"])
    del model
    torch.cuda.empty_cache()

    # 5. the v1c PSP supernet: one MAX step, then R50v1c and R101v1c
    v1c_cfg = _model_cfg(V1C, base)
    model = _build_model(v1c_cfg)
    train_ds = build_dataset(v1c_cfg["data"]["train"])
    img8, gt8 = prepare_batch([train_ds[i] for i in range(DEEPLAB_BATCH)],
                              v1c_cfg["img_norm_cfg"], "cuda")
    opt = build_optimizer(model.parameters(), v1c_cfg["optimizer"])
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logs = train_step(model.train(), opt, img8, gt8,
                      encode_arch(model_max_arch(v1c_cfg["model"])))
    loss = float(logs["loss"])
    step_ms = (time.perf_counter() - t0) * 1e3
    v1c_launches = dict(LAUNCHES)
    check(math.isfinite(loss) and v1c_launches["resize_ce_fwd"] == 2
          and v1c_launches["resize_ce_bwd"] == 2,
          f"deeplab: v1c MAX step loss {loss}, launches {v1c_launches}")
    out["v1c_step"] = {"loss": loss, "first_step_ms": step_ms,
                       "launches": v1c_launches}
    print(f"[deeplab] v1c PSP supernet MAX step (deep stem 32/32/64, output "
          f"stride 8) at batch {DEEPLAB_BATCH}: loss {loss:.4f}, first step "
          f"{step_ms:.1f} ms, launches {v1c_launches}")
    model.eval()
    for meta in build_model_sampler(Config.fromfile(V1C_EXTRACT)
                                    ["train_sampler"]).traverse():
        extract(meta["name"], model, v1c_cfg, meta)

    # 6. the analytic FLOPs of both configs at MAX and R50
    flops = out["flops"] = {}
    for tag, c in (("deeplabv3plus", cfg), ("v1c", v1c_cfg)):
        for name, meta in (("MAX", None), ("R50", anchors["R50"])):
            arch = canonical_arch(model_max_arch(c["model"]), meta)
            flops[f"{tag} {name}"] = get_model_complexity_info(
                c["model"], arch, (3, 512, 1024))
    print("[deeplab] analytic FLOPs at 512x1024 (the ASPP head uncounted, "
          "as in the JAX sweep): " + ", ".join(
              f"{k} {v['flops'] / 1e9:.1f} G / {v['params'] / 1e6:.2f} M"
              for k, v in flops.items()))
    del model
    torch.cuda.empty_cache()


# the ddp phase: data parallelism on the one card (2 gloo ranks sharing
# cuda:0; NCCL refuses two ranks on one device), then an NCCL process group
# of world size 1 through torchrun
DDP_WORLD, DDP_BATCH = 2, 4          # 2 ranks x 4 = the flagship's batch 8
DDP_ITERS = 8                        # one sandwich cycle
DDP_EVAL_RECORDS = 2                 # of 1024x2048, at R50
DDP_TIMEOUT_S = 600
# one MAX step from the same weights, 2 ranks x 4 against one process x 8,
# autocast and TF32 off. In float64 the gradients agree within
# DDP_F64_RTOL of each tensor's max. In float32 the random flagship in train
# mode (loss 10 at init) amplifies rounding: two one-process float32 routes
# (BN in cuDNN's arithmetic or the ranks') read 6-9% apart (global L2;
# PERF.md, PR 9), so the 2-rank float32 gradient may be no farther from the
# float64 one than DDP_F32_FLOOR_RATIO times the one-process float32 one is;
# its loss is within F32_LOSS_RTOL of the one-process float32 loss.
DDP_F64_RTOL = 1e-6
DDP_F32_FLOOR_RATIO = 2.0


def _ddp_cfg(batch):
    cfg = _flagship_cfg()
    cfg.merge_from_dict({"data.samples_per_gpu": batch,
                         "checkpoint_config.interval": DDP_ITERS})
    return cfg


def _ddp_model(cfg, device):
    import torch
    from gaiaseg_tpu_torch.models import build_segmentor
    torch.manual_seed(0)
    return build_segmentor(cfg["model"]).to(device)


def _one_step(cfg, rows, device, dtype, rank_bn=False):
    """One train step of the model's MAX from seed 0 in ``dtype`` (autocast
    off) on records ``rows`` of DDP_WORLD x DDP_BATCH synthetic records of
    the train records' size (seed 3): (summed loss, {name: grad}), the
    gradients summed over the ranks (every rank holds them). ``rank_bn``:
    in one process, BN takes the ranks' arithmetic (``sync_batch_norm``
    with rank 0's row of the combined statistics, the others empty) in
    place of cuDNN's: a second one-process route that rounds otherwise."""
    import contextlib
    import torch
    from gaiaseg_tpu_torch.data import SyntheticDataset
    from gaiaseg_tpu_torch.engine import build_optimizer, prepare_batch
    from gaiaseg_tpu_torch.engine import train as train_mod
    from gaiaseg_tpu_torch.models import encode_arch, model_max_arch
    from gaiaseg_tpu_torch.ops import dynamic_layers
    from gaiaseg_tpu_torch.parallel import sum_over_ranks
    model = _ddp_model(cfg, device).to(dtype).train()
    ds = SyntheticDataset(length=DDP_WORLD * DDP_BATCH,
                          size=tuple(cfg["data"]["train"]["size"]),
                          num_classes=model.num_classes, seed=3, cells=8)
    img, gt = prepare_batch([ds[i] for i in range(len(ds))][rows],
                            cfg["img_norm_cfg"], device)
    opt = build_optimizer(model.parameters(), {"type": "SGD", "lr": 0.0,
                                               "momentum": 0.9})
    amp, dp = train_mod.autocast, dynamic_layers.data_parallel
    train_mod.autocast = lambda device: contextlib.nullcontext()
    if rank_bn:
        dynamic_layers.data_parallel = lambda: (0, DDP_WORLD)
    try:
        logs = train_mod.train_step(
            model, opt, img.to(dtype), gt,
            encode_arch(model_max_arch(cfg["model"])),
            torch.Generator(device).manual_seed(0))
    finally:
        train_mod.autocast, dynamic_layers.data_parallel = amp, dp
    loss = float(sum_over_ranks(logs["loss"].double()))
    grads = {k: p.grad for k, p in model.named_parameters()}
    return loss, grads


def _grad_errors(loss, grads, ref_loss, ref_grads):
    """Loss and per-tensor gradient differences, max|d| / max|ref|."""
    rel = sorted((float((g - ref_grads[k].to(g.device)).abs().max())
                  / max(float(ref_grads[k].abs().max()), 1e-30), k)
                 for k, g in grads.items())
    d2 = sum(float((g - ref_grads[k].to(g.device)).double().square().sum())
             for k, g in grads.items())
    r2 = sum(float(g.double().square().sum()) for g in ref_grads.values())
    return {"loss": loss, "ref_loss": ref_loss,
            "loss_rel": abs(loss - ref_loss) / abs(ref_loss),
            "worst_grad_rel": rel[-1][0], "worst_tensor": rel[-1][1],
            "p99_grad_rel": rel[int(0.99 * (len(rel) - 1))][0],
            "median_grad_rel": rel[len(rel) // 2][0],
            "global_rel": (d2 / max(r2, 1e-300)) ** 0.5,
            "worst5": rel[-5:]}


def _ddp_rank(rank, world, port, tmp, ref_path, out_path, cfg_dict, device,
              eval_size):
    """One rank of the 2-rank phase (``cfg_dict`` at this rank's batch);
    writes its readings to ``out_path``."""
    import torch
    from gaiaseg_tpu_torch import parallel
    from gaiaseg_tpu_torch.utils import Config
    from gaiaseg_tpu_torch.data import SyntheticDataset
    from gaiaseg_tpu_torch.engine import (configure_numerics, evaluate,
                                          train_segmentor)
    from gaiaseg_tpu_torch.engine import train as train_mod
    from gaiaseg_tpu_torch.models import encode_arch, model_max_arch
    from gaiaseg_tpu_torch.ops.cuda import LAUNCHES, reset_launches
    cuda = device == "cuda"
    if cuda:
        torch.cuda.set_device(0)
    configure_numerics()
    parallel.initialize_distributed(f"127.0.0.1:{port}", world, rank,
                                    backend="gloo", timeout_s=DDP_TIMEOUT_S)
    out = {}
    cfg = Config(cfg_dict)
    try:
        # 1. one step in float64 and one in float32 against one process's
        rows = slice(rank * DDP_BATCH, (rank + 1) * DDP_BATCH)
        refs = torch.load(ref_path) if rank == 0 else None
        for dtype in (torch.float64, torch.float32):
            loss, grads = _one_step(cfg, rows, device, dtype)
            if rank == 0:
                name = str(dtype).split(".")[1]
                out[name] = _grad_errors(loss, grads, refs["float64"]["loss"],
                                         refs["float64"]["grads"])
                out[name]["loss_vs_one_process"] = abs(
                    loss - refs[name]["loss"]) / abs(refs[name]["loss"])
            del grads
            if cuda:
                torch.cuda.empty_cache()
        del refs

        # 2. one bf16 sandwich cycle through train_segmentor, K1/K2 counted,
        # the gradient all-reduce timed (synchronized on both sides)
        reduce_ms, reduce_mb = [], []
        reduce = train_mod.all_reduce_grads

        def timed(params):
            if cuda:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            n = reduce(params)
            if cuda:
                torch.cuda.synchronize()
            reduce_ms.append((time.perf_counter() - t0) * 1e3)
            reduce_mb.append(n / 1e6)
            return n
        model = _ddp_model(cfg, device)
        work_dir = os.path.join(tmp, "work")
        train_mod.all_reduce_grads = timed
        reset_launches()
        try:
            state, history = train_segmentor(
                model, cfg, work_dir=work_dir, device=device,
                max_iters=DDP_ITERS, seed=0)
        finally:
            train_mod.all_reduce_grads = reduce
        out["launches"] = dict(LAUNCHES)
        out["history"] = history["loss"]
        out["reduce_ms"], out["reduce_mb"] = reduce_ms, reduce_mb
        # per-tensor checksums of weights, BN statistics and momenta
        sums = {k: float(v.double().sum()) for k, v in
                model.state_dict().items()}
        sums.update({f"momentum.{k}": float(state.optimizer.state[p]
                                            ["momentum_buffer"].double()
                                            .sum())
                     for k, p in model.named_parameters()})
        out["checksums"] = parallel.all_gather_objects(sums)
        out["files"] = sorted(os.listdir(work_dir))

        # 3. a sharded eval of two 1024x2048 records at R50 against the
        # one-process eval on this rank (its collectives off)
        model.eval()
        ds = SyntheticDataset(length=DDP_EVAL_RECORDS, size=eval_size,
                              num_classes=model.num_classes, seed=1, cells=8)
        r50 = encode_arch(model_max_arch(cfg["model"]),
                          cfg["train_sampler"]["model_samplers"][0]
                          ["anchors"][-1])
        kw = dict(test_params=_test_params(cfg), device=device)
        sharded = evaluate(model, ds, r50, **kw)["confusion"]
        with parallel.local_only():
            whole = evaluate(model, ds, r50, **kw)["confusion"]
        out["eval"] = {"equal": bool((sharded == whole).all()),
                       "pixels": int(sharded.sum())}
        parallel.barrier()
    finally:
        torch.save(out, out_path)
        parallel.shutdown_distributed()


def phase_ddp(ctx):
    """Data parallelism on the card: the one-process float32 reference
    step here, then 2 gloo ranks sharing cuda:0 (float32 step, a bf16
    cycle, a sharded eval), then torchrun with an NCCL group of world 1."""
    import shutil
    import socket
    import tempfile
    import torch
    import torch.multiprocessing as mp
    from gaiaseg_tpu_torch.ops.cuda import reset_launches
    smi = ctx.get("nvidia_smi") or nvidia_smi_line()
    tmp = tempfile.mkdtemp(prefix="gseg_ddp_")

    def free_port():
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            return s.getsockname()[1]
    try:
        # the one-process float32 step at batch 8 (the reference)
        # one process x 8: float64 (the reference), float32 twice (cuDNN's
        # own repeatability) and float32 with BN in the ranks' arithmetic
        refs, peak = {}, {}
        cfg8 = _ddp_cfg(DDP_WORLD * DDP_BATCH)
        for name, dtype, rank_bn in (
                ("float64", torch.float64, False),
                ("float32", torch.float32, False),
                ("float32_again", torch.float32, False),
                ("float32_rank_bn", torch.float32, True)):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            loss, grads = _one_step(cfg8, slice(None), "cuda", dtype,
                                    rank_bn)
            peak[name] = torch.cuda.max_memory_allocated() / 1e9
            refs[name] = {"loss": loss, "grads": {k: g.cpu() for k, g in
                                                  grads.items()}}
            del grads
        floor = {name: _grad_errors(refs[name]["loss"], refs[name]["grads"],
                                    refs["float64"]["loss"],
                                    refs["float64"]["grads"])
                 for name in ("float32", "float32_again", "float32_rank_bn")}
        floor["float32_again_vs_float32"] = _grad_errors(
            refs["float32_again"]["loss"], refs["float32_again"]["grads"],
            refs["float32"]["loss"], refs["float32"]["grads"])
        for name, e in floor.items():
            what = name.replace("_vs_", " vs ") if "_vs_" in name \
                else f"{name} vs float64"
            print(f"[ddp] one process x {DDP_WORLD * DDP_BATCH}, MAX step, "
                  f"{what}: loss rel {e['loss_rel']:.1e}, grad global "
                  f"{e['global_rel']:.2e}, median "
                  f"{e['median_grad_rel']:.1e}, worst "
                  f"{e['worst_grad_rel']:.1e} ({e['worst_tensor']})")
        print(f"[ddp] peak memory GB of the one-process steps: {peak}")
        ref_path = os.path.join(tmp, "ref.pt")
        torch.save({k: refs[k] for k in ("float64", "float32")}, ref_path)
        del refs
        torch.cuda.empty_cache()

        # 2 ranks on cuda:0 over gloo
        spawn = mp.get_context("spawn")
        port = free_port()
        outs = [os.path.join(tmp, f"rank{r}.pt") for r in range(DDP_WORLD)]
        procs = [spawn.Process(target=_ddp_rank, args=(
            r, DDP_WORLD, port, tmp, ref_path, outs[r],
            _ddp_cfg(DDP_BATCH).to_dict(), "cuda", (1024, 2048)))
            for r in range(DDP_WORLD)]
        t0 = time.perf_counter()
        for p in procs:
            p.start()
        for p in procs:
            p.join(max(DDP_TIMEOUT_S - (time.perf_counter() - t0), 1))
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(30)
        check(all(p.exitcode == 0 for p in procs),
              f"ddp: rank exit codes {[p.exitcode for p in procs]}")
        ranks = [torch.load(o, weights_only=False) for o in outs]
        steps = {k: ranks[0][k] for k in ("float64", "float32")}
        for name, e in steps.items():
            print(f"[ddp] 2 ranks x {DDP_BATCH}, MAX step, {name} vs one "
                  f"process x {DDP_WORLD * DDP_BATCH} in float64: loss rel "
                  f"{e['loss_rel']:.1e} ({name} one process: "
                  f"{e['loss_vs_one_process']:.1e}), grad global "
                  f"{e['global_rel']:.2e}, median {e['median_grad_rel']:.1e},"
                  f" worst {e['worst_grad_rel']:.1e} ({e['worst_tensor']})")

        sums = ranks[0]["checksums"]
        check(sums[0] == sums[1] and ranks[1]["checksums"] == sums,
              "ddp: weights, BN statistics or momenta differ across ranks")
        for r, res in enumerate(ranks):
            names = [h["arch"] for h in res["history"]]
            check(names == ["MAX", "MIN", "R101", "R77", "R50"]
                  + ["random"] * 3, f"ddp: rank {r} arch sequence {names}")
            check(all(math.isfinite(h["loss"]) for h in res["history"]),
                  f"ddp: rank {r} non-finite loss")
            for k in ("resize_ce_fwd", "resize_ce_bwd"):
                check(res["launches"][k] == 2 * DDP_ITERS,
                      f"ddp: rank {r} {k} launched {res['launches'][k]} "
                      f"times in {DDP_ITERS} iterations (want "
                      f"{2 * DDP_ITERS})")
            check(res["eval"]["equal"] and res["eval"]["pixels"]
                  == DDP_EVAL_RECORDS * 1024 * 2048,
                  f"ddp: rank {r} sharded eval {res['eval']}")
        check(ranks[0]["files"] == ["history.json", f"iter_{DDP_ITERS}.pth",
                                    "latest.pth"],
              f"ddp: work dir holds {ranks[0]['files']}")
        check([h["loss"] for h in ranks[0]["history"]]
              == [h["loss"] for h in ranks[1]["history"]],
              "ddp: the ranks logged different global losses")
        for r, res in enumerate(ranks):
            print(f"[ddp] rank {r}: bf16 cycle step ms " + ", ".join(
                f"{h['arch']} {h['step_ms']:.1f}" for h in res["history"])
                + f"; gradient all-reduce ms " + ", ".join(
                f"{ms:.1f}" for ms in res["reduce_ms"]) + " for MB "
                + ", ".join(f"{mb:.1f}" for mb in res["reduce_mb"])
                + f"; K1/K2 {res['launches']['resize_ce_fwd']}/"
                f"{res['launches']['resize_ce_bwd']}")
        print(f"[ddp] weights, BN statistics and momenta equal on both ranks "
              f"({len(sums[0])} checksums); one checkpoint (rank 0): "
              f"{ranks[0]['files']}; sharded eval of {DDP_EVAL_RECORDS} "
              f"1024x2048 records at R50 == one process; on {smi}")

        # torchrun, an NCCL group of world size 1, the train CLI
        work = os.path.join(tmp, "nccl")
        cmd = [sys.executable, "-m", "torch.distributed.run",
               "--nproc_per_node", "1", "--master_port", str(free_port()),
               "-m", "gaiaseg_tpu_torch.tools.train_supernet", FLAGSHIP,
               "--max-iters", str(DDP_ITERS), "--work-dir", work,
               "--cfg-options", "data.samples_per_gpu=8",
               "log_config.interval=1", "cudnn_benchmark=false",
               "data.train=" + json.dumps(
                   _flagship_cfg()["data"]["train"])]
        t0 = time.perf_counter()
        run = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                             timeout=DDP_TIMEOUT_S,
                             env={**os.environ, "PYTHONPATH": REPO})
        nccl_s = time.perf_counter() - t0
        check(run.returncode == 0, f"ddp: torchrun rc {run.returncode}:\n"
              f"{run.stdout[-3000:]}\n{run.stderr[-3000:]}")
        check("process group: backend nccl, rank 0 of 1" in run.stdout,
              f"ddp: torchrun did not report an nccl group:\n"
              f"{run.stdout[-2000:]}")
        with open(os.path.join(work, "history.json")) as f:
            nccl_hist = json.load(f)["loss"]
        check(len(nccl_hist) == DDP_ITERS and all(
            math.isfinite(h["loss"]) for h in nccl_hist),
            f"ddp: torchrun losses {[h['loss'] for h in nccl_hist]}")
        print(f"[ddp] torchrun --nproc_per_node 1: backend nccl, world 1, "
              f"{DDP_ITERS} flagship iterations at batch 8 in {nccl_s:.1f}s, "
              f"losses finite ({nccl_hist[0]['loss']:.4f} -> "
              f"{nccl_hist[-1]['loss']:.4f})")
        e64, e32 = steps["float64"], steps["float32"]
        check(e64["loss_rel"] <= DDP_F64_RTOL
              and e64["worst_grad_rel"] <= DDP_F64_RTOL,
              f"ddp: float64 2x{DDP_BATCH} vs 1x{DDP_WORLD * DDP_BATCH}: "
              f"loss rel {e64['loss_rel']:.1e}, worst grad "
              f"{e64['worst_grad_rel']:.1e} ({e64['worst_tensor']})")
        limit = DDP_F32_FLOOR_RATIO * floor["float32"]["global_rel"]
        check(e32["loss_vs_one_process"] <= F32_LOSS_RTOL
              and e32["global_rel"] <= limit,
              f"ddp: float32 2x{DDP_BATCH}: loss rel "
              f"{e32['loss_vs_one_process']:.1e} to one process, grad "
              f"{e32['global_rel']:.2e} from float64 (limit {limit:.2e})")
        ctx["ddp"] = {"steps": steps, "one_process": floor, "peak_gb": peak,
                      "nccl_world1": {
            "seconds": nccl_s, "history": nccl_hist},
            "ranks": [{k: v for k, v in res.items() if k != "checksums"}
                      for res in ranks]}
    finally:
        reset_launches()
        shutil.rmtree(tmp, ignore_errors=True)


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
        "log_config.interval": 1,
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
                              seed=0, log=lambda s: print(f"[vit_train] {s}")
                              )[1]["loss"]
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
                           seed=0)[1]["loss"]

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


VIT_EVAL_SIZE = (512, 1024)   # crop 512, stride 341: 1 x 3 windows
VIT_EVAL_RECORDS = 4
VIT_EVAL_RATIOS = (0.75, 1.0)
SLIDE_RTOL = 1e-4   # batched windows vs one forward a window, float32


def _windows(h, w, crop, stride):
    """mmseg's slide grid, written out again for the check."""
    out = []
    for i in range(max(h - crop[0] + stride[0] - 1, 0) // stride[0] + 1):
        for j in range(max(w - crop[1] + stride[1] - 1, 0) // stride[1] + 1):
            y0 = min(i * stride[0], h - crop[0])
            x0 = min(j * stride[1], w - crop[1])
            out.append((y0, x0))
    return out


def phase_vit_eval(ctx):
    """The ViT's eval in its config's slide mode (crop 512, stride 341) at
    the val anchors, then whole, flip and multi-scale runs at MAX; flash_fwd
    launches once a layer a forward, K4/K5 never. Then the slide logits
    (float32, flash off) against a slide built here from whole inference
    of each window."""
    import torch
    from gaiaseg_tpu_torch.archspace import build_model_sampler
    from gaiaseg_tpu_torch.data import SyntheticDataset, TestPipelineParams
    from gaiaseg_tpu_torch.engine import evaluate, prepare_batch
    from gaiaseg_tpu_torch.models import encode_arch, model_max_arch
    from gaiaseg_tpu_torch.ops.cuda import LAUNCHES, reset_launches
    cfg = ctx.get("vit_cfg") or _vit_cfg()
    model = (ctx.get("vit_model") or _build_model(cfg)).eval()
    crop = tuple(model.test_cfg["crop_size"])
    stride = tuple(model.test_cfg["stride"])
    n_win = len(_windows(*VIT_EVAL_SIZE, crop, stride))
    check(model.test_cfg.get("mode") == "slide" and n_win == 3,
          f"vit_eval: test_cfg {model.test_cfg}, {n_win} windows")
    ds = SyntheticDataset(length=VIT_EVAL_RECORDS, size=VIT_EVAL_SIZE,
                          num_classes=19, seed=1, cells=8)
    max_arch = model_max_arch(cfg["model"])
    tp = _test_params(cfg)
    results = {}

    def run(tag, arch, forwards, test_params=tp, flip=False):
        depth = arch["backbone"]["encoder"]["depth"]
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = evaluate(model, ds, arch, test_params=test_params, flip=flip)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = dict(LAUNCHES)
        check(math.isfinite(res["mIoU"]) and 0.0 <= res["mIoU"] <= 1.0,
              f"vit_eval {tag}: mIoU {res['mIoU']}")
        want = depth * forwards * len(ds)
        check(launches["flash_fwd"] == want
              and launches["flash_bwd_dkv"] == launches["flash_bwd_dq"] == 0,
              f"vit_eval {tag}: launches {launches}, want flash_fwd {depth} "
              f"a forward x {forwards} forwards x {len(ds)} images and no "
              "backward")
        results[tag] = {"mIoU": res["mIoU"], "aAcc": res["aAcc"],
                        "seconds": dt, "seconds_per_image": dt / len(ds),
                        "launches": launches}
        print(f"[vit_eval] {tag}: mIoU {res['mIoU']:.4f} aAcc "
              f"{res['aAcc']:.4f} on {len(ds)} images "
              f"{VIT_EVAL_SIZE[0]}x{VIT_EVAL_SIZE[1]}: {dt / len(ds):.3f} s an"
              f" image; flash_fwd {launches['flash_fwd']} launches (depth "
              f"{depth})")

    for meta in build_model_sampler(cfg["val_sampler"]).traverse():
        run(f"slide {meta['name']}", encode_arch(max_arch, meta), 1)
    arch = encode_arch(max_arch)
    run("slide flip MAX", arch, 2, flip=True)
    run("slide multi-scale MAX", arch, len(VIT_EVAL_RATIOS),
        TestPipelineParams(mean=tp.mean, std=tp.std,
                           img_ratios=VIT_EVAL_RATIOS))
    slide_cfg = model.test_cfg
    model.test_cfg = {"mode": "whole"}
    try:
        run("whole MAX", arch, 1)
    finally:
        model.test_cfg = slide_cfg

    # the slide accumulation at full size: float32, flash off
    _set_flash(model, False)
    try:
        img, _ = prepare_batch([ds[0]], cfg["img_norm_cfg"], "cuda")
        with torch.no_grad():
            got = model.slide_inference(img, arch, crop, stride)
            h, w = VIT_EVAL_SIZE
            want = torch.zeros_like(got, dtype=torch.float64)
            count = torch.zeros(1, 1, h, w, dtype=torch.float64,
                                device="cuda")
            for y0, x0 in _windows(h, w, crop, stride):
                part = model.whole_inference(
                    img[:, :, y0:y0 + crop[0], x0:x0 + crop[1]], arch)
                want[:, :, y0:y0 + crop[0], x0:x0 + crop[1]] += part
                count[:, :, y0:y0 + crop[0], x0:x0 + crop[1]] += 1
            want = want / count
    finally:
        _set_flash(model, True)
    err, scale = _max_abs(got, want), float(want.abs().max())
    results["slide_vs_windows"] = {"max_abs": err, "max_ref": scale}
    print(f"[vit_eval] slide logits (3 windows in one forward, float32) vs "
          f"the windows' whole inference, averaged here: max|d| {err:.2e} "
          f"(max|ref| {scale:.2e}, tolerance {SLIDE_RTOL} of it)")
    check(got.dtype == torch.float32 and err <= SLIDE_RTOL * scale,
          f"vit_eval: slide vs windows max|d| {err:.2e}, max|ref| "
          f"{scale:.2e}")
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
    for path in (FLAGSHIP, VIT, ADE20K, FLOPS_CFG, RULES_CFG, FT_CFG,
                 *EXTRACT_CFGS, DEEPLAB, V1C, V1C_EXTRACT):
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
                   "eval": ctx.get("eval"), "loop": ctx.get("loop"),
                   "subnets": ctx.get("subnets"),
                   "deeplab": ctx.get("deeplab"), "ddp": ctx.get("ddp"),
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
