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
11. distill the DynamicDistiller at full width (``configs/local_examples/
            train_supernet/soak_distill_512.py``: the flagship student, a
            BEiT-base teacher, 768 wide, depth 12, 12 heads, patch 16,
            per-block relative-position tables, out 3/5/7/11, + a UPer
            teacher head of 512), synthetic 512x512 records kept on the card
            through the config's train pipeline, batch 8: K1/K2 at this
            path's loss shapes (decode 16x16, aux 32x32 -> 512x512) against
            their plain versions in float32 and bf16, and timed; a seeded
            teacher ``.pth`` in the official BEiT layout with tables of a
            14x14 window (a 224 pretraining), stale index buffers and a BN
            in ``fpn1.1``, loaded through ``teacher_checkpoint`` (the
            tables resampled to 32x32, the FPN deconvs loaded, ``fpn1.1``
            at init);
            one sandwich cycle (finite losses with ``distill_loss_seg`` and
            ``pairwise_loss_seg``, K1 and K2 16 launches each, every teacher
            tensor bit-equal to the loaded one after it, no teacher
            parameter in the optimizer); the warm cycles' least step times,
            a profiled MAX step and the device time of the kernels inside
            its ``teacher_forward`` range as a share of its busy time, peak
            memory; the float32 losses of one image on the card
            (K1/K2) within 1e-4 relative of the CPU's plain route. Then
            self-distillation (``soak_distill_resnet_teacher.py``):
            ``tools/make_teacher_ckpt.py`` of the trained supernet, its
            teacher bit-equal to it, one MAX step (K1/K2 2/2). Last, a
            float64 MAX step on 2 gloo ranks x 4 sharing the card against
            one process x 8 (loss and each gradient within 1e-6).
12. ddp     data parallelism on the one card (NCCL refuses two ranks on one
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
13. tp      tensor parallelism (``model_parallel`` 2) on the one card, its
            ranks over gloo sharing cuda:0: (i) the elastic ViT-B/16
            UPerNet of ``vit_train`` (1024 tokens, flash on) on 2 ranks at
            samples_per_gpu 4 (JAX's global batch 8): one float32 MAX step
            (K3-K5's float32 instances on each rank's 6 heads, AdamW + clip
            1.0) against one process's at batch 8 from the same weights
            (loss within 1e-5 relative; against one process's float32
            step, the gradients' global distance and the update's
            elements that change sign within about 10x an H100's
            readings, each tensor's gradient within twice its own float32
            distance from float64; the gradients' distance from float64
            within twice one process's float32 one, its float32 repeat
            printed; the replicated gradients' distance between the ranks
            before model rank 0's broadcast printed), then a bf16 sandwich
            cycle (MAX, a MIN of 4 heads and FFN 1536 that leaves rank 1 no
            head or feature, 2 random) cold and warm: K1/K2 8 a rank,
            K3-K5 once a layer where the rank holds an active head, each
            rank's parameter and AdamW bytes against one process's, bytes
            moved a step on each axis, step ms, peak memory, the shard
            report equal to ``tp_plan`` and the replicated parameters equal
            on both ranks; (ii) the flagship's float64 MAX step on 2 ranks at
            model_parallel 2 (every sharded conv gathered on use) against
            phase ddp's one process x 8 within 1e-6; (iii) the same on 2
            data x 2 model ranks at samples_per_gpu 2 (the crop cut to
            512x512, reference alike, when 4 ranks do not fit).
14. flash_kernels  K3 (``flash_fwd``), K4 (``flash_bwd_dkv``) and K5
            (``flash_bwd_dq``) against their plain torch versions at the ViT
            shape [8, 1024, 12, 64] in bf16 and float32, at N = 1025, 200
            (ragged tails), 1088 (a half-empty last 128-row block), 64 (one
            tile) and 129 (a block with one real row) and on all-zero
            q/k/v; each run twice must agree bit for bit. Then their times
            beside the plain version, SDPA and the bound, K3 beside SDPA's
            forward and the port's whole attention backward
            (``attention_di`` + K4 + K5) beside SDPA's backward, in turns.
15. vit_segmentor  the elastic-ViT segmentor's loss and gradients through
            the flash kernels equal the dense attention route (bf16, a
            batch of 8); two planted faults in dq (zeroed, halved) must
            fail that check.
16. vit_train  one sandwich cycle (MAX, MIN, 2 random) of the elastic-ViT
            UPerNet supernet (``configs/_dynamic_/models/upernet_elastic_
            vit.py`` with ``with_cls_token=False``, so the flash gate opens)
            at full width, synthetic 512x512 records kept on the card
            through ADE20K's train pipeline (512x512 crops), batch 8, AdamW
            + clip;
            K3-K5 must each launch once per active layer, K1/K2 twice per
            iteration. Then the cycle again for warm times, a profiled
            MAX step, and the least step times over three warm cycles.
17. vit_eval  the config's slide mode (crop 512, stride 341: 1 x 3 windows
            of four synthetic 512x1024 images, one forward an image) at the
            val anchors MIN and MAX, then flip, multi-scale (0.75, 1.0) and
            whole runs at MAX, seconds an image each; flash_fwd launches
            once a layer a forward, K4/K5 never. Then the slide logits
            (float32, flash off) within 1e-4 of max|ref| of a slide built
            from each window's whole inference.

18. convnext  K1 and K2 at this path's loss shapes (150 classes: decode
            128x128, aux 32x32 -> 512x512, the any-C instances) against
            their plain versions in float32 and bf16, each twice
            bit-equal, and their times; the ConvNeXt-T supernet
            (``DynamicConvNeXt`` defaults: dims 96/192/384/768, depths
            3/3/9/3, drop path 0.4) + UPer 512 (pool scales 1/2/3/6) + FCN
            aux 256 on stage 2, 150 classes, on
            ``configs/tests/tiny_convnext_uper.py``'s structure (AdamW +
            clip 5), synthetic 512x512 records kept on the card through
            ADE20K's train pipeline, batch 8: one sandwich cycle (MAX, MIN
            at half of every width and depths 2/2/5/2, 2 random), K1 and K2
            twice an iteration on their any-C instances, K3-K5 never; the
            warm cycle, the least step times over three warm cycles, a
            profiled MAX step, peak memory; then one float32 MAX step of
            the supernet from seed 0 (autocast and TF32 off, eval mode: BN
            running statistics, no drop path or dropout) on 2 images on
            the card (K1/K2) against the CPU (plain) from the same weights,
            beside a float64 step on the card: losses within 1e-5
            relative; each gradient's distance from float64 with PyTorch's
            own CUDA convolutions within 1e-3 of its max or within twice
            the CPU float32's distance (cuDNN's, which round more in
            float32, printed).
19. conformer  the same for the ``ElasticConvformer`` defaults (stem 64,
            widths 256/512/1024, depths 4/4/4, embed 576, 9 heads, FFN 4.0,
            ``norm_eval``) with the heads at in-channels 256/512/1024/1024;
            MIN at half of every width, embed 384 with 6 heads, FFN 3.0,
            depths 2/2/2.
20. vit_relpos  ``upernet_elastic_vit.py`` at full width with relative
            positions, token dropout 0.1 and the cls token (1025 tokens),
            batch 8 of 512x512: a MAX and a MIN step (K1/K2 twice a step,
            K3-K5 never: the flash gate stays closed, as JAX's), warm and
            least step times, a profiled MAX step, peak memory, the float32
            card-vs-CPU MAX step.
21. segformer  the SegFormer supernet (``configs/_dynamic_/models/
            segformer_elastic_mixvit.py`` as it stands: ElasticMixViT with
            MiT-B2's encoder shapes, widths 64/128/320/512, depths 3/4/6/3,
            heads 2/4/10/16 of dim 32, SR 8/4/2/1, FFN 4.0, + SegFormerHead
            256, 19 classes, AdamW + clip 1.0) with the data of
            ``configs/_dynamic_/datasets/cityscapes_1024x1024.py`` (crop
            512x1024) on synthetic 1024x2048 records kept on the card, batch
            8: the config's sandwich cycle (MAX, MIN, 2 random) with K1/K2
            once an iteration (one head) and K3-K5 never, warm and least
            step times, a profiled MAX step (which runs ``fwd_tile`` and
            ``bwd_tile``), peak memory, the float32 card-vs-CPU MAX step;
            slide eval at MAX and MIN on one 1024x2048 record (windows
            1024x1024 at stride 768: 3), seconds an image in bf16 and the
            float32 mIoU within 1e-5 of the CPU's on the same weights; the
            new losses (Dice, sigmoid and softmax focal, Mixed CE + Dice,
            EQL at sample_ratio 0) at [8, 19, 512, 1024] on the card
            against the CPU (values within 1e-5 relative, gradients within
            1e-4 of their max); one MIN step with a MixedLoss(CE, Dice)
            decode loss: finite, K1/K2 never (the unfused loss).

The train phases (``train``, ``data``, ``deeplab``, ``distill``,
``vit_train``, ``convnext``, ``conformer``, ``vit_relpos``, ``segformer``)
run at log interval 1: every step is a full step (BN
statistics updated) and synchronized, so its time is the step's.

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
          "eval", "loop", "subnets", "deeplab", "distill", "ddp", "tp",
          "flash_kernels", "vit_segmentor", "vit_train", "vit_eval",
          "convnext", "conformer", "vit_relpos", "segformer")
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
F32_SPREAD = 2.0        # a float32 gradient's distance from float64 on the
                        # card, in units of the CPU float32's own distance


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


def _train_shaped_batch(cfg, n):
    """The first ``n`` records of the config's train data on the card,
    normalized, cut to the train pipeline's crop (the step's shape; a
    record as large as the crop is whole)."""
    from gaiaseg_tpu_torch.data import build_dataset, parse_train_pipeline
    from gaiaseg_tpu_torch.engine import prepare_batch
    ds = build_dataset(cfg["data"]["train"])
    img, gt = prepare_batch([ds[i] for i in range(n)], cfg["img_norm_cfg"],
                            "cuda")
    ch, cw = parse_train_pipeline(cfg["data"]["train"].get("pipeline")) \
        .crop_size
    return img[..., :ch, :cw].contiguous(), gt[..., :ch, :cw].contiguous()


def _profile_max_step(model, cfg, warm, tag, ranges=()):
    """Where one warm MAX-arch train step spends the card's time: device
    time by kernel from torch.profiler, and the idle share of the step's
    wall time (profiler on, so the wall time carries its overhead). The
    step is the config's optimizer (at lr 0) and gradient clip. For each
    ``record_function`` name in ``ranges``, the device time of the kernels
    launched inside it, from the same trace."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from gaiaseg_tpu_torch.engine import (build_optimizer, grad_clip_norm,
                                          train_step)
    from gaiaseg_tpu_torch.models import encode_arch, model_max_arch
    img, gt = _train_shaped_batch(cfg, 8)
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
    # a range's CPU event carries the kernels its ops launched
    in_range = {name: sum(e.device_time_total for e in prof.events()
                          if e.name == name
                          and e.device_type == DeviceType.CPU) / 1e3
                for name in ranges}
    out = {"profiled_wall_ms": wall_ms, "device_busy_ms": busy,
           "unprofiled_step_ms": warm_ms, "top": rows[:15],
           "repo_kernels": ours, "ranges_ms": in_range}
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
    for name, ms in in_range.items():
        print(f"[{tag}] kernels inside {name!r} in that step: {ms:.2f} ms, "
              f"{ms / busy:.3f} of the busy time")
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


def _one_step(cfg, rows, device, dtype, rank_bn=False, model_parallel=1):
    """One train step of the model's MAX from seed 0 in ``dtype`` (autocast
    off) on records ``rows`` of DDP_WORLD x DDP_BATCH synthetic records of
    the train records' size (seed 3): (summed loss, {name: grad}), the
    gradients summed over the ranks (every rank holds them). ``rank_bn``:
    in one process, BN takes the ranks' arithmetic (``sync_batch_norm``
    with rank 0's row of the combined statistics, the others empty) in
    place of cuDNN's: a second one-process route that rounds otherwise.
    ``model_parallel`` K > 1 shards the model over a mesh of K model ranks
    first; the gradients come back at full shape."""
    import contextlib
    import torch
    from gaiaseg_tpu_torch.data import SyntheticDataset
    from gaiaseg_tpu_torch.engine import build_optimizer, prepare_batch
    from gaiaseg_tpu_torch.engine import train as train_mod
    from gaiaseg_tpu_torch.models import encode_arch, model_max_arch
    from gaiaseg_tpu_torch.ops import dynamic_layers
    from gaiaseg_tpu_torch.parallel import sum_over_ranks
    model = _ddp_model(cfg, device).to(dtype).train()
    if model_parallel > 1:
        from gaiaseg_tpu_torch.parallel import make_mesh, shard_state
        shard_state(model, make_mesh(model_parallel))
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
    grads = {k: _full(p.grad, p) for k, p in model.named_parameters()}
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
        ctx["ddp_ref64"] = refs["float64"]     # phase tp's reference
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


# the tp phase: tensor parallelism over a model axis of 2 (JAX's
# model_parallel), its ranks over gloo sharing cuda:0 as phase ddp's (NCCL
# refuses two ranks on one device)
TP_K = 2
TP_TIMEOUT_S = 900
TP_VIT_SAMPLES = 4          # samples_per_gpu: JAX's global batch 4 x 2 = 8
TP_VIT_BATCH = 8
TP_VIT_LR = 6e-5            # the ViT config's AdamW, weight decay 0.01
TP_VIT_CLIP = 1.0
# the float32 step under TP may be no farther from one process's float32
# step, and from the float64 step, than TP_FLOOR_RATIO times one process's
# float32 step is from float64 (gradients: global L2 and each tensor's L2;
# the update: its elements that change sign); the one-process float32
# repeat is printed beside it
TP_FLOOR_RATIO = 2.0
F32_EPS = 2.0 ** -23        # float32's machine epsilon
# the float32 step under TP against one process's float32 step, about 10x
# what an H100 80GB HBM3 reads (PERF.md): the gradients' global L2 2.39e-4
# (float32 reads 3.56e-2 from float64) and 252 elements of the AdamW
# update that change sign (float32 vs float64: 1,493,551)
TP_VS_ONE_GLOBAL = 2.5e-3
TP_VS_ONE_FLIPS = 2500
# the cycle's MIN: 4 of 12 heads and FFN 1536 of 3072 in every layer, so
# model rank 1 (heads 6-11, FFN features 1536-3071) holds none of them
TP_MIN = {"name": "MIN", "arch.backbone.embedding.width": 384,
          "arch.backbone.encoder.depth": 8,
          "arch.backbone.encoder.num_heads": [4] * 12,
          "arch.backbone.encoder.ffn_channels": [1536] * 12}
TP_FLAGSHIP_SAMPLES = 2     # the 2 x 2 mesh: 2 x 4 ranks = the batch of 8
TP_CUT_CROP = (512, 512)    # the 2 x 2 flagship crop when 4 ranks do not fit


def _tp_vit_cfg():
    cfg = _vit_cfg()
    cfg.merge_from_dict({"data.samples_per_gpu": TP_VIT_SAMPLES,
                         "model_parallel": TP_K})
    cfg["train_sampler"]["model_samplers"][0]["anchors"][1] = dict(TP_MIN)
    return cfg


def _tp_vit_batch(cfg, device):
    """8 records of the train crop's size (phase vit_segmentor's at
    512x512) on ``device``, labels partly ignored."""
    from gaiaseg_tpu_torch.data import SyntheticDataset, parse_train_pipeline
    from gaiaseg_tpu_torch.engine import prepare_batch
    crop = parse_train_pipeline(cfg["data"]["train"].get("pipeline")) \
        .crop_size
    ds = SyntheticDataset(length=TP_VIT_BATCH, size=tuple(crop),
                          num_classes=19, seed=5, cells=8)
    img, gt = prepare_batch([ds[i] for i in range(TP_VIT_BATCH)],
                            cfg["img_norm_cfg"], device)
    gt[:, :8] = 255
    return img, gt


def _full(t, p):
    """``t`` (a parameter's value or gradient) at the parameter's full
    shape: gathered over the model group when the parameter is sharded."""
    from gaiaseg_tpu_torch.parallel.tensor_parallel import gather_full, \
        tp_info
    info = tp_info(p)
    return t if info is None else gather_full(t, info)


def _tp_vit_step(model, img, gt, arch, dtype, flash):
    """One AdamW + clip step of the ViT at MAX in ``dtype`` (autocast off):
    (loss, clip norm, {name: full gradient after the clip}, {name: full
    update}, the optimizer, the step's bytes moved on each axis)."""
    import contextlib
    import torch
    from gaiaseg_tpu_torch.engine import build_optimizer
    from gaiaseg_tpu_torch.engine import train as train_mod
    from gaiaseg_tpu_torch.parallel import distributed, sum_over_ranks
    _set_flash(model, flash)
    model.to(dtype).train()
    with torch.no_grad():
        before = {k: _full(p.detach(), p).clone()
                  for k, p in model.named_parameters()}
    opt = build_optimizer(model.parameters(), {
        "type": "AdamW", "lr": TP_VIT_LR, "weight_decay": 0.01})
    amp = train_mod.autocast
    train_mod.autocast = lambda device: contextlib.nullcontext()
    distributed.reset_traffic()
    try:
        logs = train_mod.train_step(
            model, opt, img.to(dtype), gt, arch,
            torch.Generator(img.device).manual_seed(0), TP_VIT_CLIP)
    finally:
        train_mod.autocast = amp
    traffic = dict(distributed.TRAFFIC)
    with torch.no_grad():
        grads = {k: _full(p.grad, p).cpu().clone() for k, p in
                 model.named_parameters()}
        update = {k: (_full(p.detach(), p) - before[k]).cpu()
                  for k, p in model.named_parameters()}
    return (float(sum_over_ranks(logs["loss"].double())),
            float(logs["grad_norm"]), grads, update, opt, traffic)


def _state_bytes(model, opt):
    """(parameter bytes, optimizer-state bytes) this process holds."""
    import torch
    params = sum(p.numel() * p.element_size() for p in model.parameters())
    state = sum(v.numel() * v.element_size() for st in opt.state.values()
                for v in st.values() if isinstance(v, torch.Tensor))
    return params, state


def _tp_vit_rank(rank, world, port, state_path, out_path, cfg_dict,
                 device):
    """One rank of part (i): the float32 MAX step, then the bf16 sandwich
    cycle through ``train_segmentor`` (cold and warm) with the launch
    counts, state bytes, per-axis traffic and peak memory."""
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    import torch
    from gaiaseg_tpu_torch import parallel
    from gaiaseg_tpu_torch.engine import configure_numerics, train_segmentor
    from gaiaseg_tpu_torch.models import (build_segmentor, encode_arch,
                                          model_max_arch)
    from gaiaseg_tpu_torch.ops.cuda import LAUNCHES, reset_launches
    from gaiaseg_tpu_torch.parallel import distributed
    from gaiaseg_tpu_torch.utils import Config
    cuda = device == "cuda"
    if cuda:
        torch.cuda.set_device(0)
    configure_numerics()
    parallel.initialize_distributed(f"127.0.0.1:{port}", world, rank,
                                    backend="gloo", timeout_s=TP_TIMEOUT_S)
    out = {}
    cfg = Config(cfg_dict)
    state = torch.load(state_path)

    def fresh():
        model = build_segmentor(cfg["model"])
        model.load_state_dict(state)
        model = model.to(device)
        parallel.shard_state(model, parallel.make_mesh(TP_K))
        return model
    from gaiaseg_tpu_torch.engine import train as train_mod
    sync = train_mod.sync_replicated_grads
    drift = []

    def recorded(params):
        """The broadcast of the replicated gradients, with this rank's
        distance from model rank 0's before it (atomics may round the
        ranks' copies apart on the card)."""
        params = list(params)
        mine = {id(p): p.grad.detach().clone() for p in params
                if p.grad is not None and getattr(p, "tp", None) is None}
        moved = sync(params)
        d2 = r2 = 0.0
        worst, differ = 0.0, 0
        for p in params:
            if id(p) not in mine:
                continue
            ref = p.grad.detach().double()
            d = (mine[id(p)].double() - ref).abs()
            d2 += float(d.square().sum())
            r2 += float(ref.square().sum())
            worst = max(worst, float(d.max()))
            differ += int(bool(d.max() > 0))
        drift.append({"global": (d2 / max(r2, 1e-300)) ** 0.5,
                      "max_abs": worst, "tensors_differ": differ,
                      "tensors": len(mine)})
        return moved
    train_mod.sync_replicated_grads = recorded
    try:
        # 1. the float32 MAX step on the batch of 8 (one data index)
        model = fresh()
        out["report"] = parallel.shard_report(model)
        img, gt = _tp_vit_batch(cfg, device)
        arch = encode_arch(model_max_arch(cfg["model"]))
        reset_launches()
        loss, norm, grads, update, opt, traffic = _tp_vit_step(
            model, img, gt, arch, torch.float32, True)
        out["f32"] = {"loss": loss, "norm": norm,
                      "launches": dict(LAUNCHES), "traffic": traffic,
                      "bytes": _state_bytes(model, opt),
                      "drift": list(drift)}
        drift.clear()
        if rank == 0:
            torch.save({"grads": grads, "update": update},
                       out_path + ".f32")
        del model, opt, grads, update, img, gt
        if cuda:
            torch.cuda.empty_cache()

        # 2. the bf16 sandwich cycle (MAX, MIN, 2 random), then again warm
        model = fresh()
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        reset_launches()
        distributed.reset_traffic()
        st, hist = train_segmentor(model, cfg, device=device,
                                   max_iters=VIT_ITERS, seed=0)
        out["launches"] = dict(LAUNCHES)
        out["traffic"] = dict(distributed.TRAFFIC)
        out["drift"] = list(drift)
        train_mod.sync_replicated_grads = sync
        out["history"] = hist["loss"]
        out["bytes"] = _state_bytes(model, st.optimizer)
        out["warm"] = train_segmentor(model, cfg, device=device,
                                      max_iters=VIT_ITERS, seed=0)[1]["loss"]
        out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9 \
            if cuda else None
        # K3-K5's device time in a profiled bf16 MAX step on the head shard
        out["profile"] = _profile_max_step(model, cfg, out["warm"],
                                           f"tp rank {rank}") if cuda \
            else None
        # replicated parameters equal on both model ranks, bit for bit,
        # after the broadcasts
        sums = {k: float(p.detach().double().sum())
                for k, p in model.named_parameters()
                if getattr(p, "tp", None) is None}
        out["replicated_equal"] = len(set(
            tuple(sorted(s.items()))
            for s in parallel.all_gather_objects(sums))) == 1
        parallel.barrier()
    finally:
        train_mod.sync_replicated_grads = sync
        torch.save(out, out_path)
        parallel.shutdown_distributed()


def _tp_flagship_rank(rank, world, port, cfg_dict, out_path, device):
    """One rank of parts (ii) and (iii): the flagship's float64 MAX step at
    ``model_parallel`` 2 (data index d reads records [d*n, (d+1)*n) of the
    8); rank 0 saves the loss and the full gradients."""
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    import torch
    from gaiaseg_tpu_torch import parallel
    from gaiaseg_tpu_torch.engine import configure_numerics
    from gaiaseg_tpu_torch.utils import Config
    if device == "cuda":
        torch.cuda.set_device(0)
    configure_numerics()
    parallel.initialize_distributed(f"127.0.0.1:{port}", world, rank,
                                    backend="gloo", timeout_s=TP_TIMEOUT_S)
    out = {}
    try:
        d_size = world // TP_K
        n = DDP_WORLD * DDP_BATCH // d_size
        d = rank // TP_K
        loss, grads = _one_step(Config(cfg_dict), slice(d * n, (d + 1) * n),
                                device, torch.float64,
                                model_parallel=TP_K)
        out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9 \
            if device == "cuda" else None
        if rank == 0:
            out["loss"] = loss
            out["grads"] = {k: g.cpu() for k, g in grads.items()}
        parallel.barrier()
    finally:
        torch.save(out, out_path)
        parallel.shutdown_distributed()


def _spawn_ranks(target, world, args_of, tag):
    """``target(rank, world, port, *args_of(rank))`` on ``world`` spawned
    processes; raises unless every one exits 0 within TP_TIMEOUT_S."""
    import socket
    import torch.multiprocessing as mp
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    spawn = mp.get_context("spawn")
    procs = [spawn.Process(target=target, args=(r, world, port,
                                                *args_of(r)))
             for r in range(world)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    for p in procs:
        p.join(max(TP_TIMEOUT_S - (time.perf_counter() - t0), 1))
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(30)
    check(all(p.exitcode == 0 for p in procs),
          f"tp: {tag} rank exit codes {[p.exitcode for p in procs]}")
    return time.perf_counter() - t0


def _dist(got, ref):
    """Global L2 and worst per-tensor max|d|/max|ref| of two {name:
    tensor} maps."""
    d2 = sum(float((got[k].double() - v.double()).square().sum())
             for k, v in ref.items())
    r2 = sum(float(v.double().square().sum()) for v in ref.values())
    worst = max((float((got[k].double() - v.double()).abs().max())
                 / max(float(v.abs().max()), 1e-30), k)
                for k, v in ref.items())
    return {"global": (d2 / max(r2, 1e-300)) ** 0.5, "worst": worst[0],
            "worst_tensor": worst[1]}


def _tp_vit(ctx, tmp, smi):
    """Part (i): the ViT at full width on 2 ranks at model_parallel 2."""
    import torch
    from gaiaseg_tpu_torch.archspace import build_model_sampler
    from gaiaseg_tpu_torch.models import (build_segmentor, encode_arch,
                                          model_max_arch)
    from gaiaseg_tpu_torch.parallel import tp_plan
    cfg = _tp_vit_cfg()
    model = _build_model(cfg)
    state = {k: v.cpu() for k, v in model.state_dict().items()}
    state_path = os.path.join(tmp, "vit_state.pt")
    torch.save(state, state_path)
    n_full = sum(p.numel() for p in model.parameters())
    img, gt = _tp_vit_batch(cfg, "cuda")
    arch = encode_arch(model_max_arch(cfg["model"]))
    # one process x 8: float64 (dense attention: the kernels take bf16 and
    # float32), float32 on K3-K5's float32 instances, twice
    one = {}
    for name, dtype, flash in (("float64", torch.float64, False),
                               ("float32", torch.float32, True),
                               ("float32_again", torch.float32, True)):
        model.load_state_dict(state)
        torch.cuda.reset_peak_memory_stats()
        loss, norm, grads, update, opt, _ = _tp_vit_step(
            model, img, gt, arch, dtype, flash)
        one[name] = {"loss": loss, "norm": norm, "grads": grads,
                     "update": update,
                     "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        if name == "float32":
            one_bytes = _state_bytes(model, opt)
        del opt, grads, update
        torch.cuda.empty_cache()
    del model, img, gt
    torch.cuda.empty_cache()
    plan = tp_plan(build_segmentor(cfg["model"]), TP_K)
    # K3-K5 launch once a layer on a rank whose shard holds an active head
    sampler = build_model_sampler(cfg["train_sampler"])
    archs = [encode_arch(model_max_arch(cfg["model"]), sampler.sample())
             ["backbone"]["encoder"] for _ in range(VIT_ITERS)]
    per = 12 // TP_K
    flash_want = [sum(1 for a in archs for i in range(a["depth"])
                      if a["num_heads"][i] > m * per) for m in range(TP_K)]

    outs = [os.path.join(tmp, f"vit_rank{r}.pt") for r in range(TP_K)]
    secs = _spawn_ranks(_tp_vit_rank, TP_K, lambda r: (
        state_path, outs[r], cfg.to_dict(), "cuda"), "vit")
    ranks = [torch.load(o, weights_only=False) for o in outs]
    tp32 = torch.load(outs[0] + ".f32", weights_only=False)
    ref = one["float64"]
    e = {"tp_grads": _dist(tp32["grads"], ref["grads"]),
         "one_grads": _dist(one["float32"]["grads"], ref["grads"]),
         "repeat_grads": _dist(one["float32_again"]["grads"],
                               one["float32"]["grads"]),
         "tp_update": _dist(tp32["update"], ref["update"]),
         "one_update": _dist(one["float32"]["update"], ref["update"])}
    one32, f64 = one["float32"], ref
    e["tp_vs_one_grads"] = _dist(tp32["grads"], one32["grads"])
    # each tensor: TP's distance from one process's float32 step against
    # that step's own distance from float64 (its float32 noise; at least
    # float32's epsilon of the tensor), in L2
    ratios = []
    for k, v in f64["grads"].items():
        v = v.double()
        noise = max(float((one32["grads"][k].double() - v).norm()),
                    F32_EPS * float(v.norm()))
        d = float((tp32["grads"][k].double()
                   - one32["grads"][k].double()).norm())
        ratios.append((d / noise if noise > 0 else (0.0 if d == 0
                                                    else math.inf), k))
    ratios.sort(reverse=True)
    # AdamW's first update is +-lr an element, so its distance says little:
    # count the elements whose update changed sign (|d| > lr) from one
    # process's float32 step, against float32's own count from float64

    def flipped(a, b):
        return sum(int(((a[k] - b[k]).abs() > TP_VIT_LR).sum())
                   for k in f64["update"])
    flip = max(float((tp32["update"][k] - one32["update"][k]).abs().max())
               for k in f64["update"])
    flips = flipped(tp32["update"], one32["update"])
    flips_floor = flipped(one32["update"], f64["update"])
    loss_rel = abs(ranks[0]["f32"]["loss"] - one32["loss"]) \
        / abs(one32["loss"])
    limit = TP_FLOOR_RATIO * e["one_grads"]["global"]
    print(f"[tp] ViT-B/16 UPerNet at 1024 tokens, MAX, batch 8, float32 "
          f"(K3-K5's float32 instances, TF32 off), AdamW + clip "
          f"{TP_VIT_CLIP}: 2 ranks at model_parallel {TP_K} vs one process: "
          f"loss {ranks[0]['f32']['loss']:.7f} vs {one32['loss']:.7f}"
          f" (rel {loss_rel:.1e}), clip norm {ranks[0]['f32']['norm']:.6f} "
          f"vs {one32['norm']:.6f}")
    print(f"[tp] gradients vs one process's float64 (dense): 2 ranks "
          f"global {e['tp_grads']['global']:.2e} worst "
          f"{e['tp_grads']['worst']:.1e} ({e['tp_grads']['worst_tensor']}); "
          f"one process float32 (the floor) global "
          f"{e['one_grads']['global']:.2e} worst {e['one_grads']['worst']:.1e}"
          f"; one process float32 repeat vs float32 global "
          f"{e['repeat_grads']['global']:.2e}; tolerance "
          f"{TP_FLOOR_RATIO} x floor = {limit:.2e}")
    print(f"[tp] gradients, 2 ranks vs one process's float32: global "
          f"{e['tp_vs_one_grads']['global']:.2e} (tolerance "
          f"{TP_VS_ONE_GLOBAL:.1e}), "
          f"worst max|d|/max|ref| {e['tp_vs_one_grads']['worst']:.1e} ("
          f"{e['tp_vs_one_grads']['worst_tensor']}); each tensor's L2 "
          f"distance over one process's float32 distance from float64: "
          + ", ".join(f"{r:.3f} ({k})" for r, k in ratios[:3])
          + f", median {ratios[len(ratios) // 2][0]:.3f}; tolerance "
          f"{TP_FLOOR_RATIO}")
    print(f"[tp] updates vs float64: 2 ranks global "
          f"{e['tp_update']['global']:.2e}, one process float32 "
          f"{e['one_update']['global']:.2e}; 2 ranks vs one process float32:"
          f" max|d| {flip:.2e}, {flips} of {n_full} elements changed sign "
          f"(|d| > lr {TP_VIT_LR:.0e}; tolerance {TP_VS_ONE_FLIPS}); one "
          f"process float32 vs float64: {flips_floor}")
    check(loss_rel <= F32_LOSS_RTOL,
          f"tp: ViT float32 loss rel {loss_rel:.1e} to one process")
    check(e["tp_grads"]["global"] <= limit,
          f"tp: ViT float32 gradients {e['tp_grads']['global']:.2e} from "
          f"float64, limit {limit:.2e}")
    check(e["tp_vs_one_grads"]["global"] <= TP_VS_ONE_GLOBAL,
          f"tp: ViT float32 gradients {e['tp_vs_one_grads']['global']:.2e} "
          f"from one process's float32, limit {TP_VS_ONE_GLOBAL:.1e}")
    check(ratios[0][0] <= TP_FLOOR_RATIO,
          f"tp: ViT float32 gradient of {ratios[0][1]} is {ratios[0][0]:.3f}"
          f" x one process's float32 noise from one process's")
    check(flips <= min(TP_VS_ONE_FLIPS, TP_FLOOR_RATIO * flips_floor),
          f"tp: ViT float32 update changed sign in {flips} elements from "
          f"one process's, limit {TP_VS_ONE_FLIPS} (float32 from float64: "
          f"{flips_floor})")
    for r, res in enumerate(ranks):
        d = res["f32"]["drift"] + res["drift"]
        print(f"[tp] ViT rank {r}: replicated gradients before model rank "
              f"0's broadcast, from rank 0's: float32 MAX step global "
              f"{res['f32']['drift'][0]['global']:.2e} max|d| "
              f"{res['f32']['drift'][0]['max_abs']:.2e} ("
              f"{res['f32']['drift'][0]['tensors_differ']} of "
              f"{res['f32']['drift'][0]['tensors']} tensors differ); bf16 "
              f"cycle global " + ", ".join(
                  f"{x['global']:.2e}" for x in res["drift"])
              + f" ({max(x['tensors_differ'] for x in res['drift'])} "
              f"tensors differ at most)")
        check(len(res["f32"]["drift"]) == 1 and res["drift"]
              and all(math.isfinite(x["global"]) for x in d),
              f"tp: rank {r} replicated-gradient readings {d}")
    for r, res in enumerate(ranks):
        check(res["report"] == plan, f"tp: rank {r} shard report differs "
              "from tp_plan")
        check(res["replicated_equal"], f"tp: rank {r}: replicated "
              "parameters differ across the model ranks after the cycle "
              "(the broadcasts keep them equal)")
    routes = {}
    for name, (_, _, route) in plan.items():
        routes[route] = routes.get(route, 0) + 1
    print(f"[tp] shard report: {len(plan)} of {len(state)} tensors sharded "
          f"(routes {routes}); replicated parameters equal on both ranks "
          "after the cycle (checksums)")

    # the cycle: archs, launches per rank, bytes, traffic, times, memory
    names = [h["arch"] for h in ranks[0]["history"]]
    check(names == ["MAX", "MIN", "random", "random"],
          f"tp: ViT cycle archs {names}")
    for r, res in enumerate(ranks):
        check(all(math.isfinite(h["loss"]) for h in res["history"]),
              f"tp: rank {r} non-finite loss")
        for k in ("resize_ce_fwd", "resize_ce_bwd"):
            check(res["launches"][k] == 2 * VIT_ITERS,
                  f"tp: rank {r} {k} launched {res['launches'][k]} times")
        for k in FLASH_KERNELS:
            check(res["launches"][k] == flash_want[r],
                  f"tp: rank {r} {k} launched {res['launches'][k]} times, "
                  f"want {flash_want[r]} (its layers with an active head)")
            check(res["f32"]["launches"][k] == 12,
                  f"tp: rank {r} {k} launched {res['f32']['launches'][k]} "
                  "times in the float32 MAX step, want 12")
    check([h["loss"] for h in ranks[0]["history"]]
          == [h["loss"] for h in ranks[1]["history"]],
          "tp: the model ranks logged different losses")
    bytes_one = one_bytes
    t = {"checks": e, "flip_max": flip, "flips": flips,
         "flips_floor": flips_floor, "tensor_ratios": ratios[:10],
         "loss_rel": loss_rel,
         "tolerance": limit, "flash_want": flash_want, "one_process": {
             k: {kk: v[kk] for kk in ("loss", "norm", "peak_gb")}
             for k, v in one.items()},
         "one_process_bytes": bytes_one, "seconds": secs,
         "ranks": [{k: v for k, v in res.items()} for res in ranks]}
    for r, res in enumerate(ranks):
        p_b, o_b = res["bytes"]
        steps = len(res["history"])
        print(f"[tp] ViT rank {r}: parameters {p_b / 1e9:.3f} GB, AdamW "
              f"state {o_b / 1e9:.3f} GB (one process {bytes_one[0] / 1e9:.3f}"
              f" + {bytes_one[1] / 1e9:.3f} GB: {p_b / bytes_one[0]:.3f}, "
              f"{o_b / bytes_one[1]:.3f}); per step moved model axis "
              f"{res['traffic']['model'] / steps / 1e6:.1f} MB, data axis "
              f"{res['traffic']['data'] / steps / 1e6:.1f} MB (float32 MAX "
              f"step: {res['f32']['traffic']['model'] / 1e6:.1f} / "
              f"{res['f32']['traffic']['data'] / 1e6:.1f} MB); K1-K5 "
              + "/".join(str(res["launches"][k]) for k in (
                  "resize_ce_fwd", "resize_ce_bwd") + FLASH_KERNELS)
              + "; bf16 cycle step ms " + ", ".join(
                  f"{h['arch']} {h['step_ms']:.1f}" for h in res["history"])
              + "; warm " + ", ".join(
                  f"{h['arch']} {h['step_ms']:.1f}" for h in res["warm"])
              + "; least MAX {:.1f} ms".format(min(
                  h["step_ms"] for h in res["history"] + res["warm"]
                  if h["arch"] == "MAX"))
              + f"; peak {res['peak_gb'] or 0:.2f} GB; on {smi}")
    ctx["tp_vit"] = t
    return ranks


def _tp_flagship(ctx, tmp, smi, world, ref, cfg, tag):
    """Parts (ii) and (iii): the flagship float64 MAX step on ``world``
    ranks at model_parallel 2 against the one-process reference ``ref``."""
    import torch
    outs = [os.path.join(tmp, f"{tag}_rank{r}.pt") for r in range(world)]
    secs = _spawn_ranks(_tp_flagship_rank, world, lambda r: (
        cfg.to_dict(), outs[r], "cuda"), tag)
    ranks = [torch.load(o, weights_only=False) for o in outs]
    e = _grad_errors(ranks[0]["loss"], ranks[0]["grads"], ref["loss"],
                     ref["grads"])
    d = world // TP_K
    print(f"[tp] flagship float64 MAX step, {d} data x {TP_K} model ranks "
          f"({world}) vs one process x {DDP_WORLD * DDP_BATCH}: loss rel "
          f"{e['loss_rel']:.1e}, grad global {e['global_rel']:.2e}, median "
          f"{e['median_grad_rel']:.1e}, worst {e['worst_grad_rel']:.1e} "
          f"({e['worst_tensor']}); tolerance {DDP_F64_RTOL}; peak GB a rank "
          f"{[round(r['peak_gb'] or 0, 2) for r in ranks]}; {secs:.1f} s")
    check(e["loss_rel"] <= DDP_F64_RTOL
          and e["worst_grad_rel"] <= DDP_F64_RTOL,
          f"tp: flagship {tag}: loss rel {e['loss_rel']:.1e}, worst grad "
          f"{e['worst_grad_rel']:.1e} ({e['worst_tensor']})")
    e.pop("worst5", None)
    return {"errors": e, "seconds": secs,
            "peak_gb": [r["peak_gb"] for r in ranks]}


def phase_tp(ctx):
    """Tensor parallelism on the card: (i) the ViT at model_parallel 2 on
    2 gloo ranks (float32 MAX step vs one process, a bf16 sandwich cycle);
    (ii) the flagship's float64 MAX step on 2 ranks and (iii) on 2 data x 2
    model ranks, each against one process."""
    import shutil
    import tempfile
    import torch
    from gaiaseg_tpu_torch.ops.cuda import reset_launches
    smi = ctx.get("nvidia_smi") or nvidia_smi_line()
    tmp = tempfile.mkdtemp(prefix="gseg_tp_")
    torch.cuda.empty_cache()
    print(f"[tp] the ranks share cuda:0 over gloo, whose all_reduce and "
          f"broadcast take CUDA tensors (copied through the host by gloo); "
          f"the port's model-axis gather is one all_reduce of a zero-padded "
          f"buffer, nothing is staged by the port; this process holds "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB on the card")
    try:
        ranks = _tp_vit(ctx, tmp, smi)
        ctx["tp_launches"] = {k: sum(r["launches"][k] for r in ranks)
                              for k in ranks[0]["launches"]}
        ctx["tp_rank_launches"] = [r["launches"] for r in ranks]

        # (ii) the flagship at model_parallel 2 on 2 ranks, float64
        ref = ctx.get("ddp_ref64")
        cfg8 = _ddp_cfg(DDP_WORLD * DDP_BATCH)
        if ref is None:
            loss, grads = _one_step(cfg8, slice(None), "cuda",
                                    torch.float64)
            ref = {"loss": loss, "grads": {k: g.cpu()
                                           for k, g in grads.items()}}
            del grads
            torch.cuda.empty_cache()
        res = {"flagship_2": _tp_flagship(ctx, tmp, smi, TP_K, ref, cfg8,
                                          "flagship_2")}
        # (iii) 2 data x 2 model ranks, samples_per_gpu 2: 4 float64 ranks
        # of 4 records each must fit beside this process
        cfg4 = _ddp_cfg(TP_FLAGSHIP_SAMPLES)
        free = torch.cuda.mem_get_info()[0] / 1e9
        per_rank = (ctx.get("ddp") or {}).get("peak_gb", {}).get(
            "float64", 35.1) / 2
        need = 2 * TP_K * per_rank * 1.25
        if need > free:
            cfg4.merge_from_dict({"data.train.size": list(TP_CUT_CROP)})
            cfg8c = _ddp_cfg(DDP_WORLD * DDP_BATCH)
            cfg8c.merge_from_dict({"data.train.size": list(TP_CUT_CROP)})
            loss, grads = _one_step(cfg8c, slice(None), "cuda",
                                    torch.float64)
            ref = {"loss": loss, "grads": {k: g.cpu()
                                           for k, g in grads.items()}}
            del grads
            torch.cuda.empty_cache()
            print(f"[tp] 2 x 2: 4 float64 ranks of 4 records need ~{need:.1f}"
                  f" GB, {free:.1f} GB free: the crop is cut to "
                  f"{TP_CUT_CROP[0]}x{TP_CUT_CROP[1]} (records and the "
                  "one-process reference alike)")
        else:
            print(f"[tp] 2 x 2 at 512x1024: ~{need:.1f} GB needed, "
                  f"{free:.1f} GB free")
        res["flagship_2x2"] = _tp_flagship(ctx, tmp, smi, 2 * TP_K, ref,
                                           cfg4, "flagship_2x2")
        ctx["tp"] = {"vit": ctx.pop("tp_vit"), **res}
    finally:
        reset_launches()
        shutil.rmtree(tmp, ignore_errors=True)


# the distill phase: the DynamicDistiller at full width (a BEiT-base teacher
# from an official-layout .pth of a 224x224 pretraining, then a flagship
# supernet teaching a fresh one), on the flagship student at 512x512
DISTILL_BEIT = os.path.join(REPO, "configs", "local_examples",
                            "train_supernet", "soak_distill_512.py")
DISTILL_SELF = os.path.join(REPO, "configs", "local_examples",
                            "train_supernet",
                            "soak_distill_resnet_teacher.py")
DISTILL_BATCH = 8
PRETRAIN_WINDOW = 14          # BEiT-base pretrained at 224x224, patch 16
DISTILL_LOSS_RTOL = 1e-4      # card (K1/K2) vs CPU (plain), float32, each
                              # loss of one 512x512 image
DISTILL_RANKS, DISTILL_RANK_BATCH = 2, 4
DISTILL_F64_RTOL = 1e-6       # 2 ranks x 4 vs 1 x 8, float64, per tensor
# K1/K2 at the flagship student's losses on a 512x512 crop: decode logits
# at output stride 32 (16x16, row factor 32), aux at 16 (32x32, factor 16)
DISTILL_LOSSES = {"ds_decode": (8, 19, 16, 16, 512, 512),
                  "ds_aux": (8, 19, 32, 32, 512, 512)}


def _distill_cfg(path, teacher_path):
    """``path``'s config with the flagship's synthetic records (512x512,
    kept on the card) through its own train pipeline, every step a full
    one, the teacher file given, no checkpoint or eval in 8 iterations."""
    from gaiaseg_tpu_torch.models import fill_img_size
    from gaiaseg_tpu_torch.utils import Config
    cfg = Config.fromfile(path)
    cfg.merge_from_dict({
        "data.train": {"type": "SyntheticDataset", "size": [512, 512],
                       "length": 16, "num_classes": 19, "seed": 0,
                       "cells": 8, "device_cache": True},
        "data.samples_per_gpu": DISTILL_BATCH,
        "cudnn_benchmark": False, "auto_resume": False,
        "log_config.interval": 1,
        "teacher_checkpoint": teacher_path})
    fill_img_size(cfg)
    return cfg


def _official_beit_teacher(path, cfg):
    """Write a seeded teacher segmentor ``.pth`` in the official BEiT layout
    (``backbone.*``: blocks with q/v biases, per-block tables of a
    PRETRAIN_WINDOW window and their index buffers, the FPN adapters with
    ``fpn1.1`` a BN; ``decode_head.*``: the UPer head; ``auxiliary_head.*``,
    left behind); returns the state dict."""
    import copy
    import torch
    from gaiaseg_tpu_torch.models import build_backbone, build_head
    from gaiaseg_tpu_torch.models.backbones.beit import relative_position_index
    torch.manual_seed(11)
    bb_cfg = dict(copy.deepcopy(cfg["model"]["teacher_backbone"]),
                  img_size=PRETRAIN_WINDOW * 16)
    beit = build_backbone(bb_cfg)
    head = build_head(cfg["model"]["teacher_decode_head"],
                      beit.out_channels())
    g = torch.Generator().manual_seed(12)
    sd = {}
    for k, v in beit.state_dict().items():
        if k.startswith("fpn1.1."):        # the port's LayerNorm
            continue
        if k.endswith("relative_position_bias_table"):
            v = torch.randn(v.shape, generator=g) * 0.5
        elif k.endswith(("q_bias", "v_bias")):
            v = torch.randn(v.shape, generator=g) * 0.02
        sd["backbone." + k] = v
    idx = torch.from_numpy(relative_position_index(
        PRETRAIN_WINDOW, PRETRAIN_WINDOW).astype("int64"))
    for i in range(len(beit.blocks)):
        sd[f"backbone.blocks.{i}.attn.relative_position_index"] = idx
    d = beit.embed_dim
    sd.update({"backbone.fpn1.1.weight": torch.rand(d, generator=g) + 0.5,
               "backbone.fpn1.1.bias": torch.randn(d, generator=g) * 0.1,
               "backbone.fpn1.1.running_mean": torch.randn(d, generator=g),
               "backbone.fpn1.1.running_var": torch.rand(d, generator=g) + .5,
               "backbone.fpn1.1.num_batches_tracked": torch.tensor(1000)})
    for k, v in head.state_dict().items():
        if k.endswith("running_var"):
            v = torch.rand(v.shape, generator=g) + 0.5
        elif k.endswith(("running_mean", "bn.bias")):
            v = torch.randn(v.shape, generator=g) * 0.1
        sd["decode_head." + k] = v
    sd["auxiliary_head.conv_seg.weight"] = torch.zeros(19, 256, 1, 1)
    torch.save({"meta": {"note": "seeded, official BEiT layout"},
                "state_dict": sd}, path)
    return sd


def _teacher_state(model):
    return {k: v.detach().cpu().clone() for k, v in model.state_dict().items()
            if k.startswith(("t_backbone.", "t_neck.", "t_decode_head."))}


def _distill_losses_f32(model, img, gt, arch):
    """forward_train's losses in float32 (autocast off) in eval mode (BN
    running statistics, no dropout), the whole pairwise maps (no
    generator)."""
    import torch
    model.eval()
    with torch.no_grad(), torch.autocast(img.device.type, enabled=False):
        _, logs = model.forward_train(img, gt, arch)
    return {k: float(v) for k, v in logs.items()}


def _distill_rank(rank, world, port, cfg_dict, ref_path, out_path):
    """One of the ranks of the distill phase's float64 MAX step."""
    import torch
    from gaiaseg_tpu_torch import parallel
    from gaiaseg_tpu_torch.engine import configure_numerics
    from gaiaseg_tpu_torch.utils import Config
    torch.cuda.set_device(0)
    configure_numerics()
    parallel.initialize_distributed(f"127.0.0.1:{port}", world, rank,
                                    backend="gloo", timeout_s=DDP_TIMEOUT_S)
    out = {}
    try:
        rows = slice(rank * DISTILL_RANK_BATCH,
                     (rank + 1) * DISTILL_RANK_BATCH)
        loss, grads = _one_step(Config(cfg_dict), rows, "cuda",
                                torch.float64)
        grads = {k: g for k, g in grads.items() if g is not None}
        if rank == 0:
            ref = torch.load(ref_path)
            out = _grad_errors(loss, grads, ref["loss"], ref["grads"])
            out["tensors"] = len(grads)
        parallel.barrier()
    finally:
        torch.save(out, out_path)
        parallel.shutdown_distributed()


def phase_distill(ctx):
    """The DynamicDistiller at full width on one card: K1/K2 at the
    student's loss shapes against their plain versions; the BEiT-base
    teacher route (``soak_distill_512.py``) from an official-layout
    ``.pth`` through the table surgery, one sandwich cycle and its warm
    repeats, the teacher bit-equal after training and outside the
    optimizer, a profiled MAX step with the teacher's share, card vs CPU
    losses in float32; the self-distillation route
    (``soak_distill_resnet_teacher.py``) from ``make_teacher_ckpt``; a
    float64 MAX step on 2 gloo ranks x 4 against one process x 8."""
    import shutil
    import socket
    import tempfile
    import torch
    import torch.multiprocessing as mp
    from gaiaseg_tpu_torch.data import build_dataset
    from gaiaseg_tpu_torch.engine import (configure_numerics, prepare_batch,
                                          train_segmentor)
    from gaiaseg_tpu_torch.engine.ckpt_surgery import \
        resample_rel_pos_bias_table
    from gaiaseg_tpu_torch.engine.teacher import load_teacher_checkpoint
    from gaiaseg_tpu_torch.models import (build_segmentor, encode_arch,
                                          model_max_arch)
    from gaiaseg_tpu_torch.ops.cuda import LAUNCHES, reset_launches
    from gaiaseg_tpu_torch.tools import make_teacher_ckpt
    smi = ctx.get("nvidia_smi") or nvidia_smi_line()
    out = ctx["distill"] = {}
    configure_numerics()
    torch.backends.cudnn.benchmark = False
    # 0. K1/K2 at this path's loss shapes against their plain versions
    errs = {"resize_ce_fwd": 0.0, "resize_ce_bwd": 0.0}
    checks = out["kernel_checks"] = []
    for name, shape in DISTILL_LOSSES.items():
        for dtype in (torch.float32, torch.bfloat16):
            _check_case(name, shape, dtype, seed=1, errs=errs, log=checks)
    timings = out["kernel_timings"] = {}
    for name, shape in DISTILL_LOSSES.items():
        _time_case(name, shape, timings)
    out["max_abs_err"] = errs
    tmp = tempfile.mkdtemp(prefix="gseg_distill_")
    try:
        # 1. the teacher file, the model, and the teacher it must load
        t0 = time.perf_counter()
        pth = os.path.join(tmp, "beit_upernet_teacher.pth")
        cfg = _distill_cfg(DISTILL_BEIT, pth)
        file_sd = _official_beit_teacher(pth, cfg)
        out["teacher_file_mb"] = os.path.getsize(pth) / 1e6
        torch.manual_seed(0)
        cpu_model = build_segmentor(cfg["model"])
        res = load_teacher_checkpoint(pth, cpu_model)
        loaded = _teacher_state(cpu_model)
        table = "blocks.3.attn.relative_position_bias_table"
        want = resample_rel_pos_bias_table(
            file_sd["backbone." + table].numpy(), PRETRAIN_WINDOW, 32)
        deconvs = [k for k in file_sd if k.startswith(
            ("backbone.fpn1.0.", "backbone.fpn1.3.", "backbone.fpn2.0."))]
        check(torch.equal(loaded["t_backbone." + table],
                          torch.from_numpy(want))
              and loaded["t_backbone." + table].shape[0] == 63 * 63 + 3
              and len(deconvs) == 6 and all(
                  torch.equal(loaded["t_" + k], file_sd[k]) for k in deconvs)
              and res["kept_init"] == ["t_backbone.fpn1.1.bias",
                                       "t_backbone.fpn1.1.weight"],
              f"distill: teacher file load: kept at init {res['kept_init']}")
        model = _build_model(cfg)      # seed 0: the same FPN init
        n_t = sum(p.numel() for m in model.teacher_modules()
                  for p in m.parameters())
        n_s = sum(p.numel() for p in model.parameters()) - n_t
        print(f"[distill] BEiT-base teacher (768 wide, depth 12, 12 heads, "
              f"rel-pos tables {PRETRAIN_WINDOW}x{PRETRAIN_WINDOW} -> 32x32, "
              f"out 3/5/7/11) + UPer 512: {n_t / 1e6:.2f} M parameters "
              f"({out['teacher_file_mb']:.0f} MB file); flagship student "
              f"{n_s / 1e6:.2f} M; batch {DISTILL_BATCH} of 512x512; set-up "
              f"{time.perf_counter() - t0:.1f}s")

        # 2. one sandwich cycle through train_segmentor (the teacher file
        # through teacher_checkpoint), then the warm ones
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        state, hist = train_segmentor(
            model, cfg, device="cuda", max_iters=8, seed=0,
            log=lambda s: print(f"[distill] {s}"))
        launches = out["launches"] = dict(LAUNCHES)
        cold = hist["loss"]
        out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        names = [r["arch"] for r in cold]
        check(names == ["MAX", "MIN", "R101", "R77", "R50"] + ["random"] * 3,
              f"distill: arch sequence {names}")
        check(all(math.isfinite(r[k]) for r in cold for k in
                  ("loss", "distill_loss_seg", "pairwise_loss_seg")),
              f"distill: losses {cold}")
        for k in ("resize_ce_fwd", "resize_ce_bwd"):
            check(launches[k] == 2 * len(cold),
                  f"distill: {k} launched {launches[k]} times in "
                  f"{len(cold)} iterations (want 2 per iteration)")
        after = _teacher_state(model)
        check(after.keys() == loaded.keys() and all(
            torch.equal(after[k], loaded[k]) for k in loaded),
            "distill: the teacher moved in training: " + str(
                [k for k in loaded if not torch.equal(after[k], loaded[k])]
                [:4]))
        t_ids = {id(p) for m in model.teacher_modules()
                 for p in m.parameters()}
        held = {id(p) for g in state.optimizer.param_groups
                for p in g["params"]}
        check(not t_ids & held and len(held) > 0,
              "distill: the optimizer holds teacher parameters")
        print(f"[distill] cycle losses: " + ", ".join(
            f"{r['arch']} {r['loss']:.3f}/{r['distill_loss_seg']:.3f}/"
            f"{r['pairwise_loss_seg']:.3f}" for r in cold)
            + " (decode/distill/pairwise)")
        print(f"[distill] launches {launches}; {len(loaded)} teacher tensors"
              f" bit-equal to the loaded ones after the cycle; the "
              f"optimizer holds none of them; peak memory "
              f"{out['peak_mem_gb']:.2f} GB; on {smi}")
        cfg["teacher_checkpoint"] = None     # loaded; the repeats reuse it
        warm = train_segmentor(model, cfg, device="cuda", max_iters=8,
                               seed=0)[1]["loss"]
        out["cold_history"], out["warm_history"] = cold, warm
        out.update(_steady_step_ms(model, cfg, warm, "distill"))
        prof = out["profile"] = _profile_max_step(
            model, cfg, warm, "distill", ranges=("teacher_forward",))
        busy = prof["device_busy_ms"]
        teacher_ms = prof["ranges_ms"]["teacher_forward"]
        check(busy > 0 and teacher_ms > 0,
              f"distill: profiled MAX step busy {busy} ms, teacher "
              f"{teacher_ms} ms")
        out["teacher_ms"], out["teacher_share"] = teacher_ms, teacher_ms / busy
        ds = build_dataset(cfg["data"]["train"])

        # 3. card (K1/K2) vs CPU (plain) losses, float32, one image
        cpu_model.load_state_dict({k: v.cpu() for k, v in
                                   model.state_dict().items()})
        max_arch = encode_arch(model_max_arch(cfg["model"]))
        rec = ds[3]
        img1, gt1 = prepare_batch([rec], cfg["img_norm_cfg"], "cuda")
        reset_launches()
        card = _distill_losses_f32(model, img1, gt1, max_arch)
        k_card = dict(LAUNCHES)
        t0 = time.perf_counter()
        cpu = _distill_losses_f32(cpu_model, img1.cpu(), gt1.cpu(), max_arch)
        cpu_s = time.perf_counter() - t0
        rel = {k: abs(card[k] - cpu[k]) / max(abs(cpu[k]), 1e-30)
               for k in cpu}
        check(set(card) == set(cpu) and k_card["resize_ce_fwd"] == 2
              and max(rel.values()) <= DISTILL_LOSS_RTOL,
              f"distill: card {card} vs CPU {cpu}, launches {k_card}")
        out["card_vs_cpu"] = {"card": card, "cpu": cpu, "rel": rel,
                              "cpu_s": cpu_s}
        print(f"[distill] float32 losses of one 512x512 image, card (K1/K2 "
              f"{k_card['resize_ce_fwd']}/{k_card['resize_ce_bwd']}) vs CPU "
              f"(plain, {cpu_s:.1f}s): " + ", ".join(
                  f"{k} {card[k]:.6f}/{cpu[k]:.6f} (rel {rel[k]:.1e})"
                  for k in sorted(cpu)))
        student_path = os.path.join(tmp, "flagship_supernet.pth")
        torch.save({"meta": {"iter": 32}, "state_dict": {
            k: v.cpu() for k, v in model.state_dict().items()
            if not k.startswith("t_")}}, student_path)
        del model, cpu_model, state, loaded, after, file_sd
        torch.cuda.empty_cache()

        # 4. self-distillation: the trained flagship supernet as teacher
        teacher_path = os.path.join(tmp, "flagship_teacher.pth")
        make_teacher_ckpt.main([student_path, teacher_path])
        scfg = _distill_cfg(DISTILL_SELF, teacher_path)
        smodel = _build_model(scfg)
        reset_launches()
        shist = train_segmentor(smodel, scfg, device="cuda", max_iters=1,
                                seed=0)[1]["loss"]
        s_launches = dict(LAUNCHES)
        src = torch.load(student_path, weights_only=False)["state_dict"]
        got = _teacher_state(smodel)
        same = [k for k in got if torch.equal(got[k], src[k[2:]])]
        check(len(same) == len(got) and len(got) == len(
            [k for k in src if k.startswith(("backbone.", "decode_head."))])
            and shist[0]["arch"] == "MAX" and math.isfinite(shist[0]["loss"])
            and s_launches["resize_ce_fwd"] == 2
            and s_launches["resize_ce_bwd"] == 2,
            f"distill: self-distillation: {len(same)}/{len(got)} teacher "
            f"tensors equal the supernet's, step {shist}, {s_launches}")
        out["self_distill"] = {"step": shist[0], "launches": s_launches,
                               "teacher_tensors": len(got)}
        print(f"[distill] self-distillation: make_teacher_ckpt of the "
              f"trained supernet -> {len(got)} teacher tensors (BN "
              f"statistics included) bit-equal to it; MAX step loss "
              f"{shist[0]['loss']:.4f}, distill "
              f"{shist[0]['distill_loss_seg']:.4f}, pairwise "
              f"{shist[0]['pairwise_loss_seg']:.4f}, "
              f"{shist[0]['step_ms']:.1f} ms (first); K1/K2 "
              f"{s_launches['resize_ce_fwd']}/{s_launches['resize_ce_bwd']}")
        del smodel, src, got
        torch.cuda.empty_cache()

        # 5. a float64 MAX step of the BEiT distiller (random teacher, seed
        # 0) on 2 gloo ranks x 4 against one process x 8
        rcfg = _distill_cfg(DISTILL_BEIT, None)
        t0 = time.perf_counter()
        loss, grads = _one_step(rcfg, slice(None), "cuda", torch.float64)
        ref_path = os.path.join(tmp, "ref.pt")
        torch.save({"loss": loss, "grads": {k: g.cpu() for k, g in
                                            grads.items() if g is not None}},
                   ref_path)
        del grads
        torch.cuda.empty_cache()
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        spawn = mp.get_context("spawn")
        outs = [os.path.join(tmp, f"rank{r}.pt")
                for r in range(DISTILL_RANKS)]
        procs = [spawn.Process(target=_distill_rank, args=(
            r, DISTILL_RANKS, port, _distill_cfg(DISTILL_BEIT, None)
            .to_dict(), ref_path, outs[r])) for r in range(DISTILL_RANKS)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(DDP_TIMEOUT_S)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(30)
        check(all(p.exitcode == 0 for p in procs),
              f"distill: rank exit codes {[p.exitcode for p in procs]}")
        e = torch.load(outs[0], weights_only=False)
        out["ranks_float64"] = e
        ranks_s = time.perf_counter() - t0
        print(f"[distill] float64 MAX step, 2 gloo ranks x "
              f"{DISTILL_RANK_BATCH} vs one process x {DISTILL_BATCH}: loss "
              f"rel {e['loss_rel']:.1e}, worst grad {e['worst_grad_rel']:.1e}"
              f" ({e['worst_tensor']}) over {e['tensors']} student tensors "
              f"({ranks_s:.1f}s)")
        check(e["loss_rel"] <= DISTILL_F64_RTOL
              and e["worst_grad_rel"] <= DISTILL_F64_RTOL,
              f"distill: ranks vs one process in float64: {e}")
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
# the ConvNeXt / Conformer / relative-position ViT paths: each trains a
# full-width supernet through train_segmentor on synthetic ADE20K-sized
# records kept on the card (batch 8 of 512x512 crops, ADE20K's pipeline)
TINY_CONVNEXT = os.path.join(REPO, "configs", "tests", "tiny_convnext_uper.py")
BACKBONE_ITERS = 4          # one sandwich cycle: MAX, MIN, 2 random
ADE_CLASSES = 150
F32_CHECK_IMAGES = 2        # the float32 card-vs-CPU step's batch
CONVNEXT_DIMS, CONVNEXT_DEPTHS = [96, 192, 384, 768], [3, 3, 9, 3]
CONVNEXT_MIN_DEPTHS = [2, 2, 5, 2]
CONFORMER = {"stem": 64, "widths": [256, 512, 1024], "depths": [4, 4, 4],
             "embed": 576, "heads": 9, "ffc": 40}
CONFORMER_MIN = {"stem": 32, "widths": [128, 256, 512], "depths": [2, 2, 2],
                 "embed": 384, "heads": 6, "ffc": 30}
# the ConvNeXt and Conformer steps' two losses (N, C, h, w, H, W): 150
# classes (K1/K2's any-C instances), decode 128x128 (stride 4) and aux
# 32x32 (stage 2, stride 16) upsampled to the 512x512 labels
ADE_LOSSES = {"c150_decode": (8, 150, 128, 128, 512, 512),
              "c150_aux": (8, 150, 32, 32, 512, 512)}


def _ade_train(cfg, classes):
    """``cfg``'s train data: synthetic 512x512 records on the card through
    ADE20K's train pipeline, batch 8, every step a full one."""
    from gaiaseg_tpu_torch.utils import Config
    ade = Config.fromfile(ADE20K)
    cfg.merge_from_dict({
        "data.train": {"type": "SyntheticDataset", "size": [512, 512],
                       "length": 16, "num_classes": classes, "seed": 0,
                       "cells": 8, "pipeline": ade["train_pipeline"],
                       "device_cache": True},
        "data.samples_per_gpu": 8,
        "img_norm_cfg": {"mean": [123.675, 116.28, 103.53],
                         "std": [58.395, 57.12, 57.375], "to_rgb": True},
        "log_config.interval": 1})
    return cfg


def _uper_heads(in_channels):
    """UPer 512 (pool scales 1, 2, 3, 6) + FCN 256 aux on stage 2 at 0.4,
    150 classes: the upstream ConvNeXt UPerNet's heads."""
    ce = {"type": "CrossEntropyLoss"}
    return {
        "decode_head": {"type": "DynamicUPerHead", "in_index": [0, 1, 2, 3],
                        "in_channels": list(in_channels),
                        "input_transform": "multiple_select",
                        "channels": 512, "pool_scales": [1, 2, 3, 6],
                        "dropout_ratio": 0.1, "num_classes": ADE_CLASSES,
                        "loss_decode": dict(ce, loss_weight=1.0)},
        "auxiliary_head": {"type": "DynamicFCNHead", "in_index": 2,
                           "in_channels": in_channels[2], "channels": 256,
                           "num_convs": 1, "concat_input": False,
                           "dropout_ratio": 0.1,
                           "num_classes": ADE_CLASSES,
                           "loss_decode": dict(ce, loss_weight=0.4)}}


def _convnext_cfg():
    """``configs/tests/tiny_convnext_uper.py`` (its structure, AdamW + clip
    5, poly LR) at ConvNeXt-T's widths: dims 96/192/384/768, depths
    3/3/9/3, drop path 0.4, the UPer/FCN heads of ``_uper_heads``; the
    sandwich cycle MAX, MIN (half of every width, depths 2/2/5/2) and two
    draws of the tiny config's form (widths in steps of an eighth of MAX,
    depths from MIN's)."""
    from gaiaseg_tpu_torch.utils import Config
    cfg = Config.fromfile(TINY_CONVNEXT)
    half = [d // 2 for d in CONVNEXT_DIMS]
    width_key, depth_key = ("arch.backbone.body.width",
                            "arch.backbone.body.depth")
    cfg.merge_from_dict({
        "model.backbone.dims": CONVNEXT_DIMS,
        "model.backbone.depths": CONVNEXT_DEPTHS,
        "model.backbone.drop_path_rate": 0.4,
        **{f"model.{k}": v for k, v in _uper_heads(CONVNEXT_DIMS).items()},
        "train_sampler": {"type": "concat", "model_samplers": [
            {"type": "anchor", "anchors": [
                {"name": "MAX", width_key: CONVNEXT_DIMS,
                 depth_key: CONVNEXT_DEPTHS},
                {"name": "MIN", width_key: half,
                 depth_key: CONVNEXT_MIN_DEPTHS}]},
            {"type": "repeat", "times": 2, "model_sampler": {
                "type": "composite", "model_samplers": [
                    {"type": "range", "key": width_key, "start": half,
                     "end": CONVNEXT_DIMS,
                     "step": [d // 8 for d in CONVNEXT_DIMS]},
                    {"type": "range", "key": depth_key,
                     "start": CONVNEXT_MIN_DEPTHS, "end": CONVNEXT_DEPTHS,
                     "step": [1, 1, 1, 1]}]}}]}})
    return _ade_train(cfg, ADE_CLASSES)


def _conformer_meta(name, a):
    b = "arch.backbone."
    return {"name": name, b + "stem.width": a["stem"],
            b + "body.depth": a["depths"],
            b + "body.block.convblock.width": a["widths"],
            b + "body.block.embed_dim.width": a["embed"],
            b + "body.block.transblock.MHA.num_heads": [a["heads"]] * 3,
            b + "body.block.transblock.FFN.feedforward_channels":
                [a["ffc"]] * 3}


def _conformer_cfg():
    """The full-width ``ElasticConvformer`` defaults (stem 64, widths
    256/512/1024, depths 4/4/4, embed 576, 9 heads, FFN ratio 4.0, patch
    16) with the heads of ``_uper_heads`` at in-channels 256/512/1024/1024,
    on the tiny ConvNeXt config's structure (AdamW + clip 5, poly LR). MIN
    is half of every width, embed 384 with 6 heads, FFN ratio 3.0, depths
    2/2/2; the two draws take each from MIN to MAX."""
    from gaiaseg_tpu_torch.utils import Config
    cfg = Config.fromfile(TINY_CONVNEXT)
    lo, hi = CONFORMER_MIN, CONFORMER
    b = "arch.backbone."

    def rng(key, start, end, step):
        return {"type": "range", "key": b + key, "start": start, "end": end,
                "step": step}
    cfg["model"]["backbone"] = {
        "type": "ElasticConvformer", "stem_width": hi["stem"],
        "body_width": hi["widths"], "body_depth": hi["depths"],
        "embed_dim": hi["embed"], "num_heads": hi["heads"],
        "mlp_ratio": hi["ffc"], "patch_size": 16,
        "out_indices": [0, 1, 2, 3]}
    cfg.merge_from_dict({
        **{f"model.{k}": v for k, v in _uper_heads(
            hi["widths"] + hi["widths"][-1:]).items()},
        "train_sampler": {"type": "concat", "model_samplers": [
            {"type": "anchor", "anchors": [_conformer_meta("MAX", hi),
                                           _conformer_meta("MIN", lo)]},
            {"type": "repeat", "times": 2, "model_sampler": {
                "type": "composite", "model_samplers": [
                    rng("stem.width", lo["stem"], hi["stem"], 16),
                    rng("body.depth", lo["depths"], hi["depths"], [1] * 3),
                    rng("body.block.convblock.width", lo["widths"],
                        hi["widths"], [w // 8 for w in hi["widths"]]),
                    rng("body.block.embed_dim.width", lo["embed"],
                        hi["embed"], 64),
                    rng("body.block.transblock.MHA.num_heads",
                        [lo["heads"]] * 3, [hi["heads"]] * 3, [1] * 3),
                    rng("body.block.transblock.FFN.feedforward_channels",
                        [lo["ffc"]] * 3, [hi["ffc"]] * 3, [5] * 3)]}}]}})
    return _ade_train(cfg, ADE_CLASSES)


def _vit_relpos_cfg():
    """``upernet_elastic_vit.py`` at full width with relative positions,
    token dropout 0.1 and the cls token (1025 tokens: the flash gate stays
    closed, as JAX's ``not use_rel``), ADE20K's pipeline on 19-class
    records; the sampler's MAX and MIN anchors."""
    from gaiaseg_tpu_torch.utils import Config
    cfg = Config.fromfile(VIT)
    cfg.merge_from_dict({"model.backbone.with_rel_pos": True,
                         "model.backbone.drop_rate": 0.1,
                         "model.backbone.with_cls_token": True})
    anchors = cfg["train_sampler"]["model_samplers"][0]
    cfg["train_sampler"] = {"type": "concat", "model_samplers": [anchors]}
    return _ade_train(cfg, 19)


def _rel_by_tensor(grads, ref):
    """max|g - r| / max|r| of each tensor of ``ref``."""
    return {k: float((grads[k].double() - r.double()).abs().max())
            / max(float(r.abs().max()), 1e-300) for k, r in ref.items()}


def _f32_card_vs_cpu(cfg, tag):
    """One float32 MAX step (autocast and TF32 off) of the config's
    supernet from seed 0 in eval mode (as ``phase_segmentor``: BN running
    statistics, no stochastic depth or dropout) on F32_CHECK_IMAGES
    synthetic records, on the card (K1/K2; once with cuDNN's convolutions
    and once with PyTorch's own CUDA ones) and on the CPU (the plain
    versions), beside a float64 step on the card (the unfused loss) from
    the same weights. The card's losses within F32_LOSS_RTOL relative of
    the CPU's. Gradients: the card's (PyTorch's convolutions) distance from
    float64, max|d| / max|ref| of each tensor, within SEG_GRAD_RTOL or
    within F32_SPREAD times the CPU float32 step's own distance: a random
    supernet is ill-conditioned in float32 at some tensors (structural
    zeros under train-mode BN, a 1x1 pool branch's BN over 2 images, a
    saturated softmax), so each tensor is held to the precision float32
    has there. The cuDNN route's distances are printed, not held: cuDNN's
    float32 convolutions round more (this script on an H100, ConvNeXt:
    1.6e-3 from float64 with cuDNN, 3.8e-4 without, the CPU's 6.5e-4)."""
    import torch
    from gaiaseg_tpu_torch.data import SyntheticDataset
    from gaiaseg_tpu_torch.engine import prepare_batch
    from gaiaseg_tpu_torch.models import (build_segmentor, encode_arch,
                                          model_max_arch)
    from gaiaseg_tpu_torch.ops.cuda import LAUNCHES, reset_launches
    mcfg = cfg["model"]
    torch.manual_seed(0)
    model = build_segmentor(mcfg)
    state = {k: v.detach() for k, v in model.state_dict().items()}
    heads = 1 + len(model.aux_heads())     # K1/K2 launch once a head
    ds = SyntheticDataset(length=F32_CHECK_IMAGES, size=(512, 512),
                          num_classes=model.num_classes, seed=5, cells=8)
    del model
    img, gt = prepare_batch([ds[i] for i in range(len(ds))],
                            cfg["img_norm_cfg"], "cpu")
    gt[:, :8] = 255
    arch = encode_arch(model_max_arch(mcfg))
    res = {}
    for route, device, dtype, cudnn in (
            ("cudnn", "cuda", torch.float32, True),
            ("native", "cuda", torch.float32, False),
            ("cpu", "cpu", torch.float32, True),
            ("float64", "cuda", torch.float64, True)):
        m = build_segmentor(mcfg)
        m.load_state_dict(state)
        m = m.to(device, dtype).eval()
        if dtype == torch.float64:
            m.fused_loss = False     # the kernels compute in float32
        reset_launches()
        torch.backends.cudnn.enabled = cudnn
        t0 = time.perf_counter()
        try:
            total, _ = m.forward_train(img.to(device, dtype),
                                       gt.to(device), arch)
            total.backward()
            if device == "cuda":
                torch.cuda.synchronize()
        finally:
            torch.backends.cudnn.enabled = True
        res[route] = (float(total.detach()), {
            k: p.grad.detach().cpu() for k, p in m.named_parameters()
            if p.grad is not None}, dict(LAUNCHES),
            time.perf_counter() - t0)
        del m
    cpu, ref = res["cpu"], res["float64"][1]
    to64 = {r: _rel_by_tensor(res[r][1], ref)
            for r in ("native", "cudnn", "cpu")}
    margin = sorted((to64["native"][k] / max(
        SEG_GRAD_RTOL, F32_SPREAD * to64["cpu"][k]), k) for k in ref)
    errs = {r: _grad_errors(res[r][0], res[r][1], cpu[0], cpu[1])
            for r in ("native", "cudnn")}
    errs.update({f"{r}_to_float64": max(to64[r].values())
                 for r in to64})
    errs.update({"worst_margin": margin[-1], "cpu_s": cpu[3],
                 "float64_loss": res["float64"][0]})
    for r in ("native", "cudnn"):
        e, launches = errs[r], res[r][2]
        print(f"[{tag}] float32 MAX step of {F32_CHECK_IMAGES} 512x512 "
              f"images, card ({r} convolutions, K1/K2 "
              f"{launches['resize_ce_fwd']}/{launches['resize_ce_bwd']}) vs "
              f"CPU (plain, {cpu[3]:.1f}s): loss {e['loss']:.6f} / "
              f"{e['ref_loss']:.6f} (rel {e['loss_rel']:.1e}), worst grad "
              f"max|d|/max|ref| {e['worst_grad_rel']:.1e} "
              f"({e['worst_tensor']}), median {e['median_grad_rel']:.1e}")
        check(set(res[r][1]) == set(cpu[1]) == set(ref)
              and launches["resize_ce_fwd"] == launches["resize_ce_bwd"]
              == heads and e["loss_rel"] <= F32_LOSS_RTOL,
              f"{tag}: card ({r}) vs CPU float32 step {e}, launches "
              f"{launches}")
    print(f"[{tag}] worst gradient distance from the card's float64 step: "
          + ", ".join(f"{r} {errs[f'{r}_to_float64']:.1e}" for r in to64)
          + f"; the native route's worst tensor {margin[-1][1]} at "
          f"{margin[-1][0]:.2f} of its limit")
    check(margin[-1][0] <= 1.0,
          f"{tag}: card (native convolutions) float32 gradients from "
          f"float64: {margin[-3:]} of their limits")
    return errs


def _train_backbone_path(ctx, tag, cfg, names, describe):
    """One sandwich cycle of ``cfg`` through ``train_segmentor`` on the
    card (K1/K2 once an iteration for each head with a loss, on the
    instance of the config's class count, K3-K5 never), the cycle again
    warm, the least step times over STEADY_CYCLES warm cycles, a profiled
    MAX step, peak memory, then the float32 card-vs-CPU MAX step. Records
    the phase in ``ctx[tag]``."""
    import torch
    from gaiaseg_tpu_torch.engine import train_segmentor
    from gaiaseg_tpu_torch.ops.cuda import LAUNCHES, reset_launches
    torch.cuda.empty_cache()
    torch.backends.cudnn.benchmark = False
    model = _build_model(cfg)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[{tag}] {describe}: {n_params / 1e6:.2f} M parameters")
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    iters = len(names)
    history = train_segmentor(model, cfg, device="cuda", max_iters=iters,
                              seed=0, log=lambda s: print(f"[{tag}] {s}")
                              )[1]["loss"]
    launches = dict(LAUNCHES)
    got = [r["arch"] for r in history]
    check(got == names, f"{tag}: arch sequence {got}, want {names}")
    check(all(math.isfinite(r["loss"]) for r in history),
          f"{tag}: non-finite loss in {[r['loss'] for r in history]}")
    heads = 1 + len(model.aux_heads())
    for k in ("resize_ce_fwd", "resize_ce_bwd"):
        check(launches[k] == heads * iters,
              f"{tag}: {k} launched {launches[k]} times in {iters} "
              f"iterations (want {heads} per iteration, one a head)")
    check(not any(launches[k] for k in FLASH_KERNELS),
          f"{tag}: flash kernels launched {launches}")
    peak = torch.cuda.max_memory_allocated() / 1e9
    warm = train_segmentor(model, cfg, device="cuda", max_iters=iters,
                           seed=0)[1]["loss"]
    print(f"[{tag}] launches {launches} over {iters} iterations; peak "
          f"memory {peak:.2f} GB on {ctx['nvidia_smi']}")
    print(f"[{tag}] warm cycle step ms: " + ", ".join(
        f"{r['arch']} {r['step_ms']:.1f}" for r in warm))
    out = {"params_m": n_params / 1e6, "history": history,
           "warm_history": warm, "launches": launches, "peak_mem_gb": peak}
    out.update(_steady_step_ms(model, cfg, warm, tag))
    out["profile"] = _profile_max_step(model, cfg, warm, tag)
    ours = out["profile"]["repo_kernels"]
    if out["profile"]["device_busy_ms"]:
        want = ("fwd_tile_any", "bwd_tile_any") \
            if model.num_classes != 19 else ("fwd_tile", "bwd_tile")
        check(set(ours) == set(want),
              f"{tag}: the profiled step ran {sorted(ours)}, want the "
              f"instances {want}")
    del model
    out["card_vs_cpu"] = _f32_card_vs_cpu(cfg, tag)
    ctx[tag] = out


def phase_convnext(ctx):
    import torch
    errs = {"resize_ce_fwd": 0.0, "resize_ce_bwd": 0.0}
    checks, timings = [], {}
    for name, shape in ADE_LOSSES.items():
        for dtype in (torch.float32, torch.bfloat16):
            _check_case(name, shape, dtype, seed=1, errs=errs, log=checks)
        _time_case(name, shape, timings)
    _train_backbone_path(
        ctx, "convnext", _convnext_cfg(), ["MAX", "MIN", "random", "random"],
        "ConvNeXt-T supernet (dims 96/192/384/768, depths 3/3/9/3, drop "
        "path 0.4) + UPer 512 + FCN aux 256, 150 classes, AdamW + clip 5")
    ctx["convnext"].update(kernel_checks=checks, kernel_timings=timings,
                           max_abs_err=errs)


def phase_conformer(ctx):
    _train_backbone_path(
        ctx, "conformer", _conformer_cfg(),
        ["MAX", "MIN", "random", "random"],
        "Conformer supernet (stem 64, widths 256/512/1024, depths 4/4/4, "
        "embed 576, 9 heads, FFN 4.0, norm_eval) + UPer 512 + FCN aux 256, "
        "150 classes, AdamW + clip 5")


def phase_vit_relpos(ctx):
    _train_backbone_path(
        ctx, "vit_relpos", _vit_relpos_cfg(), ["MAX", "MIN"],
        "elastic ViT-B supernet with relative positions (tables of "
        "distance 14), token dropout 0.1, the cls token (1025 tokens) + "
        "neck + UPer 512 + FCN aux 256, 19 classes, AdamW + clip 1.0")


# the segformer phase: configs/_dynamic_/models/segformer_elastic_mixvit.py
# (MiT-B2's encoder shapes + SegFormerHead 256, 19 classes) composed with
# configs/_dynamic_/datasets/cityscapes_1024x1024.py (crop 512x1024),
# batch 8 of synthetic 1024x2048 records kept on the card
SEGFORMER = os.path.join(REPO, "configs", "_dynamic_", "models",
                         "segformer_elastic_mixvit.py")
CITYSCAPES_1024 = os.path.join(REPO, "configs", "_dynamic_", "datasets",
                               "cityscapes_1024x1024.py")
SEGFORMER_SLIDE_SIZE = (1024, 2048)     # windows 1024x1024 at stride 768: 3
SEGFORMER_MIOU_ATOL = 1e-5              # float32 slide mIoU, card vs CPU
# the new losses at the decode logits' label-size shape [N, C, H, W], card
# vs CPU in float32: the same sums in another order
NEW_LOSS_SHAPE = (8, 19, 512, 1024)
NEW_LOSS_RTOL = 1e-5
NEW_LOSS_GRAD_RTOL = 1e-4


def _segformer_cfg():
    """The SegFormer model config as it stands (its sampler MAX, MIN and
    two draws of ``width_range`` x ``depth_range``; AdamW 6e-5, wd 0.01,
    clip 1.0; poly LR with linear warmup; slide test_cfg 1024x1024 at
    stride 768) with the Cityscapes 1024x1024 dataset config's train
    pipeline (Resize to 2048x1024 at ratio 0.5-2.0, RandomCrop 512x1024,
    flip, photometric distortion) on synthetic 1024x2048 records kept on
    the card, batch 8, every step a full one."""
    from gaiaseg_tpu_torch.utils import Config
    cfg = Config.fromfile(SEGFORMER)
    city = Config.fromfile(CITYSCAPES_1024)
    cfg.merge_from_dict({
        "data.train": {"type": "SyntheticDataset",
                       "size": list(SEGFORMER_SLIDE_SIZE), "length": 16,
                       "num_classes": 19, "seed": 0, "cells": 8,
                       "pipeline": city["train_pipeline"],
                       "device_cache": True},
        "data.samples_per_gpu": 8,
        "img_norm_cfg": city["img_norm_cfg"],
        "log_config.interval": 1})
    return cfg


def _new_loss_cfgs():
    ce = {"type": "CrossEntropyLoss"}
    dice = {"type": "DiceLoss"}
    return {"dice": dice,
            "sigmoid_focal": {"type": "FocalLoss", "use_sigmoid": True},
            "softmax_focal": {"type": "FocalLoss", "use_sigmoid": False},
            "mixed_ce_dice": {"type": "MixedLoss", "losses": [ce, dice],
                              "weights": [1.0, 0.5]},
            "eql_ratio0": {"type": "EQLCrossEntropyLoss",
                           "tail_classes": list(range(10, 19)),
                           "sample_ratio": 0.0}}


def _new_losses_card_vs_cpu(tag):
    """Each new loss at the decode logits' label-size shape, float32, on
    the card against the CPU: values within NEW_LOSS_RTOL relative, the
    logits' gradients within NEW_LOSS_GRAD_RTOL of their max."""
    import torch
    from gaiaseg_tpu_torch.models import build_loss
    g = torch.Generator().manual_seed(7)
    logits = 3 * torch.randn(NEW_LOSS_SHAPE, generator=g)
    n, c, h, w = NEW_LOSS_SHAPE
    label = torch.randint(0, c, (n, h, w), generator=g, dtype=torch.int32)
    label[torch.rand((n, h, w), generator=g) < 0.1] = 255
    out = {}
    for name, lcfg in _new_loss_cfgs().items():
        res = {}
        for device in ("cuda", "cpu"):
            x = logits.to(device, copy=True).requires_grad_(True)
            fn = build_loss(lcfg)
            t0 = time.perf_counter()
            loss = fn(x, label.to(device))
            loss.backward()
            if device == "cuda":
                torch.cuda.synchronize()
            res[device] = (float(loss.detach()), x.grad.cpu(),
                           (time.perf_counter() - t0) * 1e3)
        (lc, gc, ms), (lp, gp, cpu_ms) = res["cuda"], res["cpu"]
        rel = abs(lc - lp) / max(abs(lp), 1e-30)
        grel = float((gc - gp).abs().max()) / max(float(gp.abs().max()),
                                                  1e-30)
        out[name] = {"loss": lc, "cpu_loss": lp, "loss_rel": rel,
                     "grad_rel": grel, "card_ms": ms, "cpu_ms": cpu_ms}
        print(f"[{tag}] {name} at {list(NEW_LOSS_SHAPE)}: card {lc:.7f} vs "
              f"CPU {lp:.7f} (rel {rel:.1e}), gradient max|d|/max|ref| "
              f"{grel:.1e}; {ms:.1f} ms on the card (first call)")
        check(math.isfinite(lc) and rel <= NEW_LOSS_RTOL
              and grel <= NEW_LOSS_GRAD_RTOL,
              f"{tag}: {name} card vs CPU {out[name]}")
    return out


def phase_segformer(ctx):
    """The SegFormer supernet at full width: a sandwich cycle through
    ``train_segmentor`` (K1/K2 once an iteration, K3-K5 never), warm and
    least step times, a profiled MAX step, peak memory, the float32
    card-vs-CPU MAX step; slide eval at MAX and MIN on one 1024x2048
    record (3 windows) with the float32 mIoU equal to the CPU's; the new
    losses on the card against the CPU, and one MIN step with a
    MixedLoss(CE, Dice) decode loss, which takes the unfused loss."""
    import torch
    from gaiaseg_tpu_torch.archspace import build_model_sampler
    from gaiaseg_tpu_torch.data import SyntheticDataset
    from gaiaseg_tpu_torch.engine import (build_optimizer, evaluate,
                                          grad_clip_norm, train_step)
    from gaiaseg_tpu_torch.models import (build_segmentor, encode_arch,
                                          model_max_arch)
    from gaiaseg_tpu_torch.ops.cuda import LAUNCHES, reset_launches
    cfg = _segformer_cfg()
    _train_backbone_path(
        ctx, "segformer", cfg, ["MAX", "MIN", "random", "random"],
        "SegFormer supernet (ElasticMixViT widths 64/128/320/512, depths "
        "3/4/6/3, heads 2/4/10/16 of 32, SR 8/4/2/1, FFN 4.0) + "
        "SegFormerHead 256, 19 classes, AdamW 6e-5 + clip 1.0, batch 8 of "
        "512x1024")
    out = ctx["segformer"]

    # slide eval at MAX and MIN: the card (bf16, timed), then float32 on
    # the card and on the CPU with the same weights and record
    model = _build_model(cfg).eval()
    anchors = {m["name"]: m for m in build_model_sampler(
        cfg["val_sampler"]).traverse()}
    ds = SyntheticDataset(length=1, size=SEGFORMER_SLIDE_SIZE,
                          num_classes=19, seed=1, cells=8)
    test_params = _test_params(cfg)
    cpu_model = build_segmentor(cfg["model"]).eval()
    cpu_model.load_state_dict({k: v.cpu() for k, v in
                               model.state_dict().items()})
    h, w = SEGFORMER_SLIDE_SIZE
    windows = len(_windows(h, w, cfg["model"]["test_cfg"]["crop_size"],
                           cfg["model"]["test_cfg"]["stride"]))
    slide = out["slide"] = {}
    for name in ("MAX", "MIN"):
        arch = encode_arch(model_max_arch(cfg["model"]), anchors[name])
        evaluate(model, ds, arch, test_params=test_params, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bf16 = evaluate(model, ds, arch, test_params=test_params,
                        device="cuda")
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        f32 = _float32_slide_eval(model, ds, arch, test_params,
                                  torch.device("cuda"))
        t0 = time.perf_counter()
        cpu = _float32_slide_eval(cpu_model, ds, arch, test_params,
                                  torch.device("cpu"))
        cpu_s = time.perf_counter() - t0
        d = abs(f32["mIoU"] - cpu["mIoU"])
        differ = int((f32["confusion"] != cpu["confusion"]).sum())
        slide[name] = {"s_per_image": secs, "windows": windows,
                       "mIoU_bf16": bf16["mIoU"], "mIoU_f32_cuda": f32["mIoU"],
                       "mIoU_f32_cpu": cpu["mIoU"], "abs_diff": d,
                       "confusion_cells_differ": differ, "cpu_s": cpu_s}
        print(f"[segformer] slide eval {name} (windows 1024x1024 at stride "
              f"768: {windows} on a {h}x{w} record): {secs:.3f} s an image "
              f"(bf16), mIoU {bf16['mIoU']:.4f}; float32 mIoU card "
              f"{f32['mIoU']:.7f} vs CPU {cpu['mIoU']:.7f} (|d| {d:.1e}, "
              f"{differ} confusion cells differ; CPU {cpu_s:.1f}s)")
        check(windows == 3 and all(math.isfinite(r["mIoU"])
                                   for r in (bf16, f32, cpu))
              and d <= SEGFORMER_MIOU_ATOL,
              f"segformer: slide {name} {slide[name]}")
    del model, cpu_model
    torch.cuda.empty_cache()

    # the new losses, then a MIN step whose decode loss is MixedLoss(CE,
    # Dice): the unfused route, K1/K2 never
    out["losses"] = _new_losses_card_vs_cpu("segformer")
    mcfg = dict(cfg["model"], decode_head=dict(
        cfg["model"]["decode_head"],
        loss_decode=_new_loss_cfgs()["mixed_ce_dice"]))
    torch.manual_seed(0)
    model = build_segmentor(mcfg).cuda().train()
    img, gt = _train_shaped_batch(cfg, 2)
    opt = build_optimizer(model.parameters(), cfg["optimizer"])
    reset_launches()
    logs = train_step(model, opt, img, gt,
                      encode_arch(model_max_arch(mcfg), anchors["MIN"]),
                      max_norm=grad_clip_norm(cfg.get("optimizer_config")))
    loss, launches = float(logs["loss"]), dict(LAUNCHES)
    out["mixed_step"] = {"loss": loss, "launches": launches}
    print(f"[segformer] MIN step with MixedLoss(CE, Dice) on 2 crops: "
          f"loss {loss:.4f}, launches {launches}")
    check(math.isfinite(loss) and not any(launches.values()),
          f"segformer: MixedLoss step loss {loss}, launches {launches}")
    del model
    torch.cuda.empty_cache()


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


def _path_launches(ctx, k):
    """K1/K2 launches over the main paths that ran: the flagship train
    cycle, the distill phase's BEiT-teacher cycle, the ConvNeXt,
    Conformer, relative-position ViT and SegFormer cycles and the tp
    phase's ViT cycle (both ranks), each counted from 0."""
    runs = [c[k] for c in [ctx.get("launches"), ctx.get("tp_launches")] + [
        (ctx.get(tag) or {}).get("launches")
        for tag in ("distill", "convnext", "conformer", "vit_relpos",
                    "segformer")] if c]
    return sum(runs) if runs else None


def _flash_launches(ctx, k):
    runs = [c[k] for c in (ctx.get("vit_launches"), ctx.get("tp_launches"))
            if c]
    return sum(runs) if runs else None


def kernels_line(ctx):
    """One entry per kernel. K1/K2: times per flagship train step (its
    decode-loss and aux-loss launches added), launches from the main
    paths' cycles (``_path_launches``). K3-K5: times per launch at the ViT
    train shape, launches from the ViT train cycle and the tp phase's
    cycle on head shards (both ranks)."""
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
            "launches": _path_launches(ctx, k),
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
            "launches": _flash_launches(ctx, k),
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
                 *EXTRACT_CFGS, DEEPLAB, V1C, V1C_EXTRACT, DISTILL_BEIT,
                 DISTILL_SELF, TINY_CONVNEXT, SEGFORMER, CITYSCAPES_1024):
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
                   "deeplab": ctx.get("deeplab"),
                   "distill": ctx.get("distill"), "ddp": ctx.get("ddp"),
                   "tp": ctx.get("tp"),
                   "flash_timings": ctx.get("flash_timings"),
                   "flash_forward": ctx.get("flash_forward"),
                   "flash_backward": ctx.get("flash_backward"),
                   "flash_max_abs_err": ctx.get("flash_max_abs_err"),
                   "vit_segmentor": ctx.get("vit_segmentor"),
                   "vit_launches": ctx.get("vit_launches"),
                   "vit_train": ctx.get("vit_train"),
                   "vit_profile": ctx.get("vit_profile"),
                   "vit_eval": ctx.get("vit_eval"),
                   "convnext": ctx.get("convnext"),
                   "conformer": ctx.get("conformer"),
                   "vit_relpos": ctx.get("vit_relpos"),
                   "segformer": ctx.get("segformer"),
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
