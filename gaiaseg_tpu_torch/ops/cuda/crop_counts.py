"""Class counts of RandomCrop's candidate windows, with their CUDA kernel.

``data/transforms.py`` picks RandomCrop's window (``cat_max_ratio``) from
the class counts of the nearest-resampled label of each of the K candidate
windows of each image. The JAX package computes them with XLA matmuls
(``gaiaseg_tpu/data/transforms.py`` ``_trial_histograms``); no Pallas kernel
stands behind them. ``crop_counts`` is the port's kernel for the count
(``csrc/crop_counts.cu``): it reads each window's footprint in the source
label once, weighted by the row and column multiplicities of the nearest
resample, and writes nothing crop-sized. ``crop_counts_reference`` is the
plain torch version: the windows' labels gathered at once and counted by
``torch.bincount``.

The augment had counted with ``torch.histc`` over float keys, which reads
nothing back to the host but bins a key by ``key * bins / bins`` in float32:
above 2^24 the product rounds, and at the ADE20K cells' 24,160 bins (16
images x 10 windows x 151) 485 keys land one bin low, on the card and on
the CPU. A window's pixels of class c then count as c - 1, or its
uncounted pixels as class C - 1, in the batch's last two images.

The wrapper takes the plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises. The kernel reads nothing back to
the host and allocates nothing itself, so the feed's CUDA graph of the
augment captures it.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ...utils.tracing import count
from . import build

# label dtypes the kernel reads, by their size in bytes
LABEL_DTYPES = {torch.uint8: 1, torch.int32: 4, torch.int64: 8}


def crop_counts_reference(label: torch.Tensor, rows: torch.Tensor,
                          near: torch.Tensor, valid: torch.Tensor, ch: int,
                          num_classes: int,
                          seg_pad_val: int = 255) -> torch.Tensor:
    """[B, K, C] int64 class histograms of the nearest-resampled label
    windows (``near``, ``valid`` [B, K, ch + cw]): all K windows gathered at
    once and counted by one bincount of integer keys (window x (C + 1) +
    class, C for a pixel not counted). Exact at any number of bins, but it
    reads the keys' largest value back to the host, so a CUDA graph cannot
    capture it."""
    b, k = near.shape[:2]
    lab = label[rows[:, None, None, None], near[:, :, :ch, None],
                near[:, :, None, ch:]]                      # [B, K, ch, cw]
    keep = valid[:, :, :ch, None] & valid[:, :, None, ch:] \
        & (lab >= 0) & (lab < num_classes)
    if seg_pad_val < num_classes:
        keep &= lab != seg_pad_val
    bins = num_classes + 1
    base = (torch.arange(b * k, device=lab.device)
            * bins).reshape(b, k, 1, 1)
    key = base + torch.where(keep, lab.to(torch.int64), num_classes)
    counts = torch.bincount(key.reshape(-1), minlength=b * k * bins)
    return counts.reshape(b, k, bins)[..., :num_classes]


def _check(label: torch.Tensor, rows: torch.Tensor, near: torch.Tensor,
           valid: torch.Tensor, ch: int, num_classes: int) -> None:
    """The arguments both routes take: shapes, dtypes and devices."""
    if label.dim() != 3:
        raise ValueError(f"label must be [N, H, W], got "
                         f"{tuple(label.shape)}")
    if near.dim() != 3 or near.dtype != torch.int64:
        raise ValueError(f"near must be an int64 [B, K, ch + cw] tensor, got "
                         f"{near.dtype} {tuple(near.shape)}")
    if valid.dtype != torch.bool or valid.shape != near.shape:
        raise ValueError(f"valid must be a bool tensor of near's shape "
                         f"{tuple(near.shape)}, got {valid.dtype} "
                         f"{tuple(valid.shape)}")
    if rows.dtype != torch.int64 or tuple(rows.shape) != (near.shape[0],):
        raise ValueError(f"rows must be an int64 [{near.shape[0]}] tensor, "
                         f"got {rows.dtype} {tuple(rows.shape)}")
    if not 0 < ch < near.shape[2]:
        raise ValueError(f"ch = {ch} leaves no rows or no columns of the "
                         f"{near.shape[2]} sampling positions")
    if num_classes < 1:
        raise ValueError(f"num_classes must be positive, got {num_classes}")
    if len({t.device for t in (label, rows, near, valid)}) != 1:
        raise ValueError("label, rows, near and valid lie on different "
                         "devices")


def _check_kernel(label: torch.Tensor, num_classes: int, smem: int,
                  max_smem: int) -> None:
    """What the kernel takes beyond ``_check``: the label's dtype and
    layout, and a block's shared memory at these shapes."""
    if label.dtype not in LABEL_DTYPES:
        raise ValueError(f"the kernel reads uint8, int32 or int64 labels, "
                         f"got {label.dtype}")
    if not label.is_contiguous():
        raise ValueError("label must be contiguous")
    if smem > max_smem:
        raise ValueError(f"labels of {label.shape[1]}x{label.shape[2]} at "
                         f"{num_classes} classes need {smem} B of shared "
                         f"memory a block, more than {max_smem}")


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The built kernel with its C signatures declared (built at the first
    launch, never at import)."""
    return bind(build.load("crop_counts"))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C signatures of a built ``crop_counts`` library."""
    p, i, q = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.crop_counts_smem.argtypes = [i, i, i]
    lib.crop_counts_smem.restype = i
    lib.crop_counts_max_smem.argtypes = []
    lib.crop_counts_max_smem.restype = i
    lib.crop_counts.argtypes = [p, i, p, p, p, p, i, i, i, i, i, i, i, i, q,
                                i, p]
    lib.crop_counts.restype = i
    return lib


def crop_counts(label: torch.Tensor, rows: torch.Tensor, near: torch.Tensor,
                valid: torch.Tensor, ch: int, num_classes: int,
                seg_pad_val: int = 255) -> torch.Tensor:
    """[B, K, C] int64: pixels of each class in the nearest-resampled label
    window (b, k) of record ``label[rows[b]]``. ``near`` and ``valid``
    [B, K, ch + cw] are the windows' nearest source rows, then columns, and
    their valid masks (``transforms._windows``). Pixels outside the window's
    valid rows or columns, ``seg_pad_val`` and any label outside [0, C) are
    not counted.

    Counted in the tracer's ``launch.crop_counts`` at each launch. Under the
    feed's CUDA graph a replay calls no wrapper, so the counter shows that
    the capture took the kernel; the kernel's name in the device trace
    shows it ran at each step."""
    _check(label, rows, near, valid, ch, num_classes)
    if label.device.type == "cpu":
        return crop_counts_reference(label, rows, near, valid, ch,
                                     num_classes, seg_pad_val)
    if label.device.type != "cuda":
        raise ValueError(f"crop_counts runs on cuda or cpu, not "
                         f"{label.device.type}")
    n, h, w = label.shape
    b, k, positions = near.shape
    lib = _lib()
    _check_kernel(label, num_classes, lib.crop_counts_smem(h, w, num_classes),
                  lib.crop_counts_max_smem())
    near, valid, rows = near.contiguous(), valid.contiguous(), \
        rows.contiguous()
    counts = torch.zeros(b, k, num_classes, dtype=torch.int64,
                         device=label.device)
    sms = torch.cuda.get_device_properties(label.device).multi_processor_count
    with torch.cuda.device(label.device):
        err = lib.crop_counts(
            label.data_ptr(), LABEL_DTYPES[label.dtype], rows.data_ptr(),
            near.data_ptr(), valid.data_ptr(), counts.data_ptr(), n, h, w, b,
            k, ch, positions - ch, num_classes, int(seg_pad_val), sms,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"crop_counts launch failed with cudaError_t "
                           f"{err}")
    count("launch.crop_counts")
    return counts
