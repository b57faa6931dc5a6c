"""PackedDataset: the native mmap-backed dataset, and its writer.

A copy of ``gaiaseg_tpu/data/packed.py`` on the port's own build of
``native/packio.cc``. A dataset is converted once into a fixed-shape
``.gsegpack`` file (the same format as the JAX package's, byte for byte);
batches are gathered by the C++ reader with no per-record Python objects
and no GIL during the copies, so one loader thread keeps the card fed.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from ..utils.registry import DATASETS


@DATASETS.register_module()
class PackedDataset:
    """Reads a .gsegpack file written by ``pack_dataset``."""

    def __init__(self, path: str, classes: Sequence[str] = (),
                 palette=None, num_threads: int = 2, pipeline=None, **kw):
        from ..native import load_packio
        self._lib = load_packio()
        self._handle = self._lib.packio_open(path.encode())
        if not self._handle:
            raise FileNotFoundError(f"cannot open packed dataset {path}")
        shape = (ctypes.c_int64 * 4)()
        self._lib.packio_shape(self._handle, shape)
        self.h, self.w, self.img_c, self.lab_c = (int(shape[i])
                                                  for i in range(4))
        self._n = int(self._lib.packio_len(self._handle))
        self.CLASSES = tuple(classes)
        self.PALETTE = palette
        self.num_threads = num_threads
        self.ignore_index = 255
        self.path = path

    @property
    def num_classes(self) -> int:
        return len(self.CLASSES)

    def __len__(self) -> int:
        return self._n

    def read_batch(self, indices: np.ndarray) -> Dict[str, np.ndarray]:
        """Gather a whole batch through the native reader. Labels come back
        uint8, the on-disk dtype (ignore stays 255); consumers widen them
        on the device."""
        indices = np.ascontiguousarray(indices, np.int64)
        n = len(indices)
        if n and (indices.min() < 0 or indices.max() >= self._n):
            raise IndexError(f"record index out of range [0, {self._n})")
        imgs = np.empty((n, self.h, self.w, self.img_c), np.uint8)
        labels = np.empty((n, self.h, self.w), np.uint8)
        rc = self._lib.packio_read_batch_u8(
            self._handle,
            indices.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            n,
            imgs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            labels.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            self.num_threads)
        if rc != 0:
            raise IOError(f"packio_read_batch failed on {self.path}")
        return {"img": imgs, "gt": labels, "idx": indices.astype(np.int64)}

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        b = self.read_batch(np.asarray([idx]))
        return {"img": b["img"][0], "gt": b["gt"][0], "idx": idx}

    def close(self) -> None:
        if getattr(self, "_handle", None):
            self._lib.packio_close(self._handle)
            self._handle = None

    def __del__(self):
        self.close()


def pack_dataset(dataset, out_path: str,
                 size: Optional[Tuple[int, int]] = None) -> str:
    """Convert any record-style dataset into a .gsegpack file. Records are
    resized (bilinear image, nearest label, by PIL) to ``size`` or the first
    record's shape: the format is fixed-shape by design."""
    from ..native import load_packio
    lib = load_packio()
    first = dataset[0]
    h, w = size or first["img"].shape[:2]
    n = len(dataset)
    f = lib.packio_create(out_path.encode(), n, h, w, 3, 1)
    if not f:
        raise IOError(f"cannot create {out_path}")
    try:
        for i in range(n):
            rec = dataset[i]
            img = rec["img"]
            gt = rec["gt"]
            if img.shape[:2] != (h, w):
                from PIL import Image
                img = np.asarray(Image.fromarray(img).resize(
                    (w, h), Image.BILINEAR))
                gt = np.asarray(Image.fromarray(
                    gt.astype(np.uint8)).resize((w, h), Image.NEAREST),
                    np.uint8)
            img = np.ascontiguousarray(img, np.uint8)
            gt8 = np.ascontiguousarray(
                np.clip(gt, 0, 255).astype(np.uint8))
            rc = lib.packio_append(
                f, img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                gt8.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                img.nbytes, gt8.nbytes)
            if rc != 0:
                raise IOError(f"append failed at record {i}")
    finally:
        lib.packio_finish(f)
    return out_path
