"""Host-side batch loader feeding the device-side augmentation.

A copy of ``gaiaseg_tpu/data/loader.py``: records are fixed-shape, reading
them is the only host work, and augmentation runs on the card
(``data/transforms.py``), so one loader thread and one prefetch thread keep
the card fed, in place of a pool of DataLoader worker processes. The index
streams (shuffle by ``RandomState(seed + epoch)``, drop_last, the padded
tail with ``pad_count``, the infinite stream across epochs, shards) are the
JAX package's, element for element.
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator

import numpy as np


class BatchLoader:
    """Batches a dataset of fixed-shape records into numpy stacks.

    ``shard_id``/``num_shards`` give per-process dataset sharding (in place
    of DistributedSampler).
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 seed: int = 0, drop_last: bool = True,
                 shard_id: int = 0, num_shards: int = 1,
                 prefetch: int = 2, infinite: bool = False,
                 index_only: bool = False):
        self.dataset = dataset
        # index_only: yield {'idx'} batches without materializing pixels;
        # consumers that own a device-resident cache read it in place
        # (transforms.gather_augment_batch)
        self.index_only = index_only
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.shard_id = shard_id
        self.num_shards = num_shards
        self.prefetch = prefetch
        self.infinite = infinite
        self._epoch = 0

    def _indices(self) -> np.ndarray:
        n = len(self.dataset)
        idx = np.arange(n)
        if self.shuffle:
            rng = np.random.RandomState(self.seed + self._epoch)
            rng.shuffle(idx)
        idx = idx[self.shard_id::self.num_shards]
        return idx

    def _stack(self, chunk, pad_count: int = 0) -> Dict[str, np.ndarray]:
        if self.index_only:
            batch = {"idx": np.ascontiguousarray(chunk, np.int32)}
            if pad_count:
                batch["pad_count"] = pad_count
            return batch
        fast = getattr(self.dataset, "read_batch", None)
        if fast is not None:
            # native gather path (PackedDataset / DeviceCachedDataset);
            # padded tails wrap indices in ``chunk`` already
            batch = fast(np.asarray(chunk))
            if pad_count:
                batch = dict(batch, pad_count=pad_count)
            return batch
        recs = [self.dataset[int(j)] for j in chunk]
        batch = {
            "img": np.stack([r["img"] for r in recs]),
            "gt": np.stack([r["gt"] for r in recs]),
            "idx": np.asarray([r.get("idx", int(j))
                               for r, j in zip(recs, chunk)]),
        }
        if pad_count:
            batch["pad_count"] = pad_count
        return batch

    def _batches(self) -> Iterator[Dict[str, np.ndarray]]:
        bs = self.batch_size
        if self.infinite:
            # continuous index stream straddling epoch boundaries (the
            # reference's InfiniteSampler semantics): a dataset or shard
            # smaller than the global batch still yields full batches
            # instead of dropping every epoch's tail (which livelocked
            # the prefetch worker when len(dataset) < global batch).
            if len(self._indices()) == 0:
                raise ValueError(
                    f"empty dataset shard {self.shard_id}/{self.num_shards}")
            buf: list = []
            while True:
                buf.extend(self._indices())
                self._epoch += 1
                while len(buf) >= bs:
                    yield self._stack(buf[:bs])
                    del buf[:bs]
            return
        idx = self._indices()
        end = len(idx) - (len(idx) % bs)  # full batches only; tail below
        for i in range(0, end, bs):
            yield self._stack(idx[i:i + bs])
        tail = len(idx) % bs
        if not self.drop_last and tail:
            # pad the final batch by wrapping; consumers mask via pad_count
            chunk = list(idx[end:]) + list(np.resize(idx, bs - tail))
            yield self._stack(chunk, pad_count=bs - tail)
        self._epoch += 1

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        if self.prefetch <= 0:
            yield from self._batches()
            return
        yield from _pump(self._batches, self.prefetch)

    def __len__(self) -> int:
        n = len(self._indices())
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)


JOIN_TIMEOUT_S = 60.0   # the longest a consumer's exit waits for its producer


def _pump(make_items, maxsize: int):
    """Producer thread + bounded queue with a clean shutdown path.

    Yields the items of ``make_items()``. When the consumer stops early
    (``.close()`` / generator GC / exception), the producer is signalled
    and queued items are dropped so their references release. Without
    this, an abandoned prefetch thread blocks forever on ``q.put`` holding
    ~maxsize prepped batches (device memory, for ``device_prefetch``) for
    the life of the process, and repeated ``train_segmentor`` calls in one
    process would leak the card's memory. The consumer's exit then joins
    the producer (for at most ``JOIN_TIMEOUT_S``), so no thread outlives
    the loop that used it. Producer exceptions re-raise at the
    consumer."""
    q: "queue.Queue" = queue.Queue(maxsize=max(int(maxsize), 1))
    stop = object()
    done = threading.Event()
    err: list = []

    def worker():
        try:
            for item in make_items():
                while not done.is_set():
                    try:
                        q.put(item, timeout=0.2)
                        break
                    except queue.Full:
                        pass
                else:
                    return
                del item
        except BaseException as e:  # propagate into consumer
            err.append(e)
        finally:
            while not done.is_set():
                try:
                    q.put(stop, timeout=0.2)
                    break
                except queue.Full:
                    pass

    thread = threading.Thread(target=worker, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is stop:
                if err:
                    raise err[0]
                return
            yield item
    finally:
        done.set()
        _drain(q)       # release refs the producer already queued
        if thread is not threading.current_thread():
            thread.join(JOIN_TIMEOUT_S)
            _drain(q)   # an item put between the first drain and its exit


def _drain(q: "queue.Queue") -> None:
    try:
        while True:
            q.get_nowait()
    except queue.Empty:
        pass


def device_prefetch(batches, prep, depth: int = 2):
    """Run ``prep(batch)`` (the upload and the device-side augmentation) in
    a background thread ``depth`` items ahead of the consumer.

    The prep thread is the ONLY consumer of ``batches`` and runs the prep
    calls in order, so a prep that draws from a random generator gives
    the same draws whatever the timing. Exceptions in ``prep`` or the
    source iterator re-raise at the consumer. Closing the returned
    generator (``train_segmentor`` closes it in a ``finally``) shuts the
    thread down and releases the staged device batches; abandoning it to
    the GC does the same via ``_pump``'s finally."""

    def gen():
        for b in batches:
            yield prep(b)

    yield from _pump(gen, depth)
