"""Host -> device feed: uploads and device-side preparation on a side
stream, taken over by the consumer's stream.

A prefetch thread (``loader.device_prefetch``) prepares batches ahead of the
train or eval loop. On a card it works on a CUDA stream of its own:

- each upload goes through a ring of pinned staging buffers with one event
  per buffer; a buffer is refilled only after the event says its last
  ``non_blocking`` copy has finished;
- the upload and the preparation (augmentation) run on the side stream,
  and an event recorded after them goes with the batch;
- the consumer makes its stream wait for that event and marks the batch's
  tensors as used on its stream (``record_stream``), so the caching
  allocator does not hand their memory back to the side stream while the
  consumer still reads it.

On the CPU every step is a plain call: uploads wrap the host arrays.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..utils.tracing import span


SLOTS = 2   # pinned buffers of each name: one fills while one uploads


class DeviceFeed:
    """One side stream and its pinned staging ring (``SLOTS`` buffers of
    each name)."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self._next = 0
        self._ring = [({}, None) for _ in range(SLOTS)]
        self.stream = torch.cuda.Stream(self.device) if self.cuda else None

    @contextlib.contextmanager
    def side_stream(self):
        """Ops inside run on the side stream (on the CPU: as they are)."""
        if not self.cuda:
            yield
            return
        with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            yield

    def upload(self, arrays: Dict[str, np.ndarray],
               out: Optional[Dict[str, torch.Tensor]] = None
               ) -> Dict[str, torch.Tensor]:
        """Host arrays (numpy or CPU tensors) -> device tensors (new ones,
        or ``out``'s, which must match in shape and dtype), through the
        next pinned buffer of the ring; call inside ``side_stream()``."""
        if not self.cuda:
            return {k: torch.as_tensor(v) for k, v in arrays.items()}
        bufs, event = self._ring[self._next]
        if event is not None:
            event.synchronize()           # its last copies have finished
        staged = {}
        for name, arr in arrays.items():
            host = torch.as_tensor(arr)
            buf = bufs.get(name)
            if buf is None or buf.shape != host.shape \
                    or buf.dtype != host.dtype:
                buf = bufs[name] = torch.empty(host.shape, dtype=host.dtype,
                                               pin_memory=True)
            buf.copy_(host)
            dev = torch.empty(host.shape, dtype=host.dtype,
                              device=self.device) if out is None \
                else out[name]
            if dev.shape != host.shape or dev.dtype != host.dtype:
                raise ValueError(f"upload of {name}: {tuple(host.shape)} "
                                 f"{host.dtype} into {tuple(dev.shape)} "
                                 f"{dev.dtype}")
            dev.copy_(buf, non_blocking=True)
            staged[name] = dev
        event = torch.cuda.Event()
        event.record(self.stream)
        self._ring[self._next] = (bufs, event)
        self._next = (self._next + 1) % SLOTS
        return staged

    def capture(self, fn):
        """``fn()`` recorded as a CUDA graph on the side stream (call inside
        ``side_stream()``, after one plain ``fn()`` has set up any lazy
        state): one ``replay()`` then stands for its kernels, which spares
        the host a launch each while the train step launches its own.
        Returns (graph, the outputs that every replay rewrites)."""
        self.stream.synchronize()
        graph = torch.cuda.CUDAGraph()
        graph.capture_begin(capture_error_mode="thread_local")
        try:
            out = fn()
        finally:
            graph.capture_end()
        return graph, out

    def done(self) -> Optional[torch.cuda.Event]:
        """An event after everything enqueued on the side stream so far
        (None on the CPU)."""
        if not self.cuda:
            return None
        event = torch.cuda.Event()
        event.record(self.stream)
        return event


def take(tensors: Sequence[torch.Tensor],
         event: Optional[torch.cuda.Event]) -> None:
    """Consumer side: the current stream waits for ``event`` (from
    ``DeviceFeed.done``) and owns ``tensors`` from here on; the host then
    waits until they are ready, so the wait counts as data time, not step
    time. That wait is two spans: ``feed.wait`` until the batch's own event
    (the feed's side stream), then ``device.drain`` until the consumer's
    stream has finished what was queued on it before the batch (the card
    draining the previous step). A no-op for CPU batches (``event``
    None)."""
    if event is None:
        return
    cur = torch.cuda.current_stream(tensors[0].device)
    cur.wait_event(event)
    for t in tensors:
        t.record_stream(cur)
    with span("feed.wait"):
        event.synchronize()
    with span("device.drain"):
        cur.synchronize()
