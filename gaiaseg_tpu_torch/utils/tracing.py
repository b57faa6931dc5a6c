"""Spans and counters: where the host's time goes, and what each layer
counts, in the process.

- ``span(name)``: a host interval on ``perf_counter``. Each thread keeps a
  stack of its open spans, so a span knows its parent and has a self time
  (its duration less its children's). While ``torch.profiler`` records, it
  also opens a ``record_function`` range of the same name, on the
  profiler's clock with the card's kernels; with no profiler running it
  enters none.
- ``region(name)``: a profiler range (only while a profiler records) and a
  counter of calls, with no host time: for code that issues asynchronous
  kernels, whose host time says nothing of their cost.
- ``count(name, n)``: adds to a counter. A dotted name's last part is its
  key in the group before it (``launch.flash_fwd``: key ``flash_fwd`` of
  group ``launch``); ``counters(group)`` is that group's dict, which the
  process shares (``ops.cuda.LAUNCHES`` is group ``launch``,
  ``parallel.distributed.TRAFFIC`` group ``collective.bytes``).

Spans are recorded only while a ``Recorder`` runs (the train loop makes
one and stops it when it ends). Each record carries an identifier of the
step it belongs to: ``set_step(i)`` sets the calling thread's (the loop
sets the iteration, the feed thread the index of the batch, which is the
iteration that consumes it). ``Recorder.window(end, steps)`` takes the
records of steps before ``end`` out of every thread and reduces them to
self ms a step (a batch for the threads other than the caller's), with
each counter's change a step, so no more than a window's records are ever
held. Threads append to their own queue and the reducer pops from its
front: nothing on the hot path takes a lock.
"""
from __future__ import annotations

import collections
import threading
import time
from typing import Dict, Iterable, List, Tuple

import torch
from torch.autograd import profiler as _autograd_profiler
from torch.autograd.profiler import record_function

_local = threading.local()
_threads: List["_Thread"] = []       # every thread that has opened a span
_threads_lock = threading.Lock()     # taken on a thread's first span only
_recording = False
_COUNTERS: Dict[str, Dict[str, int]] = {}


class _Thread:
    __slots__ = ("stack", "records", "step", "thread")

    def __init__(self):
        self.stack: List["span"] = []
        self.records: "collections.deque" = collections.deque()
        self.step = 0
        self.thread = threading.current_thread()


def _state() -> _Thread:
    st = getattr(_local, "state", None)
    if st is None:
        st = _local.state = _Thread()
        with _threads_lock:
            _threads.append(st)
    return st


def profiling() -> bool:
    """Whether a ``torch.profiler`` (or autograd profiler) records now."""
    return _autograd_profiler._is_profiler_enabled


def set_step(step: int) -> None:
    """The identifier the calling thread's next spans are recorded under."""
    _state().step = int(step)


class span:
    """``with span(name) as s:`` times the block on the host (``s.seconds``
    after it), as a child of the thread's innermost open span."""
    __slots__ = ("name", "seconds", "_st", "_t0", "_children", "_range")

    def __init__(self, name: str):
        self.name = name
        self.seconds = 0.0

    def __enter__(self) -> "span":
        st = self._st = _state()
        self._children = 0.0
        self._range = None
        if _autograd_profiler._is_profiler_enabled:
            self._range = record_function(self.name)
            self._range.__enter__()
        st.stack.append(self)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.seconds = time.perf_counter() - self._t0
        st = self._st
        st.stack.pop()
        if st.stack:
            st.stack[-1]._children += self.seconds
        if _recording:
            st.records.append((self.name, st.step,
                               self.seconds - self._children))
        if self._range is not None:
            self._range.__exit__(*exc)


class region:
    """``with region(name):`` counts a call of ``name`` and, while a
    profiler records, opens a range of that name; it keeps no host time."""
    __slots__ = ("name", "_range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> "region":
        count(self.name)
        self._range = None
        if _autograd_profiler._is_profiler_enabled:
            self._range = record_function(self.name)
            self._range.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        if self._range is not None:
            self._range.__exit__(*exc)


def counters(group: str, keys: Iterable[str] = ()) -> Dict[str, int]:
    """The dict of counter group ``group`` (made at the first call, with
    ``keys`` at 0)."""
    d = _COUNTERS.setdefault(group, {})
    for k in keys:
        d.setdefault(k, 0)
    return d


def count(name: str, n: int = 1) -> None:
    group, _, key = name.rpartition(".")
    d = _COUNTERS.setdefault(group, {})
    d[key] = d.get(key, 0) + n


def read_allocator(device: torch.device) -> None:
    """On a card, sets counter group ``cuda`` to the caching allocator's
    totals: ``mallocs`` (``cudaMalloc`` calls) and ``alloc_retries``
    (allocations that freed the cache and tried again). Call it after a
    sync: it reads host state alone."""
    if device.type != "cuda":
        return
    stats = torch.cuda.memory_stats(device)
    counters("cuda").update(mallocs=int(stats.get("num_device_alloc", 0)),
                            alloc_retries=int(stats.get("num_alloc_retries",
                                                        0)))


def _flat_counts() -> Dict[str, int]:
    return {(f"{g}.{k}" if g else k): v
            for g, d in list(_COUNTERS.items()) for k, v in dict(d).items()}


class Recorder:
    """Records spans from its creation to ``stop()``; the thread that made
    it reduces them a window at a time."""

    def __init__(self):
        global _recording
        self.owner = _state()
        self._counts = _flat_counts()
        _recording = True

    def window(self, end: int, steps: int
               ) -> Tuple[Dict[str, float], Dict[str, float]]:
        """``(spans, counts)`` of the window that ends before step
        ``end`` and ran ``steps`` steps: each span name's self ms a step
        (records of the owner's thread) or a batch (of the other threads;
        ``counts["feed.batches"]`` is their batches a step), and each
        counter's change a step. Records of later steps stay queued."""
        own: Dict[str, float] = {}
        fed: Dict[str, float] = {}
        batches = set()
        with _threads_lock:
            states = list(_threads)
        for st in states:
            mine = st is self.owner
            into = own if mine else fed
            records = st.records
            while records:
                rec = records.popleft()
                if rec[1] >= end:
                    records.appendleft(rec)
                    break
                if not mine:
                    batches.add(rec[1])
                into[rec[0]] = into.get(rec[0], 0.0) + rec[2]
        spans = {name: 1e3 * s / steps for name, s in own.items()}
        for name, s in fed.items():
            spans[name] = spans.get(name, 0.0) + 1e3 * s / len(batches)
        now = _flat_counts()
        counts = {}
        for name, v in now.items():
            before = self._counts.get(name, 0)
            # a counter reset inside the window counts from 0
            counts[name] = (v - before if v >= before else v) / steps
        if batches:
            counts["feed.batches"] = len(batches) / steps
        self._counts = now
        return spans, counts

    def stop(self) -> None:
        global _recording
        _recording = False
        with _threads_lock:
            for st in _threads:
                st.records.clear()
            _threads[:] = [st for st in _threads if st.thread.is_alive()]

