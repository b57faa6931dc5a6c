"""A ``torch.profiler`` span over whole steps, reduced to the device's busy
time, the time of each device operation, and the idle gaps named by what
the host was doing.

The reduction copies ``chip_smoke.py`` ``_profile_max_step``: device
activity is every CUDA event but user annotations; busy time is the union
of their intervals. Busy and wall time come from the same profiled span.
A span that records the device alone (``host=False``) leaves the host
its speed: recording every host operation slows a host-bound step, and
its idle gaps would grow by that overhead.
"""
from __future__ import annotations

import bisect
import time
from typing import Dict, List, Tuple

import torch

TOP = 10
GAP_SCAN = 4000       # host events looked at before a gap's midpoint


class Span:
    """Opened and closed by a device sync. With ``host`` it records the
    host's operations too, which name the idle gaps. On the CPU (the
    tests) it records host activity only and finds no busy time."""

    def __init__(self, device: torch.device, host: bool = True):
        from torch.profiler import ProfilerActivity, profile
        self.cuda = device.type == "cuda"
        acts = [ProfilerActivity.CPU] if host or not self.cuda else []
        if self.cuda:
            torch.cuda.synchronize()
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.start()
        self.t0 = time.perf_counter()

    def close(self) -> Dict[str, object]:
        """Sync, stop and reduce: ``wall_s``, ``busy_s``, ``kernel_s``
        (seconds by device operation name), ``range_device_s`` (device
        time of the kernels launched inside each ``record_function``
        range, by name), ``top`` and ``idle_gaps`` (at most ``TOP`` each)."""
        from torch.autograd import DeviceType
        if self.cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - self.t0
        self.prof.stop()
        spans, by_name, host, ranges = [], {}, [], {}
        for e in self.prof.events():
            a, b = e.time_range.start, e.time_range.end
            if e.device_type == DeviceType.CUDA:
                if getattr(e, "is_user_annotation", False):
                    continue
                spans.append((a, b))
                by_name[e.name] = by_name.get(e.name, 0.0) + (b - a) / 1e6
            else:
                host.append((a, b, e.name))
                if e.name.startswith("bench."):
                    ranges[e.name] = ranges.get(e.name, 0.0) \
                        + e.device_time_total / 1e6
        spans.sort()
        merged: List[List[float]] = []
        for a, b in spans:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        busy = sum(b - a for a, b in merged) / 1e6
        gaps = [(merged[i + 1][0] - merged[i][1], merged[i][1],
                 merged[i + 1][0]) for i in range(len(merged) - 1)]
        gaps.sort(reverse=True)
        host.sort()
        starts = [h[0] for h in host]
        idle: Dict[str, float] = {}
        for length, a, b in gaps[:200]:
            idle_name = _host_at(host, starts, (a + b) / 2)
            idle[idle_name] = idle.get(idle_name, 0.0) + length / 1e6
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
        return {"wall_s": wall, "busy_s": busy, "kernel_s": by_name,
                "range_device_s": ranges,
                "top": [[k, v] for k, v in top],
                "idle_gaps": [[k, v] for k, v in sorted(
                    idle.items(), key=lambda kv: -kv[1])[:TOP]]}


def _host_at(host: List[Tuple[float, float, str]], starts: List[float],
             t: float) -> str:
    """The innermost (shortest) host event running at time ``t``."""
    i = bisect.bisect_right(starts, t)
    best, best_len = "host idle", None
    for a, b, name in reversed(host[max(0, i - GAP_SCAN):i]):
        if b >= t and (best_len is None or b - a < best_len):
            best, best_len = name, b - a
    return best
