"""What a run hands back, and the lines it prints."""
from __future__ import annotations

import dataclasses
import json
import math
import sys
from typing import Any, Dict, Iterable, List, Optional, Tuple

FORBIDDEN = ("jax", "jaxlib", "flax", "gaiaseg_tpu")


def forbidden_modules(modules: Iterable[str]) -> List[str]:
    """The forbidden top-level packages among loaded module names, compared
    by the whole top-level name (``gaiaseg_tpu_torch`` is not
    ``gaiaseg_tpu``)."""
    tops = {str(m).split(".", 1)[0] for m in modules}
    return sorted(t for t in tops if t in FORBIDDEN)


@dataclasses.dataclass
class Check:
    """One number compared with the plain reference, and its limit: the
    run is correct only where ``value <= limit`` (a NaN fails)."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return not math.isnan(self.value) and self.value <= self.limit


@dataclasses.dataclass
class Run:
    e2e: Dict[str, float]
    readings: Dict[str, Any]
    checks: List[Check]
    attempted: int
    failed: int
    device: Dict[str, Any]
    breakdown: Optional[Dict[str, List[Tuple[str, float]]]] = None

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(c.ok for c in self.checks)


def emit(run: Run, metrics: Dict[str, Any], trace: bool) -> None:
    device = dict(run.device)
    if not trace:
        device.pop("busy_s", None)
        device.pop("window_s", None)
    line = {"correct": run.correct, "attempted": int(run.attempted),
            "failed": int(run.failed), "metrics": metrics, "device": device}
    if trace and run.breakdown:
        line["breakdown"] = run.breakdown
    line["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                      for c in run.checks}
    for c in run.checks:
        print(f"check {c.name}: {c.value!r} limit {c.limit!r} "
              f"{'ok' if c.ok else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
