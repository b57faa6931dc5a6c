"""Per-layer readings from the program's own spans: the log rows
(``history["loss"]``) of the last ``train_segmentor`` call in the process,
which ``gaiaseg_tpu_torch.engine.train.last_history`` keeps readable after
the loop has been stopped from ``iter_hook``.

Each row holds ``spans``, every span's self ms a step (the feed thread's a
batch). The steady rows are every row of that call but the first (the
checked steps, the feed's graph capture) and none in which a profiler
recorded (``profiled``), as the untraced run sees its window. A program
whose rows hold no spans reads nothing.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence


def steady_rows() -> List[Dict[str, Any]]:
    try:
        from gaiaseg_tpu_torch.engine.train import last_history
    except ImportError:
        return []
    history = last_history() or {}
    return [row for row in history.get("loss", [])[1:]
            if "spans" in row and not row.get("profiled")]


def mean_ms(r: Dict[str, Any], names: Sequence[str]) -> Optional[float]:
    """The mean over the steady rows of the spans ``names`` added up, in
    ms; None outside a train cell or without a steady row."""
    if r.get("kind") != "train":
        return None
    rows = steady_rows()
    if not rows:
        return None
    return sum(sum(row["spans"].get(n, 0.0) for n in names)
               for row in rows) / len(rows)
