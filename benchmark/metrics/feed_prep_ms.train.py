"""Data feed (the prefetch thread): its work on a batch, in ms a batch:
the span ``feed.prep`` with its children ``feed.read``, ``feed.params``,
``feed.upload`` and ``feed.augment``, over the steady log rows
(``lib/spans.py``)."""
from benchmark.lib.spans import mean_ms

FEED = ("feed.prep", "feed.read", "feed.params", "feed.upload",
        "feed.augment")


def read(r):
    return mean_ms(r, FEED)
