"""Data feed: the train loop's wait for the feed itself, in ms a step: the
span ``feed.wait`` (``next`` on the prefetch queue, then the batch's own
event), over the steady log rows (``lib/spans.py``)."""
from benchmark.lib.spans import mean_ms


def read(r):
    return mean_ms(r, ("feed.wait",))
