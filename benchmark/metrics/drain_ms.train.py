"""Train loop (``staging.take``): the host's wait for the card to finish
the work queued before the batch (the step before), in ms a step: the span
``device.drain``, over the steady log rows (``lib/spans.py``)."""
from benchmark.lib.spans import mean_ms


def read(r):
    return mean_ms(r, ("device.drain",))
