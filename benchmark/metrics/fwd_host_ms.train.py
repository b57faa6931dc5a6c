"""Train step, host: the host's time to issue the forward pass, any wait
inside it included, in ms a step: the span ``train.forward``, over the
steady log rows (``lib/spans.py``)."""
from benchmark.lib.spans import mean_ms


def read(r):
    return mean_ms(r, ("train.forward",))
