"""Train step, host: the host's time to issue the backward pass, any wait
inside it included, in ms a step: the span ``train.backward``, over the
steady log rows (``lib/spans.py``)."""
from benchmark.lib.spans import mean_ms


def read(r):
    return mean_ms(r, ("train.backward",))
