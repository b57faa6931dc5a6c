"""Train step, host: the host's time to issue the update, any wait inside
it included, in ms a step: the spans ``train.zero_grad``,
``train.grad_sync``, ``train.zero_fill``, ``train.clip`` and
``train.optimizer``, over the steady log rows (``lib/spans.py``)."""
from benchmark.lib.spans import mean_ms

UPDATE = ("train.zero_grad", "train.grad_sync", "train.zero_fill",
          "train.clip", "train.optimizer")


def read(r):
    return mean_ms(r, UPDATE)
