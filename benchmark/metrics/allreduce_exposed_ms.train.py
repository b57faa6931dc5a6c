"""Gradient all-reduce (``parallel/distributed.py`` ``all_reduce_grads``
over NCCL, one rank a card): on rank 0, the device ms a step in which an
NCCL kernel runs and no other kernel does, over the profiled cycles
(``loops/ddp.py``). Nothing is read where no NCCL kernel ran."""


def read(r):
    if r.get("kind") != "train":
        return None
    return r.get("allreduce_exposed_ms")
