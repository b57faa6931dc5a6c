"""Data parallelism across processes (``torch.distributed``): the port's
counterpart of ``gaiaseg_tpu/parallel/mesh.py``'s process functions. The
mesh's ``model`` axis (``make_mesh``, ``tp_spec``, ``shard_state``: tensor
parallelism) is not ported."""
from .distributed import (all_gather_objects, all_reduce_grads,
                          all_reduce_sum, barrier,
                          broadcast_object, broadcast_tensors, current_backend,
                          data_parallel, initialize_distributed,
                          is_main_process, local_only, local_rank,
                          process_count, process_index, shutdown_distributed,
                          sum_over_ranks)

__all__ = ["all_gather_objects", "all_reduce_grads", "all_reduce_sum",
           "barrier", "broadcast_object", "broadcast_tensors", "current_backend",
           "data_parallel", "initialize_distributed", "is_main_process",
           "local_only", "local_rank", "process_count", "process_index",
           "shutdown_distributed", "sum_over_ranks"]
