"""Parallelism across processes (``torch.distributed``): the port's
counterpart of ``gaiaseg_tpu/parallel/mesh.py``. ``distributed`` holds the
process functions and the data axis's collectives; ``mesh`` the ``data x
model`` mesh and the tensor-parallel sharding (``make_mesh``, ``tp_spec``,
``shard_state``, ``shard_report``); ``tensor_parallel`` the shards and the
autograd functions of the model axis."""
from .distributed import (all_gather_objects, all_reduce_grads,
                          all_reduce_sum, barrier,
                          broadcast_object, broadcast_tensors, current_backend,
                          data_parallel, initialize_distributed,
                          is_main_process, local_only, local_rank,
                          model_parallel, process_count, process_index,
                          shutdown_distributed, sum_over_ranks)
from .mesh import (DATA_AXIS, MODEL_AXIS, make_mesh, shard_report,
                   shard_state, tp_plan, tp_spec)

__all__ = ["DATA_AXIS", "MODEL_AXIS", "all_gather_objects",
           "all_reduce_grads", "all_reduce_sum", "barrier",
           "broadcast_object", "broadcast_tensors", "current_backend",
           "data_parallel", "initialize_distributed", "is_main_process",
           "local_only", "local_rank", "make_mesh", "model_parallel",
           "process_count", "process_index", "shard_report", "shard_state",
           "shutdown_distributed", "sum_over_ranks", "tp_plan", "tp_spec"]
