"""Multi-device execution on ``torch.distributed`` (JAX:
dualdiffusion_tpu/parallel): the process group, the ("data", "model")
mesh, the sharding rule, data parallelism, FSDP and tensor parallelism."""
from .collectives import Axis, Shard, average_gradients, global_grad_norm, shard_of
from .distributed import (is_main_process, local_device, maybe_initialize_distributed,
                          process_count, process_index, shutdown)
from .mesh import (MeshConfig, ParallelState, gathered, make_mesh, mesh_layout,
                   param_sharding_rule, replicate_state, shard_batch, shard_train_state,
                   whole)
