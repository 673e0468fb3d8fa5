"""Data-parallel and FSDP training over ``torch.distributed`` (the port of
`naturalspeech2_tpu/parallel/`'s data axis: `mesh.py` and `fsdp.py`).

`make_mesh` joins the process group the caller initialised (NCCL for
CUDA tensors, gloo for CPU ones); with no group and one rank it makes a
mesh without ``torch.distributed``. `comm` holds every collective the
trainers use. The model axis (tensor and sequence parallelism, JAX's
`tp.py` and `sp.py`) is not ported: ``n_model > 1`` raises.
"""

from naturalspeech2_tpu_torch.parallel.fsdp import (
    MIN_WEIGHT_SIZE,
    fsdp_spec,
    gather_params,
    reduce_scatter_grads,
    shard_state,
    state_shardings,
)
from naturalspeech2_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    Sharding,
    batch_sharding,
    check_batch_split,
    is_main_process,
    make_mesh,
    replicated,
    seed_ranks_apart,
    shard_batch,
)

__all__ = ["DATA_AXIS", "MODEL_AXIS", "Mesh", "Sharding", "make_mesh", "batch_sharding",
           "shard_batch", "replicated", "is_main_process", "check_batch_split",
           "seed_ranks_apart", "MIN_WEIGHT_SIZE", "fsdp_spec",
           "state_shardings", "shard_state", "gather_params", "reduce_scatter_grads"]
