"""Data, FSDP, tensor and sequence parallelism over ``torch.distributed``
(the port of `naturalspeech2_tpu/parallel/`: `mesh.py`, `fsdp.py`,
`tp.py` and `sp.py`).

`make_mesh` joins the process group the caller initialised (NCCL for
CUDA tensors, gloo for CPU ones) as a ``(data, model)`` grid; with no
group and one rank it makes a mesh without ``torch.distributed``. `comm`
holds every collective, each over one axis. `fsdp` splits the training
state over ``data``, `tp` the attention heads over ``model``, and `sp`
one attention's sequence over an axis.
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
    shard_batch,
)
from naturalspeech2_tpu_torch.parallel.sp import ring_attend, sp_attend, ulysses_attend
from naturalspeech2_tpu_torch.parallel.tp import TP_RULES, shard_model, spec_for_path

__all__ = ["DATA_AXIS", "MODEL_AXIS", "Mesh", "Sharding", "make_mesh", "batch_sharding",
           "shard_batch", "replicated", "is_main_process", "check_batch_split",
           "MIN_WEIGHT_SIZE", "fsdp_spec", "state_shardings", "shard_state", "gather_params",
           "reduce_scatter_grads", "TP_RULES", "spec_for_path", "shard_model", "sp_attend",
           "ulysses_attend", "ring_attend"]
