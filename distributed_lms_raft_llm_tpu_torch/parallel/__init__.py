"""Parallelism over `torch.distributed`: the mesh and each axis'
collectives, in conjugate pairs that carry the trainer's gradients
(`mesh`), partition rules and each rank's slice (`partition`), ring
attention over the sp axis (`ring`), the GPipe pipeline over pp
(`pipeline`), and the replicated host loop of a sharded engine (`spmd`).

Port of `distributed_lms_raft_llm_tpu/parallel/`: serving's dp, tp, ep and
sp, the trainer's dp, tp, sp, ep and pp, and the multi-host layout
(`make_hybrid_mesh`). JAX's sharding helpers (`single_device_mesh`,
`named_sharding`, `shard_tree`, `shardings_for`) have no counterpart:
`single_mesh` and `partition.shard_params` take their place.
"""

from .mesh import (  # noqa: F401
    SINGLE,
    Mesh,
    ParallelAxis,
    TensorParallel,
    init_process_group,
    initialize_multihost,
    make_hybrid_mesh,
    make_mesh,
    single_mesh,
)
from .partition import (  # noqa: F401
    BERT_RULES,
    GPT2_RULES,
    LLAMA_RULES,
    MOE_RULES,
    PAGED_PLANE_SPECS,
    RULES_FOR,
    match_partition_rules,
    shard_params,
    supported_tp,
    validate_tp_heads,
)
from .pipeline import pipeline_trunk  # noqa: F401
from .ring import ring_attention  # noqa: F401
from .spmd import Replica, TensorParallelFailure  # noqa: F401
