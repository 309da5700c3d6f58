"""Parallelism over `torch.distributed`: the mesh and each axis'
collectives (`mesh`), partition rules and each rank's parameter slice
(`partition`), ring attention over the sp axis (`ring`), and the replicated
host loop of a sharded engine (`spmd`).

Port of the serving half of `distributed_lms_raft_llm_tpu/parallel/`: tp,
ep and sp. Not ported yet: the pipeline (`pipeline.py`, pp) and dp inside
one engine.
"""

from .mesh import (  # noqa: F401
    SINGLE,
    Mesh,
    ParallelAxis,
    TensorParallel,
    axis_over,
    init_process_group,
    initialize_multihost,
    make_mesh,
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
from .ring import ring_attention  # noqa: F401
from .spmd import Replica, TensorParallelFailure  # noqa: F401
