"""Tensor parallelism over `torch.distributed`: the mesh and the tp axis'
collectives (`mesh`), partition rules and each rank's parameter slice
(`partition`), and the replicated host loop of a sharded engine (`spmd`).

Port of the tp half of `distributed_lms_raft_llm_tpu/parallel/`. Not ported
yet: ring attention (`ring.py`, sp), the pipeline (`pipeline.py`, pp), the
expert-parallel all-to-all (ep) and dp inside one engine.
"""

from .mesh import (  # noqa: F401
    SINGLE,
    Mesh,
    TensorParallel,
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
from .spmd import Replica, TensorParallelFailure  # noqa: F401
