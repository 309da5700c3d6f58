"""LMS application plane: state machine, persistence, service, node wiring.

The port's own copy of `distributed_lms_raft_llm_tpu/lms/`, the sharded
group router (`group_router.py`) included. The modules are
framework-free; only the relevance gate the server hands to
`LMSServicer` runs on torch.
"""

from .node import LMSNode  # noqa: F401
from .persistence import (  # noqa: F401
    BlobStore,
    SnapshotCorruption,
    SnapshotStore,
)
from .service import FileTransferServicer, LMSServicer  # noqa: F401
from .state import LMSState, empty_state, hash_password  # noqa: F401
