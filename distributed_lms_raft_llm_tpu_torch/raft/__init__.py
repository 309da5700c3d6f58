"""Raft consensus: sans-IO core, durable storage, asyncio node, transports.

The port's copy of `distributed_lms_raft_llm_tpu/raft/__init__.py`,
its logic as it is.
"""

from .core import (  # noqa: F401
    ConfigChangeInFlight,
    NotLeader,
    RaftConfig,
    RaftCore,
    Role,
    TransferInFlight,
)
from .messages import (  # noqa: F401
    AppendRequest,
    AppendResponse,
    Entry,
    VoteRequest,
    VoteResponse,
    decode_command,
    encode_command,
)
from .node import MemNetwork, MemTransport, RaftNode, Transport  # noqa: F401
from .storage import FileStorage, MemoryStorage  # noqa: F401
