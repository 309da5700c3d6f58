"""Frozen wire contract (`lms.proto`) plus generated messages and RPC glue.

The port's own copy of the JAX package's `proto/`, byte-identical on the
wire, so the PyTorch tutoring node serves the unchanged LMS.

Regenerate messages with::

    cd distributed_lms_raft_llm_tpu_torch/proto && protoc --python_out=. lms.proto

`rpc.py` provides the stub/servicer layer (it needs no grpcio-tools).
The same adder functions work for both `grpc.server` and `grpc.aio.server`
(coroutine handlers are dispatched natively by grpc.aio).
"""


# Generated gencode does a bare `import`-style module registration under the
# name "lms_pb2"; importing it as a package submodule is fine because it has
# no cross-proto imports.
from . import lms_pb2  # noqa: F401
from .rpc import *  # noqa: F401,F403
from . import rpc  # noqa: F401
