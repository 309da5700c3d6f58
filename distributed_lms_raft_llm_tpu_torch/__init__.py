"""PyTorch/CUDA port of the distributed LMS tutoring node.

A second package beside `distributed_lms_raft_llm_tpu` (the JAX reference).
It imports `torch` and never `jax`, and nothing of the JAX package: it
keeps its own copies of the framework-free pieces it needs.

It serves `Tutoring.GetLLMAnswer` end to end on one NVIDIA H100 through
the bucketed engine or the paged continuous-batching engine (int8 weights
and an int8 KV cache, the production tutoring node's configuration), and
runs the Raft-replicated LMS in front of it:

- ``proto``    — the frozen wire contract (copy of the JAX package's)
- ``models``   — GPT-2 and Llama forwards on tensors, int8 quantization,
  HF / JAX weight conversion
- ``ops``      — hand-written CUDA kernels (single-token decode attention,
  the weight-only int8 matmul) with their plain PyTorch versions
- ``engine``   — sampling, prefill/decode, `TutoringEngine`, `BatchingQueue`,
  `PagedEngine`, `PagedQueue`, the bulk-scoring tenant (`scoring`)
- ``raft``     — consensus: the sans-IO core, the WAL and snapshot
  storage, the asyncio node, the gRPC transport (framework-free copies)
- ``lms``      — the replicated LMS state, persistence, `LMSServicer`
  (the relevance gate, then the tutoring fleet router `TutoringPool`)
- ``client``   — `LMSClient`: leader discovery and the student RPCs
- ``serving``  — the tutoring and LMS gRPC servers, a local LMS cluster
  started from the deployment file (`lms_cluster`)
- ``config``   — the deployment file (TOML) the nodes start from
- ``utils``    — tokenizers, metrics, deadlines, breakers, forwarding
  auth, faults, tracing, the telemetry timeline, the watchdogs

Every entry point runs on the card (``device="cuda"``) unless the caller
asks for the CPU; asking for CUDA without a card raises (`device.py`).
"""

__version__ = "0.1.0"
