"""PyTorch/CUDA port of the distributed LMS tutoring node.

A second package beside `distributed_lms_raft_llm_tpu` (the JAX reference).
It imports `torch` and never `jax`, and nothing of the JAX package: it
keeps its own copies of the framework-free pieces it needs.

It serves `Tutoring.GetLLMAnswer` end to end on one NVIDIA H100 through
the bucketed engine or the paged continuous-batching engine (int8 weights
and an int8 KV cache, the production tutoring node's configuration):

- ``proto``    — the frozen wire contract (copy of the JAX package's)
- ``models``   — GPT-2 and Llama forwards on tensors, int8 quantization,
  HF / JAX weight conversion
- ``ops``      — hand-written CUDA kernels (single-token decode attention,
  the weight-only int8 matmul) with their plain PyTorch versions
- ``engine``   — sampling, prefill/decode, `TutoringEngine`, `BatchingQueue`,
  `PagedEngine`, `PagedQueue`, the bulk-scoring tenant (`scoring`)
- ``serving``  — the tutoring gRPC server
- ``config``   — the deployment file (TOML) a tutoring node starts from
- ``utils``    — tokenizers, metrics, deadlines, forwarding auth, the
  telemetry timeline, the serving loop's watchdog

Every entry point runs on the card (``device="cuda"``) unless the caller
asks for the CPU; asking for CUDA without a card raises (`device.py`).
"""

__version__ = "0.1.0"
