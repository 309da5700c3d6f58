"""PyTorch/CUDA port of the distributed LMS tutoring node.

A second package beside `distributed_lms_raft_llm_tpu` (the JAX reference).
It imports `torch` and never `jax`, and nothing of the JAX package: it
keeps its own copies of the framework-free pieces it needs.

This slice serves `Tutoring.GetLLMAnswer` end to end on one NVIDIA H100
through the bucketed engine:

- ``proto``    — the frozen wire contract (copy of the JAX package's)
- ``models``   — GPT-2 forward on tensors, HF / JAX weight conversion
- ``ops``      — hand-written CUDA kernels (single-token decode attention)
  with their plain PyTorch versions
- ``engine``   — sampling, prefill/decode, `TutoringEngine`, `BatchingQueue`
- ``serving``  — the tutoring gRPC server
- ``utils``    — tokenizers, metrics, deadlines, forwarding auth

Every entry point runs on the card (``device="cuda"``) unless the caller
asks for the CPU; asking for CUDA without a card raises (`device.py`).
"""

__version__ = "0.1.0"
