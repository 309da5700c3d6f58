"""Inference runtime: sampling, prefill/decode, the bucketed
`TutoringEngine` and the `BatchingQueue` in front of it, the continuous-
batching `PagedEngine` and its `PagedQueue`, and the BERT `RelevanceGate`
that the LMS consults before a question reaches a tutoring node."""

from .batcher import BatchingQueue, PagedQueue  # noqa: F401
from .engine import EngineConfig, TutoringEngine  # noqa: F401
from .gate import GateConfig, RelevanceGate  # noqa: F401
from .generate import GenerateResult, decode, generate, prefill  # noqa: F401
from .paged import PagedEngine  # noqa: F401
from .sampling import SamplingParams, sample_step  # noqa: F401
