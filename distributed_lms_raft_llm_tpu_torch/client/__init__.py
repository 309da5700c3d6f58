"""The LMS client library: leader discovery and the student RPCs (the
port's trimmed copy of `distributed_lms_raft_llm_tpu/client/`; no CLI or
GUI yet)."""

from .client import LMSClient, NoLeader  # noqa: F401
