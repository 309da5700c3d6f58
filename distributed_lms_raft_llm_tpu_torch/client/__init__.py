"""LMS clients: the leader-discovering library (`client.py`), the
terminal client (`cli.py`) and the Tkinter client (`gui.py`, imported by
no other module). The port's copy of `distributed_lms_raft_llm_tpu/client/`."""

from .client import LMSClient, NoLeader  # noqa: F401
