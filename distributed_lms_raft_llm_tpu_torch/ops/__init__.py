"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version (`attention.decode_attention` / `decode_attention_reference`)."""

from .attention import (  # noqa: F401
    decode_attention,
    decode_attention_reference,
    launch_plan,
    launch_counts,
    mask_to_bias,
    reset_launch_counts,
)
