"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version (`attention.decode_attention` / `decode_attention_reference`,
`quant_matmul.int8_matmul` / `int8_matmul_reference`)."""

from .attention import (  # noqa: F401
    decode_attention,
    decode_attention_reference,
    launch_plan,
    launch_counts,
    mask_to_bias,
    reset_launch_counts,
)
from .quant_matmul import int8_matmul, int8_matmul_reference  # noqa: F401
