"""Hand-written CUDA kernels of the port, each beside its plain PyTorch version.

Importing the package registers the kernels' ``torch.library`` ops
(``dyffusion_tpu_torch::linear_attention_qkv``, ``::linear_attention_core``,
``::fused_leaky_relu``), which an exported program calls by name.
"""
from dyffusion_tpu_torch.ops.fused_act import fused_leaky_relu, fused_leaky_relu_plain
from dyffusion_tpu_torch.ops.linear_attention import (
    linear_attention_core,
    linear_attention_core_plain,
    linear_attention_qkv,
    linear_attention_qkv_plain,
)

__all__ = [
    "fused_leaky_relu",
    "fused_leaky_relu_plain",
    "linear_attention_core",
    "linear_attention_core_plain",
    "linear_attention_qkv",
    "linear_attention_qkv_plain",
]
