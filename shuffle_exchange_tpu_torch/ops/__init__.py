"""Kernels of the PyTorch port, each beside its plain PyTorch version.

Every wrapper counts the launches of its kernel in a plain integer
(``<wrapper>.launches``); a run reads them to show that the main path went
through the kernels.
"""

from .alibi_attention import alibi_flash_attention, alibi_flash_attention_bwd
from .flash_attention import flash_attention, flash_attention_bwd, flash_attention_lse
from .fused_adam import fused_adamw_update
from .fused_decode import fused_mlp, fused_mlp_quant, fused_paged_decode_attention, fused_qkv_rope
from .grouped_gemm import grouped_matmul, grouped_matmul_dw, grouped_matmul_dx
from .lora_gemm import lora_delta
from .paged_attention import paged_decode_attention, paged_extend_attention
from .quant_matmul import QuantizedMatrix, quant_matmul, quantize_weight
from .rmsnorm import rmsnorm

#: the wrappers whose kernels the serving and training paths launch, by
#: kernel name
KERNEL_WRAPPERS = {
    "rmsnorm": rmsnorm,
    "paged_decode_attention": paged_decode_attention,
    "paged_extend_attention": paged_extend_attention,
    "fused_qkv_rope": fused_qkv_rope,
    "fused_paged_decode_attention": fused_paged_decode_attention,
    "fused_mlp": fused_mlp,
    "fused_mlp_quant": fused_mlp_quant,
    "quant_matmul": quant_matmul,
    "grouped_matmul": grouped_matmul,
    "grouped_matmul_dx": grouped_matmul_dx,
    "grouped_matmul_dw": grouped_matmul_dw,
    "lora_delta": lora_delta,
    "flash_attention": flash_attention,
    "flash_attention_bwd": flash_attention_bwd,
    "fused_adamw": fused_adamw_update,
    "alibi_flash_attention": alibi_flash_attention,
    "alibi_flash_attention_bwd": alibi_flash_attention_bwd,
}


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNEL_WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS.values():
        fn.launches = 0


__all__ = ["KERNEL_WRAPPERS", "QuantizedMatrix", "alibi_flash_attention",
           "alibi_flash_attention_bwd", "flash_attention", "flash_attention_bwd",
           "flash_attention_lse", "fused_adamw_update", "fused_mlp", "fused_mlp_quant",
           "fused_paged_decode_attention", "fused_qkv_rope", "grouped_matmul", "grouped_matmul_dw",
           "grouped_matmul_dx", "launch_counts",
           "lora_delta", "paged_decode_attention", "paged_extend_attention", "quant_matmul",
           "quantize_weight", "reset_launch_counts", "rmsnorm"]
