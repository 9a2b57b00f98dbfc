"""Kernels of the PyTorch port, each beside its plain PyTorch version.

Every wrapper counts the launches of its kernel in a plain integer
(``<wrapper>.launches``); a run reads them to show that the main path went
through the kernels.
"""

from .paged_attention import paged_decode_attention, paged_extend_attention
from .rmsnorm import rmsnorm

#: the wrappers whose kernels the serving path launches, by kernel name
KERNEL_WRAPPERS = {
    "rmsnorm": rmsnorm,
    "paged_decode_attention": paged_decode_attention,
    "paged_extend_attention": paged_extend_attention,
}


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNEL_WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS.values():
        fn.launches = 0


__all__ = ["KERNEL_WRAPPERS", "launch_counts", "paged_decode_attention",
           "paged_extend_attention", "reset_launch_counts", "rmsnorm"]
