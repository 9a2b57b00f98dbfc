"""Kernel gate and device policy for the PyTorch port.

Counterpart of ``shuffle_exchange_tpu/ops/dispatch.py``. The JAX package
picks Pallas by backend and keeps a kill switch that forces the plain
path; the port has neither. A wrapper takes its hand-written kernel for a
CUDA tensor and its plain PyTorch version only for a CPU tensor, so where
the data lies is the one thing that decides — nothing quietly falls back
on the card.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device an entry point runs on: the card unless the caller asks
    for the CPU. With no card and no explicit CPU request this raises —
    the port never carries on on the CPU by itself."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not "
                           "available")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return dev


def use_kernel(t: torch.Tensor) -> bool:
    """The kernel gate: True for a CUDA tensor (launch the kernel or
    raise), False for a CPU tensor (the plain version)."""
    if t.is_cuda:
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain path for device {t.device}")


def resolve_decode_kernel(mode: str) -> str:
    """Resolve the serving ``decode_kernel`` knob, as the JAX package's
    ``resolve_decode_kernel`` does. "xla" is the layer body over the paged
    attention kernels; "auto" resolves to it until the fused decode
    kernels are ported; "pallas" names those fused kernels."""
    if mode not in ("auto", "pallas", "xla"):
        raise ValueError(
            f'decode_kernel must be "auto", "pallas" or "xla", got {mode!r}')
    if mode == "pallas":
        raise NotImplementedError(
            'decode_kernel="pallas" (the fused QKV+RoPE+append, split-K '
            "decode and fused MLP kernels) is not ported yet: ROADMAP "
            "queue A, item 1")
    return "xla"
