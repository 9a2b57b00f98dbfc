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


def resolve_decode_kernel(mode: str, device: Union[str, torch.device]) -> str:
    """Resolve the serving ``decode_kernel`` knob for an engine on
    ``device``, as the JAX package's ``resolve_decode_kernel`` does.

    - "xla": the layer body over the paged attention kernels.
    - "pallas": the fused decode kernels (``ops/fused_decode.py``): on a
      CUDA engine their CUDA kernels, on a CPU engine their plain
      versions (the port's counterpart of JAX's interpret-mode hook).
    - "auto": "pallas" on the card, "xla" on the CPU, as JAX resolves
      "auto" to the fused kernels only on its accelerator.
    """
    if mode not in ("auto", "pallas", "xla"):
        raise ValueError(
            f'decode_kernel must be "auto", "pallas" or "xla", got {mode!r}')
    if mode == "auto":
        return "pallas" if torch.device(device).type == "cuda" else "xla"
    return mode
