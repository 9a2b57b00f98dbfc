"""Group-wise symmetric quantize / dequantize in plain PyTorch.

Counterpart of ``shuffle_exchange_tpu/ops/quant.py``: values are scaled
per flat group of ``group_size`` elements by max-abs / 127 (int8) or by
max-abs / 448 (e4m3 fp8), the trailing partial group zero-padded. The
serving engine uses the round trip (``quantize_dequantize``) for the
rounding-only weights of ``quantize_weights`` (the unembedding). There is
no kernel here: the JAX module has none either.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

FP8 = torch.float8_e4m3fn
FP8_MAX = float(torch.finfo(FP8).max)     # 448


def _group_scale(x: torch.Tensor, group_size: int, max_val: float):
    """Flatten, zero-pad and group: (g [groups, group] f32, scale [groups,
    1]) with each group's absmax mapped to ``max_val`` (an all-zero group
    gets scale 1)."""
    flat = x.reshape(-1).float()
    n = flat.shape[0]
    groups = -(-n // group_size)
    pad = groups * group_size - n
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    g = flat.reshape(groups, group_size)
    absmax = g.abs().amax(dim=1, keepdim=True)
    scale = torch.where(absmax > 0, absmax / max_val, torch.ones_like(absmax))
    return g, scale


def quantize_int8(x: torch.Tensor, group_size: int = 2048) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (any shape) -> (q int8 [groups, group], scales f32 [groups]);
    round half to even, as ``jnp.round``."""
    g, scale = _group_scale(x, group_size, 127.0)
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale[:, 0]


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, shape: Sequence[int], dtype=None):
    """The affine reconstruction ``q * scale`` in f32, unpadded to
    ``shape``; cast to ``dtype`` when given."""
    out = (q.float() * scale[:, None]).reshape(-1)
    n = 1
    for s in shape:
        n *= s
    out = out[:n].reshape(tuple(shape))
    return out.to(dtype) if dtype is not None else out


def quantize_dequantize(x: torch.Tensor, group_size: int = 2048) -> torch.Tensor:
    """The int8 round trip, in x's dtype."""
    q, s = quantize_int8(x, group_size)
    return dequantize_int8(q, s, x.shape, x.dtype)


def quantize_fp8(x: torch.Tensor, group_size: int = 2048) -> Tuple[torch.Tensor, torch.Tensor]:
    """x -> (q e4m3 [groups, group], scales f32 [groups]): each group's
    absmax maps to 448, the e4m3 maximum."""
    g, scale = _group_scale(x, group_size, FP8_MAX)
    return (g / scale).to(FP8), scale[:, 0]


# the same affine reconstruction as int8 (q * scale, unpadded to shape)
dequantize_fp8 = dequantize_int8


def quantize_dequantize_fp8(x: torch.Tensor, group_size: int = 2048) -> torch.Tensor:
    q, s = quantize_fp8(x, group_size)
    return dequantize_fp8(q, s, x.shape, x.dtype)


__all__ = ["FP8", "FP8_MAX", "dequantize_fp8", "dequantize_int8", "quantize_dequantize",
           "quantize_dequantize_fp8", "quantize_fp8", "quantize_int8"]
