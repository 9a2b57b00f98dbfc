"""Per-row multi-adapter LoRA delta for the serving step: the CUDA kernel
for Hopper and its plain PyTorch version.

Counterpart of ``shuffle_exchange_tpu/ops/lora_gemm.py``. Shape contract:
x [B, T, D], a_stack [S, D, R], b_stack [S, R, N], slots [B] int32 ->
delta [B, T, N] in x's dtype, with

    delta[b] = (x[b] @ a_stack[slots[b]]) @ b_stack[slots[b]]

summed in f32, the middle product [T, R] kept in f32. ``slots`` index the
adapter pool's slot axis (``inference/adapters.py``): slot 0 is the
all-zeros null adapter, so rows without an adapter ride the same call and
add an exact zero. The scaling alpha / r is folded into the stored B
factors at registration.

On the card ``lora_delta`` launches the hand-written kernel of
``ops/csrc/lora_gemm.cu`` (whose header says what bounds it on the H100
and how its design answers it). It replaces the TPU's
``lora_delta_pallas``. The JAX route sends shapes the TPU tiling does not
take (D or N not a multiple of 128, R not a multiple of 8) to its gather
oracle; the port has no such gate: the kernel takes every D and N and any
rank (above 64 in rank chunks of 64, with mid in device scratch the
wrapper allocates), and raises for the rest (dtypes, alignment). The
kernel reads ``slots`` on the device, so no call here copies a device
value to the host. The wrapper runs its kernel for a CUDA tensor and its
plain version for a CPU tensor, and counts one launch per call on the
card (``lora_delta.launches``).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from .dispatch import resolve_grouped_gemm

#: the ranks the kernel's shared-memory forms take; above it, stage 1 runs in
#: rank chunks of this many columns and mid goes to f32 scratch on the card
CHUNK_RANK = 64


def lora_delta_reference(x: torch.Tensor, a_stack: torch.Tensor, b_stack: torch.Tensor,
                         slots: torch.Tensor) -> torch.Tensor:
    """The plain version (JAX ``lora_delta_oracle``): gather each row's
    factor pair, ``mid = x @ A`` in f32, ``out = mid @ f32(B)`` in f32, one
    cast to x's dtype."""
    idx = slots.long()
    a = a_stack[idx].float()                      # [B, D, R]
    b = b_stack[idx].float()                      # [B, R, N]
    mid = torch.bmm(x.float(), a)                 # [B, T, R], f32
    return torch.bmm(mid, b).to(x.dtype)


def _check_shapes(x, a_stack, b_stack, slots) -> Tuple[int, int, int, int, int, int]:
    if x.dim() != 3:
        raise ValueError(f"lora_delta: x must be [B, T, D], got {tuple(x.shape)}")
    if a_stack.dim() != 3 or b_stack.dim() != 3:
        raise ValueError(f"lora_delta: a_stack must be [S, D, R] and b_stack [S, R, N], got "
                         f"{tuple(a_stack.shape)} and {tuple(b_stack.shape)}")
    B, T, D = x.shape
    S, D2, R = a_stack.shape
    if D2 != D or tuple(b_stack.shape[:2]) != (S, R):
        raise ValueError(f"lora_delta: x [.., {D}], a_stack {tuple(a_stack.shape)} and b_stack "
                         f"{tuple(b_stack.shape)} do not chain")
    if tuple(slots.shape) != (B,):
        raise ValueError(f"lora_delta: slots {tuple(slots.shape)} != ({B},)")
    return B, T, D, S, R, b_stack.shape[2]


def lora_delta(x: torch.Tensor, a_stack: torch.Tensor, b_stack: torch.Tensor,
               slots: torch.Tensor) -> torch.Tensor:
    """x [B, T, D] @ a_stack[slots] [B, D, R] @ b_stack[slots] [B, R, N] ->
    [B, T, N] in x's dtype (f32 sums, f32 mid). The CUDA kernel on a CUDA
    tensor (bf16 operands, int32 slots on the device, any rank), the plain
    version on a CPU tensor."""
    _check_shapes(x, a_stack, b_stack, slots)
    if resolve_grouped_gemm("lora", x) == "plain":
        return lora_delta_reference(x, a_stack, b_stack, slots)
    out = _launch(x, a_stack, b_stack, slots)
    lora_delta.launches += 1
    return out


lora_delta.launches = 0


# ---------------------------------------------------------------------------
# Launch
# ---------------------------------------------------------------------------

_P, _I = ctypes.c_void_p, ctypes.c_int
_LIB = []


def _lib():
    if not _LIB:
        from . import _build

        lib = _build.load("lora_gemm")
        lib.sxt_lora_delta_bf16.argtypes = [_P] * 6 + [_I] * 6 + [_P]
        lib.sxt_lora_delta_bf16.restype = ctypes.c_int
        lib.sxt_lora_error_string.argtypes = [ctypes.c_int]
        lib.sxt_lora_error_string.restype = ctypes.c_char_p
        _LIB.append(lib)
    return _LIB[0]


def _launch(x: torch.Tensor, a_stack: torch.Tensor, b_stack: torch.Tensor,
            slots: torch.Tensor) -> torch.Tensor:
    dev = x.device
    B, T, D, S, R, N = _check_shapes(x, a_stack, b_stack, slots)
    for name, t in (("x", x), ("a_stack", a_stack), ("b_stack", b_stack)):
        if t.dtype != torch.bfloat16 or t.device != dev:
            raise TypeError(f"lora_delta kernel: {name} must be bf16 on {dev}, got {t.dtype} on "
                            f"{t.device}")
    # A's rows are read 8 ranks at a time when R % 8 == 0, B's rows 8 (N % 8
    # == 0) or 2 (N even) columns at a time
    a_align = 16 if R % 8 == 0 else 2
    b_align = 16 if N % 8 == 0 else 4 if N % 2 == 0 else 2
    for name, t, need in (("a_stack", a_stack, a_align), ("b_stack", b_stack, b_align)):
        if not t.is_contiguous() or t.data_ptr() % need:
            raise ValueError(f"lora_delta kernel: {name} must be contiguous and {need}-byte "
                             "aligned (a layer view of the pool's [L, S, ...] plane is)")
    if slots.dtype != torch.int32 or slots.device != dev:
        raise TypeError(f"lora_delta kernel: slots must be int32 on {dev}, got {slots.dtype} on "
                        f"{slots.device}")
    x = x.contiguous()
    slots = slots.contiguous()
    out = torch.empty(B, T, N, device=dev, dtype=torch.bfloat16)
    if out.numel() == 0:
        return out
    mid = (torch.empty(B, T, R, device=dev, dtype=torch.float32) if R > CHUNK_RANK
           else None)
    lib = _lib()
    err = lib.sxt_lora_delta_bf16(x.data_ptr(), a_stack.data_ptr(), b_stack.data_ptr(),
                                  slots.data_ptr(), out.data_ptr(),
                                  None if mid is None else mid.data_ptr(), B, T, D, R, N, S,
                                  torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"lora_delta kernel launch failed: CUDA error {err} "
                           f"({lib.sxt_lora_error_string(err).decode()})")
    return out


__all__ = ["CHUNK_RANK", "lora_delta", "lora_delta_reference"]
