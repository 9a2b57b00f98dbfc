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

On the card ``lora_delta`` launches the hand-written kernels of
``ops/csrc/lora_gemm.cu`` (whose header says what bounds them on the H100
and how their design answers it): one-token rows at ranks up to
``ROW_RANK`` take a CUDA-core row kernel, every other call a pair of
tensor-core kernels (mid = x @ A in f32, its D splits added in a thread
block cluster and written as two bf16 terms; then both terms against B).
They replace the TPU's ``lora_delta_pallas``. The JAX route sends shapes
the TPU tiling does not take (D or N not a multiple of 128, R not a
multiple of 8) to its gather oracle; the port has no such gate: the
kernels take every D, N and rank, and raise for the rest (dtypes,
layout). The kernels read ``slots`` on the device, so no
call here copies a device value to the host. The wrapper runs its kernels for a CUDA tensor and its
plain version for a CPU tensor, and counts one launch per call on the
card (``lora_delta.launches``).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from .dispatch import resolve_grouped_gemm

#: ranks up to which one-token rows take the CUDA-core row kernel (the C
#: entry point takes it where the wrapper passes no mid scratch): one launch
#: beats the pair's two at rank 8, the pair wins from rank 16 on the H100
ROW_RANK = 8
TILE = 64            # tokens a tensor-core block; D rows of a shrink step
ROW_BLOCKS = 32      # shrink blocks a row of the call aims for (D splits when tokens are few)
EXPAND_BLOCKS = 264  # expand blocks a call aims for (two an H100 SM; N splits)
MAX_SPLITS = 8       # D splits at most: one portable thread block cluster


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
        lib.sxt_lora_delta_bf16.argtypes = [_P] * 6 + [_I] * 9 + [_P]
        lib.sxt_lora_delta_bf16.restype = ctypes.c_int
        lib.sxt_lora_error_string.argtypes = [ctypes.c_int]
        lib.sxt_lora_error_string.restype = ctypes.c_char_p
        _LIB.append(lib)
    return _LIB[0]


def rank_chunk(R: int) -> int:
    """Ranks a shrink block computes: the rank rounded up to 16, 32 or 64
    up to rank 64, chunks of 128 past it."""
    return 16 if R <= 16 else 32 if R <= 32 else 64 if R <= 64 else 128


def shrink_splits(T: int, D: int, R: int) -> Tuple[int, int]:
    """(splits, chunk) of the first product's reduction over D: chunks of
    whole TILE-row steps, at least 4 a split and at most MAX_SPLITS
    splits, enough that a row's blocks (token tiles x rank chunks x
    splits) reach ROW_BLOCKS. A function of T, D and R only: a row's sums
    are split alike whatever else the call holds."""
    tiles, chunks, steps = -(-T // TILE), -(-R // rank_chunk(R)), -(-D // TILE)
    want = -(-ROW_BLOCKS // (tiles * chunks))
    splits = max(1, min(want, steps // 4, MAX_SPLITS))
    per = -(-steps // splits)
    return -(-steps // per), per * TILE


def expand_col_splits(B: int, T: int, N: int) -> int:
    """Ranges of N (whole 64-column tiles) the second product's blocks
    split the output into, so a call has about EXPAND_BLOCKS blocks (the
    sums do not depend on it)."""
    return max(1, min(-(-N // 64), -(-EXPAND_BLOCKS // (-(-T // TILE) * B))))


def _launch(x: torch.Tensor, a_stack: torch.Tensor, b_stack: torch.Tensor,
            slots: torch.Tensor) -> torch.Tensor:
    dev = x.device
    B, T, D, S, R, N = _check_shapes(x, a_stack, b_stack, slots)
    for name, t in (("x", x), ("a_stack", a_stack), ("b_stack", b_stack)):
        if t.dtype != torch.bfloat16 or t.device != dev:
            raise TypeError(f"lora_delta kernel: {name} must be bf16 on {dev}, got {t.dtype} on "
                            f"{t.device}")
    for name, t in (("a_stack", a_stack), ("b_stack", b_stack)):
        if not t.is_contiguous():
            raise ValueError(f"lora_delta kernel: {name} must be contiguous (a layer view of "
                             "the pool's [L, S, ...] plane is)")
    if slots.dtype != torch.int32 or slots.device != dev:
        raise TypeError(f"lora_delta kernel: slots must be int32 on {dev}, got {slots.dtype} on "
                        f"{slots.device}")
    row_kernel = T == 1 and R <= ROW_RANK
    x = x.contiguous()
    slots = slots.contiguous()
    out = torch.empty(B, T, N, device=dev, dtype=torch.bfloat16)
    if out.numel() == 0:
        return out
    mid = None
    splits = chunk = col_splits = 0
    if not row_kernel:
        splits, chunk = shrink_splits(T, D, R)
        col_splits = expand_col_splits(B, T, N)
        # mid's two bf16 terms (hi, lo), ranks padded to 16 with zeros
        mid = torch.empty(2, B, T, -(-R // 16) * 16, device=dev, dtype=torch.bfloat16)
    lib = _lib()
    err = lib.sxt_lora_delta_bf16(x.data_ptr(), a_stack.data_ptr(), b_stack.data_ptr(),
                                  slots.data_ptr(), out.data_ptr(),
                                  None if mid is None else mid.data_ptr(), B, T, D, R, N, S,
                                  splits, chunk, col_splits,
                                  torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"lora_delta kernel launch failed: CUDA error {err} "
                           f"({lib.sxt_lora_error_string(err).decode()})")
    return out


__all__ = ["ROW_RANK", "expand_col_splits", "lora_delta", "lora_delta_reference",
           "rank_chunk", "shrink_splits"]
