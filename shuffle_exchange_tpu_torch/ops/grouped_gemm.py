"""Grouped (ragged) matmul for the MoE experts: the CUDA kernel for Hopper
and its plain PyTorch version.

Counterpart of ``shuffle_exchange_tpu/ops/grouped_gemm.py``. Shape
contract: x [N, K] with its rows sorted by group, w [E, K, F] and
group_sizes [E] int32 (summing to N) -> [N, F] in x's dtype, f32
accumulation: row n is ``x[n] @ w[g(n)]`` for the group g(n) that owns it.
``w`` may be an int8 / e4m3 :class:`~.quant_matmul.QuantizedMatrix` stack;
it then stands for ``bf16(q * s)`` (``w.dequantize()`` cast to x's dtype,
as JAX dequantizes the stack before its megablox ``gmm``).

On the card ``grouped_matmul`` launches the hand-written kernels of
``ops/csrc/grouped_gemm.cu`` (whose header says what bounds them on the
H100 and how their designs answer it): up to ``GEMV_MAX_N`` rows (64 over
int8 / e4m3 stacks, 32 over bf16: a decode tick's and small chunks') the
tensor-core GEMV of ``ops/csrc/mma_gemv.cuh`` (shared with B6, B7 and B8; its work
plan in ``ops/decode_gemv.py``), above that a warp-specialised
``wgmma`` kernel over TMA-fed tiles (``dx`` and ``dw`` too), whose producer
warps widen int8 / e4m3 expert tiles to bf16 in shared memory as they
arrive. It replaces the TPU's
``_grouped_matmul_gmm``; unlike the JAX route, which sends shapes the TPU
tiling does not take to ``ragged_dot``, every shape the port's models have
goes to the kernel. The kernel reads int8 / fp8 experts at storage width
and dequantizes them on the chip, and it reads ``group_sizes`` on the
device: no call here copies a device value to the host. The wrapper runs
its kernel for a CUDA tensor and its plain version for a CPU tensor, and
counts one launch per call on the card (``grouped_matmul.launches``).

``grouped_matmul`` is differentiable (a ``torch.autograd.Function`` that
saves x, w and the group sizes), as the megablox ``gmm``'s custom VJP is
(megablox ``ops.py:63-101``). Its backward calls two more wrappers, each
with its own kernel in the same source and its own plain version:

- ``grouped_matmul_dx(dout [N, F], w [E, K, F], sizes) -> [N, K]``: row n
  is ``dout[n] @ w[g(n)]^T`` (megablox ``gmm(transpose_rhs=True)``);
- ``grouped_matmul_dw(x [N, K], dout [N, F], sizes) -> [E, K, F]``: group
  g's block is ``x_g^T @ dout_g``, zeros for an empty group (``tgmm``).

Both sum in f32 and round once; rows past the groups' sum give zero dx
rows and add nothing to dw, as ``ragged_dot``'s gradient. Quantized
expert stacks serve only: under autograd they raise, as the JAX package
trains no quantized experts.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import decode_gemv
from .dispatch import resolve_grouped_gemm
from .quant_matmul import FP8, QuantizedMatrix, _sms


def _dense_stack(w, dtype: torch.dtype) -> torch.Tensor:
    """The expert stack the product multiplies by: a quantized stack
    dequantized in f32 and rounded to ``dtype``, a dense one cast."""
    if isinstance(w, QuantizedMatrix):
        return w.dequantize().to(dtype)
    return w.to(dtype)


def grouped_matmul_reference(x: torch.Tensor, w, group_sizes: torch.Tensor) -> torch.Tensor:
    """The plain version: a loop over the groups of f32 products over the
    weights as the kernel reads them (``bf16(q * s)`` for a quantized
    stack), one cast of each result to x's dtype; rows past the groups'
    sum are zeros (``jax.lax.ragged_dot``'s). It reads the group sizes on
    the host."""
    wd = _dense_stack(w, x.dtype)
    N, F = x.shape[0], wd.shape[-1]
    out = torch.zeros(N, F, dtype=x.dtype, device=x.device)
    for g, (a, b) in enumerate(_bounds(group_sizes, N)):
        if b > a:
            out[a:b] = (x[a:b].float() @ wd[g].float()).to(x.dtype)
    return out


def _check_shapes(x, w, group_sizes) -> Tuple[int, int, int, int]:
    if x.dim() != 2:
        raise ValueError(f"grouped_matmul: x must be [N, K], got {tuple(x.shape)}")
    if len(w.shape) != 3:
        raise ValueError(f"grouped_matmul: w must be [E, K, F], got {tuple(w.shape)}")
    N, K = x.shape
    E, K2, F = w.shape
    if K2 != K:
        raise ValueError(f"grouped_matmul: x contraction dim {K} != weight K {K2}")
    if tuple(group_sizes.shape) != (E,):
        raise ValueError(f"grouped_matmul: group_sizes {tuple(group_sizes.shape)} != ({E},)")
    return N, K, E, F


def grouped_matmul_dx_reference(dout: torch.Tensor, w: torch.Tensor,
                                group_sizes: torch.Tensor) -> torch.Tensor:
    """The plain dx: per group, f32 ``dout_g @ w[g]^T`` cast once to
    dout's dtype; rows past the groups' sum are zeros."""
    N, K = dout.shape[0], w.shape[1]
    out = torch.zeros(N, K, dtype=dout.dtype, device=dout.device)
    for g, (a, b) in enumerate(_bounds(group_sizes, N)):
        if b > a:
            out[a:b] = (dout[a:b].float() @ w[g].float().T).to(dout.dtype)
    return out


def grouped_matmul_dw_reference(x: torch.Tensor, dout: torch.Tensor,
                                group_sizes: torch.Tensor) -> torch.Tensor:
    """The plain dw: per group, f32 ``x_g^T @ dout_g`` cast once to x's
    dtype; an empty group's block is zeros."""
    N, K = x.shape
    E, F = group_sizes.shape[0], dout.shape[1]
    out = torch.zeros(E, K, F, dtype=x.dtype, device=x.device)
    for g, (a, b) in enumerate(_bounds(group_sizes, N)):
        if b > a:
            out[g] = (x[a:b].float().T @ dout[a:b].float()).to(x.dtype)
    return out


def _bounds(group_sizes: torch.Tensor, N: int):
    """[(start, end)] row range of each group, clamped to N (host read:
    the plain versions only)."""
    out, start = [], 0
    for size in group_sizes.tolist():
        end = min(start + int(size), N)
        out.append((start, end))
        start = end
    return out


class _GroupedMatmul(torch.autograd.Function):
    """The grouped matmul with the megablox VJP: dx by
    ``grouped_matmul_dx``, dw by ``grouped_matmul_dw`` (in w's dtype)."""

    @staticmethod
    def forward(ctx, x, w, group_sizes):
        ctx.save_for_backward(x, w, group_sizes)
        return _forward(x, w, group_sizes)

    @staticmethod
    def backward(ctx, dout):
        x, w, group_sizes = ctx.saved_tensors
        dout = dout.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = grouped_matmul_dx(dout, w, group_sizes)
        if ctx.needs_input_grad[1]:
            dw = grouped_matmul_dw(x, dout, group_sizes).to(w.dtype)
        return dx, dw, None


def grouped_matmul(x: torch.Tensor, w, group_sizes: torch.Tensor) -> torch.Tensor:
    """x [N, K] (rows sorted by group) @ w [E, K, F] by group_sizes [E]
    int32 -> [N, F] in x's dtype. The CUDA kernel on a CUDA tensor (bf16
    activations; bf16, int8 or e4m3 weights), the plain version on a CPU
    tensor. Differentiable in x and a dense w."""
    _check_shapes(x, w, group_sizes)
    tracked = torch.is_grad_enabled() and (
        x.requires_grad or getattr(w, "requires_grad", False))
    if not tracked:
        return _forward(x, w, group_sizes)
    if isinstance(w, QuantizedMatrix):
        raise TypeError("grouped_matmul: a QuantizedMatrix expert stack has no gradient (the "
                        "JAX package trains no quantized experts); train dense stacks and "
                        "quantize for serving")
    return _GroupedMatmul.apply(x, w, group_sizes)


def _forward(x, w, group_sizes):
    if resolve_grouped_gemm("moe", x) == "plain":
        return grouped_matmul_reference(x, w, group_sizes)
    out = _launch(x, w, group_sizes)
    grouped_matmul.launches += 1
    return out


def grouped_matmul_dx(dout: torch.Tensor, w: torch.Tensor,
                      group_sizes: torch.Tensor) -> torch.Tensor:
    """dout [N, F] by group @ w [E, K, F]^T -> dx [N, K] in dout's dtype
    (f32 sums); rows past the groups' sum are zeros. The CUDA kernel on a
    CUDA tensor (bf16), the plain version on a CPU tensor."""
    if (dout.dim() != 2 or w.dim() != 3 or w.shape[2] != dout.shape[1]
            or tuple(group_sizes.shape) != (w.shape[0],)):
        raise ValueError(f"grouped_matmul_dx: dout {tuple(dout.shape)} and w "
                         f"{tuple(w.shape)} / group_sizes {tuple(group_sizes.shape)} disagree")
    if resolve_grouped_gemm("moe", dout) == "plain":
        return grouped_matmul_dx_reference(dout, w, group_sizes)
    out = _launch_dx(dout, w, group_sizes)
    grouped_matmul_dx.launches += 1
    return out


def grouped_matmul_dw(x: torch.Tensor, dout: torch.Tensor,
                      group_sizes: torch.Tensor) -> torch.Tensor:
    """x [N, K], dout [N, F] by group -> dw [E, K, F] in x's dtype (the
    expert stack's: the port casts the stack to x's dtype before the
    product), f32 sums; an empty group's block is zeros. The CUDA kernel
    on a CUDA tensor (bf16), the plain version on a CPU tensor."""
    if x.dim() != 2 or dout.dim() != 2 or dout.shape[0] != x.shape[0] or group_sizes.dim() != 1:
        raise ValueError(f"grouped_matmul_dw: x {tuple(x.shape)}, dout {tuple(dout.shape)} "
                         f"and group_sizes {tuple(group_sizes.shape)} disagree")
    if resolve_grouped_gemm("moe", x) == "plain":
        return grouped_matmul_dw_reference(x, dout, group_sizes)
    out = _launch_dw(x, dout, group_sizes)
    grouped_matmul_dw.launches += 1
    return out


grouped_matmul.launches = 0
grouped_matmul_dx.launches = 0
grouped_matmul_dw.launches = 0


# ---------------------------------------------------------------------------
# Launch
# ---------------------------------------------------------------------------

#: total rows up to which the tensor-core GEMV runs, by weight format (the
#: wgmma forms past them). On the H100 the GEMV beat the wgmma forms at 32
#: and 64 ragged rows over Mixtral's experts in int8 and e4m3 (2-3x), and in
#: bf16 at 32 rows but not at 64 (scripts/torch_kernel_digest.py --sections
#: decode_gemv)
GEMV_MAX_N = {"bf16": 32, 8: 64, "fp8": 64}
#: the kernel's codes for the weight formats it takes
FORMATS = {8: 0, "fp8": 2, "bf16": 3}

_P, _I = ctypes.c_void_p, ctypes.c_int
_LIB = []


def _lib():
    if not _LIB:
        from . import _build

        lib = _build.load("grouped_gemm")
        lib.sxt_grouped_matmul_bf16.argtypes = [_P] * 6 + [_I] * 8 + [_P] + [_I] * 2 + [_P]
        lib.sxt_grouped_matmul_bf16.restype = ctypes.c_int
        lib.sxt_grouped_matmul_dx_bf16.argtypes = [_P] * 4 + [_I] * 4 + [_P]
        lib.sxt_grouped_matmul_dx_bf16.restype = ctypes.c_int
        lib.sxt_grouped_matmul_dw_bf16.argtypes = [_P] * 4 + [_I] * 4 + [_P]
        lib.sxt_grouped_matmul_dw_bf16.restype = ctypes.c_int
        lib.sxt_grouped_error_string.argtypes = [ctypes.c_int]
        lib.sxt_grouped_error_string.restype = ctypes.c_char_p
        _LIB.append(lib)
    return _LIB[0]


def row_groups(E: int, N: int) -> int:
    """The GEMV's row groups at most (mma_gemv_grouped_kernel's table):
    each group with rows, one more for every 16 of N."""
    return min(E, N) + N // decode_gemv.PASS_ROWS


def gemv_split(K: int, gs: int, F: int, E: int, N: int, elt_bytes: float,
               sms: int) -> Tuple[int, int]:
    """(splits, chunk) of the GEMV for N rows on E groups of [K, F] weights
    of ``elt_bytes`` a value, the reduction over K rows in chunks of whole
    scale groups of ``gs`` rows (bf16 weights: gs = 8, whole 32-row
    stages): ``decode_gemv.plan`` over the groups a call can hit, min(E, N)
    (one more for every 16 rows past the first 16)."""
    unit = gs if elt_bytes == 1 else decode_gemv.STAGE_ROWS
    groups = min(E, N) + (N - 1) // decode_gemv.PASS_ROWS
    return decode_gemv.plan(K, unit, -(-F // decode_gemv.TILE_COLS), groups, N, F, elt_bytes,
                            sms)


def _weight_operands(w, device, K: int, F: int):
    """(weight pointer, scales pointer or None, group size, format code) of
    the storage the kernel takes; anything else raises."""
    what = "grouped_matmul kernel"
    if isinstance(w, QuantizedMatrix):
        if w.bits not in (8, "fp8"):
            raise TypeError(f"{what}: takes int8 or fp8 expert storage, got bits={w.bits!r} "
                            "(int4 experts keep the rounding emulation, as in the JAX engine)")
        gs = w.group_size
        if gs % 32 or K % gs or F % 16:
            raise ValueError(f"{what}: needs group sizes that are multiples of 32 dividing K "
                             f"and F a multiple of 16; got K={K}, F={F}, group_size={gs}")
        if w.dtype != torch.bfloat16:
            raise TypeError(f"{what}: the kernel computes in bf16; the weight's compute dtype "
                            f"is {w.dtype}")
        want = {8: torch.int8, "fp8": FP8}[w.bits]
        for name, t, dt in (("q", w.q, want), ("scales", w.scales, torch.float32)):
            if t.device != device or t.dtype != dt:
                raise ValueError(f"{what}: {name} must be {dt} on {device}, got {t.dtype} on "
                                 f"{t.device}")
            if not t.is_contiguous() or t.data_ptr() % 16:
                raise ValueError(f"{what}: {name} must be contiguous and 16-byte aligned")
        return w.q.data_ptr(), w.scales.data_ptr(), gs, FORMATS[w.bits]
    if w.dtype != torch.bfloat16 or w.device != device:
        raise TypeError(f"{what}: dense weights must be bf16 on {device}, got {w.dtype} on "
                        f"{w.device}")
    if F % 8:
        raise ValueError(f"{what}: needs F a multiple of 8 for bf16 weights, got {F}")
    if not w.is_contiguous() or w.data_ptr() % 16:
        raise ValueError(f"{what}: w must be contiguous and 16-byte aligned")
    return w.data_ptr(), None, 8, FORMATS["bf16"]


def _launch(x: torch.Tensor, w, group_sizes: torch.Tensor) -> torch.Tensor:
    dev = x.device
    N, K, E, F = _check_shapes(x, w, group_sizes)
    if K % 8:
        raise ValueError(f"grouped_matmul kernel: needs K a multiple of 8, got {K}")
    x = _bf16_operand("grouped_matmul", "x", x, dev)
    sizes = _sizes_operand("grouped_matmul", group_sizes, dev)
    wp, sp, gs, fmt = _weight_operands(w, dev, K, F)
    out = torch.empty(N, F, device=dev, dtype=torch.bfloat16)
    if N == 0 or F == 0:
        return out
    stream = torch.cuda.current_stream(dev).cuda_stream
    gemv_max_n = GEMV_MAX_N["bf16" if fmt == FORMATS["bf16"] else w.bits]
    splits, chunk, part, counters, blocks = 1, K, None, None, 0
    if N <= gemv_max_n:
        sms = _sms(dev.index if dev.index is not None else torch.cuda.current_device())
        elt = 2 if fmt == FORMATS["bf16"] else 1
        splits, chunk = gemv_split(K, gs, F, E, N, elt, sms)
        tiles = -(-F // decode_gemv.TILE_COLS)
        blocks = decode_gemv.blocks(row_groups(E, N) * tiles * splits, sms)
        if splits > 1:
            part = torch.empty(splits, N, F, device=dev, dtype=torch.float32)
            counters = decode_gemv._counters(dev, stream, row_groups(E, N) * tiles)
    lib = _lib()
    _raise_on(lib, lib.sxt_grouped_matmul_bf16(
        x.data_ptr(), wp, sp, sizes.data_ptr(), out.data_ptr(),
        None if part is None else part.data_ptr(), N, K, F, E, gs, fmt, splits, chunk,
        None if counters is None else counters.data_ptr(), blocks, gemv_max_n, stream),
        "grouped_matmul")
    return out


def _bf16_operand(what: str, name: str, t: torch.Tensor, dev) -> torch.Tensor:
    """``t`` contiguous, checked for what the kernels' TMA tensor maps need:
    bf16 on ``dev`` and a 16-byte aligned base."""
    if t.dtype != torch.bfloat16 or t.device != dev:
        raise TypeError(f"{what} kernel: {name} must be bf16 on {dev}, got {t.dtype} on "
                        f"{t.device}")
    t = t.contiguous()
    if t.data_ptr() % 16:
        raise ValueError(f"{what} kernel: {name} {tuple(t.shape)} must start on a 16-byte "
                         "boundary (the base of its TMA tensor map)")
    return t


def _sizes_operand(what: str, group_sizes: torch.Tensor, dev) -> torch.Tensor:
    if group_sizes.device != dev or group_sizes.dtype != torch.int32:
        raise TypeError(f"{what} kernel: group_sizes must be int32 on {dev}, got "
                        f"{group_sizes.dtype} on {group_sizes.device}")
    return group_sizes.contiguous()


def _raise_on(lib, err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err} "
                           f"({lib.sxt_grouped_error_string(err).decode()})")


def _launch_dx(dout: torch.Tensor, w: torch.Tensor, group_sizes: torch.Tensor) -> torch.Tensor:
    what, dev = "grouped_matmul_dx", dout.device
    N, F = dout.shape
    E, K, _ = w.shape
    if K % 8 or F % 8:
        raise ValueError(f"{what} kernel: needs K and F multiples of 8, got K={K}, F={F}")
    dout = _bf16_operand(what, "dout", dout, dev)
    w = _bf16_operand(what, "w", w, dev)
    sizes = _sizes_operand(what, group_sizes, dev)
    out = torch.empty(N, K, device=dev, dtype=torch.bfloat16)
    if N == 0:
        return out
    lib = _lib()
    _raise_on(lib, lib.sxt_grouped_matmul_dx_bf16(
        dout.data_ptr(), w.data_ptr(), sizes.data_ptr(), out.data_ptr(), N, K, F, E,
        torch.cuda.current_stream(dev).cuda_stream), what)
    return out


def _launch_dw(x: torch.Tensor, dout: torch.Tensor, group_sizes: torch.Tensor) -> torch.Tensor:
    what, dev = "grouped_matmul_dw", x.device
    N, K = x.shape
    F, E = dout.shape[1], group_sizes.shape[0]
    if K % 8 or F % 8:
        raise ValueError(f"{what} kernel: needs K and F multiples of 8, got K={K}, F={F}")
    x = _bf16_operand(what, "x", x, dev)
    dout = _bf16_operand(what, "dout", dout, dev)
    sizes = _sizes_operand(what, group_sizes, dev)
    out = torch.empty(E, K, F, device=dev, dtype=torch.bfloat16)
    lib = _lib()
    _raise_on(lib, lib.sxt_grouped_matmul_dw_bf16(
        x.data_ptr(), dout.data_ptr(), sizes.data_ptr(), out.data_ptr(), N, K, F, E,
        torch.cuda.current_stream(dev).cuda_stream), what)
    return out


__all__ = ["FORMATS", "GEMV_MAX_N", "gemv_split", "grouped_matmul", "grouped_matmul_dw",
           "grouped_matmul_dw_reference", "grouped_matmul_dx", "grouped_matmul_dx_reference",
           "grouped_matmul_reference"]
