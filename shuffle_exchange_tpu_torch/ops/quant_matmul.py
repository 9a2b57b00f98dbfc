"""Weight-only quantized matmul: the storage form, its plain PyTorch
version and the CUDA kernel for Hopper.

Counterpart of ``shuffle_exchange_tpu/ops/quant_matmul.py``. Weights are
stored as int8, as int4 nibble pairs packed two to a byte, or as e4m3 fp8,
with f32 scales per (K-group, column): :class:`QuantizedMatrix`. Its
``__rmatmul__`` makes ``y @ w`` in the engines dispatch here with no edit
at the call site, and ``w[i]`` takes layer i of stacked ``[L, K, N]``
weights, as the engines' per-layer views do.

int4 packing (the JAX layout, byte for byte): within each K-group of
``gs`` rows, row r (r < gs/2) shares a byte with row r + gs/2, the low
nibble holding row r.

The plain version follows the JAX default (``impl="auto"``) formula
exactly: dequantize in f32, round to the compute dtype, multiply in the
activation dtype, output in ``qm.dtype``. On the TPU XLA fuses that
convert into the dot, so the weights cross HBM at storage width; PyTorch
eager cannot, so on the card ``quant_matmul`` launches the hand-written
kernels of ``ops/csrc/quant_matmul.cu`` (whose header says what bounds
them on the H100 and how their design answers it): a split-K GEMV up to
``GEMV_ROWS`` rows, past them the quantized grouped GEMM's ``wgmma`` block
(``ops/csrc/wgmma_qgemm.cuh``) over the one matrix. Both dequantize on the
chip at the same rounding point. The kernels replace the TPU's
``_quant_matmul_pallas``; ``impl`` "auto" and "pallas" both take them.
The wrapper runs its kernels for a CUDA tensor and its plain version for a
CPU tensor, and counts one launch per call on the card
(``quant_matmul.launches``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from .dispatch import use_kernel

FP8 = torch.float8_e4m3fn
#: the storage formats and the kernels' codes for them
FORMATS = {8: 0, 4: 1, "fp8": 2}


class QuantizedMatrix:
    """int8 / packed-int4 / e4m3 weight with per-(group, column) f32
    scales; ``x @ qm`` dispatches to :func:`quant_matmul`. Leading stacked
    dims ([L, K, N]) are allowed; ``qm[i]`` slices them."""

    def __init__(self, q: torch.Tensor, scales: torch.Tensor, group_size: int,
                 dtype: torch.dtype, bits=8, n_cols: int = 0):
        if bits not in FORMATS:
            raise ValueError(f"bits must be 8, 4 or \"fp8\", got {bits!r}")
        self.q = q                  # int8 [..., K, N] | uint8 [..., K//2, N] | e4m3 [..., K, N]
        self.scales = scales        # f32 [..., K//gs, N]
        self.group_size = int(group_size)
        self.dtype = dtype          # compute / output dtype
        self.bits = bits
        self.n_cols = int(n_cols or q.shape[-1])

    @property
    def shape(self) -> Tuple[int, ...]:
        """The logical [..., K, N] (int4 reports the unpacked K)."""
        if self.bits == 4:
            return (*self.q.shape[:-2], 2 * self.q.shape[-2], self.n_cols)
        return tuple(self.q.shape)

    @property
    def ndim(self) -> int:
        return self.q.dim()

    @property
    def nbytes(self) -> int:
        return self.q.numel() * self.q.element_size() + 4 * self.scales.numel()

    @property
    def device(self) -> torch.device:
        return self.q.device

    def __rmatmul__(self, x):
        return quant_matmul(x, self)

    def __getitem__(self, i):
        if self.ndim <= 2:
            raise IndexError("QuantizedMatrix indexes its leading stacked dims only; "
                             f"this one is {self.shape}")
        return QuantizedMatrix(self.q[i], self.scales[i], self.group_size, self.dtype,
                               self.bits, self.n_cols)

    def to(self, device=None, dtype: Optional[torch.dtype] = None) -> "QuantizedMatrix":
        """Move the storage to ``device``; ``dtype`` sets the compute dtype
        (the storage keeps its format)."""
        return QuantizedMatrix(self.q.to(device), self.scales.to(device), self.group_size,
                               self.dtype if dtype is None else dtype, self.bits, self.n_cols)

    def dequantize(self, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """q * s in f32, cast to ``dtype`` (default: the compute dtype)."""
        gs = self.group_size
        *lead, K, N = self.shape
        qf = (_unpack_int4(self.q, gs) if self.bits == 4 else self.q).float()
        w = qf.reshape(*lead, K // gs, gs, N) * self.scales[..., :, None, :]
        return w.reshape(*lead, K, N).to(self.dtype if dtype is None else dtype)

    def __repr__(self) -> str:
        return (f"QuantizedMatrix(shape={self.shape}, bits={self.bits!r}, "
                f"group_size={self.group_size}, dtype={self.dtype}, device={self.device})")


def _pack_int4(q: torch.Tensor, group_size: int) -> torch.Tensor:
    """Integer nibbles in [-7, 7], [..., K, N] -> uint8 [..., K//2, N]: within
    each group of ``group_size`` rows, row r packs with row r + gs/2 (low /
    high nibble)."""
    *lead, K, N = q.shape
    gs = group_size
    qg = q.to(torch.int32).reshape(*lead, K // gs, gs, N)
    low = qg[..., : gs // 2, :] & 0xF
    high = qg[..., gs // 2:, :] & 0xF
    return (low | (high << 4)).to(torch.uint8).reshape(*lead, K // 2, N)


def _unpack_int4(p: torch.Tensor, group_size: int) -> torch.Tensor:
    """uint8 [..., K//2, N] -> int32 [..., K, N], sign-extended (inverse of
    :func:`_pack_int4`)."""
    *lead, Kh, N = p.shape
    hg = group_size // 2
    i = p.reshape(*lead, Kh // hg, hg, N).to(torch.int32)
    low = ((i & 0xF) ^ 8) - 8
    high = ((i >> 4) ^ 8) - 8
    return torch.cat([low, high], dim=-2).reshape(*lead, 2 * Kh, N)


def _quantize_2d(w: torch.Tensor, gs: int, bits):
    """(q storage, f32 scales [K//gs, N]) of one [K, N] matrix."""
    K, N = w.shape
    wg = w.float().reshape(K // gs, gs, N)
    absmax = wg.abs().amax(dim=-2)                               # [Kg, N]
    qmax = float(torch.finfo(FP8).max) if bits == "fp8" else (127.0 if bits == 8 else 7.0)
    scales = torch.where(absmax > 0, absmax / qmax, torch.ones_like(absmax))
    scaled = wg / scales[:, None, :]
    if bits == "fp8":
        return scaled.to(FP8).reshape(K, N), scales
    q = torch.clamp(torch.round(scaled), -qmax, qmax).reshape(K, N)
    if bits == 4:
        return _pack_int4(q, gs), scales
    return q.to(torch.int8), scales


def quantize_weight(w: torch.Tensor, group_size: int = 256, dtype: Optional[torch.dtype] = None,
                    bits=8) -> QuantizedMatrix:
    """w [..., K, N] -> QuantizedMatrix with per-(K-group, column) scales:
    symmetric int8 (``bits=8``), packed int4 (``bits=4``) or e4m3
    (``bits="fp8"``), with JAX ``quantize_weight``'s values bit for bit
    (the same f32 operations, round half to even). The group halves from
    ``group_size`` while it does not divide K, down to 32. Stacked weights
    are quantized one [K, N] slice at a time on their own device, so the
    f32 temporary is one slice."""
    if bits not in FORMATS:
        raise ValueError(f"bits must be 8, 4 or \"fp8\", got {bits}")
    *lead, K, N = w.shape
    while K % group_size and group_size >= 64:
        group_size //= 2
    if K % group_size:
        # below 32-wide groups the f32 scales erase the storage win
        raise ValueError(f"no group size of 32 or more divides K={K}; keep this weight dense")
    gs = group_size
    qrows = K // 2 if bits == 4 else K
    qdtype = {8: torch.int8, 4: torch.uint8, "fp8": FP8}[bits]
    q = torch.empty(*lead, qrows, N, dtype=qdtype, device=w.device)
    scales = torch.empty(*lead, K // gs, N, dtype=torch.float32, device=w.device)
    flat_w, flat_q, flat_s = w.reshape(-1, K, N), q.view(-1, qrows, N), scales.view(-1, K // gs, N)
    for i in range(flat_w.shape[0]):
        flat_q[i], flat_s[i] = _quantize_2d(flat_w[i], gs, bits)
    return QuantizedMatrix(q, scales, gs, dtype or w.dtype, bits=bits, n_cols=N)


def quant_matmul_reference(x: torch.Tensor, qm: QuantizedMatrix) -> torch.Tensor:
    """The JAX default formula: ``(x @ dequantize(qm).astype(x.dtype))`` in
    ``qm.dtype``, the weights dequantized in f32 and rounded to the
    compute dtype."""
    return (x @ qm.dequantize().to(x.dtype)).to(qm.dtype)


def quant_matmul(x: torch.Tensor, qm: QuantizedMatrix, impl: str = "auto") -> torch.Tensor:
    """x [..., K] @ qm ([K, N]) -> [..., N] in ``qm.dtype``. The CUDA kernel
    on a CUDA tensor (for ``impl`` "auto" and "pallas" alike), the plain
    version on a CPU tensor."""
    if impl not in ("auto", "pallas"):
        raise ValueError(f'impl must be "auto" or "pallas", got {impl!r}')
    if qm.ndim != 2:
        raise ValueError(f"quant_matmul needs a 2D weight, got {qm.shape} (the engines take "
                         "per-layer views of stacked weights)")
    if x.shape[-1] != qm.shape[0]:
        raise ValueError(f"quant_matmul: x contraction dim {x.shape[-1]} != weight K "
                         f"{qm.shape[0]}")
    if not use_kernel(x):
        return quant_matmul_reference(x, qm)
    out = _launch(x, qm)
    quant_matmul.launches += 1
    return out


quant_matmul.launches = 0


# ---------------------------------------------------------------------------
# Launch
# ---------------------------------------------------------------------------

GEMV_ROWS = 8        # rows at most of the split-K GEMV form; more take the wgmma kernel
GEMV_TILE = 64       # output columns per GEMV block
GEMV_CHUNK = 1024    # reduction rows per GEMV block, at most
WG_TILE = (256, 128)  # output rows and columns per wgmma block (wgmma_qgemm.cuh's WgQGemm)
WG_SHORT_ROWS = 128  # its short tile's rows (WgQGemmShort), taken up to this many rows
WG_STEP = 64         # reduction rows per wgmma step
WG_MIN_STEPS = 4     # reduction steps of a split at least

_P, _I = ctypes.c_void_p, ctypes.c_int
_LIB = []


def _lib():
    if not _LIB:
        from . import _build

        lib = _build.load("quant_matmul")
        lib.sxt_quant_matmul_bf16.argtypes = [_P] * 5 + [_I] * 7 + [_P]
        lib.sxt_quant_matmul_bf16.restype = ctypes.c_int
        lib.sxt_quant_error_string.argtypes = [ctypes.c_int]
        lib.sxt_quant_error_string.restype = ctypes.c_char_p
        _LIB.append(lib)
    return _LIB[0]


def quant_splits(K: int, gs: int, n_cols: Tuple[int, ...], sms: int) -> Tuple[int, int]:
    """(splits, chunk) of the quantized GEMV's reduction over K rows for
    output matrices of ``n_cols`` columns: chunks of whole scale groups,
    at most GEMV_CHUNK rows, and enough of them that the blocks number at
    least twice the SMs. Needs gs <= GEMV_CHUNK and K % gs == 0."""
    tiles = sum(-(-n // GEMV_TILE) for n in n_cols)
    groups = K // gs
    splits = max(-(-K // GEMV_CHUNK), -(-2 * sms // tiles), 1)
    per = min(-(-groups // splits), GEMV_CHUNK // gs)
    return -(-groups // per), per * gs


def wgmma_tile_rows(M: int) -> int:
    """Rows of the wgmma form's output tile: the short tile where it spans
    the call (the C entry point picks it by the same rule; the split
    schedule below counts its tiles)."""
    return WG_SHORT_ROWS if M <= WG_SHORT_ROWS else WG_TILE[0]


def wgmma_splits(M: int, K: int, N: int, sms: int) -> Tuple[int, int]:
    """(splits, chunk) of the wgmma form's reduction: one split when the
    output tiles fill half the SMs, else as many splits as one wave of
    blocks holds (one block an SM: the block's shared memory), each of at
    least WG_MIN_STEPS whole steps of WG_STEP rows."""
    tiles = -(-M // wgmma_tile_rows(M)) * -(-N // WG_TILE[1])
    steps = -(-K // WG_STEP)
    splits = 1 if 2 * tiles > sms else max(1, min(sms // tiles, steps // WG_MIN_STEPS))
    per = -(-steps // splits)
    return -(-steps // per), per * WG_STEP


@functools.lru_cache(None)
def _sms(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def check_storage(what: str, qm: QuantizedMatrix, device, K: int, N: int) -> int:
    """Refuse storage the kernels do not take; return the format code."""
    if not isinstance(qm, QuantizedMatrix):
        raise TypeError(f"{what}: expected a QuantizedMatrix, got {type(qm).__name__}")
    if tuple(qm.shape) != (K, N):
        raise ValueError(f"{what}: weight {tuple(qm.shape)} != ({K}, {N})")
    gs = qm.group_size
    if gs % 32 or K % gs or gs > GEMV_CHUNK or N % 16:
        raise ValueError(f"{what}: the kernel takes group sizes that are multiples of 32 "
                         f"up to {GEMV_CHUNK} dividing K, and N a multiple of 16; got "
                         f"K={K}, N={N}, group_size={gs}")
    if qm.dtype != torch.bfloat16:
        raise TypeError(f"{what}: the kernel computes in bf16; the weight's compute dtype "
                        f"is {qm.dtype}")
    want = {8: torch.int8, 4: torch.uint8, "fp8": FP8}[qm.bits]
    for name, t, dt in (("q", qm.q, want), ("scales", qm.scales, torch.float32)):
        if t.device != device or t.dtype != dt:
            raise ValueError(f"{what}: {name} must be {dt} on {device}, got {t.dtype} on "
                             f"{t.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must be contiguous and 16-byte aligned")
    return FORMATS[qm.bits]


def _launch(x: torch.Tensor, qm: QuantizedMatrix) -> torch.Tensor:
    dev = x.device
    K, N = qm.shape
    if x.dtype != torch.bfloat16:
        raise TypeError(f"quant_matmul kernel: x must be bf16, got {x.dtype}")
    fmt = check_storage("quant_matmul kernel", qm, dev, K, N)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, K).contiguous()
    if x2.data_ptr() % 16:   # TMA reads x from a 16-byte aligned base
        x2 = x2.clone()
    M = x2.shape[0]
    out = torch.empty(M, N, device=dev, dtype=torch.bfloat16)
    if M == 0:
        return out.reshape(*lead, N)
    sms = _sms(dev.index if dev.index is not None else torch.cuda.current_device())
    if M <= GEMV_ROWS:
        splits, chunk = quant_splits(K, qm.group_size, (N,), sms)
    else:
        splits, chunk = wgmma_splits(M, K, N, sms)
    part = None
    if M <= GEMV_ROWS or splits > 1:
        part = torch.empty(splits, M, N, device=dev, dtype=torch.float32)
    lib = _lib()
    err = lib.sxt_quant_matmul_bf16(
        x2.data_ptr(), qm.q.data_ptr(), qm.scales.data_ptr(), out.data_ptr(),
        None if part is None else part.data_ptr(), M, K, N, qm.group_size, fmt, splits, chunk,
        torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"quant_matmul kernel launch failed: CUDA error {err} "
                           f"({lib.sxt_quant_error_string(err).decode()})")
    return out.reshape(*lead, N)


__all__ = ["FORMATS", "FP8", "QuantizedMatrix", "check_storage", "quant_matmul",
           "quant_matmul_reference", "quant_splits", "quantize_weight", "wgmma_splits"]
