"""The Triton RMSNorm kernel for Hopper.

Replaces the TPU kernel ``shuffle_exchange_tpu/ops/rmsnorm.py:
_rmsnorm_pallas``. This module imports ``triton`` at the top, so only the
launcher in ``ops/rmsnorm.py`` imports it, at its first launch on a CUDA
tensor; the CPU-only install, which has no ``triton``, never does.

What bounds it on the H100: bytes. A row is read once and written once
with about four operations per element, far below the card's ridge of
~295 operations per byte, so the least time is the bytes of x, the
residual, the weight and the output over the memory rate. The design
reads each row once: one program per row, a ``tl.constexpr`` block that
covers the whole row, the statistics in f32 in registers and the optional
residual added in the same pass. x may be bf16: the kernel upcasts in
registers, which fuses the two casts that the JAX ``_norm`` writes around
its call, and it stores the output in x's dtype.
"""

import triton
import triton.language as tl


@triton.jit
def rmsnorm_kernel(X, RES, W, Y, D, eps, HAS_RES: tl.constexpr, BLOCK: tl.constexpr):
    row = tl.program_id(0).to(tl.int64)
    cols = tl.arange(0, BLOCK)
    mask = cols < D
    xv = tl.load(X + row * D + cols, mask=mask, other=0.0)
    if HAS_RES:
        rv = tl.load(RES + row * D + cols, mask=mask, other=0.0)
        # the sum rounds to x's dtype before the statistics, as the JAX
        # wrapper's ``x + residual`` does
        xv = (xv.to(tl.float32) + rv.to(tl.float32)).to(xv.dtype)
    x32 = xv.to(tl.float32)
    var = tl.sum(x32 * x32, axis=0) / D
    w = tl.load(W + cols, mask=mask, other=0.0).to(tl.float32)
    y = x32 * tl.rsqrt(var + eps) * w
    tl.store(Y + row * D + cols, y.to(Y.dtype.element_ty), mask=mask)


def launch(x, residual, weight, out, eps: float) -> None:
    """One program per row of the contiguous ``[rows, D]`` view of x."""
    D = x.shape[-1]
    rows = x.numel() // D
    block = triton.next_power_of_2(D)
    rmsnorm_kernel[(rows,)](x, x if residual is None else residual, weight, out, D, eps,
                            HAS_RES=residual is not None, BLOCK=block,
                            num_warps=min(16, max(1, block // 256)))
