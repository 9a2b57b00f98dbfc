"""RMSNorm: the wrapper over the Triton kernel for Hopper, and its plain
PyTorch version.

Replaces the TPU kernel ``shuffle_exchange_tpu/ops/rmsnorm.py:
_rmsnorm_pallas``. The serving path reaches it from every ``_norm`` (ln1,
ln2 and the final norm) on every row of every tick. The kernel itself is
in ``ops/rmsnorm_triton.py`` (whose header says what bounds it on the
H100 and how its design answers that); that module imports ``triton`` at
its top, so this one imports it only inside the launcher.

``rmsnorm`` is differentiable. The JAX package has no backward kernel
(``_build_vjp`` wraps the Pallas forward in a ``custom_vjp`` whose
backward is plain jnp, by its own decision), so the port of it is a
``torch.autograd.Function`` around the forward whose backward is the same
analytic formula in plain PyTorch. It saves x as it was given (bf16 on
the training path), not an f32 copy.
"""

from __future__ import annotations

from typing import Optional

import torch

from .dispatch import use_kernel


def rmsnorm_reference(x: torch.Tensor, weight: torch.Tensor,
                      eps: float = 1e-5) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + eps) * w`` with f32 statistics, in x's dtype."""
    x32 = x.float()
    var = (x32 * x32).mean(-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return (out * weight.float()).to(x.dtype)


def rmsnorm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5,
            residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """RMSNorm of ``x + residual`` (the sum taken in x's dtype, as the JAX
    wrapper does). The Triton kernel on a CUDA tensor, the plain version on
    a CPU tensor."""
    if residual is not None and residual.shape != x.shape:
        raise ValueError(f"residual shape {tuple(residual.shape)} != x shape "
                         f"{tuple(x.shape)}")
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad or
                                    (residual is not None and residual.requires_grad)):
        if residual is not None:
            x = x + residual          # autograd splits the sum's gradient
        return _RMSNorm.apply(x, weight, float(eps))
    return _forward(x, weight, eps, residual)


rmsnorm.launches = 0


def _forward(x, weight, eps, residual=None):
    if not use_kernel(x):
        if residual is not None:
            x = x + residual
        return rmsnorm_reference(x, weight, eps)
    return _launch(x, weight, eps, residual)


def rmsnorm_backward(x, weight, g, eps: float = 1e-5):
    """(dx, dw) of ``rmsnorm(x, weight)`` for the cotangent ``g``, in f32
    and cast to the inputs' dtypes: with ``r = rsqrt(mean(x^2) + eps)`` and
    ``xhat = x r``, ``dx = r (g w - xhat mean(g w xhat))`` and
    ``dw = sum over rows of g xhat`` (JAX ``_build_vjp``'s ``_bwd``)."""
    x32, g32, w32 = x.float(), g.float(), weight.float()
    r = torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + eps)
    xhat = x32 * r
    gw = g32 * w32
    dx = r * (gw - xhat * (gw * xhat).mean(-1, keepdim=True))
    dw = (g32 * xhat).reshape(-1, x.shape[-1]).sum(0)
    return dx.to(x.dtype), dw.to(weight.dtype)


class _RMSNorm(torch.autograd.Function):
    """The forward (kernel on CUDA tensors) with the analytic backward."""

    @staticmethod
    def forward(ctx, x, weight, eps):
        ctx.save_for_backward(x, weight)
        ctx.eps = eps
        return _forward(x, weight, eps)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        dx, dw = rmsnorm_backward(x, weight, g, ctx.eps)
        return dx, dw, None


def _launch(x, weight, eps, residual):
    D = x.shape[-1]
    if tuple(weight.shape) != (D,):
        raise ValueError(f"rmsnorm kernel: weight shape {tuple(weight.shape)} != ({D},)")
    if x.dtype not in (torch.bfloat16, torch.float16, torch.float32):
        raise TypeError(f"rmsnorm kernel: unsupported dtype {x.dtype}")
    for name, t in (("x", x), ("weight", weight), ("residual", residual)):
        if t is not None and not (t.device == x.device and t.is_contiguous()):
            raise ValueError(f"rmsnorm kernel: {name} must be contiguous on {x.device}")
    if residual is not None and residual.dtype != x.dtype:
        raise TypeError(f"rmsnorm kernel: residual dtype {residual.dtype} != x dtype {x.dtype}")
    out = torch.empty_like(x)
    if x.numel():
        from . import rmsnorm_triton

        rmsnorm_triton.launch(x, residual, weight, out, float(eps))
        rmsnorm.launches += 1
    return out
