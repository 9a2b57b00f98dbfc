"""Fused AdamW: the CUDA kernel for Hopper, its plain PyTorch version, and
the optimizer object the training engine steps.

Replaces the TPU kernel ``shuffle_exchange_tpu/ops/fused_adam.py:
fused_adamw_update`` and its optax wrapper ``pallas_adamw``. The kernel
lives in ``ops/csrc/fused_adam.cu`` (whose header says what bounds it on
the H100 and how the design answers it); ``_build`` compiles that file
with ``nvcc`` at first use and this module binds it with ctypes.

One thing differs from the JAX module, on purpose: the update is in place
on ``p, m, v`` (JAX returns new arrays and aliases them), which is what
keeps the step at 28 bytes an element. ``FusedAdamW`` reads the learning
rate of a schedule where ``pallas_adamw`` reads it, at the count *after*
the increment (1 at the first update); ``schedule_offset=0`` gives
``optax.adamw``'s index (0 at the first update), which the JAX package runs
for every other Adam type. The two differ by one schedule step and not at
all under a constant learning rate.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Callable, Dict, Optional, Union

import numpy as np
import torch

from .dispatch import use_kernel


def bias_corrections(b1: float, b2: float, step: int):
    """``(1 - b1^step, 1 - b2^step)`` in f32, as the TPU kernel's wrapper
    computes them."""
    one, s = np.float32(1.0), np.float32(step)
    return float(one - np.float32(b1) ** s), float(one - np.float32(b2) ** s)


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------


def reference_update(p, g, m, v, *, lr, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0,
                     step=1, grad_scale=1.0):
    """(new_p, new_m, new_v), all f32 except new_p in p's dtype: the JAX
    ``_reference_update`` with the gradient first multiplied by
    ``grad_scale`` (the clip coefficient)."""
    bc1, bc2 = bias_corrections(b1, b2, step)
    p32 = p.float()
    g32 = g.float() * grad_scale if grad_scale != 1.0 else g.float()
    mv = b1 * m + (1.0 - b1) * g32
    vv = b2 * v + (1.0 - b2) * g32 * g32
    m_hat = mv / bc1
    v_hat = vv / bc2
    new_p = p32 - lr * (m_hat / (torch.sqrt(v_hat) + eps) + weight_decay * p32)
    return new_p.to(p.dtype), mv, vv


# ---------------------------------------------------------------------------
# Wrapper
# ---------------------------------------------------------------------------


def fused_adamw_update(p, g, m, v, *, lr, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0,
                       step=1, grad_scale=1.0) -> None:
    """One AdamW step on a leaf, in place on ``p``, ``m`` and ``v`` (f32,
    any shape); ``g`` is the f32 gradient, multiplied by ``grad_scale``
    inside the pass; ``step`` is the 1-based count of the bias correction.
    The CUDA kernel on CUDA tensors, the plain version on CPU tensors."""
    if not (p.shape == g.shape == m.shape == v.shape):
        raise ValueError(f"fused adamw: p {tuple(p.shape)}, g {tuple(g.shape)}, m "
                         f"{tuple(m.shape)} and v {tuple(v.shape)} must have one shape")
    if step < 1:
        raise ValueError(f"fused adamw: step is the 1-based update count, got {step}")
    if not use_kernel(p):
        new_p, new_m, new_v = reference_update(p, g, m, v, lr=lr, b1=b1, b2=b2, eps=eps,
                                               weight_decay=weight_decay, step=step,
                                               grad_scale=grad_scale)
        p.copy_(new_p)
        m.copy_(new_m)
        v.copy_(new_v)
        return
    _launch(p, g, m, v, lr, b1, b2, eps, weight_decay, step, grad_scale)


fused_adamw_update.launches = 0

_LIB = []
_SMS: Dict[int, int] = {}


def _lib():
    if not _LIB:
        from . import _build

        lib = _build.load("fused_adam")
        P, F = ctypes.c_void_p, ctypes.c_float
        lib.sxt_fused_adamw_f32.argtypes = [P] * 4 + [ctypes.c_longlong] + [F] * 10 + [ctypes.c_int, P]
        lib.sxt_fused_adamw_f32.restype = ctypes.c_int
        lib.sxt_adam_error_string.argtypes = [ctypes.c_int]
        lib.sxt_adam_error_string.restype = ctypes.c_char_p
        _LIB.append(lib)
    return _LIB[0]


def _launch(p, g, m, v, lr, b1, b2, eps, weight_decay, step, grad_scale) -> None:
    dev = p.device
    for name, t in (("p", p), ("g", g), ("m", m), ("v", v)):
        if t.device != dev:
            raise ValueError(f"fused adamw kernel: {name} must be on {dev}")
        if t.dtype != torch.float32:
            raise TypeError(f"fused adamw kernel: {name} must be f32, got {t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"fused adamw kernel: {name} must be contiguous and 16-byte "
                             "aligned")
    n = p.numel()
    if n == 0:
        return
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    bc1, bc2 = bias_corrections(b1, b2, step)
    lib = _lib()
    err = lib.sxt_fused_adamw_f32(
        p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(), n, float(lr), float(b1),
        float(b2), 1.0 - b1, 1.0 - b2, float(eps), float(weight_decay), bc1, bc2,
        float(grad_scale), _SMS[idx],
        torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"fused adamw kernel launch failed: CUDA error {err} "
                           f"({lib.sxt_adam_error_string(err).decode()})")
    fused_adamw_update.launches += 1


# ---------------------------------------------------------------------------
# The optimizer object (JAX pallas_adamw / PallasAdamState)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class AdamState:
    """``count`` updates applied so far; first and second moments ``mu`` and
    ``nu`` in f32 under the parameters' flattened leaf names."""

    count: int
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]


def clip_coefficient(grad_norm: float, max_norm: float) -> float:
    """The factor ``optax.clip_by_global_norm`` puts on every gradient."""
    if not max_norm or max_norm <= 0 or grad_norm < max_norm:
        return 1.0
    return max_norm / grad_norm


def global_norm(grads: Dict[str, torch.Tensor]) -> torch.Tensor:
    """sqrt(sum of squares over every leaf), an f32 scalar tensor (a dot
    product a leaf: no temporary of the leaf's size)."""
    flat = [g.float().reshape(-1) for g in grads.values()]
    return torch.sqrt(sum(torch.dot(g, g) for g in flat))


class FusedAdamW:
    """AdamW with decoupled weight decay whose every leaf steps through
    ``fused_adamw_update``. ``learning_rate`` is a float or a function of
    the step, read at the new count less 1 plus ``schedule_offset`` (1:
    ``pallas_adamw``'s index, 0: ``optax.adamw``'s); ``max_grad_norm`` > 0
    clips by the global norm first (the coefficient rides into the kernel
    as one scalar on the gradient)."""

    def __init__(self, learning_rate: Union[float, Callable[[int], float]], b1=0.9, b2=0.999,
                 eps=1e-8, weight_decay=0.0, max_grad_norm: float = 0.0,
                 schedule_offset: int = 1):
        self.learning_rate = learning_rate
        self.schedule_offset = int(schedule_offset)
        self.b1, self.b2, self.eps = float(b1), float(b2), float(eps)
        self.weight_decay = float(weight_decay)
        self.max_grad_norm = float(max_grad_norm or 0.0)

    def init(self, params: Dict[str, torch.Tensor]) -> AdamState:
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return AdamState(count=0, mu={k: zeros(p) for k, p in params.items()},
                         nu={k: zeros(p) for k, p in params.items()})

    def lr_at(self, count: int) -> float:
        lr = self.learning_rate
        return float(lr(count)) if callable(lr) else float(lr)

    def update(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
               state: AdamState, grad_norm: Optional[float] = None) -> None:
        """One step in place on ``params`` and ``state``. ``grad_norm`` is
        the gradients' global norm when the caller has it already."""
        scale = 1.0
        if self.max_grad_norm > 0:
            if grad_norm is None:
                grad_norm = float(global_norm(grads))
            scale = clip_coefficient(grad_norm, self.max_grad_norm)
            if not math.isfinite(scale):
                scale = 1.0
        lr = self.lr_at(state.count + self.schedule_offset)
        state.count += 1
        for name, p in params.items():
            self._step_leaf(p, grads[name], state.mu[name], state.nu[name], lr, state.count,
                            scale)

    def _step_leaf(self, p, g, m, v, lr, step, scale) -> None:
        fused_adamw_update(p, g, m, v, lr=lr, b1=self.b1, b2=self.b2, eps=self.eps,
                           weight_decay=self.weight_decay, step=step, grad_scale=scale)


__all__ = ["AdamState", "FusedAdamW", "bias_corrections", "clip_coefficient",
           "fused_adamw_update", "global_norm", "reference_update"]
