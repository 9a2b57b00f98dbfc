"""Static and dynamic fp16 loss scaling.

Counterpart of ``shuffle_exchange_tpu/runtime/loss_scaler.py`` (window
growth, backoff, hysteresis, min scale). The JAX state is a pytree inside
the jitted step; the port's engine reads the overflow flag on the host
once a step anyway, so the state is three Python numbers and ``update`` is
plain control flow with the same outcomes.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch


@dataclasses.dataclass(frozen=True)
class LossScaleState:
    scale: float            # a power of two in practice: exact in f32
    good_steps: int         # consecutive non-overflow steps
    hysteresis_left: int

    @property
    def loss_scale(self) -> float:
        return self.scale


def init_loss_scale(config) -> LossScaleState:
    """From an FP16Config (static when loss_scale > 0, else dynamic)."""
    if config.enabled and config.dynamic_loss_scale:
        initial = float(2.0 ** config.initial_scale_power)
    elif config.enabled:
        initial = float(config.loss_scale)
    else:
        initial = 1.0
    return LossScaleState(scale=initial, good_steps=0,
                          hysteresis_left=int(config.hysteresis) if config.enabled else 1)


def check_overflow(grads: Dict[str, torch.Tensor]) -> torch.Tensor:
    """A bool scalar tensor: True if any gradient element is non-finite."""
    leaves = list(grads.values())
    if not leaves:
        return torch.zeros((), dtype=torch.bool)
    return ~torch.stack([torch.isfinite(g).all() for g in leaves]).all()


def update(state: LossScaleState, overflow: bool, config) -> LossScaleState:
    """Dynamic-scale bookkeeping (reference DynamicLossScaler.update_scale):
    on overflow consume hysteresis and, once it is used up, halve the scale
    (floored at min_loss_scale) and reset the window; after
    loss_scale_window good steps in a row double it."""
    if not config.enabled or not config.dynamic_loss_scale:
        return state
    factor = 2.0
    min_scale = max(config.min_loss_scale, 1e-8)
    full = int(config.hysteresis)

    hyst = max(state.hysteresis_left - 1, 0) if overflow else state.hysteresis_left
    do_backoff = overflow and hyst == 0
    scale = max(state.scale / factor, min_scale) if do_backoff else state.scale
    if do_backoff:
        hyst = full
    if config.consecutive_hysteresis and not overflow:
        hyst = full
    good = 0 if overflow else state.good_steps + 1
    if good >= config.loss_scale_window:
        scale, good = scale * factor, 0
    return LossScaleState(scale=scale, good_steps=good, hysteresis_left=hyst)
