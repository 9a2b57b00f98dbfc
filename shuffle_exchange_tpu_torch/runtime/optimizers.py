"""Optimizer construction from config.

Counterpart of ``shuffle_exchange_tpu/runtime/optimizers.py``
(``build_optimizer``) for the Adam family: ``Adam``, ``AdamW``,
``FusedAdam`` and ``CPUAdam`` with the reference's ``adam_w_mode`` default
rule, and global-norm clipping in front. With decoupled weight decay every
one of them steps through the fused AdamW kernel's wrapper
(``ops/fused_adam.py``): the JAX package sends only ``FusedAdam`` to its
kernel because optax is its other choice, while the port has no second
implementation on the card and the function is the same. ``Adam`` with L2
decay (``adam_w_mode: false``) is plain torch ops. The other optimizer
types raise, naming their ROADMAP item.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from ..config.config_utils import ConfigError
from ..ops.fused_adam import FusedAdamW, bias_corrections
from ..utils.logging import logger

_ONEBIT = ("onebitadam", "zerooneadam", "onebitlamb")
_LATER = ("lamb", "fusedlamb", "lion", "fusedlion", "cpulion", "sgd", "adagrad", "cpuadagrad",
          "muon")


class AdamL2(FusedAdamW):
    """Adam whose weight decay is L2 (added to the gradient before the
    moments: ``optax.chain(add_decayed_weights(wd), adam)``), in plain
    torch ops. Shares the state and the clipping of ``FusedAdamW``."""

    def _step_leaf(self, p, g, m, v, lr, step, scale):
        bc1, bc2 = bias_corrections(self.b1, self.b2, step)
        g = g.float() * scale if scale != 1.0 else g.float()
        if self.weight_decay:
            g = g + self.weight_decay * p
        m.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
        v.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
        p.sub_(lr * ((m / bc1) / (torch.sqrt(v / bc2) + self.eps)))


def build_optimizer(optimizer_config, lr_schedule, gradient_clipping: float = 0.0,
                    weight_decay_mask: Optional[Any] = None) -> FusedAdamW:
    """[clip by global norm] -> the update rule, with lr = the schedule.
    Loss-scale unscaling and overflow skipping are the engine's."""
    if optimizer_config is None:
        raise ConfigError("No optimizer section in config and no client optimizer provided")
    name = optimizer_config.type
    params = dict(optimizer_config.params)
    lr = params.pop("lr", params.pop("learning_rate", 1e-3))
    betas = params.pop("betas", (0.9, 0.999))
    b1, b2 = float(betas[0]), float(betas[1])
    eps = float(params.pop("eps", 1e-8))
    wd = float(params.pop("weight_decay", 0.0))
    params.pop("momentum", None)
    schedule = lr_schedule if lr_schedule is not None else float(lr)
    clip = float(gradient_clipping or 0.0)

    lowered = name.lower()
    if lowered in _ONEBIT:
        raise ConfigError(f"optimizer type {name!r} (the 1-bit family) is not in the PyTorch "
                          "port yet: ROADMAP queue A, item 12")
    if lowered in _LATER:
        raise ConfigError(f"optimizer type {name!r} is not in the PyTorch port yet: ROADMAP "
                          "queue A, item 14 (adam, adamw, fusedadam and cpuadam are)")
    if lowered not in ("adam", "fusedadam", "cpuadam", "adamw"):
        raise ConfigError(f"Unknown optimizer type {name!r}")
    if weight_decay_mask is not None:
        raise ConfigError("weight_decay_mask is not in the PyTorch port yet: ROADMAP queue A, "
                          "item 14")
    # reference FusedAdam/DeepSpeedCPUAdam both default adam_w_mode=True
    adam_w_mode = params.pop("adam_w_mode", lowered in ("adamw", "fusedadam", "cpuadam"))
    kind = FusedAdamW if (adam_w_mode or lowered == "adamw") else AdamL2
    # FusedAdam with decoupled decay is the reference's kernel path, which
    # reads the schedule at the count after the increment; every other Adam
    # type is optax there, which reads it before
    offset = 1 if (lowered == "fusedadam" and adam_w_mode) else 0
    if params:
        logger.info(f"Optimizer {name}: ignoring unsupported params {sorted(params)}")
    return kind(schedule, b1=b1, b2=b2, eps=eps, weight_decay=wd, max_grad_norm=clip,
                schedule_offset=offset)


def get_base_lr(optimizer_config) -> float:
    if optimizer_config is None:
        return 1e-3
    p = optimizer_config.params
    return float(p.get("lr", p.get("learning_rate", 1e-3)))
