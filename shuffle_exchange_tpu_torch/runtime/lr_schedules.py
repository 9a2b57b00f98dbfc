"""Learning-rate schedules.

Counterpart of ``shuffle_exchange_tpu/runtime/lr_schedules.py``
(LRRangeTest, OneCycle, WarmupLR, WarmupDecayLR, WarmupCosineLR and a
constant: the names and params a reference JSON ``scheduler`` section
uses), as plain ``step -> lr`` functions of a Python number. The JAX
schedules trace into its jitted step; here the engine evaluates one on the
host each step and hands the value to the optimizer.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

from ..config.config_utils import ConfigError

Schedule = Callable[[float], float]  # step -> lr


def _clip(x: float, lo: float, hi: float) -> float:
    return min(max(x, lo), hi)


def lr_range_test(lr_range_test_min_lr: float = 1e-3, lr_range_test_step_size: int = 2000,
                  lr_range_test_step_rate: float = 1.0, lr_range_test_staircase: bool = False,
                  **_) -> Schedule:
    """LR sweep for finding a good lr (reference LRRangeTest)."""

    def schedule(step):
        interval = step / lr_range_test_step_size
        if lr_range_test_staircase:
            interval = math.floor(interval)
        return lr_range_test_min_lr * (1.0 + interval * lr_range_test_step_rate)

    return schedule


def one_cycle(cycle_min_lr: float = 0.0, cycle_max_lr: float = 1e-3, decay_lr_rate: float = 0.0,
              cycle_first_step_size: int = 2000, cycle_second_step_size: Optional[int] = None,
              cycle_first_stair_count: int = 0, cycle_second_stair_count: Optional[int] = None,
              decay_step_size: int = 0, cycle_momentum: bool = True, cycle_min_mom: float = 0.85,
              cycle_max_mom: float = 0.99, decay_mom_rate: float = 0.0,
              last_batch_iteration: int = -1, **_) -> Schedule:
    """Triangular one-cycle policy (reference OneCycle)."""
    second = cycle_second_step_size if cycle_second_step_size is not None else cycle_first_step_size
    total_cycle = cycle_first_step_size + second

    def schedule(step):
        step = float(step)
        if step > total_cycle:       # post-cycle decay
            post = step - total_cycle
            decay_steps = post / max(1, decay_step_size) if decay_step_size else post
            return cycle_min_lr / (1.0 + decay_lr_rate * decay_steps)
        if step <= cycle_first_step_size:
            up_frac = _clip(step / cycle_first_step_size, 0.0, 1.0)
            return cycle_min_lr + (cycle_max_lr - cycle_min_lr) * up_frac
        down_frac = _clip((step - cycle_first_step_size) / max(1, second), 0.0, 1.0)
        return cycle_max_lr - (cycle_max_lr - cycle_min_lr) * down_frac

    return schedule


def warmup_lr(warmup_min_lr: float = 0.0, warmup_max_lr: float = 1e-3,
              warmup_num_steps: int = 1000, warmup_type: str = "log", **_) -> Schedule:
    """Warmup then constant (reference WarmupLR)."""
    warmup_num_steps = max(2, warmup_num_steps)

    def schedule(step):
        step = float(step)
        if step >= warmup_num_steps:
            return warmup_max_lr
        if warmup_type == "log":
            frac = _clip(math.log1p(max(step, 1.0)) / math.log(warmup_num_steps + 1), 0.0, 1.0)
        else:
            frac = _clip(step / warmup_num_steps, 0.0, 1.0)
        return warmup_min_lr + (warmup_max_lr - warmup_min_lr) * frac

    return schedule


def warmup_decay_lr(total_num_steps: int, warmup_min_lr: float = 0.0,
                    warmup_max_lr: float = 1e-3, warmup_num_steps: int = 1000,
                    warmup_type: str = "log", **_) -> Schedule:
    """Warmup then linear decay to 0 over total_num_steps (reference WarmupDecayLR)."""
    base = warmup_lr(warmup_min_lr, warmup_max_lr, warmup_num_steps, warmup_type)
    warmup_num_steps = max(2, warmup_num_steps)

    def schedule(step):
        step = float(step)
        if step < warmup_num_steps:
            return base(step)
        decay_frac = _clip((total_num_steps - step)
                           / max(1.0, float(total_num_steps - warmup_num_steps)), 0.0, 1.0)
        return warmup_max_lr * decay_frac

    return schedule


def warmup_cosine_lr(total_num_steps: int, warmup_min_ratio: float = 0.0,
                     warmup_num_steps: int = 1000, cos_min_ratio: float = 0.0001,
                     warmup_type: str = "linear", lr: float = 1e-3, **_) -> Schedule:
    """Warmup then cosine decay (reference WarmupCosineLR). ``lr`` is the
    peak learning rate."""
    warmup_num_steps = max(2, warmup_num_steps)

    def schedule(step):
        step = float(step)
        if step < warmup_num_steps:
            ratio = warmup_min_ratio + (1.0 - warmup_min_ratio) * _clip(
                step / warmup_num_steps, 0.0, 1.0)
        else:
            progress = _clip((step - warmup_num_steps)
                             / max(1.0, float(total_num_steps - warmup_num_steps)), 0.0, 1.0)
            ratio = cos_min_ratio + (1.0 - cos_min_ratio) * 0.5 * (
                1.0 + math.cos(math.pi * progress))
        return lr * ratio

    return schedule


def constant_lr(lr: float = 1e-3, **_) -> Schedule:
    def schedule(step):
        return lr

    return schedule


VALID_LR_SCHEDULES: Dict[str, Callable[..., Schedule]] = {
    "LRRangeTest": lr_range_test,
    "OneCycle": one_cycle,
    "WarmupLR": warmup_lr,
    "WarmupDecayLR": warmup_decay_lr,
    "WarmupCosineLR": warmup_cosine_lr,
    "Constant": constant_lr,
}


def build_schedule(scheduler_config, base_lr: float) -> Schedule:
    """Build a schedule from a config ``scheduler`` section; default constant."""
    if scheduler_config is None or scheduler_config.type is None:
        return constant_lr(lr=base_lr)
    name = scheduler_config.type
    if name not in VALID_LR_SCHEDULES:
        raise ConfigError(f"Unknown scheduler type {name!r}; valid: {sorted(VALID_LR_SCHEDULES)}")
    params = dict(scheduler_config.params)
    if name == "WarmupCosineLR":
        params.setdefault("lr", base_lr)
    return VALID_LR_SCHEDULES[name](**params)
