"""The training engine of the PyTorch port, for one card.

Counterpart of ``shuffle_exchange_tpu/runtime/engine.py`` cut to what one
device runs: f32 master weights, a forward copy in the training dtype
(bf16, fp16 or f32) made from the master every step, gradients with
respect to that copy cast to f32 and accumulated over the
gradient-accumulation micro-batches, the division by ``scale * gas``, the
fp16 overflow check, the f32 global gradient norm, the non-finite guard,
the optimizer update (skipped on a bad step, which leaves master, moments
and the step count as they were) and the loss-scale update.

What differs from the JAX engine, on purpose:

- The JAX step is one jitted program that computes the update and then
  selects the old state on a bad step. Here the step runs eagerly, the
  engine reads the loss, the gradient norm and the overflow flag on the
  host once a step (one synchronisation) and does not launch the update at
  all on a bad step. The state a step leaves behind is the same.
- The update is in place (``ops/fused_adam.py``), so ``state.master`` keeps
  its tensors from step to step.
- ``zero_optimization.stage`` 0-3 is accepted and recorded; at world size 1
  all four are the same computation. A world size above 1, the host
  optimizer, ensemble (shuffle-exchange) mode, checkpoints, monitors, the
  dataloader and the profiler are not here yet; the config loader and
  ``initialize`` raise for them, naming their ROADMAP items.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ..config import ConfigError, SXConfig
from ..ops.dispatch import resolve_device
from ..ops.fused_adam import global_norm
from ..utils.logging import logger
from . import loss_scaler as ls
from .lr_schedules import build_schedule
from .optimizers import build_optimizer, get_base_lr

_STATE_ALIASES = {"exp_avg": "mu", "exp_avg_sq": "nu", "momentum": "mu", "variance": "nu"}


@dataclasses.dataclass
class TrainState:
    """Everything that evolves across steps."""

    master: Dict[str, torch.Tensor]     # f32 master params by flattened name
    opt_state: Any                      # ops.fused_adam.AdamState: count, mu, nu
    loss_scale: ls.LossScaleState
    step: int                           # optimizer updates applied (bad steps do not count)
    frozen: Any = ()                    # LoRA frozen base; () until LoRA is ported


class Engine:
    def __init__(self, config: SXConfig, loss_fn: Callable, params: Dict[str, torch.Tensor],
                 optimizer=None, lr_scheduler=None, device=None):
        """``loss_fn(params, batch, rng) -> scalar loss``; ``params`` the
        initial weights by flattened name (copied into the f32 master on
        ``device``). ``optimizer`` (an object with ``init`` and ``update``
        like ``ops.fused_adam.FusedAdamW``) and ``lr_scheduler`` (step ->
        lr) override the config's sections."""
        self.config = config
        self.device = resolve_device(device)
        self.loss_fn = loss_fn
        self.module = None
        self.global_steps = 0
        self.global_samples = 0
        self.skipped_steps = 0
        self.micro_steps = 0
        self._stashed_batch = None
        self._accum_grads = None
        self._accum_count = 0
        self._last_grad_norm = None

        self.train_dtype = config.train_dtype
        self.fp16_enabled = config.fp16.enabled
        self.bfloat16_enabled = config.bf16.enabled
        self.gas = config.gradient_accumulation_steps
        self.zero_stage = config.zero_optimization.stage
        self.ensemble, self.replicas, self.sync = False, 1, None

        master = {k: torch.empty(v.shape, dtype=torch.float32, device=self.device).copy_(v)
                  for k, v in params.items()}

        self.client_optimizer = optimizer is not None
        base_lr = get_base_lr(config.optimizer)
        self.lr_schedule = (lr_scheduler if lr_scheduler is not None
                            else build_schedule(config.scheduler, base_lr))
        if optimizer is not None:
            self.tx = optimizer
        else:
            if config.optimizer is None:
                raise ConfigError("Provide an optimizer: config 'optimizer' section or a "
                                  "client optimizer object")
            self.tx = build_optimizer(config.optimizer, self.lr_schedule,
                                      config.gradient_clipping)
        self.state = TrainState(master=master, opt_state=self.tx.init(master),
                                loss_scale=ls.init_loss_scale(config.fp16), step=0)
        self.training_dataloader = None

    # ==================================================================
    # the step
    # ==================================================================

    def _fwd_weights(self, requires_grad: bool = False) -> Dict[str, torch.Tensor]:
        """The forward copy: master cast to the training dtype (for f32, an
        alias of the master that autograd treats as its own leaf)."""
        out = {}
        for k, m in self.state.master.items():
            t = m.detach().to(self.train_dtype)
            out[k] = t.requires_grad_(True) if requires_grad else t
        return out

    def _scale(self) -> float:
        return self.state.loss_scale.scale if self.fp16_enabled else 1.0

    def _micro_grads(self, p16, micro, scale):
        """(f32 gradients of ``scale * loss`` w.r.t. the forward copy, loss).
        A leaf the loss does not reach gets a zero gradient."""
        names = list(p16)
        loss = self.loss_fn(p16, micro, None)
        scaled = loss * scale if scale != 1.0 else loss
        raw = torch.autograd.grad(scaled, [p16[n] for n in names], allow_unused=True)
        # contiguous f32: autograd may hand back a transposed layout (the tied
        # embedding's gradient through embed.T), which the AdamW kernel refuses
        grads = {n: (g.to(dtype=torch.float32, memory_format=torch.contiguous_format)
                     if g is not None
                     else torch.zeros(p16[n].shape, dtype=torch.float32, device=self.device))
                 for n, g in zip(names, raw)}
        return grads, loss.detach()

    def _accumulate(self, batch, scale):
        """Sum of the micro-batches' f32 gradients over the leading gas dim
        of ``batch``, and the mean loss."""
        p16 = self._fwd_weights(requires_grad=True)
        gas = next(iter(batch.values())).shape[0]
        acc, losses = None, []
        for i in range(gas):
            grads, loss = self._micro_grads(p16, {k: v[i] for k, v in batch.items()}, scale)
            losses.append(loss.float())
            if acc is None:
                acc = grads
            else:
                for n, g in grads.items():
                    acc[n].add_(g)
        return acc, (losses[0] if gas == 1 else torch.stack(losses).mean())

    def _train_step(self, batch):
        cfg = self.config
        st = self.state
        scale = self._scale()
        grads, loss = self._accumulate(batch, scale)
        denom = scale * self.gas
        if cfg.prescale_gradients and cfg.gradient_predivide_factor != 1.0:
            denom = denom * cfg.gradient_predivide_factor
        if denom != 1.0:
            for g in grads.values():
                g.div_(denom)
        overflow_t = (ls.check_overflow(grads) if self.fp16_enabled
                      else torch.zeros((), dtype=torch.bool, device=self.device))
        grad_norm_t = global_norm(grads)
        # the one host synchronisation of the step
        loss_v, norm_v, over_v = torch.stack(
            [loss.float(), grad_norm_t, overflow_t.float()]).tolist()
        overflow = bool(over_v)
        policy = cfg.resilience.nonfinite_policy
        nonfinite = (policy != "off" and not overflow
                     and not (math.isfinite(loss_v) and math.isfinite(norm_v)))
        bad = overflow or (nonfinite and policy == "skip")
        if not bad:
            self.tx.update(st.master, grads, st.opt_state, grad_norm=norm_v)
            st.step += 1
        st.loss_scale = ls.update(st.loss_scale, overflow, cfg.fp16)
        return loss, overflow, grad_norm_t, nonfinite

    # ==================================================================
    # batch plumbing
    # ==================================================================

    def _reshape_batch(self, batch, gas: Optional[int] = None) -> Dict[str, torch.Tensor]:
        """[B_global, ...] leaves -> [gas, micro, ...] tensors on the device."""
        gas = self.gas if gas is None else gas
        out = {}
        for k, x in batch.items():
            x = torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor) else x)
            b = x.shape[0]
            if b % gas:
                raise ConfigError(f"Batch dim {b} not divisible by "
                                  f"gradient_accumulation_steps {gas}")
            out[k] = x.to(self.device).reshape((gas, b // gas) + tuple(x.shape[1:]))
        return out

    @staticmethod
    def _take_micro(shaped):
        return {k: v[0] for k, v in shaped.items()}

    def train_batch(self, batch=None, data_iter=None):
        """One full optimizer step over a global batch (forward, backward
        and update). ``batch`` leaves are [train_batch_size, ...];
        alternatively the next item of ``data_iter``. Returns the loss (a
        0-dim f32 tensor on the device)."""
        if batch is None:
            if data_iter is None:
                raise ConfigError("train_batch needs a batch or a data_iter (an engine-owned "
                                  "dataloader from training_data is ROADMAP queue A, item 14)")
            batch = next(data_iter)
        loss, overflow, grad_norm, _ = self._train_step(self._reshape_batch(batch))
        self._last_grad_norm = grad_norm
        self._post_step(overflow)
        return loss

    def forward(self, batch, rng=None):
        """Loss of a micro-batch with the current forward weights; stashes
        the batch so ``backward()`` can compute its gradients."""
        micro = self._take_micro(self._reshape_batch(batch, gas=1))
        with torch.no_grad():
            loss = self.loss_fn(self._fwd_weights(), micro, rng)
        self._stashed_batch = micro
        return loss

    def backward(self, loss=None, batch=None):
        """Accumulate gradients for the stashed (or given) micro-batch.
        Gradients are computed here, not during ``forward``: ``loss`` is
        accepted for API parity."""
        if batch is not None:
            micro = self._take_micro(self._reshape_batch(batch, gas=1))
        elif self._stashed_batch is not None:
            micro = self._stashed_batch
        else:
            raise ConfigError("backward() without a prior forward() or an explicit batch")
        grads, loss_val = self._micro_grads(self._fwd_weights(requires_grad=True), micro,
                                            self._scale())
        if self._accum_grads is None:
            self._accum_grads = grads
        else:
            for n, g in grads.items():
                self._accum_grads[n].add_(g)
        self._accum_count += 1
        self.micro_steps += 1
        self._stashed_batch = None
        return loss_val

    def step(self):
        """Apply the accumulated gradients (divided by ``scale * number of
        backward() calls``); an fp16 overflow skips the update."""
        if self._accum_grads is None:
            raise ConfigError("step() with no accumulated gradients; call backward() first")
        st, grads = self.state, self._accum_grads
        denom = self._scale() * float(self._accum_count)
        if denom != 1.0:
            for g in grads.values():
                g.div_(denom)
        overflow = bool(ls.check_overflow(grads)) if self.fp16_enabled else False
        if not overflow:
            self.tx.update(st.master, grads, st.opt_state)
            st.step += 1
        st.loss_scale = ls.update(st.loss_scale, overflow, self.config.fp16)
        self._accum_grads = None
        self._accum_count = 0
        self._post_step(overflow)

    def eval_batch(self, batch, rng=None):
        micro = self._take_micro(self._reshape_batch(batch, gas=1))
        with torch.no_grad():
            return self.loss_fn(self._fwd_weights(), micro, rng)

    def _post_step(self, overflow: bool) -> None:
        self.global_steps += 1
        self.global_samples += self.config.train_batch_size
        if self.fp16_enabled and overflow:
            self.skipped_steps += 1
            logger.info(f"step {self.global_steps}: fp16 overflow, skipping update "
                        f"(loss scale -> {self.loss_scale()})")
        if self.global_steps % self.config.steps_per_print == 0:
            logger.info(f"step={self.global_steps} lr={self.get_lr():.3e} "
                        f"loss_scale={self.loss_scale()}")

    def train(self, mode: bool = True):
        """API parity: the functional model has no mode state."""
        return self

    def eval(self):
        return self

    def no_sync(self):
        """API parity: gradients are reduced once a step anyway."""
        return contextlib.nullcontext(self)

    # ==================================================================
    # introspection
    # ==================================================================

    def module_weights(self, consensus: bool = True) -> Dict[str, torch.Tensor]:
        """The current forward weights in the training dtype, by flattened
        name (copies: what an ``InferenceEngineV2`` of the port takes)."""
        return {k: m.detach().to(self.train_dtype, copy=True)
                for k, m in self.state.master.items()}

    def _leaf_name(self, name: str) -> str:
        names = list(self.state.master)
        hits = [n for n in names if n == name or n.endswith("." + name)]
        if not hits:
            raise KeyError(f"no parameter path matching {name!r}; available: {names[:20]}...")
        if len(hits) > 1:
            raise KeyError(f"ambiguous name {name!r}: {hits}")
        return hits[0]

    def get_full_fp32_param(self, name: str) -> np.ndarray:
        return self.state.master[self._leaf_name(name)].detach().cpu().numpy().copy()

    def set_full_fp32_param(self, name: str, value) -> None:
        leaf = self.state.master[self._leaf_name(name)]
        leaf.copy_(torch.as_tensor(np.asarray(value, np.float32)).reshape(leaf.shape))

    def _moment(self, name: str, state_key: str) -> torch.Tensor:
        key = _STATE_ALIASES.get(state_key, state_key)
        moments = getattr(self.state.opt_state, key, None)
        if not isinstance(moments, dict):
            raise KeyError(f"no optimizer state {state_key!r} for param {name!r}")
        return moments[self._leaf_name(name)]

    def get_full_optimizer_state(self, name: str, state_key: str) -> np.ndarray:
        return self._moment(name, state_key).detach().cpu().numpy().copy()

    def set_full_optimizer_state(self, name: str, state_key: str, value) -> None:
        leaf = self._moment(name, state_key)
        leaf.copy_(torch.as_tensor(np.asarray(value, np.float32)).reshape(leaf.shape))

    def get_full_grad(self, name: str) -> Optional[np.ndarray]:
        """The accumulated gradient of ``name`` on the forward / backward /
        step path; None when no gradients are pending."""
        if self._accum_grads is None:
            return None
        return self._accum_grads[self._leaf_name(name)].detach().cpu().numpy().copy()

    def get_lr(self) -> float:
        try:
            return float(self.lr_schedule(self.global_steps))
        except TypeError:
            return float(self.lr_schedule)

    def loss_scale(self) -> float:
        return float(self.state.loss_scale.scale)

    def get_global_grad_norm(self) -> Optional[float]:
        return None if self._last_grad_norm is None else float(self._last_grad_norm)

    @property
    def train_micro_batch_size_per_gpu(self) -> int:
        return self.config.train_micro_batch_size_per_gpu

    @property
    def gradient_accumulation_steps_(self) -> int:
        return self.gas

    def zero_optimization_stage(self) -> int:
        return self.zero_stage
