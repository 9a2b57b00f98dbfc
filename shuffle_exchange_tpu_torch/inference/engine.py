"""The parts of the JAX ``InferenceEngine`` that the paged engine builds on.

Counterpart of ``shuffle_exchange_tpu/inference/engine.py``: the cast of
the weights to the serving dtype and their move to the device, the
embedding at per-sequence positions, and the one transformer block every
cached path shares (``_layer_body`` / ``_block_tail`` / the dense
``_ffn``). The dense-cache v1 engine (``generate``) is a later slice
(ROADMAP queue A, item 8).

The JAX engine jit-compiles whole programs and scans the stacked layers;
here each layer is a Python loop iteration over views of the stacked
``[L, ...]`` weights, and PyTorch runs eagerly.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch
import torch.nn.functional as F

from ..models.transformer import Transformer, _norm, rope_table
from ..ops.dispatch import resolve_decode_kernel, resolve_device
from .config import InferenceConfig


def _bucket(n: int, minimum: int = 16) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


def _rope_rows(cos: torch.Tensor, sin: torch.Tensor, pos: torch.Tensor):
    """Per-sequence rope rows: pos [B] or [B, T] -> cos/sin [B, T, D/2].

    Only padding rows of a chunk (past ``nnew``) can sit at or beyond the
    table's end. JAX's ``take`` fills those rows with NaN, which lands on
    the scratch block; a CUDA index past the end would abort the process,
    so the index is clamped here. Rows that are used never reach the
    clamp (admission keeps them below ``max_seq_len``)."""
    if pos.dim() == 1:
        pos = pos[:, None]
    pos = pos.clamp(0, cos.shape[0] - 1)
    return cos[pos], sin[pos]


def _apply_rope_batched(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [B, T, H, D], cos/sin [B, T, D/2] (per-sequence positions):
    rotate-half, the rows cast to x's dtype before the multiply."""
    c = cos[:, :, None, :].to(x.dtype)
    s = sin[:, :, None, :].to(x.dtype)
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


AttnFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]


class InferenceEngine:
    """Weights cast to the serving dtype on the serving device, plus the
    layer body. ``params`` is a flattened-name state dict (``model.params()``
    or ``models.convert.params_from_numpy``). The engine runs on the card
    unless ``device="cpu"`` is given."""

    def __init__(self, model: Transformer, params: Dict[str, torch.Tensor],
                 config: Optional[InferenceConfig] = None, device=None):
        self.model = model
        self.config = config or InferenceConfig()
        self._mcfg = model.config
        self.device = resolve_device(device)
        resolve_decode_kernel(self.config.decode_kernel)   # raises on "pallas"
        self.update_params(params)

    def _prepare_params(self, params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Cast floating leaves to the serving dtype and move them to the
        device (no copy when they already match)."""
        dtype = self.config.torch_dtype()
        want = self.model.param_shapes()
        if set(params) != set(want):
            raise ValueError(f"params do not match the model: missing "
                             f"{sorted(set(want) - set(params))}, unexpected "
                             f"{sorted(set(params) - set(want))}")
        for k, v in params.items():
            if tuple(v.shape) != want[k]:
                raise ValueError(f"param {k}: shape {tuple(v.shape)} != model's {want[k]}")
        return {k: v.to(device=self.device, dtype=dtype if v.is_floating_point() else v.dtype)
                for k, v in params.items()}

    def update_params(self, params: Dict[str, torch.Tensor]) -> None:
        self.params = self._prepare_params(params)
        L = self._mcfg.n_layers
        stacked = {k[len("layers."):]: v for k, v in self.params.items()
                   if k.startswith("layers.")}
        # per-layer views of the stacked [L, ...] leaves (no copies)
        self._layer_weights: List[Dict[str, torch.Tensor]] = [
            {k: v[i] for k, v in stacked.items()} for i in range(L)]
        cfg = self._mcfg
        self._rope = rope_table(self.config.max_seq_len, cfg.rotary_dims,
                                cfg.rope_theta, device=self.device)

    # -- cached forward pieces ----------------------------------------

    def _embed_at(self, ids: torch.Tensor, pos: torch.Tensor):
        """ids [B, T], pos [B] start positions -> (x [B, T, D], positions [B, T])."""
        x = self.params["embed"][ids.long()]
        positions = pos.long()[:, None] + torch.arange(ids.shape[1], device=ids.device)[None, :]
        return x, positions

    def _layer_body(self, lw: Dict[str, torch.Tensor], h: torch.Tensor,
                    positions: torch.Tensor, attn_fn: AttnFn) -> torch.Tensor:
        """One block: norm -> QKV + RoPE -> ``attn_fn(q, k, v)`` (which also
        writes the new K/V into the pool) -> output projection, residual,
        FFN."""
        cfg = self._mcfg
        B, T = h.shape[:2]
        H, KV, Dh = cfg.n_heads, cfg.kv_heads, cfg.head_dim
        y = _norm(h, lw["ln1_w"], eps=cfg.norm_eps)
        q = (y @ lw["wq"]).reshape(B, T, H, Dh)
        k = (y @ lw["wk"]).reshape(B, T, KV, Dh)
        v = (y @ lw["wv"]).reshape(B, T, KV, Dh)
        cos, sin = self._rope
        pc, ps = _rope_rows(cos, sin, positions)
        q = _apply_rope_batched(q, pc, ps)
        k = _apply_rope_batched(k, pc, ps)
        attn = attn_fn(q, k, v)
        return self._block_tail(lw, h, attn)

    def _block_tail(self, lw: Dict[str, torch.Tensor], h: torch.Tensor,
                    attn: torch.Tensor) -> torch.Tensor:
        cfg = self._mcfg
        B, T = h.shape[:2]
        h = h + attn.reshape(B, T, cfg.n_heads * cfg.head_dim) @ lw["wo"]
        y2 = _norm(h, lw["ln2_w"], eps=cfg.norm_eps)
        return h + self._ffn(lw, y2)

    def _ffn(self, lw: Dict[str, torch.Tensor], y: torch.Tensor) -> torch.Tensor:
        """The dense SwiGLU FFN."""
        return (F.silu(y @ lw["w_gate"]) * (y @ lw["w_up"])) @ lw["w_down"]

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        return self.model.head(self.params, x)
