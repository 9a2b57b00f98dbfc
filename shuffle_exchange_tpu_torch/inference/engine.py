"""Inference engine v1 and the parts every engine shares (PyTorch port).

Counterpart of ``shuffle_exchange_tpu/inference/engine.py``: the cast of
the weights to the serving dtype and their move to the device, the
embedding at per-sequence positions, the one transformer block every
cached path shares (``_layer_body`` / ``_block_tail``, whose three
tails are the sequential block and the two parallel blocks of GPT-J and
GPT-NeoX / the dense ``_ffn``), the pieces of the fused decode path both JAX engines share (the
resolution of ``decode_kernel``, the rope rows of the fused QKV kernel,
the fused QKV for one-token rows in ``_layer_body`` and the fused MLP in
``_block_tail``), the per-row adapter deltas the paged engine's adapter
pool adds to the attention projections through the LoRA kernel
(``_lora_add``; the v1 engine refuses the ``adapters`` section, which the
JAX v1 engine ignores), the MoE FFN of an ``n_experts`` model
(``moe_layer`` over the grouped-GEMM kernel, with the routing-count tap
the paged engine reads), the weight-only quantization of ``quantize_weights``
(``_quantize``), and the dense-cache v1 engine: ``generate`` over a
``KVCache`` ``[L, B, max_seq_len, KV, Dh]``, whose prefill runs the flash
attention kernel and whose decode step runs the plain ``decode_attention``
(plain jnp in JAX as well), with the fused QKV (no pool) and MLP kernels
under ``decode_kernel: "pallas"``.

Under ``quantize_weights`` the layer matrices (``wq``, ``wk``, ``wv``,
``wo``, ``w_gate``, ``w_up``, ``w_down``: those the model has) are stored
as ``QuantizedMatrix`` leaves and every ``y @ w`` on them runs the
quantized matmul kernel; biases, norms, learned positions and ``embed_ln``
stay dense. Quantized attention weights leave the fused QKV kernel (as in
JAX, a static choice by the weights' type), and a quantized MLP takes the
fused quantized MLP kernel on one-token rows unless it has fc biases
(BLOOM, GPT-2): that one stays on the layer body, its biases added after
the quantized matmuls, as the JAX engines route it. An MoE model's expert
stacks are stored as int8 / fp8 ``[L, E, K, N]`` ``QuantizedMatrix``
leaves, which the grouped-GEMM kernel reads at storage width; int4 keeps
JAX's rounding emulation for them (dense leaves).

The JAX engine jit-compiles whole programs and scans the stacked layers;
here each layer is a Python loop iteration over views of the stacked
``[L, ...]`` weights, and PyTorch runs eagerly. The v1 engine decodes
greedily; sampling (ROADMAP queue A, item 3), tensor parallelism (item
12), checkpoint-backed serving (item 7), Hugging Face models (item 14) and
the full-sequence ``forward`` (item 4) raise, naming their item.
"""

from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..models.transformer import (Transformer, _norm, activation_fn, check_servable,
                                  decode_fusion_eligibility, rope_rows, rope_table)
from ..config.config_utils import ConfigError
from ..ops.dispatch import resolve_decode_kernel, resolve_device
from ..ops.flash_attention import flash_attention
from ..ops.fused_decode import fused_mlp, fused_qkv_rope, mlp_weights_fusable
from ..ops.lora_gemm import lora_delta
from ..ops.paged_attention import decode_attention
from ..ops.quant import quantize_dequantize
from ..ops.quant_matmul import QuantizedMatrix, quantize_weight
from ..utils.logging import logger, warning_once
from .config import InferenceConfig, sampling_knobs


class KVCache(NamedTuple):
    """The v1 engine's dense cache: k/v [L, B, max_seq_len, KV, Dh]."""

    k: torch.Tensor
    v: torch.Tensor


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


def _apply_rope_batched(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                        interleaved: bool = False) -> torch.Tensor:
    """x [B, T, H, D], cos/sin [B, T, rd/2] (per-sequence positions): JAX's
    ``_apply_rope_batched``, rotate-half or interleaved pairs over the first
    rd columns, the rest passed through, the rows cast to x's dtype before
    the multiply."""
    return rope_rows(x, cos[:, :, None, :], sin[:, :, None, :], interleaved)


AttnFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]
#: one layer's adapter operands: ({"a": {target: [S, din, R]}, "b": {target:
#: [S, R, dout]}}, slots [B] int32 on the device)
Lora = Tuple[Dict[str, Dict[str, torch.Tensor]], torch.Tensor]

#: the layer matrices ``quantize_weights`` stores quantized (the JAX
#: engine's storage names)
STORAGE_NAMES = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
#: the MoE expert stacks: int8 / fp8 storage, int4 rounding emulation
MOE_NAMES = ("moe_w_gate", "moe_w_up", "moe_w_down")


def qkv_quantized(lw) -> bool:
    """Whether a layer's attention weights are quantized: they then leave
    the fused QKV kernel for the quantized matmul (JAX
    ``_fused_qkv_args``)."""
    return any(isinstance(lw[n], QuantizedMatrix) for n in ("wq", "wk", "wv"))


class InferenceEngine:
    """Weights cast to the serving dtype on the serving device, the layer
    body, and the dense-cache ``generate``. ``params`` is a flattened-name
    state dict (``model.params()`` or ``models.convert.params_from_numpy``).
    The engine runs on the card unless ``device="cpu"`` is given."""

    #: whether the engine is the paged one, which serves the ``adapters``
    #: section and stores its KV in ``kv_cache_dtype``; the JAX v1 engine
    #: reads neither (its dense cache stays in the serving dtype), and the
    #: port refuses them there rather than ignore them
    paged = False

    def __init__(self, model: Transformer, params: Dict[str, torch.Tensor],
                 config: Optional[InferenceConfig] = None, device=None):
        # before any weight moves: a structure the engines do not serve must
        # never serve without it
        check_servable(model.config)
        self.model = model
        self.config = config or InferenceConfig()
        if self.config.adapters.enabled and not self.paged:
            raise ConfigError("adapters.enabled: multi-tenant LoRA adapters serve through the "
                              "paged InferenceEngineV2 (ContinuousBatchingScheduler, put(), "
                              "decode_loop()); the v1 engine does not apply them")
        if self.config.kv_cache_dtype != "bf16" and not self.paged:
            raise ConfigError(f"kv_cache_dtype={self.config.kv_cache_dtype!r}: int8/fp8 KV "
                              "storage serves through the paged InferenceEngineV2; the v1 "
                              "engine's dense cache stays in the serving dtype")
        self._mcfg = model.config
        self.device = resolve_device(device)
        self._resolve_decode_kernel()
        self.update_params(params)

    def _resolve_decode_kernel(self) -> None:
        """Pin the decode path for the engine's lifetime, as the JAX
        engine's ``_resolve_decode_kernel`` does: "auto" is the fused path
        on the card and the paged-kernel layer body on the CPU; "pallas" on
        a model with no fusable part of its decode layer raises. The paged
        engine always has one: its decode rows fuse the attention alone
        (split-K) when the QKV cannot fuse (GPT-J's interleaved RoPE), as
        JAX's ``_fused_attention`` says."""
        requested = self.config.decode_kernel
        self._decode_kernel = resolve_decode_kernel(requested, self.device)
        self._fuse_qkv = self._fuse_mlp = False
        if self._decode_kernel != "pallas":
            return
        elig = decode_fusion_eligibility(self._mcfg)
        self._fuse_qkv = elig["qkv"] is None
        self._fuse_mlp = elig["mlp"] is None
        if not (self._fuse_qkv or self._fuse_mlp or self.paged):
            reasons = "; ".join(r for r in elig.values() if r)
            if requested == "pallas":
                raise ValueError("decode_kernel='pallas' but no part of the decode layer "
                                 f"is fusable for this model: {reasons}")
            warning_once(f"decode_kernel=auto: model not fusable ({reasons}); using the "
                         "paged-kernel decode path")
            self._decode_kernel = "xla"

    def _prepare_params(self, params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Cast floating leaves to the serving dtype and move them to the
        device (no copy when they already match), then quantize when
        configured. ``QuantizedMatrix`` leaves (an already quantized tree)
        move as they are, their compute dtype set to the serving dtype."""
        dtype = self.config.torch_dtype()
        try:
            self.model.check_params(params)
        except ValueError as e:
            raise ValueError(f"params do not match the model: {e}") from None
        out = {}
        for k, v in params.items():
            if isinstance(v, QuantizedMatrix):
                out[k] = v.to(self.device, dtype)
            else:
                out[k] = v.to(device=self.device,
                              dtype=dtype if v.is_floating_point() else v.dtype)
        if self.config.quantize_weights:
            out = self._quantize(out)
        return out

    def _quantize(self, params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Weight-only quantization (JAX ``_quantize``): the layer matrices
        become ``QuantizedMatrix`` storage at a group of
        ``min(quant_group_size, 256)`` rows, quantized one layer at a time
        on the engine's device; the unembedding is rounded through int8 at
        flat groups of ``quant_group_size`` and stays dense. A matrix no
        group size of 32 or more divides takes the rounding instead. MoE
        expert stacks ``[L, E, K, N]`` join the storage for int8 and fp8
        and take the rounding for int4, as in JAX."""
        cfg = self.config
        gs = cfg.quant_group_size
        dtype = cfg.torch_dtype()
        storage, qdq = STORAGE_NAMES, ("unembed",)
        if cfg.quant_bits in (8, "fp8"):
            storage = storage + MOE_NAMES
        else:
            qdq = qdq + MOE_NAMES
        out = {}
        for name, v in params.items():
            leaf = name.split(".")[-1]
            if isinstance(v, QuantizedMatrix):
                out[name] = v
            elif name.startswith("layers.") and leaf in storage:
                try:
                    out[name] = quantize_weight(v, group_size=min(gs, 256), dtype=dtype,
                                                bits=cfg.quant_bits)
                except ValueError as e:
                    # one static warning for the whole walk, the detail at
                    # debug level (the JAX engine's dedup)
                    warning_once("quantize_weight rejected some weights; using "
                                 "quantize-dequantize rounding for them (per-weight detail "
                                 "at debug level)")
                    logger.debug(f"quantize_weight({name}): {e}; qdq rounding instead")
                    out[name] = quantize_dequantize(v, group_size=gs).to(v.dtype)
            elif leaf in qdq:
                out[name] = quantize_dequantize(v, group_size=gs).to(v.dtype)
            else:
                out[name] = v
        return out

    def update_params(self, params: Dict[str, torch.Tensor]) -> None:
        self.params = self._prepare_params(params)
        L = self._mcfg.n_layers
        stacked = {k[len("layers."):]: v for k, v in self.params.items()
                   if k.startswith("layers.")}
        # per-layer views of the stacked [L, ...] leaves (no copies)
        self._layer_weights: List[Dict[str, torch.Tensor]] = [
            {k: v[i] for k, v in stacked.items()} for i in range(L)]
        cfg = self._mcfg
        self._rope = (rope_table(self.config.max_seq_len, cfg.rotary_dims, cfg.rope_theta,
                                 device=self.device) if cfg.position == "rope" else None)
        # the f32 [H] ALiBi slopes on the device, or None (JAX ``self._alibi``)
        self._alibi = self.model.alibi(self.device)

    # -- cached forward pieces ----------------------------------------

    def _embed_at(self, ids: torch.Tensor, pos: torch.Tensor):
        """ids [B, T], pos [B] start positions -> (x [B, T, D], positions [B, T]).
        As the JAX engines: ``embed_ln`` on the token embedding, then the
        learned positions (``pos_offset`` added) read with the index clipped
        to the table, so a position past ``max_seq_len`` reads the last row.
        (The JAX training ``embed`` applies ``embed_ln`` after the positions;
        no decoder family has both, ROADMAP queue C.)"""
        cfg = self._mcfg
        x = self.params["embed"][ids.long()]
        if cfg.embed_ln:   # BLOOM's word_embeddings_layernorm
            x = _norm(x, self.params["embed_ln_w"], self.params["embed_ln_b"], cfg.norm,
                      eps=cfg.norm_eps)
        positions = pos.long()[:, None] + torch.arange(ids.shape[1], device=ids.device)[None, :]
        if cfg.position == "learned":
            table = self.params["pos_embed"]
            idx = (positions + cfg.pos_offset).clamp(0, table.shape[0] - 1)
            x = x + table[idx].to(x.dtype)
        return x, positions

    @staticmethod
    def _lora_add(base: torch.Tensor, x: torch.Tensor, lora: Lora,
                  target: str) -> torch.Tensor:
        """``base + (x @ A[slot[row]]) @ B[slot[row]]``: the per-row adapter
        delta through the LoRA kernel, added as JAX adds it (the delta cast
        to base's dtype, then the add: two roundings in bf16). A target the
        pool does not adapt adds nothing."""
        pool, slots = lora
        if target not in pool["a"]:
            return base
        delta = lora_delta(x, pool["a"][target], pool["b"][target], slots)
        return base + delta.to(base.dtype)

    def _layer_body(self, lw: Dict[str, torch.Tensor], h: torch.Tensor,
                    positions: torch.Tensor, attn_fn: AttnFn,
                    lora: Optional[Lora] = None) -> torch.Tensor:
        """One block: norm -> QKV + RoPE -> ``attn_fn(q, k, v)`` (which also
        writes the new K/V into the pool) -> output projection, residual,
        FFN. With ``lora`` (the layer's adapter operands) each adapted
        projection gets its per-row delta after the base matmul and before
        the reshape and RoPE, and the fused QKV is skipped, as in JAX."""
        cfg = self._mcfg
        B, T = h.shape[:2]
        H, KV, Dh = cfg.n_heads, cfg.kv_heads, cfg.head_dim
        y = _norm(h, lw["ln1_w"], lw.get("ln1_b"), cfg.norm, eps=cfg.norm_eps)
        qkv = None if lora is not None else self._maybe_fused_qkv(lw, y, positions)
        if qkv is None:
            q = y @ lw["wq"]
            k = y @ lw["wk"]
            v = y @ lw["wv"]
            if lora is not None:
                q = self._lora_add(q, y, lora, "wq")
                k = self._lora_add(k, y, lora, "wk")
                v = self._lora_add(v, y, lora, "wv")
            q = q.reshape(B, T, H, Dh)
            k = k.reshape(B, T, KV, Dh)
            v = v.reshape(B, T, KV, Dh)
            if cfg.attn_qkv_bias:   # a bf16 bias after the bf16 product, as JAX's body
                q = q + lw["b_q"].to(y.dtype).reshape(H, Dh)
                k = k + lw["b_k"].to(y.dtype).reshape(KV, Dh)
                v = v + lw["b_v"].to(y.dtype).reshape(KV, Dh)
            if self._rope is not None:
                cos, sin = self._rope
                pc, ps = _rope_rows(cos, sin, positions)
                q = _apply_rope_batched(q, pc, ps, cfg.rope_interleaved)
                k = _apply_rope_batched(k, pc, ps, cfg.rope_interleaved)
        else:
            q, k, v = qkv
        attn = attn_fn(q, k, v)
        return self._block_tail(lw, h, y, attn, lora=lora)

    def _block_tail(self, lw: Dict[str, torch.Tensor], h: torch.Tensor, y: torch.Tensor,
                    attn: torch.Tensor, lora: Optional[Lora] = None) -> torch.Tensor:
        """Output projection (with the ``wo`` adapter delta under ``lora``),
        residual(s) and FFN, shared by the plain and the fused layer bodies
        (the FFN fuses for one-token rows); ``y`` is the layer's ln1 output.
        The three tails of JAX's ``_block_tail``: a parallel block with a
        shared layernorm adds ``ffn(y)`` (fused without a norm), one with
        two layernorms ``ffn(ln2(h))`` of the block's input h, both beside
        the attention; a sequential block ``ffn(ln2(h + attn))``."""
        cfg = self._mcfg
        B, T = h.shape[:2]
        attn_flat = attn.reshape(B, T, cfg.n_heads * cfg.head_dim)
        attn_out = attn_flat @ lw["wo"]
        if lora is not None:
            attn_out = self._lora_add(attn_out, attn_flat, lora, "wo")
        if cfg.attn_out_bias:
            attn_out = attn_out + lw["b_o"].to(attn_out.dtype)
        if cfg.parallel_block:
            resid = h + attn_out
            if cfg.parallel_shared_ln:
                out = self._maybe_fused_ffn(lw, resid, y, apply_norm=False)
                return out if out is not None else resid + self._ffn(lw, y)
            out = self._maybe_fused_ffn(lw, resid, h, apply_norm=True)
            if out is not None:
                return out
            y2 = _norm(h, lw["ln2_w"], lw.get("ln2_b"), cfg.norm, eps=cfg.norm_eps)
            return resid + self._ffn(lw, y2)
        h = h + attn_out
        out = self._maybe_fused_ffn(lw, h, h, apply_norm=True)
        if out is not None:
            return out
        y2 = _norm(h, lw["ln2_w"], lw.get("ln2_b"), cfg.norm, eps=cfg.norm_eps)
        return h + self._ffn(lw, y2)

    def _fused_qkv_args(self, lw: Dict[str, torch.Tensor], positions: torch.Tensor):
        """What the fused QKV kernel takes beside the weights (JAX
        ``_fused_qkv_args``): the f32 rope rows [B, rd/2] at each one-token
        row's position (rd = ``rotary_dims``, the table's width; None, None
        without RoPE) and the q/k/v bias keywords (empty without
        biases)."""
        cosr = sinr = None
        if self._rope is not None:
            cos, sin = self._rope
            pc, ps = _rope_rows(cos, sin, positions)
            cosr, sinr = pc[:, 0].contiguous(), ps[:, 0].contiguous()
        bias = {}
        if self._mcfg.attn_qkv_bias:
            bias = {"bq": lw["b_q"], "bk": lw["b_k"], "bv": lw["b_v"]}
        return cosr, sinr, bias

    def _maybe_fused_qkv(self, lw: Dict[str, torch.Tensor], y: torch.Tensor,
                         positions: torch.Tensor):
        """q/k/v [B, 1, n, Dh] through the fused QKV kernel, without a pool,
        for one-token rows when the decode path is fused; None otherwise.
        (The paged engine's fused decode layer appends to its pool in the
        same kernel instead; this form serves the other one-token rows, as
        JAX's shared ``_layer_body`` does.)"""
        if not (self._fuse_qkv and y.shape[1] == 1) or qkv_quantized(lw):
            return None
        cfg = self._mcfg
        cosr, sinr, bias = self._fused_qkv_args(lw, positions)
        q, k, v = fused_qkv_rope(y[:, 0], lw["wq"], lw["wk"], lw["wv"], cosr, sinr,
                                 n_heads=cfg.n_heads, kv_heads=cfg.kv_heads, **bias)
        return q[:, None], k[:, None], v[:, None]

    def _maybe_fused_ffn(self, lw: Dict[str, torch.Tensor], resid: torch.Tensor,
                         y_src: torch.Tensor, apply_norm: bool) -> Optional[torch.Tensor]:
        """``resid + FFN(ln2(y_src))`` (``apply_norm=False``: ``resid +
        FFN(y_src)``, the shared layernorm's y) through the fused MLP kernel
        (bf16 weights: RMSNorm, layernorm or no norm, gated or plain, with
        the fc biases) or the fused quantized MLP kernel (the same forms
        without fc biases) for one-token rows when the decode path is
        fused; None otherwise, and for MLP weights the fused kernels cannot
        take: mixed dense and quantized, or quantized with fc biases
        (BLOOM, GPT-2, GPT-J), which stay on the layer body's quantized
        matmuls. As in JAX, a static choice by the weights' structure."""
        if not (self._fuse_mlp and resid.shape[1] == 1):
            return None
        cfg = self._mcfg
        gated = cfg.activation == "swiglu"
        wg = lw["w_gate"] if gated else None
        reason = mlp_weights_fusable(lw["w_up"], lw["w_down"], wg)
        has_bias = cfg.mlp_bias and not gated
        if reason is None and has_bias and isinstance(lw["w_up"], QuantizedMatrix):
            reason = "quantized MLP weights with fc biases"
        if reason is not None:
            warning_once(f"fused decode: MLP stays on the layer body ({reason})")
            return None
        kw = {"b_up": lw["b_up"], "b_down": lw["b_down"]} if has_bias else {}
        # without the norm its weights are unused; ln1_w rides along as a
        # shape-correct stand-in (JAX's dummy)
        ln_w = lw["ln2_w"] if apply_norm else lw["ln1_w"]
        ln_b = lw.get("ln2_b") if apply_norm else None
        out = fused_mlp(resid[:, 0], y_src[:, 0], ln_w, lw["w_up"], lw["w_down"],
                        wg, eps=cfg.norm_eps, ln_b=ln_b, norm=cfg.norm,
                        activation=cfg.activation, apply_norm=apply_norm, **kw)
        return out[:, None]

    def _ffn(self, lw: Dict[str, torch.Tensor], y: torch.Tensor) -> torch.Tensor:
        """The dense FFN (SwiGLU, or the plain MLP of the gelu family with its
        fc biases), or the MoE FFN (JAX ``_ffn``): the model's
        ``moe_ffn`` with the impl and capacity factor the paged engine's
        serving config sets (``_moe_impl_override`` / ``_moe_cf_override``;
        the v1 engine has none and takes the model config's), resolved as
        under JAX's scanned stack, plus the shared expert. With a routing tap armed
        (``_moe_tap``, the paged engine's programs) each call appends its
        expert counts [E] int32 and dropped assignments (f32), on the
        device."""
        cfg = self._mcfg
        if cfg.n_experts == 0:
            if cfg.activation == "swiglu":
                return (F.silu(y @ lw["w_gate"]) * (y @ lw["w_up"])) @ lw["w_down"]
            act = activation_fn(cfg.activation)
            if not cfg.mlp_bias:
                return act(y @ lw["w_up"]) @ lw["w_down"]
            return (act(y @ lw["w_up"] + lw["b_up"].to(y.dtype)) @ lw["w_down"]
                    + lw["b_down"].to(y.dtype))
        out, res = self.model.moe_ffn(lw, y, impl=getattr(self, "_moe_impl_override", None),
                                      capacity_factor=getattr(self, "_moe_cf_override", None))
        tap = getattr(self, "_moe_tap", None)
        if tap is not None:
            # counts are post-drop (capacity) or pre-drop with drop_fraction
            # 0 (ragged); drop_fraction = 1 - kept / (S k) makes the product
            # the dropped assignments
            rows = y.numel() // y.shape[-1]
            tap.append((res.metadata["expert_counts"].int(),
                        res.metadata["drop_fraction"] * (rows * cfg.moe_top_k)))
        return out

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        return self.model.head(self.params, x)

    # -- the dense-cache v1 engine ----------------------------------------

    def _new_cache(self, batch: int) -> KVCache:
        cfg, m = self.config, self._mcfg
        shape = (m.n_layers, batch, cfg.max_seq_len, m.kv_heads, m.head_dim)
        dtype = cfg.torch_dtype()
        return KVCache(torch.zeros(shape, dtype=dtype, device=self.device),
                       torch.zeros(shape, dtype=dtype, device=self.device))

    @torch.no_grad()
    def _prefill(self, ids: torch.Tensor, prompt_len: torch.Tensor,
                 cache: KVCache) -> torch.Tensor:
        """Right-padded prompts ids [B, Tpad]: write every layer's K/V into
        ``cache[:, :, :Tpad]`` in place, attend through the flash kernel
        (causal) and return the hidden rows at ``prompt_len - 1`` [B, 1, D]."""
        B, Tpad = ids.shape
        x, positions = self._embed_at(ids, torch.zeros(B, dtype=torch.int32,
                                                       device=ids.device))
        for i, lw in enumerate(self._layer_weights):
            def attn_fn(q, k, v, i=i):
                cache.k[i, :, :Tpad] = k.to(cache.k.dtype)
                cache.v[i, :, :Tpad] = v.to(cache.v.dtype)
                return flash_attention(q, k, v, causal=True, alibi_slopes=self._alibi)

            x = self._layer_body(lw, x, positions, attn_fn)
        idx = (prompt_len.long() - 1)[:, None, None].expand(-1, 1, x.shape[-1])
        return torch.gather(x, 1, idx)

    @torch.no_grad()
    def _decode_step(self, cache: KVCache, tok: torch.Tensor,
                     pos: torch.Tensor) -> torch.Tensor:
        """One token per sequence at ``pos`` [B] (the cache fill level):
        write its K/V at ``pos`` in place and attend over ``pos + 1`` slots.
        Returns f32 logits [B, V]."""
        B = tok.shape[0]
        x, _ = self._embed_at(tok[:, None], pos)
        rows = torch.arange(B, device=tok.device)
        pos_l = pos.long()
        for i, lw in enumerate(self._layer_weights):
            ck, cv = cache.k[i], cache.v[i]

            def attn_fn(q, k, v, ck=ck, cv=cv):
                ck[rows, pos_l] = k[:, 0].to(ck.dtype)
                cv[rows, pos_l] = v[:, 0].to(cv.dtype)
                return decode_attention(q, ck, cv, pos + 1, alibi_slopes=self._alibi)

            x = self._layer_body(lw, x, pos, attn_fn)
        return self._head(x)[:, 0]

    def forward(self, input_ids):
        """Full-sequence logits (JAX ``model.apply``): not ported yet."""
        raise NotImplementedError("InferenceEngine.forward (full-sequence logits through "
                                  "the training forward) is not in the PyTorch port yet: "
                                  "ROADMAP queue A, item 4")

    @torch.no_grad()
    def generate(self, input_ids, prompt_lengths=None, max_new_tokens: Optional[int] = None,
                 temperature: Optional[float] = None, top_k: Optional[int] = None,
                 top_p: Optional[float] = None, eos_token_id: Optional[int] = None,
                 rng=None) -> np.ndarray:
        """Greedy autoregressive generation. input_ids [B, T] right-padded,
        with per-sequence ``prompt_lengths`` (default: the full width).
        Returns int32 [B, max_new_tokens]; positions after a sequence's EOS
        hold ``pad_token_id``. The tokens stay on the device until the
        end: one copy to the host."""
        sampled = sampling_knobs(temperature, top_k, top_p)
        if sampled or rng is not None:
            raise NotImplementedError(
                f"sampled generate ({sampled or 'rng'}) is not in the PyTorch port yet; it "
                "decodes greedily: ROADMAP queue A, item 3")
        cfg = self.config
        ids = np.asarray(input_ids, dtype=np.int32)
        if ids.ndim != 2:
            raise ValueError(f"input_ids must be [B, T], got shape {ids.shape}")
        B, T = ids.shape
        if B > cfg.max_batch_size:
            raise ValueError(f"batch {B} exceeds max_batch_size {cfg.max_batch_size} "
                             "(raise it in the inference config)")
        lens = (np.full((B,), T, np.int32) if prompt_lengths is None
                else np.asarray(prompt_lengths, np.int32))
        if lens.shape != (B,) or (lens < 1).any() or (lens > T).any():
            raise ValueError(f"prompt_lengths must be [{B}] values in [1, {T}], got {lens}")
        max_new = int(max_new_tokens if max_new_tokens is not None else cfg.max_new_tokens)
        if max_new < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {max_new}")
        eos = cfg.eos_token_id if eos_token_id is None else int(eos_token_id)
        S = cfg.max_seq_len
        Tpad = min(_bucket(T), S)
        if T + max_new > S:
            raise ValueError(f"prompt {T} + max_new {max_new} exceeds max_seq_len {S}")
        if Tpad > T:
            ids = np.pad(ids, ((0, 0), (0, Tpad - T)))
        dev = self.device
        ids_t, pos = torch.from_numpy(ids).to(dev), torch.from_numpy(lens).to(dev)
        cache = self._new_cache(B)
        tok = self._head(self._prefill(ids_t, pos, cache))[:, 0].argmax(-1).to(torch.int32)
        done = tok == eos if eos >= 0 else torch.zeros(B, dtype=torch.bool, device=dev)
        out = [tok]
        for _ in range(max_new - 1):
            nxt = self._decode_step(cache, tok, pos).argmax(-1).to(torch.int32)
            nxt = torch.where(done, torch.full_like(nxt, cfg.pad_token_id), nxt)
            if eos >= 0:
                done = done | (nxt == eos)
            pos = torch.clamp(pos + 1, max=S - 1)
            out.append(nxt)
            tok = nxt
        return torch.stack(out, dim=1).cpu().numpy()


def init_inference(model=None, params=None, config=None, checkpoint: Optional[str] = None,
                   device=None, **kwargs) -> InferenceEngine:
    """Build a v1 ``InferenceEngine`` (JAX ``init_inference``) from the
    port's model object and its parameters (``model.params()`` or
    ``models.convert.params_from_numpy``). ``config`` is a dict in the JAX
    package's inference-config format or an ``InferenceConfig``; extra
    keyword arguments join the dict. The engine runs on the card unless
    ``device="cpu"`` is given."""
    if not isinstance(config, InferenceConfig):
        cfg_dict = dict(config or {})
        cfg_dict.update(kwargs)
        config = InferenceConfig.from_dict(cfg_dict)
    elif kwargs:
        raise ValueError(f"init_inference: keyword settings {sorted(kwargs)} with an "
                         "InferenceConfig object; put them in the config")
    if isinstance(model, str) or (model is not None and not isinstance(model, Transformer)):
        raise NotImplementedError("init_inference from a Hugging Face path or model object is "
                                  "not in the PyTorch port yet (ROADMAP queue A, item 14); "
                                  "pass the port's Transformer and its params")
    if checkpoint is not None:
        raise NotImplementedError("init_inference(checkpoint=...): serving from a training "
                                  "checkpoint is not in the PyTorch port yet (ROADMAP queue A, "
                                  "item 7)")
    if model is None or params is None:
        raise ValueError("init_inference requires the model and its params")
    return InferenceEngine(model, params, config, device=device)

