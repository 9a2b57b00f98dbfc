"""Decoder-only transformer, in PyTorch: the Llama family, GPT-2, BLOOM,
GPT-J and GPT-NeoX (Pythia).

Counterpart of ``shuffle_exchange_tpu/models/transformer.py`` cut to what
the serving and training slices run. Training and serving take the same
structures: RMSNorm or layernorm, RoPE (rotate-half or GPT-J's interleaved
pairs, over all of head_dim or its first ``rotary_dim`` columns), learned
positions or ALiBi, grouped-query attention with optional q/k/v/out
biases, SwiGLU, a plain MLP (gelu, gelu_new, gelu_pytorch_tanh, relu or
silu, with or without fc biases) or a Mixtral-style MoE FFN (``n_experts``
> 0: top-k routed experts in every layer, an optional shared expert),
sequential or parallel blocks (GPT-J's and Falcon's one shared layernorm,
GPT-NeoX's two), ``embed_ln`` and a tied or untied unembedding with an
optional bias (GPT-J's); serving adds weight quantization and adapters on
every one of them. The pieces the inference engines call (``embed``,
``head``) and the training forward (``layer_apply``, ``stack_apply``,
``chunked_loss``, ``loss``) are functional like the JAX ones: they take
the parameters as a flattened-name dict, so the training engine
differentiates with respect to its own forward copy of the weights. The
parameters keep the JAX package's leaf names and layouts — per-layer weights stacked on a
leading ``[L, ...]`` dim, projections stored ``[in, out]`` — so a JAX
parameter tree moves over by name (``models/convert.py``) and a test can
compare the two packages leaf by leaf.

Any other structure raises ``NotImplementedError`` naming the ROADMAP item
that ports it. The MoE training forward runs every layer's experts
through ``moe_layer`` (differentiable: the grouped GEMM's backward is its
own pair of kernels) and adds ``aux_loss_coef`` times the summed aux loss
to the cross entropy, as the JAX ``loss`` does.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.dispatch import resolve_device
from ..ops.fused_decode import FUSABLE_ACTIVATIONS


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """The JAX config's fields for the structures this slice can express
    (same names and defaults); ``check_supported`` refuses the rest."""

    vocab_size: int = 32000
    d_model: int = 512
    n_layers: int = 4
    n_heads: int = 8
    n_kv_heads: Optional[int] = None          # None = MHA; < n_heads = GQA
    d_ff: Optional[int] = None                 # default 8/3*d for swiglu
    max_seq_len: int = 2048
    activation: str = "gelu"
    norm: str = "layernorm"
    position: str = "learned"
    rope_theta: float = 500000.0
    tie_embeddings: bool = True
    norm_eps: float = 1e-5
    attn_qkv_bias: bool = False
    attn_out_bias: bool = False
    pos_offset: int = 0                        # OPT offsets learned positions by 2
    parallel_block: bool = False               # h + attn(y1) + mlp(y2) (GPT-J/NeoX/Falcon)
    parallel_shared_ln: bool = False           # y2 = y1, no ln2 (GPT-J, Falcon-7B)
    rotary_dim: int = 0                        # rope on the first rotary_dim dims (0 = all)
    rope_interleaved: bool = False             # GPT-J rotate-every-two pairs
    embed_ln: bool = False
    alibi_slope_scale: float = 1.0             # falcon scales alibi by 1/sqrt(Dh)
    mlp_bias: bool = True                      # plain-MLP fc biases (False: Falcon)
    unembed_bias: bool = False                 # GPT-J lm_head bias (untied only)
    post_ln: bool = False
    local_attention_window: int = 0
    attention_pattern: Tuple[str, ...] = ()
    # MoE (Mixtral-style when n_experts > 0): top-k routing over n_experts
    # stacked expert FFNs in every layer
    n_experts: int = 0                         # 0 = dense
    moe_top_k: int = 2
    capacity_factor: float = 1.25
    moe_impl: str = "auto"   # auto | capacity (index dispatch) | capacity_einsum | ragged
    moe_shared_expert_ff: int = 0              # Qwen2-MoE shared expert (0 = none)
    moe_norm_topk: bool = True                 # renormalize the top-k weights (Mixtral)
    # per-layer MoE flags (Megatron --expert-interval); () = every layer is
    # MoE. Interleaved dense layers are not ported (ROADMAP queue A, item 9)
    moe_layer_pattern: Tuple[bool, ...] = ()
    causal: bool = True                        # False = bidirectional (BERT)
    remat: bool = False                        # recompute each layer in backward
    remat_policy: str = "dots_saveable"        # see _remat_policy
    aux_loss_coef: float = 0.01                # weight of the MoE aux loss (0 for dense)
    # Chunked vocab cross entropy: 0 = full logits; n > 0 = n tokens per
    # chunk; -1 = auto (chunk when the f32 logits would pass 256 MB)
    loss_chunk: int = -1

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads or self.n_heads

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def rotary_dims(self) -> int:
        return self.rotary_dim or self.head_dim

    @property
    def ff_dim(self) -> int:
        if self.d_ff:
            return self.d_ff
        if self.activation == "swiglu":
            d = int(8 * self.d_model / 3)
            return 256 * ((d + 255) // 256)
        return 4 * self.d_model


def gpt2_small() -> TransformerConfig:
    """GPT-2 125M (``bench.py:2194 _config1``'s model)."""
    return TransformerConfig(vocab_size=50257, d_model=768, n_layers=12, n_heads=12,
                             max_seq_len=1024, activation="gelu", norm="layernorm",
                             position="learned", attn_qkv_bias=True, attn_out_bias=True)


def gpt2_large() -> TransformerConfig:
    return TransformerConfig(vocab_size=50257, d_model=1280, n_layers=36, n_heads=20,
                             max_seq_len=1024, activation="gelu", norm="layernorm",
                             position="learned", attn_qkv_bias=True, attn_out_bias=True)


def llama3_8b() -> TransformerConfig:
    return TransformerConfig(vocab_size=128256, d_model=4096, n_layers=32, n_heads=32,
                             n_kv_heads=8, d_ff=14336, max_seq_len=8192,
                             activation="swiglu", norm="rmsnorm", position="rope",
                             rope_theta=500000.0, tie_embeddings=False)


def mixtral_8x7b() -> TransformerConfig:
    return TransformerConfig(vocab_size=32000, d_model=4096, n_layers=32, n_heads=32,
                             n_kv_heads=8, d_ff=14336, max_seq_len=8192, activation="swiglu",
                             norm="rmsnorm", position="rope", rope_theta=1e6,
                             tie_embeddings=False, n_experts=8, moe_top_k=2)


def tiny(vocab=256, d=64, layers=2, heads=4, seq=64, **kw) -> TransformerConfig:
    return TransformerConfig(vocab_size=vocab, d_model=d, n_layers=layers, n_heads=heads,
                             max_seq_len=seq, **kw)


def tiny_moe(vocab=256, d=64, layers=2, heads=4, seq=64, experts=4, **kw) -> TransformerConfig:
    return TransformerConfig(vocab_size=vocab, d_model=d, n_layers=layers, n_heads=heads,
                             max_seq_len=seq, activation="swiglu", norm="rmsnorm",
                             position="rope", n_experts=experts, moe_top_k=2, **kw)


def _llama(vocab, d, layers, heads, kv, d_ff=None, tie=True) -> TransformerConfig:
    return TransformerConfig(vocab_size=vocab, d_model=d, n_layers=layers, n_heads=heads,
                             n_kv_heads=kv, d_ff=d_ff, max_seq_len=8192, activation="swiglu",
                             norm="rmsnorm", position="rope", rope_theta=500000.0,
                             tie_embeddings=tie)


def llama_ladder():
    """The training ladder, largest first: Llama-3-8B and scaled entries
    that keep its head geometry (head_dim 128, GQA group 4) where they can,
    so the attention kernels see the 8B shapes."""
    return [
        ("llama3-8b", llama3_8b()),
        ("llama3-3b-style", _llama(128256, 3072, 28, 24, 8, d_ff=8192, tie=False)),
        ("llama3-1b-style", _llama(128256, 2048, 16, 16, 4, d_ff=8192)),
        ("llama-750m-style", _llama(32768, 1536, 16, 12, 3)),
        ("llama-350m-style", _llama(32768, 1024, 16, 8, 2)),
    ]


def param_count(cfg: TransformerConfig) -> int:
    """Weights of a config, MoE included. The norm biases count only under
    layernorm (RMSNorm does not use them, though the JAX init draws them)."""
    d, ff = cfg.d_model, cfg.ff_dim
    q_dim, kv_dim = cfg.n_heads * cfg.head_dim, cfg.kv_heads * cfg.head_dim
    attn = d * q_dim + 2 * d * kv_dim + q_dim * d
    attn += (q_dim + 2 * kv_dim if cfg.attn_qkv_bias else 0) + (d if cfg.attn_out_bias else 0)
    if cfg.activation == "swiglu":
        mlp = 3 * d * ff
    else:
        mlp = 2 * d * ff + (ff + d if cfg.mlp_bias else 0)
    if cfg.n_experts > 0:
        Fs = cfg.moe_shared_expert_ff
        mlp = cfg.n_experts * mlp + d * cfg.n_experts + (3 * d * Fs + d if Fs else 0)
    norm = 2 if cfg.norm == "layernorm" else 1    # weight (and bias) of a norm
    shared_ln = cfg.parallel_block and cfg.parallel_shared_ln   # no ln2
    per_layer = attn + mlp + (1 if shared_ln else 2) * norm * d
    embed = cfg.vocab_size * d * (1 if cfg.tie_embeddings else 2)
    if cfg.unembed_bias and not cfg.tie_embeddings:
        embed += cfg.vocab_size
    if cfg.position == "learned":
        embed += (cfg.max_seq_len + cfg.pos_offset) * d
    if cfg.embed_ln:
        embed += 2 * d
    return cfg.n_layers * per_layer + embed + norm * d


def pick_ladder_config(device_memory_bytes: int):
    """(name, config): the largest ladder entry whose 14 bytes a parameter
    (bf16 forward copy, f32 master and two Adam moments) fit 55% of the
    device's memory; activations under remat take the rest."""
    budget = 0.55 * device_memory_bytes
    ladder = llama_ladder()
    for name, cfg in ladder:
        if 14 * param_count(cfg) <= budget:
            return name, cfg
    return ladder[-1]


_ACTIVATIONS = ("swiglu", "gelu", "gelu_new", "gelu_pytorch_tanh", "relu", "silu")


def _refusals(cfg: TransformerConfig):
    """(refused, what) for every structure neither the training forward
    nor the serving engines take."""
    later = "ROADMAP queue A, item 4"
    return [
        (cfg.norm not in ("rmsnorm", "layernorm"), f"norm={cfg.norm!r} ({later})"),
        (cfg.activation not in _ACTIVATIONS, f"activation={cfg.activation!r} ({later})"),
        (cfg.position not in ("rope", "learned", "alibi"), f"position={cfg.position!r} ({later})"),
        (cfg.position == "rope" and (cfg.rotary_dims % 2 or cfg.rotary_dims > cfg.head_dim),
         f"rotary_dim={cfg.rotary_dim} must be even and at most head_dim={cfg.head_dim}"),
        (cfg.post_ln, f"post_ln ({later})"),
        (cfg.n_experts > 0 and bool(cfg.moe_layer_pattern) and not all(cfg.moe_layer_pattern),
         "interleaved dense and MoE layers (moe_layer_pattern; ROADMAP queue A, item 9)"),
        (cfg.local_attention_window > 0 or "local" in cfg.attention_pattern,
         f"local attention ({later})"),
        (not cfg.causal, f"bidirectional (encoder) attention ({later})"),
        (cfg.n_heads % cfg.kv_heads != 0, "n_heads must be a multiple of n_kv_heads"),
    ]


def _raise_first(checks) -> None:
    for bad, what in checks:
        if bad:
            raise NotImplementedError(f"not supported by the PyTorch port yet: {what}")


def check_supported(cfg: TransformerConfig) -> None:
    """Raise for every structure the port's training forward does not take:
    the same as ``check_servable`` (``post_ln``, local and bidirectional
    attention stay refused, ROADMAP queue A, item 4). Parallel blocks,
    interleaved or partial RoPE and the unembedding bias train as they
    serve."""
    _raise_first(_refusals(cfg))


def check_servable(cfg: TransformerConfig) -> None:
    """Raise for every structure the port's inference engines do not serve.
    They serve RMSNorm or layernorm, RoPE (rotate-half or GPT-J's
    interleaved pairs, over all of head_dim or its first ``rotary_dim``
    columns), learned positions or ALiBi, q/k/v/out and fc biases,
    ``embed_ln``, SwiGLU or a plain MLP of the gelu family, MoE, parallel
    blocks (two layernorms, or GPT-J's shared one) and an unembedding bias,
    each in bf16 or with quantized weights (``quantize_weights``) and
    multi-tenant adapters. Local or bidirectional attention and ``post_ln``
    stay refused (ROADMAP queue A, item 4 (d))."""
    _raise_first(_refusals(cfg))


def decode_fusion_eligibility(cfg: TransformerConfig) -> dict:
    """Which parts of the fused decode layer this model structure takes,
    as the JAX package's ``decode_fusion_eligibility`` decides it:
    ``{"qkv": None | reason, "mlp": None | reason}``, None meaning
    fusable. (The JAX ``"verify"`` entry gates speculative verify rows,
    which the port does not serve yet: ROADMAP queue A, item 3.)"""
    qkv = None
    if cfg.position == "rope" and cfg.rope_interleaved:
        qkv = ("interleaved (GPT-J rotate-every-two) rope pairing: the "
               "fused kernel's rotate-half form does not cover it")
    mlp = None
    if cfg.n_experts > 0:
        mlp = ("MoE FFN (expert dispatch stays on the moe_layer path, which itself takes "
               "int8/fp8 expert storage through the grouped-GEMM kernel)")
    elif cfg.activation not in FUSABLE_ACTIVATIONS:
        mlp = (f"activation {cfg.activation!r} is not fusable "
               f"(fusable: {', '.join(FUSABLE_ACTIVATIONS)})")
    elif cfg.norm not in ("rmsnorm", "layernorm"):
        mlp = f"unknown norm {cfg.norm!r}"
    return {"qkv": qkv, "mlp": mlp}


# ---------------------------------------------------------------------------
# Core ops
# ---------------------------------------------------------------------------


def _norm(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None,
          kind: str = "rmsnorm", eps: float = 1e-5) -> torch.Tensor:
    """The JAX ``_norm``: result in x's dtype. RMSNorm goes to its kernel
    (B1), which takes x as it is and does both f32 casts in registers, so no
    f32 copy of x is written. Layernorm is plain PyTorch in f32 (population
    variance), as the JAX one is plain jnp."""
    if kind == "rmsnorm":
        from ..ops.rmsnorm import rmsnorm

        return rmsnorm(x, weight, eps=eps)
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = x32.var(-1, keepdim=True, unbiased=False)
    out = (x32 - mean) * (1.0 / torch.sqrt(var + eps))
    out = out * weight.float() + bias.float()
    return out.to(x.dtype)


def activation_fn(name: str):
    """The non-gated activations (JAX ``activation_fn``): "gelu" is the
    exact (erf) form, "gelu_new" and "gelu_pytorch_tanh" the tanh one."""
    fns = {"gelu": F.gelu, "relu": F.relu, "silu": F.silu,
           "gelu_new": lambda x: F.gelu(x, approximate="tanh"),
           "gelu_pytorch_tanh": lambda x: F.gelu(x, approximate="tanh")}
    if name not in fns:
        raise ValueError(f"Unsupported activation {name!r}; use swiglu/gelu/relu/silu/gelu_new")
    return fns[name]


def alibi_slopes(n_heads: int) -> np.ndarray:
    """BLOOM/ALiBi head slopes (Press et al.; HF ``build_alibi_tensor``), f32
    numpy: the JAX package's ``alibi_slopes`` bit for bit."""

    def pow2(n):
        start = 2.0 ** (-(2.0 ** -(math.log2(n) - 3)))
        return [start ** (i + 1) for i in range(n)]

    if math.log2(n_heads).is_integer():
        s = pow2(n_heads)
    else:
        m = 2 ** math.floor(math.log2(n_heads))
        s = pow2(m) + pow2(2 * m)[0::2][: n_heads - m]
    return np.asarray(s, np.float32)


def rope_table(seq_len: int, head_dim: int, theta: float,
               device: Union[str, torch.device, None] = "cpu"):
    """(cos, sin) [seq_len, head_dim/2] in f32; ``head_dim`` is the rotated
    width (``rotary_dims``: all of a head, or its first ``rotary_dim``
    columns)."""
    freqs = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                          device=device) / head_dim))
    t = torch.arange(seq_len, dtype=torch.float32, device=device)
    angles = torch.outer(t, freqs)
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               interleaved: bool = False) -> torch.Tensor:
    """x [B, T, H, D], cos/sin [T, rd/2]: rotates the first rd = 2 *
    cos.shape[-1] columns (partial rotary: GPT-NeoX's ``rotary_pct``,
    GPT-J's ``rotary_dim``) and passes the rest through; the table cast to
    x's dtype before the multiply."""
    return rope_rows(x, cos[None, :, None, :], sin[None, :, None, :], interleaved)


def rope_rows(x: torch.Tensor, c: torch.Tensor, s: torch.Tensor,
              interleaved: bool = False) -> torch.Tensor:
    """JAX ``apply_rope`` on x [..., D] with cos/sin ``c`` / ``s``
    broadcastable to [..., rd/2]: rotate-half pairs column i with i + rd/2
    (Llama, NeoX), interleaved ones 2i with 2i + 1 (GPT-J); columns >= rd
    pass through."""
    rd = 2 * c.shape[-1]
    rot, rest = (x[..., :rd], x[..., rd:]) if rd < x.shape[-1] else (x, None)
    c, s = c.to(x.dtype), s.to(x.dtype)
    if interleaved:
        x1, x2 = rot[..., 0::2], rot[..., 1::2]
        out = torch.stack([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).reshape(rot.shape)
    else:
        x1, x2 = rot.chunk(2, dim=-1)
        out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out if rest is None else torch.cat([out, rest], dim=-1)


class _MmF32Out(torch.autograd.Function):
    """``torch.mm(x, w, out_dtype=f32)`` on the card with its gradients: the
    f32 cotangent is cast to the operands' dtype and the two products run
    in that dtype with f32 accumulation."""

    @staticmethod
    def forward(ctx, x2, w):
        ctx.save_for_backward(x2, w)
        return torch.mm(x2, w, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        x2, w = ctx.saved_tensors
        g = g.to(x2.dtype)
        return g @ w.T, x2.T @ g


def logits_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [..., D] @ w [D, V] with f32 output: bf16 operands, f32
    accumulation and no rounding of the logits to bf16 (the JAX head's
    ``preferred_element_type=f32``)."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if x2.dtype == torch.float32 and w.dtype == torch.float32:
        out = x2 @ w
    elif x2.is_cuda:
        w = w.to(x2.dtype)
        if torch.is_grad_enabled() and (x2.requires_grad or w.requires_grad):
            out = _MmF32Out.apply(x2, w)
        else:
            out = torch.mm(x2, w, out_dtype=torch.float32)
    else:
        out = x2.float() @ w.float()   # exact upcast: the same products and sums
    return out.reshape(*lead, w.shape[-1])


def _remat_policy(name: str) -> Optional[str]:
    """What ``remat`` keeps of a layer: None for "none" (no recompute),
    "full" for "full" / "nothing_saveable" (only the layer's input is kept
    and the whole layer, its flash forward included, runs again in
    backward). The JAX package's selective policies are not ported."""
    if name == "none":
        return None
    if name in ("full", "nothing_saveable"):
        return "full"
    if name == "save_flash_lse":
        raise NotImplementedError(
            "remat_policy 'save_flash_lse' (keep the flash kernel's out and lse) is not "
            "ported yet: ROADMAP queue A, item 5 (a)")
    if name == "offload_kv_host":
        raise NotImplementedError("remat_policy 'offload_kv_host' is not ported yet: host "
                                  "offload is ROADMAP queue A, item 12")
    if name in ("dots_saveable", "dots_with_no_batch_dims_saveable", "save_attn_seams",
                "save_ffn"):
        raise NotImplementedError(
            f"remat_policy {name!r} (a selective save policy) is not ported yet: ROADMAP "
            "queue A, item 4; use 'nothing_saveable', 'full' or 'none'")
    raise ValueError(f"unknown remat_policy {name!r}")


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------


class Transformer(nn.Module):
    """Holds the parameters under their flattened JAX names ("embed",
    "layers.wq", ...) and the embedding and head the engines call. Runs on
    the card unless ``device="cpu"`` is given."""

    def __init__(self, config: TransformerConfig, device=None):
        super().__init__()
        check_servable(config)
        self.config = config
        self.device = resolve_device(device)
        self.layers = nn.ParameterDict()
        self._slopes: Dict[torch.device, torch.Tensor] = {}   # ALiBi slopes by device

    # -- parameters ----------------------------------------------------

    def param_shapes(self) -> Dict[str, Tuple[int, ...]]:
        """Flattened name -> shape, exactly the JAX init's leaves."""
        cfg = self.config
        L, D, H, KV, Dh, Fd, V = (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.kv_heads,
                                  cfg.head_dim, cfg.ff_dim, cfg.vocab_size)
        shapes = {"embed": (V, D)}
        if cfg.position == "learned":
            shapes["pos_embed"] = (cfg.max_seq_len + cfg.pos_offset, D)
        shapes.update({
            "layers.ln1_w": (L, D), "layers.ln1_b": (L, D),
            "layers.wq": (L, D, H * Dh), "layers.wk": (L, D, KV * Dh),
            "layers.wv": (L, D, KV * Dh), "layers.wo": (L, H * Dh, D),
        })
        if not (cfg.parallel_block and cfg.parallel_shared_ln):
            shapes.update({"layers.ln2_w": (L, D), "layers.ln2_b": (L, D)})
        if cfg.attn_qkv_bias:
            shapes.update({"layers.b_q": (L, H * Dh), "layers.b_k": (L, KV * Dh),
                           "layers.b_v": (L, KV * Dh)})
        if cfg.attn_out_bias:
            shapes["layers.b_o"] = (L, D)
        if cfg.n_experts > 0:
            E = cfg.n_experts
            shapes.update({"layers.moe_gate": (L, D, E), "layers.moe_w_up": (L, E, D, Fd),
                           "layers.moe_w_down": (L, E, Fd, D),
                           "layers.moe_w_gate": (L, E, D, Fd)})
            Fs = cfg.moe_shared_expert_ff
            if Fs > 0:
                shapes.update({"layers.moe_shared_w_gate": (L, D, Fs),
                               "layers.moe_shared_w_up": (L, D, Fs),
                               "layers.moe_shared_w_down": (L, Fs, D),
                               "layers.moe_shared_gate": (L, D, 1)})
        elif cfg.activation == "swiglu":
            shapes.update({"layers.w_gate": (L, D, Fd), "layers.w_up": (L, D, Fd),
                           "layers.w_down": (L, Fd, D)})
        else:
            shapes.update({"layers.w_up": (L, D, Fd), "layers.w_down": (L, Fd, D)})
            if cfg.mlp_bias:
                shapes.update({"layers.b_up": (L, Fd), "layers.b_down": (L, D)})
        if cfg.embed_ln:
            shapes.update({"embed_ln_w": (D,), "embed_ln_b": (D,)})
        shapes.update({"ln_f_w": (D,), "ln_f_b": (D,)})
        if not cfg.tie_embeddings:
            shapes["unembed"] = (D, V)
            if cfg.unembed_bias:
                shapes["unembed_b"] = (V,)
        return shapes

    def optional_shapes(self) -> Dict[str, Tuple[int, ...]]:
        """Leaves a parameter dict may hold beyond ``param_shapes()``: the
        per-expert biases of the Megatron biased-expert layout, which the
        JAX init never draws but an imported tree can carry."""
        cfg = self.config
        if cfg.n_experts == 0:
            return {}
        L, E, D, Fd = cfg.n_layers, cfg.n_experts, cfg.d_model, cfg.ff_dim
        return {"layers.moe_b_gate": (L, E, Fd), "layers.moe_b_up": (L, E, Fd),
                "layers.moe_b_down": (L, E, D)}

    def check_params(self, params) -> None:
        """Raise unless ``params`` holds exactly the model's leaves (plus
        any of ``optional_shapes()``) at their shapes."""
        want, extra = self.param_shapes(), self.optional_shapes()
        missing = sorted(set(want) - set(params))
        unexpected = sorted(set(params) - set(want) - set(extra))
        if missing or unexpected:
            raise ValueError(f"parameter names differ: missing {missing}, unexpected "
                             f"{unexpected}")
        for name, t in params.items():
            shape = want.get(name, extra.get(name))
            if tuple(t.shape) != tuple(shape):
                raise ValueError(f"{name}: shape {tuple(t.shape)} != {tuple(shape)}")

    def _init_scale(self, name: str) -> Optional[float]:
        """Std of the JAX init's normal draw for a leaf; None for the norm
        weights (ones) and biases (zeros)."""
        cfg = self.config
        L, D, Fd = cfg.n_layers, cfg.d_model, cfg.ff_dim
        HD = cfg.n_heads * cfg.head_dim
        Fs = max(cfg.moe_shared_expert_ff, 1)
        leaf = name.split(".")[-1]
        # expert stacks follow JAX init_expert_mlp: 1/sqrt(fan_in), with no
        # depth factor on the down projection
        return {"embed": 0.02, "unembed": 0.02, "pos_embed": 0.02,
                "wq": 1 / math.sqrt(D), "wk": 1 / math.sqrt(D), "wv": 1 / math.sqrt(D),
                "wo": 1 / math.sqrt(2 * L) / math.sqrt(HD),
                "w_gate": 1 / math.sqrt(D), "w_up": 1 / math.sqrt(D),
                "w_down": 1 / math.sqrt(2 * L) / math.sqrt(Fd),
                "moe_gate": 1 / math.sqrt(D), "moe_w_gate": 1 / math.sqrt(D),
                "moe_w_up": 1 / math.sqrt(D), "moe_w_down": 1 / math.sqrt(Fd),
                "moe_shared_w_gate": 1 / math.sqrt(D), "moe_shared_w_up": 1 / math.sqrt(D),
                "moe_shared_w_down": 1 / math.sqrt(Fs)}.get(leaf)

    @torch.no_grad()
    def init(self, generator: Optional[torch.Generator] = None,
             dtype: torch.dtype = torch.float32, device=None) -> Dict[str, torch.Tensor]:
        """Random weights with the JAX package's init scales, drawn from
        ``generator`` (its device is where the draws happen), stored in
        ``dtype`` on ``device`` (default: the model's). Stacked leaves are
        drawn layer by layer in f32, so the transient f32 copy is one
        layer's slice. Returns the state dict (``params()``)."""
        device = self.device if device is None else resolve_device(device)
        gen_dev = generator.device if generator is not None else device
        state = {}
        for name, shape in self.param_shapes().items():
            leaf = name.split(".")[-1]
            t = torch.empty(shape, dtype=dtype, device=device)
            scale = self._init_scale(name)
            if scale is None:
                t.fill_(1.0 if leaf.endswith("_w") else 0.0)
            else:
                parts = t if name.startswith("layers.") else t[None]
                for part in parts:
                    draw = torch.randn(part.shape, generator=generator,
                                       dtype=torch.float32, device=gen_dev)
                    part.copy_((draw * scale).to(device=device, dtype=dtype))
            state[name] = t
        self.device = device
        self.load_params(state)
        return self.params()

    def load_params(self, state: Dict[str, torch.Tensor]) -> None:
        """Install a flattened-name state dict (no copies). Names and
        shapes must be exactly ``param_shapes()`` (plus any of
        ``optional_shapes()``)."""
        self.check_params(state)
        for name, t in state.items():
            p = nn.Parameter(t, requires_grad=t.is_floating_point())
            if name.startswith("layers."):
                self.layers[name[len("layers."):]] = p
            else:
                # top-level leaves go straight into _parameters: "embed" is
                # also the name of the embed() method, and the state dict
                # keys must stay the JAX leaf names
                self._parameters[name] = p

    def params(self) -> Dict[str, torch.Tensor]:
        """The state dict under the flattened JAX names (detached: the
        engines own what they differentiate)."""
        return {k: v.detach() for k, v in self.state_dict(keep_vars=True).items()}

    def has_params(self) -> bool:
        return "embed" in self._parameters

    # -- forward pieces ------------------------------------------------

    def embed(self, params: Dict[str, torch.Tensor], input_ids: torch.Tensor):
        """ids [.., T] -> (x [.., T, D], (cos, sin) rope tables [T, Dh/2], or
        (None, None) for learned and ALiBi positions)."""
        cfg = self.config
        T = input_ids.shape[-1]
        x = params["embed"][input_ids]
        if cfg.position == "learned":
            x = x + params["pos_embed"][cfg.pos_offset:cfg.pos_offset + T].to(x.dtype)
        if cfg.embed_ln:
            # BLOOM's word_embeddings_layernorm
            x = _norm(x, params["embed_ln_w"], params["embed_ln_b"], cfg.norm, eps=cfg.norm_eps)
        if cfg.position in ("learned", "alibi"):
            return x, (None, None)
        return x, rope_table(T, cfg.rotary_dims, cfg.rope_theta, device=x.device)

    def unembed_weight(self, params: Dict[str, torch.Tensor]) -> torch.Tensor:
        return params["embed"].T if self.config.tie_embeddings else params["unembed"]

    def head(self, params: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
        """Final norm + unembed: x [.., D] -> f32 logits [.., vocab], plus the
        unembedding bias in f32 when the model has one (JAX ``_unembed``:
        untied only)."""
        cfg = self.config
        x = _norm(x, params["ln_f_w"], params.get("ln_f_b"), cfg.norm, eps=cfg.norm_eps)
        logits = logits_f32(x, self.unembed_weight(params))
        if cfg.unembed_bias and not cfg.tie_embeddings:
            logits = logits + params["unembed_b"].float()
        return logits

    # -- training forward ------------------------------------------------

    def alibi(self, device) -> Optional[torch.Tensor]:
        """The f32 [H] slopes ``alibi_slopes(H) * alibi_slope_scale`` on
        ``device`` for an ALiBi model (made once a device: a host copy per
        layer would stall the host on the card's queue), else None."""
        cfg = self.config
        if cfg.position != "alibi":
            return None
        dev = torch.device(device)
        if dev not in self._slopes:
            self._slopes[dev] = torch.from_numpy(alibi_slopes(cfg.n_heads)
                                                 * cfg.alibi_slope_scale).to(dev)
        return self._slopes[dev]

    def layer_apply(self, lw: Dict[str, torch.Tensor], h: torch.Tensor, rope):
        """One block, ``lw`` one layer's leaves: h [B, T, D] -> (h, the
        layer's MoE aux loss, 0 for a dense model). Pre-norm attention
        (q/k/v biases, then RoPE when ``position`` is "rope": rotate-half or
        interleaved, over the first ``rotary_dims`` columns; ``flash_attention``
        with the ALiBi slopes when it is "alibi"; the out bias) and a SwiGLU
        MLP, a plain MLP with or without fc biases, or the MoE FFN. A
        sequential block adds the attention to the residual stream and
        feeds the MLP ``ln2`` of the sum; a parallel block (GPT-J, NeoX,
        Falcon) adds both to the block's input, the MLP fed ``ln1``'s output
        under ``parallel_shared_ln`` and ``ln2`` of the input otherwise."""
        from ..ops.flash_attention import flash_attention

        cfg = self.config
        B, T = h.shape[:2]
        H, KV, Dh = cfg.n_heads, cfg.kv_heads, cfg.head_dim
        dtype = h.dtype
        y = _norm(h, lw["ln1_w"], lw.get("ln1_b"), cfg.norm, eps=cfg.norm_eps)
        q = (y @ lw["wq"]).reshape(B, T, H, Dh)
        k = (y @ lw["wk"]).reshape(B, T, KV, Dh)
        v = (y @ lw["wv"]).reshape(B, T, KV, Dh)
        if cfg.attn_qkv_bias:
            q = q + lw["b_q"].to(dtype).reshape(H, Dh)
            k = k + lw["b_k"].to(dtype).reshape(KV, Dh)
            v = v + lw["b_v"].to(dtype).reshape(KV, Dh)
        if cfg.position == "rope":
            cos, sin = rope
            q = apply_rope(q, cos, sin, interleaved=cfg.rope_interleaved)
            k = apply_rope(k, cos, sin, interleaved=cfg.rope_interleaved)
        attn = flash_attention(q, k, v, causal=cfg.causal,
                               alibi_slopes=self.alibi(h.device)).reshape(B, T, H * Dh)
        attn_out = attn @ lw["wo"]
        if cfg.attn_out_bias:
            attn_out = attn_out + lw["b_o"].to(dtype)
        if cfg.parallel_block:
            # GPT-J / NeoX / Falcon: h + attn(ln1 h) + mlp(ln1 h or ln2 h)
            y2 = y if cfg.parallel_shared_ln else _norm(h, lw["ln2_w"], lw.get("ln2_b"),
                                                        cfg.norm, eps=cfg.norm_eps)
            h = h + attn_out
        else:
            h = h + attn_out
            y2 = _norm(h, lw["ln2_w"], lw.get("ln2_b"), cfg.norm, eps=cfg.norm_eps)
        if cfg.n_experts > 0:
            ff, res = self.moe_ffn(lw, y2)
            return h + ff, res.aux_loss
        if cfg.activation == "swiglu":
            ff = (F.silu(y2 @ lw["w_gate"]) * (y2 @ lw["w_up"])) @ lw["w_down"]
        elif cfg.mlp_bias:
            act = activation_fn(cfg.activation)
            ff = act(y2 @ lw["w_up"] + lw["b_up"].to(dtype)) @ lw["w_down"] + lw["b_down"].to(dtype)
        else:
            ff = activation_fn(cfg.activation)(y2 @ lw["w_up"]) @ lw["w_down"]
        return h + ff, torch.zeros((), dtype=torch.float32, device=h.device)

    def moe_ffn(self, lw: Dict[str, torch.Tensor], y: torch.Tensor, impl: Optional[str] = None,
                capacity_factor: Optional[float] = None):
        """The MoE FFN of one layer (JAX ``layer_apply``'s MoE branch and the
        engines' ``_ffn``): the routed experts through ``moe_layer(...,
        scanned=True)`` (so "auto" resolves to "capacity", as under JAX's
        layer scan) and the Qwen2-style shared expert added with its
        per-token sigmoid gate. ``impl`` / ``capacity_factor`` override the
        config's (a serving config's). Returns (ff, the ``MoEResult``)."""
        from ..moe.layer import moe_layer

        cfg = self.config
        experts = {n[len("moe_"):]: v for n, v in lw.items()
                   if n.startswith("moe_") and n != "moe_gate" and not n.startswith("moe_shared")}
        res = moe_layer(lw["moe_gate"], experts, y, k=cfg.moe_top_k,
                        capacity_factor=(cfg.capacity_factor if capacity_factor is None
                                         else capacity_factor),
                        activation=cfg.activation, impl=impl or cfg.moe_impl,
                        normalize_weights=cfg.moe_norm_topk, scanned=True)
        ff = res.output
        if cfg.moe_shared_expert_ff > 0:
            shared = (F.silu(y @ lw["moe_shared_w_gate"])
                      * (y @ lw["moe_shared_w_up"])) @ lw["moe_shared_w_down"]
            gate_s = torch.sigmoid(y @ lw["moe_shared_gate"])
            ff = ff + gate_s.to(ff.dtype) * shared
        return ff, res

    def stack_apply(self, stacked_layers: Dict[str, torch.Tensor], x: torch.Tensor, rope):
        """Run the stack over x: ``stacked_layers`` holds the ``[L, ...]``
        leaves by their short names ("wq", ...). Returns (x, summed aux).
        Each leaf is unbound once, so autograd builds one stacked gradient
        per leaf; with ``remat`` each layer is checkpointed and runs again
        in backward."""
        cfg = self.config
        check_supported(cfg)
        names = list(stacked_layers)
        per_layer = zip(*(stacked_layers[n].unbind(0) for n in names))
        full = cfg.remat and _remat_policy(cfg.remat_policy) == "full"

        def layer_fn(h, *leaves):
            return self.layer_apply(dict(zip(names, leaves)), h, rope)

        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for leaves in per_layer:
            if full and torch.is_grad_enabled():
                x, a = checkpoint(layer_fn, x, *leaves, use_reentrant=False)
            else:
                x, a = layer_fn(x, *leaves)
            aux = aux + a
        return x, aux

    @staticmethod
    def stacked(params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The ``layers.*`` leaves of a flattened-name dict by short name."""
        return {k[len("layers."):]: v for k, v in params.items() if k.startswith("layers.")}

    @staticmethod
    def token_loss(logits: torch.Tensor, labels: torch.Tensor):
        """Cross-entropy pieces (nll_sum f32, token_count): a negative
        label (-100) is ignored."""
        mask = labels >= 0
        safe = torch.where(mask, labels, torch.full_like(labels, -100)).long()
        nll = F.cross_entropy(logits.reshape(-1, logits.shape[-1]).float(), safe.reshape(-1),
                              ignore_index=-100, reduction="sum")
        return nll, mask.sum()

    def chunked_loss(self, params, x: torch.Tensor, labels: torch.Tensor, chunk: int):
        """Final norm + unembed (+ the unembedding bias in f32, as ``head``)
        + cross entropy over sequence chunks of ``chunk`` tokens, each
        checkpointed: the live logits are [B, chunk, vocab], never [B, T,
        vocab]. The same numbers as ``head`` + ``token_loss`` (the softmax
        is per token). The vocab is not padded (JAX pads it on a TPU only),
        so no pad mask is added."""
        cfg = self.config
        w = self.unembed_weight(params)
        ln_w = params["ln_f_w"]
        ln_b = params["ln_f_b"] if cfg.norm == "layernorm" else None
        bias = params["unembed_b"] if cfg.unembed_bias and not cfg.tie_embeddings else None

        def body(xch, lch, ln_w, ln_b, w, bias):
            xn = _norm(xch, ln_w, ln_b, cfg.norm, eps=cfg.norm_eps)
            logits = logits_f32(xn, w)
            if bias is not None:
                logits = logits + bias.float()
            return self.token_loss(logits, lch)[0]

        nll_sum = torch.zeros((), dtype=torch.float32, device=x.device)
        for a in range(0, x.shape[1], chunk):
            xch, lch = x[:, a:a + chunk].contiguous(), labels[:, a:a + chunk]
            if torch.is_grad_enabled():
                nll_sum = nll_sum + checkpoint(body, xch, lch, ln_w, ln_b, w, bias,
                                               use_reentrant=False)
            else:
                nll_sum = nll_sum + body(xch, lch, ln_w, ln_b, w, bias)
        return nll_sum, (labels >= 0).sum()

    def _loss_chunk(self, B: int, T: int) -> int:
        """The resolved chunk size; 0 = full logits."""
        c = self.config.loss_chunk
        if c >= 0:
            return 0 if c == 0 else min(c, T)
        if B * T * self.config.vocab_size * 4 <= 256 * 1024 * 1024:
            return 0
        return min(256, T)

    def apply(self, params, input_ids):
        """input_ids [B, T] -> f32 logits [B, T, vocab]."""
        return self.apply_with_aux(params, input_ids)[0]

    def apply_with_aux(self, params, input_ids):
        """(logits, moe aux loss): aux is 0 for dense models."""
        params = self._params_or_own(params)
        x, rope = self.embed(params, self._ids(input_ids, params))
        x, aux = self.stack_apply(self.stacked(params), x, rope)
        return self.head(params, x), aux

    def loss(self, params, batch, rng=None):
        """Next-token cross entropy of ``batch = {"input_ids": [B, T]}``
        (labels are the ids shifted by one), or of explicit
        ``batch["labels"]`` (already aligned, -100 = ignore). ``params`` is
        a flattened-name dict, or None for the model's own parameters. An
        MoE model adds ``aux_loss_coef`` times its summed aux loss."""
        params = self._params_or_own(params)
        for key in ("ltd_keep_prob", "pld_theta"):
            if key in batch:
                raise NotImplementedError(f"batch[{key!r}] (random-LTD / progressive layer "
                                          "drop) is not ported yet: ROADMAP queue A, item 14")
        ids = self._ids(batch["input_ids"], params)
        if "labels" in batch:
            labels, model_ids = self._ids(batch["labels"], params), ids
        else:
            labels, model_ids = ids[:, 1:], ids[:, :-1]
        B, T = model_ids.shape
        chunk = self._loss_chunk(B, T)
        if chunk:
            x, rope = self.embed(params, model_ids)
            x, aux = self.stack_apply(self.stacked(params), x, rope)
            nll_sum, count = self.chunked_loss(params, x, labels, chunk)
        else:
            logits, aux = self.apply_with_aux(params, model_ids)
            nll_sum, count = self.token_loss(logits, labels)
        return nll_sum / count.clamp(min=1) + self.config.aux_loss_coef * aux

    def _params_or_own(self, params):
        if params is not None:
            return params
        if not self.has_params():
            raise ValueError("the model holds no parameters yet: call init() or load_params()")
        return dict(self.state_dict(keep_vars=True))

    @staticmethod
    def _ids(ids, params) -> torch.Tensor:
        dev = params["embed"].device
        return torch.as_tensor(ids).to(device=dev, dtype=torch.long)
