"""Decoder-only transformer, Llama family, in PyTorch.

Counterpart of ``shuffle_exchange_tpu/models/transformer.py`` cut to what
the serving slice runs: RMSNorm, rotate-half RoPE, grouped-query
attention, SwiGLU and an untied (or tied) unembedding. The parameters keep
the JAX package's leaf names and layouts — per-layer weights stacked on a
leading ``[L, ...]`` dim, projections stored ``[in, out]`` — so a JAX
parameter tree moves over by name (``models/convert.py``) and a test can
compare the two packages leaf by leaf.

Any other structure raises ``NotImplementedError`` naming the ROADMAP item
that ports it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple, Union

import torch
from torch import nn

from ..ops.dispatch import resolve_device


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
    parallel_block: bool = False
    rotary_dim: int = 0
    rope_interleaved: bool = False
    embed_ln: bool = False
    post_ln: bool = False
    local_attention_window: int = 0
    attention_pattern: Tuple[str, ...] = ()
    n_experts: int = 0

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


def llama3_8b() -> TransformerConfig:
    return TransformerConfig(vocab_size=128256, d_model=4096, n_layers=32, n_heads=32,
                             n_kv_heads=8, d_ff=14336, max_seq_len=8192,
                             activation="swiglu", norm="rmsnorm", position="rope",
                             rope_theta=500000.0, tie_embeddings=False)


def tiny(vocab=256, d=64, layers=2, heads=4, seq=64, **kw) -> TransformerConfig:
    return TransformerConfig(vocab_size=vocab, d_model=d, n_layers=layers, n_heads=heads,
                             max_seq_len=seq, **kw)


def check_supported(cfg: TransformerConfig) -> None:
    """Raise for every structure outside the Llama family this slice ports."""
    later = "ROADMAP queue A, item 4"
    checks = [
        (cfg.norm != "rmsnorm", f"norm={cfg.norm!r} (only rmsnorm is ported; {later})"),
        (cfg.activation != "swiglu",
         f"activation={cfg.activation!r} (only swiglu is ported; {later})"),
        (cfg.position == "alibi",
         "ALiBi positions (ALiBi in the paged kernels: ROADMAP queue A, item 3; "
         f"the model path: {later})"),
        (cfg.position != "rope" and cfg.position != "alibi",
         f"position={cfg.position!r} (only rope is ported; {later})"),
        (cfg.rope_interleaved, f"interleaved (rotate-every-two) rope ({later})"),
        (cfg.rotary_dim not in (0, cfg.head_dim), f"partial rotary_dim ({later})"),
        (cfg.parallel_block, f"parallel blocks ({later})"),
        (cfg.embed_ln, f"embed_ln ({later})"),
        (cfg.post_ln, f"post_ln ({later})"),
        (cfg.attn_qkv_bias or cfg.attn_out_bias, f"attention biases ({later})"),
        (cfg.n_experts > 0, "MoE layers (ROADMAP queue A, item 9)"),
        (cfg.local_attention_window > 0 or "local" in cfg.attention_pattern,
         f"local attention ({later})"),
        (cfg.n_heads % cfg.kv_heads != 0, "n_heads must be a multiple of n_kv_heads"),
    ]
    for bad, what in checks:
        if bad:
            raise NotImplementedError(f"not supported by the PyTorch port yet: {what}")


#: activations the port's fused MLP kernel computes. The JAX package's
#: ``ops/fused_decode.py:FUSABLE_ACTIVATIONS`` also has silu, relu,
#: gelu_new and gelu_pytorch_tanh, which join with those activations
#: (ROADMAP queue A, item 4)
FUSABLE_ACTIVATIONS = ("swiglu",)


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
        mlp = "MoE FFN (expert dispatch stays on the MoE layer path)"
    elif cfg.activation not in FUSABLE_ACTIVATIONS:
        mlp = (f"activation {cfg.activation!r} is not fusable "
               f"(fusable: {', '.join(FUSABLE_ACTIVATIONS)})")
    elif cfg.norm != "rmsnorm":
        mlp = (f"norm {cfg.norm!r}: the port's fused MLP kernel normalises with "
               "RMSNorm (layernorm joins with ROADMAP queue A, item 4)")
    return {"qkv": qkv, "mlp": mlp}


# ---------------------------------------------------------------------------
# Core ops
# ---------------------------------------------------------------------------


def _norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm in f32, result in x's dtype. The JAX ``_norm`` casts to f32
    around its rmsnorm call; the kernel takes x as it is and does both
    casts in registers, so no f32 copy of x is written."""
    from ..ops.rmsnorm import rmsnorm

    return rmsnorm(x, weight, eps=eps)


def rope_table(seq_len: int, head_dim: int, theta: float,
               device: Union[str, torch.device, None] = "cpu"):
    """(cos, sin) [seq_len, head_dim/2] in f32."""
    freqs = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                          device=device) / head_dim))
    t = torch.arange(seq_len, dtype=torch.float32, device=device)
    angles = torch.outer(t, freqs)
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [B, T, H, D], cos/sin [T, D/2]: rotate-half pairing (dim i with
    i + D/2), the table cast to x's dtype before the multiply."""
    c = cos[None, :, None, :].to(x.dtype)
    s = sin[None, :, None, :].to(x.dtype)
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def logits_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [..., D] @ w [D, V] with f32 output: bf16 operands, f32
    accumulation and no rounding of the logits to bf16 (the JAX head's
    ``preferred_element_type=f32``)."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if x2.dtype == torch.float32 and w.dtype == torch.float32:
        out = x2 @ w
    elif x2.is_cuda:
        out = torch.mm(x2, w.to(x2.dtype), out_dtype=torch.float32)
    else:
        out = x2.float() @ w.float()   # exact upcast: the same products and sums
    return out.reshape(*lead, w.shape[-1])


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------


class Transformer(nn.Module):
    """Holds the parameters under their flattened JAX names ("embed",
    "layers.wq", ...) and the embedding and head the engines call. Runs on
    the card unless ``device="cpu"`` is given."""

    def __init__(self, config: TransformerConfig, device=None):
        super().__init__()
        check_supported(config)
        self.config = config
        self.device = resolve_device(device)
        self.layers = nn.ParameterDict()

    # -- parameters ----------------------------------------------------

    def param_shapes(self) -> Dict[str, Tuple[int, ...]]:
        """Flattened name -> shape, exactly the JAX init's leaves."""
        cfg = self.config
        L, D, H, KV, Dh, Fd, V = (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.kv_heads,
                                  cfg.head_dim, cfg.ff_dim, cfg.vocab_size)
        shapes = {
            "embed": (V, D),
            "layers.ln1_w": (L, D), "layers.ln1_b": (L, D),
            "layers.wq": (L, D, H * Dh), "layers.wk": (L, D, KV * Dh),
            "layers.wv": (L, D, KV * Dh), "layers.wo": (L, H * Dh, D),
            "layers.ln2_w": (L, D), "layers.ln2_b": (L, D),
            "layers.w_gate": (L, D, Fd), "layers.w_up": (L, D, Fd),
            "layers.w_down": (L, Fd, D),
            "ln_f_w": (D,), "ln_f_b": (D,),
        }
        if not cfg.tie_embeddings:
            shapes["unembed"] = (D, V)
        return shapes

    def _init_scale(self, name: str) -> Optional[float]:
        """Std of the JAX init's normal draw for a leaf; None for the norm
        weights (ones) and biases (zeros)."""
        cfg = self.config
        L, D, Fd = cfg.n_layers, cfg.d_model, cfg.ff_dim
        HD = cfg.n_heads * cfg.head_dim
        leaf = name.split(".")[-1]
        return {"embed": 0.02, "unembed": 0.02,
                "wq": 1 / math.sqrt(D), "wk": 1 / math.sqrt(D), "wv": 1 / math.sqrt(D),
                "wo": 1 / math.sqrt(2 * L) / math.sqrt(HD),
                "w_gate": 1 / math.sqrt(D), "w_up": 1 / math.sqrt(D),
                "w_down": 1 / math.sqrt(2 * L) / math.sqrt(Fd)}.get(leaf)

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
        shapes must be exactly ``param_shapes()``."""
        want = self.param_shapes()
        if set(state) != set(want):
            raise ValueError(f"parameter names differ: missing "
                             f"{sorted(set(want) - set(state))}, unexpected "
                             f"{sorted(set(state) - set(want))}")
        for name, t in state.items():
            if tuple(t.shape) != want[name]:
                raise ValueError(f"{name}: shape {tuple(t.shape)} != {want[name]}")
            p = nn.Parameter(t, requires_grad=False)
            if name.startswith("layers."):
                self.layers[name[len("layers."):]] = p
            else:
                # top-level leaves go straight into _parameters: "embed" is
                # also the name of the embed() method, and the state dict
                # keys must stay the JAX leaf names
                self._parameters[name] = p

    def params(self) -> Dict[str, torch.Tensor]:
        """The state dict under the flattened JAX names."""
        return {k: v.detach() for k, v in self.state_dict(keep_vars=True).items()}

    # -- forward pieces ------------------------------------------------

    def embed(self, params: Dict[str, torch.Tensor], input_ids: torch.Tensor):
        """ids [.., T] -> (x [.., T, D], (cos, sin) rope tables [T, Dh/2])."""
        cfg = self.config
        x = params["embed"][input_ids]
        return x, rope_table(input_ids.shape[-1], cfg.rotary_dims, cfg.rope_theta,
                             device=x.device)

    def unembed_weight(self, params: Dict[str, torch.Tensor]) -> torch.Tensor:
        return params["embed"].T if self.config.tie_embeddings else params["unembed"]

    def head(self, params: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
        """Final norm + unembed: x [.., D] -> f32 logits [.., vocab]."""
        x = _norm(x, params["ln_f_w"], eps=self.config.norm_eps)
        return logits_f32(x, self.unembed_weight(params))
