"""Hugging Face configs into the port's ``TransformerConfig``.

A slice of ``shuffle_exchange_tpu/models/hf.py``: ``config_from_hf`` for a
``config.json`` dict, for the families the port trains: GPT-2, BLOOM and
the Llama family (llama, mistral, phi3, which the JAX mapping sends through
one branch), and those it serves: GPT-J, GPT-NeoX (Pythia) and Falcon (the
7B's multi-query shared-layernorm parallel block, the 40B's
``new_decoder_architecture`` with two parallel norms, and falcon-rw's
sequential ALiBi blocks), the parallel-block families. The field mapping
is the JAX package's, line for line. Other
families, HF config objects and the weight conversion raise, naming ROADMAP
queue A, item 14; ``transformers`` is never imported.
"""

from __future__ import annotations

from typing import Any, Dict

from .transformer import TransformerConfig

# HF architecture class name -> family key (the JAX package's table)
_ARCH_FAMILIES = {
    "LlamaForCausalLM": "llama", "MistralForCausalLM": "llama", "Qwen2ForCausalLM": "qwen2",
    "MixtralForCausalLM": "mixtral", "GPT2LMHeadModel": "gpt2", "OPTForCausalLM": "opt",
    "Phi3ForCausalLM": "phi3", "Qwen2MoeForCausalLM": "qwen2moe", "GPTJForCausalLM": "gptj",
    "GPTNeoXForCausalLM": "gptneox", "FalconForCausalLM": "falcon", "RWForCausalLM": "falcon",
    "BloomForCausalLM": "bloom", "BertForMaskedLM": "bert", "BertForPreTraining": "bert",
    "BertModel": "bert", "DistilBertForMaskedLM": "distilbert", "GPTNeoForCausalLM": "gptneo",
    "InternLMForCausalLM": "internlm", "InternLM2ForCausalLM": "internlm2",
}
_MODEL_TYPE_FAMILIES = {"llama": "llama", "mistral": "llama", "qwen2": "qwen2",
                        "mixtral": "mixtral", "gpt2": "gpt2", "opt": "opt", "phi3": "phi3",
                        "gptj": "gptj", "gpt_neox": "gptneox", "falcon": "falcon",
                        "bloom": "bloom", "qwen2_moe": "qwen2moe", "bert": "bert",
                        "distilbert": "distilbert", "gpt_neo": "gptneo", "internlm": "internlm",
                        "internlm2": "internlm2", "megatron": "megatron",
                        "megatron-gpt": "megatron", "megatron_gpt": "megatron"}
_PORTED = ("gpt2", "bloom", "llama", "phi3", "gptj", "gptneox", "falcon")


def _family(cfg: Dict[str, Any]) -> str:
    archs = cfg.get("architectures") or []
    family = next((_ARCH_FAMILIES[a] for a in archs if a in _ARCH_FAMILIES), None)
    if family is None:
        family = _MODEL_TYPE_FAMILIES.get(cfg.get("model_type", ""))
    if family is None:
        raise ValueError(f"Unsupported HF architecture {archs or cfg.get('model_type')!r}; "
                         f"supported: {sorted(set(_ARCH_FAMILIES.values()))}")
    return family


def config_from_hf(hf_config: Dict[str, Any]) -> TransformerConfig:
    """Map an HF ``config.json`` dict to a ``TransformerConfig``, as the JAX
    ``config_from_hf`` maps it."""
    if not isinstance(hf_config, dict):
        raise NotImplementedError("config_from_hf takes a config.json dict in the PyTorch "
                                  "port; HF config objects are ROADMAP queue A, item 14")
    cfg = hf_config
    family = _family(cfg)
    if family not in _PORTED:
        raise NotImplementedError(f"config_from_hf for the {family!r} family is not in the "
                                  f"PyTorch port yet (ported: {', '.join(_PORTED)}): ROADMAP "
                                  f"queue A, item 14")
    if family == "gpt2":
        return TransformerConfig(
            vocab_size=cfg["vocab_size"], d_model=cfg["n_embd"], n_layers=cfg["n_layer"],
            n_heads=cfg["n_head"], max_seq_len=cfg.get("n_positions", 1024),
            activation=cfg.get("activation_function", "gelu_new"),
            norm="layernorm", position="learned",
            norm_eps=cfg.get("layer_norm_epsilon", 1e-5),
            attn_qkv_bias=True, attn_out_bias=True, tie_embeddings=True)
    if family == "bloom":
        return TransformerConfig(
            vocab_size=cfg["vocab_size"], d_model=cfg["hidden_size"],
            n_layers=cfg["n_layer"], n_heads=cfg["n_head"],
            max_seq_len=cfg.get("seq_length", 2048),
            activation="gelu_new",   # BloomGelu is the tanh approximation
            norm="layernorm", position="alibi", embed_ln=True,
            attn_qkv_bias=True, attn_out_bias=True,
            norm_eps=cfg.get("layer_norm_epsilon", 1e-5),
            tie_embeddings=cfg.get("tie_word_embeddings", True))
    if family == "gptj":
        return TransformerConfig(
            vocab_size=cfg["vocab_size"], d_model=cfg["n_embd"], n_layers=cfg["n_layer"],
            n_heads=cfg["n_head"], max_seq_len=cfg.get("n_positions", 2048),
            activation=cfg.get("activation_function", "gelu_new"),
            norm="layernorm", position="rope", rope_theta=10000.0,
            rotary_dim=cfg.get("rotary_dim") or 0, rope_interleaved=True,
            parallel_block=True, parallel_shared_ln=True,
            norm_eps=cfg.get("layer_norm_epsilon", 1e-5),
            tie_embeddings=cfg.get("tie_word_embeddings", False),
            unembed_bias=True)
    if family == "gptneox":
        head_dim = cfg["hidden_size"] // cfg["num_attention_heads"]
        return TransformerConfig(
            vocab_size=cfg["vocab_size"], d_model=cfg["hidden_size"],
            n_layers=cfg["num_hidden_layers"], n_heads=cfg["num_attention_heads"],
            d_ff=cfg.get("intermediate_size"),
            max_seq_len=cfg.get("max_position_embeddings", 2048),
            activation=cfg.get("hidden_act", "gelu"),
            norm="layernorm", position="rope",
            rope_theta=float(cfg.get("rotary_emb_base", 10000.0)),
            rotary_dim=int(cfg.get("rotary_pct", 1.0) * head_dim),
            parallel_block=cfg.get("use_parallel_residual", True),
            attn_qkv_bias=cfg.get("attention_bias", True),
            attn_out_bias=cfg.get("attention_bias", True),
            norm_eps=cfg.get("layer_norm_eps", 1e-5),
            tie_embeddings=cfg.get("tie_word_embeddings", False))
    if family == "falcon":
        H = cfg["num_attention_heads"]
        new_arch = cfg.get("new_decoder_architecture", False)
        kv = (cfg.get("num_kv_heads") or H) if new_arch else (
            1 if cfg.get("multi_query", True) else H)
        return TransformerConfig(
            vocab_size=cfg["vocab_size"], d_model=cfg["hidden_size"],
            n_layers=cfg["num_hidden_layers"], n_heads=H, n_kv_heads=kv,
            max_seq_len=cfg.get("max_position_embeddings", 2048),
            activation="gelu", norm="layernorm",
            position="alibi" if cfg.get("alibi", False) else "rope",
            # Falcon's baddbmm scales the ALiBi bias by 1/sqrt(Dh) (BLOOM's
            # does not)
            alibi_slope_scale=(cfg["hidden_size"] // H) ** -0.5,
            d_ff=cfg.get("ffn_hidden_size"),
            rope_theta=float(cfg.get("rope_theta", 10000.0)),
            parallel_block=cfg.get("parallel_attn", True),
            parallel_shared_ln=cfg.get("parallel_attn", True) and not new_arch,
            attn_qkv_bias=cfg.get("bias", False), attn_out_bias=cfg.get("bias", False),
            mlp_bias=cfg.get("bias", False),
            norm_eps=cfg.get("layer_norm_epsilon", 1e-5),
            tie_embeddings=cfg.get("tie_word_embeddings", True))
    return TransformerConfig(      # llama / mistral / phi3
        vocab_size=cfg["vocab_size"], d_model=cfg["hidden_size"],
        n_layers=cfg["num_hidden_layers"], n_heads=cfg["num_attention_heads"],
        n_kv_heads=cfg.get("num_key_value_heads"),
        d_ff=cfg.get("intermediate_size"),
        max_seq_len=cfg.get("max_position_embeddings", 4096),
        activation="swiglu", norm="rmsnorm", position="rope",
        rope_theta=float(cfg.get("rope_theta", 10000.0)),
        norm_eps=cfg.get("rms_norm_eps", 1e-6),
        tie_embeddings=cfg.get("tie_word_embeddings", False))


__all__ = ["config_from_hf"]
