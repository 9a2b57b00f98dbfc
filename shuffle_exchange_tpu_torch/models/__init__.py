from .convert import (QuantizedArrays, adapter_pool_to_numpy, load_train_state,
                      params_from_numpy, params_to_numpy, train_state_to_numpy)
from .hf import config_from_hf
from .transformer import (Transformer, TransformerConfig, alibi_slopes, gpt2_large, gpt2_small,
                          llama3_8b, llama_ladder, mixtral_8x7b, param_count, pick_ladder_config,
                          tiny, tiny_moe)

MODEL_REGISTRY = {
    "gpt2-small": gpt2_small,
    "gpt2-large": gpt2_large,
    "llama3-8b": llama3_8b,
    "mixtral-8x7b": mixtral_8x7b,
    "tiny": tiny,
    "tiny-moe": tiny_moe,
}


def get_model(name: str, device=None, **overrides) -> Transformer:
    import dataclasses

    cfg = MODEL_REGISTRY[name]()
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return Transformer(cfg, device=device)


__all__ = ["MODEL_REGISTRY", "QuantizedArrays", "Transformer", "TransformerConfig",
           "adapter_pool_to_numpy", "alibi_slopes", "config_from_hf", "get_model", "gpt2_large",
           "gpt2_small", "llama3_8b",
           "llama_ladder", "load_train_state", "mixtral_8x7b", "param_count",
           "params_from_numpy", "params_to_numpy", "pick_ladder_config", "tiny", "tiny_moe",
           "train_state_to_numpy"]
