from .convert import (QuantizedArrays, load_train_state, params_from_numpy, params_to_numpy,
                      train_state_to_numpy)
from .transformer import (Transformer, TransformerConfig, llama3_8b, llama_ladder,
                          param_count, pick_ladder_config, tiny)

MODEL_REGISTRY = {
    "llama3-8b": llama3_8b,
    "tiny": tiny,
}


def get_model(name: str, device=None, **overrides) -> Transformer:
    import dataclasses

    cfg = MODEL_REGISTRY[name]()
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return Transformer(cfg, device=device)


__all__ = ["MODEL_REGISTRY", "QuantizedArrays", "Transformer", "TransformerConfig", "get_model", "llama3_8b",
           "llama_ladder", "load_train_state", "param_count", "params_from_numpy",
           "params_to_numpy", "pick_ladder_config", "tiny", "train_state_to_numpy"]
