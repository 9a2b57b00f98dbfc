from .convert import params_from_numpy, params_to_numpy
from .transformer import Transformer, TransformerConfig, llama3_8b, tiny

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


__all__ = ["MODEL_REGISTRY", "Transformer", "TransformerConfig", "get_model",
           "llama3_8b", "params_from_numpy", "params_to_numpy", "tiny"]
