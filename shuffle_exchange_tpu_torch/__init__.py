"""shuffle_exchange_tpu_torch — the PyTorch and CUDA port of
``shuffle_exchange_tpu`` for NVIDIA Hopper.

The port grows slice by slice beside the JAX package, which stays the
reference. This package imports ``torch`` and never ``jax`` or anything of
``shuffle_exchange_tpu``. Its entry points run on the card unless the
caller passes ``device="cpu"``; every hand-written kernel has a plain
PyTorch version that runs only for CPU tensors.
"""

__version__ = "0.1.0"


def init_inference(model=None, params=None, config=None, **kwargs):
    """Build a v1 inference engine (JAX ``shuffle_exchange_tpu.init_inference``);
    see :func:`shuffle_exchange_tpu_torch.inference.init_inference`."""
    from .inference.engine import init_inference as _init_inference

    return _init_inference(model=model, params=params, config=config, **kwargs)
