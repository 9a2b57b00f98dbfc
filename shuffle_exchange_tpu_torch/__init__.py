"""shuffle_exchange_tpu_torch — the PyTorch and CUDA port of
``shuffle_exchange_tpu`` for NVIDIA Hopper.

The port grows slice by slice beside the JAX package, which stays the
reference. This package imports ``torch`` and never ``jax`` or anything of
``shuffle_exchange_tpu``. Its entry points run on the card unless the
caller passes ``device="cpu"``; every hand-written kernel has a plain
PyTorch version that runs only for CPU tensors.
"""

from typing import Any, Callable, Optional

__version__ = "0.1.0"


def initialize(
    args=None,
    model: Any = None,
    optimizer=None,
    model_parameters=None,
    training_data=None,
    lr_scheduler=None,
    distributed_port: int = 29500,
    mpu=None,
    dist_init_required: Optional[bool] = None,
    collate_fn=None,
    config=None,
    mesh_param=None,
    config_params=None,
    # fork kwargs (the decentralized weight sync)
    shuffle_step: Optional[int] = None,
    rings: Optional[int] = None,
    method: Optional[str] = None,
    slice_count: Optional[int] = None,
    # extras
    loss_fn: Optional[Callable] = None,
    params: Any = None,
    seed: int = 0,
    device=None,
):
    """Initialize the training engine (JAX ``shuffle_exchange_tpu.initialize``,
    the same signature plus ``device``). Returns ``(engine, optimizer,
    dataloader, lr_scheduler)``; the dataloader is None until the data
    pipeline is ported.

    ``model`` may be an object with ``init`` and ``loss(params, batch, rng)``
    (the port's ``Transformer``: weights it already holds are the start,
    otherwise they are drawn from ``seed`` on the device), or a dict of
    parameters by flattened name with ``loss_fn`` passed separately (or
    ``model=None`` with ``params`` and ``loss_fn``). ``config`` is a dict or
    JSON path in the reference's format. The engine runs on the card unless
    ``device="cpu"``.
    """
    import torch

    from .config import ConfigError, SXConfig
    from .ops.dispatch import resolve_device
    from .runtime.engine import Engine

    fork = {"shuffle_step": shuffle_step, "rings": rings, "method": method,
            "slice_count": slice_count}
    given = sorted(k for k, v in fork.items() if v is not None)
    if given:
        raise NotImplementedError(
            f"initialize({', '.join(given)}=...): the decentralized weight sync "
            "(shuffle-exchange) is not in the PyTorch port yet: ROADMAP queue A, item 11")
    if training_data is not None or collate_fn is not None:
        raise NotImplementedError(
            "initialize(training_data=..., collate_fn=...): the engine-owned dataloader is not "
            "in the PyTorch port yet: ROADMAP queue A, item 14; pass batches to train_batch()")
    if mpu is not None or mesh_param is not None:
        raise NotImplementedError("initialize(mpu=..., mesh_param=...): parallel layouts are "
                                  "not in the PyTorch port yet: ROADMAP queue A, item 12")
    if config is None and config_params is not None:
        config = config_params
    if config is None and args is not None and getattr(args, "deepspeed_config", None) is not None:
        config = args.deepspeed_config

    device = resolve_device(device)
    cfg = SXConfig.load(config, world_size=1)

    resolved = params
    if model is not None and hasattr(model, "loss"):
        mcfg = getattr(model, "config", None)
        if mcfg is not None:   # structures that serve but do not train refuse here
            from .models.transformer import check_supported

            check_supported(mcfg)
        if resolved is None:
            if getattr(model, "has_params", lambda: False)():
                resolved = model.params()
            else:
                gen = torch.Generator(device=device).manual_seed(seed)
                resolved = model.init(gen, dtype=torch.float32, device=device)
        loss_fn = loss_fn or model.loss
    elif model is not None and loss_fn is not None and resolved is None:
        resolved = model      # the model argument was a parameter dict
    if resolved is None or loss_fn is None:
        raise ConfigError("initialize() needs a model object (init+loss) or params + loss_fn")

    engine = Engine(config=cfg, loss_fn=loss_fn, params=resolved, optimizer=optimizer,
                    lr_scheduler=lr_scheduler, device=device)
    if model is not None and hasattr(model, "loss"):
        engine.module = model
    return engine, engine.tx, engine.training_dataloader, engine.lr_schedule


def init_inference(model=None, params=None, config=None, **kwargs):
    """Build a v1 inference engine (JAX ``shuffle_exchange_tpu.init_inference``);
    see :func:`shuffle_exchange_tpu_torch.inference.init_inference`."""
    from .inference.engine import init_inference as _init_inference

    return _init_inference(model=model, params=params, config=config, **kwargs)
