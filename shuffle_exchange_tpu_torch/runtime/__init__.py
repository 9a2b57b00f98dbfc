"""The training runtime of the PyTorch port: the engine, its optimizers,
learning-rate schedules and loss scaler (counterpart of
``shuffle_exchange_tpu/runtime``)."""

from .engine import Engine, TrainState

__all__ = ["Engine", "TrainState"]
