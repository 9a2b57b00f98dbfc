"""Process logging for the PyTorch port.

Counterpart of ``shuffle_exchange_tpu/utils/logging.py``: the same
``logger`` and ``warning_once``, kept as the port's own copy so the port
never imports the JAX package.
"""

from __future__ import annotations

import functools
import logging
import os
import sys

LOG_LEVELS = {
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warning": logging.WARNING,
    "error": logging.ERROR,
    "critical": logging.CRITICAL,
}


@functools.lru_cache(None)
def _create_logger(name: str = "shuffle_exchange_tpu_torch",
                   level: int = logging.INFO) -> logging.Logger:
    lg = logging.getLogger(name)
    lg.setLevel(level)
    lg.propagate = False
    if not lg.handlers:
        handler = logging.StreamHandler(stream=sys.stdout)
        handler.setFormatter(logging.Formatter(
            "[%(asctime)s] [%(levelname)s] [%(name)s] %(message)s",
            datefmt="%H:%M:%S"))
        lg.addHandler(handler)
    return lg


logger = _create_logger(level=LOG_LEVELS.get(
    os.environ.get("SXT_LOG_LEVEL", "info").lower(), logging.INFO))


def warning_once(message: str) -> None:
    _warn_once(message)


@functools.lru_cache(None)
def _warn_once(message: str) -> None:
    logger.warning(message)
