"""Test seams (counterpart of ``shuffle_exchange_tpu.testing`` for the
names the port has): fault injection at the adapter pool's fetch site."""

from . import faults  # noqa: F401
from .faults import Fault, InjectedFault  # noqa: F401
