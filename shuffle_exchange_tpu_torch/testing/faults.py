"""Fault-injection seam (PyTorch port, the part the serving path reaches).

Counterpart of ``shuffle_exchange_tpu/testing/faults.py`` cut to what the
adapter pool's ``adapter_fetch`` site needs: ``arm`` a fault, ``clear``
and list the ``armed`` ones, and ``maybe_crash`` at a site. When no fault
is armed a site costs one module-level boolean check (``ACTIVE``). A
fault is one-shot: after it trips it disarms. ``fire_nth=N`` stays silent
for the first N - 1 matching checks and trips on the Nth, so a schedule
reproduces run after run.

Sites (``Fault.site``):

- ``adapter_fetch`` — kill an adapter pool's miss-path ``acquire`` after
  the victim slot is chosen and before anything is mutated
  (``inference/adapters.py``): residency, refcounts, free slots and
  counters stay as they were.

The other sites of the JAX package (checkpointing, training, the serving
fleet), their options (``byte_offset``, ``once=False``) and the
environment arming (``SXT_FAULTS``) come with the modules that check them
(ROADMAP queue A, item 14).
"""

from __future__ import annotations

import dataclasses
import threading
from typing import List


class InjectedFault(Exception):
    """Raised at an armed fault site (simulates a crash)."""


SITES = ("adapter_fetch",)


@dataclasses.dataclass
class Fault:
    site: str
    fire_nth: int = 1                   # trip on the Nth matching check
    checks: int = 0                     # matching checks seen so far

    def __post_init__(self):
        if self.site not in SITES:
            raise ValueError(f"unknown fault site {self.site!r}; known: {SITES}")
        if self.fire_nth < 1:
            raise ValueError(f"fire_nth must be >= 1, got {self.fire_nth}")


_PLAN: List[Fault] = []
#: guards _PLAN and the per-fault check counters
_MU = threading.Lock()
ACTIVE = False   # fast-path gate: every site checks this first, lock-free


def _update_active() -> None:
    global ACTIVE
    ACTIVE = bool(_PLAN)


def arm(site: str, fire_nth: int = 1) -> Fault:
    """Arm one fault at ``site``; returns it."""
    f = Fault(site, fire_nth=fire_nth)
    with _MU:
        _PLAN.append(f)
        _update_active()
    return f


def clear() -> None:
    with _MU:
        _PLAN.clear()
        _update_active()


def armed() -> List[Fault]:
    with _MU:
        return list(_PLAN)


def _trip(site: str) -> bool:
    """Whether the armed fault at ``site`` trips now (it disarms as it
    does). A fault armed with ``fire_nth=N`` absorbs its first N - 1
    checks silently."""
    with _MU:
        for f in _PLAN:
            if f.site == site:
                f.checks += 1
                if f.checks < f.fire_nth:
                    return False
                _PLAN.remove(f)
                _update_active()
                return True
    return False


def maybe_crash(site: str, exc=InjectedFault) -> None:
    """Raise ``exc`` when a fault is armed at ``site``."""
    if ACTIVE and _trip(site):
        raise exc(f"injected crash at {site}")
