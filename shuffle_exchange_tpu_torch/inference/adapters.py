"""Paged multi-tenant LoRA adapter pool (PyTorch port).

Counterpart of ``shuffle_exchange_tpu/inference/adapters.py``: a
fixed-slot device pool of rank-padded LoRA factor pairs that a
mixed-adapter batch gathers from per row inside the serving step
(``ops/lora_gemm.lora_delta``). Slot indices are data riding the sequence
descriptors; the pool's device planes keep one shape whatever adapters
are loaded, so a warmed server admits new adapter ids without a new
program shape.

The pool behaves as JAX's does, slot numbers and counters included:

- **Slot 0 is the all-zeros null adapter**: rows without an adapter
  gather it and add an exact ``0.0``. The device planes carry ``slots`` +
  1 slots.
- **Content-keyed registration**: the raw padded factors are digested;
  re-registering identical bytes is a no-op, changed bytes bump the
  adapter's version and rewrite its slot when it is resident.
- **Refcounted residency with LRU paging**: ``acquire`` pins an adapter's
  slot for a running sequence; a miss takes the last free slot or evicts
  the least recently used resident with no references; when every slot is
  pinned the pool is dry (``AdapterPoolDry``) and the scheduler parks the
  request: park, never preempt.
- **Prefetch staging**: ``prefetch`` copies an adapter's padded planes
  into host buffers (pinned when the pool lives on the card) under
  recycled stage ids, so the install of a predicted miss is one
  non-blocking host-to-device copy.
- **Scaling folded at registration**: stored B is ``B * (alpha / r)`` and
  ranks are zero-padded to ``max_rank``.

The device planes are the engine's serving dtype on the engine's device.
An install writes the slot of each plane in place, on the current stream,
so programs already issued read the old factors and later ones the new
(JAX swaps whole arrays instead). A stage's pinned buffers are refilled
only after the copies that read them have run (an event per stage).

All mutable state rides one ``threading.Lock``. Fault site:
``adapter_fetch`` fires in a miss-path ``acquire`` after the victim is
chosen and before anything is mutated, so a crashed fetch leaves
residency, refcounts and device slots as they were.
"""

from __future__ import annotations

import dataclasses
import hashlib
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.dispatch import resolve_device
from ..testing import faults

NULL_SLOT = 0

#: the attention projections the pool serves (the serving delta seam lives
#: in the engine's attention layer body)
SUPPORTED_TARGETS = ("wq", "wk", "wv", "wo")


class AdapterPoolDry(RuntimeError):
    """Every pool slot is pinned by a running sequence: the scheduler parks
    the requesting sequence until a release frees a slot."""


def target_dims(tcfg, target: str) -> Tuple[int, int]:
    """(d_in, d_out) of one attention projection: the base matmul the
    adapter delta parallels."""
    q_dim = tcfg.n_heads * tcfg.head_dim
    kv_dim = tcfg.kv_heads * tcfg.head_dim
    return {
        "wq": (tcfg.d_model, q_dim),
        "wk": (tcfg.d_model, kv_dim),
        "wv": (tcfg.d_model, kv_dim),
        "wo": (q_dim, tcfg.d_model),
    }[target]


def pool_bytes(tcfg, slots: int, max_rank: int,
               targets: Sequence[str] = SUPPORTED_TARGETS,
               bytes_per_elem: int = 4) -> int:
    """Device bytes of a pool geometry (slots and the null slot, padded
    factor pairs over all layers and targets), computed without building
    a pool."""
    total = 0
    for t in targets:
        din, dout = target_dims(tcfg, t)
        total += tcfg.n_layers * (slots + 1) * max_rank * (din + dout)
    return total * bytes_per_elem


@dataclasses.dataclass
class _Resident:
    """One occupied device slot: which adapter, how many running sequences
    pin it, and which content version is installed."""

    adapter_id: str
    slot: int
    refs: int
    version: int


class AdapterPool:
    """Fixed-slot device pool of padded LoRA factor pairs.

    Device layout (per target ``t``): ``a[t]`` is [L, S, d_in, R] and
    ``b[t]`` is [L, S, R, d_out] with S = ``slots`` + 1 and R =
    ``max_rank``; layer i's views ``a[t][i]`` / ``b[t][i]`` are the
    contiguous [S, d_in, R] / [S, R, d_out] stacks the kernel takes. The
    planes live on the card unless ``device="cpu"`` is passed."""

    def __init__(self, tcfg, slots: int, max_rank: int,
                 targets: Sequence[str] = SUPPORTED_TARGETS,
                 prefetch_depth: int = 1, dtype: torch.dtype = torch.float32,
                 device=None):
        for t in targets:
            if t not in SUPPORTED_TARGETS:
                raise ValueError(f"adapters: unsupported target {t!r} "
                                 f"(supported: {SUPPORTED_TARGETS})")
        if slots < 1:
            raise ValueError("adapters: slots must be >= 1")
        if max_rank < 1:
            raise ValueError("adapters: max_rank must be >= 1")
        self.tcfg = tcfg
        self.slots = int(slots)
        self.max_rank = int(max_rank)
        self.targets = tuple(targets)
        self.prefetch_depth = int(prefetch_depth)
        self.dtype = dtype
        self.device = resolve_device(device)
        self._mu = threading.Lock()
        L, S, R = tcfg.n_layers, self.slots + 1, self.max_rank
        self.a: Dict[str, torch.Tensor] = {}
        self.b: Dict[str, torch.Tensor] = {}
        for t in self.targets:
            din, dout = target_dims(tcfg, t)
            self.a[t] = torch.zeros((L, S, din, R), dtype=dtype, device=self.device)
            self.b[t] = torch.zeros((L, S, R, dout), dtype=dtype, device=self.device)
        # aid -> {target: (A_pad [L, din, R], B_pad [L, R, dout])}: the f32
        # host copies the device slots fetch from
        self._host: Dict[str, Dict[str, Tuple[np.ndarray, np.ndarray]]] = {}
        self._digest: Dict[str, str] = {}
        self._version: Dict[str, int] = {}
        # residency: the insertion order of _resident IS the LRU order (an
        # acquire hit re-inserts)
        self._resident: Dict[str, _Resident] = {}
        self._free_slots: List[int] = list(range(1, S))
        # prefetch staging under recycled stage ids (never adapter ids), the
        # host buffers of each stage allocated once
        self._staged: Dict[str, List[torch.Tensor]] = {}
        self._stage_ids: Dict[str, int] = {}
        self._free_stages: List[int] = []
        self._next_stage = 0
        self._buffers: Dict[Tuple[int, int], torch.Tensor] = {}
        self._stage_events: Dict[int, torch.cuda.Event] = {}
        # counters (the scheduler's stats()["adapters"] reads these)
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.installs = 0
        self.prefetches = 0
        self.prefetch_hits = 0
        self.prefetch_misses = 0

    # -- registration (content-keyed) ----------------------------------

    def _pad_factors(self, factors, alpha) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
        """Validate and normalize ``{target: (A, B)}`` (2-D factors tied over
        the layers or 3-D [L, ...] ones) into padded [L, din, R] / [L, R,
        dout] f32 host planes with alpha / r folded into B."""
        L, R = self.tcfg.n_layers, self.max_rank
        out = {}
        for t, (A, B) in factors.items():
            if t not in self.targets:
                raise ValueError(f"adapters: target {t!r} not in pool targets {self.targets}")
            A = np.asarray(A)
            B = np.asarray(B)
            if A.ndim == 2:
                A = np.broadcast_to(A, (L,) + A.shape)
            if B.ndim == 2:
                B = np.broadcast_to(B, (L,) + B.shape)
            din, dout = target_dims(self.tcfg, t)
            r = A.shape[-1]
            if A.shape != (L, din, r) or B.shape != (L, r, dout):
                raise ValueError(f"adapters: {t} factors have shapes {A.shape}/{B.shape}, want "
                                 f"[L={L}, {din}, r]/[L, r, {dout}]")
            if r > R:
                raise ValueError(f"adapters: {t} rank {r} exceeds pool max_rank {R}")
            scale = (alpha / r) if alpha is not None else 1.0
            A_pad = np.zeros((L, din, R), np.float32)
            B_pad = np.zeros((L, R, dout), np.float32)
            A_pad[:, :, :r] = A
            B_pad[:, :r, :] = B * scale   # the padded rows of B stay 0
            out[t] = (A_pad, B_pad)
        return out

    def register(self, adapter_id: str, factors, alpha=None,
                 version: Optional[int] = None) -> int:
        """Make ``adapter_id`` known to the pool (host side; residency is
        ``acquire``'s business). ``factors`` maps target -> (A, B) numpy
        arrays. Identical bytes are a no-op; changed bytes bump the version
        and, when the adapter is resident, rewrite its device slot so
        running sequences pick up the new factors at their next step.
        Returns the version."""
        if not adapter_id:
            raise ValueError("adapters: adapter_id must be non-empty")
        padded = self._pad_factors(factors, alpha)
        h = hashlib.blake2b(digest_size=16)
        for t in sorted(padded):
            A_pad, B_pad = padded[t]
            h.update(t.encode())
            h.update(A_pad.tobytes())
            h.update(B_pad.tobytes())
        digest = h.hexdigest()
        with self._mu:
            if self._digest.get(adapter_id) == digest and version is None:
                return self._version[adapter_id]
            self._host[adapter_id] = padded
            self._digest[adapter_id] = digest
            self._version[adapter_id] = (version if version is not None
                                         else self._version.get(adapter_id, 0) + 1)
            self._release_staging(adapter_id)   # staged bytes are stale
            res = self._resident.get(adapter_id)
            if res is not None:
                self._install(adapter_id, res.slot)
                res.version = self._version[adapter_id]
            return self._version[adapter_id]

    def registered(self, adapter_id: str) -> bool:
        with self._mu:
            return adapter_id in self._host

    def version(self, adapter_id: str) -> Optional[int]:
        with self._mu:
            return self._version.get(adapter_id)

    # -- residency -----------------------------------------------------

    def _planes(self, adapter_id: str) -> List[np.ndarray]:
        """The host planes of every pool target in order (zeros for a
        target the adapter does not adapt)."""
        planes = []
        for t in self.targets:
            pair = self._host[adapter_id].get(t)
            if pair is None:
                L, R = self.tcfg.n_layers, self.max_rank
                din, dout = target_dims(self.tcfg, t)
                pair = (np.zeros((L, din, R), np.float32), np.zeros((L, R, dout), np.float32))
            planes.extend(pair)
        return planes

    def _install(self, adapter_id: str, slot: int,
                 staged: Optional[List[torch.Tensor]] = None) -> None:
        """Write ``adapter_id``'s padded planes into device slot ``slot``
        (from the prefetch staging when given: a non-blocking copy from
        pinned memory on the card). The caller holds ``_mu``."""
        if staged is None:
            planes = [torch.from_numpy(p) for p in self._planes(adapter_id)]
        else:
            planes = staged
        it = iter(planes)
        for t in self.targets:
            for plane in (self.a[t], self.b[t]):
                src = next(it).to(self.device, non_blocking=staged is not None)
                plane[:, slot].copy_(src)      # the f32 -> serving dtype cast on the device
        self.installs += 1

    def acquire(self, adapter_id: str) -> int:
        """Pin ``adapter_id`` resident and return its device slot.

        Hit: bump the refcount and the recency. Miss: take a free slot, else
        evict the LRU resident with no references; when every slot is
        pinned raise :class:`AdapterPoolDry` (nothing was mutated). The
        fault site fires before any mutation as well."""
        with self._mu:
            if adapter_id not in self._host:
                raise KeyError(f"adapters: {adapter_id!r} is not registered")
            res = self._resident.get(adapter_id)
            if res is not None:
                self.hits += 1
                res.refs += 1
                self._resident.pop(adapter_id)      # refresh recency
                self._resident[adapter_id] = res
                return res.slot
            victim = None
            if not self._free_slots:
                for aid, r in self._resident.items():   # LRU first
                    if r.refs == 0:
                        victim = aid
                        break
                if victim is None:
                    raise AdapterPoolDry(f"adapters: all {self.slots} slots pinned "
                                         f"({sorted(self._resident)}) — cannot load "
                                         f"{adapter_id!r}")
            if faults.ACTIVE:
                faults.maybe_crash("adapter_fetch")
            self.misses += 1
            if victim is not None:
                self._free_slots.append(self._resident.pop(victim).slot)
                self.evictions += 1
            slot = self._free_slots.pop()
            staged = self._staged.get(adapter_id)
            if staged is not None:
                self.prefetch_hits += 1
            else:
                self.prefetch_misses += 1
            self._install(adapter_id, slot, staged=staged)
            if staged is not None and self.device.type == "cuda":
                # the stage's buffers are refilled only after these copies ran
                ev = torch.cuda.Event()
                ev.record()
                self._stage_events[self._stage_ids[adapter_id]] = ev
            self._release_staging(adapter_id)       # consumed
            self._resident[adapter_id] = _Resident(adapter_id=adapter_id, slot=slot, refs=1,
                                                   version=self._version[adapter_id])
            return slot

    def release(self, adapter_id: str) -> None:
        """Unpin one reference. The adapter STAYS resident at refs == 0,
        warm for a re-acquire, until LRU eviction reclaims its slot."""
        with self._mu:
            res = self._resident.get(adapter_id)
            if res is None or res.refs <= 0:
                raise RuntimeError(f"adapters: release of {adapter_id!r} without a matching "
                                   "acquire")
            res.refs -= 1

    def can_acquire(self, adapter_id: str) -> bool:
        """True iff an ``acquire`` now would succeed (resident, or a slot is
        free or evictable). Mutates nothing."""
        with self._mu:
            if adapter_id not in self._host:
                return False
            if adapter_id in self._resident or self._free_slots:
                return True
            return any(r.refs == 0 for r in self._resident.values())

    def can_acquire_all(self, adapter_ids) -> Tuple[bool, str]:
        """Would pinning ALL of ``adapter_ids`` (duplicates collapsed)
        succeed now? Residents with no references that the batch itself
        re-acquires are NOT counted evictable, so a mixed batch cannot pass
        by planning to evict its own hits. Mutates nothing; ``(ok, why)``
        with ``why`` naming the dry pool on refusal."""
        with self._mu:
            batch = {a for a in adapter_ids if a is not None}
            for aid in batch:
                if aid not in self._host:
                    return False, f"adapter {aid!r} is not registered"
            need = {a for a in batch if a not in self._resident}
            evictable = sum(1 for aid, r in self._resident.items()
                            if r.refs == 0 and aid not in batch)
            cap = len(self._free_slots) + evictable
            if len(need) > cap:
                return False, (f"adapter pool dry: batch needs {len(need)} new slot(s) for "
                               f"{sorted(need)} but only {cap} of {self.slots} are free or "
                               "evictable")
            return True, ""

    def slot_of(self, adapter_id: str) -> Optional[int]:
        with self._mu:
            res = self._resident.get(adapter_id)
            return res.slot if res is not None else None

    def resident_ids(self) -> List[str]:
        """Resident adapter ids, LRU-oldest first."""
        with self._mu:
            return list(self._resident)

    # -- prefetch ------------------------------------------------------

    def _buffer(self, stage: int, i: int, shape) -> torch.Tensor:
        """Host staging buffer ``i`` of ``stage`` (pinned when the pool is
        on the card), allocated at its first use."""
        buf = self._buffers.get((stage, i))
        if buf is None:
            buf = torch.empty(shape, dtype=torch.float32,
                              pin_memory=self.device.type == "cuda")
            self._buffers[(stage, i)] = buf
        return buf

    def prefetch(self, adapter_id: str) -> bool:
        """Stage ``adapter_id``'s padded planes into host buffers so the
        eventual acquire-miss install copies from them. Depth-bounded; True
        when a staging now exists."""
        with self._mu:
            if adapter_id not in self._host or adapter_id in self._resident:
                return False
            if adapter_id in self._staged:
                return True
            while len(self._staged) >= max(1, self.prefetch_depth):
                evicted = next(iter(self._staged))
                self._staged.pop(evicted)
                self._free_stages.append(self._stage_ids.pop(evicted))
            if self._free_stages:
                stage = self._free_stages.pop()
            else:
                stage = self._next_stage
                self._next_stage += 1
            ev = self._stage_events.pop(stage, None)
            if ev is not None:
                ev.synchronize()        # an install may still be reading these buffers
            staged = []
            for i, p in enumerate(self._planes(adapter_id)):
                buf = self._buffer(stage, i, p.shape)
                buf.numpy()[...] = p
                staged.append(buf)
            self._staged[adapter_id] = staged
            self._stage_ids[adapter_id] = stage
            self.prefetches += 1
            return True

    def _release_staging(self, adapter_id: str) -> None:
        """Return ``adapter_id``'s stage, if any, to the free list. The
        caller holds ``_mu``."""
        committed = self._staged.pop(adapter_id, None) is not None
        stage = self._stage_ids.pop(adapter_id, None)
        if committed and stage is not None:
            self._free_stages.append(stage)

    # -- engine operands -----------------------------------------------

    def device_operands(self):
        """Per-target (A-stack, B-stack) device planes with leading L."""
        with self._mu:
            return {"a": dict(self.a), "b": dict(self.b)}

    # -- observability -------------------------------------------------

    def stats(self) -> Dict[str, object]:
        with self._mu:
            return {
                "slots": self.slots,
                "resident": len(self._resident),
                "pinned": sum(1 for r in self._resident.values() if r.refs > 0),
                "registered": len(self._host),
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "installs": self.installs,
                "prefetches": self.prefetches,
                "prefetch_hits": self.prefetch_hits,
                "prefetch_misses": self.prefetch_misses,
            }
