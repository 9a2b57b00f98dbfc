"""Continuous-batching serving scheduler — Dynamic SplitFuse over the
paged engine (PyTorch port).

Counterpart of ``shuffle_exchange_tpu/inference/scheduler.py`` cut to its
core: a FIFO request queue and a running set, and a ``tick()`` that packs a
per-step token budget with one decode token for every running sequence
plus prefill chunks from partially prefilled and queued sequences, then
runs the whole mixed batch as one ``engine.step()``. When the KV pool runs
dry the youngest admitted sequence is preempted: its blocks are freed and
it is requeued at the front with its generated tokens folded into its
prefill target, so greedy decoding replays it exactly. On an MoE engine
expert capacity is an admission resource too: while the previous tick's
peak expert load is over the threshold, queued requests park at their FIFO
seat (policy "park"; running sequences are never preempted for it), as
the JAX scheduler does. With the engine's adapter pool on, a request may
name an adapter (``submit(adapter_id=)``); a queued request whose adapter
cannot be seated beside this tick's other admissions parks at its FIFO
seat until a running sequence releases a slot (park, never preempt), and
the next waiting adapters are staged ahead of their admission.

Speculation, the KV tier, fault sites, the sanitizer, deadlines, the
adapter fleet (``publish_adapter``, affinity, failover) and the monitor
sinks are later slices (ROADMAP queue A).
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from ..utils.logging import logger
from .config import ServingConfig
from .engine_v2 import InferenceEngineV2
from .paged import blocks_needed

QUEUED, PREFILL, RUNNING, FINISHED = "queued", "prefill", "running", "finished"


@dataclasses.dataclass
class ServingRequest:
    """One request's lifecycle (queued -> prefill -> running -> finished,
    with preemption looping running -> queued)."""

    uid: int
    prompt: List[int]
    max_new_tokens: int
    state: str = QUEUED
    prefill_done: int = 0
    generated: List[int] = dataclasses.field(default_factory=list)
    submitted_at: float = 0.0
    first_token_at: Optional[float] = None
    last_token_at: Optional[float] = None
    finished_at: Optional[float] = None
    tpot_s: List[float] = dataclasses.field(default_factory=list)
    preemptions: int = 0
    # parked on expert-capacity pressure: held at its FIFO seat until the
    # running ticks drain it (park, never preempt)
    moe_waiting: bool = False
    # the adapter this request decodes under (None: the base model), and
    # whether it is parked waiting for an adapter pool slot
    adapter_id: Optional[str] = None
    adapter_waiting: bool = False

    @property
    def prefill_target(self) -> List[int]:
        """The prompt plus everything generated so far: what must be in the
        pool before the next decode (a preempted request replays it)."""
        return self.prompt + self.generated

    @property
    def done(self) -> bool:
        return len(self.generated) >= self.max_new_tokens


class ContinuousBatchingScheduler:
    """Queue + running set + per-tick token-budget packing over an
    :class:`InferenceEngineV2`; greedy decoding. ``on_token(uid, tok)``
    streams output."""

    def __init__(self, engine: InferenceEngineV2,
                 on_token: Optional[Callable[[int, int], None]] = None,
                 clock: Callable[[], float] = time.perf_counter):
        if not isinstance(engine, InferenceEngineV2):
            raise TypeError("ContinuousBatchingScheduler needs the paged "
                            f"InferenceEngineV2, got {type(engine).__name__}")
        self.engine = engine
        self.cfg: ServingConfig = engine.config.serving
        self.queue: Deque[ServingRequest] = deque()   # FIFO; preempted at front
        self.active: List[ServingRequest] = []         # admission order
        self.requests: Dict[int, ServingRequest] = {}
        self.on_token = on_token
        self.clock = clock
        self.ticks = 0
        self.preemptions = 0
        self.moe_capacity_parks = 0
        self.moe_unparks = 0
        # the engine's adapter pool (None unless adapters.enabled), the
        # residency parks and the tokens emitted under each adapter
        self.apool = engine.adapters
        self.adapter_parks = 0
        self.adapter_unparks = 0
        self.adapter_tokens: Dict[str, int] = {}
        self._next_uid = 0

    # -- request intake ------------------------------------------------

    def submit(self, prompt: Sequence[int], max_new_tokens: int = 32,
               uid: Optional[int] = None, adapter_id: Optional[str] = None) -> int:
        """Queue one request; returns its uid. Requests that can never fit
        the engine fail here, with named numbers, and so does an adapter
        the pool does not know (residency is not checked here: a
        registered adapter pages in at admission, or the request parks)."""
        if adapter_id is not None:
            if self.apool is None:
                raise ValueError(f"request names adapter {adapter_id!r} but the adapter pool "
                                 "is disabled (enable config.adapters)")
            if not self.apool.registered(adapter_id):
                raise ValueError(f"adapter {adapter_id!r} is not registered; register it "
                                 "first")
        prompt = list(map(int, prompt))
        if not prompt:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
        eng = self.engine
        total = len(prompt) + max_new_tokens
        if total > eng.config.max_seq_len:
            raise ValueError(f"prompt {len(prompt)} + max_new_tokens {max_new_tokens} = "
                             f"{total} exceeds max_seq_len {eng.config.max_seq_len}")
        usable = eng.allocator.num_blocks - 1   # block 0 is scratch
        need_max = blocks_needed(total, eng.cache.block_size)
        if need_max > usable:
            raise ValueError(
                f"request needs up to {need_max} KV blocks but the pool has "
                f"{usable} usable (num_kv_blocks={eng.allocator.num_blocks} minus "
                f"scratch); raise num_kv_blocks or shorten the request")
        if uid is None:
            while self._next_uid in self.requests or self._next_uid in eng._seqs:
                self._next_uid += 1
            uid = self._next_uid
            self._next_uid += 1
        elif uid in self.requests or uid in eng._seqs:
            raise ValueError(f"uid {uid} is already live")
        r = ServingRequest(uid=uid, prompt=prompt, max_new_tokens=int(max_new_tokens),
                           submitted_at=self.clock(), adapter_id=adapter_id)
        self.requests[uid] = r
        self.queue.append(r)
        return uid

    # -- bookkeeping ---------------------------------------------------

    def _seen(self, r: ServingRequest) -> int:
        d = self.engine._seqs.get(r.uid)
        return d.seen_tokens if d else 0

    def _have_blocks(self, r: ServingRequest) -> int:
        d = self.engine._seqs.get(r.uid)
        return len(d.blocks) if d else 0

    def _preempt(self, r: ServingRequest) -> None:
        """Free a sequence's KV and requeue it at the front; its prefill
        target now includes its generated tokens."""
        if r.uid in self.engine._seqs:
            self.engine.flush([r.uid])
        self.active.remove(r)
        r.state = QUEUED
        r.prefill_done = 0
        r.preemptions += 1
        self.preemptions += 1
        self.queue.appendleft(r)
        logger.info(f"serving: preempted uid {r.uid} ({len(r.generated)} tokens "
                    "generated) — KV pool pressure; requeued at front")

    def _finish(self, r: ServingRequest, now: float) -> None:
        r.state = FINISHED
        r.finished_at = now
        if r.uid in self.engine._seqs:
            self.engine.flush([r.uid])
        if r in self.active:
            self.active.remove(r)

    def _emit(self, r: ServingRequest, tok: int, now: float) -> None:
        r.generated.append(tok)
        if r.first_token_at is None:
            r.first_token_at = now
        elif r.last_token_at is not None:
            r.tpot_s.append(now - r.last_token_at)
        r.last_token_at = now
        if r.adapter_id is not None:
            self.adapter_tokens[r.adapter_id] = self.adapter_tokens.get(r.adapter_id, 0) + 1
        if self.on_token is not None:
            self.on_token(r.uid, tok)
        if r.done:
            self._finish(r, now)

    # -- the scheduling loop -------------------------------------------

    def tick(self) -> bool:
        """Pack one token-budget step and run it as one ``engine.step()``.
        Returns True while admitted or queued work remains."""
        eng, cfg = self.engine, self.cfg
        bs = eng.cache.block_size

        # 1) decode set: one budget slot per running sequence; preempt the
        # youngest admitted sequence until the pool can fund the decodes
        def decode_need(rs):
            return sum(max(0, blocks_needed(self._seen(r) + 1, bs) - self._have_blocks(r))
                       for r in rs)

        while True:
            decodes = [r for r in self.active if r.state == RUNNING]
            if decode_need(decodes) <= eng.free_blocks or not self.active:
                break
            self._preempt(self.active[-1])

        budget_left = cfg.token_budget - len(decodes)
        free_left = eng.free_blocks - decode_need(decodes)

        # 2) fill the remainder with prefill chunks: partially prefilled
        # actives first (admission order), then FIFO admission from the
        # queue while the running cap and the pool allow. Strict
        # head-of-line order keeps admission starvation-free.
        prefills: List[Tuple[ServingRequest, List[int]]] = []
        admitted: List[ServingRequest] = []
        for r in [a for a in self.active if a.state == PREFILL] + list(self.queue):
            if budget_left <= 0:
                break
            from_queue = r.state == QUEUED
            if from_queue and r.adapter_id is not None and self.apool is not None:
                # can the pool seat this request's adapter beside everything
                # admitted this tick? If not, park in place: it keeps its
                # FIFO seat, younger work may pass it, and no running
                # sequence is preempted for an adapter slot (the acquire
                # happens at the admission commit below)
                want = [a.adapter_id for a in admitted] + [r.adapter_id]
                if not self.apool.can_acquire_all(want)[0]:
                    if not r.adapter_waiting:
                        r.adapter_waiting = True
                        self.adapter_parks += 1
                    continue
            if from_queue and eng._moe_serving and cfg.moe.overload_policy == "park" and \
                    (self.active or admitted) and \
                    eng.moe_pressure() > cfg.moe.overload_threshold:
                # the previous tick's routing ran some expert past its
                # buffer: hold new sequences at their FIFO seat while the
                # running ones drain it ("drop" admits and lets the
                # capacity route drop the overflow)
                if not r.moe_waiting:
                    r.moe_waiting = True
                    self.moe_capacity_parks += 1
                continue
            if from_queue and len(self.active) + len(admitted) >= cfg.max_running:
                break
            target = r.prefill_target
            if from_queue:
                pd, free_have = 0, 0
            else:
                pd, free_have = r.prefill_done, self._have_blocks(r)
            remaining = len(target) - pd
            chunk = min(budget_left, remaining)
            # a leftover sliver that does not finish the prompt is not
            # worth a slot — wait for a fuller tick
            if chunk < remaining and chunk < cfg.chunk_min:
                break
            fit = (free_left + free_have) * bs - pd
            chunk = min(chunk, fit)
            if chunk <= 0 or (chunk < remaining and chunk < cfg.chunk_min):
                break
            free_left -= max(0, blocks_needed(pd + chunk, bs) - free_have)
            budget_left -= chunk
            prefills.append((r, target[pd:pd + chunk]))
            if from_queue:
                admitted.append(r)
                if r.adapter_waiting:
                    r.adapter_waiting = False
                    self.adapter_unparks += 1
                if r.moe_waiting:
                    r.moe_waiting = False
                    self.moe_unparks += 1
        for r in admitted:
            self.queue.remove(r)
            self.active.append(r)
            r.state = PREFILL
            r.prefill_done = 0
            # admit in the engine now, the adapter bound first: the
            # descriptor is born with its slot pinned, so this tick's chunk
            # already runs under the adapter
            if r.adapter_id is not None:
                eng.configure_adapter(r.uid, r.adapter_id)
            eng.acquire_prefix(r.uid, r.prefill_target)

        # 3) nothing packable?
        if not decodes and not prefills:
            if not (self.active or self.queue):
                return False
            if any(r.moe_waiting or r.adapter_waiting for r in self.queue):
                return True     # parked (expert pressure, adapter slots): running rows free them
            head = next((r for r in self.active if r.state == PREFILL),
                        self.queue[0] if self.queue else None)
            if head is None:
                return True
            raise RuntimeError(
                f"serving stalled: uid {head.uid} needs "
                f"{blocks_needed(len(head.prefill_target), bs)} KV blocks for its "
                f"prefill but only {eng.free_blocks} of {eng.allocator.num_blocks} "
                f"are free and nothing is running to release more; raise "
                f"num_kv_blocks or lower max_running")

        # 4) one dispatch for the whole tick
        self.ticks += 1
        dlogits, plogits = eng.step([r.uid for r in decodes],
                                    [r.generated[-1] for r in decodes],
                                    [(r.uid, c) for r, c in prefills])

        # 5) decode tokens stream now; a finished prefill yields the
        # sequence's next token (its first for a fresh request)
        now = self.clock()
        for i, r in enumerate(decodes):
            self._emit(r, int(np.argmax(dlogits[i])), now)
        for i, (r, chunk) in enumerate(prefills):
            r.prefill_done += len(chunk)
            if r.prefill_done == len(r.prefill_target):
                r.state = RUNNING
                self._emit(r, int(np.argmax(plogits[i])), now)
        if self.apool is not None:
            # stage the next waiting adapters' planes into host buffers a
            # tick ahead of the admission that installs them
            depth, staged, seen = max(0, eng.config.adapters.prefetch_depth), 0, set()
            for r in self.queue:
                if staged >= depth:
                    break
                aid = r.adapter_id
                if aid is None or aid in seen or self.apool.slot_of(aid) is not None:
                    continue
                self.apool.prefetch(aid)
                seen.add(aid)
                staged += 1
        return bool(self.active or self.queue)

    def drain(self) -> None:
        while self.tick():
            pass

    def serve(self, requests: Sequence[Union[Sequence[int], Tuple[Sequence[int], int]]],
              max_new_tokens: int = 32,
              arrivals: Optional[Sequence[float]] = None,
              adapter_ids: Optional[Sequence[Optional[str]]] = None) -> Dict[int, List[int]]:
        """Serve requests to completion. ``requests``: prompts, or
        ``(prompt, max_new)`` pairs. ``arrivals``: optional arrival offsets
        in seconds — request i is submitted once ``clock() - t0 >=
        arrivals[i]``; None submits everything up front. ``adapter_ids``:
        per-request adapter names (None entries serve the base model).
        Returns ``{uid: generated tokens}`` in submission order."""
        items = []
        for req in requests:
            if (isinstance(req, tuple) and len(req) == 2
                    and not isinstance(req[1], (list, np.ndarray))):
                items.append((list(req[0]), int(req[1])))
            else:
                items.append((list(req), int(max_new_tokens)))
        if arrivals is not None and len(arrivals) != len(items):
            raise ValueError("arrivals must align with requests")
        if adapter_ids is not None and len(adapter_ids) != len(items):
            raise ValueError("adapter_ids must align with requests")
        pending = deque(enumerate(items))
        t0 = self.clock()
        uids: List[int] = []
        while pending or self.active or self.queue:
            while pending and (arrivals is None
                               or self.clock() - t0 >= arrivals[pending[0][0]]):
                i, (prompt, mn) = pending.popleft()
                uids.append(self.submit(prompt, max_new_tokens=mn, adapter_id=(
                    None if adapter_ids is None else adapter_ids[i])))
            if not self.tick() and pending and arrivals is not None:
                wait = arrivals[pending[0][0]] - (self.clock() - t0)
                if wait > 0:
                    time.sleep(wait)
        return {uid: self.requests[uid].generated for uid in uids}

    # -- observability --------------------------------------------------

    def stats(self) -> Dict[str, object]:
        """Serving summary over finished requests: sustained tokens/s (wall
        span from first submit to last finish), TTFT/TPOT percentiles,
        ticks and preemptions; with the adapter pool on, its counters, the
        residency parks and the tokens emitted under each adapter (None
        when it is off); and on an MoE engine the routed traffic, last
        tick's expert pressure and the capacity parks (None on a dense
        engine)."""

        def pct(xs, q):
            return float(np.percentile(xs, q)) if len(xs) else None

        eng = self.engine
        done = [r for r in self.requests.values() if r.state == FINISHED]
        ttft = [r.first_token_at - r.submitted_at for r in done
                if r.first_token_at is not None]
        tpot = [t for r in done for t in r.tpot_s]
        total = sum(len(r.generated) for r in done)
        span = (max(r.finished_at for r in done)
                - min(r.submitted_at for r in done)) if done else 0.0
        return {
            "queue_depth": len(self.queue),
            "running": len(self.active),
            "requests": len(done),
            "generated_tokens": total,
            "sustained_tokens_per_sec": (total / span) if span > 0 else None,
            "ttft_p50_s": pct(ttft, 50),
            "ttft_p95_s": pct(ttft, 95),
            "tpot_p50_s": pct(tpot, 50),
            "tpot_p95_s": pct(tpot, 95),
            "ticks": self.ticks,
            "preemptions": self.preemptions,
            "adapters": (None if self.apool is None else {
                **self.apool.stats(),
                "parks": self.adapter_parks,
                "unparks": self.adapter_unparks,
                "waiting": sum(1 for r in self.queue if r.adapter_waiting),
                "tokens_by_adapter": dict(self.adapter_tokens),
            }),
            "moe": (None if not eng._moe_serving else {
                "dispatched": eng.moe_dispatched,
                "dropped": eng.moe_dropped,
                "expert_load_max": eng.moe_expert_load_max,
                "pressure": eng.moe_pressure(),
                "capacity_parks": self.moe_capacity_parks,
                "unparks": self.moe_unparks,
                "waiting": sum(1 for r in self.queue if r.moe_waiting),
            }),
        }
