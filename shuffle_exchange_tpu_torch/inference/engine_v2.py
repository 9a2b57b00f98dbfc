"""Paged continuous-batching engine (PyTorch port of ``engine_v2``).

Counterpart of ``shuffle_exchange_tpu/inference/engine_v2.py``: host-side
sequence state and block allocation; ``step()`` — one continuous-batching
tick that advances every decode row by one token and absorbs a prefill
chunk for every prefilling row, in one of three programs as in JAX (the
mixed Dynamic-SplitFuse program, decode only, or extend only); ``put()`` —
the sequential serving step: every new uid through one batched prefill
program (each layer scatters the prompts' K/V into their blocks and runs
the flash attention kernel over the prompts), single-token extensions
through the decode program and longer ones through block-sized extend
chunks; and ``decode_loop()`` — ``n_steps`` greedy decode programs with
the argmax fed back on the device and one copy to the host at the end. Within a layer, chunk rows run ``_extend_layer`` (scatter the
chunk's K/V, then the paged extend kernel) and decode rows run
``_decode_layer``: with ``decode_kernel`` resolved to "pallas" (the default
on the card) that is ``_fused_paged_layer`` (the fused QKV+RoPE+append,
split-K attention and fused MLP kernels), with "xla" the layer body over
the paged decode kernel. Quantized attention weights leave the fused QKV
kernel, as in JAX: under "pallas" their decode rows run the layer body
with the quantized matmul for q/k/v/wo, the row append, the split-K
attention (JAX's "attention-only fusion") and the fused quantized MLP.

Shapes follow the JAX bins exactly (power-of-two row counts and block-table
widths, the serving chunk ladder), so padding rows scribble on the scratch
block just as they do in JAX. The bins matter less here than under XLA —
PyTorch does not compile per shape — but keeping them keeps the two
engines' kernels fed identical operands, and the MoE capacity route's
capacity, which counts the padded rows, equal to JAX's.

MoE serving (JAX ``engine_v2``'s expert-capacity serving): every program
arms a routing tap that the shared ``_ffn`` fills with each layer's expert
counts and dropped assignments on the device; after the program the tap
folds to [L, E] (the lanes of a mixed program summed per layer) and is
read on the host once, beside the logits, into the counters
``moe_dispatched``, ``moe_dropped`` and ``moe_expert_load_max`` and the
previous-tick load that ``moe_pressure()`` and the admission read. On one
card the experts stay whole (JAX's ``_shard_expert_weights`` is a no-op at
an expert axis of 1).

Multi-tenant LoRA serving (JAX ``engine_v2``'s adapter pool): with
``adapters.enabled`` the engine holds an ``AdapterPool`` and every
descriptor a pinned slot (0, the all-zeros null adapter, for rows without
one). Every program then passes each lane's slots [B] (an int32 tensor on
the device, padding rows on slot 0) with the layer's factor stacks down to
the layer body, where the LoRA kernel adds each row's delta to the
adapted projections; decode rows skip the fused QKV kernel for it (the
fused decode layer is not used) and keep the split-K attention and the
fused MLP, as in JAX. An adapter is pinned when its sequence is admitted
(``configure_adapter`` binds it beforehand; ``put()`` and ``step()`` pin
a call's new adapters before any other state changes and release them if
that fails) and released at ``flush``. Adapter residency is the third
admission resource, after KV blocks and ``max_seq_len``.

int8/fp8 KV (JAX ``kv_cache_dtype``): the pool stores one byte an element
beside f32 scale planes, and each of the three pool writes quantizes on
write: the prefill's scatter (its attention still reads the prompt's own
full-precision K/V, so one-shot ``put()`` logits equal bf16 mode's), the
chunk scatter of ``_extend_layer`` (the chunk then reads itself back
dequantized) and the decode append. The fused decode layer takes JAX's
quantized form: the QKV kernel without a pool (its in-kernel append would
write raw projections without a scale), the quantizing append, then the
split-K kernel over the planes. The paged kernels read the pool at
storage width and dequantize in registers.

Left for later slices: ``step_sampled``, speculation, prefix caching and
``fork`` and the KV tier (ROADMAP queue A, item 3) and expert parallelism
(item 12).
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.transformer import _norm
from ..moe.gating import compute_capacity
from ..ops.flash_attention import flash_attention
from ..ops.fused_decode import fused_paged_decode_attention, fused_qkv_rope
from ..ops.paged_attention import paged_decode_attention, paged_extend_attention
from .adapters import AdapterPool
from .config import InferenceConfig
from .engine import InferenceEngine, Lora, _bucket, qkv_quantized
from .paged import (BlockedAllocator, PagedKVCache, append_token_kv, blocks_needed, kv_parts,
                    write_blocks, write_rows)


def _pool_operands(ck, cv, tables, lens):
    """The attention wrappers' leading pool operands: the data planes of a
    layer's K/V parts, the tables and the lengths."""
    return kv_parts(ck)[0], kv_parts(cv)[0], tables, lens


def _scales(ck, cv) -> dict:
    """The wrappers' scale-plane keywords (none for a bf16 pool)."""
    ks, vs = kv_parts(ck)[1], kv_parts(cv)[1]
    return {} if ks is None else dict(k_scale=ks, v_scale=vs)


@dataclasses.dataclass
class SequenceDescriptor:
    """Host state for one live sequence: the tokens whose K/V are in the
    pool (``seen_tokens``), the blocks holding them, and the f32 logits at
    its latest position (``last_logits`` [V], set by every program that
    advances it)."""

    uid: int
    seen_tokens: int = 0
    blocks: List[int] = dataclasses.field(default_factory=list)
    last_logits: Optional[np.ndarray] = None
    # the adapter this sequence decodes under and its pinned pool slot
    # (slot 0: the all-zeros null adapter, an exact no-op)
    adapter_id: Optional[str] = None
    adapter_slot: int = 0


class InferenceEngineV2(InferenceEngine):
    """Paged continuous-batching engine over a ``PagedKVCache``."""

    paged = True

    def __init__(self, model, params, config: Optional[InferenceConfig] = None,
                 device=None):
        super().__init__(model, params, config, device)
        cfg, mcfg = self.config, self._mcfg
        if cfg.max_seq_len % cfg.kv_block_size:
            raise ValueError("max_seq_len must be a multiple of kv_block_size")
        self.cache = PagedKVCache.create(mcfg.n_layers, cfg.num_kv_blocks, cfg.kv_block_size,
                                         mcfg.kv_heads, mcfg.head_dim, cfg.torch_dtype(),
                                         self.device, kv_cache_dtype=cfg.kv_cache_dtype)
        self.allocator = BlockedAllocator(cfg.num_kv_blocks)
        # block 0 is scratch: padding table entries and padding rows
        # scribble here, and it is never read unmasked
        self._scratch = self.allocator.allocate(1)[0]
        self._seqs: Dict[int, SequenceDescriptor] = {}
        self._max_blocks = cfg.max_seq_len // cfg.kv_block_size
        # ticks dispatched (one per step() that ran a program), and by
        # program: the scheduler's one-dispatch-per-tick contract and the
        # kernel-launch accounting in chip_smoke.py read these
        self.dispatch_count = 0
        self.dispatches_by_program: Dict[str, int] = collections.Counter()
        # distinct program shapes dispatched (the shape-bin ladder's footprint)
        self._program_keys: set = set()
        # MoE serving: the routing tap and the moe/* counters
        self._moe_serving = mcfg.n_experts > 0
        self._moe_tap: Optional[list] = None   # armed per program; _ffn appends
        self.moe_dispatched = 0        # expert assignments routed (post-drop)
        self.moe_dropped = 0           # assignments dropped at expert capacity
        self.moe_expert_load_max = 0   # peak per-(layer, expert) load seen
        self._moe_last_counts: Optional[np.ndarray] = None   # [E] worst layer, last tick
        self._moe_last_total = 0       # S*k of the last tick (capacity denominator)
        if self._moe_serving:
            mo = cfg.serving.moe
            # "auto" defers to the model config's moe_impl; an explicit
            # serving impl wins
            self._moe_impl_override = None if mo.moe_impl == "auto" else mo.moe_impl
            self._moe_cf_override = mo.capacity_factor
        # multi-tenant LoRA: the adapter pool (its planes in the serving
        # dtype on the engine's device), each layer's views of them, and
        # the bindings of uids not admitted yet
        self.adapters: Optional[AdapterPool] = None
        self._adapter_layers: List[Dict[str, Dict[str, torch.Tensor]]] = []
        self._pending_adapter: Dict[int, str] = {}
        if cfg.adapters.enabled:
            ac = cfg.adapters
            self.adapters = AdapterPool(mcfg, slots=ac.slots, max_rank=ac.max_rank,
                                        targets=ac.targets, prefetch_depth=ac.prefetch_depth,
                                        dtype=cfg.torch_dtype(), device=self.device)
            ops = self.adapters.device_operands()
            self._adapter_layers = [{k: {t: v[i] for t, v in ops[k].items()} for k in ("a", "b")}
                                    for i in range(mcfg.n_layers)]

    # -- scheduling queries -------------------------------------------

    @property
    def free_blocks(self) -> int:
        return self.allocator.free_blocks

    @property
    def program_shapes(self) -> frozenset:
        return frozenset(self._program_keys)

    def query(self, uid: int) -> Tuple[int, int]:
        """(max further tokens for uid, free blocks)."""
        desc = self._seqs.get(uid)
        seen = desc.seen_tokens if desc else 0
        have = len(desc.blocks) * self.cache.block_size if desc else 0
        headroom = (have - seen) + self.allocator.free_blocks * self.cache.block_size
        return min(self.config.max_seq_len - seen, headroom), self.allocator.free_blocks

    def can_schedule(self, uids: Sequence[int], lengths: Sequence[int]) -> bool:
        return self._admission_detail(uids, lengths)[0]

    def _admission_detail(self, uids: Sequence[int],
                          lengths: Sequence[int]) -> Tuple[bool, int, str]:
        """(ok, blocks_from_free_pool, why-not), with named numbers.

        The checks on new uids (adapter residency, expert pressure) serve
        ``put()`` and direct ``step()`` callers. The scheduler gates its
        admissions in ``tick()`` and creates each descriptor through
        ``acquire_prefix`` before the tick's ``step()``, as JAX's does, so
        by then its uids are known and only the KV check applies."""
        bs = self.cache.block_size
        need, worst_uid, worst_ask = 0, None, -1
        for uid, n in zip(uids, lengths):
            desc = self._seqs.get(uid)
            seen = desc.seen_tokens if desc else 0
            have = len(desc.blocks) if desc else 0
            if seen + n > self.config.max_seq_len:
                return False, 0, (
                    f"uid {uid} would overrun max_seq_len: {seen} seen + {n} "
                    f"new > {self.config.max_seq_len} (split the request or "
                    f"raise max_seq_len)")
            ask = max(0, blocks_needed(seen + n, bs) - have)
            need += ask
            if ask > worst_ask:
                worst_uid, worst_ask = uid, ask
        if need > self.allocator.free_blocks:
            return False, need, (
                f"needs {need} KV blocks, {self.allocator.free_blocks} free "
                f"(largest single ask: uid {worst_uid} wants {worst_ask} new); "
                f"flush finished sequences or raise num_kv_blocks")
        if self.adapters is not None:
            # adapter residency, the third resource: a batch whose pending
            # adapters cannot all be pinned is refused before any change,
            # naming the adapter pool (not KV), so the scheduler parks
            want = [self._pending_adapter[u] for u in uids
                    if self._seqs.get(u) is None and u in self._pending_adapter]
            if want:
                aok, awhy = self.adapters.can_acquire_all(want)
                if not aok:
                    return False, need, (
                        f"adapter pool (KV is fine: {need} blocks needed, "
                        f"{self.allocator.free_blocks} free): {awhy}; park until a running "
                        f"sequence releases its slot")
        if self._moe_serving and any(self._seqs.get(u) is None for u in uids):
            # expert capacity: when the previous tick's routing saturated
            # some expert's buffer, new sequences are refused (known uids
            # always pass: their ticks drain the pressure)
            mo = self.config.serving.moe
            pr = self.moe_pressure()
            if mo.overload_policy == "park" and self._seqs and pr > mo.overload_threshold:
                return False, need, (
                    f"expert capacity (KV is fine: {need} blocks needed, "
                    f"{self.allocator.free_blocks} free): last tick's peak "
                    f"expert ran at {pr:.2f}x capacity (threshold "
                    f"{mo.overload_threshold:g}, policy park); hold new "
                    f"sequences until routing pressure drains")
        return True, need, ""

    # -- MoE routing counts --------------------------------------------

    def _moe_arm(self) -> None:
        """Arm the routing tap for one program (``_ffn`` appends one entry
        per layer and lane); a no-op on dense models."""
        self._moe_tap = [] if self._moe_serving else None

    def _moe_fold(self, lanes: int = 1):
        """Close the tap: (counts [L, E] int32, dropped [L] f32) on the
        device, the lanes of each layer summed (JAX ``_moe_ys``); None on
        dense models."""
        tap, self._moe_tap = self._moe_tap, None
        if tap is None:
            return None
        L = self._mcfg.n_layers
        assert len(tap) == L * lanes, \
            f"the routing tap holds {len(tap)} entries for {L} layers x {lanes} lanes"
        counts = torch.stack([c for c, _ in tap]).reshape(L, lanes, -1).sum(1)
        dropped = torch.stack([d.float() for _, d in tap]).reshape(L, lanes).sum(1)
        return counts, dropped

    def _pop_moe(self, folded) -> None:
        """Read one dispatch's folded routing counts on the host (one copy a
        program) into the per-tick accounting."""
        if folded is not None:
            self._note_moe_counts((folded[0].cpu().numpy(), folded[1].cpu().numpy()))

    def _note_moe_counts(self, moe) -> None:
        """Host-side accounting from one dispatch's routing counts ``moe =
        (counts [..., L, E], dropped [..., L])`` (a leading steps axis from
        ``decode_loop``): the moe/* counters and the previous-tick load
        snapshot ``moe_pressure`` reads. Counts are post-drop (capacity) or
        pre-drop with no drops (ragged), so ``counts.sum() + dropped``
        recovers S*k either way."""
        E = self._mcfg.n_experts
        counts = np.asarray(moe[0]).reshape(-1, E)
        dropped = np.asarray(moe[1], np.float64).reshape(-1)
        self.moe_dispatched += int(counts.sum())
        self.moe_dropped += int(round(float(dropped.sum())))
        self.moe_expert_load_max = max(self.moe_expert_load_max, int(counts.max()))
        self._moe_last_counts = counts.max(axis=0)
        self._moe_last_total = int(round(float(counts[-1].sum() + dropped[-1])))

    def moe_pressure(self) -> float:
        """The previous tick's peak per-expert load over that tick's expert
        capacity (1/capacity_factor under balanced routing; > 1 means some
        expert ran past its buffer). 0.0 before the first MoE tick and on
        dense models."""
        if not self._moe_serving or self._moe_last_counts is None:
            return 0.0
        k = max(1, self._mcfg.moe_top_k)
        S = max(1, self._moe_last_total // k)
        cap = compute_capacity(S, self._mcfg.n_experts, k, self._moe_cf_override)
        return float(self._moe_last_counts.max()) / float(max(1, cap))

    def _ensure_blocks(self, desc: SequenceDescriptor, total_tokens: int) -> None:
        """Grow ``desc`` to cover ``total_tokens``."""
        need = blocks_needed(total_tokens, self.cache.block_size) - len(desc.blocks)
        if need > 0:
            desc.blocks.extend(self.allocator.allocate(need))

    def _table(self, desc: SequenceDescriptor, width: Optional[int] = None) -> np.ndarray:
        """Block-table row for one sequence, scratch-padded to ``width``."""
        width = self._max_blocks if width is None else width
        assert len(desc.blocks) <= width, (desc.uid, len(desc.blocks), width)
        t = np.full((width,), self._scratch, dtype=np.int32)
        t[:len(desc.blocks)] = desc.blocks
        return t

    def _binned_width(self, nblocks: int) -> int:
        """Power-of-two block-table width covering ``nblocks``, capped at
        the max_seq_len table."""
        return min(_bucket(max(1, int(nblocks)), minimum=1), self._max_blocks)

    def _pack_decode(self, descs: List[SequenceDescriptor], toks: Sequence[int]):
        """(B, W, tok, pos, tables) for a one-token decode batch; blocks must
        already cover seen + 1."""
        W = self._binned_width(max(len(d.blocks) for d in descs))
        B = _bucket(len(descs), minimum=1)
        tok = np.zeros((B,), np.int32)
        pos = np.zeros((B,), np.int32)
        tables = np.full((B, W), self._scratch, np.int32)
        for i, (d, t) in enumerate(zip(descs, toks)):
            tok[i], pos[i] = t, d.seen_tokens
            tables[i] = self._table(d, W)
        return B, W, tok, pos, tables

    def _pack_chunks(self, batch: List[Tuple[SequenceDescriptor, List[int]]],
                     pad_chunk: Optional[int] = None):
        """(B, C, W, ids, start, nnew, tables) for a chunked-prefill batch;
        blocks must already cover seen + len(chunk)."""
        cmax = max(len(c) for _, c in batch)
        C = pad_chunk if pad_chunk is not None else _bucket(cmax, minimum=1)
        assert C >= cmax, (C, cmax)
        W = self._binned_width(max(len(d.blocks) for d, _ in batch))
        B = _bucket(len(batch), minimum=1)
        ids = np.zeros((B, C), np.int32)
        start = np.zeros((B,), np.int32)
        nnew = np.ones((B,), np.int32)
        tables = np.full((B, W), self._scratch, np.int32)
        for i, (d, chunk) in enumerate(batch):
            ids[i, :len(chunk)] = chunk
            start[i] = d.seen_tokens
            nnew[i] = len(chunk)
            tables[i] = self._table(d, W)
        return B, C, W, ids, start, nnew, tables

    def _pack_prefill(self, prefills: List[Tuple[SequenceDescriptor, List[int]]]):
        """(P, tpad, ids, plen, btables) for the batched prefill program;
        allocates each descriptor's blocks. tpad is a power of two of at
        least one block, capped at max_seq_len; P a power of two."""
        bs = self.cache.block_size
        tmax = max(len(toks) for _, toks in prefills)
        tpad = max(bs, _bucket(tmax, minimum=bs))
        tpad = min(-(-tpad // bs) * bs, self.config.max_seq_len)
        nblk_pad = tpad // bs
        P = _bucket(len(prefills), minimum=1)
        ids = np.zeros((P, tpad), np.int32)
        plen = np.ones((P,), np.int32)
        btables = np.full((P, nblk_pad), self._scratch, np.int32)
        for i, (desc, toks) in enumerate(prefills):
            T = len(toks)
            self._ensure_blocks(desc, T)
            ids[i, :T] = toks
            plen[i] = T
            btables[i, :len(desc.blocks)] = desc.blocks[:nblk_pad]
        return P, tpad, ids, plen, btables

    # -- layers -----------------------------------------------------------

    def _decode_layer(self, lw, h, ck, cv, pos, tables,
                      lora: Optional[Lora] = None) -> torch.Tensor:
        """One decode layer (one token per row): the fused layer when the
        decode path is fused, the QKV fuses (not GPT-J's interleaved RoPE),
        the attention weights are dense and no adapter operands ride the
        call, else append the token's K/V into the layer's pool view in
        place and run the split-K decode kernel (fused path: JAX's
        attention-only fusion) or the paged decode kernel. ck/cv are the
        layer's pool views, or (data, scale) pairs of a quantized pool."""
        fused = self._decode_kernel == "pallas"
        if fused and self._fuse_qkv and not qkv_quantized(lw) and lora is None:
            return self._fused_paged_layer(lw, h, ck, cv, pos, tables)

        def attn_fn(q, k, v):
            # ck/cv are views of the stacked pool: the append writes into it
            # in place, where the JAX layer scan rewrites the whole pool as
            # scan outputs every step
            append_token_kv(ck, cv, k[:, 0], v[:, 0], tables, pos)
            attend = fused_paged_decode_attention if fused else paged_decode_attention
            # fused: JAX's attention-only fusion
            return attend(q.contiguous(), *_pool_operands(ck, cv, tables, pos + 1),
                          alibi_slopes=self._alibi, **_scales(ck, cv))

        return self._layer_body(lw, h, pos, attn_fn, lora=lora)

    def _fused_paged_layer(self, lw, h, ck, cv, pos, tables) -> torch.Tensor:
        """One fused decode layer (JAX ``_fused_paged_layer``): ln1 (through
        the RMSNorm kernel, or plain layernorm); the QKV kernel projects,
        adds the q/k/v biases, applies RoPE (none for learned positions and
        ALiBi) and writes the new token's K/V into the layer's pool view in
        place; the split-K kernel attends through the block table, with the
        ALiBi slopes; ``_block_tail`` does the ``wo`` product, its bias and
        the residual(s) and takes the fused MLP when the model's MLP fuses
        (on ln1's y, without a norm, under a shared layernorm). A
        kernel that fails raises: nothing drops to another path. On a
        quantized pool the QKV kernel runs without a pool and the
        quantizing append writes the token's rows and scales (JAX's form:
        the in-kernel append would store raw projections without a
        scale)."""
        cfg = self._mcfg
        cosr, sinr, bias = self._fused_qkv_args(lw, pos)
        y = _norm(h, lw["ln1_w"], lw.get("ln1_b"), cfg.norm, eps=cfg.norm_eps)
        heads = dict(n_heads=cfg.n_heads, kv_heads=cfg.kv_heads, **bias)
        if self.cache.quantized:
            q, k, v = fused_qkv_rope(y[:, 0], lw["wq"], lw["wk"], lw["wv"], cosr, sinr, **heads)
            append_token_kv(ck, cv, k, v, tables, pos)
        else:
            q, _, _ = fused_qkv_rope(y[:, 0], lw["wq"], lw["wk"], lw["wv"], cosr, sinr, ck, cv,
                                     tables, pos, **heads)
        attn = fused_paged_decode_attention(q[:, None], *_pool_operands(ck, cv, tables, pos + 1),
                                            alibi_slopes=self._alibi, **_scales(ck, cv))
        return self._block_tail(lw, h, y, attn)

    def _extend_layer(self, lw, h, ck, cv, positions, start, nnew, tables,
                      lora: Optional[Lora] = None) -> torch.Tensor:
        """One chunked-prefill layer: scatter the chunk's K/V into the
        layer's pool view in place (token i of row b -> block
        tables[b, (start+i)//bs], offset (start+i)%bs; tokens past nnew land
        on the scratch block; a quantized pool quantizes each row on write),
        then paged extend attention, which reads the chunk back from the
        pool (dequantized, on a quantized pool)."""
        B, C = h.shape[:2]
        bs = self.cache.block_size

        def attn_fn(q, k, v):
            valid = torch.arange(C, device=h.device)[None, :] < nnew[:, None]
            col = torch.clamp(positions // bs, max=tables.shape[1] - 1)
            blk = tables.clamp_min(0).long().gather(1, col)
            blk = torch.where(valid, blk, torch.full_like(blk, self._scratch))
            off = positions % bs
            KV, Dh = k.shape[2], k.shape[3]
            # index_put_ on the layer's pool views: no copy of the pool
            write_rows(ck, cv, k.reshape(B * C, KV, Dh), v.reshape(B * C, KV, Dh),
                       blk.reshape(-1), off.reshape(-1))
            return paged_extend_attention(q.contiguous(), *_pool_operands(ck, cv, tables, start),
                                          nnew, alibi_slopes=self._alibi, **_scales(ck, cv))

        return self._layer_body(lw, h, positions, attn_fn, lora=lora)

    # -- programs -----------------------------------------------------------

    def _to_device(self, *arrays: np.ndarray) -> List[torch.Tensor]:
        return [torch.from_numpy(a).to(self.device) for a in arrays]

    def _aslots(self, descs, B: int) -> Optional[torch.Tensor]:
        """A lane's adapter slots [B] int32 on the device, padding rows on
        the null slot; None when the pool is off. Slot values are data:
        which adapters a batch names never changes a program's shapes."""
        if self.adapters is None:
            return None
        s = np.zeros((B,), np.int32)
        for i, d in enumerate(descs):
            s[i] = d.adapter_slot
        return torch.from_numpy(s).to(self.device)

    def _lora(self, i: int, aslots: Optional[torch.Tensor]) -> Optional[Lora]:
        """Layer i's adapter operands for a lane with slots ``aslots``."""
        return None if aslots is None else (self._adapter_layers[i], aslots)

    @torch.no_grad()
    def _decode_program(self, tok, pos, tables, aslots=None) -> torch.Tensor:
        self._moe_arm()
        x, _ = self._embed_at(tok[:, None], pos)
        for i, lw in enumerate(self._layer_weights):
            x = self._decode_layer(lw, x, *self.cache.layer(i), pos, tables,
                                   lora=self._lora(i, aslots))
        return self._head(x)[:, 0]

    @torch.no_grad()
    def _extend_program(self, ids, start, nnew, tables, aslots=None) -> torch.Tensor:
        self._moe_arm()
        x, positions = self._embed_at(ids, start)
        for i, lw in enumerate(self._layer_weights):
            x = self._extend_layer(lw, x, *self.cache.layer(i), positions,
                                   start, nnew, tables, lora=self._lora(i, aslots))
        return self._last_rows_logits(x, nnew)

    @torch.no_grad()
    def _prefill_program(self, ids, plen, btables, aslots=None) -> torch.Tensor:
        """The batched prefill (JAX ``_paged_prefill_impl``): ids [P, tpad]
        right-padded prompts from position 0, plen [P], btables [P,
        tpad // bs] (scratch-padded). Each layer scatters every row's K/V
        into its blocks of the layer's pool view in place (padding rows
        and padding blocks land on the scratch block; a quantized pool
        quantizes each row on write and scatters its scales) and attends
        through the flash attention kernel over the rows' own
        full-precision K/V, causally. Returns f32 logits [P, V] at each
        row's ``plen - 1``."""
        self._moe_arm()
        P = ids.shape[0]
        flat = btables.reshape(-1).long()
        x, positions = self._embed_at(ids, torch.zeros(P, dtype=torch.int32,
                                                       device=ids.device))
        for i, lw in enumerate(self._layer_weights):
            ck, cv = self.cache.layer(i)

            def attn_fn(q, k, v, ck=ck, cv=cv):
                write_blocks(ck, k, flat)
                write_blocks(cv, v, flat)
                return flash_attention(q, k, v, causal=True, alibi_slopes=self._alibi)

            x = self._layer_body(lw, x, positions, attn_fn, lora=self._lora(i, aslots))
        return self._last_rows_logits(x, plen)

    @torch.no_grad()
    def _mixed_program(self, dtok, dpos, dtables, pids, pstart, pnnew, ptables,
                       daslots=None, paslots=None):
        """The Dynamic-SplitFuse step: within each layer the decode rows run
        first and then the chunk rows, on the same pool (the JAX layer-scan
        order). Decode and chunk rows are disjoint sequences, so they write
        disjoint blocks. Each lane carries its own adapter slots."""
        self._moe_arm()
        xd, _ = self._embed_at(dtok[:, None], dpos)
        xp, ppos = self._embed_at(pids, pstart)
        for i, lw in enumerate(self._layer_weights):
            ck, cv = self.cache.layer(i)
            xd = self._decode_layer(lw, xd, ck, cv, dpos, dtables, lora=self._lora(i, daslots))
            xp = self._extend_layer(lw, xp, ck, cv, ppos, pstart, pnnew, ptables,
                                    lora=self._lora(i, paslots))
        return self._head(xd)[:, 0], self._last_rows_logits(xp, pnnew)

    def _last_rows_logits(self, x: torch.Tensor, nnew: torch.Tensor) -> torch.Tensor:
        idx = (nnew.long() - 1)[:, None, None].expand(-1, 1, x.shape[-1])
        return self._head(torch.gather(x, 1, idx))[:, 0]

    # -- the tick -------------------------------------------------------------

    def _admit_step(self, decode_uids, decode_tokens, prefills):
        """Validate, admit the whole tick before any state mutation, then
        create descriptors for new prefill uids and ensure every
        participant's blocks."""
        prefills = [(u, list(map(int, c))) for u, c in prefills]
        if len(decode_uids) != len(decode_tokens):
            raise ValueError("decode_uids and decode_tokens must align")
        all_uids = list(decode_uids) + [u for u, _ in prefills]
        if len(set(all_uids)) != len(all_uids):
            raise ValueError("duplicate uid in one step(): a sequence is either "
                             "decoding or prefilling in a tick, never both")
        for uid in decode_uids:
            if uid not in self._seqs:
                raise ValueError(f"decode uid {uid} unknown — prefill it first "
                                 "(step(prefills=...))")
        for uid, chunk in prefills:
            if not chunk:
                raise ValueError(f"prefill uid {uid} with an empty chunk")
        ok, _, why = self._admission_detail(
            all_uids, [1] * len(decode_uids) + [len(c) for _, c in prefills])
        if not ok:
            raise RuntimeError(f"cannot schedule step(): {why}")
        # pin this tick's new adapters first, residents first, so a miss's
        # LRU eviction never takes a slot a hit of the same batch pins
        order = [(uid, self._pending_adapter[uid]) for uid, _ in prefills
                 if uid not in self._seqs and uid in self._pending_adapter]
        if order:
            order.sort(key=lambda t: self.adapters.slot_of(t[1]) is None)
        abind = self._pin_adapters(order)
        pdescs = []
        for uid, _ in prefills:
            desc = self._seqs.get(uid)
            if desc is None:
                desc = self._new_descriptor(uid, abind)
            pdescs.append(desc)
        ddescs = [self._seqs[u] for u in decode_uids]
        for d in ddescs:
            self._ensure_blocks(d, d.seen_tokens + 1)
        for d, (_, chunk) in zip(pdescs, prefills):
            self._ensure_blocks(d, d.seen_tokens + len(chunk))
        return prefills, ddescs, pdescs

    def _pin_adapters(self, order: Sequence[Tuple[int, str]]) -> Dict[int, Tuple[str, int]]:
        """Acquire the adapter of each (uid, adapter id) in ``order``; if one
        acquire fails, release the ones made and raise (nothing changes).
        Returns {uid: (adapter id, slot)}."""
        abind: Dict[int, Tuple[str, int]] = {}
        done: List[str] = []
        try:
            for uid, aid in order:
                abind[uid] = (aid, self.adapters.acquire(aid))
                done.append(aid)
        except BaseException:
            for aid in done:
                self.adapters.release(aid)
            raise
        return abind

    def _new_descriptor(self, uid: int, abind: Dict[int, Tuple[str, int]]) -> SequenceDescriptor:
        """Create the descriptor of a new uid, bound to its pinned adapter."""
        desc = self._seqs[uid] = SequenceDescriptor(uid=uid)
        if uid in abind:
            desc.adapter_id, desc.adapter_slot = abind[uid]
            self._pending_adapter.pop(uid, None)
        return desc

    def acquire_prefix(self, uid: int, tokens: Sequence[int]) -> int:
        """Admit ``uid`` as JAX ``acquire_prefix`` does with prefix caching
        off (the prefix cache is ROADMAP queue A, item 3): a cold
        descriptor at position 0, its pending adapter pinned first (a dry
        pool raises before anything changes). Returns the cached tokens:
        0."""
        if uid in self._seqs:
            raise ValueError(f"uid {uid} is already live")
        if not len(tokens):
            raise ValueError(f"new uid {uid} with no tokens")
        aid = self._pending_adapter.get(uid)
        self._new_descriptor(uid, self._pin_adapters([(uid, aid)] if aid is not None else []))
        return 0

    def step(self, decode_uids: Sequence[int], decode_tokens: Sequence[int],
             prefills: Sequence[Tuple[int, Sequence[int]]] = ()):
        """One continuous-batching tick: every uid in ``decode_uids``
        advances one token and every ``(uid, chunk)`` in ``prefills`` absorbs
        a prompt chunk (new uids start at position 0), in one program.
        Admission is all-or-nothing before any state changes. Returns
        ``(decode_logits [len(decode_uids), V], prefill_logits
        [len(prefills), V])`` as f32 numpy arrays; prefill logits are at each
        chunk's last token."""
        prefills, ddescs, pdescs = self._admit_step(decode_uids, decode_tokens, prefills)
        V = self._mcfg.vocab_size
        dlogits = np.zeros((0, V), np.float32)
        plogits = np.zeros((0, V), np.float32)
        if ddescs:
            Bd, Wd, tok, pos, dtables = self._pack_decode(ddescs, decode_tokens)
            dargs = self._to_device(tok, pos, dtables)
            dslots = self._aslots(ddescs, Bd)
        if pdescs:
            chunks = [(d, c) for d, (_, c) in zip(pdescs, prefills)]
            cmax = max(len(c) for _, c in chunks)
            Bp, C, Wp, ids, start, nnew, ptables = self._pack_chunks(
                chunks, pad_chunk=self.config.serving.bin_chunk(cmax))
            pargs = self._to_device(ids, start, nnew, ptables)
            pslots = self._aslots(pdescs, Bp)
        if ddescs and pdescs:
            dl, pl = self._mixed_program(*dargs, *pargs, daslots=dslots, paslots=pslots)
            key = ("mixed", Bd, Wd, Bp, C, Wp)
            dlogits, plogits = dl.cpu().numpy(), pl.cpu().numpy()
            self._pop_moe(self._moe_fold(lanes=2))
        elif ddescs:
            key = ("decode", Bd, Wd)
            dlogits = self._decode_program(*dargs, aslots=dslots).cpu().numpy()
            self._pop_moe(self._moe_fold())
        elif pdescs:
            key = ("extend", Bp, C, Wp)
            plogits = self._extend_program(*pargs, aslots=pslots).cpu().numpy()
            self._pop_moe(self._moe_fold())
        else:
            return dlogits, plogits
        self._count_dispatch(key)

        for i, d in enumerate(ddescs):
            d.seen_tokens += 1
            d.last_logits = dlogits[i]
        for i, (d, (_, chunk)) in enumerate(zip(pdescs, prefills)):
            d.seen_tokens += len(chunk)
            d.last_logits = plogits[i]
        return dlogits[:len(ddescs)], plogits[:len(pdescs)]

    def _count_dispatch(self, key: tuple) -> None:
        self._program_keys.add(key)
        self.dispatches_by_program[key[0]] += 1
        self.dispatch_count += 1

    # -- the sequential serving API --------------------------------------

    def put(self, uids: Sequence[int], tokens: Sequence[Sequence[int]]) -> np.ndarray:
        """One engine step (JAX ``put``): new uids are prefilled, known
        uids extended by their new tokens (none: their logits are returned
        as they are). Returns f32 logits [len(uids), V] at each sequence's
        latest position, in order. Admission (lengths and KV blocks, then
        the batch bound) is checked before any state changes: a refused
        call leaves the engine as it was.

        Programs: all new uids in one batched prefill program (P, tpad);
        the single-token extensions in one decode program (the fused
        decode layer under "pallas"); the longer ones in extend programs
        of at most ``kv_block_size`` tokens per sequence, as many as the
        longest needs."""
        if len(uids) != len(tokens):
            raise ValueError("uids and tokens must align")
        if len(set(uids)) != len(uids):
            raise ValueError("duplicate uid in one put() batch: a sequence can "
                             "advance at most one decode position per engine step")
        for uid, toks in zip(uids, tokens):
            if uid not in self._seqs and not len(toks):
                raise ValueError(f"new uid {uid} with no tokens")
        ok, _, why = self._admission_detail(uids, [len(t) for t in tokens])
        if not ok:
            raise RuntimeError(f"cannot schedule put() batch: {why}")
        n_ext = sum(1 for uid, toks in zip(uids, tokens) if uid in self._seqs and len(toks))
        if n_ext > self.config.max_batch_size:
            raise ValueError(f"decode batch {n_ext} exceeds max_batch_size "
                             f"{self.config.max_batch_size} (raise it in the inference config)")
        bs = self.cache.block_size
        # pin the new uids' adapters first, in uid order (JAX admits each
        # new uid through acquire_prefix in that order)
        abind = self._pin_adapters([(u, self._pending_adapter[u]) for u in uids
                                    if u not in self._seqs and u in self._pending_adapter])
        prefills: List[Tuple[SequenceDescriptor, List[int]]] = []
        extends: List[Tuple[SequenceDescriptor, List[int]]] = []
        for uid, toks in zip(uids, tokens):
            toks = list(map(int, toks))
            if uid in self._seqs:
                if toks:
                    extends.append((self._seqs[uid], toks))
            else:
                prefills.append((self._new_descriptor(uid, abind), toks))

        if prefills:
            P, tpad, ids, plen, btables = self._pack_prefill(prefills)
            logits = self._prefill_program(
                *self._to_device(ids, plen, btables),
                aslots=self._aslots([d for d, _ in prefills], P)).cpu().numpy()
            self._pop_moe(self._moe_fold())
            self._count_dispatch(("prefill", P, tpad))
            for i, (desc, toks) in enumerate(prefills):
                desc.seen_tokens = len(toks)
                desc.last_logits = logits[i]

        singles = [(d, toks[0]) for d, toks in extends if len(toks) == 1]
        multis = [(d, toks) for d, toks in extends if len(toks) > 1]
        if singles:
            for d, _ in singles:
                self._ensure_blocks(d, d.seen_tokens + 1)
            B, W, tok, pos, tables = self._pack_decode([d for d, _ in singles],
                                                       [t for _, t in singles])
            logits = self._decode_program(
                *self._to_device(tok, pos, tables),
                aslots=self._aslots([d for d, _ in singles], B)).cpu().numpy()
            self._pop_moe(self._moe_fold())
            self._count_dispatch(("decode", B, W))
            for i, (d, _) in enumerate(singles):
                d.seen_tokens += 1
                d.last_logits = logits[i]

        while any(toks for _, toks in multis):
            batch = []
            for d, toks in multis:
                if toks:
                    batch.append((d, toks[:bs]))
                    del toks[:bs]
            for d, chunk in batch:
                self._ensure_blocks(d, d.seen_tokens + len(chunk))
            B, C, W, ids, start, nnew, tables = self._pack_chunks(batch)
            logits = self._extend_program(
                *self._to_device(ids, start, nnew, tables),
                aslots=self._aslots([d for d, _ in batch], B)).cpu().numpy()
            self._pop_moe(self._moe_fold())
            self._count_dispatch(("extend", B, C, W))
            for i, (d, chunk) in enumerate(batch):
                d.seen_tokens += len(chunk)
                d.last_logits = logits[i]

        return np.stack([self._seqs[uid].last_logits for uid in uids])

    def decode_loop(self, uids: Sequence[int], tokens: Sequence[int],
                    n_steps: int) -> np.ndarray:
        """Greedy-decode ``n_steps`` tokens for known uids (JAX
        ``decode_loop``): ``tokens`` are each sequence's next input token;
        every step runs the decode program and feeds its argmax back on
        the device, with no host synchronisation until the one copy of the
        tokens (and the last logits) at the end. Returns int32 [len(uids),
        n_steps]; the descriptors advance as ``n_steps`` single-token
        ``put()`` calls would move them. Admission is checked before any
        state changes."""
        if len(uids) != len(tokens):
            raise ValueError("uids and tokens must align")
        if len(set(uids)) != len(uids):
            raise ValueError("duplicate uid in one decode_loop() batch")
        for uid in uids:
            if uid not in self._seqs:
                raise ValueError(f"decode_loop uid {uid} unknown — put() its prompt first")
        if int(n_steps) < 1:
            raise ValueError(f"n_steps must be >= 1, got {n_steps}")
        n_steps = int(n_steps)
        descs = [self._seqs[u] for u in uids]
        ok, _, why = self._admission_detail(uids, [n_steps] * len(uids))
        if not ok:
            raise RuntimeError(f"cannot schedule decode_loop: {why}")
        for d in descs:
            self._ensure_blocks(d, d.seen_tokens + n_steps)
        # the table covers exactly the blocks this loop can touch, rounded
        # up to a power of two (the decode kernels walk it to kv_len only)
        W = self._binned_width(max(len(d.blocks) for d in descs))
        tables = np.stack([self._table(d, W) for d in descs]).astype(np.int32)
        pos0 = np.asarray([d.seen_tokens for d in descs], np.int32)
        tok, pos, tables_t = self._to_device(np.asarray(tokens, np.int32), pos0, tables)
        aslots = self._aslots(descs, len(uids))
        out = torch.empty(n_steps, len(uids), dtype=torch.int32, device=self.device)
        routed = []    # per step (counts [L, E], dropped [L]), on the device
        for s in range(n_steps):
            logits = self._decode_program(tok, pos, tables_t, aslots=aslots)
            routed.append(self._moe_fold())
            tok = logits.argmax(-1).to(torch.int32)
            out[s] = tok
            pos = pos + 1
        toks = out.T.cpu().numpy()
        last = logits.cpu().numpy()
        if self._moe_serving:   # one read of [n_steps, L, E] for the loop
            self._pop_moe((torch.stack([c for c, _ in routed]),
                           torch.stack([d for _, d in routed])))
        self._count_dispatch(("decode_loop", len(uids), n_steps, W))
        for i, d in enumerate(descs):
            d.seen_tokens += n_steps
            d.last_logits = last[i]
        return toks

    def configure_adapter(self, uid: int, adapter_id: Optional[str]) -> None:
        """Bind ``adapter_id`` to ``uid`` (JAX ``configure_adapter``). An
        unknown uid gets a PENDING binding, consumed where its admission
        creates the descriptor and pins the slot; a live uid rebinds in
        place, acquiring the new adapter before releasing the old, so a
        failed acquire changes nothing. ``None`` restores the base model
        (the null slot 0)."""
        desc = self._seqs.get(uid)
        if desc is None:
            if adapter_id is None:
                self._pending_adapter.pop(uid, None)
                return
            if self.adapters is None:
                raise RuntimeError("configure_adapter: adapters are disabled (set "
                                   "adapters.enabled in the inference config)")
            if not self.adapters.registered(adapter_id):
                raise KeyError(f"configure_adapter: {adapter_id!r} is not registered — "
                               "publish it first")
            self._pending_adapter[uid] = adapter_id
            return
        if adapter_id == desc.adapter_id:
            return
        if adapter_id is not None:
            if self.adapters is None:
                raise RuntimeError("configure_adapter: adapters are disabled (set "
                                   "adapters.enabled in the inference config)")
            slot = self.adapters.acquire(adapter_id)
        else:
            slot = 0
        if desc.adapter_id is not None:
            self.adapters.release(desc.adapter_id)
        desc.adapter_id, desc.adapter_slot = adapter_id, slot

    def flush(self, uids: Sequence[int]) -> None:
        """Free all state of finished sequences; each one's adapter is
        unpinned and stays resident (warm) until LRU eviction needs its
        slot."""
        for uid in uids:
            desc = self._seqs.pop(uid, None)
            if desc is None:
                raise ValueError(f"unknown uid {uid}")
            self._pending_adapter.pop(uid, None)
            if desc.adapter_id is not None and self.adapters is not None:
                self.adapters.release(desc.adapter_id)
            self.allocator.free(desc.blocks)
