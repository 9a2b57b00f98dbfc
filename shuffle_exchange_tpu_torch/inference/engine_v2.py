"""Paged continuous-batching engine (PyTorch port of ``engine_v2``).

Counterpart of ``shuffle_exchange_tpu/inference/engine_v2.py``: host-side
sequence state and block allocation, and ``step()`` — one continuous-
batching tick that advances every decode row by one token and absorbs a
prefill chunk for every prefilling row. A tick runs one of three
programs, as in JAX: the mixed Dynamic-SplitFuse program, decode only, or
extend only. Within a layer, chunk rows run ``_extend_layer`` (scatter the
chunk's K/V, then the paged extend kernel) and decode rows run
``_decode_layer``: with ``decode_kernel`` resolved to "pallas" (the default
on the card) that is ``_fused_paged_layer`` (the fused QKV+RoPE+append,
split-K attention and fused MLP kernels), with "xla" the layer body over
the paged decode kernel.

Shapes follow the JAX bins exactly (power-of-two row counts and block-table
widths, the serving chunk ladder), so padding rows scribble on the scratch
block just as they do in JAX. The bins matter less here than under XLA —
PyTorch does not compile per shape — but keeping them keeps the two
engines' kernels fed identical operands.

Left for later slices: ``put()`` / ``decode_loop`` and their flash prefill
(ROADMAP queue A, item 2), ``step_sampled``, speculation, prefix caching,
int8/fp8 KV and the KV tier (item 3), adapters and MoE serving.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.transformer import _norm
from ..ops.fused_decode import fused_paged_decode_attention, fused_qkv_rope
from ..ops.paged_attention import paged_decode_attention, paged_extend_attention
from .config import InferenceConfig
from .engine import InferenceEngine, _bucket
from .paged import BlockedAllocator, PagedKVCache, append_token_kv, blocks_needed


@dataclasses.dataclass
class SequenceDescriptor:
    """Host state for one live sequence: the tokens whose K/V are in the
    pool (``seen_tokens``) and the blocks holding them."""

    uid: int
    seen_tokens: int = 0
    blocks: List[int] = dataclasses.field(default_factory=list)


class InferenceEngineV2(InferenceEngine):
    """Paged continuous-batching engine over a ``PagedKVCache``."""

    def __init__(self, model, params, config: Optional[InferenceConfig] = None,
                 device=None):
        super().__init__(model, params, config, device)
        cfg, mcfg = self.config, self._mcfg
        if cfg.max_seq_len % cfg.kv_block_size:
            raise ValueError("max_seq_len must be a multiple of kv_block_size")
        self.cache = PagedKVCache.create(mcfg.n_layers, cfg.num_kv_blocks, cfg.kv_block_size,
                                         mcfg.kv_heads, mcfg.head_dim, cfg.torch_dtype(),
                                         self.device)
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
        """(ok, blocks_from_free_pool, why-not), with named numbers."""
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
        return True, need, ""

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

    # -- layers -----------------------------------------------------------

    def _decode_layer(self, lw, h, ck, cv, pos, tables) -> torch.Tensor:
        """One decode layer (one token per row): the fused layer when the
        decode path is fused, else append the token's K/V into the layer's
        pool view in place and run paged decode attention."""
        if self._decode_kernel == "pallas" and self._fuse_qkv:
            return self._fused_paged_layer(lw, h, ck, cv, pos, tables)

        def attn_fn(q, k, v):
            # ck/cv are views of the stacked pool: the append writes into it
            # in place, where the JAX layer scan rewrites the whole pool as
            # scan outputs every step
            append_token_kv(ck, cv, k[:, 0], v[:, 0], tables, pos)
            return paged_decode_attention(q.contiguous(), ck, cv, tables, pos + 1)

        return self._layer_body(lw, h, pos, attn_fn)

    def _fused_paged_layer(self, lw, h, ck, cv, pos, tables) -> torch.Tensor:
        """One fused decode layer (JAX ``_fused_paged_layer``): ln1 through
        the RMSNorm kernel; the QKV kernel projects, applies RoPE and
        writes the new token's K/V into the layer's pool view in place;
        the split-K kernel attends through the block table; ``_block_tail``
        does the ``wo`` product and the residual and takes the fused MLP.
        A kernel that fails raises: nothing drops to another path."""
        cfg = self._mcfg
        cosr, sinr = self._fused_qkv_args(pos)
        y = _norm(h, lw["ln1_w"], eps=cfg.norm_eps)
        q, _, _ = fused_qkv_rope(y[:, 0], lw["wq"], lw["wk"], lw["wv"], cosr, sinr, ck, cv,
                                 tables, pos, n_heads=cfg.n_heads, kv_heads=cfg.kv_heads)
        attn = fused_paged_decode_attention(q[:, None], ck, cv, tables, pos + 1)
        return self._block_tail(lw, h, attn)

    def _extend_layer(self, lw, h, ck, cv, positions, start, nnew, tables) -> torch.Tensor:
        """One chunked-prefill layer: scatter the chunk's K/V into the
        layer's pool view in place (token i of row b -> block
        tables[b, (start+i)//bs], offset (start+i)%bs; tokens past nnew land
        on the scratch block), then paged extend attention."""
        B, C = h.shape[:2]
        bs = self.cache.block_size

        def attn_fn(q, k, v):
            valid = torch.arange(C, device=h.device)[None, :] < nnew[:, None]
            col = torch.clamp(positions // bs, max=tables.shape[1] - 1)
            blk = tables.clamp_min(0).long().gather(1, col)
            blk = torch.where(valid, blk, torch.full_like(blk, self._scratch))
            off = positions % bs
            KV, Dh = k.shape[2], k.shape[3]
            # index_put_ on the layer's pool view: no copy of the pool
            ck[blk.reshape(-1), :, off.reshape(-1)] = k.reshape(B * C, KV, Dh).to(ck.dtype)
            cv[blk.reshape(-1), :, off.reshape(-1)] = v.reshape(B * C, KV, Dh).to(cv.dtype)
            return paged_extend_attention(q.contiguous(), ck, cv, tables, start, nnew)

        return self._layer_body(lw, h, positions, attn_fn)

    # -- programs -----------------------------------------------------------

    def _to_device(self, *arrays: np.ndarray) -> List[torch.Tensor]:
        return [torch.from_numpy(a).to(self.device) for a in arrays]

    @torch.no_grad()
    def _decode_program(self, tok, pos, tables) -> torch.Tensor:
        x, _ = self._embed_at(tok[:, None], pos)
        for i, lw in enumerate(self._layer_weights):
            x = self._decode_layer(lw, x, self.cache.k[i], self.cache.v[i], pos, tables)
        return self._head(x)[:, 0]

    @torch.no_grad()
    def _extend_program(self, ids, start, nnew, tables) -> torch.Tensor:
        x, positions = self._embed_at(ids, start)
        for i, lw in enumerate(self._layer_weights):
            x = self._extend_layer(lw, x, self.cache.k[i], self.cache.v[i], positions,
                                   start, nnew, tables)
        return self._last_rows_logits(x, nnew)

    @torch.no_grad()
    def _mixed_program(self, dtok, dpos, dtables, pids, pstart, pnnew, ptables):
        """The Dynamic-SplitFuse step: within each layer the decode rows run
        first and then the chunk rows, on the same pool (the JAX layer-scan
        order). Decode and chunk rows are disjoint sequences, so they write
        disjoint blocks."""
        xd, _ = self._embed_at(dtok[:, None], dpos)
        xp, ppos = self._embed_at(pids, pstart)
        for i, lw in enumerate(self._layer_weights):
            ck, cv = self.cache.k[i], self.cache.v[i]
            xd = self._decode_layer(lw, xd, ck, cv, dpos, dtables)
            xp = self._extend_layer(lw, xp, ck, cv, ppos, pstart, pnnew, ptables)
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
        pdescs = []
        for uid, _ in prefills:
            desc = self._seqs.get(uid)
            if desc is None:
                desc = self._seqs[uid] = SequenceDescriptor(uid=uid)
            pdescs.append(desc)
        ddescs = [self._seqs[u] for u in decode_uids]
        for d in ddescs:
            self._ensure_blocks(d, d.seen_tokens + 1)
        for d, (_, chunk) in zip(pdescs, prefills):
            self._ensure_blocks(d, d.seen_tokens + len(chunk))
        return prefills, ddescs, pdescs

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
        if pdescs:
            chunks = [(d, c) for d, (_, c) in zip(pdescs, prefills)]
            cmax = max(len(c) for _, c in chunks)
            Bp, C, Wp, ids, start, nnew, ptables = self._pack_chunks(
                chunks, pad_chunk=self.config.serving.bin_chunk(cmax))
            pargs = self._to_device(ids, start, nnew, ptables)
        if ddescs and pdescs:
            dl, pl = self._mixed_program(*dargs, *pargs)
            key = ("mixed", Bd, Wd, Bp, C, Wp)
            dlogits, plogits = dl.cpu().numpy(), pl.cpu().numpy()
        elif ddescs:
            key = ("decode", Bd, Wd)
            dlogits = self._decode_program(*dargs).cpu().numpy()
        elif pdescs:
            key = ("extend", Bp, C, Wp)
            plogits = self._extend_program(*pargs).cpu().numpy()
        else:
            return dlogits, plogits
        self._program_keys.add(key)
        self.dispatches_by_program[key[0]] += 1
        self.dispatch_count += 1

        for d in ddescs:
            d.seen_tokens += 1
        for d, (_, chunk) in zip(pdescs, prefills):
            d.seen_tokens += len(chunk)
        return dlogits[:len(ddescs)], plogits[:len(pdescs)]

    def flush(self, uids: Sequence[int]) -> None:
        """Free all state of finished sequences."""
        for uid in uids:
            desc = self._seqs.pop(uid, None)
            if desc is None:
                raise ValueError(f"unknown uid {uid}")
            self.allocator.free(desc.blocks)
