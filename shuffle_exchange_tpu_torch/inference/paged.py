"""Paged KV cache: the block allocator and the device block pool.

Counterpart of ``shuffle_exchange_tpu/inference/paged.py`` without the
prefix registry (content keys, the cached-free LRU) and without int8/fp8
storage, which later slices port (ROADMAP queue A, item 3).

The pool is ``[L, num_blocks, KV, block_size, Dh]``; ``cache.k[i]`` is a
view of layer i, and every write into the pool is an in-place
``index_put_`` on that view. The JAX layer scan instead rewrites the whole
pool as scan outputs on every step (``engine_v2.py`` measured those copies
at about a fifth of TPU decode time); here no pool copy is ever made.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Sequence

import torch


class BlockedAllocator:
    """Ref-counted free list over ``num_blocks`` KV blocks (host side):
    ``allocate`` hands out blocks at refcount 1, ``retain`` shares them,
    ``free`` drops one reference and returns a block at refcount 0.
    Freeing a block that is not held raises, and a bad call mutates
    nothing."""

    def __init__(self, num_blocks: int):
        if num_blocks <= 0:
            raise ValueError("num_blocks must be positive")
        self.num_blocks = num_blocks
        self._free: List[int] = list(range(num_blocks))
        self._ref: Dict[int, int] = {}

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def live_blocks(self) -> int:
        return len(self._ref)

    @property
    def shared_blocks(self) -> int:
        return sum(1 for c in self._ref.values() if c > 1)

    def ref_count(self, block: int) -> int:
        return self._ref.get(block, 0)

    def allocate(self, n: int) -> List[int]:
        if n > self.free_blocks:
            raise RuntimeError(f"out of KV blocks: want {n}, have {self.free_blocks}")
        out, self._free = self._free[:n], self._free[n:]
        for b in out:
            self._ref[b] = 1
        return out

    def retain(self, blocks: Sequence[int]) -> None:
        for b in blocks:
            if b not in self._ref:
                raise ValueError(f"retain of unallocated block {b}")
        for b in blocks:
            self._ref[b] += 1

    def free(self, blocks: Sequence[int]) -> None:
        drops: Dict[int, int] = {}
        for b in blocks:
            drops[b] = drops.get(b, 0) + 1
        for b, n in drops.items():
            if not 0 <= b < self.num_blocks:
                raise ValueError(f"bad block id {b}")
            have = self._ref.get(b, 0)
            if have < n:
                raise ValueError(f"double free: block {b} dropped {n}x but holds "
                                 f"{have} reference{'' if have == 1 else 's'}")
        for b in blocks:
            self._ref[b] -= 1
            if self._ref[b] == 0:
                del self._ref[b]
                self._free.append(b)


class PagedKVCache(NamedTuple):
    """Device block pool; k/v: [L, num_blocks, KV, block_size, Dh]."""

    k: torch.Tensor
    v: torch.Tensor

    @classmethod
    def create(cls, n_layers: int, num_blocks: int, block_size: int, kv_heads: int,
               head_dim: int, dtype: torch.dtype, device) -> "PagedKVCache":
        shape = (n_layers, num_blocks, kv_heads, block_size, head_dim)
        return cls(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))

    @property
    def block_size(self) -> int:
        return self.k.shape[3]


def blocks_needed(n_tokens: int, block_size: int) -> int:
    return max(1, -(-n_tokens // block_size))


def append_token_kv(ck: torch.Tensor, cv: torch.Tensor, newk: torch.Tensor,
                    newv: torch.Tensor, block_table: torch.Tensor,
                    pos: torch.Tensor) -> None:
    """Write one new token's K/V per sequence into one layer's pool, in
    place. ck/cv [nblk, KV, bs, Dh] (a view of the stacked pool); newk/newv
    [B, KV, Dh]; block_table [B, W]; pos [B] = the slot being written.
    Padding rows (pos 0 over a scratch table) all land on the scratch
    block, which is never read unmasked."""
    bs = ck.shape[2]
    pos = pos.long()
    blk = block_table.clamp_min(0).long().gather(1, (pos // bs)[:, None])[:, 0]
    off = pos % bs
    # advanced indices around the KV slice address [B, KV, Dh] rows
    ck[blk, :, off] = newk.to(ck.dtype)
    cv[blk, :, off] = newv.to(cv.dtype)
