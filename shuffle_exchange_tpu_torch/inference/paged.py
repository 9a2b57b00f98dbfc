"""Paged KV cache: the block allocator and the device block pool.

Counterpart of ``shuffle_exchange_tpu/inference/paged.py`` without the
prefix registry (content keys, the cached-free LRU), which a later slice
ports (ROADMAP queue A, item 3 (b)).

The pool is ``[L, num_blocks, KV, block_size, Dh]``; ``cache.layer(i)``
gives views of layer i, and every write into the pool is an in-place
``index_put_`` on those views. With ``kv_cache_dtype`` "int8" or "fp8"
the pool stores one byte an element (int8, or float8_e4m3fn) beside f32
scale planes ``[L, num_blocks, KV, block_size]``, one scale per written
(token, kv head) row: every write quantizes (``quantize_kv``) and every
read dequantizes, as in JAX. The JAX layer scan instead rewrites the whole
pool as scan outputs on every step (``engine_v2.py`` measured those copies
at about a fifth of TPU decode time); here no pool copy is ever made.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

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


# ---------------------------------------------------------------------------
# KV quantization (kv_cache_dtype: bf16 | int8 | fp8)
# ---------------------------------------------------------------------------

KV_CACHE_DTYPES = ("bf16", "int8", "fp8")

#: one layer's K or V operand: the bare pool view, or (data, scale) for a
#: quantized pool (JAX ``kv_parts``' pairs)
KVPart = Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]


def kv_storage_dtype(kv_cache_dtype: str, compute_dtype: torch.dtype) -> torch.dtype:
    """The pool's storage dtype for a ``kv_cache_dtype`` mode ("bf16" is the
    engine's serving dtype)."""
    if kv_cache_dtype == "int8":
        return torch.int8
    if kv_cache_dtype == "fp8":
        return torch.float8_e4m3fn
    return compute_dtype


def _kv_maxval(qdtype: torch.dtype) -> float:
    return 127.0 if qdtype == torch.int8 else float(torch.finfo(qdtype).max)   # e4m3: 448


def quantize_kv(x: torch.Tensor, qdtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric quantization over the last (Dh) axis: x [..., Dh]
    -> (q [..., Dh] in ``qdtype``, scale [...] f32), ``scale = absmax /
    maxv`` (1 where the row is all zero), int8 rounding half to even and
    then clipping to +-127, e4m3 by the cast (JAX ``quantize_kv``; the
    bytes are equal to JAX's, which the CPU tests hold)."""
    x32 = x.float()
    absmax = x32.abs().amax(-1)
    maxv = _kv_maxval(qdtype)
    # a tensor divisor: PyTorch's CUDA division by a Python scalar multiplies
    # by its reciprocal, one f32 rounding away from the true quotient
    scale = torch.where(absmax > 0, absmax / absmax.new_full((), maxv), torch.ones_like(absmax))
    y = x32 / scale[..., None]
    if qdtype == torch.int8:
        return torch.round(y).clamp(-maxv, maxv).to(torch.int8), scale
    return y.to(qdtype), scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor,
                  dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """q [..., Dh] storage + scale [...] -> f32 (or ``dtype``) values."""
    out = q.float() * scale[..., None].float()
    return out if dtype is None else out.to(dtype)


def kv_parts(c: KVPart) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(data, scale or None) of a layer's K or V operand."""
    if isinstance(c, tuple):
        return c[0], c[1]
    return c, None


class PagedKVCache(NamedTuple):
    """Device block pool; k/v: [L, num_blocks, KV, block_size, Dh] in the
    storage dtype, k_scale/v_scale: [L, num_blocks, KV, block_size] f32 for
    a quantized pool (None for bf16)."""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None

    @classmethod
    def create(cls, n_layers: int, num_blocks: int, block_size: int, kv_heads: int,
               head_dim: int, dtype: torch.dtype, device,
               kv_cache_dtype: str = "bf16") -> "PagedKVCache":
        if kv_cache_dtype not in KV_CACHE_DTYPES:
            raise ValueError(f"kv_cache_dtype must be one of {KV_CACHE_DTYPES}, got "
                             f"{kv_cache_dtype!r}")
        store = kv_storage_dtype(kv_cache_dtype, dtype)
        shape = (n_layers, num_blocks, kv_heads, block_size, head_dim)
        k = torch.zeros(shape, dtype=store, device=device)
        v = torch.zeros(shape, dtype=store, device=device)
        if kv_cache_dtype == "bf16":
            return cls(k, v)
        return cls(k, v, torch.ones(shape[:-1], dtype=torch.float32, device=device),
                   torch.ones(shape[:-1], dtype=torch.float32, device=device))

    @property
    def block_size(self) -> int:
        return self.k.shape[3]

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    def layer(self, i: int) -> Tuple[KVPart, KVPart]:
        """Layer i's K and V operands: views of the pool (and of its scale
        planes), which writes update in place."""
        if self.quantized:
            return (self.k[i], self.k_scale[i]), (self.v[i], self.v_scale[i])
        return self.k[i], self.v[i]

    def pool_nbytes(self) -> int:
        """Resident bytes of the pool, scale planes included."""
        return sum(t.numel() * t.element_size() for t in self if t is not None)


def blocks_needed(n_tokens: int, block_size: int) -> int:
    return max(1, -(-n_tokens // block_size))


def write_rows(ck: KVPart, cv: KVPart, k: torch.Tensor, v: torch.Tensor, blk: torch.Tensor,
               off: torch.Tensor) -> None:
    """Write K/V rows k/v [N, KV, Dh] at (blk[n], :, off[n]) of one layer's
    pool, in place; a quantized pool quantizes each (row, kv head) on write
    and scatters its scale too."""
    for c, x in ((ck, k), (cv, v)):
        data, scale = kv_parts(c)
        if scale is not None:
            x, s = quantize_kv(x, data.dtype)
            scale[blk, :, off] = s
        # advanced indices around the KV slice address [N, KV, Dh] rows
        data[blk, :, off] = x.to(data.dtype)


def write_blocks(c: KVPart, x: torch.Tensor, flat: torch.Tensor) -> None:
    """Write rows x [P, tpad, KV, Dh] (tpad a multiple of the block size)
    as whole blocks into blocks ``flat`` [P * tpad / bs] of one layer's
    pool, in place (the batched prefill's scatter); a quantized pool
    quantizes each (row, kv head) on write and scatters its scales as
    [P * tpad / bs, KV, bs]."""
    data, scale = kv_parts(c)
    P, tpad = x.shape[:2]
    bs = data.shape[2]

    def blocks(t):   # [P, tpad, KV(, Dh)] -> [P * tpad / bs, KV, bs(, Dh)]
        t = t.reshape(P, tpad // bs, bs, *t.shape[2:]).transpose(2, 3)
        return t.reshape(P * (tpad // bs), *t.shape[2:])

    if scale is not None:
        x, sx = quantize_kv(x, data.dtype)
        scale[flat] = blocks(sx)
    data[flat] = blocks(x).to(data.dtype)


def append_token_kv(ck: KVPart, cv: KVPart, newk: torch.Tensor, newv: torch.Tensor,
                    block_table: torch.Tensor, pos: torch.Tensor) -> None:
    """Write one new token's K/V per sequence into one layer's pool, in
    place. ck/cv [nblk, KV, bs, Dh] views of the stacked pool (or (data,
    scale) pairs: quantize on write); newk/newv [B, KV, Dh]; block_table
    [B, W]; pos [B] = the slot being written. Padding rows (pos 0 over a
    scratch table) all land on the scratch block, which is never read
    unmasked."""
    bs = kv_parts(ck)[0].shape[2]
    pos = pos.long()
    blk = block_table.clamp_min(0).long().gather(1, (pos // bs)[:, None])[:, 0]
    write_rows(ck, cv, newk, newv, blk, pos % bs)
