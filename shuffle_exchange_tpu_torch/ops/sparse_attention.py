"""Blocksparse attention: fixed / longformer / bigbird / variable layouts.

Counterpart of ``shuffle_exchange_tpu/ops/sparse_attention.py``. The
``SparsityConfig`` family (Dense, Fixed, BSLongformer, BigBird, Variable)
builds a block layout [T/bs, S/bs] of the key blocks each query block
attends to; ``sparse_attention`` expands it to an element mask
``kron(layout, ones(bs, bs))[:T, :S]``, ANDs the causal ``tril(k=S-T)``
into it when asked, and runs attention under that mask.

On a CUDA tensor that is always the flash kernel's element-mask form
(B15 with splash's ``mask_np``, ``ops/flash_attention.py``), which skips
the empty tiles in its forward, dq and dk/dv passes; the mask's tile map
is built on the host once per mask. On a CPU tensor it is the plain
version: JAX's dense path (f32 scores and weights, masked pairs -1e30,
the weights of masked pairs zeroed so that a query row with no allowed
key gives 0 and zero gradients). Two deliberate differences from JAX:
the port has no shape gate (JAX routes to splash only for D % 64 == 0,
T and S multiples of 128 and no fully masked row; the kernel masks
ragged edges and empty rows itself), and ``impl="dense"`` is the plain
version, which runs only on the CPU: on a CUDA tensor it raises.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from .flash_attention import flash_attention, reference_attention, tile_mask


@dataclasses.dataclass
class SparsityConfig:
    """Base block-layout config (the reference's sparsity_config.py)."""

    block: int = 16

    def make_layout(self, seq_len: int) -> np.ndarray:
        raise NotImplementedError

    def _n(self, seq_len: int) -> int:
        if seq_len % self.block:
            raise ValueError(f"seq_len {seq_len} not divisible by block {self.block}")
        return seq_len // self.block


@dataclasses.dataclass
class DenseSparsityConfig(SparsityConfig):
    def make_layout(self, seq_len: int) -> np.ndarray:
        n = self._n(seq_len)
        return np.ones((n, n), bool)


@dataclasses.dataclass
class FixedSparsityConfig(SparsityConfig):
    """Local blocks + periodic global columns: every query attends its
    local stride window plus the last ``num_global_blocks`` of each
    earlier stride."""

    num_local_blocks: int = 4
    num_global_blocks: int = 1

    def __post_init__(self):
        if self.num_global_blocks > self.num_local_blocks:
            raise ValueError(
                f"FixedSparsityConfig: num_global_blocks ({self.num_global_blocks}) must be "
                f"<= num_local_blocks ({self.num_local_blocks}) — globals are each stride's "
                "trailing blocks")

    def make_layout(self, seq_len: int) -> np.ndarray:
        n = self._n(seq_len)
        layout = np.zeros((n, n), bool)
        stride = self.num_local_blocks
        for qi in range(n):
            start = (qi // stride) * stride
            layout[qi, start:start + stride] = True        # local window
            for s in range(0, start, stride):               # earlier strides' trailing blocks
                layout[qi, s + stride - self.num_global_blocks:s + stride] = True
        return layout


@dataclasses.dataclass
class BSLongformerSparsityConfig(SparsityConfig):
    """Sliding window + designated global blocks."""

    num_sliding_window_blocks: int = 3
    global_block_indices: tuple = (0,)

    def make_layout(self, seq_len: int) -> np.ndarray:
        n = self._n(seq_len)
        layout = np.zeros((n, n), bool)
        w = self.num_sliding_window_blocks // 2
        for qi in range(n):
            layout[qi, max(0, qi - w):min(n, qi + w + 1)] = True
        for g in self.global_block_indices:
            if g < n:
                layout[:, g] = True                        # everyone sees global
                layout[g, :] = True                        # global sees everyone
        return layout


@dataclasses.dataclass
class BigBirdSparsityConfig(SparsityConfig):
    """Window + global + random blocks (the random blocks from ``seed``)."""

    num_random_blocks: int = 1
    num_sliding_window_blocks: int = 3
    num_global_blocks: int = 1
    seed: int = 0

    def make_layout(self, seq_len: int) -> np.ndarray:
        n = self._n(seq_len)
        layout = np.zeros((n, n), bool)
        w = self.num_sliding_window_blocks // 2
        for qi in range(n):
            layout[qi, max(0, qi - w):min(n, qi + w + 1)] = True
        g = min(self.num_global_blocks, n)
        layout[:, :g] = True
        layout[:g, :] = True
        rng = np.random.default_rng(self.seed)
        for qi in range(n):
            picks = rng.choice(n, size=min(self.num_random_blocks, n), replace=False)
            layout[qi, picks] = True
        return layout


@dataclasses.dataclass
class VariableSparsityConfig(SparsityConfig):
    """Per-row local windows + explicit global indices."""

    num_local_blocks: int = 4
    global_block_indices: tuple = (0,)

    def make_layout(self, seq_len: int) -> np.ndarray:
        n = self._n(seq_len)
        layout = np.zeros((n, n), bool)
        for qi in range(n):
            layout[qi, max(0, qi - self.num_local_blocks + 1):qi + 1] = True
        for g in self.global_block_indices:
            if g < n:
                layout[:, g] = True
                layout[g, :] = True
        return layout


IMPLS = ("auto", "splash", "dense")


def element_mask(layout: np.ndarray, block: int, T: int, S: int, causal: bool) -> np.ndarray:
    """The [T, S] element mask of a block layout: ``kron(layout, ones(bs,
    bs))[:T, :S]``, ANDed with ``tril(k=S-T)`` when causal (JAX's)."""
    m = np.kron(np.asarray(layout, bool), np.ones((block, block), bool))[:T, :S]
    if causal:
        m = m & np.tril(np.ones((T, S), bool), k=S - T)
    return m


def sparse_attention(q, k, v, config: Optional[SparsityConfig] = None, causal: bool = True,
                     layout: Optional[np.ndarray] = None, impl: str = "auto"):
    """Blocksparse attention. q [B,T,H,D], k/v [B,S,KV,D] -> [B,T,H,D].

    ``config`` builds the layout from T (or pass a precomputed block
    ``layout`` [T/bs, S/bs] bool with its block size in ``config.block``).
    "auto" and "splash": the flash kernel's element-mask form on a CUDA
    tensor (empty tiles skipped), the plain version on a CPU tensor;
    "dense": the plain version, on the CPU only. Differentiable either
    way."""
    if impl not in IMPLS:
        raise ValueError(f"sparse_attention: impl must be one of {IMPLS}, got {impl!r}")
    config = config or FixedSparsityConfig()
    T, S = q.shape[1], k.shape[1]
    if layout is None:
        if T != S:
            raise ValueError("sparse_attention with auto layout expects T == S")
        layout = config.make_layout(T)
    mask = tile_mask(element_mask(layout, config.block, T, S, causal))
    if impl == "dense":
        if q.is_cuda:
            raise ValueError("sparse_attention: impl='dense' is the plain version, which runs "
                             "on the CPU; on a CUDA tensor use 'auto' (the kernel)")
        return reference_attention(q, k, v, causal=False, p_f32=True, mask=mask)
    return flash_attention(q, k, v, causal=False, mask=mask)


__all__ = ["BSLongformerSparsityConfig", "BigBirdSparsityConfig", "DenseSparsityConfig",
           "FixedSparsityConfig", "IMPLS", "SparsityConfig", "VariableSparsityConfig",
           "element_mask", "sparse_attention"]
