"""The work plan of the tensor-core GEMV of the decode rows
(``ops/csrc/mma_gemv.cuh``), shared by B16's decode rows
(``ops/grouped_gemm.py``) and B7, the quantized fused MLP
(``ops/fused_decode.py``).

The kernel's blocks are persistent (one an SM) and walk items of one row
group (up to 16 activation rows), one 128-column weight tile and one K
chunk of whole scale groups; a block's 8 warps split the chunk's 32-row
stages between them. One chunk over all of K needs no partials; several
write f32 partials that the tile's last block adds in split order.
:func:`plan` picks the split count: the fewest bytes-equivalents through
the busiest SM (its items' weight bytes and fixed cost), plus the
partials' bytes spread over the card.
"""

from __future__ import annotations

import functools
from typing import Tuple

#: the kernel's geometry (mma_gemv.cuh: kTileCols, kRows, kStageRows, kWarps)
TILE_COLS = 128     # weight columns a tile
PASS_ROWS = 16      # activation rows a row group (the m16 A operand)
STAGE_ROWS = 32     # weight rows a stage (two k16 steps)
WARPS = 8           # warps a block; each takes a contiguous run of a chunk's stages


#: an item's fixed cost beyond its weight bytes, and a split item's fold,
#: in bytes streamed by one SM in the same time (~20 GB/s an SM at the
#: H100's ~2.7 TB/s of reads): the block's barrier and sums with the ring
#: refilling behind them took ~5 us an item on the H100
#: (scripts/torch_kernel_digest.py --sections decode_gemv)
ITEM_BYTES = 96 << 10
FOLD_BYTES = 32 << 10


@functools.lru_cache(None)
def plan(K: int, unit: int, tiles: int, groups: int, rows: int, n_out: int,
         elt_bytes: float, sms: int) -> Tuple[int, int]:
    """(splits, chunk) of a reduction over K rows in chunks of whole
    ``unit`` rows (the scale group; bf16 weights: STAGE_ROWS), for
    ``groups`` row groups of ``tiles`` column tiles, ``rows`` activation
    rows and ``n_out`` output columns, weights of ``elt_bytes`` a value, on
    ``sms`` blocks. Every warp's part of a chunk is at least one stage
    unless K is shorter. The cost of a split count: the busiest SM's
    rounds, ceil(items / sms), each an item's weight bytes plus
    ITEM_BYTES, and past one split the partials' f32 bytes written and
    read (splits x rows x n_out x 8) over the SMs plus FOLD_BYTES a round;
    the cheapest wins, fewer splits on a tie."""
    units = -(-K // unit)
    least = min(units, -(-WARPS * STAGE_ROWS // unit))   # units a chunk at least
    best = None
    for s in range(1, units + 1):
        per = -(-units // s)
        if per < least:
            break
        chunk = per * unit
        splits = -(-K // chunk)
        rounds = -(-(groups * tiles * splits) // sms)
        cost = rounds * (chunk * TILE_COLS * elt_bytes + ITEM_BYTES)
        if splits > 1:
            cost += splits * rows * n_out * 8 / sms + rounds * FOLD_BYTES
        if best is None or cost < best[0]:
            best = (cost, splits, chunk)
    return best[1], best[2]


def blocks(items: int, sms: int) -> int:
    """Persistent blocks for at most ``items`` items: one an SM."""
    return max(1, min(items, sms))


__all__ = ["FOLD_BYTES", "ITEM_BYTES", "PASS_ROWS", "STAGE_ROWS", "TILE_COLS", "WARPS",
           "blocks", "plan"]
