"""The flash forward and backward redesigned for Hopper (the dense forward
at head dims 64, 80, 96, 128 and 256 and the dense backward at 64, 128 and
256:
warp-specialised wgmma kernels over TMA-fed tiles,
``ops/csrc/flash_attention.cu``), on the CPU: what of their design can be
held without the card.

- Each instance's shared memory, from a mirror of the launchers' formula
  (``wgmma_smem_bytes``), fits an H100 block (232,448 B) and equals the
  CUDA source's (the ``WgFwd`` / ``WgDq`` / ``WgDkv`` structs' expressions
  in ``wgmma_flash.cuh`` evaluated), and so do the tile shapes it mirrors; at 80 and 96 a tile's
  column blocks (one full 64-column block in the 128-byte swizzle and a
  16- or 32-column tail in the 32- or 64-byte swizzle) cover the head dim,
  each within its swizzle's TMA box and on a 1024-byte boundary.
- A mirror of the block schedules: query tiles of one head (128 rows at
  head dim 128, 64 at 256), grouped by (sequence, kv head) and longest
  first within the group under a causal mask, every (sequence, head, tile)
  once, over ragged T (1, 37, 129, ...); each consumer warpgroup's live key
  tiles cover every key its rows see and skip only tiles wholly above its
  diagonal; the dk/dv pass's blocks grouped by (sequence, kv head), key
  tile 0 first, and its iterations visit every (query head of the group,
  query tile at or below the diagonal) once, heads in ascending order; at
  64 (the key split: a block is 128 keys, each consumer its own 64 over
  every query of a ring tile) each consumer covers each of its keys once,
  in the same fixed order, and skips only query tiles wholly above its
  keys.
- A plain mirror of the new arithmetic in f32 (S summed over the column
  blocks in k-step order, O's column blocks side by side; the log2-domain
  online softmax over the row blocks and 64-key tiles with the rescale
  2^(m - m_new) and masked probabilities exactly 0; the dk/dv pass with
  its query split and head-dim column split between two warpgroups, or at
  64 its key split, and its fixed group-sum order; the dq pass over its
  row blocks) equals JAX
  ``reference_attention`` (its ``jax.vjp`` for the gradients) and, at the
  head dims splash takes (multiples of 64), ``splash_attention_gqa`` in
  interpret mode within 1e-5; at 64 the backward mirror also equals
  ``jax.vjp`` of ``splash_attention_gqa`` in interpret mode (MHA, GQA,
  segment ids, ragged T).
- The wrappers hand the C entry points the operands, shapes, causal flag
  and scale, and the backward an f32 [B, H, T] delta buffer.
"""

import importlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shuffle_exchange_tpu.ops.flash_attention import reference_attention as jreference
from shuffle_exchange_tpu.ops.flash_attention import splash_attention_gqa

fa = importlib.import_module("shuffle_exchange_tpu_torch.ops.flash_attention")
CU = (fa.__file__.rsplit("/", 1)[0]) + "/csrc/flash_attention.cu"
WG = (fa.__file__.rsplit("/", 1)[0]) + "/csrc/wgmma_flash.cuh"   # the kernels' shapes and bodies
T_ = torch.from_numpy
NEG = -1e30
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
WG_ROWS = 64        # rows (or, in the dk/dv pass, head-dim halves) a consumer warpgroup
# the head dims whose dense forms (no element mask) run the wgmma kernels:
# the forward at all of them, the backward at WGMMA_BWD_HEAD_DIMS
WGMMA_HEAD_DIMS = (64, 80, 96, 128, 256)
WGMMA_BWD_HEAD_DIMS = (64, 128, 256)
SMEM_LIMIT = 232448   # dynamic shared memory an H100 block can have
_SLACK = 1024         # the kernels align their tiles to the 1024-byte swizzle period


def wgmma_tiles(dh: int) -> dict:
    """The wgmma kernels' blocks at head dim ``dh`` (flash_attention.cu's
    ``WgFwd`` / ``WgDq`` / ``WgDkv``): ``fwd`` and ``dq`` -> (query rows a
    block, keys a ring tile, ring slots), ``dkv`` -> (keys a block, query
    rows a ring tile, ring slots); ``dq`` and ``dkv`` only where the
    backward is built. Two consumer warpgroups take 64 rows each below 256;
    at 256 (and in the dk/dv pass at 128 and 256) they split the head-dim
    columns of the accumulators instead; in the dk/dv pass at 64 a block is
    128 keys, 64 a consumer."""
    if dh not in WGMMA_HEAD_DIMS:
        raise ValueError(f"no wgmma flash kernel at head_dim {dh} {WGMMA_HEAD_DIMS}")
    wide = dh == 256
    tiles = {"fwd": (64 if wide else 128, 64, 4 if wide else 8)}
    if dh in WGMMA_BWD_HEAD_DIMS:
        tiles.update(dq=(64 if wide else 128, 64, 3 if wide else 8),
                     dkv=(128 if dh == 64 else 64, 64, 4 if wide else 8))
    return tiles


def column_blocks(dh: int) -> list:
    """A tile's column blocks at head dim ``dh``: (first column, columns,
    swizzle bytes): dh // 64 full blocks of 64 columns in the 128-byte
    swizzle, then a tail of dh % 64 columns (16: the 32-byte swizzle, 32:
    the 64-byte one), whose rows are as many bytes as its swizzle."""
    blocks = [(64 * i, 64, 128) for i in range(dh // 64)]
    if dh % 64:
        blocks.append((dh - dh % 64, dh % 64, 2 * (dh % 64)))
    return blocks


def wgmma_smem_bytes(which: str, dh: int) -> int:
    """Dynamic shared memory of one block of the wgmma kernel ``which``
    ("fwd", "dq", "dkv") at head dim ``dh``, as its launcher asks for it
    (a mirror of the ``SMEM`` formulas of the ``Wg*`` structs):
    the alignment slack, the resident tiles (Q; Q and dO; K and V), the
    ring, the exchange between the two consumers (at 256 the forward's two
    buffers of both partial score tiles and the dq pass's one buffer of
    both partial S and dP tiles, f32; the dk/dv pass's four [64, 64] bf16
    P^T / dS^T tiles, two sets of them at 128, none at 64, and each
    consumer's two staged lse / delta rows: its 32 queries', at 64 all 64)
    and the ring's mbarriers (8 bytes each: full and empty a slot, one more
    for the resident tiles)."""
    tiles = wgmma_tiles(dh)
    if which not in tiles:
        raise ValueError(f"no wgmma flash kernel for the {which} pass at head_dim {dh} "
                         f"{WGMMA_BWD_HEAD_DIMS}")
    rows, cols, slots = tiles[which]
    resident = {"fwd": 1, "dq": 2, "dkv": 2}[which] * rows * dh * 2
    if which == "dkv":   # two sets of P^T / dS^T tiles at 128, one at 256, none at 64
        key_split = dh == 64
        ptiles = 0 if key_split else (1 if dh == 256 else 2) * 4 * rows * cols * 2
        exchange = ptiles + 2 * 2 * 2 * (cols if key_split else cols // 2) * 4
    elif dh == 256:
        exchange = 2 * 2 * rows * cols * 4
    else:
        exchange = 0
    return _SLACK + resident + slots * cols * dh * 2 + exchange + 8 * (2 * slots + 1)


KNOWN_SMEM = {("fwd", 64): 83080, ("fwd", 80): 103560, ("fwd", 96): 124040,
              ("fwd", 128): 165000, ("fwd", 256): 230472, ("dq", 64): 99464,
              ("dq", 128): 197768, ("dq", 256): 230456, ("dkv", 64): 101512,
              ("dkv", 128): 231560, ("dkv", 256): 231496}
# the CUDA source's constants its structs' expressions use
SOURCE_CONSTANTS = {"kConsumerWgs": 2, "kAlign": 1024}


# ---------------------------------------------------------------------------
# Shared memory and tile shapes
# ---------------------------------------------------------------------------


def _source_tiles(struct: str, dh: int) -> dict:
    """The constants of a ``Wg*`` struct of the CUDA source at head dim dh,
    each evaluated from its C expression in order (``a ? b : c`` as
    Python's conditional, ``/`` as C's integer division)."""
    body = (open(CU).read() + open(WG).read()).split(f"struct {struct} {{", 1)[1].split("};", 1)[0]
    env = dict(SOURCE_CONSTANTS, DH=dh)
    for decl in re.findall(r"static constexpr (?:int|bool) ([^;]+);", body):
        for name, expr in re.findall(r"(\w+) =\s*((?:[^,(]|\([^)]*\))+)", decl):
            expr = " ".join(expr.split())
            expr = re.sub(r"^(.*?) \? (.*?) : (.*)$", r"(\2) if (\1) else (\3)", expr)
            expr = re.sub(r"(?<!/)/(?!/)", "//", expr)   # C's integer division
            env[name] = eval(expr, {}, env)
    return env


SMEM_CASES = [(which, dh) for dh in WGMMA_HEAD_DIMS for which in wgmma_tiles(dh)]


@pytest.mark.parametrize("which,dh", SMEM_CASES, ids=[f"{w}-{d}" for w, d in SMEM_CASES])
def test_shared_memory_fits_a_block_and_matches_the_source(which, dh):
    smem = wgmma_smem_bytes(which, dh)
    assert smem <= SMEM_LIMIT == 232448
    assert smem == KNOWN_SMEM[(which, dh)]
    src = _source_tiles({"fwd": "WgFwd", "dq": "WgDq", "dkv": "WgDkv"}[which], dh)
    rows, cols, slots = wgmma_tiles(dh)[which]
    if which == "dkv":
        assert (src["BN"], src["BQ"], src["SLOTS"]) == (rows, cols, slots)
    else:
        assert (src["BM"], src["BN"], src["SLOTS"]) == (rows, cols, slots)
    assert src["SMEM"] == smem            # the mirror is the launcher's formula
    assert rows % WG_ROWS == 0 and cols % 16 == 0 and dh % 16 == 0
    if which == "fwd":   # full column blocks and the tail block
        assert (src["CB"], src["TAIL"]) == (dh // 64, dh % 64)
        assert src["CB"] * 64 + src["TAIL"] == dh
    # every ring tile is 32 KB at 256 (the budget the slot counts are cut to)
    if dh == 256:
        assert cols * dh * 2 == 32768


def test_wgmma_tiles_refuse_other_head_dims():
    """What stays unbuilt: the wgmma backward at 80 and 96 (they have no
    backward), and head dims that are not multiples of 16, such as 72."""
    for dh in (80, 96):
        for which in ("dq", "dkv"):
            with pytest.raises(ValueError, match="no wgmma flash kernel"):
                wgmma_smem_bytes(which, dh)
    for dh in (72, 48, 512):
        with pytest.raises(ValueError, match="no wgmma flash kernel"):
            wgmma_tiles(dh)


@pytest.mark.parametrize("dh", WGMMA_HEAD_DIMS)
def test_column_blocks_cover_the_head_dim_within_their_swizzles(dh):
    """A tile's column blocks tile [0, dh) in order; each block's row is
    exactly its swizzle's bytes (the TMA box's inner dimension may not pass
    the swizzle span), the tail's k-steps are whole (16 columns), and every
    block of a 64-, 128- or BM-row tile starts on a 1024-byte boundary."""
    blocks = column_blocks(dh)
    assert [c0 for c0, _, _ in blocks] == list(np.cumsum([0] + [n for _, n, _ in blocks[:-1]]))
    assert sum(n for _, n, _ in blocks) == dh
    src = _source_tiles("WgFwd", dh)
    for c0, n, swizzle in blocks:
        assert 2 * n == swizzle and swizzle in (32, 64, 128) and n % 16 == 0
    for rows in (64, src["BM"]):
        starts = np.cumsum([0] + [rows * sw for _, _, sw in blocks[:-1]])
        assert all(int(x) % 1024 == 0 for x in starts)
        assert sum(rows * sw for _, _, sw in blocks) == rows * dh * 2   # the tile's bytes
    # a consumer's 64 rows of the tail start on the tail swizzle's 8-row period
    c0, n, swizzle = blocks[-1]
    assert (64 * swizzle) % (8 * swizzle) == 0


# ---------------------------------------------------------------------------
# Block schedules
# ---------------------------------------------------------------------------


def fwd_blocks(B, T, H, causal, BM=128, KV=None):
    """The forward's and the dq pass's blocks in issue order, (b, h, qt):
    the kernels' ``block_of_rows``: by (sequence, kv head), then query tile
    (longest first under a causal mask), then the group's query heads."""
    KV = H if KV is None else KV
    G, nqt = H // KV, -(-T // BM)
    blocks = []
    for x in range(B * KV * nqt * G):
        grp, rem = divmod(x, nqt * G)
        rank, g = divmod(rem, G)
        b, kvh = divmod(grp, KV)
        blocks.append((b, kvh * G + g, nqt - 1 - rank if causal else rank))
    return blocks


def dkv_blocks(B, S, KV, BN=64):
    """The dk/dv pass's blocks in issue order, (b, kv head, key tile)."""
    nkt = -(-S // BN)
    return [(bkv // KV, bkv % KV, kt) for bkv, kt in
            (divmod(x, nkt) for x in range(B * KV * nkt))]


def live_tiles(r0, T, S, causal, BM, BN, off=0):
    """(key tiles the block loads, the ones warpgroup rows [r0, r0 + 64)
    computes): n_kv as the kernel's, a tile wholly above the diagonal
    skipped. ``off``: the ALiBi form's bottom-right diagonal (query i sees
    keys j <= i + off)."""
    q0 = r0 // BM * BM
    n_s = -(-S // BN)
    n_kv = min((q0 + BM - 1 + off) // BN + 1, n_s) if causal else n_s
    return n_kv, [j for j in range(n_kv) if not (causal and j * BN > r0 + WG_ROWS - 1 + off)]


def dkv_iterations(kt, kvh, n_rep, T, causal, BQ=64, BN=64, off=0):
    """The dk/dv pass's (head, query tile) sequence for key tile kt (of BN
    keys): from the query tile of the first query that sees the tile's
    first key under a causal mask (``off`` as in ``live_tiles``)."""
    nqt = -(-T // BQ)
    qt_lo = max(0, (kt * BN - off) // BQ) if causal else 0
    n_q = nqt - qt_lo
    return [(kvh * n_rep + i // n_q, qt_lo + i % n_q) for i in range(n_rep * n_q)]


@pytest.mark.parametrize("dh", WGMMA_HEAD_DIMS)
@pytest.mark.parametrize("T,S,causal", [(1, 1, True), (37, 37, True), (128, 128, True),
                                        (129, 129, True), (1000, 1000, True),
                                        (200, 1000, False), (37, 37, False)])
def test_forward_and_dq_blocks_cover_every_tile_once_longest_first(dh, T, S, causal):
    B, H, KV = 2, 4, 2
    for which in [w for w in ("fwd", "dq") if w in wgmma_tiles(dh)]:
        BM, BN, _ = wgmma_tiles(dh)[which]
        blocks = fwd_blocks(B, T, H, causal, BM, KV)
        assert sorted(blocks) == sorted({(b, h, qt) for b in range(B) for h in range(H)
                                         for qt in range(-(-T // BM))})
        assert len(blocks) == len(set(blocks))
        # a (sequence, kv head)'s blocks are contiguous, its longest first, the
        # group's query heads of one query tile side by side
        per = -(-T // BM) * (H // KV)
        for start in range(0, len(blocks), per):
            group = blocks[start:start + per]
            assert len({(b, h // (H // KV)) for b, h, _ in group}) == 1
            loads = [live_tiles(qt * BM, T, S, causal, BM, BN)[0] for _, _, qt in group]
            assert loads == sorted(loads, reverse=True)
            assert [qt for _, _, qt in group[::H // KV]] == [qt for _, _, qt in group][::H // KV]
        for _, _, qt in blocks:
            # at 128 two consumers take 64 rows each; at 256 both take the
            # block's 64 rows (and half the head dim each)
            for w in range(BM // WG_ROWS):
                r0 = qt * BM + w * WG_ROWS
                n_kv, live = live_tiles(r0, T, S, causal, BM, BN)
                rows = range(r0, min(r0 + WG_ROWS, T))
                seen = {j * BN + c for j in live for c in range(BN)}
                for r in rows:   # every key a row sees lies in a computed tile
                    visible = range(0, min(r + 1, S)) if causal else range(S)
                    assert set(visible) <= seen
                for j in set(range(n_kv)) - set(live):   # skipped: wholly above the diagonal
                    assert causal and j * BN > r0 + WG_ROWS - 1
        if T in (1, 37):   # one query tile: rows past T are computed, not written
            assert len(blocks) == B * H and all(qt == 0 for _, _, qt in blocks)


@pytest.mark.parametrize("BN", [64, 128])
@pytest.mark.parametrize("S", [1, 37, 1000])
def test_dkv_blocks_cover_every_key_tile_once_grouped_by_kv_head(S, BN):
    B, KV = 3, 2
    blocks = dkv_blocks(B, S, KV, BN)
    nkt = -(-S // BN)
    assert sorted(blocks) == sorted({(b, kvh, kt) for b in range(B) for kvh in range(KV)
                                     for kt in range(nkt)})
    for start in range(0, len(blocks), nkt):   # key tile 0 (the most query tiles) first
        assert [kt for _, _, kt in blocks[start:start + nkt]] == list(range(nkt))


@pytest.mark.parametrize("BN", [64, 128])
@pytest.mark.parametrize("T,causal", [(1, True), (37, True), (200, True), (200, False)])
@pytest.mark.parametrize("n_rep", [1, 4])
def test_dkv_iterations_cover_each_head_and_query_tile_once_in_order(T, causal, n_rep, BN):
    kvh = 1
    for kt in range(-(-T // BN)):
        its = dkv_iterations(kt, kvh, n_rep, T, causal, BN=BN)
        heads = [h for h, _ in its]
        assert heads == sorted(heads)                                  # fixed group-sum order
        want = {(kvh * n_rep + g, qt) for g in range(n_rep)
                for qt in range(kt * BN // 64 if causal else 0, -(-T // 64))}
        assert sorted(its) == sorted(want) and len(its) == len(want)
        assert len(its) >= 1


# ---------------------------------------------------------------------------
# The arithmetic, mirrored in f32
# ---------------------------------------------------------------------------


def _rows(x, start, n):
    """Rows [start, start + n) of [L, ...], zeros past the end (TMA's fill)."""
    out = torch.zeros((n,) + tuple(x.shape[1:]), dtype=x.dtype)
    stop = min(start + n, x.shape[0])
    if stop > start:
        out[:stop - start] = x[start:stop]
    return out


def _allowed(rows, keys, S, T, causal, seg, off=0):
    ok = (keys[None, :] < S) & (rows[:, None] < T)
    if causal:
        ok &= ~(keys[None, :] > rows[:, None] + off)
    if seg is not None:
        last = seg.shape[0] - 1   # the kernels read row min(r, T - 1)'s id
        sr, sk = seg[rows.clamp(max=last)], seg[keys.clamp(max=last)]
        ok &= sr[:, None] == sk[None, :]
    return ok


def alibi_off(T, S, slopes, off):
    """The diagonal's offset a mirror uses: the ALiBi form's bottom-right
    S - T unless ``off`` overrides it (a broken mirror); 0 without slopes."""
    if off is not None:
        return off
    return S - T if slopes is not None else 0


def mirror_forward(q, k, v, causal, seg=None, slopes=None, off=None):
    """The wgmma forward's arithmetic in f32: (out, lse). With ``slopes``
    [H] the ALiBi form: t = s * scale log2(e) + slope_h log2(e) j at the
    absolute key j, the row max over t, the bottom-right diagonal
    (``alibi_off``), keys past S masked."""
    B, T, H, Dh = q.shape
    S, KV = k.shape[1], k.shape[2]
    BM, BN, _ = wgmma_tiles(Dh)["fwd"]
    sl2 = Dh ** -0.5 * LOG2E
    off = alibi_off(T, S, slopes, off)
    out, lse = torch.zeros(B, T, H, Dh), torch.zeros(B, H, T)
    for b, h, qt in fwd_blocks(B, T, H, causal, BM):
        kvh = h // (H // KV)
        sb = None if seg is None else seg[b]
        for w in range(BM // WG_ROWS):
            r0 = qt * BM + w * WG_ROWS
            rows = torch.arange(r0, r0 + WG_ROWS)
            qs = _rows(q[b, :, h], r0, WG_ROWS)
            m, l = torch.full((WG_ROWS,), NEG), torch.zeros(WG_ROWS)
            acc = torch.zeros(WG_ROWS, Dh)
            for j in live_tiles(r0, T, S, causal, BM, BN, off)[1]:
                k0 = j * BN
                keys = torch.arange(k0, k0 + BN)
                kt, vt = _rows(k[b, :, kvh], k0, BN), _rows(v[b, :, kvh], k0, BN)
                # S over the column blocks in k-step order (a tail block last)
                s = sum(qs[:, c0:c0 + n] @ kt[:, c0:c0 + n].T for c0, n, _ in column_blocks(Dh))
                if slopes is None:
                    s = s * sl2
                    masked = (causal and k0 + BN - 1 > r0) or k0 + BN > S or sb is not None
                else:   # the bias at the absolute key, in the log2 domain
                    s = s * sl2 + (slopes[h] * LOG2E) * keys.float()
                    masked = k0 + BN - 1 > r0 + off or k0 + BN > S
                if masked:   # rows past T are not masked here: the kernel writes none of them
                    s = torch.where(_allowed(rows, keys, S, 1 << 30, causal, sb, off), s,
                                    torch.tensor(NEG))
                mn = torch.maximum(m, s.max(1).values)
                al = torch.exp2(m - mn)
                p = torch.exp2(s - mn[:, None])
                if masked:
                    p = torch.where(s <= NEG, torch.zeros(()), p)
                l = l * al + p.sum(1)
                # O's column blocks side by side (the tail's own product)
                pv = torch.cat([p @ vt[:, c0:c0 + n] for c0, n, _ in column_blocks(Dh)], 1)
                acc = acc * al[:, None] + pv
                m = mn
            for i, r in enumerate(rows.tolist()):
                if r < T:
                    out[b, r, h] = acc[i] / max(l[i].item(), 1e-30)
                    lse[b, h, r] = (m[i] + torch.log2(l[i].clamp(min=1e-30))) * LN2
    return out, lse


def key_split_live(its, kw0, causal, BQ=64, off=0):
    """The iterations that add anything for a key-split warpgroup with keys
    [kw0, kw0 + 64): all but the query tiles wholly above its keys
    (causal), which the kernel computes all masked (exact zeros, so the
    mirror may leave them out)."""
    return [(h, qt) for h, qt in its if not (causal and qt * BQ + BQ - 1 + off < kw0)]


def _exponent_t(K, Q, sl2, lse2, keys, slopes, head):
    """P^T's exponent in the log2 domain, keys as rows: (K Q^T) scale
    log2(e) - lse2; with ``slopes`` plus the head's bias slope log2(e) j at
    each key j, the bias less lse2 first (as the kernels form it)."""
    st = (K @ Q.T) * sl2
    if slopes is None:
        return st - lse2[None]
    return st + (((slopes[head] * LOG2E) * keys.float())[:, None] - lse2[None])


def _query_vectors(lse, delta, head, q0, T, BQ, alibi):
    """A ring tile's staged lse (log2 domain) and delta for queries
    [q0, q0 + BQ): a query past T reads 0, or in the ALiBi form lse +1e30
    (its P is then exactly 0)."""
    queries = torch.arange(q0, q0 + BQ)
    lse2 = torch.where(queries < T, _rows(lse[head], q0, BQ) * LOG2E, -NEG if alibi else 0.)
    return queries, lse2, torch.where(queries < T, _rows(delta[head], q0, BQ), 0.)


def key_split_dkv(q, k, v, dout, lse, delta, sb, kw0, kt, kvh, n_rep, causal, sl2, slopes=None,
                  off=0):
    """One key-split warpgroup of the dk/dv pass at 64 (one sequence: q,
    dout [T, H, Dh], k, v [S, Dh], lse, delta [H, T]): S^T = K_w Q^T and
    dP^T = V_w dO^T over all 64 queries of each live iteration's tile,
    P^T with masked pairs exactly 0 (the masked form only where the tile
    needs it), dS^T = P^T (dP^T - delta), dv += P^T dO and dk += dS^T Q in
    the iterations' order. -> (dv, dk unscaled), [64, Dh] each, and the
    [H] dslope partials of these 64 keys (ALiBi: per key the sum of dS
    over a head's queries, times j, summed over the keys)."""
    T, S, Dh = q.shape[0], k.shape[0], q.shape[-1]
    BQ = 64
    keys = torch.arange(kw0, kw0 + WG_ROWS)
    K, V = _rows(k, kw0, WG_ROWS), _rows(v, kw0, WG_ROWS)
    dv, dk = torch.zeros(WG_ROWS, Dh), torch.zeros(WG_ROWS, Dh)
    dsum = torch.zeros(q.shape[1], WG_ROWS)
    its = dkv_iterations(kt, kvh, n_rep, T, causal, BQ, 2 * WG_ROWS, off)
    for head, qt in key_split_live(its, kw0, causal, BQ, off):
        q0 = qt * BQ
        Q, dO = _rows(q[:, head], q0, BQ), _rows(dout[:, head], q0, BQ)
        queries, lse2, dlt = _query_vectors(lse, delta, head, q0, T, BQ, slopes is not None)
        p = torch.exp2(_exponent_t(K, Q, sl2, lse2, keys, slopes, head))
        if slopes is None:
            masked = ((causal and kw0 + WG_ROWS - 1 > q0) or q0 + BQ > T or kw0 + WG_ROWS > S
                      or sb is not None)
        else:
            masked = kw0 + WG_ROWS - 1 > q0 + off or kw0 + WG_ROWS > S
        if masked:
            p = torch.where(_allowed(queries, keys, S, T, causal, sb, off).T, p, torch.zeros(()))
        ds = p * ((V @ dO.T) - dlt[None])
        dv += p @ dO
        dk += ds @ Q
        dsum[head] += ds.sum(1)
    return dv, dk, (dsum * keys.float()).sum(1)


def mirror_backward(q, k, v, out, dout, lse, causal, seg=None, slopes=None, off=None):
    """The wgmma backward's arithmetic in f32: delta, the dk/dv pass (two
    warpgroups, each forming P^T and dS^T for half the queries and then
    accumulating half the head-dim columns, the group's query heads summed
    in order) and the dq pass (its row blocks). -> (dq, dk, dv). With
    ``slopes`` the ALiBi form (as ``mirror_forward``): each query head's
    bias at the absolute key, queries past T at lse +1e30, and the dslope
    partials [B, H, ceil(S / 64)] (each 64-key tile's sum of dS times j:
    the key split's warpgroup its own 64 keys, the query split's two
    warpgroups' sums over their 32 queries of a tile added in order), which
    the wrapper sums -> (dq, dk, dv, dslope)."""
    B, T, H, Dh = q.shape
    S, KV = k.shape[1], k.shape[2]
    n_rep, half, scale = H // KV, Dh // 2, Dh ** -0.5
    sl2 = scale * LOG2E
    off = alibi_off(T, S, slopes, off)
    alibi = slopes is not None
    delta = (dout * out).sum(-1).permute(0, 2, 1)                  # [B, H, T]
    dq, dk, dv = torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    part = torch.zeros(B, H, -(-S // 64))
    BN, BQ, _ = wgmma_tiles(Dh)["dkv"]
    for kt in range(-(-S // BN)):
        for b in range(B):
            sb = None if seg is None else seg[b]
            for kvh in range(KV):
                k0 = kt * BN
                if BN == 2 * WG_ROWS:   # the key split: warpgroup w owns keys k0 + 64 w ..
                    for w in range(2):
                        kw0 = k0 + w * WG_ROWS
                        dvw, dkw, pw = key_split_dkv(q[b], k[b, :, kvh], v[b, :, kvh], dout[b],
                                                     lse[b], delta[b], sb, kw0, kt, kvh, n_rep,
                                                     causal, sl2, slopes, off)
                        n = max(0, min(WG_ROWS, S - kw0))
                        dv[b, kw0:kw0 + n, kvh] = dvw[:n]
                        dk[b, kw0:kw0 + n, kvh] = dkw[:n] * scale
                        if kw0 < S:
                            heads = slice(kvh * n_rep, (kvh + 1) * n_rep)
                            part[b, heads, kw0 // 64] = pw[heads]
                    continue
                keys = torch.arange(k0, k0 + BN)
                K, V = _rows(k[b, :, kvh], k0, BN), _rows(v[b, :, kvh], k0, BN)
                acc = [[torch.zeros(BN, half), torch.zeros(BN, half)] for _ in range(2)]
                dsum = torch.zeros(H, 2, BN)   # per head and warpgroup: dS summed over its queries
                for head, qt in dkv_iterations(kt, kvh, n_rep, T, causal, BQ, off=off):
                    q0 = qt * BQ
                    Q, dO = _rows(q[b, :, head], q0, BQ), _rows(dout[b, :, head], q0, BQ)
                    queries, lse2, dlt = _query_vectors(lse[b], delta[b], head, q0, T, BQ, alibi)
                    # each warpgroup forms S^T and dP^T for its 32 queries
                    p = torch.exp2(torch.cat([_exponent_t(K, Q[w * 32:(w + 1) * 32], sl2,
                                                          lse2[w * 32:(w + 1) * 32], keys, slopes,
                                                          head) for w in range(2)], 1))
                    dpt = torch.cat([V @ dO[w * 32:(w + 1) * 32].T for w in range(2)], 1)
                    if alibi:
                        masked = k0 + BN - 1 > q0 + off or k0 + BN > S
                    else:
                        masked = ((causal and qt == kt) or q0 + BQ > T or k0 + BN > S
                                  or sb is not None)
                    if masked:
                        p = torch.where(_allowed(queries, keys, S, T, causal, sb, off).T, p,
                                        torch.zeros(()))
                    ds = p * (dpt - dlt[None])
                    for w in range(2):   # warpgroup w: columns [w * half, (w + 1) * half)
                        cols = slice(w * half, (w + 1) * half)
                        acc[w][0] += p @ dO[:, cols]
                        acc[w][1] += ds @ Q[:, cols]
                        dsum[head, w] += ds[:, w * 32:(w + 1) * 32].sum(1)
                n = min(BN, S - k0)
                dv[b, k0:k0 + n, kvh] = torch.cat([acc[0][0], acc[1][0]], 1)[:n]
                dk[b, k0:k0 + n, kvh] = torch.cat([acc[0][1], acc[1][1]], 1)[:n] * scale
                for head in range(kvh * n_rep, (kvh + 1) * n_rep):
                    part[b, head, kt] = sum((dsum[head, w] * keys.float()).sum() for w in range(2))
    BM, BN, _ = wgmma_tiles(Dh)["dq"]
    for b, h, qt in fwd_blocks(B, T, H, causal, BM):
        kvh = h // n_rep
        sb = None if seg is None else seg[b]
        for w in range(BM // WG_ROWS):
            r0 = qt * BM + w * WG_ROWS
            rows = torch.arange(r0, r0 + WG_ROWS)
            Q, dO = _rows(q[b, :, h], r0, WG_ROWS), _rows(dout[b, :, h], r0, WG_ROWS)
            _, lse2, dlt = _query_vectors(lse[b], delta[b], h, r0, T, WG_ROWS, alibi)
            acc = torch.zeros(WG_ROWS, Dh)
            for j in live_tiles(r0, T, S, causal, BM, BN, off)[1]:
                k0 = j * BN
                keys = torch.arange(k0, k0 + BN)
                K, V = _rows(k[b, :, kvh], k0, BN), _rows(v[b, :, kvh], k0, BN)
                # (transposed: rows are keys in _exponent_t)
                p = torch.exp2(_exponent_t(K, Q, sl2, lse2, keys, slopes, h).T)
                if alibi:
                    masked = k0 + BN - 1 > r0 + off or k0 + BN > S
                else:
                    masked = (causal and k0 + BN - 1 > r0) or k0 + BN > S or sb is not None
                if masked:
                    p = torch.where(_allowed(rows, keys, S, 1 << 30, causal, sb, off), p,
                                    torch.zeros(()))
                acc += (p * (dO @ V.T - dlt[:, None])) @ K
            n = max(0, min(WG_ROWS, T - r0))
            dq[b, r0:r0 + n, h] = acc[:n] * scale
    if not alibi:
        return dq, dk, dv
    return dq, dk, dv, part.sum(dim=(0, 2))


# (B, T, S, H, KV, causal, segments)
CASES = [(2, 200, 200, 4, 2, True, False), (1, 37, 37, 4, 1, True, True),
         (2, 1, 1, 2, 2, True, False), (1, 130, 300, 4, 4, False, False),
         (1, 256, 256, 2, 2, True, True)]
CASE_IDS = ["gqa", "ragged-seg", "one-row", "full-t<s", "mha-seg"]


def _case(B, T, S, H, KV, Dh, segments, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, T, H, Dh)).astype(np.float32)
    k = rng.standard_normal((B, S, KV, Dh)).astype(np.float32)
    v = rng.standard_normal((B, S, KV, Dh)).astype(np.float32)
    dout = rng.standard_normal((B, T, H, Dh)).astype(np.float32)
    seg = None
    if segments:
        seg = np.sort(rng.integers(0, 3, size=(B, T)), axis=1).astype(np.int32)
    return q, k, v, dout, seg


@pytest.mark.parametrize("dh", WGMMA_HEAD_DIMS)
@pytest.mark.parametrize("B,T,S,H,KV,causal,segments", CASES, ids=CASE_IDS)
def test_forward_mirror_matches_jax(dh, B, T, S, H, KV, causal, segments):
    q, k, v, _, seg = _case(B, T, S, H, KV, dh, segments, seed=T + dh)
    out, lse = mirror_forward(T_(q), T_(k), T_(v), causal, None if seg is None else T_(seg))
    jseg = None if seg is None else jnp.asarray(seg)
    want = jreference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal, jseg)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    # lse against the log-sum-exp of the same masked scores
    logits = fa._masked_logits(T_(q), T_(k), causal, None if seg is None else T_(seg))
    np.testing.assert_allclose(lse.numpy(), torch.logsumexp(logits, -1).numpy(), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("dh", [d for d in WGMMA_HEAD_DIMS if d % 64 == 0])
@pytest.mark.parametrize("segments", [False, True], ids=["noseg", "seg"])
def test_forward_mirror_matches_splash_interpret(dh, segments):
    q, k, v, _, seg = _case(1, 256, 256, 4, 2, dh, segments, seed=7)
    out, _ = mirror_forward(T_(q), T_(k), T_(v), True, None if seg is None else T_(seg))
    want = splash_attention_gqa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
                                segment_ids=None if seg is None else jnp.asarray(seg),
                                interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dh", WGMMA_BWD_HEAD_DIMS)
@pytest.mark.parametrize("B,T,S,H,KV,causal,segments", CASES, ids=CASE_IDS)
def test_backward_mirror_matches_jax_vjp(dh, B, T, S, H, KV, causal, segments):
    q, k, v, dout, seg = _case(B, T, S, H, KV, dh, segments, seed=2 * T + dh)
    jseg = None if seg is None else jnp.asarray(seg)
    want_out, vjp = jax.vjp(lambda a, b_, c: jreference(a, b_, c, causal, jseg),
                            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(dout))
    tseg = None if seg is None else T_(seg)
    out, lse = mirror_forward(T_(q), T_(k), T_(v), causal, tseg)
    got = mirror_backward(T_(q), T_(k), T_(v), out, T_(dout), lse, causal, tseg)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("T,causal", [(1, True), (37, True), (200, True), (1000, True),
                                      (200, False)])
@pytest.mark.parametrize("n_rep", [1, 4])
def test_dkv_key_split_covers_each_key_once_per_consumer_in_a_fixed_order(T, causal, n_rep):
    """At 64 a dk/dv block is 128 keys: warpgroup w owns keys [k0 + 64 w,
    k0 + 64 w + 64). Every key lies in exactly one warpgroup's range; each
    warpgroup walks the block's iterations in the ring's order (heads
    ascending, query tiles ascending); the only ones that add nothing are
    query tiles wholly above its keys (all masked), and the rest hold every
    query that sees each of its keys, in every head of the group."""
    BN, BQ, _ = wgmma_tiles(64)["dkv"]
    assert BN == 2 * WG_ROWS
    S, kvh = T, 1
    owners = np.zeros(S, np.int64)
    for _, _, kt in dkv_blocks(1, S, 1, BN):
        its = dkv_iterations(kt, kvh, n_rep, T, causal, BQ, BN)
        assert its == sorted(its)
        for w in range(2):
            kw0 = kt * BN + w * WG_ROWS
            live = key_split_live(its, kw0, causal)
            assert live == sorted(live)
            for h, qt in set(its) - set(live):   # skipped: every query before every key
                assert causal and qt * BQ + BQ - 1 < kw0
            for key in range(kw0, min(kw0 + WG_ROWS, S)):
                owners[key] += 1
                seen = range(key, T) if causal else range(T)
                for g in range(n_rep):
                    tiles = {qt for h, qt in live if h == kvh * n_rep + g}
                    assert {x // BQ for x in seen} <= tiles
    assert (owners == 1).all()


@pytest.mark.parametrize("B,T,S,H,KV,segments", [(1, 256, 256, 4, 4, False),
                                                 (1, 256, 256, 4, 2, True),
                                                 (2, 384, 384, 4, 1, False)],
                         ids=["mha", "gqa-seg", "mqa"])
def test_backward_mirror_at_64_matches_splash_vjp_interpret(B, T, S, H, KV, segments):
    """Splash takes sequence lengths in multiples of 128; ragged T at 64 is
    held against ``jax.vjp`` of ``reference_attention`` above."""
    q, k, v, dout, seg = _case(B, T, S, H, KV, 64, segments, seed=T + H)
    jseg = None if seg is None else jnp.asarray(seg)
    _, vjp = jax.vjp(lambda a, b_, c: splash_attention_gqa(a, b_, c, causal=True,
                                                            segment_ids=jseg, interpret=True),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(dout))
    tseg = None if seg is None else T_(seg)
    out, lse = mirror_forward(T_(q), T_(k), T_(v), True, tseg)
    got = mirror_backward(T_(q), T_(k), T_(v), out, T_(dout), lse, True, tseg)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)


def test_dkv_column_split_is_the_joint_pass():
    """The two warpgroups' halves of dk and dv, concatenated, are the
    joint product over all the head-dim columns, bit for bit in f32 (each
    output column's sum runs over the same terms in the same order)."""
    q, k, v, dout, _ = _case(1, 64, 64, 2, 1, 256, False, seed=11)
    q, k, v, dout = map(T_, (q, k, v, dout))
    out, lse = mirror_forward(q, k, v, True)
    _, dk, dv = mirror_backward(q, k, v, out, dout, lse, True)
    delta = (dout * out).sum(-1).permute(0, 2, 1)
    sl2 = 256 ** -0.5 * LOG2E
    dk_joint, dv_joint = torch.zeros(64, 256), torch.zeros(64, 256)
    keys = torch.arange(64)
    for head in range(2):
        Q, dO = q[0, :, head], dout[0, :, head]
        p = torch.exp2(k[0, :, 0] @ Q.T * sl2 - lse[0, head][None] * LOG2E)
        p = torch.where(keys[:, None] > keys[None, :], torch.zeros(()), p)
        ds = p * (v[0, :, 0] @ dO.T - delta[0, head][None])
        dv_joint += p @ dO
        dk_joint += ds @ Q
    torch.testing.assert_close(dv[0, :, 0], dv_joint, rtol=0, atol=0)
    torch.testing.assert_close(dk[0, :, 0], dk_joint * 256 ** -0.5, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# The C arguments
# ---------------------------------------------------------------------------


class _Lib:   # records each C call's arguments
    def __init__(self, calls):
        self.calls = calls

    def __getattr__(self, name):
        return lambda *args: self.calls.setdefault(name, args) and 0


@pytest.mark.parametrize("dh", WGMMA_HEAD_DIMS)
@pytest.mark.parametrize("causal", [True, False])
def test_wrappers_hand_the_c_entry_points_operands_and_scratch(monkeypatch, dh, causal):
    calls, made = {}, {}
    monkeypatch.setattr(fa, "_lib", lambda: _Lib(calls))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: type("S", (), {"cuda_stream": 0}))
    real_empty, real_empty_like = torch.empty, torch.empty_like

    def empty(*shape, **kw):
        t = real_empty(*shape, **kw)
        made[t.data_ptr()] = (tuple(t.shape), t.dtype)
        return t

    def empty_like(x, **kw):
        t = real_empty_like(x, **kw)
        made[t.data_ptr()] = (tuple(t.shape), t.dtype)
        return t

    monkeypatch.setattr(torch, "empty", empty)
    monkeypatch.setattr(torch, "empty_like", empty_like)
    B, T, H, KV = 2, 37, 8, 2
    q = torch.zeros(B, T, H, dh, dtype=torch.bfloat16)
    k = torch.zeros(B, T, KV, dh, dtype=torch.bfloat16)
    v = torch.zeros(B, T, KV, dh, dtype=torch.bfloat16)
    out, lse = fa._launch(q, k, v, causal, None, want_lse=True)
    args = calls["sxt_flash_attention_bf16"]
    assert args[:7] == (q.data_ptr(), k.data_ptr(), v.data_ptr(), None, None, None, 0)
    assert args[7:9] == (out.data_ptr(), lse.data_ptr())
    assert made[args[7]] == ((B, T, H, dh), torch.bfloat16)
    assert made[args[8]] == ((B, H, T), torch.float32)
    assert args[9:17] == (B, T, T, H, KV, dh, int(causal), dh ** -0.5)
    if dh not in fa.BWD_HEAD_DIMS:   # 80, 96: forward only
        return
    dq, dk, dv = fa._launch_bwd(q, k, v, out, lse, q, causal, None)
    args = calls["sxt_flash_attention_bwd_bf16"]
    assert args[:7] == (q.data_ptr(), k.data_ptr(), v.data_ptr(), None, None, None, 0)
    assert args[7:10] == (out.data_ptr(), q.data_ptr(), lse.data_ptr())
    assert made[args[10]] == ((B, H, T), torch.float32)                # delta: scratch
    assert args[11:14] == (dq.data_ptr(), dk.data_ptr(), dv.data_ptr())
    assert made[args[12]] == ((B, T, KV, dh), torch.bfloat16)
    assert args[14:22] == (B, T, T, H, KV, dh, int(causal), dh ** -0.5)
