"""Paged decode and extend attention: CUDA kernels for Hopper, and their
plain PyTorch versions.

Replaces the TPU kernels ``shuffle_exchange_tpu/ops/paged_attention.py:
paged_decode_attention_pallas`` and ``paged_extend_attention_pallas``. The
kernels live in ``ops/csrc/paged_attention.cu`` (whose header says what
bounds them on the H100 and how their design answers it); ``_build``
compiles that file with ``nvcc`` at first use and this module binds it
with ctypes.

The plain versions port the JAX package's oracle path:
``inference/paged.py:gather_kv`` (gather the pool through the block table
into ``[B, S, KV, Dh]``) and ``inference/engine.py:decode_attention`` /
``extend_attention`` (dense attention with f32 scores). Like the JAX plain
path they round the softmax weights to the cache dtype before P·V; the
kernels keep them to ~16 bits (two bf16 terms), and the plain versions
given ``p_f32=True`` keep them in f32. The CPU tests hold the plain
versions against the JAX package in f32, where the two roundings agree,
and with ``p_f32=True`` against the Pallas kernels in bf16; on the card,
``chip_smoke.py`` holds each kernel against its plain version with
``p_f32=True`` in bf16.

The decode kernel splits each sequence: ``decode_splits`` picks, from the
card's SM count, splits of 256 of the table's ``W * bs`` positions, fewer
(down to 128) where the (sequence, kv head, split) blocks would not reach
one an SM, and one split where the (sequence, kv head) blocks reach two an
SM. Each split writes f32 partials (``acc``, ``m``, ``l``, one buffer)
that this module allocates, and a merge kernel combines them in split
order; with one split no partials exist and the kernel writes the output
itself. A decode block takes the whole query-head group of its kv head and
reads each K/V tile once; the extend kernel tiles a kv head's flattened
query rows by 64 and issues the tiles longest first.

ALiBi: given ``alibi_slopes`` [H] (f32 on the card), every form adds
``slope_h * j`` in f32 to the scaled score of logical key position j (the
sequence position the block table maps, never a pool slot), as JAX's
``decode_attention`` / ``extend_attention`` and its Pallas kernels do;
query head ``h = kv * G + g`` takes slope h.

int8/fp8 KV: given ``k_scale``/``v_scale`` [nblk, KV, bs] f32 (one scale
per stored (token, kv head) row), the pools are int8 or float8_e4m3fn.
The plain versions gather and then dequantize in f32 (JAX ``gather_kv``'s
pairs); the kernels stage the tile's raw one-byte rows and its scales,
widen the rows to bf16 (exactly), and apply the K scale to the score's
column and the V scale to the probability's column in f32. Slopes and
scales compose. The kernels take head_dim 64, 128, 256 (GPT-J-6B's), 80
(Pythia-2.8b's) or 96 (Phi-3-mini's) and any query-head group
``G = H / KV`` (Falcon-7B's 71 heads of 64 over one kv head). Another
head dim raises, naming its ROADMAP item (``HEAD_DIM_LATER``).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Tuple

import torch

from .dispatch import use_kernel

# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def gather_kv(ck: torch.Tensor, cv: torch.Tensor, block_table: torch.Tensor,
              k_scale=None, v_scale=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """ck/cv [nblk, KV, bs, Dh] (one layer), block_table [B, maxblk] (-1
    pad, read as block 0) -> k/v [B, maxblk*bs, KV, Dh]. Padding gathers
    whatever block 0 holds; callers mask by length. With scale planes
    ``k_scale``/``v_scale`` [nblk, KV, bs] the gathered rows are
    dequantized to f32 (``float(q) * scale``)."""
    bt = block_table.clamp_min(0).long()
    B, M = bt.shape

    def g(c):
        x = c[bt.reshape(-1)]                              # [B*M, KV, bs(, Dh)]
        x = x.reshape(B, M, *x.shape[1:]).transpose(2, 3)  # [B, M, bs, KV(, Dh)]
        return x.reshape(B, M * x.shape[2], *x.shape[3:])

    if k_scale is None:
        return g(ck), g(cv)
    return (g(ck).float() * g(k_scale)[..., None].float(),
            g(cv).float() * g(v_scale)[..., None].float())


def _alibi_bias(alibi_slopes, KV: int, G: int, S: int, device) -> torch.Tensor:
    """[KV, G, S] f32: ``slope_h * j`` for query head ``h = kv * G + g`` at
    key position j (JAX's ``reshape(KV, G)`` of the slopes)."""
    slopes = torch.as_tensor(alibi_slopes, dtype=torch.float32, device=device).reshape(KV, G)
    return slopes[:, :, None] * torch.arange(S, dtype=torch.float32, device=device)


def decode_attention(q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
                     kv_len: torch.Tensor, p_f32: bool = False,
                     alibi_slopes=None) -> torch.Tensor:
    """One query token against a dense cache: q [B,1,H,Dh], ck/cv
    [B,S,KV,Dh], kv_len [B] valid slots -> [B,1,H,Dh]. Cache-dtype operands
    with f32 products and sums (the upcast is exact), f32 softmax; the
    weights are rounded to the cache dtype before P·V unless ``p_f32``.
    ``alibi_slopes`` [H] add ``slope_h * j`` at key slot j."""
    B, S, KV, Dh = ck.shape
    H = q.shape[2]
    G = H // KV
    qf = q.to(ck.dtype).reshape(B, KV, G, Dh).float()
    scores = torch.einsum("bkgd,bskd->bkgs", qf, ck.float()) / math.sqrt(Dh)
    if alibi_slopes is not None:
        scores = scores + _alibi_bias(alibi_slopes, KV, G, S, ck.device)[None]
    pos = torch.arange(S, device=ck.device)
    mask = (pos[None, :] < kv_len.to(ck.device).long()[:, None])[:, None, None, :]
    scores = scores.masked_fill(~mask, torch.finfo(torch.float32).min)
    w = torch.exp(scores - scores.amax(-1, keepdim=True))
    w = w / w.sum(-1, keepdim=True)
    if not p_f32:
        w = w.to(cv.dtype).float()
    out = torch.einsum("bkgs,bskd->bkgd", w, cv.float())
    return out.reshape(B, 1, H, Dh).to(q.dtype)


def extend_attention(q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
                     start_pos: torch.Tensor, kv_len: torch.Tensor,
                     p_f32: bool = False, alibi_slopes=None) -> torch.Tensor:
    """A C-token chunk against a dense cache that already holds the chunk's
    own K/V: q [B,C,H,Dh], ck/cv [B,S,KV,Dh]; query i of sequence b sees
    slots s <= start_pos[b] + i and s < kv_len[b] -> [B,C,H,Dh]. The
    weights are rounded to the cache dtype before P·V unless ``p_f32``.
    ``alibi_slopes`` [H] add ``slope_h * j`` at key slot j."""
    B, S, KV, Dh = ck.shape
    C, H = q.shape[1], q.shape[2]
    G = H // KV
    dev = ck.device
    qf = q.to(ck.dtype).reshape(B, C, KV, G, Dh).float()
    scores = torch.einsum("bckgd,bskd->bckgs", qf, ck.float()) / math.sqrt(Dh)
    if alibi_slopes is not None:
        scores = scores + _alibi_bias(alibi_slopes, KV, G, S, dev)[None, None]
    lim = torch.minimum(
        start_pos.to(dev).long()[:, None] + torch.arange(C, device=dev)[None, :] + 1,
        kv_len.to(dev).long()[:, None])                     # [B, C]
    s_idx = torch.arange(S, device=dev)
    mask = (s_idx[None, None, :] < lim[:, :, None])[:, :, None, None, :]
    scores = scores.masked_fill(~mask, torch.finfo(torch.float32).min)
    w = torch.exp(scores - scores.amax(-1, keepdim=True))
    w = w / w.sum(-1, keepdim=True)
    if not p_f32:
        w = w.to(cv.dtype).float()
    out = torch.einsum("bckgs,bskd->bckgd", w, cv.float())
    return out.reshape(B, C, H, Dh).to(q.dtype)


def paged_decode_reference(q, ck, cv, block_table, kv_len, p_f32=False, alibi_slopes=None,
                           k_scale=None, v_scale=None):
    """The plain paged decode: gather through the table (so slot j of the
    gathered cache is logical position j; dequantized in f32 given scale
    planes), dense decode."""
    k, v = gather_kv(ck, cv, block_table, k_scale, v_scale)
    return decode_attention(q, k, v, kv_len, p_f32, alibi_slopes)


def paged_extend_reference(q, ck, cv, block_table, start, nnew, p_f32=False,
                           alibi_slopes=None, k_scale=None, v_scale=None):
    """The plain paged extend: gather through the table (dequantized given
    scale planes), dense extend with ``kv_len = start + nnew``. Rows past
    ``nnew`` are don't-care (the engine reads logits at ``nnew - 1``) and
    differ from the kernel's."""
    k, v = gather_kv(ck, cv, block_table, k_scale, v_scale)
    return extend_attention(q, k, v, start, start + nnew, p_f32, alibi_slopes)


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


def scales_given(k_scale, v_scale) -> bool:
    """Whether a call carries scale planes (both or neither)."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError("paged attention: k_scale and v_scale go together")
    return k_scale is not None


def scale_kw(k_scale, v_scale) -> dict:
    """The launch's scale-plane keywords (none for a bf16 pool)."""
    return {} if k_scale is None else dict(k_scale=k_scale, v_scale=v_scale)


def paged_decode_attention(q, ck, cv, block_table, kv_len, *,
                           alibi_slopes=None, k_scale=None, v_scale=None):
    """q [B,1,H,Dh] against one layer of the pool ck/cv [nblk,KV,bs,Dh]
    through block_table [B,W]; kv_len [B] -> [B,1,H,Dh]; ``alibi_slopes``
    [H] add ``slope_h * j`` at logical key position j; ``k_scale`` /
    ``v_scale`` [nblk,KV,bs] f32 dequantize an int8 or e4m3 pool. The CUDA
    kernel on a CUDA tensor, the plain version on a CPU tensor."""
    scales_given(k_scale, v_scale)
    if not use_kernel(q):
        return paged_decode_reference(q, ck, cv, block_table, kv_len,
                                      alibi_slopes=alibi_slopes, k_scale=k_scale,
                                      v_scale=v_scale)
    out = _launch("decode", q, ck, cv, block_table, kv_len, alibi_slopes,
                  **scale_kw(k_scale, v_scale))
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0


def paged_extend_attention(q, ck, cv, block_table, start, nnew, *,
                           alibi_slopes=None, k_scale=None, v_scale=None):
    """A C-token chunk per sequence, q [B,C,H,Dh], whose own K/V are
    already in the pool; start [B] first new position, nnew [B] <= C.
    Row c of sequence b sees pool positions < start[b] + c + 1;
    ``alibi_slopes`` and the scale planes as in
    :func:`paged_decode_attention`. The CUDA kernel on a CUDA tensor, the
    plain version on a CPU tensor."""
    scales_given(k_scale, v_scale)
    if not use_kernel(q):
        return paged_extend_reference(q, ck, cv, block_table, start, nnew,
                                      alibi_slopes=alibi_slopes, k_scale=k_scale,
                                      v_scale=v_scale)
    out = _launch("extend", q, ck, cv, block_table, start, alibi_slopes,
                  **scale_kw(k_scale, v_scale))
    paged_extend_attention.launches += 1
    return out


paged_extend_attention.launches = 0


# ---------------------------------------------------------------------------
# Launch
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "sxt_paged_decode": [_P] * 12 + [_I] * 9 + [ctypes.c_float, _P],
    "sxt_paged_extend": [_P] * 9 + [_I] * 8 + [ctypes.c_float, _P],
}
#: the kernels' storage codes (paged_tile.cuh: KvBf16, KvInt8, KvFp8)
KV_KINDS = {torch.bfloat16: 0, torch.int8: 1, torch.float8_e4m3fn: 2}
#: the head dims the paged kernels (and the split-K decode kernel) are built for:
#: multiples of 16, so a stored row is whole 16-byte vectors
HEAD_DIMS = (64, 80, 96, 128, 256)
#: what a head dim outside HEAD_DIMS waits for
HEAD_DIM_LATER = ("ROADMAP queue A, item 4 (h): the paged and split-K kernels are built at "
                  "head dims that are multiples of 16")
#: query heads a decode block (B2 and B5: ``csrc/paged_decode.cuh``) takes in
#: one pass past a group of 16: 128 at head_dim <= 96, 64 above (registers)
DECODE_PASS_HEADS = {64: 128, 80: 128, 96: 128, 128: 64, 256: 64}
#: the decode kernel's splits are whole multiples of this many positions
DECODE_SPLIT_UNIT = 16
#: positions of a decode split, and the fewest a split is cut to where the
#: (sequence, kv head, split) blocks would not reach one an SM
DECODE_SPLIT_LEN, DECODE_SPLIT_MIN = 256, 128


def decode_passes(G: int, Dh: int) -> Tuple[int, int]:
    """(query heads a pass of a decode block takes, passes): a block of the
    paged decode kernels (B2, B5) holds the whole query-head group of its kv
    head, in one pass up to ``DECODE_PASS_HEADS[Dh]`` heads (any group of 16
    or fewer: one MMA row tile), walking its split again for the next heads
    past that (``paged_decode.cuh: DecodeShape``)."""
    per = G if G <= 16 else min(G, DECODE_PASS_HEADS[Dh])
    return per, -(-G // per)


def decode_splits(B: int, KV: int, width: int, bs: int, sms: int) -> Tuple[int, int]:
    """(splits, positions per split) of the paged decode kernel over a table
    of ``width`` entries of ``bs`` positions on a card of ``sms`` SMs: one
    split (the kernel then writes the output without a merge) where the
    ``B * KV`` (sequence, kv head) blocks reach ``2 * sms``; else splits of
    DECODE_SPLIT_LEN positions, cut to as few as DECODE_SPLIT_MIN (in
    multiples of DECODE_SPLIT_UNIT) where those leave fewer than ``sms``
    blocks; none empty."""
    positions, blocks = width * bs, B * KV
    if blocks >= 2 * sms:
        return 1, positions
    per = DECODE_SPLIT_LEN
    if blocks * -(-positions // per) < sms:
        want = -(-sms // blocks)
        per = max(DECODE_SPLIT_MIN, positions // want // DECODE_SPLIT_UNIT * DECODE_SPLIT_UNIT)
    if per >= positions:
        return 1, positions
    return -(-positions // per), per


@functools.lru_cache(None)
def _sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


_LIB = []


def _lib():
    if not _LIB:
        from . import _build

        lib = _build.load("paged_attention")
        for name, args in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = ctypes.c_int
        lib.sxt_cuda_error_string.argtypes = [ctypes.c_int]
        lib.sxt_cuda_error_string.restype = ctypes.c_char_p
        _LIB.append(lib)
    return _LIB[0]


def pool_kind(q, ck, cv, k_scale, v_scale, what: str = "paged kernel") -> int:
    """The storage code the kernels take for this pool, after checking
    what they read: q bf16; a bf16 pool without scales, or an int8 / e4m3
    pool with f32 scale planes [nblk, KV, bs]; all on q's device,
    contiguous and 16-byte aligned. Anything else raises (nothing is
    cast or copied)."""
    for name, t in (("q", q), ("k pool", ck), ("v pool", cv)):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{what}: {name} must be on {q.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must be contiguous and 16-byte aligned")
    if q.dtype != torch.bfloat16:
        raise TypeError(f"{what}: q must be bf16, got {q.dtype}")
    quant = scales_given(k_scale, v_scale)
    if ck.dtype != cv.dtype or ck.dtype not in KV_KINDS or quant != (ck.dtype != torch.bfloat16):
        raise TypeError(f"{what}: pools must be bf16 without scale planes or int8 / "
                        f"float8_e4m3fn with them, got {ck.dtype} / {cv.dtype} "
                        f"{'with' if quant else 'without'} scales")
    if quant:
        for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
            if (t.device != q.device or t.dtype != torch.float32 or not t.is_contiguous()
                    or tuple(t.shape) != tuple(ck.shape[:3])):
                raise ValueError(f"{what}: {name} must be contiguous f32 "
                                 f"{list(ck.shape[:3])} on {q.device}, got {t.dtype} "
                                 f"{tuple(t.shape)} on {t.device}")
    return KV_KINDS[ck.dtype]


def _check_operands(q, ck, cv, k_scale=None, v_scale=None) -> int:
    kind = pool_kind(q, ck, cv, k_scale, v_scale)
    if ck.shape != cv.shape or ck.dim() != 4:
        raise ValueError(f"paged kernel: pools must be [nblk,KV,bs,Dh], got "
                         f"{tuple(ck.shape)} / {tuple(cv.shape)}")
    H, Dh = q.shape[2], q.shape[3]
    KV = ck.shape[1]
    if ck.shape[3] != Dh or H % KV:
        raise ValueError(f"paged kernel: q heads {H} / Dh {Dh} do not match "
                         f"pool {tuple(ck.shape)}")
    if Dh not in HEAD_DIMS:
        raise ValueError(f"paged kernel: head_dim {Dh} not built {HEAD_DIMS} ({HEAD_DIM_LATER})")
    return kind


def alibi_operand(slopes, H: int, device, what: str = "paged kernel"):
    """The slopes a kernel reads: f32 [H] contiguous on ``device``, or None.
    A CUDA tensor of another dtype or device raises (no silent cast or
    copy); host arrays are moved once."""
    if slopes is None:
        return None
    if not isinstance(slopes, torch.Tensor):
        slopes = torch.as_tensor(slopes, dtype=torch.float32, device=device)
    if slopes.device != device or slopes.dtype != torch.float32:
        raise TypeError(f"{what}: ALiBi slopes must be f32 on {device}, got {slopes.dtype} "
                        f"on {slopes.device}")
    if tuple(slopes.shape) != (H,):
        raise ValueError(f"{what}: ALiBi slopes must be [H] = [{H}], got "
                         f"{tuple(slopes.shape)}")
    return slopes.contiguous()


def _index(t, B, device, what):
    t = torch.as_tensor(t, device=device)
    if t.dtype.is_floating_point or t.shape[0] != B:
        raise ValueError(f"paged kernel: bad {what} {tuple(t.shape)} {t.dtype}")
    return t.to(torch.int32).contiguous()


def _launch(kind, q, ck, cv, block_table, lens, alibi_slopes=None, k_scale=None,
            v_scale=None):
    store = _check_operands(q, ck, cv, k_scale, v_scale)
    ks_ptr = None if k_scale is None else k_scale.data_ptr()
    vs_ptr = None if v_scale is None else v_scale.data_ptr()
    B, C, H, Dh = q.shape
    slopes = alibi_operand(alibi_slopes, H, q.device)
    sl_ptr = None if slopes is None else slopes.data_ptr()
    KV, bs = ck.shape[1], ck.shape[2]
    table = _index(block_table, B, q.device, "block table")
    if table.dim() != 2:
        raise ValueError(f"paged kernel: block table must be [B, W], got "
                         f"{tuple(table.shape)}")
    W = table.shape[1]
    lens = _index(lens, B, q.device, "kv_len" if kind == "decode" else "start")
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    lib = _lib()
    scale = float(Dh) ** -0.5
    if kind == "decode":
        if C != 1:
            raise ValueError("paged decode kernel: one query token per sequence")
        splits, split_len = decode_splits(B, KV, W, bs, _sms(q.device))
        part = [None] * 3
        if splits > 1:   # the splits' f32 acc, m and l (merged by the second kernel), one buffer
            rows = B * splits * H
            buf = torch.empty(rows * (Dh + 2), device=q.device, dtype=torch.float32)
            part = [buf.data_ptr() + 4 * rows * off for off in (0, Dh, Dh + 1)]
        err = lib.sxt_paged_decode(
            q.data_ptr(), ck.data_ptr(), cv.data_ptr(), ks_ptr, vs_ptr, table.data_ptr(),
            lens.data_ptr(), sl_ptr, out.data_ptr(), *part, store, B, H, KV, Dh, bs, W,
            splits, split_len, scale, stream)
    else:
        err = lib.sxt_paged_extend(
            q.data_ptr(), ck.data_ptr(), cv.data_ptr(), ks_ptr, vs_ptr, table.data_ptr(),
            lens.data_ptr(), sl_ptr, out.data_ptr(), store, B, C, H, KV, Dh, bs, W, scale,
            stream)
    if err:
        raise RuntimeError(f"paged {kind} kernel launch failed: CUDA error "
                           f"{err} ({lib.sxt_cuda_error_string(err).decode()})")
    return out
