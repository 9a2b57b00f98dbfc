"""The fused decode layer: CUDA kernels for Hopper, and their plain PyTorch
versions.

Replaces the TPU kernels of ``shuffle_exchange_tpu/ops/fused_decode.py``:

- ``fused_qkv_rope_pallas``: QKV projection, rotate-half RoPE in f32 and
  the in-place append of the new token's K/V to the layer's pool;
- ``fused_paged_decode_attention_pallas``: split-K flash-decode over the
  block table with an (m, l, acc) merge;
- ``fused_mlp_pallas``: RMSNorm + SwiGLU MLP + residual.

The kernels live in ``ops/csrc/fused_decode.cu`` (whose header says what
bounds them on the H100 and how their design answers it); ``_build``
compiles that file with ``nvcc`` at first use and this module binds it
with ctypes. Each wrapper runs its kernel for a CUDA tensor and its plain
version for a CPU tensor, and counts one launch per call on the card
(``<wrapper>.launches``), whatever number of CUDA kernels the call runs.

The plain versions keep the TPU kernels' rounding points: QKV sums in f32,
RoPE in f32 and one cast; attention with q scaled in f32, f32 softmax
weights (not rounded to the cache dtype) and the split merge; the MLP with
yn and a = silu(g)*u rounded to the activation dtype and the residual added
in f32. In this slice the kernels take bf16 weights and pools without
biases, ALiBi or scale planes; those raise, naming the ROADMAP item.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .dispatch import use_kernel
from .paged_attention import gather_kv

_NEG = -1e30     # the TPU kernels' finite mask sentinel

# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def rope_heads(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate-half RoPE in f32 on per-head rows: x [B, n, Dh] f32, cos/sin
    [B, Dh/2] f32 rows at each sequence's position. Column d's partner is
    d + Dh/2 (first half, negated) or d - Dh/2 (second half), as in JAX's
    flat-layout ``_rope_flat``."""
    c, s = cos[:, None, :], sin[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def append_rows(pool_k, pool_v, k, v, block_table, pos) -> None:
    """Write k/v [B, KV, Dh] into one layer's pool at (table[b, pos//bs],
    :, pos % bs, :), in place; -1 table entries are read as block 0."""
    bs = pool_k.shape[2]
    pos = pos.long()
    col = (pos // bs).clamp(max=block_table.shape[1] - 1)
    blk = block_table.clamp_min(0).long().gather(1, col[:, None])[:, 0]
    pool_k[blk, :, pos % bs] = k.to(pool_k.dtype)
    pool_v[blk, :, pos % bs] = v.to(pool_v.dtype)


def fused_qkv_rope_reference(y, wq, wk, wv, cos, sin, pool_k, pool_v, block_table, pos,
                             *, n_heads: int, kv_heads: int):
    """y [B, D] -> (q [B, H, Dh], k, v [B, KV, Dh]) in y's dtype, with k/v
    appended to the pool in place: f32 products and sums, RoPE in f32 from
    the f32 rows cos/sin [B, Dh/2], one cast."""
    B = y.shape[0]
    H, KV = n_heads, kv_heads
    Dh = wq.shape[1] // H
    yf = y.float()
    q = (yf @ wq.float()).reshape(B, H, Dh)
    k = (yf @ wk.float()).reshape(B, KV, Dh)
    v = (yf @ wv.float()).reshape(B, KV, Dh)
    q = rope_heads(q, cos.float(), sin.float()).to(y.dtype)
    k = rope_heads(k, cos.float(), sin.float()).to(y.dtype)
    v = v.to(y.dtype)
    append_rows(pool_k, pool_v, k, v, block_table, pos)
    return q, k, v


def split_count(width: int, num_splits: int) -> Tuple[int, int]:
    """(splits, table entries per split) for a table of ``width`` entries:
    at most ``num_splits`` and ``width`` splits, none of them empty by
    construction (a sequence may still end before a split starts)."""
    spb = -(-width // max(1, min(int(num_splits), width)))
    return -(-width // spb), spb


def fused_paged_decode_reference(q, ck, cv, block_table, kv_len, num_splits: int = 2):
    """Split-K paged decode: q [B,1,H,Dh] against one layer of the pool
    through block_table [B,W]; kv_len [B] -> [B,1,H,Dh]. Each split of the
    table gives (m, l, acc) in f32 with q scaled in f32 and the softmax
    weights kept in f32 (masked scores -1e30; a split with no visible
    position gives m = -1e30, l = 0); the merge is that of the TPU
    kernel."""
    B, _, H, Dh = q.shape
    KV, bs = ck.shape[1], ck.shape[2]
    G = H // KV
    W = block_table.shape[1]
    S, spb = split_count(W, num_splits)
    k, v = gather_kv(ck, cv, block_table)                  # [B, W*bs, KV, Dh]
    P, L = S * spb * bs, spb * bs
    k = F.pad(k.float(), (0, 0, 0, 0, 0, P - W * bs))
    v = F.pad(v.float(), (0, 0, 0, 0, 0, P - W * bs))
    qf = q.reshape(B, KV, G, Dh).float() * Dh ** -0.5
    sc = torch.einsum("bkgd,bpkd->bkgp", qf, k)
    valid = (torch.arange(P, device=q.device)[None, :]
             < kv_len.to(q.device).long()[:, None])[:, None, None, :]
    sc = sc.masked_fill(~valid, _NEG).reshape(B, KV, G, S, L)
    valid = valid.reshape(B, 1, 1, S, L)
    m = sc.amax(-1)                                         # [B, KV, G, S]
    p = torch.where(valid, torch.exp(sc - m[..., None]), torch.zeros_like(sc))
    l = p.sum(-1)
    acc = torch.einsum("bkgsl,bslkd->bkgsd", p, v.reshape(B, S, L, KV, Dh))
    m_g = m.amax(-1, keepdim=True)
    w = torch.exp(m - m_g)
    out = (w[..., None] * acc).sum(-2) / (w * l).sum(-1, keepdim=True).clamp_min(1e-30)
    return out.reshape(B, 1, H, Dh).to(q.dtype)


def fused_mlp_reference(resid, y_src, ln_w, w_up, w_down, w_gate, eps: float = 1e-5):
    """``resid + w_down·(silu(yn·w_gate) ⊙ yn·w_up)``, yn = RMSNorm(y_src):
    f32 statistics, yn and a rounded to resid's dtype, products summed in
    f32, the residual added in f32, one cast."""
    x32 = y_src.float()
    var = (x32 * x32).mean(-1, keepdim=True)
    yn = (x32 * torch.rsqrt(var + eps) * ln_w.float()).to(resid.dtype).float()
    a = (F.silu(yn @ w_gate.float()) * (yn @ w_up.float())).to(resid.dtype).float()
    return (resid.float() + a @ w_down.float()).to(resid.dtype)


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


def _refuse_biases(what: str, *biases) -> None:
    if any(b is not None for b in biases):
        raise NotImplementedError(f"{what} biases in the fused decode kernels are not "
                                  "ported yet: ROADMAP queue A, item 4")


def fused_qkv_rope(y, wq, wk, wv, cos, sin, pool_k, pool_v, block_table, pos, *,
                   n_heads: int, kv_heads: int, bq=None, bk=None, bv=None):
    """One token per sequence: y [B, D] (the normalised hidden rows) ->
    (q [B, H, Dh], k, v [B, KV, Dh]); rotate-half RoPE from the f32 rows
    cos/sin [B, Dh/2] at each row's position ``pos`` [B]; the new K/V is
    written into the layer's pool [nblk, KV, bs, Dh] in place at
    (block_table[b, pos//bs], :, pos % bs). The CUDA kernel on a CUDA
    tensor, the plain version on a CPU tensor."""
    _refuse_biases("QKV", bq, bk, bv)
    if not use_kernel(y):
        return fused_qkv_rope_reference(y, wq, wk, wv, cos, sin, pool_k, pool_v,
                                        block_table, pos, n_heads=n_heads, kv_heads=kv_heads)
    out = _launch_qkv(y, wq, wk, wv, cos, sin, pool_k, pool_v, block_table, pos,
                      n_heads, kv_heads)
    fused_qkv_rope.launches += 1
    return out


fused_qkv_rope.launches = 0


def fused_paged_decode_attention(q, ck, cv, block_table, kv_len, *,
                                 num_splits: Optional[int] = None, alibi_slopes=None,
                                 k_scale=None, v_scale=None):
    """Split-K paged decode: q [B,1,H,Dh] against one layer of the pool
    ck/cv [nblk,KV,bs,Dh] through block_table [B,W]; kv_len [B] ->
    [B,1,H,Dh]. ``num_splits`` defaults to the split count that fills the
    card's SMs (on the CPU, JAX's default of 2); the result does not
    depend on it beyond rounding. The CUDA kernel on a CUDA tensor, the
    plain version on a CPU tensor."""
    if alibi_slopes is not None:
        raise NotImplementedError("ALiBi slopes in the split-K decode kernel are not "
                                  "ported yet: ROADMAP queue A, item 3")
    if k_scale is not None or v_scale is not None:
        raise NotImplementedError("int8/fp8 KV scale planes in the split-K decode kernel "
                                  "are not ported yet: ROADMAP queue A, item 3")
    if not use_kernel(q):
        return fused_paged_decode_reference(q, ck, cv, block_table, kv_len,
                                            2 if num_splits is None else num_splits)
    out = _launch_attention(q, ck, cv, block_table, kv_len, num_splits)
    fused_paged_decode_attention.launches += 1
    return out


fused_paged_decode_attention.launches = 0


def fused_mlp(resid, y_src, ln_w, w_up, w_down, w_gate, *, eps: float = 1e-5,
              b_up=None, b_down=None):
    """``resid + mlp(RMSNorm(y_src))`` for one token per sequence: resid /
    y_src [B, D], ln_w [D], w_gate / w_up [D, F], w_down [F, D], SwiGLU.
    The CUDA kernels on a CUDA tensor, the plain version on a CPU tensor."""
    _refuse_biases("MLP", b_up, b_down)
    if w_gate is None:
        raise NotImplementedError("the non-gated fused MLP is not ported yet: ROADMAP "
                                  "queue A, item 4")
    if not use_kernel(resid):
        return fused_mlp_reference(resid, y_src, ln_w, w_up, w_down, w_gate, eps)
    out = _launch_mlp(resid, y_src, ln_w, w_up, w_down, w_gate, eps)
    fused_mlp.launches += 1
    return out


fused_mlp.launches = 0


# ---------------------------------------------------------------------------
# Launch
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "sxt_fused_qkv_rope_bf16": [_P] * 14 + [_I] * 9 + [_P],
    "sxt_fused_paged_decode_bf16": [_P] * 9 + [_I] * 7 + [_F, _P],
    "sxt_fused_mlp_bf16": [_P] * 11 + [_I] * 7 + [_F, _P],
}
_LIB = []

GEMV_TILE = 64       # output columns per block of the GEMV kernel
GEMV_CHUNK = 1024    # reduction rows per block, at most
GEMV_ROWS = 8        # activation rows per launch


def _lib():
    if not _LIB:
        from . import _build

        lib = _build.load("fused_decode")
        for name, args in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = ctypes.c_int
        lib.sxt_fused_error_string.argtypes = [ctypes.c_int]
        lib.sxt_fused_error_string.restype = ctypes.c_char_p
        _LIB.append(lib)
    return _LIB[0]


def _sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def gemv_splits(K: int, n_cols: Tuple[int, ...], sms: int) -> Tuple[int, int]:
    """(splits, chunk) of a reduction over K rows for output matrices of
    ``n_cols`` columns: chunks of at most GEMV_CHUNK rows (a multiple of
    8), and enough of them that the blocks number at least twice the SMs."""
    tiles = sum(-(-n // GEMV_TILE) for n in n_cols)
    splits = max(-(-K // GEMV_CHUNK), -(-2 * sms // tiles), 1)
    per_split = -(-K // splits)
    chunk = -(-per_split // 8) * 8
    return -(-K // chunk), chunk


def attention_splits(B: int, KV: int, width: int, sms: int) -> int:
    """The split count for the card: enough (sequence, kv head, split)
    blocks for two per SM, capped by the table width."""
    return split_count(width, -(-2 * sms // max(1, B * KV)))[0]


def _bf16(name, t, device, shape=None):
    if not t.is_cuda or t.device != device:
        raise ValueError(f"fused decode kernel: {name} must be on {device}")
    if t.dtype != torch.bfloat16:
        raise TypeError(f"fused decode kernel: {name} must be bf16 (this slice's kernels "
                        f"take bf16 weights, activations and pools), got {t.dtype}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"fused decode kernel: {name} must be contiguous and 16-byte aligned")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"fused decode kernel: {name} shape {tuple(t.shape)} != {tuple(shape)}")
    return t


def _index(t, B, device, what, dims=1):
    t = torch.as_tensor(t, device=device)
    if t.dtype.is_floating_point or t.dim() != dims or t.shape[0] != B:
        raise ValueError(f"fused decode kernel: bad {what} {tuple(t.shape)} {t.dtype}")
    return t.to(torch.int32).contiguous()


def _raise_on(err, lib, what):
    if err:
        raise RuntimeError(f"fused {what} kernel launch failed: CUDA error {err} "
                           f"({lib.sxt_fused_error_string(err).decode()})")


def _launch_qkv(y, wq, wk, wv, cos, sin, pool_k, pool_v, block_table, pos, H, KV):
    dev = y.device
    B, D = y.shape
    Nq, Nkv = wq.shape[1], wk.shape[1]
    Dh = Nq // H
    if Nq != H * Dh or Nkv != KV * Dh or H % KV or Dh % 8 or Dh > 1024:
        raise ValueError(f"fused QKV kernel: wq {tuple(wq.shape)} / wk {tuple(wk.shape)} do "
                         f"not split into {H} / {KV} heads of a head_dim divisible by 8")
    _bf16("y", y, dev)
    _bf16("wq", wq, dev, (D, Nq))
    _bf16("wk", wk, dev, (D, Nkv))
    _bf16("wv", wv, dev, (D, Nkv))
    _bf16("k pool", pool_k, dev)
    _bf16("v pool", pool_v, dev, pool_k.shape)
    if pool_k.dim() != 4 or pool_k.shape[1] != KV or pool_k.shape[3] != Dh:
        raise ValueError(f"fused QKV kernel: pool {tuple(pool_k.shape)} is not "
                         f"[nblk, {KV}, bs, {Dh}]")
    rope = []
    for name, t in (("cos", cos), ("sin", sin)):
        if t.device != dev or t.dtype != torch.float32 or tuple(t.shape) != (B, Dh // 2):
            raise ValueError(f"fused QKV kernel: {name} must be f32 [{B}, {Dh // 2}] on {dev}")
        rope.append(t.contiguous())
    table = _index(block_table, B, dev, "block table", dims=2)
    pos = _index(pos, B, dev, "pos")
    q = torch.empty(B, H, Dh, device=dev, dtype=y.dtype)
    k = torch.empty(B, KV, Dh, device=dev, dtype=y.dtype)
    v = torch.empty(B, KV, Dh, device=dev, dtype=y.dtype)
    splits, chunk = gemv_splits(D, (Nq, Nkv, Nkv), _sms(dev))
    part = torch.empty(splits, min(B, GEMV_ROWS), Nq + 2 * Nkv, device=dev,
                       dtype=torch.float32)
    lib = _lib()
    err = lib.sxt_fused_qkv_rope_bf16(
        y.data_ptr(), wq.data_ptr(), wk.data_ptr(), wv.data_ptr(), rope[0].data_ptr(),
        rope[1].data_ptr(), table.data_ptr(), pos.data_ptr(), pool_k.data_ptr(),
        pool_v.data_ptr(), q.data_ptr(), k.data_ptr(), v.data_ptr(), part.data_ptr(),
        B, D, H, KV, Dh, pool_k.shape[2], table.shape[1], splits, chunk,
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, lib, "QKV")
    return q, k, v


def _launch_attention(q, ck, cv, block_table, kv_len, num_splits):
    dev = q.device
    B, one, H, Dh = q.shape
    if one != 1:
        raise ValueError("split-K decode kernel: one query token per sequence")
    _bf16("q", q, dev)
    _bf16("k pool", ck, dev)
    _bf16("v pool", cv, dev, ck.shape)
    if ck.dim() != 4 or ck.shape[3] != Dh or H % ck.shape[1]:
        raise ValueError(f"split-K decode kernel: q heads {H} / Dh {Dh} do not match pool "
                         f"{tuple(ck.shape)}")
    KV, bs = ck.shape[1], ck.shape[2]
    if Dh not in (64, 128):
        raise ValueError(f"split-K decode kernel: head_dim {Dh} not built (64, 128)")
    if (H // KV) * Dh > 1024:
        raise ValueError(f"split-K decode kernel: G*Dh = {(H // KV) * Dh} > 1024")
    table = _index(block_table, B, dev, "block table", dims=2)
    lens = _index(kv_len, B, dev, "kv_len")
    W = table.shape[1]
    if num_splits is None:
        splits = attention_splits(B, KV, W, _sms(dev))
    else:
        splits = split_count(W, num_splits)[0]
    out = torch.empty_like(q)
    o_part = torch.empty(B, splits, H, Dh, device=dev, dtype=torch.float32)
    m_part = torch.empty(B, splits, H, device=dev, dtype=torch.float32)
    l_part = torch.empty(B, splits, H, device=dev, dtype=torch.float32)
    lib = _lib()
    err = lib.sxt_fused_paged_decode_bf16(
        q.data_ptr(), ck.data_ptr(), cv.data_ptr(), table.data_ptr(), lens.data_ptr(),
        out.data_ptr(), o_part.data_ptr(), m_part.data_ptr(), l_part.data_ptr(),
        B, H, KV, Dh, bs, W, splits, float(Dh) ** -0.5,
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, lib, "split-K decode")
    return out


def _launch_mlp(resid, y_src, ln_w, w_up, w_down, w_gate, eps):
    dev = resid.device
    B, D = resid.shape
    Fd = w_up.shape[1]
    if D % 8 or Fd % 8:
        raise ValueError(f"fused MLP kernel: D={D} and F={Fd} must be multiples of 8")
    _bf16("resid", resid, dev)
    _bf16("y_src", y_src, dev, (B, D))
    _bf16("ln_w", ln_w, dev, (D,))
    _bf16("w_gate", w_gate, dev, (D, Fd))
    _bf16("w_up", w_up, dev, (D, Fd))
    _bf16("w_down", w_down, dev, (Fd, D))
    rows = min(B, GEMV_ROWS)
    sms = _sms(dev)
    s1, c1 = gemv_splits(D, (Fd, Fd), sms)
    s2, c2 = gemv_splits(Fd, (D,), sms)
    out = torch.empty_like(resid)
    yn = torch.empty(rows, D, device=dev, dtype=resid.dtype)
    a = torch.empty(rows, Fd, device=dev, dtype=resid.dtype)
    part1 = torch.empty(s1, rows, 2 * Fd, device=dev, dtype=torch.float32)
    part2 = torch.empty(s2, rows, D, device=dev, dtype=torch.float32)
    lib = _lib()
    err = lib.sxt_fused_mlp_bf16(
        resid.data_ptr(), y_src.data_ptr(), ln_w.data_ptr(), w_gate.data_ptr(),
        w_up.data_ptr(), w_down.data_ptr(), out.data_ptr(), yn.data_ptr(), a.data_ptr(),
        part1.data_ptr(), part2.data_ptr(), B, D, Fd, s1, c1, s2, c2, float(eps),
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, lib, "MLP")
    return out


__all__ = ["fused_mlp", "fused_mlp_reference", "fused_paged_decode_attention",
           "fused_paged_decode_reference", "fused_qkv_rope", "fused_qkv_rope_reference",
           "gemv_splits", "attention_splits", "split_count", "rope_heads"]
