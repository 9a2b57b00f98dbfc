"""The fused decode layer: CUDA kernels for Hopper, and their plain PyTorch
versions.

Replaces the TPU kernels of ``shuffle_exchange_tpu/ops/fused_decode.py``:

- ``fused_qkv_rope_pallas``: QKV projection, q/k/v biases in f32 (all
  three or none), rotate-half RoPE in f32 over all of head_dim or its
  first rd columns (partial rotary: GPT-NeoX / Pythia), the rest passed
  through (none without cos / sin: the learned-position and ALiBi
  families) and, given a pool, the in-place
  append of the new token's K/V to the layer's pool (the paged engine);
  without one, q/k/v only (the dense-cache v1 engine);
- ``fused_paged_decode_attention_pallas``: split-K flash-decode over the
  block table with an (m, l, acc) merge, with ALiBi slopes, over a bf16
  pool or an int8 / e4m3 pool with f32 scale planes (dequantized in
  registers as in ``ops/paged_attention.py``), head_dim 64, 80, 96, 128
  or 256, any query-head group (Falcon-7B's 71 heads over one kv head);
- ``fused_mlp_pallas``: RMSNorm, layernorm (with its bias) or no norm
  (``apply_norm=False``: the shared layernorm's y of GPT-J's parallel
  blocks) + a gated (SwiGLU) or plain MLP with one of
  ``FUSABLE_ACTIVATIONS`` and optional fc biases + residual;
- ``fused_mlp_quant_pallas``: the same over int8 / packed-int4 / e4m3
  weights (``QuantizedMatrix``, ``ops/quant_matmul.py``), which
  ``fused_mlp`` dispatches to, as the JAX wrapper does.

The kernels live in ``ops/csrc/fused_decode.cu`` (whose header says what
bounds them on the H100 and how their design answers it); ``_build``
compiles that file with ``nvcc`` at first use and this module binds it
with ctypes. Each wrapper runs its kernel for a CUDA tensor and its plain
version for a CPU tensor, and counts one launch per call on the card
(``<wrapper>.launches``), whatever number of CUDA kernels the call runs.

The plain versions keep the TPU kernels' rounding points: QKV sums in f32,
the biases added in f32, RoPE in f32 and one cast; attention with q scaled
in f32, ALiBi's ``slope_h * j`` added in f32 at the logical key position,
f32 softmax weights (not rounded to the cache dtype) and the split merge;
the MLP with yn and a = act(g)*u (or act(u + b_up)) rounded to the
activation dtype and the residual and down bias added in f32; the
quantized MLP dequantizes its weights to f32 (the JAX kernel's
``dot(bf16, f32)`` promotes) and rounds at the same points. The unfused
layer body rounds elsewhere (a bf16 product, then a bf16 bias), so the
fused and unfused paths differ by a bf16 step. The kernels take bf16
activations, weights and biases and f32 slopes and scale planes. The
quantized MLP takes every norm, gate and activation form the bf16 one does,
but no fc biases: ``fused_mlp`` raises for quantized weights with biases,
as the JAX wrapper does (the engines keep that MLP on the layer body).
Without the norm, yn is y_src rounded to the activation dtype, the TPU
kernels' rounding point.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .dispatch import use_kernel
from .paged_attention import (HEAD_DIM_LATER, HEAD_DIMS, _alibi_bias, _sms, alibi_operand,
                              decode_splits, gather_kv, pool_kind, scale_kw, scales_given)
from . import decode_gemv
from .quant_matmul import QuantizedMatrix, check_storage

_NEG = -1e30     # the TPU kernels' finite mask sentinel

#: activations the fused MLP kernel computes (the JAX package's
#: ``ops/fused_decode.py:FUSABLE_ACTIVATIONS``; exact "gelu" is not one)
FUSABLE_ACTIVATIONS = ("swiglu", "silu", "relu", "gelu_new", "gelu_pytorch_tanh")
#: the kernel's activation codes (swiglu is silu on the gate)
_ACT_CODES = {"swiglu": 0, "silu": 0, "relu": 1, "gelu_new": 2, "gelu_pytorch_tanh": 2}
_NORM_CODES = {"rmsnorm": 0, "layernorm": 1}
_NO_NORM = 2     # apply_norm=False: yn = y_src


def _act_f32(name: str):
    if name in ("swiglu", "silu"):
        return F.silu
    if name == "relu":
        return F.relu
    return lambda x: F.gelu(x, approximate="tanh")

# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def rope_heads(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate-half RoPE in f32 on per-head rows: x [B, n, Dh] f32, cos/sin
    [B, rd/2] f32 rows at each sequence's position (rd <= Dh, even). Column
    d < rd pairs with d + rd/2 (first half, negated) or d - rd/2 (second
    half); columns >= rd pass through, as in JAX's flat-layout
    ``_rope_flat`` (whose pass-through columns get cos 1 and sin 0)."""
    rd = 2 * cos.shape[-1]
    c, s = cos[:, None, :], sin[:, None, :]
    x1, x2, rest = x[..., :rd // 2], x[..., rd // 2:rd], x[..., rd:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s, rest], dim=-1)


def append_rows(pool_k, pool_v, k, v, block_table, pos) -> None:
    """Write k/v [B, KV, Dh] into one layer's pool at (table[b, pos//bs],
    :, pos % bs, :), in place; -1 table entries are read as block 0."""
    bs = pool_k.shape[2]
    pos = pos.long()
    col = (pos // bs).clamp(max=block_table.shape[1] - 1)
    blk = block_table.clamp_min(0).long().gather(1, col[:, None])[:, 0]
    pool_k[blk, :, pos % bs] = k.to(pool_k.dtype)
    pool_v[blk, :, pos % bs] = v.to(pool_v.dtype)


def fused_qkv_rope_reference(y, wq, wk, wv, cos, sin, pool_k=None, pool_v=None,
                             block_table=None, pos=None, *, n_heads: int, kv_heads: int,
                             bq=None, bk=None, bv=None):
    """y [B, D] -> (q [B, H, Dh], k, v [B, KV, Dh]) in y's dtype, with k/v
    appended to the pool in place when one is given: f32 products and
    sums, the biases added in f32, RoPE in f32 from the f32 rows cos/sin
    [B, rd/2] over each head's first rd columns (none when cos is None),
    one cast."""
    B = y.shape[0]
    H, KV = n_heads, kv_heads
    Dh = wq.shape[1] // H
    yf = y.float()
    q, k, v = yf @ wq.float(), yf @ wk.float(), yf @ wv.float()
    if bq is not None:
        q, k, v = q + bq.float(), k + bk.float(), v + bv.float()
    q, k, v = q.reshape(B, H, Dh), k.reshape(B, KV, Dh), v.reshape(B, KV, Dh)
    if cos is not None:
        q = rope_heads(q, cos.float(), sin.float())
        k = rope_heads(k, cos.float(), sin.float())
    q, k, v = q.to(y.dtype), k.to(y.dtype), v.to(y.dtype)
    if pool_k is not None:
        append_rows(pool_k, pool_v, k, v, block_table, pos)
    return q, k, v


def split_count(width: int, num_splits: int) -> Tuple[int, int]:
    """(splits, table entries per split) for a table of ``width`` entries:
    at most ``num_splits`` and ``width`` splits, none of them empty by
    construction (a sequence may still end before a split starts)."""
    spb = -(-width // max(1, min(int(num_splits), width)))
    return -(-width // spb), spb


def fused_paged_decode_reference(q, ck, cv, block_table, kv_len, num_splits: int = 2,
                                 alibi_slopes=None, k_scale=None, v_scale=None):
    """Split-K paged decode: q [B,1,H,Dh] against one layer of the pool
    through block_table [B,W]; kv_len [B] -> [B,1,H,Dh]. Each split of the
    table gives (m, l, acc) in f32 with q scaled in f32, ``slope_h * j``
    added at logical position j (``alibi_slopes`` [H]) and the softmax
    weights kept in f32 (masked scores -1e30; a split with no visible
    position gives m = -1e30, l = 0); the merge is that of the TPU
    kernel. Scale planes dequantize the gathered rows in f32."""
    B, _, H, Dh = q.shape
    KV, bs = ck.shape[1], ck.shape[2]
    G = H // KV
    W = block_table.shape[1]
    S, spb = split_count(W, num_splits)
    k, v = gather_kv(ck, cv, block_table, k_scale, v_scale)   # [B, W*bs, KV, Dh]
    P, L = S * spb * bs, spb * bs
    k = F.pad(k.float(), (0, 0, 0, 0, 0, P - W * bs))
    v = F.pad(v.float(), (0, 0, 0, 0, 0, P - W * bs))
    qf = q.reshape(B, KV, G, Dh).float() * Dh ** -0.5
    sc = torch.einsum("bkgd,bpkd->bkgp", qf, k)
    if alibi_slopes is not None:
        sc = sc + _alibi_bias(alibi_slopes, KV, G, P, q.device)[None]
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


def fused_mlp_reference(resid, y_src, ln_w, w_up, w_down, w_gate, eps: float = 1e-5, *,
                        ln_b=None, b_up=None, b_down=None, norm: str = "rmsnorm",
                        activation: str = "swiglu", apply_norm: bool = True):
    """``resid + w_down·a + b_down`` with a = act(yn·w_gate) ⊙ (yn·w_up +
    b_up) (gated: ``w_gate`` given) or act(yn·w_up + b_up), yn = norm(y_src)
    (RMSNorm, or layernorm with ``ln_b`` and the population variance; with
    ``apply_norm=False`` yn = y_src and ``ln_w`` / ``ln_b`` are not read):
    f32 statistics, yn and a rounded to resid's dtype, products summed and
    the biases added in f32, the residual and then b_down added in f32, one
    cast."""
    x32 = y_src.float()
    if not apply_norm:
        yn = x32
    elif norm == "rmsnorm":
        var = (x32 * x32).mean(-1, keepdim=True)
        yn = x32 * torch.rsqrt(var + eps) * ln_w.float()
    else:
        mean = x32.mean(-1, keepdim=True)
        var = x32.var(-1, keepdim=True, unbiased=False)
        yn = (x32 - mean) * (1.0 / torch.sqrt(var + eps)) * ln_w.float()
        if ln_b is not None:
            yn = yn + ln_b.float()
    yn = yn.to(resid.dtype).float()
    act = _act_f32(activation)
    u = yn @ w_up.float()
    if b_up is not None:
        u = u + b_up.float()
    a = act(yn @ w_gate.float()) * u if w_gate is not None else act(u)
    out = resid.float() + a.to(resid.dtype).float() @ w_down.float()
    if b_down is not None:
        out = out + b_down.float()
    return out.to(resid.dtype)


def fused_mlp_quant_reference(resid, y_src, ln_w, w_up, w_down, w_gate, eps: float = 1e-5, *,
                              ln_b=None, norm: str = "rmsnorm", activation: str = "swiglu",
                              apply_norm: bool = True):
    """:func:`fused_mlp_reference` over ``QuantizedMatrix`` weights
    dequantized to f32 (not rounded to the activation dtype), gated when
    ``w_gate`` is given, without fc biases: the JAX quantized kernel's
    rounding points (yn and a rounded to resid's dtype, f32 sums)."""
    f32 = torch.float32
    gate = None if w_gate is None else w_gate.dequantize(f32)
    return fused_mlp_reference(resid, y_src, ln_w, w_up.dequantize(f32), w_down.dequantize(f32),
                               gate, eps, ln_b=ln_b, norm=norm, activation=activation,
                               apply_norm=apply_norm)


def mlp_weights_fusable(w_up, w_down, w_gate=None) -> Optional[str]:
    """None when the fused MLP kernels can take these weights (all dense,
    D a multiple of 32 and F of 8, or all quantized alike); otherwise the
    reason, in the JAX package's words where it has them."""
    ws = [w for w in (w_gate, w_up, w_down) if w is not None]
    quant = [isinstance(w, QuantizedMatrix) for w in ws]
    if not any(quant):
        D, Fd = w_up.shape
        if D % 32 or Fd % 8:
            return (f"dense MLP widths D={D}, F={Fd} (the bf16 kernels need D a multiple of 32 "
                    f"and F of 8)")
        return None
    if not all(quant):
        return "mixed dense/quantized MLP weights"
    gs, bits = ws[0].group_size, ws[0].bits
    if any(w.group_size != gs or w.bits != bits for w in ws):
        return "mixed group_size/bits across MLP weights"
    D, F_ = w_up.shape
    if D % gs or F_ % gs:
        return f"D={D}/F={F_} not multiples of quant group_size={gs}"
    if bits == 4 and gs % 2:
        return f"odd int4 group_size={gs}"
    return None


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


def fused_qkv_rope(y, wq, wk, wv, cos, sin, pool_k=None, pool_v=None, block_table=None,
                   pos=None, *, n_heads: int, kv_heads: int, bq=None, bk=None, bv=None):
    """One token per sequence: y [B, D] (the normalised hidden rows) ->
    (q [B, H, Dh], k, v [B, KV, Dh]); the biases ``bq`` [H*Dh], ``bk``,
    ``bv`` [KV*Dh] (all three or none) added in f32, then rotate-half RoPE
    from the f32 rows cos/sin [B, rd/2] over each head's first rd columns
    (rd even, at most Dh; the rest pass through; ``cos = sin = None``: no
    RoPE).
    Given a pool, the new K/V is also written into the layer's pool [nblk,
    KV, bs, Dh] in place at (block_table[b, pos//bs], :, pos % bs) for each
    row's position ``pos`` [B]; with ``pool_k=None`` no pool row is written
    (the dense-cache engine's form). The CUDA kernel on a CUDA tensor, the
    plain version on a CPU tensor."""
    if sum(b is None for b in (bq, bk, bv)) not in (0, 3):
        raise ValueError("fused QKV: bq, bk and bv go together (all given or all None)")
    if (cos is None) != (sin is None):
        raise ValueError("fused QKV: cos and sin go together (both given: RoPE; both None: "
                         "none)")
    if any(isinstance(w, QuantizedMatrix) for w in (wq, wk, wv)):
        raise ValueError("fused QKV: quantized attention weights take quant_matmul (the "
                         "engines route them there, as the JAX engines do)")
    pooled = [a is not None for a in (pool_k, pool_v, block_table, pos)]
    if any(pooled) and not all(pooled):
        raise ValueError("fused QKV: pool_k, pool_v, block_table and pos go together "
                         "(all given: append; all None: no pool)")
    if not use_kernel(y):
        return fused_qkv_rope_reference(y, wq, wk, wv, cos, sin, pool_k, pool_v,
                                        block_table, pos, n_heads=n_heads, kv_heads=kv_heads,
                                        bq=bq, bk=bk, bv=bv)
    out = _launch_qkv(y, wq, wk, wv, cos, sin, pool_k, pool_v, block_table, pos,
                      n_heads, kv_heads, (bq, bk, bv))
    fused_qkv_rope.launches += 1
    return out


fused_qkv_rope.launches = 0


def fused_paged_decode_attention(q, ck, cv, block_table, kv_len, *,
                                 num_splits: Optional[int] = None, alibi_slopes=None,
                                 k_scale=None, v_scale=None):
    """Split-K paged decode: q [B,1,H,Dh] against one layer of the pool
    ck/cv [nblk,KV,bs,Dh] through block_table [B,W]; kv_len [B] ->
    [B,1,H,Dh]. ``num_splits`` (JAX's: split s covers the table entries
    [s * spb, (s + 1) * spb)) defaults to :func:`attention_splits` on the
    card (on the CPU, JAX's default of 2); the result does not depend on it
    beyond rounding. ``alibi_slopes`` [H] add ``slope_h * j`` at logical key
    position j; ``k_scale`` / ``v_scale`` [nblk,KV,bs] f32 dequantize an int8
    or e4m3 pool; head_dim 64, 80, 96, 128 or 256, any query-head group
    ``G = H / KV`` (a block holds the whole group: ``decode_passes``). The
    CUDA kernel on a CUDA tensor, the plain version on a CPU tensor."""
    scales_given(k_scale, v_scale)
    if not use_kernel(q):
        return fused_paged_decode_reference(q, ck, cv, block_table, kv_len,
                                            2 if num_splits is None else num_splits,
                                            alibi_slopes, k_scale, v_scale)
    out = _launch_attention(q, ck, cv, block_table, kv_len, num_splits, alibi_slopes,
                            **scale_kw(k_scale, v_scale))
    fused_paged_decode_attention.launches += 1
    return out


fused_paged_decode_attention.launches = 0


def _check_mlp_form(norm: str, activation: str) -> None:
    if activation not in FUSABLE_ACTIVATIONS:
        raise ValueError(f"fused MLP: activation {activation!r} is not fusable (fusable: "
                         f"{', '.join(FUSABLE_ACTIVATIONS)})")
    if norm not in _NORM_CODES:
        raise ValueError(f"fused MLP: norm must be rmsnorm or layernorm, got {norm!r}")


def fused_mlp(resid, y_src, ln_w, w_up, w_down, w_gate=None, *, eps: float = 1e-5,
              b_up=None, b_down=None, ln_b=None, norm: str = "rmsnorm",
              activation: str = "swiglu", apply_norm: bool = True):
    """``resid + mlp(norm(y_src))`` for one token per sequence: resid /
    y_src [B, D], ln_w (and, under layernorm, ``ln_b``) [D], w_up [D, F],
    w_down [F, D]; gated (SwiGLU form) when ``w_gate`` [D, F] is given,
    else plain; ``activation`` one of :data:`FUSABLE_ACTIVATIONS`; fc
    biases ``b_up`` [F] / ``b_down`` [D] optional. ``QuantizedMatrix``
    weights go to :func:`fused_mlp_quant` (every norm, gate and activation
    form; with fc biases they raise, as in JAX). ``apply_norm=False``
    skips the norm (yn = y_src; ``ln_w`` and ``ln_b`` are not read: GPT-J's
    shared layernorm). The CUDA kernels on a CUDA tensor, the plain version
    on a CPU tensor."""
    _check_mlp_form(norm, activation)
    ln_b = ln_b if norm == "layernorm" and apply_norm else None
    if any(isinstance(w, QuantizedMatrix) for w in (w_gate, w_up, w_down)):
        if b_up is not None or b_down is not None:
            # JAX's fused_mlp raises here too; the engines keep such an MLP
            # on the layer body
            raise ValueError("fused MLP: quantized weights with fc biases are not supported "
                             "(the engines route them to the layer body's quantized matmuls)")
        return fused_mlp_quant(resid, y_src, ln_w, w_up, w_down, w_gate, eps=eps, ln_b=ln_b,
                               norm=norm, activation=activation, apply_norm=apply_norm)
    kw = dict(ln_b=ln_b, b_up=b_up, b_down=b_down, norm=norm, activation=activation,
              apply_norm=apply_norm)
    if not use_kernel(resid):
        return fused_mlp_reference(resid, y_src, ln_w, w_up, w_down, w_gate, eps, **kw)
    out = _launch_mlp(resid, y_src, ln_w, w_up, w_down, w_gate, eps, **kw)
    fused_mlp.launches += 1
    return out


fused_mlp.launches = 0


def fused_mlp_quant(resid, y_src, ln_w, w_up, w_down, w_gate=None, *, eps: float = 1e-5,
                    ln_b=None, norm: str = "rmsnorm", activation: str = "swiglu",
                    apply_norm: bool = True):
    """:func:`fused_mlp` over ``QuantizedMatrix`` weights sharing one format
    and group size, the weights read at storage width and dequantized in
    registers: RMSNorm or layernorm (with ``ln_b``), gated when ``w_gate``
    is given, else plain, any of :data:`FUSABLE_ACTIVATIONS`; no fc biases;
    ``apply_norm=False`` skips the norm. Weights the kernel cannot take
    raise, with the reason of :func:`mlp_weights_fusable`. The CUDA kernels
    on a CUDA tensor, the plain version on a CPU tensor."""
    _check_mlp_form(norm, activation)
    reason = mlp_weights_fusable(w_up, w_down, w_gate)
    if reason is None and not isinstance(w_up, QuantizedMatrix):
        reason = "dense MLP weights (they take fused_mlp's bf16 kernel)"
    if reason is not None:
        raise ValueError(f"fused quantized MLP: {reason}")
    kw = dict(ln_b=ln_b if norm == "layernorm" and apply_norm else None, norm=norm,
              activation=activation, apply_norm=apply_norm)
    if not use_kernel(resid):
        return fused_mlp_quant_reference(resid, y_src, ln_w, w_up, w_down, w_gate, eps, **kw)
    out = _launch_mlp_quant(resid, y_src, ln_w, w_up, w_down, w_gate, eps, **kw)
    fused_mlp_quant.launches += 1
    return out


fused_mlp_quant.launches = 0


# ---------------------------------------------------------------------------
# Launch
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "sxt_fused_qkv_rope_bf16": [_P] * 17 + [_I] * 10 + [_P],
    "sxt_fused_paged_decode": [_P] * 13 + [_I] * 8 + [_F, _P],
    "sxt_fused_mlp_bf16": [_P] * 14 + [_I] * 11 + [_F, _P],
    "sxt_fused_mlp_quant_bf16": [_P] * 15 + [_I] * 13 + [_F, _P],
}
_LIB = []

#: B4's CUDA-core GEMV (gemv_partial_kernel)
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


def gemv_splits(K: int, n_cols: Tuple[int, ...], sms: int) -> Tuple[int, int]:
    """(splits, chunk) of a reduction over K rows for output matrices of
    ``n_cols`` columns: chunks of at most GEMV_CHUNK rows (a multiple of
    8), and enough of them that the blocks number at least twice the SMs."""
    tiles = sum(-(-n // GEMV_TILE) for n in n_cols)
    splits = max(-(-K // GEMV_CHUNK), -(-2 * sms // tiles), 1)
    per_split = -(-K // splits)
    chunk = -(-per_split // 8) * 8
    return -(-K // chunk), chunk


def attention_splits(B: int, KV: int, width: int, bs: int, sms: int) -> int:
    """The split count the wrapper gives the kernel on a card of ``sms``
    SMs: the table-entry splits nearest B2's positions per split
    (:func:`decode_splits`: 256 positions, down to 128 where the (sequence,
    kv head, split) blocks would not reach one an SM, one split where the
    (sequence, kv head) blocks reach two an SM), whole table entries of
    ``bs`` positions and at least one a split."""
    per = decode_splits(B, KV, width, bs, sms)[1]
    spb = max(1, per // bs)
    return split_count(width, -(-width // spb))[0]


#: the folded merge's limits: the f32 partials (G * Dh * splits values) the
#: last split of a (sequence, kv head) reads back, and the grid's blocks
#: an SM. Past either the merge runs as a second kernel, over the whole
#: card. On the H100 (scripts/torch_kernel_digest.py --sections paged) the
#: fold ran up to 7% faster at Llama-3-8B's 512 blocks (4 x 128 heads in 8
#: splits: 4K values), within 4% either way at a 16/2 x 64 group's 176,
#: took 1.6x the merge launch's time at Falcon-7B's 73K values (71 x 64
#: heads in 16 splits: one block's loads in series), and ran mostly 1-5%
#: slower at 1,024-2,048 blocks (GPT-J-6B's, Phi-3-mini's, Pythia-2.8b's and
#: BLOOM-1b7's 16-32 kv heads in 8 splits).
FOLD_MAX_PARTIALS = 16384
FOLD_MAX_BLOCKS_PER_SM = 4
def folds(B: int, KV: int, G: int, Dh: int, splits: int, sms: int) -> bool:
    """Whether the split-K decode merges in its last split (else a second
    kernel merges): more than one split, at most FOLD_MAX_PARTIALS partial
    values a (sequence, kv head) and at most FOLD_MAX_BLOCKS_PER_SM blocks
    an SM."""
    return (splits > 1 and G * Dh * splits <= FOLD_MAX_PARTIALS
            and B * KV * splits <= FOLD_MAX_BLOCKS_PER_SM * sms)


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


def _vector(name, t, device, n):
    """A bias or norm vector the kernels read element by element: bf16 [n]
    contiguous on ``device`` (no alignment needed), or None."""
    if t is None:
        return None
    if not t.is_cuda or t.device != device or t.dtype != torch.bfloat16:
        raise TypeError(f"fused decode kernel: {name} must be bf16 on {device}, got "
                        f"{t.dtype} on {t.device}")
    if tuple(t.shape) != (n,) or not t.is_contiguous():
        raise ValueError(f"fused decode kernel: {name} must be contiguous [{n}], got "
                         f"{tuple(t.shape)}")
    return t


def _ptr(t):
    return None if t is None else t.data_ptr()


def _index(t, B, device, what, dims=1):
    t = torch.as_tensor(t, device=device)
    if t.dtype.is_floating_point or t.dim() != dims or t.shape[0] != B:
        raise ValueError(f"fused decode kernel: bad {what} {tuple(t.shape)} {t.dtype}")
    return t.to(torch.int32).contiguous()


def _raise_on(err, lib, what):
    if err:
        raise RuntimeError(f"fused {what} kernel launch failed: CUDA error {err} "
                           f"({lib.sxt_fused_error_string(err).decode()})")


def _launch_qkv(y, wq, wk, wv, cos, sin, pool_k, pool_v, block_table, pos, H, KV, biases):
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
    if pool_k is not None:
        _bf16("k pool", pool_k, dev)
        _bf16("v pool", pool_v, dev, pool_k.shape)
        if pool_k.dim() != 4 or pool_k.shape[1] != KV or pool_k.shape[3] != Dh:
            raise ValueError(f"fused QKV kernel: pool {tuple(pool_k.shape)} is not "
                             f"[nblk, {KV}, bs, {Dh}]")
    bq, bk, bv = (_vector(n, b, dev, size)
                  for n, b, size in zip(("bq", "bk", "bv"), biases, (Nq, Nkv, Nkv)))
    rope, rd = [None, None], 0
    if cos is not None:
        rd = 2 * cos.shape[-1] if cos.dim() == 2 else 0
        for i, (name, t) in enumerate((("cos", cos), ("sin", sin))):
            if (t.device != dev or t.dtype != torch.float32 or not 0 < rd <= Dh
                    or tuple(t.shape) != (B, rd // 2)):
                raise ValueError(f"fused QKV kernel: {name} must be f32 [{B}, rd/2] on {dev} "
                                 f"with rd even and at most head_dim {Dh}, got {t.dtype} "
                                 f"{tuple(t.shape)} on {t.device}")
            rope[i] = t.contiguous()
    if pool_k is not None:
        table = _index(block_table, B, dev, "block table", dims=2)
        pos = _index(pos, B, dev, "pos")
        pool_args = (table.data_ptr(), pos.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr())
        bs, W = pool_k.shape[2], table.shape[1]
    else:   # no append: the kernel writes no pool row
        pool_args, bs, W = (None,) * 4, 1, 0
    q = torch.empty(B, H, Dh, device=dev, dtype=y.dtype)
    k = torch.empty(B, KV, Dh, device=dev, dtype=y.dtype)
    v = torch.empty(B, KV, Dh, device=dev, dtype=y.dtype)
    splits, chunk = gemv_splits(D, (Nq, Nkv, Nkv), _sms(dev))
    part = torch.empty(splits, min(B, GEMV_ROWS), Nq + 2 * Nkv, device=dev,
                       dtype=torch.float32)
    lib = _lib()
    err = lib.sxt_fused_qkv_rope_bf16(
        y.data_ptr(), wq.data_ptr(), wk.data_ptr(), wv.data_ptr(), _ptr(bq), _ptr(bk), _ptr(bv),
        _ptr(rope[0]), _ptr(rope[1]), *pool_args, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        part.data_ptr(), B, D, H, KV, Dh, rd, bs, W, splits, chunk,
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, lib, "QKV")
    return q, k, v


def _launch_attention(q, ck, cv, block_table, kv_len, num_splits, alibi_slopes=None,
                      k_scale=None, v_scale=None, fold: Optional[bool] = None):
    """One launch of the split-K decode kernel; the merge folds into each
    last split where :func:`folds` says so (``fold`` True / False forces
    it, or a second merge kernel)."""
    dev = q.device
    B, one, H, Dh = q.shape
    if one != 1:
        raise ValueError("split-K decode kernel: one query token per sequence")
    store = pool_kind(q, ck, cv, k_scale, v_scale, "split-K decode kernel")
    if ck.shape != cv.shape or ck.dim() != 4 or ck.shape[3] != Dh or H % ck.shape[1]:
        raise ValueError(f"split-K decode kernel: q heads {H} / Dh {Dh} do not match pool "
                         f"{tuple(ck.shape)}")
    KV, bs = ck.shape[1], ck.shape[2]
    if Dh not in HEAD_DIMS:
        raise ValueError(f"split-K decode kernel: head_dim {Dh} not built {HEAD_DIMS} "
                         f"({HEAD_DIM_LATER})")
    table = _index(block_table, B, dev, "block table", dims=2)
    lens = _index(kv_len, B, dev, "kv_len")
    slopes = alibi_operand(alibi_slopes, H, dev, "split-K decode kernel")
    W = table.shape[1]
    splits = split_count(W, attention_splits(B, KV, W, bs, _sms(dev)) if num_splits is None
                         else num_splits)[0]
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(dev).cuda_stream
    part, counters = [None] * 3, None
    if splits > 1:   # the splits' f32 acc, m and l, one buffer
        rows = B * splits * H
        buf = torch.empty(rows * (Dh + 2), device=dev, dtype=torch.float32)
        part = [buf.data_ptr() + 4 * rows * off for off in (0, Dh, Dh + 1)]
        if folds(B, KV, H // KV, Dh, splits, _sms(dev)) if fold is None else fold:
            counters = decode_gemv._counters(dev, stream, B * KV).data_ptr()
    lib = _lib()
    err = lib.sxt_fused_paged_decode(
        q.data_ptr(), ck.data_ptr(), cv.data_ptr(), _ptr(k_scale), _ptr(v_scale),
        table.data_ptr(), lens.data_ptr(), _ptr(slopes), out.data_ptr(), *part, counters, store,
        B, H, KV, Dh, bs, W, splits, float(Dh) ** -0.5, stream)
    _raise_on(err, lib, "split-K decode")
    return out


def mlp_plan(D: int, F: int, unit: int, gated: bool, rows: int, elt_bytes: float,
             sms: int) -> Tuple[Tuple[int, int, int], Tuple[int, int, int]]:
    """((splits, chunk, blocks) of the up GEMV, (...) of the down GEMV) of
    the fused MLP on the tensor-core GEMV (B6: ``unit`` a stage's
    STAGE_ROWS, ``elt_bytes`` 2; B7: the scale group and the format's bytes)
    for a pass of ``rows`` rows (``decode_gemv.plan``): the up GEMV's items
    are 128 columns of w_up (gated: and of w_gate, twice the bytes) over K =
    D, the down GEMV's 128 columns of D over K = F."""
    up_tiles = -(-F // decode_gemv.TILE_COLS)
    down_tiles = -(-D // decode_gemv.TILE_COLS)
    out = []
    for K, tiles, n_out, elt in ((D, up_tiles, (2 if gated else 1) * F,
                                  (2 if gated else 1) * elt_bytes),
                                 (F, down_tiles, D, elt_bytes)):
        splits, chunk = decode_gemv.plan(K, unit, tiles, 1, rows, n_out, elt, sms)
        out.append((splits, chunk, decode_gemv.blocks(tiles * splits, sms)))
    return out[0], out[1]


def _mlp_workspaces(dev, stream, B: int, D: int, F: int, gated: bool, plan, dtype):
    """a [min(B, 16), F], the f32 partials of each GEMV that splits K, and
    the counters where either does."""
    (s1, _, _), (s2, _, _) = plan
    rows = min(B, decode_gemv.PASS_ROWS)
    a = torch.empty(rows, F, device=dev, dtype=dtype)
    part1 = (torch.empty(s1, rows, (2 if gated else 1) * F, device=dev, dtype=torch.float32)
             if s1 > 1 else None)
    part2 = torch.empty(s2, rows, D, device=dev, dtype=torch.float32) if s2 > 1 else None
    counters = None
    if s1 > 1 or s2 > 1:
        counters = decode_gemv._counters(dev, stream, max(-(-F // decode_gemv.TILE_COLS),
                                                          -(-D // decode_gemv.TILE_COLS)))
    return a, part1, part2, counters


def _launch_mlp(resid, y_src, ln_w, w_up, w_down, w_gate, eps, *, ln_b, b_up, b_down, norm,
                activation, apply_norm=True):
    dev = resid.device
    B, D = resid.shape
    Fd = w_up.shape[1]
    gated = w_gate is not None
    if D % 32 or Fd % 8:
        raise ValueError(f"fused MLP kernel: D={D} must be a multiple of 32 (the GEMV's "
                         f"32-row stages) and F={Fd} of 8")
    _bf16("resid", resid, dev)
    _bf16("y_src", y_src, dev, (B, D))
    _vector("ln_w", ln_w, dev, D)
    ln_b, b_up, b_down = (_vector(n, t, dev, size) for n, t, size in
                          (("ln_b", ln_b, D), ("b_up", b_up, Fd), ("b_down", b_down, D)))
    if gated:
        _bf16("w_gate", w_gate, dev, (D, Fd))
    _bf16("w_up", w_up, dev, (D, Fd))
    _bf16("w_down", w_down, dev, (Fd, D))
    plan = mlp_plan(D, Fd, decode_gemv.STAGE_ROWS, gated, min(B, decode_gemv.PASS_ROWS), 2,
                    _sms(dev))
    (s1, c1, b1), (s2, c2, b2) = plan
    stream = torch.cuda.current_stream(dev).cuda_stream
    out = torch.empty_like(resid)
    a, part1, part2, counters = _mlp_workspaces(dev, stream, B, D, Fd, gated, plan, resid.dtype)
    lib = _lib()
    err = lib.sxt_fused_mlp_bf16(
        resid.data_ptr(), y_src.data_ptr(), ln_w.data_ptr(), _ptr(ln_b), _ptr(w_gate),
        w_up.data_ptr(), w_down.data_ptr(), _ptr(b_up), _ptr(b_down), out.data_ptr(),
        a.data_ptr(), _ptr(part1), _ptr(part2), _ptr(counters), B, D, Fd, s1, c1, s2, c2, b1,
        b2, _NORM_CODES[norm] if apply_norm else _NO_NORM, _ACT_CODES[activation], float(eps),
        stream)
    _raise_on(err, lib, "MLP")
    return out


def _launch_mlp_quant(resid, y_src, ln_w, w_up, w_down, w_gate, eps, *, ln_b, norm,
                      activation, apply_norm=True):
    dev = resid.device
    B, D = resid.shape
    Fd = w_up.shape[1]
    gated = w_gate is not None
    _bf16("resid", resid, dev)
    _bf16("y_src", y_src, dev, (B, D))
    _vector("ln_w", ln_w, dev, D)
    _vector("ln_b", ln_b, dev, D)
    fmt = check_storage("fused quantized MLP kernel: w_up", w_up, dev, D, Fd)
    if gated:
        check_storage("fused quantized MLP kernel: w_gate", w_gate, dev, D, Fd)
    check_storage("fused quantized MLP kernel: w_down", w_down, dev, Fd, D)
    gs = w_up.group_size
    plan = mlp_plan(D, Fd, gs, gated, min(B, decode_gemv.PASS_ROWS),
                    0.5 if w_up.bits == 4 else 1, _sms(dev))
    (s1, c1, b1), (s2, c2, b2) = plan
    stream = torch.cuda.current_stream(dev).cuda_stream
    out = torch.empty_like(resid)
    a, part1, part2, counters = _mlp_workspaces(dev, stream, B, D, Fd, gated, plan, resid.dtype)
    gate = (w_gate.q.data_ptr(), w_gate.scales.data_ptr()) if gated else (None, None)
    lib = _lib()
    err = lib.sxt_fused_mlp_quant_bf16(
        resid.data_ptr(), y_src.data_ptr(), ln_w.data_ptr(), _ptr(ln_b), *gate,
        w_up.q.data_ptr(), w_up.scales.data_ptr(), w_down.q.data_ptr(),
        w_down.scales.data_ptr(), out.data_ptr(), a.data_ptr(), _ptr(part1), _ptr(part2),
        _ptr(counters), B, D, Fd, gs, fmt, s1, c1, s2, c2, b1, b2,
        _NORM_CODES[norm] if apply_norm else _NO_NORM, _ACT_CODES[activation], float(eps),
        stream)
    _raise_on(err, lib, "quantized MLP")
    return out


__all__ = ["FUSABLE_ACTIVATIONS", "fused_mlp", "fused_mlp_quant", "fused_mlp_quant_reference", "fused_mlp_reference",
           "folds", "fused_paged_decode_attention", "fused_paged_decode_reference", "fused_qkv_rope",
           "fused_qkv_rope_reference", "gemv_splits", "attention_splits", "mlp_plan",
           "mlp_weights_fusable",
           "split_count", "rope_heads"]
