"""Flash attention, forward and backward: the CUDA kernels for Hopper, and
their plain PyTorch versions.

Replaces the TPU kernels ``shuffle_exchange_tpu/ops/flash_attention.py:
pallas_attention`` (the stock flash kernel, MHA, forward and backward) and
``splash_attention_gqa`` (GQA with unexpanded K/V: the forward, the dq
pass and the dkv pass): causal and full masks, segment ids, splash's
element mask ``mask_np`` (a ``TileMask``), any T and S, head_dim 64, 128
or 256 forward and backward (GPT-J-6B serves and trains at 256), and 80 and
96 forward only (Pythia-2.8b's and Phi-3-mini's prefill, where the JAX
package runs its jnp reference: the port's own route on the card; the
backward refuses them, naming ROADMAP queue A, item 4 (h)). The kernels
live in ``ops/csrc/flash_attention.cu`` (whose header says what bounds them
on the H100 and how the design answers it): the dense forward at every
head dim and the dense backward at 64, 128 and 256 run warp-specialised
wgmma kernels over TMA-fed tiles (at 80 and 96 a tile's last 16 or 32
columns are a narrow tail block; at 64 the dk/dv pass gives each consumer
its own 64 keys), the element-mask forms ``mma.sync`` kernels over 64 x 64
tiles. ``_build`` compiles that file with ``nvcc`` at first use and this
module binds it with ctypes.

``flash_attention`` is differentiable: when an input requires grad, a CUDA
call goes through a ``torch.autograd.Function`` whose forward also writes
the log-sum-exp (``lse [B, H, T]`` f32, natural log: the convention of the
TPU ALiBi flash kernel) and saves ``(q, k, v, out, lse)``, and whose
backward launches the backward kernels. A CPU call that requires grad
is autograd through ``reference_attention``; ``reference_attention_bwd``
is the plain version of the backward kernels themselves, on the same
operands (the forward's stored ``out`` included).

The plain version ports ``reference_attention`` as it is, down to the
cast of the softmax weights to ``v.dtype`` before P·V. The kernel keeps
P to about 16 bits instead (two bf16 terms), and so does the plain version
given ``p_f32=True``: the CPU tests hold the plain version against the
JAX package with the cast (f32, where the two agree), and on the card
``chip_smoke.py`` holds the kernel against ``p_f32=True`` in bf16.

Three pieces of the JAX ``flash_attention`` are deliberately not carried
over: its fallback to the reference when the Pallas call raises, its size
gate (``_pallas_ok``: T, S >= 128 and head_dim % 64 == 0, a TPU tiling
constraint; the kernel masks ragged T and S itself), and the causal mask
for T != S, where the JAX paths disagree (``reference_attention`` aligns
the diagonal bottom-right, the TPU kernels top-left): the wrapper refuses
it. ALiBi slopes route to ``ops/alibi_attention.py`` (B11-B13).

The element mask (splash's ``NumpyMask``, which ``ops/sparse_attention.py``
builds from a block layout): a ``TileMask`` holds a [T, S] boolean mask
shared by every sequence and head together with its tile map, built once
on the host and cached per mask: each (64-query, 64-key) tile of the
kernels is empty (skipped by all three passes), full (run unmasked) or
partial (its [64, 64] bytes of the mask are read where segment ids are
tested). Its plain version is ``reference_attention`` with the mask ANDed
in and the softmax weights kept in f32, and a query row with no allowed
key gives 0 with zero gradients, as the JAX package's dense path
(``ops/sparse_attention.py``'s ``where(mask, probs, 0)``).
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
from typing import Optional, Tuple

import numpy as np
import torch

from .dispatch import use_kernel

_NEG = -1e30     # the mask value of reference_attention and the TPU kernels
HEAD_DIMS = (64, 80, 96, 128, 256)   # the forward kernel's instances
BWD_HEAD_DIMS = (64, 128, 256)       # the backward kernels'
#: what every unbuilt head dim waits for (the TPU package has no kernel at 80 or 96)
LATER = "ROADMAP queue A, item 4 (h): training at head dims 80 and 96, and other head dims"
TILE = 64        # the mma.sync kernels' query and key tile (flash_tile.cuh: kBlockM, kBlockN)

# ---------------------------------------------------------------------------
# The element mask and its tile map
# ---------------------------------------------------------------------------


class TileMask:
    """A [T, S] boolean element mask shared by every sequence and head
    (splash's ``NumpyMask``) and the kernels' tile map of it, built on the
    host: each (64-query, 64-key) tile is empty, full (inside [T, S] and
    all True) or partial. ``row_ptr`` / ``row_kt`` / ``row_blk`` list each
    query tile's non-empty key tiles and ``col_ptr`` / ``col_qt`` /
    ``col_blk`` each key tile's non-empty query tiles, in ascending order,
    with the index of the tile's partial block in ``blocks`` [n, 64, 64]
    uint8 (the mask under the tile, 0 past T and S) or -1 when full.
    ``allowed`` counts the True elements (the work a call needs)."""

    def __init__(self, mask):
        m = np.ascontiguousarray(np.asarray(mask, bool))
        if m.ndim != 2:
            raise ValueError(f"element mask must be [T, S], got {m.shape}")
        self.mask = m
        T, S = m.shape
        self.T, self.S = T, S
        nqt, nkt = -(-T // TILE), -(-S // TILE)
        pad = np.zeros((nqt * TILE, nkt * TILE), bool)
        pad[:T, :S] = m
        tiles = pad.reshape(nqt, TILE, nkt, TILE).transpose(0, 2, 1, 3)   # [nqt, nkt, 64, 64]
        count = tiles.sum((2, 3))
        inside = ((np.arange(nqt) + 1) * TILE <= T)[:, None] & (
            (np.arange(nkt) + 1) * TILE <= S)[None, :]
        full = inside & (count == TILE * TILE)
        partial = (count > 0) & ~full
        blk = np.full((nqt, nkt), -1, np.int32)
        blk[partial] = np.arange(int(partial.sum()), dtype=np.int32)
        self.blocks = np.ascontiguousarray(tiles[partial].astype(np.uint8))
        self.state = np.where(full, 1, np.where(partial, 2, 0)).astype(np.int8)
        qt, kt = np.nonzero(count > 0)                   # row-major: by query tile
        self.row_ptr = np.searchsorted(qt, np.arange(nqt + 1)).astype(np.int32)
        self.row_kt, self.row_blk = kt.astype(np.int32), blk[qt, kt]
        kt2, qt2 = np.nonzero((count > 0).T)             # by key tile
        self.col_ptr = np.searchsorted(kt2, np.arange(nkt + 1)).astype(np.int32)
        self.col_qt, self.col_blk = qt2.astype(np.int32), blk[qt2, kt2]
        self.nnz = int(qt.size)
        self.allowed = int(count.sum())
        self._device = {}

    @property
    def empty_rows(self) -> np.ndarray:
        """Query rows with no allowed key (they give 0)."""
        return ~self.mask.any(axis=1)

    def device_operands(self, device) -> Tuple[torch.Tensor, torch.Tensor]:
        """(tiles, blocks) on ``device``, made once: the int32 buffer
        row_ptr | row_kt | row_blk | col_ptr | col_qt | col_blk the kernels
        read (flash_attention.cu: tile_map), and the partial blocks."""
        key = str(device)
        if key not in self._device:
            tiles = np.concatenate([self.row_ptr, self.row_kt, self.row_blk, self.col_ptr,
                                    self.col_qt, self.col_blk]).astype(np.int32)
            blocks = self.blocks if self.blocks.size else np.zeros((1, TILE, TILE), np.uint8)
            self._device[key] = (torch.from_numpy(tiles).to(device),
                                 torch.from_numpy(blocks).to(device))
        return self._device[key]


_TILE_MASKS: "collections.OrderedDict[str, TileMask]" = collections.OrderedDict()
_TILE_MASK_CACHE = 8


def tile_mask(mask) -> TileMask:
    """The ``TileMask`` of an element mask [T, S], built once per mask:
    masks are cached by their content (a digest of the packed bits), the
    eight most recent kept."""
    if isinstance(mask, TileMask):
        return mask
    m = np.ascontiguousarray(np.asarray(mask, bool))
    key = hashlib.sha1(np.packbits(m).tobytes() + repr(m.shape).encode()).hexdigest()
    tm = _TILE_MASKS.get(key)
    if tm is None:
        tm = _TILE_MASKS[key] = TileMask(m)
        while len(_TILE_MASKS) > _TILE_MASK_CACHE:
            _TILE_MASKS.popitem(last=False)
    _TILE_MASKS.move_to_end(key)
    return tm


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------


def repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """[B, S, KV, Dh] -> [B, S, KV * n_rep, Dh]: kv head j serves query
    heads j * n_rep ... j * n_rep + n_rep - 1 (JAX ``_repeat_kv``)."""
    if n_rep == 1:
        return k
    B, S, KV, Dh = k.shape
    return k[:, :, :, None, :].expand(B, S, KV, n_rep, Dh).reshape(B, S, KV * n_rep, Dh)


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, segment_ids: Optional[torch.Tensor] = None,
                        p_f32: bool = False, mask=None) -> torch.Tensor:
    """q [B,T,H,Dh], k/v [B,S,KV,Dh] -> [B,T,H,Dh]: scores in f32 with q
    scaled by Dh^-0.5 in f32; masked scores -1e30 (causal: query i sees
    keys j <= i + S - T; segment ids [B, T] that differ; an element mask
    [T, S] (bool, or a ``TileMask``) that is False); softmax in f32; the
    weights cast to v's dtype before P·V unless ``p_f32``. Under an
    element mask the weights of masked pairs are 0, so a row with no
    allowed key gives 0 (JAX's dense path)."""
    v = repeat_kv(v, q.shape[2] // k.shape[2])
    probs = _probs(q, k, causal, segment_ids, mask)
    if not p_f32:
        probs = probs.to(v.dtype)
    return torch.einsum("bhts,bshd->bthd", probs.float(), v.float()).to(q.dtype)


def _element_mask(mask, device) -> torch.Tensor:
    m = mask.mask if isinstance(mask, TileMask) else mask
    return torch.as_tensor(np.asarray(m, bool) if not isinstance(m, torch.Tensor) else m,
                           device=device).bool()


def _probs(q, k, causal, segment_ids, mask) -> torch.Tensor:
    """Softmax weights [B, H, T, S] in f32; zero on the pairs an element
    mask forbids (so also on rows it forbids entirely)."""
    probs = torch.softmax(_masked_logits(q, k, causal, segment_ids, mask), dim=-1)
    if mask is not None:
        probs = probs * _element_mask(mask, q.device)[None, None]
    return probs


def _masked_logits(q, k, causal, segment_ids, mask=None) -> torch.Tensor:
    """The f32 scores [B, H, T, S] of ``reference_attention``, masked."""
    k = repeat_kv(k, q.shape[2] // k.shape[2])
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bthd,bshd->bhts", q.float() * scale, k.float())
    if causal:
        t, s = q.shape[1], k.shape[1]
        mask = torch.ones(t, s, dtype=torch.bool, device=q.device).tril(s - t)
        logits = logits.masked_fill(~mask[None, None], _NEG)
    if segment_ids is not None:
        seg = segment_ids.to(q.device)
        same = seg[:, None, :, None] == seg[:, None, None, :]
        logits = logits.masked_fill(~same, _NEG)
    if mask is not None:
        logits = logits.masked_fill(~_element_mask(mask, q.device)[None, None], _NEG)
    return logits


def reference_attention_lse(q, k, v, causal: bool = True, segment_ids=None,
                            p_f32: bool = False, mask=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``reference_attention`` and the natural-log log-sum-exp of each
    row's masked scaled scores, ``lse [B, H, T]`` f32."""
    out = reference_attention(q, k, v, causal, segment_ids, p_f32=p_f32, mask=mask)
    return out, torch.logsumexp(_masked_logits(q, k, causal, segment_ids, mask), dim=-1)


def reference_attention_bwd(q, k, v, out, dout, causal: bool = True, segment_ids=None,
                            mask=None):
    """(dq, dk, dv) in the inputs' dtypes, computed in f32 as the dq and
    dkv passes compute them: ``P = softmax(S)``, ``dP = dO V^T``,
    ``delta = rowsum(dO * out)`` from the forward's stored ``out``,
    ``dS = P (dP - delta)``, ``dq = scale dS K``, ``dk = scale dS^T Q``,
    ``dv = P^T dO``, the last two summed over a kv head's query heads.
    With ``out`` unrounded this is autograd through ``reference_attention``
    (the CPU tests hold the two together); with the bf16 ``out`` the
    kernels are given, delta carries its rounding here as it does there."""
    B, S, KV, Dh = k.shape
    G = q.shape[2] // KV
    probs = _probs(q, k, causal, segment_ids, mask)                            # [B,H,T,S]
    do = dout.float()
    dp = torch.einsum("bthd,bshd->bhts", do, repeat_kv(v, G).float())
    delta = (do * out.float()).sum(-1).permute(0, 2, 1)                         # [B,H,T]
    ds = probs * (dp - delta[..., None])
    scale = Dh ** -0.5
    dq = scale * torch.einsum("bhts,bshd->bthd", ds, repeat_kv(k, G).float())
    dk = scale * torch.einsum("bhts,bthd->bshd", ds, q.float())
    dv = torch.einsum("bhts,bthd->bshd", probs, do)
    dk, dv = (t.reshape(B, S, KV, G, Dh).sum(3) for t in (dk, dv))
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# Wrapper
# ---------------------------------------------------------------------------


def _check_shapes(q, k, v, causal, segment_ids, mask=None) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash attention: q must be [B,T,H,Dh] and k, v [B,S,KV,Dh], got "
                         f"{tuple(q.shape)} / {tuple(k.shape)} / {tuple(v.shape)}")
    B, T, H, Dh = q.shape
    _, S, KV, _ = k.shape
    if k.shape[0] != B or k.shape[3] != Dh or KV < 1 or H % KV:
        raise ValueError(f"flash attention: k/v {tuple(k.shape)} do not serve q "
                         f"{tuple(q.shape)} (same batch and head_dim, H a multiple of KV)")
    if causal and T != S:
        raise ValueError(
            f"flash attention: causal with T={T} != S={S} is refused: the JAX package's "
            "reference_attention aligns the diagonal bottom-right (tril(k=S-T)) and its TPU "
            "kernels top-left (CausalMask((T, S))), so there is no one answer to port "
            "(ROADMAP queue C)")
    if segment_ids is not None and (T != S or tuple(segment_ids.shape) != (B, T)):
        raise ValueError(f"flash attention: segment_ids must be [B, T] = [{B}, {T}] with "
                         f"T == S, got {tuple(segment_ids.shape)} and S={S}")
    if mask is not None:
        if causal:
            raise ValueError("flash attention: an element mask takes causal=False (AND the "
                             "causal mask into it, as sparse_attention does)")
        if (mask.T, mask.S) != (T, S):
            raise ValueError(f"flash attention: element mask [{mask.T}, {mask.S}] does not "
                             f"match T={T}, S={S}")


def _mask_kw(mask) -> dict:
    return {} if mask is None else {"mask": mask}


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True,
                    segment_ids: Optional[torch.Tensor] = None, *,
                    alibi_slopes=None, mask=None) -> torch.Tensor:
    """q [B,T,H,Dh], k/v [B,S,KV,Dh] (H a multiple of KV, query head h
    reading kv head h // (H // KV)) -> [B,T,H,Dh]; ``segment_ids`` [B, T]
    int (T == S) mask pairs whose ids differ. Causal needs T == S. The
    CUDA kernel on a CUDA tensor, the plain version on a CPU tensor.
    ``alibi_slopes`` [H] route to ``alibi_flash_attention`` (S >= T,
    bottom-right diagonal). ``mask``: an element mask [T, S] (bool array
    or ``TileMask``; causal=False), whose empty tiles the kernels skip and
    whose plain version keeps the weights in f32."""
    if alibi_slopes is not None:
        if mask is not None:
            raise ValueError("flash attention: ALiBi slopes with an element mask are not a "
                             "form of any TPU kernel")
        from .alibi_attention import alibi_flash_attention

        return alibi_flash_attention(q, k, v, alibi_slopes, causal, segment_ids)
    mask = None if mask is None else tile_mask(mask)
    _check_shapes(q, k, v, causal, segment_ids, mask)
    if not use_kernel(q):   # autograd sees through the plain version
        return reference_attention(q, k, v, causal, segment_ids, p_f32=mask is not None,
                                   mask=mask)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _FlashAttention.apply(q, k, v, bool(causal), segment_ids, mask)
    out, _ = _launch(q, k, v, causal, segment_ids, want_lse=False, **_mask_kw(mask))
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def flash_attention_lse(q, k, v, causal: bool = True, segment_ids=None, mask=None):
    """(out, lse): ``flash_attention`` and the log-sum-exp its kernel writes
    (``[B, H, T]`` f32, natural log). No gradient flows through this form."""
    mask = None if mask is None else tile_mask(mask)
    _check_shapes(q, k, v, causal, segment_ids, mask)
    if not use_kernel(q):
        return reference_attention_lse(q, k, v, causal, segment_ids, p_f32=mask is not None,
                                       mask=mask)
    out = _launch(q, k, v, causal, segment_ids, want_lse=True, **_mask_kw(mask))
    flash_attention.launches += 1
    return out


def flash_attention_bwd(q, k, v, out, lse, dout, causal: bool = True, segment_ids=None,
                        mask=None):
    """(dq, dk, dv) from the forward's operands, its ``out`` and ``lse``
    and the cotangent ``dout`` [B,T,H,Dh]. The CUDA kernels on a CUDA
    tensor; on a CPU tensor the plain version (which recomputes the
    softmax and does not read ``lse``)."""
    mask = None if mask is None else tile_mask(mask)
    _check_shapes(q, k, v, causal, segment_ids, mask)
    if dout.shape != q.shape or out.shape != q.shape:
        raise ValueError(f"flash attention backward: out {tuple(out.shape)} and dout "
                         f"{tuple(dout.shape)} must have q's shape {tuple(q.shape)}")
    if not use_kernel(q):
        return reference_attention_bwd(q, k, v, out, dout, causal, segment_ids, mask=mask)
    grads = _launch_bwd(q, k, v, out, lse, dout, causal, segment_ids, **_mask_kw(mask))
    flash_attention_bwd.launches += 1
    return grads


flash_attention_bwd.launches = 0


class _FlashAttention(torch.autograd.Function):
    """The kernels under autograd: forward saves (q, k, v, out, lse) and
    carries the element mask (if any) to the backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, segment_ids, mask=None):
        out, lse = _launch(q, k, v, causal, segment_ids, want_lse=True, **_mask_kw(mask))
        flash_attention.launches += 1
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.segment_ids, ctx.mask = causal, segment_ids, mask
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout, ctx.causal, ctx.segment_ids,
                                         mask=ctx.mask)
        return dq, dk, dv, None, None, None


# ---------------------------------------------------------------------------
# Launch
# ---------------------------------------------------------------------------

_LIB = []


def _lib():
    if not _LIB:
        from . import _build

        lib = _build.load("flash_attention")
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.sxt_flash_attention_bf16.argtypes = [P] * 6 + [I] + [P] * 2 + [I] * 7 + [
            ctypes.c_float, P]
        lib.sxt_flash_attention_bf16.restype = ctypes.c_int
        lib.sxt_flash_attention_bwd_bf16.argtypes = [P] * 6 + [I] + [P] * 7 + [I] * 7 + [
            ctypes.c_float, P]
        lib.sxt_flash_attention_bwd_bf16.restype = ctypes.c_int
        lib.sxt_flash_error_string.argtypes = [ctypes.c_int]
        lib.sxt_flash_error_string.restype = ctypes.c_char_p
        _LIB.append(lib)
    return _LIB[0]


def check_operands(q, k, v, segment_ids=None, *, backward: bool = False, **more) -> None:
    """What the kernels take, whatever the device: bf16, contiguous and
    16-byte aligned, a head_dim of ``HEAD_DIMS`` (``BWD_HEAD_DIMS`` for the
    ``backward``), int32-castable segment ids (``more``: further named
    bf16 operands, the backward's out and dout). A CUDA tensor that fails
    raises here; it never takes the plain version, and nothing is copied
    silently."""
    for name, t in (("q", q), ("k", k), ("v", v), *more.items()):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"flash attention kernel: {name} must be bf16, got {t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash attention kernel: {name} must be contiguous and "
                             "16-byte aligned")
    Dh = q.shape[3]
    if backward and Dh not in BWD_HEAD_DIMS:
        raise ValueError(f"flash attention backward kernels: head_dim {Dh} not built "
                         f"{BWD_HEAD_DIMS} ({LATER})")
    if Dh not in HEAD_DIMS:
        raise ValueError(f"flash attention kernel: head_dim {Dh} not built {HEAD_DIMS} "
                         f"({LATER})")
    if segment_ids is not None and segment_ids.dtype.is_floating_point:
        raise TypeError(f"flash attention kernel: segment_ids must be integers, got "
                        f"{segment_ids.dtype}")


def _same_device(dev, **tensors) -> None:
    for name, t in tensors.items():
        if t is not None and t.device != dev:
            raise ValueError(f"flash attention kernel: {name} must be on {dev}")


def _raise_on(err, lib, what: str) -> None:
    if err:
        raise RuntimeError(f"flash attention {what} launch failed: CUDA error {err} "
                           f"({lib.sxt_flash_error_string(err).decode()})")


def _tile_args(mask, device):
    """(tiles pointer, blocks pointer, nnz) of a TileMask, or nulls."""
    if mask is None:
        return None, None, 0
    tiles, blocks = mask.device_operands(device)
    return tiles.data_ptr(), blocks.data_ptr(), mask.nnz


def _launch(q, k, v, causal, segment_ids, want_lse: bool, mask=None):
    """(out, lse or None): one launch of the forward kernel."""
    dev = q.device
    _same_device(dev, k=k, v=v, segment_ids=segment_ids)
    check_operands(q, k, v, segment_ids)
    B, T, H, Dh = q.shape
    S, KV = k.shape[1], k.shape[2]
    seg = None if segment_ids is None else segment_ids.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    lse = torch.empty(B, H, T, dtype=torch.float32, device=dev) if want_lse else None
    lib = _lib()
    err = lib.sxt_flash_attention_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), None if seg is None else seg.data_ptr(),
        *_tile_args(mask, dev), out.data_ptr(), None if lse is None else lse.data_ptr(), B, T,
        S, H, KV, Dh, int(bool(causal)), float(Dh) ** -0.5,
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, lib, "kernel")
    return out, lse


def _launch_bwd(q, k, v, out, lse, dout, causal, segment_ids, mask=None):
    """(dq, dk, dv): the delta, dk/dv (one launch, but two passes for the
    element mask at head_dim 256) and dq kernels, in that order."""
    dev = q.device
    _same_device(dev, k=k, v=v, out=out, lse=lse, dout=dout, segment_ids=segment_ids)
    check_operands(q, k, v, segment_ids, backward=True, out=out, dout=dout)
    B, T, H, Dh = q.shape
    S, KV = k.shape[1], k.shape[2]
    if lse.dtype != torch.float32 or tuple(lse.shape) != (B, H, T) or not lse.is_contiguous():
        raise ValueError(f"flash attention backward: lse must be contiguous f32 "
                         f"[{B}, {H}, {T}], got {lse.dtype} {tuple(lse.shape)}")
    seg = None if segment_ids is None else segment_ids.to(torch.int32).contiguous()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty_like(lse)
    lib = _lib()
    err = lib.sxt_flash_attention_bwd_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), None if seg is None else seg.data_ptr(),
        *_tile_args(mask, dev), out.data_ptr(), dout.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), B, T, S, H, KV, Dh, int(bool(causal)),
        float(Dh) ** -0.5, torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, lib, "backward kernels")
    return dq, dk, dv


__all__ = ["BWD_HEAD_DIMS", "HEAD_DIMS", "TileMask", "check_operands", "flash_attention", "flash_attention_bwd",
           "flash_attention_lse", "reference_attention", "reference_attention_bwd",
           "reference_attention_lse", "repeat_kv", "tile_mask"]
