"""Flash attention, forward and backward: the CUDA kernels for Hopper, and
their plain PyTorch versions.

Replaces the TPU kernels ``shuffle_exchange_tpu/ops/flash_attention.py:
pallas_attention`` (the stock flash kernel, MHA, forward and backward) and
``splash_attention_gqa`` (GQA with unexpanded K/V: the forward, the dq
pass and the dkv pass): causal and full masks, segment ids, any T and S,
head_dim 64 or 128. The kernels live in ``ops/csrc/flash_attention.cu``
(whose header says what bounds them on the H100 and how the design answers
it); ``_build`` compiles that file with ``nvcc`` at first use and this
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
it. ALiBi is later work (ROADMAP queue A, item 5).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .dispatch import use_kernel

_NEG = -1e30     # the mask value of reference_attention and the TPU kernels
HEAD_DIMS = (64, 128)

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
                        p_f32: bool = False) -> torch.Tensor:
    """q [B,T,H,Dh], k/v [B,S,KV,Dh] -> [B,T,H,Dh]: scores in f32 with q
    scaled by Dh^-0.5 in f32; masked scores -1e30 (causal: query i sees
    keys j <= i + S - T; segment ids [B, T] that differ); softmax in f32;
    the weights cast to v's dtype before P·V unless ``p_f32``."""
    v = repeat_kv(v, q.shape[2] // k.shape[2])
    probs = torch.softmax(_masked_logits(q, k, causal, segment_ids), dim=-1)
    if not p_f32:
        probs = probs.to(v.dtype)
    return torch.einsum("bhts,bshd->bthd", probs.float(), v.float()).to(q.dtype)


def _masked_logits(q, k, causal, segment_ids) -> torch.Tensor:
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
    return logits


def reference_attention_lse(q, k, v, causal: bool = True, segment_ids=None,
                            p_f32: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """``reference_attention`` and the natural-log log-sum-exp of each
    row's masked scaled scores, ``lse [B, H, T]`` f32."""
    out = reference_attention(q, k, v, causal, segment_ids, p_f32=p_f32)
    return out, torch.logsumexp(_masked_logits(q, k, causal, segment_ids), dim=-1)


def reference_attention_bwd(q, k, v, out, dout, causal: bool = True, segment_ids=None):
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
    probs = torch.softmax(_masked_logits(q, k, causal, segment_ids), dim=-1)   # [B,H,T,S]
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


def _check_shapes(q, k, v, causal, segment_ids) -> None:
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


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True,
                    segment_ids: Optional[torch.Tensor] = None, *,
                    alibi_slopes=None) -> torch.Tensor:
    """q [B,T,H,Dh], k/v [B,S,KV,Dh] (H a multiple of KV, query head h
    reading kv head h // (H // KV)) -> [B,T,H,Dh]; ``segment_ids`` [B, T]
    int (T == S) mask pairs whose ids differ. Causal needs T == S. The
    CUDA kernel on a CUDA tensor, the plain version on a CPU tensor.
    ``alibi_slopes`` [H] route to ``alibi_flash_attention`` (S >= T,
    bottom-right diagonal)."""
    if alibi_slopes is not None:
        from .alibi_attention import alibi_flash_attention

        return alibi_flash_attention(q, k, v, alibi_slopes, causal, segment_ids)
    _check_shapes(q, k, v, causal, segment_ids)
    if not use_kernel(q):
        return reference_attention(q, k, v, causal, segment_ids)   # autograd sees through it
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _FlashAttention.apply(q, k, v, bool(causal), segment_ids)
    out, _ = _launch(q, k, v, causal, segment_ids, want_lse=False)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def flash_attention_lse(q, k, v, causal: bool = True, segment_ids=None):
    """(out, lse): ``flash_attention`` and the log-sum-exp its kernel writes
    (``[B, H, T]`` f32, natural log). No gradient flows through this form."""
    _check_shapes(q, k, v, causal, segment_ids)
    if not use_kernel(q):
        return reference_attention_lse(q, k, v, causal, segment_ids)
    out = _launch(q, k, v, causal, segment_ids, want_lse=True)
    flash_attention.launches += 1
    return out


def flash_attention_bwd(q, k, v, out, lse, dout, causal: bool = True, segment_ids=None):
    """(dq, dk, dv) from the forward's operands, its ``out`` and ``lse``
    and the cotangent ``dout`` [B,T,H,Dh]. The CUDA kernels on a CUDA
    tensor; on a CPU tensor the plain version (which recomputes the
    softmax and does not read ``lse``)."""
    _check_shapes(q, k, v, causal, segment_ids)
    if dout.shape != q.shape or out.shape != q.shape:
        raise ValueError(f"flash attention backward: out {tuple(out.shape)} and dout "
                         f"{tuple(dout.shape)} must have q's shape {tuple(q.shape)}")
    if not use_kernel(q):
        return reference_attention_bwd(q, k, v, out, dout, causal, segment_ids)
    grads = _launch_bwd(q, k, v, out, lse, dout, causal, segment_ids)
    flash_attention_bwd.launches += 1
    return grads


flash_attention_bwd.launches = 0


class _FlashAttention(torch.autograd.Function):
    """The kernels under autograd: forward saves (q, k, v, out, lse)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, segment_ids):
        out, lse = _launch(q, k, v, causal, segment_ids, want_lse=True)
        flash_attention.launches += 1
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.segment_ids = causal, segment_ids
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout, ctx.causal, ctx.segment_ids)
        return dq, dk, dv, None, None


# ---------------------------------------------------------------------------
# Launch
# ---------------------------------------------------------------------------

_LIB = []


def _lib():
    if not _LIB:
        from . import _build

        lib = _build.load("flash_attention")
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.sxt_flash_attention_bf16.argtypes = [P] * 6 + [I] * 7 + [ctypes.c_float, P]
        lib.sxt_flash_attention_bf16.restype = ctypes.c_int
        lib.sxt_flash_attention_bwd_bf16.argtypes = [P] * 11 + [I] * 7 + [ctypes.c_float, P]
        lib.sxt_flash_attention_bwd_bf16.restype = ctypes.c_int
        lib.sxt_flash_error_string.argtypes = [ctypes.c_int]
        lib.sxt_flash_error_string.restype = ctypes.c_char_p
        _LIB.append(lib)
    return _LIB[0]


def check_operands(q, k, v, segment_ids=None, **more) -> None:
    """What the kernels take, whatever the device: bf16, contiguous and
    16-byte aligned, head_dim 64 or 128, int32-castable segment ids
    (``more``: further named bf16 operands, the backward's out and dout).
    A CUDA tensor that fails raises here; it never takes the plain
    version, and nothing is copied silently."""
    for name, t in (("q", q), ("k", k), ("v", v), *more.items()):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"flash attention kernel: {name} must be bf16, got {t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash attention kernel: {name} must be contiguous and "
                             "16-byte aligned")
    if q.shape[3] not in HEAD_DIMS:
        raise ValueError(f"flash attention kernel: head_dim {q.shape[3]} not built "
                         f"{HEAD_DIMS}")
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


def _launch(q, k, v, causal, segment_ids, want_lse: bool):
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
        out.data_ptr(), None if lse is None else lse.data_ptr(), B, T, S, H, KV, Dh,
        int(bool(causal)), float(Dh) ** -0.5, torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, lib, "kernel")
    return out, lse


def _launch_bwd(q, k, v, out, lse, dout, causal, segment_ids):
    """(dq, dk, dv): the delta, dk/dv and dq kernels, in that order."""
    dev = q.device
    _same_device(dev, k=k, v=v, out=out, lse=lse, dout=dout, segment_ids=segment_ids)
    check_operands(q, k, v, segment_ids, out=out, dout=dout)
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
        out.data_ptr(), dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), B, T, S, H, KV, Dh, int(bool(causal)),
        float(Dh) ** -0.5, torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, lib, "backward kernels")
    return dq, dk, dv


__all__ = ["HEAD_DIMS", "check_operands", "flash_attention", "flash_attention_bwd",
           "flash_attention_lse", "reference_attention", "reference_attention_bwd",
           "reference_attention_lse", "repeat_kv"]
