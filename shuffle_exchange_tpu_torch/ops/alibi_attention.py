"""ALiBi flash attention, forward and backward: the CUDA kernels for Hopper,
and their plain PyTorch versions.

Replaces the TPU kernels of ``shuffle_exchange_tpu/ops/alibi_attention.py``:
``_alibi_flash_fwd_impl`` (B11, out and lse), and the dq pass (B12) and the
dk/dv pass with the slope cotangent (B13) of ``_flash_bwd_impl``. The kernels
are the ALiBi instances of the dense flash kernels' warp-specialised
``wgmma`` bodies (``ops/csrc/wgmma_flash.cuh``), wrapped in
``ops/csrc/alibi_attention.cu`` (whose header says what bounds them on the
H100 and what the ALiBi form adds); ``_build`` compiles that file with
``nvcc`` at first use and this module binds it with ctypes.

What is computed, as the JAX package computes it: scores q.k * Dh^-0.5 in
f32 plus ``slope_h * j`` on the absolute key position j; the causal
diagonal aligned bottom-right (query i sees keys j <= i + S - T, S >= T);
masked scores -1e30; softmax in f32; the natural-log ``lse [B, H, T]``
including the bias. Query head h reads kv head h // (H // KV).

``alibi_flash_attention`` is differentiable. A CUDA call that requires grad
goes through a ``torch.autograd.Function`` whose forward writes lse and
saves ``(q, k, v, slopes, out, lse)`` and whose backward launches the
backward kernels, with the dslope output only when ``slopes`` requires grad
(JAX's ``need_dslope=False`` otherwise). A CPU call is autograd through
``reference_alibi_attention_lse``. The kernels take causal attention
without segment ids only; the wrapper refuses the rest on every device
(bidirectional ALiBi is ROADMAP queue A, item 4 (d)). Unlike the JAX
``alibi_kernel_ok`` there is no shape gate: ragged T and S (training runs
T = seq - 1) are masked inside the kernels.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .dispatch import use_kernel
from .flash_attention import repeat_kv

#: the head dims B11-B13 are built for (their own: B14's forward also takes 256)
HEAD_DIMS = (64, 128)

_NEG = -1e30     # the mask value of reference_attention and the TPU kernels
_KEY_TILE = 64   # keys per tile of the dk/dv kernel: one dslope partial each

# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------


def _alibi_logits(q, k, slopes, causal: bool) -> torch.Tensor:
    """The f32 scores [B, H, T, S]: q scaled by Dh^-0.5 in f32, plus
    ``slope_h * j``, masked to -1e30 above the bottom-right diagonal."""
    k = repeat_kv(k, q.shape[2] // k.shape[2])
    T, S = q.shape[1], k.shape[1]
    logits = torch.einsum("bthd,bshd->bhts", q.float() * q.shape[-1] ** -0.5, k.float())
    pos = torch.arange(S, dtype=torch.float32, device=q.device)
    logits = logits + slopes.float().to(q.device)[None, :, None, None] * pos
    if causal:
        mask = torch.ones(T, S, dtype=torch.bool, device=q.device).tril(S - T)
        logits = logits.masked_fill(~mask[None, None], _NEG)
    return logits


def reference_alibi_attention_lse(q, k, v, slopes, causal: bool = True,
                                  p_f32: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out [B, T, H, Dh] in q's dtype, lse [B, H, T] f32): JAX
    ``reference_attention(..., alibi_slopes=slopes)`` and the log-sum-exp of
    each row's biased, masked scores. The softmax weights are cast to
    ``v.dtype`` before P.V unless ``p_f32`` (the kernel keeps P to ~16 bits,
    so the card check holds it against ``p_f32=True``)."""
    logits = _alibi_logits(q, k, slopes, causal)
    probs = torch.softmax(logits, dim=-1)
    if not p_f32:
        probs = probs.to(v.dtype)
    vr = repeat_kv(v, q.shape[2] // k.shape[2])
    out = torch.einsum("bhts,bshd->bthd", probs.float(), vr.float()).to(q.dtype)
    return out, torch.logsumexp(logits, dim=-1)


def reference_alibi_attention_bwd(q, k, v, slopes, out, lse, dout, causal: bool = True,
                                  need_dslope: bool = True):
    """(dq, dk, dv, dslope [H] f32 or None), computed in f32 as the TPU dq
    and dk/dv kernels compute them (``_score_grads``): ``P = exp(S - lse)``
    from the forward's lse, ``dP = dO V^T``, ``delta = rowsum(dO * out)``
    from the forward's stored out, ``dS = P (dP - delta)``,
    ``dq = scale dS K``, ``dk = dS^T (q scale)``, ``dv = P^T dO`` (dk and dv
    summed over a kv head's query heads) and ``dslope_h = sum dS_ij * j``
    over batch, queries and keys."""
    B, S, KV, Dh = k.shape
    G = q.shape[2] // KV
    p = torch.exp(_alibi_logits(q, k, slopes, causal) - lse.float()[..., None])
    do = dout.float()
    dp = torch.einsum("bthd,bshd->bhts", do, repeat_kv(v, G).float())
    delta = (do * out.float()).sum(-1).permute(0, 2, 1)                    # [B, H, T]
    ds = p * (dp - delta[..., None])
    scale = Dh ** -0.5
    dq = scale * torch.einsum("bhts,bshd->bthd", ds, repeat_kv(k, G).float())
    dk = torch.einsum("bhts,bthd->bshd", ds, q.float() * scale)
    dv = torch.einsum("bhts,bthd->bshd", p, do)
    dk, dv = (t.reshape(B, S, KV, G, Dh).sum(3) for t in (dk, dv))
    dslope = None
    if need_dslope:
        pos = torch.arange(S, dtype=torch.float32, device=q.device)
        dslope = (ds * pos).sum(dim=(0, 2, 3))
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), dslope


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


def _check_shapes(q, k, v, slopes, causal, segment_ids) -> None:
    if not causal:
        raise NotImplementedError("ALiBi attention without the causal mask (bidirectional "
                                  "ALiBi) is not ported: ROADMAP queue A, item 4 (d)")
    if segment_ids is not None:
        raise NotImplementedError("ALiBi attention with segment ids is not ported (the JAX "
                                  "package takes its jnp reference there): ROADMAP queue A, "
                                  "item 4 (d)")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"alibi attention: q must be [B,T,H,Dh] and k, v [B,S,KV,Dh], got "
                         f"{tuple(q.shape)} / {tuple(k.shape)} / {tuple(v.shape)}")
    B, T, H, Dh = q.shape
    _, S, KV, _ = k.shape
    if k.shape[0] != B or k.shape[3] != Dh or KV < 1 or H % KV:
        raise ValueError(f"alibi attention: k/v {tuple(k.shape)} do not serve q "
                         f"{tuple(q.shape)} (same batch and head_dim, H a multiple of KV)")
    if S < T:
        raise ValueError(f"alibi attention: S={S} < T={T}; the causal diagonal is aligned "
                         "bottom-right (query i sees keys j <= i + S - T), which needs S >= T")
    if tuple(slopes.shape) != (H,):
        raise ValueError(f"alibi attention: slopes must be [H] = [{H}], got "
                         f"{tuple(slopes.shape)}")


def _as_slopes(slopes, q) -> torch.Tensor:
    if isinstance(slopes, torch.Tensor):
        return slopes
    return torch.as_tensor(slopes, dtype=torch.float32, device=q.device)


def alibi_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, slopes,
                          causal: bool = True,
                          segment_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q [B,T,H,Dh], k/v [B,S,KV,Dh] (S >= T), slopes [H] -> [B,T,H,Dh]:
    the B11 kernel on a CUDA tensor (its backward B12 + B13 under autograd),
    the plain version on a CPU tensor."""
    slopes = _as_slopes(slopes, q)
    _check_shapes(q, k, v, slopes, causal, segment_ids)
    if not use_kernel(q):
        return reference_alibi_attention_lse(q, k, v, slopes, causal)[0]
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v, slopes)):
        return _AlibiFlashAttention.apply(q, k, v, slopes)
    out, _ = _launch(q, k, v, slopes, want_lse=False)
    alibi_flash_attention.launches += 1
    return out


alibi_flash_attention.launches = 0


def alibi_flash_attention_lse(q, k, v, slopes, causal: bool = True, segment_ids=None):
    """(out, lse): ``alibi_flash_attention`` and the log-sum-exp its kernel
    writes (``[B, H, T]`` f32, natural log, bias included). No gradient
    flows through this form."""
    slopes = _as_slopes(slopes, q)
    _check_shapes(q, k, v, slopes, causal, segment_ids)
    if not use_kernel(q):
        return reference_alibi_attention_lse(q, k, v, slopes, causal)
    out = _launch(q, k, v, slopes, want_lse=True)
    alibi_flash_attention.launches += 1
    return out


def alibi_flash_attention_bwd(q, k, v, slopes, out, lse, dout, causal: bool = True,
                              need_dslope: bool = True):
    """(dq, dk, dv, dslope or None) from the forward's operands, its ``out``
    and ``lse`` and the cotangent ``dout``: the delta, dk/dv (B13) and dq
    (B12) kernels on a CUDA tensor, the plain version on a CPU tensor."""
    slopes = _as_slopes(slopes, q)
    _check_shapes(q, k, v, slopes, causal, None)
    if dout.shape != q.shape or out.shape != q.shape:
        raise ValueError(f"alibi attention backward: out {tuple(out.shape)} and dout "
                         f"{tuple(dout.shape)} must have q's shape {tuple(q.shape)}")
    if not use_kernel(q):
        return reference_alibi_attention_bwd(q, k, v, slopes, out, lse, dout, causal,
                                             need_dslope)
    grads = _launch_bwd(q, k, v, slopes, out, lse, dout, need_dslope)
    alibi_flash_attention_bwd.launches += 1
    return grads


alibi_flash_attention_bwd.launches = 0


class _AlibiFlashAttention(torch.autograd.Function):
    """The kernels under autograd: forward saves (q, k, v, slopes, out, lse)."""

    @staticmethod
    def forward(ctx, q, k, v, slopes):
        out, lse = _launch(q, k, v, slopes, want_lse=True)
        alibi_flash_attention.launches += 1
        ctx.save_for_backward(q, k, v, slopes, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, slopes, out, lse = ctx.saved_tensors
        dq, dk, dv, dslope = alibi_flash_attention_bwd(
            q, k, v, slopes, out, lse, dout, need_dslope=ctx.needs_input_grad[3])
        return dq, dk, dv, dslope


# ---------------------------------------------------------------------------
# Launch
# ---------------------------------------------------------------------------

_LIB = []


def _lib():
    if not _LIB:
        from . import _build

        lib = _build.load("alibi_attention")
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.sxt_alibi_fwd_bf16.argtypes = [P] * 6 + [I] * 6 + [F, P]
        lib.sxt_alibi_bwd_delta_bf16.argtypes = [P] * 3 + [I] * 4 + [P]
        lib.sxt_alibi_bwd_dkv_bf16.argtypes = [P] * 10 + [I] * 6 + [F, P]
        lib.sxt_alibi_bwd_dq_bf16.argtypes = [P] * 8 + [I] * 6 + [F, P]
        for fn in (lib.sxt_alibi_fwd_bf16, lib.sxt_alibi_bwd_delta_bf16,
                   lib.sxt_alibi_bwd_dkv_bf16, lib.sxt_alibi_bwd_dq_bf16):
            fn.restype = ctypes.c_int
        lib.sxt_alibi_error_string.argtypes = [ctypes.c_int]
        lib.sxt_alibi_error_string.restype = ctypes.c_char_p
        _LIB.append(lib)
    return _LIB[0]


def check_operands(q, k, v, slopes, **more) -> None:
    """What the kernels take, whatever the device: bf16 q, k, v (and the
    further named bf16 operands in ``more``: the backward's out and dout),
    contiguous and 16-byte aligned; f32 contiguous slopes; head_dim 64 or
    128. A CUDA tensor that fails raises here; it never takes the plain
    version, and nothing is copied silently."""
    for name, t in (("q", q), ("k", k), ("v", v), *more.items()):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"alibi attention kernel: {name} must be bf16, got {t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"alibi attention kernel: {name} must be contiguous and "
                             "16-byte aligned")
    if slopes.dtype != torch.float32 or not slopes.is_contiguous():
        raise TypeError(f"alibi attention kernel: slopes must be contiguous f32, got "
                        f"{slopes.dtype}")
    if q.shape[3] not in HEAD_DIMS:
        raise ValueError(f"alibi attention kernel: head_dim {q.shape[3]} not built "
                         f"{HEAD_DIMS}")


def _same_device(dev, **tensors) -> None:
    for name, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"alibi attention kernel: {name} must be on {dev}")


def _raise_on(err, lib, what: str) -> None:
    if err:
        raise RuntimeError(f"alibi attention {what} launch failed: CUDA error {err} "
                           f"({lib.sxt_alibi_error_string(err).decode()})")


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _launch(q, k, v, slopes, want_lse: bool):
    """(out, lse or None): one launch of the B11 forward kernel."""
    dev = q.device
    _same_device(dev, k=k, v=v, slopes=slopes)
    check_operands(q, k, v, slopes)
    B, T, H, Dh = q.shape
    S, KV = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty(B, H, T, dtype=torch.float32, device=dev) if want_lse else None
    lib = _lib()
    err = lib.sxt_alibi_fwd_bf16(q.data_ptr(), k.data_ptr(), v.data_ptr(), slopes.data_ptr(),
                                 out.data_ptr(), None if lse is None else lse.data_ptr(), B, T,
                                 S, H, KV, Dh, float(Dh) ** -0.5, _stream(dev))
    _raise_on(err, lib, "forward kernel")
    return out, lse


def _check_bwd_operands(q, k, v, slopes, out, lse, dout) -> None:
    _same_device(q.device, k=k, v=v, slopes=slopes, out=out, lse=lse, dout=dout)
    check_operands(q, k, v, slopes, out=out, dout=dout)
    B, T, H, _ = q.shape
    if lse.dtype != torch.float32 or tuple(lse.shape) != (B, H, T) or not lse.is_contiguous():
        raise ValueError(f"alibi attention backward: lse must be contiguous f32 "
                         f"[{B}, {H}, {T}], got {lse.dtype} {tuple(lse.shape)}")


def _launch_delta(out, dout) -> torch.Tensor:
    """delta [B, H, T] f32 = rowsum(dout * out)."""
    B, T, H, Dh = out.shape
    delta = torch.empty(B, H, T, dtype=torch.float32, device=out.device)
    lib = _lib()
    _raise_on(lib.sxt_alibi_bwd_delta_bf16(out.data_ptr(), dout.data_ptr(), delta.data_ptr(),
                                           B, T, H, Dh, _stream(out.device)),
              lib, "backward delta kernel")
    return delta


def _launch_dkv(q, k, v, slopes, dout, lse, delta, need_dslope: bool):
    """(dk, dv, dslope or None): one launch of the B13 kernel; the
    [B, H, key tiles] dslope partials summed over batch and tiles."""
    B, T, H, Dh = q.shape
    S, KV = k.shape[1], k.shape[2]
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    part = (torch.empty(B, H, -(-S // _KEY_TILE), dtype=torch.float32, device=q.device)
            if need_dslope else None)
    lib = _lib()
    err = lib.sxt_alibi_bwd_dkv_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), slopes.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        None if part is None else part.data_ptr(), B, T, S, H, KV, Dh, float(Dh) ** -0.5,
        _stream(q.device))
    _raise_on(err, lib, "dk/dv kernel")
    return dk, dv, (None if part is None else part.sum(dim=(0, 2)))


def _launch_dq(q, k, v, slopes, dout, lse, delta) -> torch.Tensor:
    """dq: one launch of the B12 kernel."""
    B, T, H, Dh = q.shape
    S, KV = k.shape[1], k.shape[2]
    dq = torch.empty_like(q)
    lib = _lib()
    err = lib.sxt_alibi_bwd_dq_bf16(q.data_ptr(), k.data_ptr(), v.data_ptr(), slopes.data_ptr(),
                                    dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                                    dq.data_ptr(), B, T, S, H, KV, Dh, float(Dh) ** -0.5,
                                    _stream(q.device))
    _raise_on(err, lib, "dq kernel")
    return dq


def _launch_bwd(q, k, v, slopes, out, lse, dout, need_dslope: bool):
    """(dq, dk, dv, dslope or None): the delta, dk/dv and dq kernels."""
    _check_bwd_operands(q, k, v, slopes, out, lse, dout)
    delta = _launch_delta(out, dout)
    dk, dv, dslope = _launch_dkv(q, k, v, slopes, dout, lse, delta, need_dslope)
    return _launch_dq(q, k, v, slopes, dout, lse, delta), dk, dv, dslope


__all__ = ["alibi_flash_attention", "alibi_flash_attention_bwd", "alibi_flash_attention_lse",
           "check_operands", "reference_alibi_attention_bwd", "reference_alibi_attention_lse"]
