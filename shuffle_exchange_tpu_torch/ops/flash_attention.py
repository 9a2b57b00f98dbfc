"""Flash attention (forward): the CUDA kernel for Hopper, and its plain
PyTorch version.

Replaces the forward of the TPU kernels ``shuffle_exchange_tpu/ops/
flash_attention.py:pallas_attention`` (the stock flash kernel, MHA) and
``splash_attention_gqa`` (GQA with unexpanded K/V): causal and full masks,
segment ids, any T and S, head_dim 64 or 128. The kernel lives in
``ops/csrc/flash_attention.cu`` (whose header says what bounds it on the
H100 and how its design answers it); ``_build`` compiles that file with
``nvcc`` at first use and this module binds it with ctypes.

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
it. ALiBi and the backward are later work (ROADMAP queue A, item 5).
"""

from __future__ import annotations

import ctypes
from typing import Optional

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
    n_rep = q.shape[2] // k.shape[2]
    k = repeat_kv(k, n_rep)
    v = repeat_kv(v, n_rep)
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
    probs = torch.softmax(logits, dim=-1)
    if not p_f32:
        probs = probs.to(v.dtype)
    return torch.einsum("bhts,bshd->bthd", probs.float(), v.float()).to(q.dtype)


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
    CUDA kernel on a CUDA tensor, the plain version on a CPU tensor."""
    if alibi_slopes is not None:
        raise NotImplementedError("ALiBi in the flash attention kernel is not ported yet: "
                                  "ROADMAP queue A, item 5")
    _check_shapes(q, k, v, causal, segment_ids)
    if not use_kernel(q):
        return reference_attention(q, k, v, causal, segment_ids)
    out = _launch(q, k, v, causal, segment_ids)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


# ---------------------------------------------------------------------------
# Launch
# ---------------------------------------------------------------------------

_LIB = []


def _lib():
    if not _LIB:
        from . import _build

        lib = _build.load("flash_attention")
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.sxt_flash_attention_bf16.argtypes = [P] * 5 + [I] * 7 + [ctypes.c_float, P]
        lib.sxt_flash_attention_bf16.restype = ctypes.c_int
        lib.sxt_flash_error_string.argtypes = [ctypes.c_int]
        lib.sxt_flash_error_string.restype = ctypes.c_char_p
        _LIB.append(lib)
    return _LIB[0]


def check_operands(q, k, v, segment_ids=None) -> None:
    """What the kernel takes, whatever the device: bf16, contiguous and
    16-byte aligned, head_dim 64 or 128, int32-castable segment ids. A
    CUDA tensor that fails raises here; it never takes the plain version."""
    for name, t in (("q", q), ("k", k), ("v", v)):
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


def _launch(q, k, v, causal, segment_ids):
    dev = q.device
    for name, t in (("k", k), ("v", v), ("segment_ids", segment_ids)):
        if t is not None and t.device != dev:
            raise ValueError(f"flash attention kernel: {name} must be on {dev}")
    check_operands(q, k, v, segment_ids)
    B, T, H, Dh = q.shape
    S, KV = k.shape[1], k.shape[2]
    seg = None if segment_ids is None else segment_ids.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    lib = _lib()
    err = lib.sxt_flash_attention_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), None if seg is None else seg.data_ptr(),
        out.data_ptr(), B, T, S, H, KV, Dh, int(bool(causal)), float(Dh) ** -0.5,
        torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"flash attention kernel launch failed: CUDA error {err} "
                           f"({lib.sxt_flash_error_string(err).decode()})")
    return out


__all__ = ["HEAD_DIMS", "check_operands", "flash_attention", "reference_attention",
           "repeat_kv"]
