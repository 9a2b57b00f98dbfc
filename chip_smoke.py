"""Smoke run of the PyTorch port (``shuffle_exchange_tpu_torch``) on one
NVIDIA H100.

Run from the repository root, with one CUDA card:

    python3 chip_smoke.py [--seed N] [--out result.json]

It never imports JAX or the JAX package, and every failure ends it with a
non-zero exit code. Four phases:

1. Build: ``nvcc`` compiles the two CUDA sources (paged attention and the
   fused decode layer) into ``build/`` at once, one process each, and the
   Triton RMSNorm kernel compiles at its first launch.
2. Kernels: each kernel and its plain PyTorch version run in bf16 on the
   card at the serving path's shapes; the errors are held to stated
   tolerances (shown once to catch a deliberately broken plain version)
   and each is timed beside its bound (the least time the card could
   take for the same work) and one PyTorch library call that computes the
   same function, as a yardstick only; the host's cost of issuing one
   call of each wrapper is timed too.
3. Serve: ``ContinuousBatchingScheduler(InferenceEngineV2(...)).serve`` on
   Llama-3-8B at full width and depth with random weights from a seeded
   generator on the card, twice: with ``decode_kernel: "auto"`` (which
   must resolve to the fused kernels) and with ``"xla"`` (the paged
   decode kernel). The kernels' launch counters, zeroed just before each
   serve and read just after, must equal what the engine's programs
   imply. A short profiled serve of each shows where the device time goes.
4. End to end: the same weights cut to depth 2 on the card (bf16), with
   "auto" and with "xla", and on the CPU (the plain path in f32) run one
   teacher-forced ``step()`` schedule; every tick's logits must agree
   within a stated tolerance.

The second-to-last line of standard output is one JSON object with a row
per kernel; the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
BF16_FLOP_PER_S = 989e12       # H100 SXM dense bf16 tensor-core peak
FLUSH_BYTES = 256 << 20        # written between timed launches: > the 50 MB L2


def _check(ok, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def card_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]


def bound(nbytes: float, flops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def time_cold(fn, iters: int = 20) -> float:
    """Mean device ms of ``fn`` with a cold L2: before each timed call the
    card writes FLUSH_BYTES and then idles for about a millisecond, so the
    host has enqueued the call before its start event is reached."""
    import torch

    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()
    pairs = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(2_000_000)
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / iters


def host_us(fn, calls: int = 20) -> float:
    """Mean host microseconds to issue one call of ``fn`` (its Python,
    checks, allocations and launches). The calls queue behind a ~25 ms
    device sleep, so the host never waits on the card."""
    import torch

    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def check_rmsnorm(gen):
    import torch
    import torch.nn.functional as F

    from shuffle_exchange_tpu_torch.ops.rmsnorm import rmsnorm, rmsnorm_reference

    rows_out = []
    for rows in (256, 8):
        D = 4096
        x = torch.randn(rows, D, generator=gen, device="cuda").bfloat16()
        w = (1 + 0.1 * torch.randn(D, generator=gen, device="cuda")).bfloat16()
        got, want = rmsnorm(x, w, 1e-5).float(), rmsnorm_reference(x, w, 1e-5).float()
        torch.cuda.synchronize()
        err = (got - want).abs()
        # both keep f32 statistics and round once to bf16: within two
        # bf16 steps (2^-7 relative) of each other
        tol_ok = bool((err <= 2 ** -7 * want.abs() + 1e-3).all())
        lib = F.rms_norm(x, (D,), w, 1e-5).float()
        nbytes = 2 * rows * D * 2 + D * 2
        b_ms, b_by = bound(nbytes, 4.0 * rows * D)
        rows_out.append(dict(
            shape=[rows, D], max_abs_err=err.max().item(),
            max_rel_err=(err.max() / want.abs().max()).item(), tolerance="2^-7*|plain| + 1e-3",
            within=tol_ok, library_max_abs_err=(lib - want).abs().max().item(),
            ms=time_cold(lambda: rmsnorm(x, w, 1e-5)),
            host_us=host_us(lambda: rmsnorm(x, w, 1e-5)),
            plain_ms=time_cold(lambda: rmsnorm_reference(x, w, 1e-5)),
            library_ms=time_cold(lambda: F.rms_norm(x, (D,), w, 1e-5)),
            bound_ms=b_ms, bound_by=b_by))
        _check(tol_ok, f"rmsnorm kernel disagrees with its plain version at {[rows, D]}: "
               f"max abs err {rows_out[-1]['max_abs_err']}")
    return rows_out


# The paged kernels and their plain versions (given p_f32=True, so both
# keep the softmax weights in f32) each round one f32 result to bf16; the
# f32 results differ only in summation order. So they agree to one bf16
# step of the output (2^-7 |plain|), plus 1e-3 of the head row's RMS for
# outputs near zero. A mask off by one position at kv_len ~1000 moves
# most outputs by several times that.
PAGED_TOL = "2^-7*|plain| + 1e-3*rms(plain row)"


def paged_close(got, want):
    """(elementwise |got - want|, whether all of it is within PAGED_TOL);
    rows are the last dimension (one head's Dh outputs)."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    rms = want.pow(2).mean(-1, keepdim=True).sqrt()
    return err, bool((err <= 2 ** -7 * want.abs() + 1e-3 * rms).all())


def _paged_inputs(gen, rng, lens, H, KV, Dh, bs, pad=0):
    """A bf16 pool holding the sequences' blocks in shuffled order, their
    block tables padded to a power-of-two width with ``pad`` (the scratch
    block 0, or -1, which the kernels read as block 0)."""
    import torch

    nb = [-(-int(n) // bs) for n in lens]
    nblk = 1 + sum(nb)
    W = 1 << max(0, (max(nb) - 1).bit_length())
    ids = rng.permutation(np.arange(1, nblk)).tolist()
    table = np.full((len(lens), W), pad, np.int32)
    for b, n in enumerate(nb):
        table[b, :n] = [ids.pop() for _ in range(n)]
    ck = torch.randn(nblk, KV, bs, Dh, generator=gen, device="cuda").bfloat16()
    cv = torch.randn(nblk, KV, bs, Dh, generator=gen, device="cuda").bfloat16()
    return ck, cv, torch.from_numpy(table).cuda()


def _sdpa_inputs(q, ck, cv, table, visible):
    """Gathered K/V [B, KV, S, Dh] and a boolean mask for one SDPA call."""
    import torch

    from shuffle_exchange_tpu_torch.ops.paged_attention import gather_kv

    k, v = gather_kv(ck, cv, table)
    pos = np.arange(k.shape[1])[None, None, :]
    mask = pos < visible[:, :, None]                          # [B, C, S]
    return (q.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(),
            v.transpose(1, 2).contiguous(), torch.from_numpy(mask[:, None]).cuda())


def decode_case(gen, rng):
    """The decode inputs both decode kernels are timed at: 8 sequences of
    up to 1024 positions, Llama-3-8B heads, 64-token blocks."""
    import torch

    B, H, KV, Dh, bs = 8, 32, 8, 128, 64
    lens = np.concatenate([[1024], rng.integers(1, 1025, size=B - 1)]).astype(np.int32)
    ck, cv, table = _paged_inputs(gen, rng, lens, H, KV, Dh, bs)
    q = torch.randn(B, 1, H, Dh, generator=gen, device="cuda").bfloat16()
    return q, ck, cv, table, lens


def _decode_bound(q, ck, table, lens):
    B, _, H, Dh = q.shape
    KV = ck.shape[1]
    total = int(lens.sum())
    nbytes = 2 * B * H * Dh * 2 + total * KV * Dh * 2 * 2 + table.numel() * 4 + B * 4
    return bound(nbytes, 4.0 * total * H * Dh)


def check_paged_decode(case):
    import torch
    import torch.nn.functional as F

    from shuffle_exchange_tpu_torch.ops.paged_attention import (paged_decode_attention,
                                                                paged_decode_reference)

    q, ck, cv, table, lens = case
    B, _, H, Dh = q.shape
    KV, bs = ck.shape[1], ck.shape[2]
    kvl = torch.from_numpy(lens).cuda()
    got = paged_decode_attention(q, ck, cv, table, kvl)
    want = paged_decode_reference(q, ck, cv, table, kvl, p_f32=True)
    err, tol_ok = paged_close(got, want)
    want = want.float()
    qs, ks, vs, mask = _sdpa_inputs(q, ck, cv, table, lens[:, None])
    lib = lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask, enable_gqa=True)
    lib_err = (lib().transpose(1, 2).float() - want).abs().max().item()
    total = int(lens.sum())
    b_ms, b_by = _decode_bound(q, ck, table, lens)
    row = dict(shape=dict(B=B, H=H, KV=KV, Dh=Dh, bs=bs, kv_len=lens.tolist(),
                          kv_len_total=total, table_width=int(table.shape[1])),
               max_abs_err=err.max().item(), max_rel_err=(err.max() / want.abs().max()).item(),
               tolerance=PAGED_TOL, within=tol_ok,
               library_max_abs_err=lib_err,
               ms=time_cold(lambda: paged_decode_attention(q, ck, cv, table, kvl)),
               host_us=host_us(lambda: paged_decode_attention(q, ck, cv, table, kvl)),
               plain_ms=time_cold(lambda: paged_decode_reference(q, ck, cv, table, kvl)),
               library_ms=time_cold(lib), bound_ms=b_ms, bound_by=b_by)
    _check(tol_ok, f"paged decode kernel disagrees with its plain version: "
           f"max abs err {row['max_abs_err']}")
    return row


def check_paged_extend(gen, rng):
    import torch
    import torch.nn.functional as F

    from shuffle_exchange_tpu_torch.ops.paged_attention import (paged_extend_attention,
                                                                paged_extend_reference)

    B, C, H, KV, Dh, bs = 2, 256, 32, 8, 128, 64
    start = np.asarray([512, 700], np.int32)
    nnew = np.asarray([256, 200], np.int32)
    ck, cv, table = _paged_inputs(gen, rng, start + nnew, H, KV, Dh, bs)
    q = torch.randn(B, C, H, Dh, generator=gen, device="cuda").bfloat16()
    st, nn = torch.from_numpy(start).cuda(), torch.from_numpy(nnew).cuda()
    got = paged_extend_attention(q, ck, cv, table, st, nn)
    want = paged_extend_reference(q, ck, cv, table, st, nn, p_f32=True)
    # rows past nnew are padding the engine never reads (the plain version
    # caps them at start + nnew, the kernel keeps them causal)
    checks = [paged_close(got[b, :n], want[b, :n]) for b, n in enumerate(nnew)]
    err = torch.cat([e.flatten() for e, _ in checks])
    tol_ok = all(ok for _, ok in checks)
    want = want.float()
    ref = torch.cat([want[b, :n].abs().flatten() for b, n in enumerate(nnew)])
    c = np.arange(C)[None, :]
    visible = np.minimum(start[:, None] + c + 1, (start + nnew)[:, None])
    qs, ks, vs, mask = _sdpa_inputs(q, ck, cv, table, visible)
    lib = lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask, enable_gqa=True)
    lib_out = lib().transpose(1, 2).float()
    lib_err = max((lib_out[b, :n] - want[b, :n]).abs().max().item() for b, n in enumerate(nnew))
    rows_seen = sum(int(s) * int(n) + int(n) * (int(n) + 1) // 2 for s, n in zip(start, nnew))
    nbytes = (2 * B * C * H * Dh * 2 + int((start + nnew).sum()) * KV * Dh * 2 * 2
              + table.numel() * 4 + 2 * B * 4)
    b_ms, b_by = bound(nbytes, 4.0 * rows_seen * H * Dh)
    row = dict(shape=dict(B=B, C=C, H=H, KV=KV, Dh=Dh, bs=bs, start=start.tolist(),
                          nnew=nnew.tolist(), table_width=int(table.shape[1])),
               max_abs_err=err.max().item(), max_rel_err=(err.max() / ref.max()).item(),
               tolerance=PAGED_TOL + " (rows < nnew)",
               within=tol_ok, library_max_abs_err=lib_err,
               ms=time_cold(lambda: paged_extend_attention(q, ck, cv, table, st, nn)),
               host_us=host_us(lambda: paged_extend_attention(q, ck, cv, table, st, nn)),
               plain_ms=time_cold(lambda: paged_extend_reference(q, ck, cv, table, st, nn)),
               library_ms=time_cold(lib), bound_ms=b_ms, bound_by=b_by)
    _check(tol_ok, f"paged extend kernel disagrees with its plain version: "
           f"max abs err {row['max_abs_err']}")
    return row


# (H, KV, Dh, bs): GQA groups 1, 3, 4 and 8, both built head sizes, two
# block sizes
SWEEP = [(8, 8, 64, 16), (24, 8, 128, 64), (32, 8, 128, 16), (16, 2, 64, 64)]


def check_paged_sweep(gen, rng):
    """Correctness only, at shapes off the smoke path: the SWEEP head
    layouts, kv_len 1 and block-boundary lengths, tables padded with -1,
    one-row and odd-length chunks with rows past nnew, and a head layout
    the decode kernel refuses. Returns the largest errors; a disagreement
    beyond PAGED_TOL fails."""
    import torch

    from shuffle_exchange_tpu_torch.ops.paged_attention import (paged_decode_attention,
                                                                paged_decode_reference,
                                                                paged_extend_attention,
                                                                paged_extend_reference)

    def close(got, want):
        err, ok = paged_close(got, want)
        return err.max().item(), ok

    worst = {"decode": 0.0, "extend": 0.0}
    for H, KV, Dh, bs in SWEEP:
        lens = np.asarray([1, bs, bs + 1, 3 * bs - 5, 200], np.int32)
        ck, cv, table = _paged_inputs(gen, rng, lens, H, KV, Dh, bs, pad=-1)
        q = torch.randn(len(lens), 1, H, Dh, generator=gen, device="cuda").bfloat16()
        kvl = torch.from_numpy(lens).cuda()
        err, ok = close(paged_decode_attention(q, ck, cv, table, kvl),
                        paged_decode_reference(q, ck, cv, table, kvl, p_f32=True))
        _check(ok, f"paged decode kernel disagrees at H={H} KV={KV} Dh={Dh} bs={bs}: {err}")
        worst["decode"] = max(worst["decode"], err)
        for C, start, nnew in ((1, [0, 5, 40, 7, 100], [1, 1, 1, 1, 1]),
                               (37, [0, 9, 64, 3, 120], [37, 20, 1, 37, 30])):
            start, nnew = np.asarray(start, np.int32), np.asarray(nnew, np.int32)
            ck, cv, table = _paged_inputs(gen, rng, start + nnew, H, KV, Dh, bs, pad=-1)
            q = torch.randn(len(start), C, H, Dh, generator=gen, device="cuda").bfloat16()
            st, nn = torch.from_numpy(start).cuda(), torch.from_numpy(nnew).cuda()
            got = paged_extend_attention(q, ck, cv, table, st, nn)
            want = paged_extend_reference(q, ck, cv, table, st, nn, p_f32=True)
            for b, n in enumerate(nnew):
                err, ok = close(got[b, :n], want[b, :n])
                _check(ok, f"paged extend kernel disagrees at H={H} KV={KV} Dh={Dh} bs={bs} "
                       f"C={C} row {b}: {err}")
                worst["extend"] = max(worst["extend"], err)
    q = torch.zeros(1, 1, 64, 128, device="cuda", dtype=torch.bfloat16)
    pool = torch.zeros(2, 4, 16, 128, device="cuda", dtype=torch.bfloat16)
    one = torch.ones(1, dtype=torch.int32, device="cuda")
    try:
        paged_decode_attention(q, pool, pool, one[:, None], one)
    except ValueError as e:   # G * Dh = 2048 is past what the decode kernel holds
        worst["refused"] = str(e)
    _check("refused" in worst, "the decode kernel accepted G * Dh = 2048")
    torch.cuda.synchronize()
    return worst


# ---------------------------------------------------------------------------
# Phase 2b: the fused decode kernels
# ---------------------------------------------------------------------------

LLAMA_WIDTHS = dict(D=4096, H=32, KV=8, Dh=128, F=14336)


def _bites(got, broken) -> bool:
    """The tolerance catches a deliberately broken plain version: the
    kernel's output is NOT within PAGED_TOL of it."""
    return not paged_close(got, broken)[1]


def check_fused_qkv(gen, rng, B):
    """B4 at Llama-3-8B widths: B rows at random positions < 2048, each
    appending into its own block of the pool; both sides start from the
    same pool and must leave every other pool row as it was."""
    import torch

    from shuffle_exchange_tpu_torch.models.transformer import rope_table
    from shuffle_exchange_tpu_torch.ops.fused_decode import (fused_qkv_rope,
                                                             fused_qkv_rope_reference)

    D, H, KV, Dh = (LLAMA_WIDTHS[k] for k in ("D", "H", "KV", "Dh"))
    bs, W = 64, 32
    pos = rng.integers(0, W * bs, size=B).astype(np.int32)
    table = np.full((B, W), -1, np.int32)
    table[np.arange(B), pos // bs] = np.arange(1, B + 1)
    y = torch.randn(B, D, generator=gen, device="cuda").bfloat16()
    w = [(torch.randn(D, n * Dh, generator=gen, device="cuda") * D ** -0.5).bfloat16()
         for n in (H, KV, KV)]
    pool = [torch.randn(B + 1, KV, bs, Dh, generator=gen, device="cuda").bfloat16()
            for _ in range(2)]
    cos_t, sin_t = rope_table(W * bs, Dh, 500000.0, device="cuda")
    pt = torch.from_numpy(pos).cuda()
    cos, sin = cos_t[pt.long()].contiguous(), sin_t[pt.long()].contiguous()
    tt = torch.from_numpy(table).cuda()
    kp, pp = [p.clone() for p in pool], [p.clone() for p in pool]
    args = (cos, sin)
    got = fused_qkv_rope(y, *w, *args, *kp, tt, pt, n_heads=H, kv_heads=KV)
    want = fused_qkv_rope_reference(y, *w, *args, *pp, tt, pt, n_heads=H, kv_heads=KV)
    torch.cuda.synchronize()
    checks = [paged_close(g, wt) for g, wt in zip(got, want)]
    tol_ok = all(ok for _, ok in checks)
    err = max(e.max().item() for e, _ in checks)
    appended = torch.zeros(pool[0].shape[:3], dtype=torch.bool, device="cuda")
    rows = (torch.arange(1, B + 1, device="cuda"), slice(None), pt.long() % bs)
    appended[rows] = True
    pool_ok = all(torch.equal(k_[~appended], p_[~appended]) and torch.equal(k_[rows], new)
                  for k_, p_, new in zip(kp, pool, got[1:]))
    # a plain version that misplaces the rotation (no RoPE on k) must fail
    bites = _bites(got[1], (y.float() @ w[1].float()).reshape(B, KV, Dh).bfloat16())
    wqkv = torch.cat(w, dim=1)
    n_out = (H + 2 * KV) * Dh
    nbytes = D * n_out * 2 + B * D * 2 + B * n_out * 2 + B * 2 * KV * Dh * 2 + 2 * B * Dh * 4 \
        + table.size * 4 + B * 4
    b_ms, b_by = bound(nbytes, 2.0 * B * D * n_out)
    run = lambda: fused_qkv_rope(y, *w, *args, *kp, tt, pt, n_heads=H, kv_heads=KV)
    plain = lambda: fused_qkv_rope_reference(y, *w, *args, *pp, tt, pt, n_heads=H, kv_heads=KV)
    row = dict(shape=dict(B=B, D=D, H=H, KV=KV, Dh=Dh, bs=bs, pos=pos.tolist()),
               max_abs_err=err, tolerance=PAGED_TOL + " per head row", within=tol_ok,
               pool_rows_exact=pool_ok, tolerance_bites=bites,
               ms=time_cold(run), host_us=host_us(run), plain_ms=time_cold(plain),
               library_ms=time_cold(lambda: y @ wqkv),
               library="torch.matmul(y, [wq|wk|wv]) (projection only)",
               bound_ms=b_ms, bound_by=b_by)
    _check(tol_ok and pool_ok, f"fused QKV kernel disagrees with its plain version at B={B}: "
           f"max abs err {err}, pool rows exact {pool_ok}")
    _check(bites, "the fused QKV tolerance does not catch a plain version without RoPE")
    return row


def check_fused_mlp(gen, B):
    """B6 at Llama-3-8B widths, the engine's call: resid and y_src are the
    same rows. A plain version without one 64-row tile of F must fail the
    tolerance."""
    import torch
    import torch.nn.functional as F

    from shuffle_exchange_tpu_torch.ops.fused_decode import fused_mlp, fused_mlp_reference

    D, Fd = LLAMA_WIDTHS["D"], LLAMA_WIDTHS["F"]
    h = torch.randn(B, D, generator=gen, device="cuda").bfloat16()
    ln_w = (1 + 0.1 * torch.randn(D, generator=gen, device="cuda")).bfloat16()
    wg, wu = [(torch.randn(D, Fd, generator=gen, device="cuda") * D ** -0.5).bfloat16()
              for _ in range(2)]
    wd = (torch.randn(Fd, D, generator=gen, device="cuda") * Fd ** -0.5).bfloat16()
    got = fused_mlp(h, h, ln_w, wu, wd, wg, eps=1e-5)
    want = fused_mlp_reference(h, h, ln_w, wu, wd, wg, eps=1e-5)
    err, tol_ok = paged_close(got, want)
    wd_cut = wd.clone()
    wd_cut[:64] = 0
    bites = _bites(got, fused_mlp_reference(h, h, ln_w, wu, wd_cut, wg, eps=1e-5))
    del wd_cut

    def cublas_sequence():
        yn = F.rms_norm(h, (D,), ln_w, 1e-5)
        return h + (F.silu(yn @ wg) * (yn @ wu)) @ wd

    nbytes = 3 * D * Fd * 2 + 2 * B * D * 2 + D * 2
    b_ms, b_by = bound(nbytes, 2.0 * B * D * Fd * 3)
    row = dict(shape=dict(B=B, D=D, F=Fd), max_abs_err=err.max().item(),
               max_rel_err=(err.max() / want.float().abs().max()).item(),
               tolerance=PAGED_TOL + " per row", within=tol_ok, tolerance_bites=bites,
               ms=time_cold(lambda: fused_mlp(h, h, ln_w, wu, wd, wg, eps=1e-5)),
               host_us=host_us(lambda: fused_mlp(h, h, ln_w, wu, wd, wg, eps=1e-5)),
               cublas_sequence_host_us=host_us(cublas_sequence),
               plain_ms=time_cold(lambda: fused_mlp_reference(h, h, ln_w, wu, wd, wg, eps=1e-5)),
               library_ms=None, cublas_sequence_ms=time_cold(cublas_sequence),
               bound_ms=b_ms, bound_by=b_by)
    _check(tol_ok, f"fused MLP kernel disagrees with its plain version at B={B}: "
           f"max abs err {row['max_abs_err']}")
    _check(bites, "the fused MLP tolerance does not catch a plain version missing one F tile")
    return row


def check_fused_decode(case):
    """B5 at B2's decode inputs, with the split count the wrapper picks for
    the card. A plain version that drops the last split of the longest
    sequence must fail the tolerance."""
    import torch
    import torch.nn.functional as F

    from shuffle_exchange_tpu_torch.ops.fused_decode import (attention_splits,
                                                             fused_paged_decode_attention,
                                                             fused_paged_decode_reference,
                                                             split_count)

    q, ck, cv, table, lens = case
    B, _, H, Dh = q.shape
    KV, bs, W = ck.shape[1], ck.shape[2], table.shape[1]
    splits = attention_splits(B, KV, W, torch.cuda.get_device_properties(0).multi_processor_count)
    kvl = torch.from_numpy(lens).cuda()
    got = fused_paged_decode_attention(q, ck, cv, table, kvl)
    want = fused_paged_decode_reference(q, ck, cv, table, kvl, splits)
    err, tol_ok = paged_close(got, want)
    spb = split_count(W, splits)[1]
    cut = lens.copy()
    cut[0] -= spb * bs       # lens[0] = 1024 fills the table: its last split goes
    bites = _bites(got[:1], fused_paged_decode_reference(
        q, ck, cv, table, torch.from_numpy(cut).cuda(), splits)[:1])
    qs, ks, vs, mask = _sdpa_inputs(q, ck, cv, table, lens[:, None])
    lib = lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask, enable_gqa=True)
    b_ms, b_by = _decode_bound(q, ck, table, lens)
    row = dict(shape=dict(B=B, H=H, KV=KV, Dh=Dh, bs=bs, kv_len=lens.tolist(),
                          kv_len_total=int(lens.sum()), table_width=W, splits=splits),
               max_abs_err=err.max().item(),
               max_rel_err=(err.max() / want.float().abs().max()).item(),
               tolerance=PAGED_TOL, within=tol_ok, tolerance_bites=bites,
               ms=time_cold(lambda: fused_paged_decode_attention(q, ck, cv, table, kvl)),
               host_us=host_us(lambda: fused_paged_decode_attention(q, ck, cv, table, kvl)),
               plain_ms=time_cold(lambda: fused_paged_decode_reference(q, ck, cv, table, kvl,
                                                                       splits)),
               library_ms=time_cold(lib), bound_ms=b_ms, bound_by=b_by)
    _check(tol_ok, f"split-K decode kernel disagrees with its plain version: "
           f"max abs err {row['max_abs_err']}")
    _check(bites, "the split-K tolerance does not catch a plain version missing one split")
    return row


def check_fused_decode_sweep(gen, rng):
    """B5 for correctness at the SWEEP head layouts: kv_len 1 and block
    edges, -1-padded tables, split counts 1, 2, 3, the table width and the
    wrapper's own; and a head layout it refuses."""
    import torch

    from shuffle_exchange_tpu_torch.ops.fused_decode import (attention_splits,
                                                             fused_paged_decode_attention,
                                                             fused_paged_decode_reference)

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    worst = 0.0
    for H, KV, Dh, bs in SWEEP:
        lens = np.asarray([1, bs, bs + 1, 3 * bs - 5, 200], np.int32)
        ck, cv, table = _paged_inputs(gen, rng, lens, H, KV, Dh, bs, pad=-1)
        q = torch.randn(len(lens), 1, H, Dh, generator=gen, device="cuda").bfloat16()
        kvl = torch.from_numpy(lens).cuda()
        W = table.shape[1]
        for n in (1, 2, 3, W, None):
            splits = attention_splits(len(lens), KV, W, sms) if n is None else n
            err, ok = paged_close(fused_paged_decode_attention(q, ck, cv, table, kvl, num_splits=n),
                                  fused_paged_decode_reference(q, ck, cv, table, kvl, splits))
            _check(ok, f"split-K decode kernel disagrees at H={H} KV={KV} Dh={Dh} bs={bs} "
                   f"splits={n}: {err.max().item()}")
            worst = max(worst, err.max().item())
    q = torch.zeros(1, 1, 64, 128, device="cuda", dtype=torch.bfloat16)
    pool = torch.zeros(2, 4, 16, 128, device="cuda", dtype=torch.bfloat16)
    one = torch.ones(1, dtype=torch.int32, device="cuda")
    refused = None
    try:
        fused_paged_decode_attention(q, pool, pool, one[:, None], one)
    except ValueError as e:   # G * Dh = 2048 is past what the kernel holds
        refused = str(e)
    _check(refused is not None, "the split-K decode kernel accepted G * Dh = 2048")
    torch.cuda.synchronize()
    return {"fused_decode": worst, "refused": refused}


# ---------------------------------------------------------------------------
# Phase 3: serve Llama-3-8B through the scheduler
# ---------------------------------------------------------------------------

SERVE_CONFIG = dict(dtype="bfloat16", max_seq_len=2048, kv_block_size=64, num_kv_blocks=160,
                    decode_kernel="auto", serving={"token_budget": 256, "max_running": 8})
XLA_CONFIG = dict(SERVE_CONFIG, decode_kernel="xla")
N_PROMPTS, MAX_NEW = 8, 32


def serve(model, params, rng, device=None, config=SERVE_CONFIG, n_prompts=N_PROMPTS,
          max_new=MAX_NEW, prompt_range=(128, 1024)):
    """One serve of ``n_prompts`` random prompts through the scheduler.
    Returns (tokens by uid, scheduler, engine, host seconds of each tick by
    program); every tick's logits are checked finite and of the expected
    shape on the way."""
    from shuffle_exchange_tpu_torch.inference import (ContinuousBatchingScheduler,
                                                      InferenceConfig, InferenceEngineV2)

    V = model.config.vocab_size
    eng = InferenceEngineV2(model, params, InferenceConfig(**config), device=device)
    step = eng.step
    tick_s = {"decode": [], "extend": [], "mixed": []}

    def checked_step(decode_uids, decode_tokens, prefills=()):
        t0 = time.perf_counter()
        dl, pl = step(decode_uids, decode_tokens, prefills)   # returns host arrays: synced
        kind = "mixed" if decode_uids and prefills else "decode" if decode_uids else "extend"
        tick_s[kind].append(time.perf_counter() - t0)
        _check(dl.shape == (len(decode_uids), V) and pl.shape == (len(prefills), V),
               f"logits shapes {dl.shape} / {pl.shape}")
        _check(np.isfinite(dl).all() and np.isfinite(pl).all(), "non-finite logits")
        return dl, pl

    eng.step = checked_step
    sched = ContinuousBatchingScheduler(eng)
    lo, hi = prompt_range
    prompts = [rng.integers(1, V, size=int(n)).tolist()
               for n in rng.integers(lo, hi + 1, size=n_prompts)]
    out = sched.serve(prompts, max_new_tokens=max_new)
    return out, sched, eng, tick_s


def _kernel_kind(name: str) -> str:
    low = name.lower()
    for key, kind in (("gemv_partial_kernel", "fused_gemv (qkv + mlp products)"),
                      ("qkv_epilogue_kernel", "fused_qkv_rope"),
                      ("split_decode_kernel", "fused_paged_decode_attention"),
                      ("split_merge_kernel", "fused_paged_decode_attention"),
                      ("norm_rows_kernel", "fused_mlp (norm, epilogues)"),
                      ("swiglu_epilogue_kernel", "fused_mlp (norm, epilogues)"),
                      ("residual_epilogue_kernel", "fused_mlp (norm, epilogues)"),
                      ("paged_decode_kernel", "paged_decode_attention"),
                      ("paged_extend_kernel", "paged_extend_attention"),
                      ("rmsnorm_kernel", "rmsnorm")):
        if key in low:
            return kind
    if any(k in low for k in ("gemm", "gemv", "nvjet", "cutlass", "xmma", "cublas")):
        return "matmul"
    if "memcpy" in low or "memset" in low:
        return "copy"
    return "other"


def trace_serve(model, params, rng, config=SERVE_CONFIG):
    """Device time by kernel kind over a short profiled serve (4 requests
    of 128-512 prompt tokens, 8 new tokens each), against the wall time of
    the window. The profiler's own host overhead lengthens the window, so
    the idle share it gives is an upper bound."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, sched, _, _ = serve(model, params, rng, config=config, n_prompts=4, max_new=8,
                               prompt_range=(128, 512))
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans, by_kind = [], {}
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        start, end = ev.time_range.start, ev.time_range.end
        spans.append((start, end))
        kind = by_kind.setdefault(_kernel_kind(ev.name), {"us": 0.0, "count": 0})
        kind["us"] += end - start
        kind["count"] += 1
    if not spans:
        return None
    busy, last = 0.0, -math.inf
    for start, end in sorted(spans):           # union of the device intervals
        if end > last:
            busy += end - max(start, last)
            last = end
    return {"ticks": sched.ticks, "wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
            "idle_share": 1 - busy / wall_us,
            "by_kind_ms": {k: v["us"] / 1e3 for k, v in sorted(by_kind.items())},
            "kernels_by_kind": {k: v["count"] for k, v in sorted(by_kind.items())}}


def expected_launches(eng, n_layers):
    """Launches per kernel that the engine's programs imply. Chunk rows
    norm every layer twice and the final rows once, and run the extend
    kernel in every layer. Decode rows, fused: ln1 in every layer and the
    final norm, and each fused kernel once a layer; else like chunk rows,
    with the paged decode kernel. The mixed program runs both row sets."""
    by = eng.dispatches_by_program
    L = n_layers
    dec = by.get("decode", 0) + by.get("mixed", 0)
    ext = by.get("extend", 0) + by.get("mixed", 0)
    fused = eng._decode_kernel == "pallas"
    out = {"rmsnorm": (2 * L + 1) * ext + (L + 1 if fused else 2 * L + 1) * dec,
           "paged_decode_attention": 0 if fused else L * dec,
           "paged_extend_attention": L * ext}
    for name in ("fused_qkv_rope", "fused_paged_decode_attention", "fused_mlp"):
        out[name] = L * dec if fused else 0
    return out


def counted_serve(model, params, rng, config, n_layers, card):
    """One serve with every launch counter zeroed just before and read
    just after; the counts must equal what the programs imply."""
    import torch

    from shuffle_exchange_tpu_torch import ops

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out, sched, eng, tick_s = serve(model, params, rng, config=config)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = ops.launch_counts()
    stats = sched.stats()
    _check(len(out) == N_PROMPTS and all(len(t) == MAX_NEW for t in out.values()),
           f"requests did not all finish with {MAX_NEW} tokens: "
           f"{ {u: len(t) for u, t in out.items()} }")
    _check(all(0 <= t < model.config.vocab_size for ts in out.values() for t in ts),
           "token out of range")
    _check(eng.dispatch_count == sched.ticks,
           f"dispatch_count {eng.dispatch_count} != ticks {sched.ticks}")
    want = expected_launches(eng, n_layers)
    _check(launches == want, f"launch counts {launches} != implied by the programs {want}")
    tick_ms = {k: dict(n=len(v), p50=float(np.percentile(v, 50)) * 1e3,
                       p90=float(np.percentile(v, 90)) * 1e3) for k, v in tick_s.items() if v}
    label = config["decode_kernel"]
    print(f"[serve {label}] resolved {eng._decode_kernel}: {N_PROMPTS} requests x {MAX_NEW} "
          f"new tokens in {seconds:.2f} s: ticks={stats['ticks']} "
          f"programs={dict(eng.dispatches_by_program)} preemptions={stats['preemptions']} "
          f"tok/s={stats['sustained_tokens_per_sec']} ttft_p50_s={stats['ttft_p50_s']} "
          f"tpot_p50_s={stats['tpot_p50_s']} launches={launches} "
          f"peak_mem_GiB={torch.cuda.max_memory_allocated() / 2**30:.2f} on {card}", flush=True)
    print(f"[serve {label}] host ms per tick by program: {json.dumps(tick_ms)}", flush=True)
    return dict(stats, seconds=seconds, launches=launches, resolved=eng._decode_kernel,
                programs=dict(eng.dispatches_by_program), tick_ms=tick_ms, tokens=out)


# ---------------------------------------------------------------------------
# Phase 4: depth 2 on the card against the CPU plain path in f32
# ---------------------------------------------------------------------------

# bf16 keeps 8 significant bits; two layers and the head in bf16 leave
# about 1% of the largest logit as error against f32 (1.1-1.2% in CPU
# rehearsals at widths 1024 and 2048). The tolerance is 3% of the tick's
# largest |logit|.
E2E_REL_TOL = 0.03


def e2e_schedule(rng, V):
    p = [rng.integers(1, V, size=n).tolist() for n in (300, 180, 90, 40)]
    t = rng.integers(1, V, size=32).tolist()
    return [
        ([], [], [(0, p[0][:200]), (1, p[1][:56])]),                 # extend only
        ([], [], [(0, p[0][200:]), (1, p[1][56:]), (2, p[2][:40])]),
        ([0, 1], t[0:2], [(2, p[2][40:])]),                          # mixed
        ([0, 1, 2], t[2:5], []),                                     # decode only
        ([0, 1, 2], t[5:8], []),
        ([0, 2], t[8:10], [(3, p[3])]),                              # mixed, new uid
        ([0, 1, 2, 3], t[10:14], []),
    ]


def e2e_check(cfg, card_state, rng, card_device="cuda", decode_kernel="auto"):
    """Run the schedule on a bf16 engine on the card (``decode_kernel`` as
    given) and an f32 engine on the CPU ("xla": the paged plain versions)
    built from the same weights; returns per-tick errors."""
    from shuffle_exchange_tpu_torch.inference import InferenceConfig, InferenceEngineV2
    from shuffle_exchange_tpu_torch.models import Transformer

    icfg = dict(max_seq_len=512, kv_block_size=64, num_kv_blocks=24,
                serving={"token_budget": 256, "max_running": 8})
    card = InferenceEngineV2(Transformer(cfg, device=card_device), card_state,
                             InferenceConfig(dtype="bfloat16", decode_kernel=decode_kernel,
                                             **icfg), device=card_device)
    if decode_kernel == "auto" and card_device == "cuda":
        _check(card._decode_kernel == "pallas", "decode_kernel auto did not resolve to the "
               "fused kernels on the card")
    cpu_state = {k: v.detach().float().cpu() for k, v in card_state.items()}
    host = InferenceEngineV2(Transformer(cfg, device="cpu"), cpu_state,
                             InferenceConfig(dtype="float32", decode_kernel="xla", **icfg),
                             device="cpu")
    ticks = []
    for tick in e2e_schedule(rng, cfg.vocab_size):
        got = card.step(*tick)
        want = host.step(*tick)
        g = np.concatenate([a for a in got if a.size])
        w = np.concatenate([a for a in want if a.size])
        _check(np.isfinite(g).all(), "non-finite logits on the card")
        err = np.abs(g - w)
        ticks.append(dict(rows=int(g.shape[0]), max_abs_err=float(err.max()),
                          ref_abs_max=float(np.abs(w).max()),
                          within=bool(err.max() <= E2E_REL_TOL * np.abs(w).max()),
                          argmax_agree=float(np.mean(g.argmax(-1) == w.argmax(-1)))))
    return ticks


# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="also write the results as JSON here")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from shuffle_exchange_tpu_torch import ops
    from shuffle_exchange_tpu_torch.models import Transformer, llama3_8b
    from shuffle_exchange_tpu_torch.ops import _build

    t_start = time.perf_counter()
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    # 1. build: one nvcc per source, all at once
    t0 = time.perf_counter()
    libs = _build.build_all(["paged_attention", "fused_decode"])
    nvcc_s = time.perf_counter() - t0
    for stem, lib in libs.items():
        print(f"[build] nvcc {stem}.cu -> {lib.name}")
        print(lib.with_suffix(".log").read_text().strip())
    print(f"[build] both sources in {nvcc_s:.2f} s", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    t0 = time.perf_counter()
    x = torch.randn(8, 4096, generator=gen, device="cuda").bfloat16()
    ops.rmsnorm(x, torch.ones(4096, device="cuda", dtype=torch.bfloat16))
    torch.cuda.synchronize()
    print(f"[build] triton rmsnorm first launch (compile): {time.perf_counter() - t0:.2f} s",
          flush=True)

    # 2. kernels against their plain versions
    rng = np.random.default_rng(args.seed)
    rms = check_rmsnorm(gen)
    case = decode_case(gen, rng)
    dec = check_paged_decode(case)
    ext = check_paged_extend(gen, rng)
    sweep = check_paged_sweep(gen, rng)
    print(f"[kernel] paged sweep {SWEEP}: {json.dumps(sweep)}", flush=True)
    fused_rng = np.random.default_rng([args.seed, 3])
    qkv = [check_fused_qkv(gen, fused_rng, B) for B in (8, 1)]
    fdec = check_fused_decode(case)
    mlp = [check_fused_mlp(gen, B) for B in (8, 1)]
    fsweep = check_fused_decode_sweep(gen, fused_rng)
    print(f"[kernel] split-K decode sweep {SWEEP}: {json.dumps(fsweep)}", flush=True)
    del case
    checked = {"rmsnorm": rms, "paged_decode_attention": [dec], "paged_extend_attention": [ext],
               "fused_qkv_rope": qkv, "fused_paged_decode_attention": [fdec],
               "fused_mlp": mlp}
    for name, rows in checked.items():
        for r in rows:
            extra = {k: r[k] for k in ("tolerance_bites", "pool_rows_exact",
                                       "cublas_sequence_ms", "cublas_sequence_host_us",
                                       "library") if k in r}
            print(f"[kernel] {name} {json.dumps(r['shape'])}: max_abs_err={r['max_abs_err']} "
                  f"(tol {r['tolerance']}) kernel_ms={r['ms']} host_us={r['host_us']} "
                  f"plain_ms={r['plain_ms']} "
                  f"library_ms={r['library_ms']} bound_ms={r['bound_ms']} ({r['bound_by']}) "
                  f"{json.dumps(extra)} on {card}", flush=True)

    # 3. serve Llama-3-8B at full width and depth: "auto" (the fused
    # kernels on the card), then "xla" (the paged decode kernel)
    cfg = llama3_8b()
    t0 = time.perf_counter()
    model = Transformer(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(args.seed),
                        dtype=torch.bfloat16)
    torch.cuda.synchronize()
    print(f"[serve] init {cfg.n_layers}-layer Llama-3-8B in bf16: "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    # each phase draws from its own stream, so a change to one phase's
    # draws leaves the others' inputs as they were; both serves get the
    # same prompts
    serves = {}
    for label, config in (("auto", SERVE_CONFIG), ("xla", XLA_CONFIG)):
        serves[label] = counted_serve(model, params, np.random.default_rng([args.seed, 1]),
                                      config, cfg.n_layers, card)
    _check(serves["auto"]["resolved"] == "pallas",
           "decode_kernel auto did not resolve to the fused kernels on the card")
    same = sum(serves["auto"]["tokens"][u] == serves["xla"]["tokens"][u]
               for u in serves["auto"]["tokens"])
    print(f"[serve] requests with equal tokens on both paths (bf16, greedy): {same} of "
          f"{N_PROMPTS}", flush=True)
    launches = {k: serves["auto"]["launches"][k] + serves["xla"]["launches"][k]
                for k in ops.KERNEL_WRAPPERS}
    _check(all(n > 0 for n in launches.values()), f"a kernel never launched: {launches}")

    # 3b. where the device time goes: a short profiled serve on each path
    traces = {}
    for label, config in (("auto", SERVE_CONFIG), ("xla", XLA_CONFIG)):
        traces[label] = trace_serve(model, params, np.random.default_rng([args.seed, 4]), config)
        print(f"[trace {label}] "
              f"{json.dumps(traces[label]) if traces[label] else 'no device kernels recorded'}",
              flush=True)

    # 4. depth 2 on the card, fused and not, against the CPU f32 plain path
    cfg2 = dataclasses.replace(cfg, n_layers=2)
    state2 = {k: (v[:2] if k.startswith("layers.") else v) for k, v in params.items()}
    e2e = {}
    for dk in ("auto", "xla"):
        t0 = time.perf_counter()
        e2e[dk] = e2e_check(cfg2, state2, np.random.default_rng([args.seed, 2]), decode_kernel=dk)
        for i, t in enumerate(e2e[dk]):
            print(f"[e2e {dk}] tick {i}: rows={t['rows']} max_abs_err={t['max_abs_err']} "
                  f"(tol {E2E_REL_TOL} x |ref| max {t['ref_abs_max']}) "
                  f"argmax_agree={t['argmax_agree']}")
        _check(all(t["within"] for t in e2e[dk]), f"depth-2 logits on the card ({dk}) "
               "disagree with the CPU f32 plain path")
        print(f"[e2e {dk}] {len(e2e[dk])} ticks in {time.perf_counter() - t0:.2f} s", flush=True)

    replaces = {"rmsnorm": "shuffle_exchange_tpu/ops/rmsnorm.py:87",
                "paged_decode_attention": "shuffle_exchange_tpu/ops/paged_attention.py:39",
                "paged_extend_attention": "shuffle_exchange_tpu/ops/paged_attention.py:216",
                "fused_qkv_rope": "shuffle_exchange_tpu/ops/fused_decode.py:130",
                "fused_paged_decode_attention": "shuffle_exchange_tpu/ops/fused_decode.py:324",
                "fused_mlp": "shuffle_exchange_tpu/ops/fused_decode.py:536"}
    paged_cu = "shuffle_exchange_tpu_torch/ops/csrc/paged_attention.cu"
    fused_cu = "shuffle_exchange_tpu_torch/ops/csrc/fused_decode.cu"
    sources = {"rmsnorm": ("triton", "shuffle_exchange_tpu_torch/ops/rmsnorm_triton.py"),
               "paged_decode_attention": ("cuda", paged_cu),
               "paged_extend_attention": ("cuda", paged_cu),
               "fused_qkv_rope": ("cuda", fused_cu),
               "fused_paged_decode_attention": ("cuda", fused_cu),
               "fused_mlp": ("cuda", fused_cu)}
    kernels = []
    for name, rows in checked.items():
        route, source = sources[name]
        m = rows[0]           # timed at the first (largest) shape
        kernels.append({"name": name, "route": route, "source": source,
                        "replaces": replaces[name], "launches": launches[name],
                        "max_abs_err": max(r["max_abs_err"] for r in rows),
                        "ms": m["ms"], "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
                        "bound_by": m["bound_by"], "library_ms": m["library_ms"]})
    for s_ in serves.values():
        s_["tokens"] = {int(u): t for u, t in s_["tokens"].items()}
    result = {"card": card, "seconds": time.perf_counter() - t_start,
              "build": {"nvcc_s": nvcc_s}, "kernels": kernels,
              "kernel_checks": dict(checked, paged_sweep=sweep, fused_decode_sweep=fsweep),
              "serve": serves, "trace": traces, "e2e": e2e}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(f"total {result['seconds']:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
