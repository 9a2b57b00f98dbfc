"""Smoke run of the PyTorch port (``shuffle_exchange_tpu_torch``) on one
NVIDIA H100.

Run from the repository root, with one CUDA card:

    python3 chip_smoke.py [--seed N] [--out result.json]

It never imports JAX or the JAX package, and every failure ends it with a
non-zero exit code. The phases:

1. Build: ``nvcc`` compiles the eight CUDA sources (paged attention, the
   fused decode layer, flash attention, fused AdamW, the quantized matmul,
   the grouped GEMM, the LoRA delta and ALiBi flash attention) into
   ``build/`` at once, one process each, and the Triton RMSNorm kernel compiles at its first
   launch.
2. Kernels: each kernel and its plain PyTorch version run in bf16 on the
   card at the shapes the serving and training paths give it (RMSNorm at
   both); the errors are held to stated
   tolerances (shown once to catch a deliberately broken plain version)
   and each is timed beside its bound (the least time the card could
   take for the same work) and one PyTorch library call that computes the
   same function, as a yardstick only; the host's cost of issuing one
   call of each wrapper is timed too. Phase 2c does this for the flash
   attention kernel (the prefill's) and the fused QKV kernel without a
   pool (the v1 engine's form), phase 2d for the training kernels: the
   flash forward's out and log-sum-exp at the training shapes, the flash
   backward and fused AdamW, phase 2e for the quantized serving kernels:
   the quantized matmul for int8, int4 and fp8 storage on Llama-3-8B's
   matrices from 1 to 8192 rows (the split-K GEMV to 8 rows, the wgmma
   kernel past them, its 256-row cells timed on all four matrices), and
   the quantized fused MLP at 1, 8, 9 and 16 rows (its tensor-core GEMV
   takes 16 rows a pass), phase 2f
   for the MoE experts' grouped GEMM: bf16, int8 and fp8 stacks of 8
   experts on Mixtral's two expert shapes, 2 to 16,384 rows in four
   group patterns (balanced, one expert, empty first and last experts,
   ragged; 16 rows or fewer on the tensor-core GEMV), phase 2g for the LoRA delta of multi-tenant serving:
   Llama-3-8B's projections (N 4096 and 1024) at ranks 8, 16 and 64 over
   pools of 5 and 65 slots, from one decode row to a put() of 8 x 1024
   rows, with null rows, equal bits twice, each row of a mixed call
   bit-equal to the row alone and a plain version that rounds mid to bf16
   failing, phase 2h for the grouped GEMM's backward
   (B16-dx and B16-dw) at bench.py's _config3 expert shapes in both
   directions (65,472 ragged rows in the four patterns and with rows past
   the groups' sum; 8 x 10,230 capacity rows) and Mixtral's at 16,384
   rows, with equal bits twice, phase 2i for the ALiBi flash kernels (B11
   forward + lse, B12 dq, B13 dk/dv + dslope: the ALiBi instances of the
   wgmma flash kernels) at BLOOM-1b7's training
   shape (timed at its batch of 16), on block boundaries, at T < S (the
   bottom-right diagonal), GQA and head dim 64, on a generator of its own:
   tolerances shown to catch flipped slopes, a top-left diagonal and a zero
   dslope in every head the draw resolves,
   equal bits twice, SDPA with a materialised bias mask as the yardstick,
   phase 2j for the serving kernels' ALiBi and bias forms (BLOOM and GPT-2
   serving): B2, B3 and B5 with slopes at BLOOM-1b7's heads (16 x 128),
   GPT-2's (12 x 64) and a GQA layout, kv_len up to 2,048, pools in
   shuffled block order, B5 at 1, 2, 4 and its own split count; B4 with
   q/k/v biases and no RoPE at both widths, with and without a pool; B6 with
   layernorm, fc biases and the plain MLP for gelu_new (BLOOM's),
   gelu_pytorch_tanh, relu and silu, and the gated form under layernorm:
   tolerances shown to catch flipped slopes, the neighbouring head's
   slopes, zero slopes, the bias formed in bf16, dropped biases and RMSNorm
   in place of layernorm; phase 2k for the KV scale-plane forms of B2, B3
   and B5 (int8 / fp8 KV serving): int8 and e4m3 pools with their f32
   scale planes at Llama-3-8B's heads and BLOOM-1b7's (with its slopes),
   kv_len up to 2,048, pools in shuffled block order, B5 at 1, 2, 4 and its
   own split count, timed against the bound at 1 byte an element plus 4 a
   row, the same kernel over the bf16 pool and dequantize + SDPA:
   tolerances shown to catch dropped scales, swapped K and V scale planes,
   scales rolled within a block, int8 read unsigned and e4m3 read as e5m2;
   phase 2l for B15 with an element mask (splash's ``mask_np``, reached
   through ``sparse_attention``): forward, dq and dk/dv on the Fixed and
   BigBird layouts at T = S = 8,192 (16/4 heads of 128, causal) and a
   layout with fully masked query rows (exactly 0 in out and dq), timed
   beside the bound on the allowed pairs' operations, SDPA with the
   boolean mask and B15 unmasked-causal; tolerances shown to catch the
   mask transposed, the causal AND dropped, a tile map of a shifted layout
   and a plain version without the zero-row rule; ``impl="dense"`` must
   raise on a CUDA tensor; then one user call of ``sparse_attention``
   (forward and backward) must launch the mask form once each; phase 2m
   for the quantized fused MLP's (B7's) forms: RMSNorm or layernorm with
   its bias, gated or plain, silu, relu, gelu_new or gelu_pytorch_tanh,
   int8, int4 or fp8, at Llama-3-8B's, BLOOM-1b7's and GPT-2's widths, 1
   and 8 rows, over cells in which every value of each axis meets every
   value of each other axis: tolerances shown to catch a dropped layernorm
   bias, the gate read on the plain form, gelu_new computed as relu,
   layernorm computed as RMSNorm and w_down's scale rows shifted, each
   cell timed beside its bytes bound and dequantize + the cuBLAS sequence;
   phase 2n for the parallel-block families' forms: B6 and B7 without
   their norm (``apply_norm=False``) at GPT-J-6B's widths (B7 int8, int4
   and fp8 without fc biases), B4 with partial rotary (rd 32 of 128) and
   biases at Pythia-1.4b's heads and a GQA layout, B2 / B3 / B5 at GPT-J's
   16 x 256 heads over bf16, int8 and fp8 pools, and the flash forward at
   head_dim 256; tolerances shown to catch the norm applied anyway, ``ln_b``
   read, y_src swapped for resid, the rotation over all of Dh, the partner
   at Dh/2, the pass-through columns rotated, the softmax scale of head_dim
   128, the neighbouring head and a shifted causal diagonal; phases 2o and
   2p for the wide query-head groups and the head dims 80 and 96; phase 2q
   for the flash backward at head_dim 256 (its dv and dk passes and the dq
   pass): GPT-J-6B's training shape (8 x 2048 and 2047, 16 heads), a GQA
   group of 4, segment ids, a full mask with T < S and the Fixed layout
   through a tile map, each timed beside its bound and SDPA's backward
   (its backend named), with a shifted diagonal and the softmax scale of
   head_dim 128 as bites, and one ``sparse_attention`` call at 256 under
   autograd.
3. Serve: ``ContinuousBatchingScheduler(InferenceEngineV2(...)).serve`` on
   Llama-3-8B at full width (SERVE_LAYERS layers) with random weights from a seeded
   generator on the card, twice: with ``decode_kernel: "auto"`` (which
   must resolve to the fused kernels) and with ``"xla"`` (the paged
   decode kernel). 3b: one ``put()`` of 8 prompts (one batched prefill
   program through the flash kernel), then ``decode_loop`` of 31 steps,
   whose tokens must equal 31 single-token ``put()`` calls. 3c: the v1
   ``init_inference(...).generate`` on the same prompts. Each run's
   launch counters, zeroed just before it and read just after, must
   equal what the engine's programs imply. Short profiled runs show where
   the device time goes. 3d: weight-quantized serving, a serve for each of
   int8, int4 and fp8 (``quantize_weights``; the engine quantizes the bf16
   weights on the card), then int8 ``put()`` + ``decode_loop`` and the int8
   v1 ``generate``, their launch counters held the same way, and the weight
   bytes against bf16. 3f: multi-tenant LoRA serving on the same weights
   (``bench.py``'s multi-tenant row: a pool of 4 slots of rank 8 over wq
   and wv, 64 tenants, 24 requests served closed-loop, striped over 1, 8
   and 64 adapters): tok/s, TTFT, TPOT, pool hits, evictions and parks,
   no preemption, no new program shape once a stripe is warm, the launch
   counters held the same way; ``put()`` under 8 adapters +
   ``decode_loop`` against the single-token ``put()`` loop, and a
   profiled decode window. 3h: ``kv_cache_dtype`` int8 and fp8 on the same
   weights: a serve under "auto" (B4 without a pool, the quantizing
   append, B5 over the scale planes) and one under "xla" (B2), ``put()`` +
   ``decode_loop`` against the single-token ``put()`` loop, the launch
   counters held the same way, the pool bytes of bf16, int8 and fp8 and a
   profiled int8 decode window.
3e. Mixtral-8x7B at full width, 16 of its 32 layers, on the same card, its
   experts and attention matrices in int8 storage made from a seed (23.9 GB;
   all 32 layers, 47.7 GB, ran until the time limit forced the cut): a serve
   with ``serving.moe.moe_impl`` "ragged" and one with "auto" (the
   capacity route), ``put()`` + ``decode_loop`` against the single-token
   ``put()`` loop and the v1 ``generate``, every engine over the one
   weight set, the launch counters held the same way (three grouped-GEMM
   launches a layer of every program) and a profiled serve. It runs after
   phase 4, once the Llama-3-8B weights are freed, and before training.
4. End to end: the same weights cut to depth 2 on the card (bf16), with
   "auto" and with "xla", and on the CPU (the plain path in f32) run a
   teacher-forced ``step()`` schedule, a ``put()`` schedule (a cold
   batched prefill, then single- and multi-token extensions) and the v1
   prefill and decode steps; all logits must agree within a stated
   tolerance. Then the ``step()`` and ``put()`` schedules of a quantized
   engine of each format against the CPU f32 engine fed the weights it
   serves, and of a bf16 and an int8 engine with adapters of rank 8 and 16
   on all four projections (and rows without one) against the CPU f32
   engine with the same factors. 4c: the ``step()`` schedule ("auto") and
   the ``put()`` schedule ("auto" and "xla") with int8 and with fp8 KV
   against the CPU f32 engine in the same KV mode (BLOOM-1b7's after its
   3g). After 3e: Mixtral cut to depth 2, int8
   and fp8, its ``step()`` and ``put()`` schedules against the CPU f32
   engine fed the card's weights dequantized and routed as the card
   routed; routing flips are reported with their router-logit gaps.
3g. BLOOM-1b7 (ALiBi, 24 layers, 1.72 B parameters, built by
   ``config_from_hf``) and GPT-2 125M (learned positions) at full width and
   depth, seeded weights made on the card, after 3e: a serve under "auto"
   (BLOOM: B4, B5 and B6 with the slopes and biases; GPT-2: B4 and B5, its
   exact-gelu MLP on the layer body) and under "xla" (B2 with the slopes),
   ``put()`` (B11 or B14 in the prefill) + ``decode_loop`` against the
   single-token ``put()`` loop, the v1 ``generate``, the launch counters held
   to the programs (no RMSNorm launch), a profiled ``put()`` (BLOOM's
   prefill: as many B11 launches by its kernel's name as its counter
   counts, a multiple of the layers) and decode window;
   BLOOM-1b7 then serves with int8 KV under "auto" and runs ``put()`` +
   ``decode_loop`` over it (slopes and scales in one kernel). 4b:
   each cut to depth 2, its ``step()``, ``put()`` and v1 schedules under
   "auto" and "xla" against the CPU f32 engine, as phase 4.
3i. On the same weights: BLOOM-1b7 with int8, int4 and fp8 weights and
   GPT-2 with int8 weights, each a serve under "auto" and "xla", ``put()``
   + ``decode_loop`` against the single-token ``put()`` loop and the v1
   ``generate``, the launch counters held to the programs (the quantized
   matmul on every matrix, the fused quantized MLP never: the fc biases
   keep the MLP on the layer body, as in JAX) and the weight bytes;
   BLOOM-1b7's widths without fc biases, int8, under "auto" (the fused
   quantized MLP in its layernorm + plain + gelu_new form once a layer and
   decode row); multi-tenant BLOOM-1b7 on a bf16 and an int8 base (3f's
   pool and tenants, 24 requests over 8 adapters, no preemption); and a
   profiled int8 decode window. 4d: BLOOM-1b7 int8 cut to depth 2 (and its
   widths without fc biases) against the CPU f32 engine, as phase 4.
3j. GPT-J-6B and Pythia-1.4b (``config_from_hf`` of their published
   configs) at full width (SERVE_LAYERS layers), seeded bf16 weights, as phase 3g runs
   BLOOM-1b7: both serve paths, ``put()`` + ``decode_loop`` against the
   single-token ``put()`` loop, the v1 ``generate`` and a profiled decode
   window, with a fused decode step's launches held exactly (GPT-J: per
   layer B5 and B6 without its norm, no B4; Pythia: B4 and B5, no B6) and
   the prefill's flash forward once a layer; then GPT-J's widths with
   ``mlp_bias=False``, int8, at depth 2 (B7 without its norm twice a
   decode row-step). 4e: each cut to depth 2 against the CPU f32 engine,
   as phase 4.
5. Train: ``initialize`` + ``Engine.train_batch`` on the largest entry of
   the Llama training ladder whose state fits the card (``llama3-1b-style``
   on 80 GB), full depth, bf16, FusedAdam, full remat, batch 32 x 1024, one
   seeded batch repeated: step p50, tokens/s, MFU, peak memory, a falling
   loss, launch counters equal to what the program implies, and one
   profiled step.
6. The training model cut to depth 2: the card's bf16 loss and every
   gradient leaf against a CPU f32 engine from the same weights, a 3-step
   loss trajectory, and a skipped step that must leave the state bit-equal.
5b. MoE training: bench.py's _config3 model (8 experts, top-2, 0.61 B
   parameters) at full width and depth under ``moe_impl`` "capacity" (the
   bench row) and "ragged", its training config (FusedAdam, bf16, ZeRO 2),
   batch 32 x 1024, full remat: step p50, tokens/s, MFU billed on the
   activated parameters, peak memory, a falling loss, the drop fraction,
   launch counters equal to what the program implies (the grouped GEMM
   twice a projection and layer under remat, its dx and dw once), one
   profiled step.
6b. The _config3 model cut to depth 2 as phase 6, the CPU f32 engine routed
   as the card routed (``TrainRoutingReplay``; flips reported with their
   router-logit gaps, and every remat recompute's routing bit-equal to its
   forward's on the card).
5c. ALiBi training: BLOOM-1b7 (1.72 B parameters, built by
   ``config_from_hf`` from its published config) at full width and depth
   under phase 5's config, batch 16 x 2048, full remat, 9 steps + 1
   profiled: the same metrics, the ALiBi kernels B11 (2L a step) and their
   backward (L) on the implied counts and, by kernel name, in the profiled
   step; no RMSNorm launch.
5d. GPT-2 125M under ``bench.py``'s ``_config1`` (AdamW, ZeRO 1, bf16, no
   remat), batch 16 x 1024: the same metrics, B14 on the MHA path.
6c. BLOOM-1b7 cut to depth 2 as phase 6, against the CPU f32 engine.
5e. GPT-J-6B (``config_from_hf`` of its published config: shared-layernorm
   parallel blocks, interleaved RoPE over 64 of 256 columns, an
   unembedding bias) at 14 of its 28 layers (3.23 B parameters; all 28 do
   not fit one card's optimizer state), batch 8 x 2048, phase 5's config,
   full remat, 9 steps + 1 profiled: the same metrics, and the flash
   backward at head_dim 256 once a layer and step. 5f. Pythia-1.4b whole
   (two layernorms, partial rotary) at 16 x 2048. 6d. Each cut to depth 2
   as phase 6, against the CPU f32 engine.

The second-to-last line of standard output is one JSON object with a row
per kernel; the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import math
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
BF16_FLOP_PER_S = 989e12       # H100 SXM dense bf16 tensor-core peak
F32_FLOP_PER_S = 67e12         # H100 SXM f32 outside the tensor cores
FLUSH_BYTES = 256 << 20        # written between timed launches: > the 50 MB L2
# the layers every served model keeps (at full width): its host-bound serving
# phases take time in proportion to its depth, and 4 keeps the whole script
# within 1,000 s on a slow host (with 8 it took 1,008.5 s on one H100
# machine; Llama-3-8B has 32 layers, Mixtral-8x7B 32, GPT-J-6B 28)
SERVE_LAYERS = 4


def _check(ok, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def card_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]


def bound(nbytes: float, flops: float, flop_rate: float = BF16_FLOP_PER_S):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / flop_rate
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def time_cold(fn, iters: int = 10, warm: int = 3) -> float:
    """Mean device ms of ``iters`` calls of ``fn`` with a cold L2: before
    each timed call the card writes FLUSH_BYTES and then idles for about a
    millisecond, so the host has enqueued the call before its start event
    is reached."""
    import torch

    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    for _ in range(warm):
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


def time_plain(fn) -> float:
    """Mean device ms of a plain version (the kernel's arithmetic in plain
    PyTorch, no yardstick of speed): 3 cold calls after one warm-up."""
    return time_cold(fn, 3, warm=1)


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


# the serving ticks' rows (a 256-token budget, 8 decode rows) at the 8B
# width, then what the training step gives the kernel: a layer's norm over
# 32 sequences of 1023 positions and one 256-position chunk of the loss
# head's final norm, at the training model's width
RMSNORM_SHAPES = [(256, 4096), (8, 4096), (32, 1023, 2048), (32, 256, 2048)]


def check_rmsnorm(gen):
    import torch
    import torch.nn.functional as F

    from shuffle_exchange_tpu_torch.ops.rmsnorm import rmsnorm, rmsnorm_reference

    rows_out = []
    for shape in RMSNORM_SHAPES:
        D, rows = shape[-1], int(np.prod(shape[:-1]))
        x = torch.randn(*shape, generator=gen, device="cuda").bfloat16()
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
            shape=list(shape), max_abs_err=err.max().item(),
            max_rel_err=(err.max() / want.abs().max()).item(), tolerance="2^-7*|plain| + 1e-3",
            within=tol_ok, library_max_abs_err=(lib - want).abs().max().item(),
            ms=time_cold(lambda: rmsnorm(x, w, 1e-5)),
            host_us=host_us(lambda: rmsnorm(x, w, 1e-5)),
            plain_ms=time_plain(lambda: rmsnorm_reference(x, w, 1e-5)),
            library_ms=time_cold(lambda: F.rms_norm(x, (D,), w, 1e-5)),
            bound_ms=b_ms, bound_by=b_by))
        _check(tol_ok, f"rmsnorm kernel disagrees with its plain version at {list(shape)}: "
               f"max abs err {rows_out[-1]['max_abs_err']}")
        del x, got, want, err, lib
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


def equal_bits_twice(run) -> bool:
    """Two launches of ``run`` on the same inputs give the same bits (no
    atomics in any sum: the kernels fix their summation order)."""
    import torch

    a, b = run(), run()
    return torch.equal(a.view(torch.int16), b.view(torch.int16))


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
    run = lambda: paged_decode_attention(q, ck, cv, table, kvl)
    plain = lambda qq: paged_decode_reference(qq, ck, cv, table, kvl, p_f32=True)
    got, want = run(), plain(q)
    err, tol_ok = paged_close(got, want)
    bites, twice = attention_bites(got, plain, q), equal_bits_twice(run)
    want = want.float()
    qs, ks, vs, mask = _sdpa_inputs(q, ck, cv, table, lens[:, None])
    lib = lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask, enable_gqa=True)
    lib_err = (lib().transpose(1, 2).float() - want).abs().max().item()
    total = int(lens.sum())
    b_ms, b_by = _decode_bound(q, ck, table, lens)
    row = dict(shape=dict(B=B, H=H, KV=KV, Dh=Dh, bs=bs, kv_len=lens.tolist(),
                          kv_len_total=total, table_width=int(table.shape[1])),
               max_abs_err=err.max().item(), max_rel_err=(err.max() / want.abs().max()).item(),
               tolerance=PAGED_TOL, within=tol_ok, tolerance_bites=bites,
               equal_bits_twice=twice, library_max_abs_err=lib_err,
               ms=time_cold(run), host_us=host_us(run),
               plain_ms=time_plain(lambda: paged_decode_reference(q, ck, cv, table, kvl)),
               library_ms=time_cold(lib), bound_ms=b_ms, bound_by=b_by)
    _check(tol_ok, f"paged decode kernel disagrees with its plain version: "
           f"max abs err {row['max_abs_err']}")
    _check(all(bites.values()), f"paged decode kernel: the tolerance misses {bites}")
    _check(twice, "paged decode kernel: two runs gave different bits")
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
    run = lambda: paged_extend_attention(q, ck, cv, table, st, nn)
    plain = lambda qq: paged_extend_reference(qq, ck, cv, table, st, nn, p_f32=True)
    got, want = run(), plain(q)
    # rows past nnew are padding the engine never reads (the plain version
    # caps them at start + nnew, the kernel keeps them causal)
    checks = [paged_close(got[b, :n], want[b, :n]) for b, n in enumerate(nnew)]
    err = torch.cat([e.flatten() for e, _ in checks])
    tol_ok = all(ok for _, ok in checks)
    pick = lambda x: torch.cat([x[b, :n].flatten() for b, n in enumerate(nnew)])
    bites, twice = attention_bites(got, plain, q, pick), equal_bits_twice(run)
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
               tolerance=PAGED_TOL + " (rows < nnew)", within=tol_ok, tolerance_bites=bites,
               equal_bits_twice=twice, library_max_abs_err=lib_err,
               ms=time_cold(run), host_us=host_us(run),
               plain_ms=time_plain(lambda: paged_extend_reference(q, ck, cv, table, st, nn)),
               library_ms=time_cold(lib), bound_ms=b_ms, bound_by=b_by)
    _check(tol_ok, f"paged extend kernel disagrees with its plain version: "
           f"max abs err {row['max_abs_err']}")
    _check(all(bites.values()), f"paged extend kernel: the tolerance misses {bites}")
    _check(twice, "paged extend kernel: two runs gave different bits")
    return row


# (H, KV, Dh, bs): GQA groups 1, 3, 4 and 8, both built head sizes, two
# block sizes
SWEEP = [(8, 8, 64, 16), (24, 8, 128, 64), (32, 8, 128, 16), (16, 2, 64, 64)]
# a group wider than one MMA row tile (16 query heads of 128 a kv head: the
# decode kernels' warps take whole row tiles), drawn from its own generator
# so the later phases' inputs stay as they were
WIDE_SWEEP = (64, 4, 128, 16)
# groups past one pass of the decode kernel's row tiles (64 query heads a
# pass at head_dim 128 and 256), each from its own generator too
PASS_SWEEP = [(72, 1, 128, 64), (65, 1, 256, 16)]


def _wide_sweep_case(rng_seed=2048, shape=WIDE_SWEEP):
    import torch

    H, KV, Dh, bs = shape
    gen = torch.Generator(device="cuda").manual_seed(rng_seed)
    lens = np.asarray([1, bs, bs + 1, 200, 75], np.int32)
    ck, cv, table = _paged_inputs(gen, np.random.default_rng(rng_seed), lens, H, KV, Dh, bs,
                                  pad=-1)
    q = torch.randn(len(lens), 1, H, Dh, generator=gen, device="cuda").bfloat16()
    return q, ck, cv, table, torch.from_numpy(lens).cuda()


def check_paged_sweep(gen, rng):
    """Correctness only, at shapes off the smoke path: the SWEEP head
    layouts, kv_len 1 and block-boundary lengths, tables padded with -1,
    one-row and odd-length chunks with rows past nnew, and the decode
    kernel at WIDE_SWEEP and PASS_SWEEP. Returns the largest errors; a
    disagreement beyond PAGED_TOL fails."""
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
    q, ck, cv, table, kvl = _wide_sweep_case()
    err, ok = close(paged_decode_attention(q, ck, cv, table, kvl),
                    paged_decode_reference(q, ck, cv, table, kvl, p_f32=True))
    _check(ok, f"paged decode kernel disagrees at {WIDE_SWEEP}: {err}")
    worst["decode_wide_group"] = err
    for i, shape in enumerate(PASS_SWEEP):
        q, ck, cv, table, kvl = _wide_sweep_case(2049 + i, shape)
        err, ok = close(paged_decode_attention(q, ck, cv, table, kvl),
                        paged_decode_reference(q, ck, cv, table, kvl, p_f32=True))
        _check(ok, f"paged decode kernel disagrees at {shape}: {err}")
        worst[f"decode_two_passes_{shape[0]}x{shape[2]}"] = err
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


def check_fused_qkv(gen, rng, B, pooled=True, widths=LLAMA_WIDTHS, theta=500000.0):
    """B4 at ``widths`` (Llama-3-8B's; Falcon-7B's in phase 2o) with RoPE
    base ``theta``: B rows at random positions < 2048. With
    ``pooled`` (the paged engine's form) each row appends into its own
    block of the pool; both sides start from the same pool and must leave
    every other pool row as it was. Without, the v1 decode step's form:
    q, k, v only."""
    import torch

    from shuffle_exchange_tpu_torch.models.transformer import rope_table
    from shuffle_exchange_tpu_torch.ops.fused_decode import (fused_qkv_rope,
                                                             fused_qkv_rope_reference)

    D, H, KV, Dh = (widths[k] for k in ("D", "H", "KV", "Dh"))
    bs, W = 64, 32
    pos = rng.integers(0, W * bs, size=B).astype(np.int32)
    table = np.full((B, W), -1, np.int32)
    table[np.arange(B), pos // bs] = np.arange(1, B + 1)
    y = torch.randn(B, D, generator=gen, device="cuda").bfloat16()
    w = [(torch.randn(D, n * Dh, generator=gen, device="cuda") * D ** -0.5).bfloat16()
         for n in (H, KV, KV)]
    pt, tt = torch.from_numpy(pos).cuda(), torch.from_numpy(table).cuda()
    kargs = pargs = ()
    if pooled:
        pool = [torch.randn(B + 1, KV, bs, Dh, generator=gen, device="cuda").bfloat16()
                for _ in range(2)]
        kp, pp = [p.clone() for p in pool], [p.clone() for p in pool]
        kargs, pargs = (*kp, tt, pt), (*pp, tt, pt)
    cos_t, sin_t = rope_table(W * bs, Dh, theta, device="cuda")
    cos, sin = cos_t[pt.long()].contiguous(), sin_t[pt.long()].contiguous()
    run = lambda: fused_qkv_rope(y, *w, cos, sin, *kargs, n_heads=H, kv_heads=KV)
    plain = lambda: fused_qkv_rope_reference(y, *w, cos, sin, *pargs, n_heads=H, kv_heads=KV)
    got, want = run(), plain()
    torch.cuda.synchronize()
    checks = [paged_close(g, wt) for g, wt in zip(got, want)]
    tol_ok = all(ok for _, ok in checks)
    err = max(e.max().item() for e, _ in checks)
    pool_ok = True
    if pooled:
        appended = torch.zeros(pool[0].shape[:3], dtype=torch.bool, device="cuda")
        rows = (torch.arange(1, B + 1, device="cuda"), slice(None), pt.long() % bs)
        appended[rows] = True
        pool_ok = all(torch.equal(k_[~appended], p_[~appended]) and torch.equal(k_[rows], new)
                      for k_, p_, new in zip(kp, pool, got[1:]))
    # a plain version that misplaces the rotation (no RoPE on k) must fail
    bites = _bites(got[1], (y.float() @ w[1].float()).reshape(B, KV, Dh).bfloat16())
    wqkv = torch.cat(w, dim=1)
    n_out = (H + 2 * KV) * Dh
    nbytes = D * n_out * 2 + B * D * 2 + B * n_out * 2 + 2 * B * Dh * 4
    if pooled:   # the appended rows, the table and the positions
        nbytes += B * 2 * KV * Dh * 2 + table.size * 4 + B * 4
    b_ms, b_by = bound(nbytes, 2.0 * B * D * n_out)
    row = dict(shape=dict(B=B, D=D, H=H, KV=KV, Dh=Dh, bs=bs, pos=pos.tolist(), pool=pooled),
               max_abs_err=err, tolerance=PAGED_TOL + " per head row", within=tol_ok,
               tolerance_bites=bites, ms=time_cold(run), host_us=host_us(run),
               plain_ms=time_plain(plain), library_ms=time_cold(lambda: y @ wqkv),
               library="torch.matmul(y, [wq|wk|wv]) (projection only)",
               bound_ms=b_ms, bound_by=b_by)
    if pooled:
        row["pool_rows_exact"] = pool_ok
    _check(tol_ok and pool_ok, f"fused QKV kernel (pool={pooled}) disagrees with its plain "
           f"version at B={B}: max abs err {err}, pool rows exact {pool_ok}")
    _check(bites, "the fused QKV tolerance does not catch a plain version without RoPE")
    return row


def check_fused_mlp(gen, B, widths=LLAMA_WIDTHS):
    """B6 at ``widths`` (Llama-3-8B's; Phi-3-mini's in phase 2p), the
    engine's call: resid and y_src are the same rows. A plain version
    without one 64-row tile of F must fail the tolerance."""
    import torch
    import torch.nn.functional as F

    from shuffle_exchange_tpu_torch.ops.fused_decode import fused_mlp, fused_mlp_reference

    D, Fd = widths["D"], widths["F"]
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
               plain_ms=time_plain(lambda: fused_mlp_reference(h, h, ln_w, wu, wd, wg, eps=1e-5)),
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
    splits = attention_splits(B, KV, W, bs,
                              torch.cuda.get_device_properties(0).multi_processor_count)
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
               plain_ms=time_plain(lambda: fused_paged_decode_reference(q, ck, cv, table, kvl,
                                                                       splits)),
               library_ms=time_cold(lib), bound_ms=b_ms, bound_by=b_by)
    _check(tol_ok, f"split-K decode kernel disagrees with its plain version: "
           f"max abs err {row['max_abs_err']}")
    _check(bites, "the split-K tolerance does not catch a plain version missing one split")
    return row


def check_fused_decode_sweep(gen, rng):
    """B5 for correctness at the SWEEP head layouts and WIDE_SWEEP: kv_len 1
    and block edges, -1-padded tables, split counts 1, 2, 3, the table width
    and the wrapper's own, each with the merge folded into the last split
    and as a second kernel."""
    import torch

    from shuffle_exchange_tpu_torch.ops.fused_decode import (_launch_attention, attention_splits,
                                                             fused_paged_decode_reference)

    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def cases():
        for H, KV, Dh, bs in SWEEP:
            lens = np.asarray([1, bs, bs + 1, 3 * bs - 5, 200], np.int32)
            ck, cv, table = _paged_inputs(gen, rng, lens, H, KV, Dh, bs, pad=-1)
            q = torch.randn(len(lens), 1, H, Dh, generator=gen, device="cuda").bfloat16()
            yield q, ck, cv, table, torch.from_numpy(lens).cuda()
        yield _wide_sweep_case()

    worst = {"fused_decode": 0.0}
    for q, ck, cv, table, kvl in cases():
        B, _, H, Dh = q.shape
        KV, W = ck.shape[1], table.shape[1]
        for n in (1, 2, 3, W, None):
            splits = attention_splits(B, KV, W, ck.shape[2], sms) if n is None else n
            want = fused_paged_decode_reference(q, ck, cv, table, kvl, splits)
            for fold in (True, False):   # the merge in the last split, and as a second kernel
                err, ok = paged_close(_launch_attention(q, ck, cv, table, kvl, n, fold=fold),
                                      want)
                _check(ok, f"split-K decode kernel disagrees at H={H} KV={KV} Dh={Dh} "
                       f"splits={n} fold={fold}: {err.max().item()}")
                key = "fused_decode" if H // KV <= 16 else "fused_decode_wide_group"
                worst[key] = max(worst.get(key, 0.0), err.max().item())
    torch.cuda.synchronize()
    return worst


# ---------------------------------------------------------------------------
# Phase 2c: flash attention (the prefill)
# ---------------------------------------------------------------------------


def _masked_plain(q, k, v, allowed):
    """Attention in f32 with P kept in f32 over an explicit [T, S] (or [B,
    T, S]) mask: the yardstick for deliberately broken plain versions."""
    import torch

    from shuffle_exchange_tpu_torch.ops.flash_attention import repeat_kv

    G = q.shape[2] // k.shape[2]
    kf, vf = repeat_kv(k, G).float(), repeat_kv(v, G).float()
    logits = torch.einsum("bthd,bshd->bhts", q.float() * q.shape[-1] ** -0.5, kf)
    allowed = allowed if allowed.dim() == 3 else allowed[None]
    logits = logits.masked_fill(~allowed[:, None], -1e30)
    return torch.einsum("bhts,bshd->bthd", torch.softmax(logits, -1), vf).to(q.dtype)


def _sdpa_kernels(fn):
    """Names of the CUDA kernels one call of ``fn`` launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted({ev.name for ev in prof.events()
                   if ev.device_type == torch.autograd.DeviceType.CUDA})


# (B, T, S, H, KV, Dh, causal, segments): the prefill's largest program
# (8 prompts padded to 1024) and one long prompt (the two timed cells),
# then a sweep over MHA, GQA groups 4 and 8 and both head sizes, at ragged
# lengths (down to one row and below one tile), a full mask with T != S and
# segment-id cases, each held to its plain version (their times are
# scripts/torch_kernel_digest.py's sweeps section)
FLASH_TIMED = 2
FLASH_SHAPES = [
    (8, 1024, 1024, 32, 8, 128, True, False),
    (1, 2048, 2048, 32, 8, 128, True, False),
    (2, 1000, 1000, 32, 8, 128, True, False),
    (2, 200, 200, 32, 32, 128, True, False),
    (2, 1000, 1000, 32, 32, 128, True, False),
    (2, 200, 200, 16, 2, 64, True, False),
    (2, 1000, 1000, 16, 2, 64, True, False),
    (2, 200, 1000, 32, 8, 128, False, False),
    (2, 1000, 1000, 32, 8, 128, True, True),
    (3, 1, 1, 8, 2, 128, True, False),
    (3, 37, 37, 8, 2, 64, True, True),
]


def check_flash(gen, rng):
    """The flash kernel against its plain version with P in f32 (both round
    one f32 result to bf16) at every FLASH_SHAPES shape, within PAGED_TOL.
    The first FLASH_TIMED shapes (the first is the one the ``kernels`` line
    reports) are timed beside their bound, the plain version and SDPA (as a
    yardstick; its backend named from the kernels it ran); at each of them
    two launches give equal bits, and a plain version with the causal
    diagonal shifted by one, and one without the last 64-key tile, must
    fail the tolerance."""
    import torch
    import torch.nn.functional as F

    from shuffle_exchange_tpu_torch.ops.flash_attention import (flash_attention,
                                                                reference_attention)

    rows = []
    for i, (B, T, S, H, KV, Dh, causal, segments) in enumerate(FLASH_SHAPES):
        q = torch.randn(B, T, H, Dh, generator=gen, device="cuda").bfloat16()
        k = torch.randn(B, S, KV, Dh, generator=gen, device="cuda").bfloat16()
        v = torch.randn(B, S, KV, Dh, generator=gen, device="cuda").bfloat16()
        seg = None
        if segments:
            seg = torch.from_numpy(np.sort(rng.integers(0, 4, size=(B, T)), axis=1)
                                   .astype(np.int32)).cuda()
        run = lambda: flash_attention(q, k, v, causal=causal, segment_ids=seg)
        plain = lambda: reference_attention(q, k, v, causal, seg, p_f32=True)
        got, want = run(), plain()
        torch.cuda.synchronize()
        err, tol_ok = paged_close(got, want)
        _check(tol_ok, f"flash attention kernel disagrees with its plain version at "
               f"{FLASH_SHAPES[i]}: max abs err {err.max().item()}")
        allowed = torch.ones(T, S, dtype=torch.bool, device="cuda")
        if causal:
            allowed = allowed.tril()
        if seg is not None:
            allowed = allowed[None] & (seg[:, :, None] == seg[:, None, :])
        pairs = int(allowed.sum().item()) * (1 if allowed.dim() == 3 else B)
        row = dict(shape=dict(B=B, T=T, S=S, H=H, KV=KV, Dh=Dh, causal=causal,
                              segment_ids=segments),
                   max_abs_err=err.max().item(),
                   max_rel_err=(err.max() / want.float().abs().max()).item(),
                   tolerance=PAGED_TOL + " (plain with P in f32)", within=tol_ok)
        if i >= FLASH_TIMED:
            rows.append(row)
            del q, k, v, got, want
            continue
        row["equal_bits_twice"] = equal_bits_twice(run)
        _check(row["equal_bits_twice"], f"two runs of the flash forward differ at "
               f"{FLASH_SHAPES[i]}")
        shifted = torch.ones(T, S, dtype=torch.bool, device="cuda").tril(1)
        short = torch.ones(T, S, dtype=torch.bool, device="cuda").tril()
        short[:, S - 64:] = False     # rows past S - 64 keep keys 0 .. S - 65
        row["tolerance_bites"] = {
            "diagonal_shifted": _bites(got, _masked_plain(q, k, v, shifted)),
            "last_kv_tile_missing": _bites(got, _masked_plain(q, k, v, short))}
        _check(all(row["tolerance_bites"].values()), f"the flash tolerance does not catch "
               f"a broken plain version at {FLASH_SHAPES[i]}: {row['tolerance_bites']}")
        qs, ks, vs = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        if seg is None:
            lib = lambda: F.scaled_dot_product_attention(qs, ks, vs, is_causal=causal,
                                                         enable_gqa=True)
        else:
            mask = allowed[:, None]
            lib = lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask,
                                                         enable_gqa=True)
        row["library_max_abs_err"] = (lib().transpose(1, 2).float()
                                      - want.float()).abs().max().item()
        nbytes = 2 * B * T * H * Dh * 2 + 2 * B * S * KV * Dh * 2 + (0 if seg is None else B * T * 4)
        b_ms, b_by = bound(nbytes, 4.0 * pairs * H * Dh)
        row.update(visible_pairs=pairs, ms=time_cold(run), host_us=host_us(run),
                   plain_ms=time_plain(plain), library_ms=time_cold(lib),
                   library_kernels=_sdpa_kernels(lib), bound_ms=b_ms, bound_by=b_by)
        row["library_backend"] = _sdpa_backend(row["library_kernels"])
        row["tflops"] = 4.0 * pairs * H * Dh / (row["ms"] * 1e-3) / 1e12
        rows.append(row)
        del q, k, v, got, want
    torch.cuda.synchronize()
    return rows


# ---------------------------------------------------------------------------
# Phase 2d: the training kernels (flash attention backward, fused AdamW)
# ---------------------------------------------------------------------------

# The backward kernels and the plain version (reference_attention_bwd: the
# passes' formulas in f32 on the same operands, the forward's bf16 out
# included) each round one f32 gradient to bf16. The kernels feed P and dS
# to the tensor cores as two bf16 terms (hi + lo), so their f32 results
# differ from the plain ones by summation order and ~2^-16 relative terms
# only: one bf16 step of the gradient (2^-7 |plain|) plus 2^-8 of the
# tensor's RMS for elements that cancel to near zero. A causal diagonal
# shifted by one moves dv of the early keys by far more. (Autograd through
# the unrounded f32 forward is further away, because delta = rowsum(dout *
# out) then lacks the rounding of out: its distance is reported beside.)
# The 1e-5 is for gradients that are zero by cancellation in f32 (a row
# with one visible key has dS = dP - delta = 0 up to f32 rounding of two
# sums of order 10).
GRAD_TOL = "2^-7*|plain| + 2^-8*rms(plain tensor) + 1e-5"
LSE_TOL = 1e-3       # f32 sums in another order and exp2f: absolute, lse is of order 1-10
# The worst element's distance from autograd through the unrounded f32
# forward (reference_attention with P in f32), over the tensor's RMS, at the
# training shape: measured 0.07 (dv) to 0.13 (dq) on the H100, all of it the
# bf16 rounding of out inside delta. A limit of 1.5 times that holds the
# kernels to the yardstick that shares nothing with them.
AUTOGRAD_TOL = 0.2


def grad_close(got, want):
    got, want = got.float(), want.float()
    err = (got - want).abs()
    rms = want.pow(2).mean().sqrt()
    return err, bool((err <= 2 ** -7 * want.abs() + 2 ** -8 * rms + 1e-5).all())


# (B, T, S, H, KV, Dh, causal, segments): the training step's shape (32
# sequences of 1023 positions after the label shift, 16/4 heads of 128), the
# same at T = 1024, an MHA shape and GPT-2 _config1's training shape (16 x
# 1023, 12 heads of 64) (these four are timed), then MHA at T = 200, head
# size 64, segment ids, ragged T = 37, one row, and a full mask with T != S.
# GPT-2's cell draws from its own generator (seeded from the phase's), so the
# phases after this one keep the inputs they had before it was added
FLASH_BWD_TIMED = 4
FLASH_BWD_GPT2 = (16, 1023, 1023, 12, 12, 64, True, False)
FLASH_BWD_SHAPES = [
    (32, 1023, 1023, 16, 4, 128, True, False),
    (32, 1024, 1024, 16, 4, 128, True, False),
    (2, 1000, 1000, 32, 32, 128, True, False),
    FLASH_BWD_GPT2,
    (2, 200, 200, 8, 8, 128, True, False),
    (2, 1000, 1000, 16, 2, 64, True, False),
    (2, 1000, 1000, 16, 4, 128, True, True),
    (3, 37, 37, 8, 2, 64, True, True),
    (3, 1, 1, 8, 2, 128, True, False),
    (2, 200, 1000, 16, 4, 128, False, False),
]


def _masked_plain_grads(q, k, v, dout, allowed):
    """(dq, dk, dv) in bf16 by autograd through ``_masked_plain`` on f32
    copies: the yardstick for deliberately broken plain versions."""
    import torch

    leaves = [t.float().requires_grad_(True) for t in (q, k, v)]
    out = _masked_plain(*leaves, allowed)
    return [g.bfloat16() for g in torch.autograd.grad(out, leaves, dout.float())]


def check_flash_bwd(gen, rng):
    """The forward's out and lse and the backward kernels against their
    plain versions at every FLASH_BWD_SHAPES shape (the kernel's out goes
    into both backwards only once it has agreed with the plain out); the
    first FLASH_BWD_TIMED shapes are timed beside their bound, the plain
    version, SDPA's forward and SDPA's backward (yardsticks only, the
    backend named). At each timed shape a plain version with the causal
    diagonal shifted by one must fail both tolerances and two runs of the
    forward and of the backward kernels must give equal bits; at the first
    the kernels must stay within AUTOGRAD_TOL of autograd through the plain
    forward."""
    import torch
    import torch.nn.functional as F

    from shuffle_exchange_tpu_torch.ops.flash_attention import (flash_attention_bwd,
                                                                flash_attention_lse,
                                                                reference_attention,
                                                                reference_attention_bwd,
                                                                reference_attention_lse)

    rows = []
    gpt2_gen = torch.Generator(device="cuda").manual_seed(gen.initial_seed() + 1)
    for i, (B, T, S, H, KV, Dh, causal, segments) in enumerate(FLASH_BWD_SHAPES):
        shape = (B, T, S, H, KV, Dh, causal, segments)
        g = gpt2_gen if shape == FLASH_BWD_GPT2 else gen
        q = torch.randn(B, T, H, Dh, generator=g, device="cuda").bfloat16()
        k = torch.randn(B, S, KV, Dh, generator=g, device="cuda").bfloat16()
        v = torch.randn(B, S, KV, Dh, generator=g, device="cuda").bfloat16()
        dout = torch.randn(B, T, H, Dh, generator=g, device="cuda").bfloat16()
        seg = None
        if segments:
            seg = torch.from_numpy(np.sort(rng.integers(0, 4, size=(B, T)), axis=1)
                                   .astype(np.int32)).cuda()
        out, lse = flash_attention_lse(q, k, v, causal, seg)
        want_out, want_lse = reference_attention_lse(q, k, v, causal, seg, p_f32=True)
        torch.cuda.synchronize()
        out_err, out_ok = paged_close(out, want_out)
        out_err = out_err.max().item()
        _check(out_ok, f"flash forward (with lse) out disagrees with its plain version at "
               f"{shape}: max abs err {out_err}")
        lse_err = (lse - want_lse).abs().max().item()
        _check(lse_err <= LSE_TOL, f"flash forward lse disagrees with its plain version at "
               f"{shape}: max abs err {lse_err}")
        del want_out
        # out has agreed with the plain forward: both backwards read it
        run = lambda: flash_attention_bwd(q, k, v, out, lse, dout, causal, seg)
        plain = lambda: reference_attention_bwd(q, k, v, out, dout, causal, seg)
        got = run()
        want = plain()
        torch.cuda.synchronize()
        checks = [grad_close(g, w) for g, w in zip(got, want)]
        errs = {n: e.max().item() for n, (e, _) in zip(("dq", "dk", "dv"), checks)}
        tol_ok = all(ok for _, ok in checks)
        _check(tol_ok, f"flash backward kernels disagree with their plain version at {shape}: "
               f"max abs err {errs}")
        allowed = torch.ones(T, S, dtype=torch.bool, device="cuda")
        if causal:
            allowed = allowed.tril()
        if seg is not None:
            allowed = allowed[None] & (seg[:, :, None] == seg[:, None, :])
        pairs = int(allowed.sum().item()) * (1 if allowed.dim() == 3 else B)
        row = dict(shape=dict(B=B, T=T, S=S, H=H, KV=KV, Dh=Dh, causal=causal,
                              segment_ids=segments),
                   max_abs_err=max(errs.values()), errs=errs, lse_max_abs_err=lse_err,
                   fwd_out_max_abs_err=out_err,
                   tolerance=GRAD_TOL + f"; lse {LSE_TOL} abs; forward out {PAGED_TOL}",
                   within=tol_ok)
        if i < FLASH_BWD_TIMED:
            again = run()
            torch.cuda.synchronize()
            row["equal_bits_twice"] = all(torch.equal(a, b_) for a, b_ in zip(got, again))
            row["fwd_equal_bits_twice"] = equal_bits_twice(
                lambda: flash_attention_lse(q, k, v, causal, seg)[0])
            _check(row["equal_bits_twice"] and row["fwd_equal_bits_twice"],
                   f"two runs of the flash kernels differ at {shape}")
            del again
            small = slice(0, 4)      # the shifted plain version on 4 sequences
            shifted = torch.ones(T, S, dtype=torch.bool, device="cuda").tril(1)
            broken = _masked_plain_grads(q[small], k[small], v[small], dout[small], shifted)
            row["tolerance_bites"] = {
                n: not grad_close(g[small], w)[1]
                for n, g, w in zip(("dq", "dk", "dv"), got, broken)}
            logits = torch.einsum("bthd,bshd->bhts", q[small].float() * Dh ** -0.5,
                                  k[small].float().repeat_interleave(H // KV, dim=2))
            shifted_lse = torch.logsumexp(logits.masked_fill(~shifted, -1e30), -1)
            row["tolerance_bites"]["lse"] = bool(
                (lse[small] - shifted_lse).abs().max().item() > LSE_TOL)
            _check(all(row["tolerance_bites"].values()), "the flash backward tolerance does "
                   f"not catch a shifted diagonal at {shape}: {row['tolerance_bites']}")
            del broken, logits, shifted_lse
        if i == 0:
            leaves = [t[small].float().requires_grad_(True) for t in (q, k, v)]
            auto = torch.autograd.grad(reference_attention(*leaves, causal, None), leaves,
                                       dout[small].float())
            row["autograd_max_err_over_rms"] = {
                n: ((g[small].float() - a).abs().max() / a.pow(2).mean().sqrt()).item()
                for n, g, a in zip(("dq", "dk", "dv"), got, auto)}
            _check(max(row["autograd_max_err_over_rms"].values()) <= AUTOGRAD_TOL,
                   f"the flash backward kernels are further than {AUTOGRAD_TOL} of the "
                   f"tensor's RMS from autograd through the plain forward: "
                   f"{row['autograd_max_err_over_rms']}")
            del leaves, auto
        if i < FLASH_BWD_TIMED:
            qs, ks, vs = (t.transpose(1, 2).contiguous().requires_grad_(True) for t in (q, k, v))
            dos = dout.transpose(1, 2).contiguous()
            lib_fwd = lambda: F.scaled_dot_product_attention(qs, ks, vs, is_causal=causal,
                                                             enable_gqa=True)
            lib_out = lib_fwd()
            lib = lambda: torch.autograd.grad(lib_out, (qs, ks, vs), dos, retain_graph=True)
            lib_dq = lib()[0].transpose(1, 2)
            row["library_max_abs_err"] = (lib_dq.float() - want[0].float()).abs().max().item()
            nbytes = (3 * B * T * H * Dh * 2 + 2 * B * S * KV * Dh * 2 + B * H * T * 4   # reads
                      + B * T * H * Dh * 2 + 2 * B * S * KV * Dh * 2)                    # writes
            b_ms, b_by = bound(nbytes, 10.0 * pairs * H * Dh)
            row.update(visible_pairs=pairs, ms=time_cold(run, iters=10),
                       host_us=host_us(run), plain_ms=time_plain(plain),
                       library_ms=time_cold(lib, iters=10),
                       library="SDPA backward (torch.autograd.grad of "
                               "scaled_dot_product_attention, enable_gqa)",
                       library_kernels=_sdpa_kernels(lib), bound_ms=b_ms, bound_by=b_by,
                       fwd_lse_ms=time_cold(lambda: flash_attention_lse(q, k, v, causal, seg),
                                            iters=10),
                       library_fwd_ms=time_cold(lib_fwd, iters=10))
            row["library_backend"] = _sdpa_backend(row["library_kernels"])
            row["fwd_bound_ms"] = bound(2 * B * T * H * Dh * 2 + 2 * B * S * KV * Dh * 2
                                        + B * H * T * 4, 4.0 * pairs * H * Dh)[0]
            row["tflops"] = 10.0 * pairs * H * Dh / (row["ms"] * 1e-3) / 1e12
            del qs, ks, vs, dos, lib_out, lib_dq
        rows.append(row)
        del q, k, v, dout, out, lse, got, want, want_lse
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    return rows


# The kernel and the plain version do the same f32 operations; the
# compiler may contract a multiply and an add into one fma and PyTorch
# divides by a scalar as a product with its reciprocal, so they differ by a
# few f32 roundings of the terms: 1e-6 of (|plain| + |the value before the
# step|), the second term for elements whose update cancels the value. For
# p there is also 1e-5*lr: where b1*m and (1-b1)*g cancel, the new m keeps
# few digits and the update lr*m_hat/(sqrt(v_hat)+eps), of order lr, moves
# with it. Leaving the weight decay out moves p by lr*wd*|p| = 6e-7 at the
# typical |p| of 0.02, 200 times that floor.
ADAM_TOL = "1e-6*(|plain| + |value before the step|) + 1e-5*lr (p) or 1e-12 (m, v)"
ADAM_HP = dict(lr=3e-4, b1=0.9, b2=0.999, eps=1e-8)


def check_fused_adamw(gen):
    """B10 against its plain version: the largest stacked leaf of the
    training model, its embedding and a ragged 1-D leaf, at steps 1 and
    1000, with and without weight decay and with a clip coefficient. The
    first leaf is timed beside its bound and ``torch.optim.AdamW(fused=
    True)`` (a yardstick only). A plain version without the weight decay
    must fail the tolerance."""
    import torch

    from shuffle_exchange_tpu_torch.ops.fused_adam import fused_adamw_update, reference_update

    def close(got, want, before, floor):
        err = (got - want).abs()
        return err.max().item(), bool((err <= 1e-6 * (want.abs() + before.abs()) + floor).all())

    p_floor = 1e-5 * ADAM_HP["lr"]

    rows = []
    for i, shape in enumerate([(16, 2048, 8192), (128256, 2048), (1000003,)]):
        n = int(np.prod(shape))
        p = torch.randn(shape, generator=gen, device="cuda") * 0.02
        g = torch.randn(shape, generator=gen, device="cuda") * 1e-3
        m = torch.randn(shape, generator=gen, device="cuda") * 1e-3
        v = torch.rand(shape, generator=gen, device="cuda") * 1e-6
        worst, ok_all, bites = 0.0, True, None
        for step, wd, gscale in ((1, 0.1, 1.0), (1000, 0.1, 0.37), (1000, 0.0, 1.0)):
            kp, km, kv_ = p.clone(), m.clone(), v.clone()
            if step == 1:
                km.zero_()
                kv_.zero_()
            m0, v0 = km.clone(), kv_.clone()
            fused_adamw_update(kp, g, km, kv_, weight_decay=wd, step=step, grad_scale=gscale,
                               **ADAM_HP)
            want = reference_update(p, g, m0, v0, weight_decay=wd, step=step,
                                    grad_scale=gscale, **ADAM_HP)
            torch.cuda.synchronize()
            for got_t, want_t, before, floor in zip((kp, km, kv_), want, (p, m0, v0),
                                                    (p_floor, 1e-12, 1e-12)):
                err, ok = close(got_t, want_t, before, floor)
                worst, ok_all = max(worst, err), ok_all and ok
            if wd and bites is None:
                no_wd = reference_update(p, g, m0, v0, weight_decay=0.0, step=step,
                                         grad_scale=gscale, **ADAM_HP)[0]
                bites = not close(kp, no_wd, p, p_floor)[1]
            del kp, km, kv_, m0, v0, want
        _check(ok_all, f"fused AdamW kernel disagrees with its plain version at {shape}: "
               f"max abs err {worst}")
        _check(bites, "the AdamW tolerance does not catch a plain version without weight decay")
        row = dict(shape=list(shape), max_abs_err=worst, tolerance=ADAM_TOL, within=ok_all,
                   tolerance_bites=bites)
        if i == 0:
            run = lambda: fused_adamw_update(p, g, m, v, weight_decay=0.1, step=1000, **ADAM_HP)
            plain = lambda: reference_update(p, g, m, v, weight_decay=0.1, step=1000, **ADAM_HP)
            lp = torch.nn.Parameter(p.clone())
            lp.grad = g
            opt = torch.optim.AdamW([lp], lr=ADAM_HP["lr"], betas=(0.9, 0.999), eps=1e-8,
                                    weight_decay=0.1, fused=True)
            b_ms, b_by = bound(28.0 * n, 12.0 * n, F32_FLOP_PER_S)
            row.update(ms=time_cold(run, iters=10), host_us=host_us(run),
                       plain_ms=time_plain(plain),
                       library_ms=time_cold(opt.step, iters=10),
                       library="torch.optim.AdamW(fused=True).step()",
                       bound_ms=b_ms, bound_by=b_by)
            row["gbytes_per_s"] = 28.0 * n / (row["ms"] * 1e-3) / 1e9
            del lp, opt
        rows.append(row)
        del p, g, m, v
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# Phase 2e: the quantized serving kernels (B8 quantized matmul, B7 quantized
# fused MLP)
# ---------------------------------------------------------------------------

QUANT_FORMATS = (8, 4, "fp8")
# Llama-3-8B's layer matrices (K, N): wq / wo, wk / wv, w_gate / w_up, w_down
QUANT_SHAPES = [(4096, 14336), (4096, 4096), (4096, 1024), (14336, 4096)]
# decode rows (8 and 1), a tick's chunk rows (256) and a put() of 8 prompts
# padded to 1024 (8192)
QUANT_ROWS = [8, 1, 256, 8192]
# (M, K, N, gs) off the path: ragged rows on both forms, N not a multiple
# of either kernel's column tile, and group 64
QUANT_EXTRA = [(37, 4096, 1024, 256), (3, 4096, 1040, 256), (1000, 1024, 1040, 256),
               (8, 4096, 1024, 64), (256, 4096, 1024, 64)]


class _f32_reduction:
    """cuBLAS with f32 reductions for bf16 products (no bf16 split-K
    partials) while the plain versions run, so they round once as the
    kernels do."""

    def __enter__(self):
        import torch

        self.was = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

    def __exit__(self, *exc):
        import torch

        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = self.was


# The quantized MLP's kernel and plain version round a = silu(g)*u to bf16
# from f32 sums of g and u that differ in summation order (5e-7 relative on
# the H100); about 0.1% of a's elements then round the other way, each
# moving the down projection by ulp(a) * |w_down|. Beyond one bf16 step of
# the output that left at most 0.0012 of the row's RMS over 20 seeds x 3
# formats of 8 rows on the H100 (more than 1e-3 of the RMS, which the
# serving kernels' tolerance allows), so the output is held to one bf16
# step of itself plus one bf16 step (0.0078) of the row's RMS. A w_down with
# its scale rows shifted by one group lands at least 0.36 of the RMS beyond.
QUANT_MLP_TOL = "2^-7*|plain| + 2^-7*rms(plain row)"


def quant_mlp_close(got, want):
    got, want = got.float(), want.float()
    err = (got - want).abs()
    rms = want.pow(2).mean(-1, keepdim=True).sqrt()
    return err, bool((err <= 2 ** -7 * want.abs() + 2 ** -7 * rms).all())


def _shifted_scales(qm):
    """A broken copy: every scale row moved down by one group."""
    from shuffle_exchange_tpu_torch.ops.quant_matmul import QuantizedMatrix

    return QuantizedMatrix(qm.q, qm.scales.roll(1, 0), qm.group_size, qm.dtype, qm.bits,
                           qm.n_cols)


def _swapped_nibbles(qm):
    """A broken int4 copy: rows r and r + gs/2 of each group exchanged."""
    from shuffle_exchange_tpu_torch.ops.quant_matmul import QuantizedMatrix

    return QuantizedMatrix((qm.q >> 4) | (qm.q << 4), qm.scales, qm.group_size, qm.dtype,
                           qm.bits, qm.n_cols)


def check_quant_matmul(gen):
    """B8 against its plain version (the JAX default formula) for the three
    formats at group 256 on Llama-3-8B's four matrix shapes and QUANT_ROWS
    rows, then QUANT_EXTRA; the cases of the first shape (w_gate / w_up)
    and the 256-row cases of every shape (a tick's chunk rows, on the
    wgmma kernel) are timed beside their bound, the plain version,
    dequantize + ``torch.matmul`` (the library yardstick) and cuBLAS on the
    dense bf16 weight (the other shapes' times are
    scripts/torch_kernel_digest.py's sweeps section). At each format's first case a
    plain version with the scale rows shifted by one group (and, for
    int4, one with the nibbles swapped) must fail the tolerance, and two
    runs must give equal bits."""
    import torch

    from shuffle_exchange_tpu_torch.ops.quant_matmul import (quant_matmul,
                                                             quant_matmul_reference,
                                                             quantize_weight)

    cases = [(bits, M, K, N, 256, (K, N) == QUANT_SHAPES[0] or M == 256)
             for bits in QUANT_FORMATS for K, N in QUANT_SHAPES for M in QUANT_ROWS]
    cases += [(bits, M, K, N, gs, False) for bits in QUANT_FORMATS
              for M, K, N, gs in QUANT_EXTRA]
    rows, made = [], {}
    with _f32_reduction():
        for bits, M, K, N, gs, timed in cases:
            if (bits, K, N, gs) not in made:
                made.clear()
                torch.cuda.empty_cache()
                w = (torch.randn(K, N, generator=gen, device="cuda") * K ** -0.5).bfloat16()
                made[(bits, K, N, gs)] = (w, quantize_weight(w, gs, bits=bits))
            w, qm = made[(bits, K, N, gs)]
            x = torch.randn(M, K, generator=gen, device="cuda").bfloat16()
            run = lambda: quant_matmul(x, qm)
            plain = lambda: quant_matmul_reference(x, qm)
            got, want = run(), plain()
            torch.cuda.synchronize()
            err, tol_ok = paged_close(got, want)
            row = dict(shape=dict(M=M, K=K, N=N, gs=qm.group_size, bits=str(bits)),
                       max_abs_err=err.max().item(),
                       max_rel_err=(err.max() / want.float().abs().max()).item(),
                       tolerance=PAGED_TOL + " per output row", within=tol_ok)
            _check(tol_ok, f"quantized matmul kernel disagrees with its plain version at "
                   f"{row['shape']}: max abs err {row['max_abs_err']}")
            if not any(r["shape"]["bits"] == str(bits) for r in rows):
                bites = {"scales_shifted": _bites(got, quant_matmul_reference(
                    x, _shifted_scales(qm)))}
                if bits == 4:
                    bites["nibbles_swapped"] = _bites(got, quant_matmul_reference(
                        x, _swapped_nibbles(qm)))
                row["tolerance_bites"] = bites
                row["equal_bits_twice"] = torch.equal(got, run())
                _check(all(bites.values()), f"the quantized matmul tolerance does not catch a "
                       f"broken plain version: {bites}")
                _check(row["equal_bits_twice"], "two runs of the quantized matmul differ")
            if timed:
                nbytes = M * K * 2 + qm.nbytes + M * N * 2
                b_ms, b_by = bound(nbytes, 2.0 * M * K * N)
                iters = 10 if M > 1024 else 20
                row.update(ms=time_cold(run, iters), host_us=host_us(run),
                           plain_ms=time_plain(plain),
                           library_ms=time_cold(lambda: x @ qm.dequantize(), iters),
                           library="dequantize() + torch.matmul",
                           dense_cublas_ms=time_cold(lambda: x @ w, iters),
                           bound_ms=b_ms, bound_by=b_by)
                row["gbytes_per_s"] = nbytes / (row["ms"] * 1e-3) / 1e9
                row["tflops"] = 2.0 * M * K * N / (row["ms"] * 1e-3) / 1e12
            rows.append(row)
            del x, got, want, err
    made.clear()
    torch.cuda.empty_cache()
    return rows


def check_fused_mlp_quant(gen):
    """B7 at Llama-3-8B widths for the three formats at group 256, B = 8,
    1, 16 (the kernel's pass of 16 rows) and 9 (a pass past the old 8-row
    groups), through ``fused_mlp`` (the engine's call, which dispatches on
    the weights' type), against its plain version. A plain version with
    w_down's scale rows shifted by one group (and, for int4, one with
    w_up's nibbles swapped) must fail the tolerance. Timed beside its
    bound, the plain version, the dequantize + cuBLAS sequence (the
    library yardstick) and the cuBLAS sequence on the dense bf16
    weights."""
    import torch
    import torch.nn.functional as F

    from shuffle_exchange_tpu_torch.ops.fused_decode import fused_mlp, fused_mlp_quant_reference
    from shuffle_exchange_tpu_torch.ops.quant_matmul import quantize_weight

    D, Fd = LLAMA_WIDTHS["D"], LLAMA_WIDTHS["F"]
    wg, wu = [(torch.randn(D, Fd, generator=gen, device="cuda") * D ** -0.5).bfloat16()
              for _ in range(2)]
    wd = (torch.randn(Fd, D, generator=gen, device="cuda") * Fd ** -0.5).bfloat16()
    ln_w = (1 + 0.1 * torch.randn(D, generator=gen, device="cuda")).bfloat16()
    rows = []
    with _f32_reduction():
        for bits in QUANT_FORMATS:
            qg, qu, qd = (quantize_weight(w, 256, bits=bits) for w in (wg, wu, wd))
            for B in (8, 1, 16, 9):
                h = torch.randn(B, D, generator=gen, device="cuda").bfloat16()
                run = lambda: fused_mlp(h, h, ln_w, qu, qd, qg, eps=1e-5)
                plain = lambda: fused_mlp_quant_reference(h, h, ln_w, qu, qd, qg, eps=1e-5)
                got, want = run(), plain()
                err, tol_ok = quant_mlp_close(got, want)
                bites = {"w_down_scales_shifted": not quant_mlp_close(
                    got, fused_mlp_quant_reference(h, h, ln_w, qu, _shifted_scales(qd), qg,
                                                   eps=1e-5))[1]}
                if bits == 4:
                    bites["w_up_nibbles_swapped"] = not quant_mlp_close(
                        got, fused_mlp_quant_reference(h, h, ln_w, _swapped_nibbles(qu), qd, qg,
                                                       eps=1e-5))[1]
                _check(tol_ok, f"fused quantized MLP kernel disagrees with its plain version at "
                       f"bits={bits} B={B}: max abs err {err.max().item()}")
                _check(all(bites.values()), f"the fused quantized MLP tolerance does not catch "
                       f"a broken plain version: {bites}")
                twice = torch.equal(got, run())
                _check(twice, f"two runs of the fused quantized MLP differ at bits={bits} B={B}")

                def deq_cublas():
                    yn = F.rms_norm(h, (D,), ln_w, 1e-5)
                    return h + (F.silu(yn @ qg.dequantize()) * (yn @ qu.dequantize())) \
                        @ qd.dequantize()

                def dense_cublas():
                    yn = F.rms_norm(h, (D,), ln_w, 1e-5)
                    return h + (F.silu(yn @ wg) * (yn @ wu)) @ wd

                nbytes = qg.nbytes + qu.nbytes + qd.nbytes + 3 * B * D * 2 + D * 2
                b_ms, b_by = bound(nbytes, 6.0 * B * D * Fd)
                row = dict(shape=dict(B=B, D=D, F=Fd, gs=256, bits=str(bits)),
                           max_abs_err=err.max().item(),
                           max_rel_err=(err.max() / want.float().abs().max()).item(),
                           tolerance=QUANT_MLP_TOL, within=tol_ok, equal_bits_twice=twice,
                           tolerance_bites=bites, ms=time_cold(run), host_us=host_us(run),
                           plain_ms=time_plain(plain), library_ms=time_cold(deq_cublas),
                           library="dequantize() + the cuBLAS sequence",
                           dense_cublas_sequence_ms=time_cold(dense_cublas),
                           bound_ms=b_ms, bound_by=b_by)
                row["gbytes_per_s"] = nbytes / (row["ms"] * 1e-3) / 1e9
                rows.append(row)
                del h, got, want, err
            del qg, qu, qd
            torch.cuda.empty_cache()
    del wg, wu, wd
    torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# Phase 2m: B7's norm, gate and activation forms
# ---------------------------------------------------------------------------

# (D, F) of the three models the port serves quantized
MQ_WIDTHS = {"llama": (4096, 14336), "bloom": (2048, 8192), "gpt2": (768, 3072)}
MQ_AXES = {"norm": ("rmsnorm", "layernorm"), "gated": (True, False),
           "activation": ("silu", "relu", "gelu_new", "gelu_pytorch_tanh"),
           "bits": QUANT_FORMATS, "width": tuple(MQ_WIDTHS), "B": (8, 1)}
# the form BLOOM-1b7's widths without fc biases serve (phase 3i) in each
# format, first: the kernels JSON times the first
MQ_FIRST = [("layernorm", False, "gelu_new", bits, "bloom", 8) for bits in QUANT_FORMATS]


def mlp_quant_cells(first=MQ_FIRST, axes=MQ_AXES):
    """``first``, then cells of the product of ``axes`` picked greedily
    (each the one that meets the most value pairs not yet met) until every
    value of every axis has met every value of every other axis."""
    import itertools

    n = len(axes)

    def pairs(cell):
        return {(i, cell[i], j, cell[j]) for i, j in itertools.combinations(range(n), 2)}

    vals = list(axes.values())
    need = {(i, a, j, b) for i, j in itertools.combinations(range(n), 2)
            for a in vals[i] for b in vals[j]}
    cells = list(first)
    for c in cells:
        need -= pairs(c)
    product = list(itertools.product(*vals))
    while need:
        best = max(product, key=lambda c: len(pairs(c) & need))
        cells.append(best)
        need -= pairs(best)
    return cells


def _b7_broken(h, ln_w, ln_b, qu, qd, qg, norm, act, bite):
    """A plain B7 with one deliberate fault: ``ln_b`` dropped, the gate read
    on the plain form (w_up standing in as the gate), gelu_new computed as
    relu, or RMSNorm (its bias kept) where the form says layernorm."""
    import torch

    from shuffle_exchange_tpu_torch.ops.fused_decode import _act_f32, fused_mlp_quant_reference

    if bite == "rmsnorm_for_layernorm":
        x = h.float()
        yn = (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + 1e-5) * ln_w.float()
              + ln_b.float()).to(h.dtype).float()
        f32 = torch.float32
        u = yn @ qu.dequantize(f32)
        fn = _act_f32(act)
        a = fn(yn @ qg.dequantize(f32)) * u if qg is not None else fn(u)
        return (h.float() + a.to(h.dtype).float() @ qd.dequantize(f32)).to(h.dtype)
    kw = dict(ln_b=None if bite == "dropped_ln_b" else ln_b, norm=norm,
              activation="relu" if bite == "gelu_new_as_relu" else act)
    gate = qu if bite == "gate_read_on_plain" else qg
    return fused_mlp_quant_reference(h, h, ln_w, qu, qd, gate, 1e-5, **kw)


def check_mlp_quant_forms(gen):
    """B7 in every norm (RMSNorm, layernorm with its bias), gate (gated or
    plain), fusable activation and storage format, at Llama-3-8B's,
    BLOOM-1b7's and GPT-2's widths and 1 and 8 rows, over the cells of
    ``mlp_quant_cells`` (each axis value meets each other axis's values),
    through ``fused_mlp`` against ``fused_mlp_quant_reference`` within
    QUANT_MLP_TOL; the MQ_FIRST cells (BLOOM's form in each format) timed
    beside their bytes bound, the plain version and dequantize + the cuBLAS
    sequence (the others' times: scripts/torch_kernel_digest.py's sweeps
    section). The rows carry a per-row offset (a
    hidden state's mean), so layernorm and RMSNorm differ; the bites that
    apply to a cell's form must fail: a dropped ``ln_b``, the gate read on
    the plain form, gelu_new computed as relu, layernorm computed as
    RMSNorm."""
    import torch
    import torch.nn.functional as F

    from shuffle_exchange_tpu_torch.ops.fused_decode import fused_mlp, fused_mlp_quant_reference
    from shuffle_exchange_tpu_torch.ops.quant_matmul import quantize_weight

    randn = lambda *sh, scale=1.0: scale * torch.randn(*sh, generator=gen, device="cuda")
    rows, made = [], {}
    cells = MQ_FIRST + sorted((c for c in mlp_quant_cells() if c not in MQ_FIRST),
                              key=lambda c: (c[4], str(c[3])))     # one quantization each
    with _f32_reduction():
        for norm, gated, act, bits, width, B in cells:
            D, Fd = MQ_WIDTHS[width]
            if (width, bits) not in made:
                made.clear()
                torch.cuda.empty_cache()
                ws = [randn(D, Fd, scale=D ** -0.5).bfloat16(), randn(D, Fd, scale=D ** -0.5)
                      .bfloat16(), randn(Fd, D, scale=Fd ** -0.5).bfloat16()]
                made[(width, bits)] = [quantize_weight(w, 256, bits=bits) for w in ws]
                del ws
            qg_all, qu, qd = made[(width, bits)]
            qg = qg_all if gated else None
            ln_w = (1 + randn(D, scale=0.1)).bfloat16()
            ln_b = randn(D, scale=0.1).bfloat16()
            h = (randn(B, D) + randn(B, 1, scale=0.5)).bfloat16()
            kw = dict(ln_b=ln_b, norm=norm, activation=act)
            run = lambda: fused_mlp(h, h, ln_w, qu, qd, qg, eps=1e-5, **kw)
            plain = lambda: fused_mlp_quant_reference(h, h, ln_w, qu, qd, qg, 1e-5, **kw)
            got, want = run(), plain()
            err, tol_ok = quant_mlp_close(got, want)
            names = (["dropped_ln_b", "rmsnorm_for_layernorm"] if norm == "layernorm" else []) + \
                (["gate_read_on_plain"] if not gated else []) + \
                (["gelu_new_as_relu"] if act == "gelu_new" else [])
            bites = {b: not quant_mlp_close(got, _b7_broken(h, ln_w, ln_b, qu, qd, qg, norm, act,
                                                            b))[1] for b in names}
            bites["w_down_scales_shifted"] = not quant_mlp_close(got, fused_mlp_quant_reference(
                h, h, ln_w, qu, _shifted_scales(qd), qg, 1e-5, **kw))[1]
            shape = dict(B=B, D=D, F=Fd, gs=qu.group_size, bits=str(bits), norm=norm,
                         gated=gated, activation=act, width=width)
            _check(tol_ok, f"fused quantized MLP kernel disagrees with its plain version at "
                   f"{shape}: max abs err {err.max().item()}")
            _check(all(bites.values()), f"the fused quantized MLP tolerance does not catch a "
                   f"broken plain version at {shape}: {bites}")
            twice = torch.equal(got, run())
            _check(twice, f"two runs of the fused quantized MLP differ at {shape}")
            fn = {"silu": F.silu, "relu": F.relu}.get(act, lambda x: F.gelu(x, approximate="tanh"))

            def deq_cublas():
                yn = (F.layer_norm(h, (D,), ln_w, ln_b, 1e-5) if norm == "layernorm" else
                      F.rms_norm(h, (D,), ln_w, 1e-5))
                u = yn @ qu.dequantize()
                a = fn(yn @ qg.dequantize()) * u if gated else fn(u)
                return h + a @ qd.dequantize()

            mats = [w for w in (qg, qu, qd) if w is not None]
            nbytes = sum(w.nbytes for w in mats) + 3 * B * D * 2 + 2 * D * 2
            b_ms, b_by = bound(nbytes, 2.0 * B * D * Fd * len(mats))
            row = dict(shape=shape, max_abs_err=err.max().item(),
                       max_rel_err=(err.max() / want.float().abs().max()).item(),
                       tolerance=QUANT_MLP_TOL, within=tol_ok, tolerance_bites=bites,
                       equal_bits_twice=twice)
            if (norm, gated, act, bits, width, B) in MQ_FIRST:   # BLOOM's form: timed
                row.update(ms=time_cold(run), host_us=host_us(run), plain_ms=time_plain(plain),
                           library_ms=time_cold(deq_cublas),
                           library="dequantize() + the cuBLAS sequence", bound_ms=b_ms,
                           bound_by=b_by)
                row["gbytes_per_s"] = nbytes / (row["ms"] * 1e-3) / 1e9
            rows.append(row)
            del h, got, want, err
    made.clear()
    torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# Phase 2f: the grouped GEMM of the MoE experts (B16)
# ---------------------------------------------------------------------------

GG_FORMATS = ("bf16", 8, "fp8")
# Mixtral-8x7B's expert matrices (K, F): w_gate / w_up, w_down; 8 experts
GG_SHAPES = [(4096, 14336), (14336, 4096)]
GG_E = 8
# a decode tick's rows at 1, 8 and 32 sequences x top-2 (64: the most the
# tensor-core GEMV takes), a tick's 256 chunk rows x top-2, and a put() of 8
# prompts of 1024 x top-2
GG_ROWS = [2, 16, 64, 512, 16384]
GG_PATTERNS = ("balanced", "one_expert", "empty_ends", "ragged")
# the (format, pattern) cells timed here: a routed batch's bf16, int8 and
# fp8 stacks (the others' times are scripts/torch_kernel_digest.py's sweeps section)
GG_TIMED = (("bf16", "ragged"), (8, "ragged"), ("fp8", "ragged"))


def group_pattern(pattern, N, E, rng):
    """Group sizes [E] summing to N: ``balanced`` (N // E each, the rest
    on the first experts), ``one_expert`` (all rows on expert 3),
    ``empty_ends`` (experts 0 and E - 1 empty, the rows spread at random
    over the others) or ``ragged`` (spread at random over all)."""
    if pattern == "balanced":
        sizes = np.full(E, N // E)
        sizes[:N % E] += 1
    elif pattern == "one_expert":
        sizes = np.zeros(E, np.int64)
        sizes[3] = N
    elif pattern == "empty_ends":
        sizes = np.zeros(E, np.int64)
        sizes[1:E - 1] = rng.multinomial(N, np.full(E - 2, 1 / (E - 2)))
    else:
        sizes = rng.multinomial(N, rng.dirichlet(np.ones(E)))
    return sizes.astype(np.int32)


def _moved_boundary(sizes):
    """Broken group sizes (numpy in, numpy out): the first row of the
    second non-empty group handed to the first."""
    bad = sizes.copy()
    g, h = np.flatnonzero(bad)[:2]
    bad[g] += 1
    bad[h] -= 1
    return bad


def _shifted_expert_scales(qm):
    """A broken expert stack: every scale row moved down one group along K."""
    from shuffle_exchange_tpu_torch.ops.quant_matmul import QuantizedMatrix

    return QuantizedMatrix(qm.q, qm.scales.roll(1, -2), qm.group_size, qm.dtype, qm.bits,
                           qm.n_cols)


def _library_grouped(x, w, sizes):
    """(callable, name) of the library yardstick: ``torch._grouped_mm``
    over the bf16 stack where this torch has it, else a per-expert cuBLAS
    loop (group sizes read once on the host, outside the timing)."""
    import torch

    offs = torch.cumsum(sizes, 0).to(torch.int32)
    if hasattr(torch, "_grouped_mm"):
        for form in (w, w.transpose(1, 2).contiguous().transpose(1, 2)):
            try:
                torch._grouped_mm(x, form, offs=offs, out_dtype=torch.bfloat16)
                torch.cuda.synchronize()
                return (lambda f=form: torch._grouped_mm(x, f, offs=offs,
                                                         out_dtype=torch.bfloat16)), \
                    "torch._grouped_mm"
            except (RuntimeError, TypeError, ValueError):
                continue
    bounds = np.concatenate([[0], np.cumsum(sizes.tolist())])

    def loop():
        return [x[a:b] @ w[g] for g, (a, b) in enumerate(zip(bounds[:-1], bounds[1:])) if b > a]

    return loop, "per-expert cuBLAS loop"


def check_grouped_gemm(gen, rng, timed=True):
    """B16 against its plain version (a per-group loop of f32 products over
    the weights as the kernel reads them) for bf16, int8 and fp8 expert
    stacks at group 256, on Mixtral's two expert shapes with 8 experts, at
    GG_ROWS rows in each of GG_PATTERNS. At each format's first balanced
    case of 16 rows (the decode rows' tensor-core GEMV) and of 512 rows (the
    wgmma forms) a plain version that hands a boundary row to the neighbouring
    expert, and (quantized) one with the scale rows shifted by one group,
    must fail the tolerance, and two runs must give equal bits. With
    ``timed``, the GG_TIMED cells are timed beside their bound (the x rows,
    the bytes of the experts that have rows, the output; 2 N K F
    operations), the plain version and the library yardstick (dequantize +
    the library call for the quantized stacks)."""
    import torch

    from shuffle_exchange_tpu_torch.ops.grouped_gemm import (grouped_matmul,
                                                             grouped_matmul_reference)
    from shuffle_exchange_tpu_torch.ops.quant_matmul import quantize_weight

    rows = []
    with _f32_reduction():
        for K, F in GG_SHAPES:
            w16 = (torch.randn(GG_E, K, F, generator=gen, device="cuda") * K ** -0.5).bfloat16()
            for fmt in GG_FORMATS:
                w = w16 if fmt == "bf16" else quantize_weight(w16, 256, bits=fmt)
                expert_bytes = w.nbytes / GG_E if fmt != "bf16" else K * F * 2
                for N in GG_ROWS:
                    x = torch.randn(N, K, generator=gen, device="cuda").bfloat16()
                    for pattern in GG_PATTERNS:
                        sizes_np = group_pattern(pattern, N, GG_E, rng)
                        sizes = torch.from_numpy(sizes_np).cuda()
                        run = lambda: grouped_matmul(x, w, sizes)
                        plain = lambda: grouped_matmul_reference(x, w, sizes)
                        got, want = run(), plain()
                        torch.cuda.synchronize()
                        err, tol_ok = paged_close(got, want)
                        row = dict(shape=dict(N=N, K=K, F=F, E=GG_E, fmt=str(fmt),
                                              groups=pattern, sizes=sizes_np.tolist()),
                                   max_abs_err=err.max().item(),
                                   max_rel_err=(err.max() / want.float().abs().max()).item(),
                                   tolerance=PAGED_TOL + " per output row", within=tol_ok)
                        _check(tol_ok, f"grouped matmul kernel disagrees with its plain version "
                               f"at {row['shape']}: max abs err {row['max_abs_err']}")
                        # the bites and equal bits at each format's first balanced cell of
                        # the GEMV's rows (16) and of the wgmma forms' (512)
                        if N in (16, 512) and pattern == "balanced" and not any(
                                r["shape"]["fmt"] == str(fmt) and r["shape"]["N"] == N
                                and "tolerance_bites" in r for r in rows):
                            bites = {"boundary_row_moved": _bites(got, grouped_matmul_reference(
                                x, w, torch.from_numpy(_moved_boundary(sizes_np)).cuda()))}
                            if fmt != "bf16":
                                bites["scales_shifted"] = _bites(got, grouped_matmul_reference(
                                    x, _shifted_expert_scales(w), sizes))
                            row["tolerance_bites"] = bites
                            row["equal_bits_twice"] = torch.equal(got, run())
                            _check(all(bites.values()), f"the grouped matmul tolerance does not "
                                   f"catch a broken plain version: {bites}")
                            _check(row["equal_bits_twice"], "two runs of the grouped matmul "
                                   "differ")
                        if timed and (fmt, pattern) in GG_TIMED:
                            used = int((sizes_np > 0).sum())
                            nbytes = N * K * 2 + used * expert_bytes + N * F * 2
                            b_ms, b_by = bound(nbytes, 2.0 * N * K * F)
                            lib, lib_name = _library_grouped(x, w16, sizes)
                            if fmt != "bf16":
                                lib_q = lib
                                lib = lambda: (w.dequantize(), lib_q())
                                lib_name = "dequantize() + " + lib_name
                            iters = 5 if N > 1024 else 10
                            row.update(ms=time_cold(run, iters), host_us=host_us(run),
                                       plain_ms=time_plain(plain), library_ms=time_cold(lib, 3),
                                       library=lib_name, bound_ms=b_ms, bound_by=b_by)
                            row["gbytes_per_s"] = nbytes / (row["ms"] * 1e-3) / 1e9
                            row["tflops"] = 2.0 * N * K * F / (row["ms"] * 1e-3) / 1e12
                        rows.append(row)
                        del got, want, err
                    del x
                del w
                torch.cuda.empty_cache()
            del w16
            torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# Phase 2h: the grouped GEMM's backward (B16-dx, B16-dw)
# ---------------------------------------------------------------------------

# bench.py's _config3 expert matrices (K, F): w_gate / w_up [1024, 2816] and
# w_down [2816, 1024], at its training rows: 32 x 1023 tokens x top-2 =
# 65,472 sorted rows on the ragged route, 8 experts x capacity 10,230 on the
# capacity route; then Mixtral's expert matrices at a put()'s 16,384 rows
GB_CONFIG3 = [(1024, 2816), (2816, 1024)]
GB_RAGGED_N, GB_CAPACITY = 65472, 10230
GB_MIXTRAL = [(4096, 14336), (14336, 4096)]
GB_PATTERNS = GG_PATTERNS + ("past_sum",)


def _bwd_sizes(pattern, N, E, rng):
    """Group sizes: phase 2f's patterns, or "past_sum" (a ragged spread of
    N - 100 rows: the last 100 rows belong to no group)."""
    if pattern == "past_sum":
        return group_pattern("ragged", N - 100, E, rng)
    return group_pattern(pattern, N, E, rng)


def _library_bwd(which, a, b, sizes):
    """(callable, name) of the library yardstick for B16-dx / B16-dw:
    ``torch._grouped_mm`` on the same bf16 operands (dx: dout @ a transposed
    view of the stack; dw: the 2-D x 2-D form x^T, dout with offsets) where
    this torch takes them, else a per-expert cuBLAS loop (group sizes read
    once on the host, outside the timing)."""
    import torch

    offs = torch.cumsum(sizes, 0).to(torch.int32)
    if hasattr(torch, "_grouped_mm"):
        forms = ([(a, b.transpose(1, 2))] if which == "dx" else
                 [(a.T, b), (a.T.contiguous(), b)])
        for p, q in forms:
            try:
                torch._grouped_mm(p, q, offs=offs, out_dtype=torch.bfloat16)
                torch.cuda.synchronize()
                return (lambda p=p, q=q: torch._grouped_mm(p, q, offs=offs,
                                                           out_dtype=torch.bfloat16)), \
                    "torch._grouped_mm"
            except (RuntimeError, TypeError, ValueError):
                continue
    bounds = np.concatenate([[0], np.cumsum(sizes.tolist())])
    spans = [(g, lo, hi) for g, (lo, hi) in enumerate(zip(bounds[:-1], bounds[1:])) if hi > lo]
    if which == "dx":
        return (lambda: [a[lo:hi] @ b[g].T for g, lo, hi in spans]), "per-expert cuBLAS loop"
    return (lambda: [a[lo:hi].T @ b[lo:hi] for g, lo, hi in spans]), "per-expert cuBLAS loop"


def _bwd_cases():
    """(label, K, F, N, pattern) of phase 2h: the _config3 shapes at the
    ragged route's rows in every pattern and at the capacity route's equal
    groups, then Mixtral's shapes at 16,384 ragged rows; last two edge
    cells: 16 rows (the wgmma kernels take dx and dw at every row count)
    and K, F that are multiples of 8 but not of the kernels' tiles."""
    for K, F in GB_CONFIG3:
        for pattern in GB_PATTERNS:
            yield "config3 ragged", K, F, GB_RAGGED_N, pattern
        yield "config3 capacity", K, F, GG_E * GB_CAPACITY, "balanced"
    for K, F in GB_MIXTRAL:
        yield "mixtral", K, F, 16384, "ragged"
    yield "16 rows", 1024, 2816, 16, "ragged"
    yield "ragged tile edges", 1000, 1032, 4100, "past_sum"


def check_grouped_gemm_bwd(gen, rng, timed=True):
    """B16-dx and B16-dw against their plain versions (per-group loops of
    f32 products, one cast) in bf16 at ``_bwd_cases()``. Each cell is held
    to PAGED_TOL per output row; rows past the groups' sum must be exact
    zeros in dx and an empty group's dw block exact zeros. At each
    direction's first _config3 ragged cell, a plain version that hands a
    boundary row to the neighbouring expert must fail the tolerance, and
    two runs must give equal bits. With ``timed``, every cell is timed with
    a cold L2 beside its bound (2 N K F operations; the operands read once
    and the result written once), the plain version, the library yardstick
    and the host cost of one wrapper call."""
    import torch

    from shuffle_exchange_tpu_torch.ops.grouped_gemm import (grouped_matmul_dw,
                                                             grouped_matmul_dw_reference,
                                                             grouped_matmul_dx,
                                                             grouped_matmul_dx_reference)

    rows, bitten = [], set()
    with _f32_reduction():
        for label, K, F, N, pattern in _bwd_cases():
            sizes_np = _bwd_sizes(pattern, N, GG_E, rng)
            sizes = torch.from_numpy(sizes_np).cuda()
            x = torch.randn(N, K, generator=gen, device="cuda").bfloat16()
            w = (torch.randn(GG_E, K, F, generator=gen, device="cuda") * K ** -0.5).bfloat16()
            dout = torch.randn(N, F, generator=gen, device="cuda").bfloat16()
            summed = int(sizes_np.sum())
            used = int((sizes_np > 0).sum())
            for which in ("dx", "dw"):
                if which == "dx":
                    run = lambda: grouped_matmul_dx(dout, w, sizes)
                    plain = lambda s=sizes: grouped_matmul_dx_reference(dout, w, s)
                    nbytes = N * F * 2 + used * K * F * 2 + N * K * 2
                    lib, lib_name = _library_bwd("dx", dout, w, sizes)
                else:
                    run = lambda: grouped_matmul_dw(x, dout, sizes)
                    plain = lambda s=sizes: grouped_matmul_dw_reference(x, dout, s)
                    nbytes = summed * (K + F) * 2 + GG_E * K * F * 2
                    lib, lib_name = _library_bwd("dw", x, dout, sizes)
                got, want = run(), plain()
                torch.cuda.synchronize()
                err, tol_ok = paged_close(got, want)
                row = dict(shape=dict(which=which, label=label, N=N, K=K, F=F, E=GG_E,
                                      groups=pattern, sizes=sizes_np.tolist()),
                           max_abs_err=err.max().item(),
                           max_rel_err=(err.max() / want.float().abs().max()).item(),
                           tolerance=PAGED_TOL + " per output row", within=tol_ok)
                _check(tol_ok, f"grouped_matmul_{which} kernel disagrees with its plain version "
                       f"at {row['shape']}: max abs err {row['max_abs_err']}")
                if which == "dx" and summed < N:
                    row["rows_past_sum_zero"] = not got[summed:].any().item()
                    _check(row["rows_past_sum_zero"], "dx rows past the groups' sum not zero")
                if which == "dw" and used < GG_E:
                    row["empty_groups_zero"] = not got[torch.from_numpy(sizes_np == 0).cuda()
                                                       ].any().item()
                    _check(row["empty_groups_zero"], "dw blocks of empty groups not zero")
                if label == "config3 ragged" and which not in bitten:
                    bitten.add(which)
                    broken = torch.from_numpy(_moved_boundary(sizes_np)).cuda()
                    row["tolerance_bites"] = {"boundary_row_moved": _bites(got, plain(broken))}
                    row["equal_bits_twice"] = torch.equal(got, run())
                    _check(all(row["tolerance_bites"].values()), f"the grouped_matmul_{which} "
                           f"tolerance does not catch a broken plain version")
                    _check(row["equal_bits_twice"], f"two runs of grouped_matmul_{which} differ")
                if timed:
                    b_ms, b_by = bound(nbytes, 2.0 * summed * K * F)
                    row.update(ms=time_cold(run, 5), host_us=host_us(run),
                               plain_ms=time_plain(plain), library_ms=time_cold(lib, 3),
                               library=lib_name, bound_ms=b_ms, bound_by=b_by)
                    row["tflops"] = 2.0 * summed * K * F / (row["ms"] * 1e-3) / 1e12
                rows.append(row)
                del got, want, err
            del x, w, dout
            torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# Phase 2g: the per-row LoRA delta of multi-tenant serving (B9)
# ---------------------------------------------------------------------------

# Llama-3-8B's adapted projections: D 4096 in, N 4096 out (wq, wo) or 1024
# (wk, wv); pool ranks 8 (the row kernel's at one-token rows), 16 and 64; pools of 4
# and 64 slots plus the null slot
LORA_D = 4096
LORA_N = (4096, 1024)
LORA_R = (8, 16, 64)
LORA_S = (5, 65)
# (B, T): one decode row, a decode tick's 8 rows (null rows and repeated
# slots), a tick's chunk rows and a put() of 8 prompts padded to 1024
LORA_ROWS = [(1, 1), (8, 1), (2, 256), (8, 1024)]


def lora_slots(B, S):
    """The rows' slots: one adapter for one row; for 8 rows two null rows
    and repeated slots, the pool's last slot included."""
    if B == 1:
        return [1]
    if B == 2:
        return [1, S - 1]
    return [0, 1, S - 1, 1, 0, 2, S - 1, 3]


def _lora_mid_bf16(x, a, b, slots):
    """A broken plain version: the middle product rounded to bf16 (the
    Punica form) before the second product."""
    import torch

    idx = slots.long()
    mid = torch.bmm(x.float(), a[idx].float()).bfloat16().float()
    return torch.bmm(mid, b[idx].float()).to(x.dtype)


def lora_bound(B, T, D, R, N, slots):
    """The least time for the call's work (ms, and what bounds it): x of
    the rows that name an adapter read once, every output row written
    once, the factors of the distinct slots they name read once; both
    products' operations (2 T (D + N) R a row that names an adapter) at
    the bf16 tensor-core rate, whatever unit computes them (the same work
    priced alike for every kernel)."""
    used = [s for s in slots if s != 0]
    rows = len(used) * T
    nbytes = rows * D * 2 + B * T * N * 2 + len(set(used)) * (D * R + R * N) * 2 + B * 4
    return bound(nbytes, 2.0 * rows * (D + N) * R)


def check_lora_gemm(gen, ranks=LORA_R, pools=LORA_S, row_shapes=LORA_ROWS):
    """B9 against its plain version (gather, f32 products, f32 mid) in bf16
    at every (rows, N, R, S) of ``row_shapes``, LORA_N, ``ranks`` and
    ``pools`` (phase 2g: the LORA_* lists; phase 2p: the ranks above 64,
    on the tensor-core pair at every row shape): the serving kernels'
    tolerance per output
    row, null rows exactly 0, equal bits twice, and at 8 rows each row of
    the mixed call bit-equal to a call of that row alone. At each shape of
    the first pool at N 4096 a plain version that reads slot s + 1 must
    fail the tolerance, and so must one that rounds mid to bf16 (the
    Punica form; the kernels carry mid as two bf16 terms). Every cell is
    timed beside its bound, the plain version, the library sequence it
    replaces (gather + two ``torch.bmm`` in bf16; no single PyTorch call
    computes it) and the host us of one wrapper call."""
    import torch

    from shuffle_exchange_tpu_torch.ops.lora_gemm import lora_delta, lora_delta_reference

    rows = []
    with _f32_reduction():
        for S in pools:
            for R in ranks:
                for N in LORA_N:
                    a = (torch.randn(S, LORA_D, R, generator=gen, device="cuda")
                         * LORA_D ** -0.5).bfloat16()
                    b = (torch.randn(S, R, N, generator=gen, device="cuda") * R ** -0.5).bfloat16()
                    a[0].zero_()
                    b[0].zero_()
                    for B, T in row_shapes:
                        sl = lora_slots(B, S)
                        slots = torch.tensor(sl, dtype=torch.int32, device="cuda")
                        x = torch.randn(B, T, LORA_D, generator=gen, device="cuda").bfloat16()
                        run = lambda: lora_delta(x, a, b, slots)
                        plain = lambda: lora_delta_reference(x, a, b, slots)
                        got, want = run(), plain()
                        torch.cuda.synchronize()
                        err, tol_ok = paged_close(got, want)
                        null = [i for i, s_ in enumerate(sl) if s_ == 0]
                        row = dict(shape=dict(B=B, T=T, D=LORA_D, R=R, N=N, S=S, slots=sl),
                                   max_abs_err=err.max().item(),
                                   max_rel_err=(err.max() / want.float().abs().max()).item(),
                                   tolerance=PAGED_TOL + " per output row; null rows exactly 0",
                                   within=tol_ok,
                                   null_rows_zero=all(bool((got[i] == 0).all()) for i in null),
                                   equal_bits_twice=torch.equal(got, run()))
                        _check(tol_ok, f"lora delta kernel disagrees with its plain version at "
                               f"{row['shape']}: max abs err {row['max_abs_err']}")
                        _check(row["null_rows_zero"], f"lora delta: a null row is not exactly 0 "
                               f"at {row['shape']}")
                        _check(row["equal_bits_twice"], f"two runs of the lora delta differ at "
                               f"{row['shape']}")
                        if B == 8:
                            row["rows_equal_solo"] = all(
                                torch.equal(got[i], lora_delta(x[i:i + 1], a, b, slots[i:i + 1])[0])
                                for i in range(B))
                            _check(row["rows_equal_solo"], f"a row of the mixed lora call differs "
                                   f"from the row alone at {row['shape']}")
                        if S == pools[0] and N == LORA_N[0]:
                            next_slot = lora_delta_reference(x, a, b, (slots + 1) % S)
                            mid_bf16 = _lora_mid_bf16(x, a, b, slots)
                            bites = {"slot_plus_one": _bites(got, next_slot),
                                     "mid_rounded_bf16": _bites(got, mid_bf16)}
                            row["tolerance_bites"] = bites
                            _check(bites["slot_plus_one"], "the lora tolerance does not catch a "
                                   "plain version reading the next slot")
                            _check(bites["mid_rounded_bf16"], "the lora tolerance does not catch "
                                   f"a plain version rounding mid to bf16 at {row['shape']}")
                        b_ms, b_by = lora_bound(B, T, LORA_D, R, N, sl)
                        idx = slots.long()
                        seq = lambda: torch.bmm(torch.bmm(x, a[idx]), b[idx])
                        iters = 5 if B * T > 1024 else 10
                        row.update(ms=time_cold(run, iters), host_us=host_us(run),
                                   plain_ms=time_plain(plain), library_ms=None,
                                   library_sequence_ms=time_cold(seq, 3),
                                   library="none (gather + two torch.bmm in bf16 timed as "
                                           "library_sequence_ms)",
                                   bound_ms=b_ms, bound_by=b_by)
                        rows.append(row)
                        del x, got, want, err
                    del a, b
            torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# Phase 3: serve Llama-3-8B through the scheduler
# ---------------------------------------------------------------------------

SERVE_CONFIG = dict(dtype="bfloat16", max_seq_len=2048, kv_block_size=64, num_kv_blocks=160,
                    decode_kernel="auto", serving={"token_budget": 256, "max_running": 8})
XLA_CONFIG = dict(SERVE_CONFIG, decode_kernel="xla")
N_PROMPTS, MAX_NEW = 8, 32


def serve(model, params, rng, device=None, config=SERVE_CONFIG, n_prompts=N_PROMPTS,
          max_new=MAX_NEW, prompt_range=(128, 1024), engine=None):
    """One serve of ``n_prompts`` random prompts through the scheduler, on
    ``engine`` or a new engine. Returns (tokens by uid, scheduler, engine,
    host seconds of each tick by program); every tick's logits are checked
    finite and of the expected shape on the way."""
    from shuffle_exchange_tpu_torch.inference import (ContinuousBatchingScheduler,
                                                      InferenceConfig, InferenceEngineV2)

    V = model.config.vocab_size
    eng = engine or InferenceEngineV2(model, params, InferenceConfig(**config), device=device)
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


QGMM_KIND = "grouped_matmul (B16 int8 / fp8, wgmma)"   # wg_qgmm_kernel's kind in a trace
QMM_KIND = "quant_matmul (B8 past its decode rows, wgmma)"   # wg_qmatmul_kernel's
B8_GEMV_KIND = "quant_matmul (B8 decode rows, tensor-core GEMV)"   # mma_gemv_quant_kernel's
LORA_SHRINK_KIND = "lora_delta (B9 shrink, tensor cores)"
LORA_EXPAND_KIND = "lora_delta (B9 expand, tensor cores)"
GEMV_KIND = "grouped_matmul (B16 decode rows, tensor-core GEMV)"   # mma_gemv_grouped_kernel's
B7_KIND = "fused_mlp_quant (B7, tensor-core GEMV)"   # mma_gemv_mlp_up / _down_kernel's
B6_KIND = "fused_mlp (B6, tensor-core GEMV)"         # their bf16 instances (format code 3)


def _kernel_kind(name: str) -> str:
    low = name.lower()
    # the ALiBi instances' names contain the dense ones' (wg_fwd_kernel, ...):
    # they come first (alibi_wg_dkv: the dk/dv pass at 128 and its key split at 64)
    for key, kind in (("alibi_wg_fwd_kernel", "alibi_flash_attention (B11)"),
                      ("alibi_wg_dq_kernel", "alibi dq (B12)"),
                      ("alibi_wg_dkv", "alibi dk/dv (B13)"),
                      ("flash_bwd_delta_kernel", "attention delta (flash and ALiBi backward)"),
                      ("wg_fwd_kernel", "flash_attention (wgmma forward)"),
                      ("wg_dkv_kernel", "flash_attention_bwd (wgmma dk/dv)"),
                      ("wg_dkv_keys_kernel", "flash_attention_bwd (wgmma dk/dv)"),
                      ("wg_dq_kernel", "flash_attention_bwd (wgmma dq)"),
                      ("flash_fwd_kernel", "flash_attention"),
                      ("flash_bwd_", "flash_attention_bwd"),
                      ("fused_adamw_kernel", "fused_adamw"),
                      ("mma_gemv_grouped_kernel", GEMV_KIND),
                      ("mma_gemv_quant_kernel", B8_GEMV_KIND),
                      # B6's instances are B7's kernels at format 3 (bf16): first
                      ("mma_gemv_mlp_up_kernel<3,", B6_KIND),
                      ("mma_gemv_mlp_down_kernel<3>", B6_KIND),
                      ("mma_gemv_mlp_", B7_KIND),
                      ("wg_qgmm_kernel", QGMM_KIND),
                      ("wg_gmm_kernel<true>", "grouped_matmul_dx (B16-dx, wgmma)"),
                      ("wg_gmm_kernel", "grouped_matmul (B16 bf16, wgmma)"),
                      ("wg_tgmm_kernel", "grouped_matmul_dw (B16-dw, wgmma)"),
                      ("lora_row_kernel", "lora_delta (B9 decode rows)"),
                      ("lora_shrink_kernel", LORA_SHRINK_KIND),
                      ("lora_expand_kernel", LORA_EXPAND_KIND),
                      ("gemv_partial_kernel", "fused_qkv_rope (B4 products)"),
                      ("wg_qmatmul_kernel", QMM_KIND),
                      ("quant_out_kernel", QMM_KIND),
                      ("qkv_epilogue_kernel", "fused_qkv_rope"),
                      ("group_decode_kernel", "fused_paged_decode_attention"),
                      ("group_merge_kernel", "fused_paged_decode_attention (merge)"),
                      ("paged_decode_kernel", "paged_decode_attention"),
                      ("paged_decode_merge_kernel", "paged_decode_attention (merge)"),
                      ("paged_extend_kernel", "paged_extend_attention"),
                      ("rmsnorm_kernel", "rmsnorm")):
        if key in low:
            return kind
    if any(k in low for k in ("gemm", "gemv", "nvjet", "cutlass", "xmma", "cublas")):
        return "matmul"
    if "memcpy" in low or "memset" in low:
        return "copy"
    return "other"


def weight_bytes(params) -> int:
    """Bytes the engine's weights hold on the device (quantized storage and
    its scales included)."""
    from shuffle_exchange_tpu_torch.ops.quant_matmul import QuantizedMatrix

    return sum(v.nbytes if isinstance(v, QuantizedMatrix) else v.numel() * v.element_size()
               for v in params.values())


def trace_serve(model, params, rng, config=SERVE_CONFIG):
    """Device time by kernel kind over a short profiled serve (4 requests
    of 128-512 prompt tokens, 8 new tokens each), against the wall time of
    the window; the engine (and a quantized engine's quantization) is made
    before the window opens. The profiler's own host overhead lengthens
    the window, so the idle share it gives is an upper bound."""
    from shuffle_exchange_tpu_torch.inference import InferenceConfig, InferenceEngineV2

    out = {}
    eng = InferenceEngineV2(model, params, InferenceConfig(**config))

    def run():
        out["sched"] = serve(model, params, rng, n_prompts=4, max_new=8,
                             prompt_range=(128, 512), engine=eng)[1]

    summary = profiled(run)
    return summary and dict(summary, ticks=out["sched"].ticks)


def profiled(fn, top_other: int = 0):
    """Run ``fn`` under ``torch.profiler``; device busy ms (the union of
    the kernels' intervals), the window's wall ms, the idle share (an
    upper bound: the profiler lengthens the window) and device ms by
    kernel kind; with ``top_other`` the largest kernels of kind "other" by
    name. None when no device kernel was recorded."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans, by_kind, other = [], {}, {}
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        start, end = ev.time_range.start, ev.time_range.end
        spans.append((start, end))
        name = _kernel_kind(ev.name)
        kind = by_kind.setdefault(name, {"us": 0.0, "count": 0})
        kind["us"] += end - start
        kind["count"] += 1
        if name == "other":
            o = other.setdefault(ev.name[:120], {"us": 0.0, "count": 0})
            o["us"] += end - start
            o["count"] += 1
    if not spans:
        return None
    busy, last = 0.0, -math.inf
    for start, end in sorted(spans):           # union of the device intervals
        if end > last:
            busy += end - max(start, last)
            last = end
    out = {"wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
           "idle_share": 1 - busy / wall_us,
           "by_kind_ms": {k: v["us"] / 1e3 for k, v in sorted(by_kind.items())},
           "kernels_by_kind": {k: v["count"] for k, v in sorted(by_kind.items())}}
    if top_other:
        largest = sorted(other.items(), key=lambda kv: -kv[1]["us"])[:top_other]
        out["other_top_ms"] = [[n, v["us"] / 1e3, v["count"]] for n, v in largest]
    return out


def expected_launches(eng, n_layers, loop_steps=0, by=None):
    """Launches per kernel that the paged engine's programs imply. Chunk
    and prefill rows norm every layer twice and the final rows once;
    chunk rows run the extend kernel in every layer, prefill rows the
    flash kernel. Decode rows (a decode program, a mixed one, or each of
    ``loop_steps`` steps of ``decode_loop``), fused: ln1 in every layer and
    the final norm, and each fused kernel once a layer; else like chunk
    rows, with the paged decode kernel. Quantized weights: every matmul of
    chunk and prefill rows is the quantized matmul (7 a layer for a gated
    MLP, 6 for a plain one); fused decode rows take it for q, k, v and wo,
    the split-K attention and the quantized fused MLP (the fused QKV kernel
    steps aside), unfused ones for every matrix. A quantized MLP with fc
    biases (BLOOM, GPT-2) stays on the layer body, as in JAX: the quantized
    matmul for w_up and w_down on every row, no fused MLP. Layernorm models
    launch no RMSNorm; an ALiBi model's prefill
    rows run B11 in place of the flash kernel, and an MLP that does not
    fuse (GPT-2's exact gelu) stays on the layer body. An MoE model's FFN runs three grouped-GEMM launches a layer on
    every row kind and never fuses (ln2 is its own RMSNorm); quantized,
    only q, k, v and wo take the quantized matmul. With the adapter pool
    on, every row kind runs the LoRA delta once per adapted projection a
    layer, and decode rows leave the fused QKV kernel (the rest of the
    fused path stays). ``by``: dispatches by program (default: the
    engine's since it was made)."""
    by = eng.dispatches_by_program if by is None else by
    L = n_layers
    dec = by.get("decode", 0) + by.get("mixed", 0) + loop_steps
    ext = by.get("extend", 0) + by.get("mixed", 0)
    pre = by.get("prefill", 0)
    mcfg = eng._mcfg
    fused = eng._decode_kernel == "pallas"
    quant = eng.config.quantize_weights
    moe = mcfg.n_experts > 0
    gated = mcfg.activation == "swiglu"
    n_mlp = 3 if gated else 2
    fused_mlp = (fused and eng._fuse_mlp
                 and not (quant and mcfg.mlp_bias and not gated))   # JAX's routing
    lora = eng.adapters is not None
    rms = mcfg.norm == "rmsnorm"               # layernorm is plain PyTorch, as in JAX
    alibi = mcfg.position == "alibi"           # the prefill takes B11
    out = {"rmsnorm": ((2 * L + 1) * (ext + pre) + (L + 1 if fused_mlp else 2 * L + 1) * dec
                       if rms else 0),
           "paged_decode_attention": 0 if fused else L * dec,
           "paged_extend_attention": L * ext, "flash_attention": 0 if alibi else L * pre,
           "fused_paged_decode_attention": L * dec if fused else 0,
           "fused_qkv_rope": L * dec if fused and eng._fuse_qkv and not quant and not lora else 0,
           "fused_mlp": L * dec if fused_mlp and not quant else 0,
           "fused_mlp_quant": L * dec if fused_mlp and quant else 0,
           "grouped_matmul": 3 * L * (dec + ext + pre) if moe else 0,
           "lora_delta": (len(eng.config.adapters.targets) * L * (dec + ext + pre)
                          if lora else 0)}
    if not quant:
        out["quant_matmul"] = 0
    elif moe:
        out["quant_matmul"] = 4 * L * (dec + ext + pre)
    else:
        out["quant_matmul"] = ((4 if fused_mlp else 4 + n_mlp) * L * dec
                               + (4 + n_mlp) * L * (ext + pre))
    # the training step's
    out.update(flash_attention_bwd=0, fused_adamw=0, grouped_matmul_dx=0, grouped_matmul_dw=0,
               alibi_flash_attention=L * pre if alibi else 0, alibi_flash_attention_bwd=0)
    return out


def counted_serve(model, params, rng, config, n_layers, card, label=None,
                  prompt_range=(128, 1024)):
    """One serve with every launch counter zeroed just before and read
    just after; the counts must equal what the programs imply."""
    import torch

    from shuffle_exchange_tpu_torch import ops
    from shuffle_exchange_tpu_torch.inference import InferenceConfig, InferenceEngineV2

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = InferenceEngineV2(model, params, InferenceConfig(**config))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out, sched, eng, tick_s = serve(model, params, rng, config=config, engine=eng,
                                    prompt_range=prompt_range)
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
    label = label or config["decode_kernel"]
    print(f"[serve {label}] engine made in {init_s:.2f} s; resolved {eng._decode_kernel}: "
          f"{N_PROMPTS} requests x {MAX_NEW} new tokens in {seconds:.2f} s: ticks={stats['ticks']} "
          f"programs={dict(eng.dispatches_by_program)} preemptions={stats['preemptions']} "
          f"tok/s={stats['sustained_tokens_per_sec']} ttft_p50_s={stats['ttft_p50_s']} "
          f"ttft_p95_s={stats['ttft_p95_s']} tpot_p50_s={stats['tpot_p50_s']} "
          f"tpot_p95_s={stats['tpot_p95_s']} launches={launches} "
          f"peak_mem_GiB={torch.cuda.max_memory_allocated() / 2**30:.2f} on {card}", flush=True)
    if stats["moe"] is not None:
        print(f"[serve {label}] moe: {json.dumps(stats['moe'])}", flush=True)
    print(f"[serve {label}] host ms per tick by program: {json.dumps(tick_ms)}", flush=True)
    return dict(stats, seconds=seconds, init_s=init_s, launches=launches,
                resolved=eng._decode_kernel,
                programs=dict(eng.dispatches_by_program), tick_ms=tick_ms, tokens=out,
                weight_bytes=weight_bytes(eng.params))


# ---------------------------------------------------------------------------
# Phases 3b and 3c: put() / decode_loop, and the v1 generate
# ---------------------------------------------------------------------------

LOOP_STEPS = 31


def loop_prompts(rng, V, n=N_PROMPTS, longest=1024):
    """``n`` prompts of 128-``longest`` tokens, the first exactly ``longest``:
    at 1024 the longest sequence needs 17 blocks of 64 from the first decode
    step to the last (16 at GPT-2's 960), so ``decode_loop`` and the
    single-token ``put()`` loop see the same block-table width (32; 16) and
    launch identical programs."""
    lens = np.concatenate([[longest], rng.integers(128, longest + 1, size=n - 1)])
    return [rng.integers(1, V, size=int(L)).tolist() for L in lens]


def put_decode_loop(model, params, prompts, n_layers, card, config=SERVE_CONFIG, label="put",
                    setup=None):
    """3b: one ``put()`` of every prompt (one batched prefill program),
    then ``decode_loop`` of LOOP_STEPS steps, with the launch counters
    zeroed just before and read just after; they must equal what the
    programs imply. The tokens must equal LOOP_STEPS single-token
    ``put()`` calls on a second engine. ``setup(engine)``, when given,
    prepares each engine first (3f: registers adapters and binds the
    uids)."""
    import torch

    from shuffle_exchange_tpu_torch import ops
    from shuffle_exchange_tpu_torch.inference import InferenceConfig, InferenceEngineV2

    V = model.config.vocab_size
    uids = list(range(len(prompts)))
    eng = InferenceEngineV2(model, params, InferenceConfig(**config))
    _check(eng._decode_kernel == "pallas", "decode_kernel auto did not resolve to the fused "
           "kernels on the card")
    if setup is not None:
        setup(eng)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    logits = eng.put(uids, prompts)                 # host array: synchronised
    prefill_s = time.perf_counter() - t0
    first = [int(t) for t in logits.argmax(-1)]
    t0 = time.perf_counter()
    toks = eng.decode_loop(uids, first, LOOP_STEPS)
    loop_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    _check(logits.shape == (len(uids), V) and np.isfinite(logits).all(),
           f"put() logits {logits.shape} not finite or not [{len(uids)}, {V}]")
    _check(toks.shape == (len(uids), LOOP_STEPS) and ((0 <= toks) & (toks < V)).all(),
           f"decode_loop tokens {toks.shape} out of shape or range")
    want = expected_launches(eng, n_layers, loop_steps=LOOP_STEPS)
    _check(launches == want, f"put/decode_loop launch counts {launches} != implied {want}")
    bs, longest = eng.cache.block_size, max(len(p) for p in prompts)
    tpad = min(max(bs, 1 << (longest - 1).bit_length()), eng.config.max_seq_len)
    width = eng._binned_width(-(-(longest + LOOP_STEPS) // bs))
    _check(eng.program_shapes == {("prefill", len(uids), tpad),
                                  ("decode_loop", len(uids), LOOP_STEPS, width)},
           f"put/decode_loop programs {sorted(eng.program_shapes)}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    programs = sorted(eng.program_shapes)
    moe = (dict(dispatched=eng.moe_dispatched, dropped=eng.moe_dropped,
                expert_load_max=eng.moe_expert_load_max) if eng._moe_serving else None)
    del eng

    ref = InferenceEngineV2(model, params, InferenceConfig(**config))
    if setup is not None:
        setup(ref)
    ref_first = [int(t) for t in ref.put(uids, prompts).argmax(-1)]
    nxt, host = ref_first, []
    for _ in range(LOOP_STEPS):
        nxt = [int(t) for t in ref.put(uids, [[t] for t in nxt]).argmax(-1)]
        host.append(nxt)
    host = np.asarray(host, np.int32).T
    _check(ref_first == first and np.array_equal(toks, host),
           f"decode_loop tokens differ from the single-token put() loop in "
           f"{int((toks != host).sum())} of {toks.size} places")
    del ref
    n_tok = sum(len(p) for p in prompts)
    out = dict(prompt_tokens=n_tok, prefill_ms=prefill_s * 1e3,
               prefill_tokens_per_s=n_tok / prefill_s,
               decode_loop_ms_per_step=loop_s * 1e3 / LOOP_STEPS,
               decode_loop_tokens_per_s=len(uids) * LOOP_STEPS / loop_s, launches=launches,
               programs=programs, equal_to_put_loop=True, tokens=toks.tolist(), moe=moe)
    print(f"[{label}] {len(uids)} prompts, {n_tok} tokens: prefill {out['prefill_ms']:.1f} ms "
          f"({out['prefill_tokens_per_s']:.0f} tok/s); decode_loop {LOOP_STEPS} steps "
          f"{out['decode_loop_ms_per_step']:.2f} ms/step "
          f"({out['decode_loop_tokens_per_s']:.1f} tok/s); tokens equal to {LOOP_STEPS} "
          f"single-token put() calls; launches={launches}; peak_mem_GiB={peak:.2f}"
          f"{'' if moe is None else f'; moe={json.dumps(moe)}'} on {card}", flush=True)
    return out


def trace_put_decode_loop(model, params, prompts, n_steps=8, config=SERVE_CONFIG):
    """Device time by kernel kind over a profiled ``put()`` of ``prompts``
    and a ``decode_loop`` of ``n_steps`` steps on a fresh engine, made
    before the window opens."""
    from shuffle_exchange_tpu_torch.inference import InferenceConfig, InferenceEngineV2

    eng = InferenceEngineV2(model, params, InferenceConfig(**config))

    def run():
        first = [int(t) for t in eng.put(list(range(len(prompts))), prompts).argmax(-1)]
        eng.decode_loop(list(range(len(prompts))), first, n_steps)

    return profiled(run)


V1_CONFIG = {"dtype": "bfloat16", "max_seq_len": 2048}


def v1_generate(model, params, prompts, n_layers, card, max_new=LOOP_STEPS + 1,
                config=V1_CONFIG, label="v1 generate"):
    """3c: ``init_inference(model, params, config).generate`` on right-padded
    prompts, greedy, ``max_new`` tokens; the launch counters must equal
    what its prefill (flash kernel, or B11 for ALiBi) and decode steps
    (fused QKV without a pool, fused MLP where the model's MLP fuses; plain
    decode attention) imply. With quantized weights
    every prefill matmul is the quantized matmul (7 a layer; 6 for a plain
    MLP), and a decode step takes it for q, k, v and wo beside the
    quantized fused MLP, or for every matrix when the MLP has fc biases
    (BLOOM, GPT-2: the layer body, as in JAX)."""
    from shuffle_exchange_tpu_torch import init_inference, ops

    eng = init_inference(model, params, dict(config))
    _check(eng._decode_kernel == "pallas", "v1 decode_kernel auto did not resolve to the "
           "fused kernels on the card")
    T = max(len(p) for p in prompts)
    ids = np.zeros((len(prompts), T), np.int32)
    for i, p in enumerate(prompts):
        ids[i, :len(p)] = p
    lens = np.asarray([len(p) for p in prompts], np.int32)
    t0 = time.perf_counter()
    eng.generate(ids, prompt_lengths=lens, max_new_tokens=1)     # the prefill and head alone
    prefill_s = time.perf_counter() - t0
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = eng.generate(ids, prompt_lengths=lens, max_new_tokens=max_new)
    seconds = time.perf_counter() - t0
    launches = ops.launch_counts()
    V = model.config.vocab_size
    _check(out.shape == (len(prompts), max_new) and ((0 <= out) & (out < V)).all(),
           f"v1 generate tokens {out.shape} out of shape or range")
    L, steps = n_layers, max_new - 1
    want = {k: 0 for k in launches}
    quant = eng.config.quantize_weights
    mcfg = eng._mcfg
    gated = mcfg.activation == "swiglu"
    # the fused MLP on decode steps, unless quantized with fc biases (JAX's routing)
    mlp = eng._fuse_mlp and not (quant and mcfg.mlp_bias and not gated)
    if mcfg.norm != "rmsnorm":   # BLOOM / GPT-2: layernorm, B11 or B14 prefill, B4, maybe B6
        want.update({"alibi_flash_attention" if mcfg.position == "alibi" else
                     "flash_attention": L})
        if quant:   # B8 on every matrix but a fused MLP's; B4 steps aside
            n_mlp = 3 if gated else 2
            want.update(quant_matmul=(4 + n_mlp) * L + (4 if mlp else 4 + n_mlp) * L * steps,
                        fused_mlp_quant=L * steps if mlp else 0)
        else:   # B4 unless the QKV stays on the layer body (GPT-J's interleaved RoPE)
            want.update(fused_qkv_rope=L * steps if eng._fuse_qkv else 0,
                        fused_mlp=L * steps if mlp else 0)
    elif eng._mcfg.n_experts:     # the MoE FFN: three grouped GEMMs a layer, no fused MLP
        want.update(flash_attention=L, rmsnorm=(2 * L + 1) * (1 + steps),
                    grouped_matmul=3 * L * (1 + steps))
        if quant:
            want.update(quant_matmul=4 * L * (1 + steps))
        else:
            want.update(fused_qkv_rope=L * steps)
    elif quant:
        want.update(flash_attention=L, rmsnorm=(2 * L + 1) + (L + 1) * steps,
                    quant_matmul=7 * L + 4 * L * steps, fused_mlp_quant=L * steps)
    else:
        want.update(flash_attention=L, rmsnorm=(2 * L + 1) + (L + 1) * steps,
                    fused_qkv_rope=L * steps, fused_mlp=L * steps)
    _check(launches == want, f"v1 generate launch counts {launches} != implied {want}")
    step_ms = (seconds - prefill_s) * 1e3 / steps
    print(f"[{label}] {len(prompts)} x {max_new} tokens from prompts padded to {T} in "
          f"{seconds:.2f} s ({len(prompts) * max_new / seconds:.1f} tok/s); a 1-token "
          f"generate (prefill) {prefill_s * 1e3:.1f} ms, so {step_ms:.2f} ms a decode step; "
          f"launches={launches} on {card}", flush=True)
    return dict(seconds=seconds, tokens_per_s=len(prompts) * max_new / seconds,
                prefill_ms=prefill_s * 1e3, decode_step_ms=step_ms, launches=launches,
                tokens=out.tolist())


# ---------------------------------------------------------------------------
# Phase 3d: weight-quantized serving (quantize_weights int8 / int4 / fp8)
# ---------------------------------------------------------------------------

QUANT_SERVE = {bits: dict(SERVE_CONFIG, quantize_weights=True, quant_bits=bits)
               for bits in QUANT_FORMATS}


def quant_serving(model, params, prompts, n_layers, card, seed, bf16):
    """3d: a counted ``serve()`` of the phase-3 requests for each format
    with ``decode_kernel`` "auto" (which must resolve to the fused
    kernels), then int8 ``put()`` + ``decode_loop`` (tokens equal to the
    single-token ``put()`` loop) and the int8 v1 ``generate`` on the 3b
    prompts, a short profiled int8 serve and the int8 put()'s prefill
    program profiled alone. Each engine quantizes the
    dense bf16 weights on the card and is freed before the next; ``bf16``
    holds phase 3's results, to compare tokens and weight bytes with."""
    import torch

    from shuffle_exchange_tpu_torch.inference import InferenceConfig, InferenceEngineV2

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    out = {"serve": {}}
    dense_bytes = weight_bytes(params)
    for bits in QUANT_FORMATS:
        name = "fp8" if bits == "fp8" else f"int{bits}"
        r = counted_serve(model, params, np.random.default_rng([seed, 1]), QUANT_SERVE[bits],
                          n_layers, card, label=name)
        _check(r["resolved"] == "pallas", f"{name}: decode_kernel auto did not resolve to the "
               "fused kernels on the card")
        r["same_tokens_as_bf16"] = sum(r["tokens"][u] == bf16["tokens"][u] for u in r["tokens"])
        print(f"[serve {name}] weights {r['weight_bytes'] / 1e9:.3f} GB against "
              f"{dense_bytes / 1e9:.3f} GB in bf16 ({r['weight_bytes'] / dense_bytes:.3f}); "
              f"requests with tokens equal to the bf16 serve's: {r['same_tokens_as_bf16']} of "
              f"{N_PROMPTS}", flush=True)
        r["tokens"] = {int(u): t for u, t in r["tokens"].items()}
        out["serve"][name] = r
        free()
    out["dense_weight_bytes"] = dense_bytes
    out["put_decode_loop"] = put_decode_loop(model, params, prompts, n_layers, card,
                                             config=QUANT_SERVE[8], label="put int8")
    free()
    out["v1_generate"] = v1_generate(model, params, prompts, n_layers, card,
                                     config=dict(V1_CONFIG, **_quant(8)),
                                     label="v1 generate int8")
    free()
    out["trace"] = trace_serve(model, params, np.random.default_rng([seed, 4]),
                               QUANT_SERVE[8])
    print(f"[trace int8] {json.dumps(out['trace']) if out['trace'] else 'no device kernels'}",
          flush=True)
    free()
    out["trace_put_decode_loop"] = trace_put_decode_loop(model, params, prompts,
                                                         config=QUANT_SERVE[8])
    print(f"[trace put_decode_loop int8] {json.dumps(out['trace_put_decode_loop'])}", flush=True)
    # B7 runs on the decode rows only: its device ms a step of the window's 8
    t = out["trace_put_decode_loop"] or {}
    b7 = dict(launches=t.get("kernels_by_kind", {}).get(B7_KIND, 0),
              ms_per_step=t.get("by_kind_ms", {}).get(B7_KIND, 0.0) / 8, layers=n_layers)
    out["b7_decode"] = b7
    print(f"[trace put_decode_loop int8] B7 (the quantized fused MLP, tensor-core GEMV): "
          f"{b7['launches']} kernel launches over 8 decode steps at {n_layers} layers, "
          f"{b7['ms_per_step']:.4f} device ms a step ({b7['ms_per_step'] / n_layers:.4f} a "
          f"layer)", flush=True)
    # and B8's wq / wk / wv / wo at the 8 decode rows, on its own GEMV instance
    b8 = dict(launches=t.get("kernels_by_kind", {}).get(B8_GEMV_KIND, 0),
              ms_per_step=t.get("by_kind_ms", {}).get(B8_GEMV_KIND, 0.0) / 8, layers=n_layers)
    out["b8_decode"] = b8
    print(f"[trace put_decode_loop int8] B8 decode rows (tensor-core GEMV): {b8['launches']} "
          f"launches over 8 decode steps at {n_layers} layers, {b8['ms_per_step']:.4f} device "
          f"ms a step", flush=True)
    _check(b8["launches"] == 4 * n_layers * 8 and b7["launches"] == 2 * n_layers * 8,
           f"the int8 decode window did not launch B8's GEMV 4 times and B7's 2 kernels a "
           f"layer and step: {t.get('kernels_by_kind')}")
    free()
    # the int8 put() prefill program alone: B8's launches past 8 rows (7 a
    # layer, every matrix of the 8 x 1024 rows) and their device ms
    eng = InferenceEngineV2(model, params, InferenceConfig(**QUANT_SERVE[8]))
    uids = list(range(len(prompts)))
    out["trace_prefill"] = profiled(lambda: eng.put(uids, prompts), top_other=4)
    print(f"[trace_prefill int8] {json.dumps(out['trace_prefill'])}", flush=True)
    del eng
    free()
    return out


# ---------------------------------------------------------------------------
# Phase 3h: int8 and fp8 KV serving (kv_cache_dtype)
# ---------------------------------------------------------------------------

KV_FORMATS = ("int8", "fp8")
KV_SERVE = {fmt: dict(SERVE_CONFIG, kv_cache_dtype=fmt) for fmt in KV_FORMATS}


def pool_nbytes(cfg, config) -> dict:
    """The KV pool's bytes (scale planes included) in each kv_cache_dtype
    mode at an engine config's geometry (counted on meta tensors)."""
    import torch

    from shuffle_exchange_tpu_torch.inference.paged import PagedKVCache

    return {fmt: PagedKVCache.create(cfg.n_layers, config["num_kv_blocks"],
                                     config["kv_block_size"], cfg.kv_heads, cfg.head_dim,
                                     torch.bfloat16, "meta", kv_cache_dtype=fmt).pool_nbytes()
            for fmt in ("bf16",) + KV_FORMATS}


def kv_quant_serving(model, params, prompts, n_layers, card, seed, bf16, formats=KV_FORMATS,
                     decode_kernels=("auto", "xla"), config=SERVE_CONFIG, prompt_range=(128, 1024),
                     label="", trace=True):
    """3h: for each KV format a counted ``serve()`` of the phase-3 requests
    under each decode kernel ("auto" must resolve to the fused path, where
    B4 runs without a pool and the quantizing append writes the rows; "xla"
    runs B2), then ``put()`` + ``decode_loop`` (tokens equal to the
    single-token ``put()`` loop), the launch counters held to the programs
    each time; the pool bytes of bf16, int8 and fp8 at the serving
    geometry; and, with ``trace``, a profiled int8 decode window.
    ``bf16`` holds the bf16 serve's results, to compare tokens with."""
    import torch

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    out = {"serve": {}, "put_decode_loop": {},
           "pool_nbytes": pool_nbytes(model.config, config)}
    print(f"[kv {label}] pool bytes at {config['num_kv_blocks']} blocks of "
          f"{config['kv_block_size']}: {json.dumps(out['pool_nbytes'])}", flush=True)
    for fmt in formats:
        conf = dict(config, kv_cache_dtype=fmt)
        for dk in decode_kernels:
            r = counted_serve(model, params, np.random.default_rng([seed, 1]),
                              dict(conf, decode_kernel=dk), n_layers, card,
                              label=f"{label}{fmt} KV {dk}", prompt_range=prompt_range)
            _check(dk != "auto" or r["resolved"] == "pallas", f"{fmt} KV: decode_kernel auto "
                   "did not resolve to the fused kernels on the card")
            r["same_tokens_as_bf16"] = sum(r["tokens"][u] == bf16["tokens"][u]
                                           for u in r["tokens"])
            print(f"[serve {label}{fmt} KV {dk}] requests with tokens equal to the bf16-KV "
                  f"serve's: {r['same_tokens_as_bf16']} of {N_PROMPTS}", flush=True)
            r["tokens"] = {int(u): t for u, t in r["tokens"].items()}
            out["serve"][f"{fmt} {dk}"] = r
            free()
        out["put_decode_loop"][fmt] = put_decode_loop(model, params, prompts, n_layers, card,
                                                      config=conf, label=f"put {label}{fmt} KV")
        free()
    if trace:
        out["trace_decode"] = trace_decode_window(model, params, prompts,
                                                  config=dict(config, kv_cache_dtype="int8"))
        print(f"[trace {label}decode_loop int8 KV] "
              f"{json.dumps(out['trace_decode']) if out['trace_decode'] else 'no device kernels'}",
              flush=True)
        free()
    return out


# ---------------------------------------------------------------------------
# Phase 3f: multi-tenant LoRA serving (the adapter pool, B9)
# ---------------------------------------------------------------------------

# bench.py's serving_multi_tenant_row geometry: a pool of 4 slots of rank 8
# over wq and wv, 64 tenants registered, 24 requests of 64-512 prompt
# tokens and 32 new tokens, striped round-robin over 1, 8 and 64 adapters
MT_TARGETS = ("wq", "wv")
MT_RANK = 8
MT_CONFIG = dict(SERVE_CONFIG, adapters={"enabled": True, "slots": 4, "max_rank": MT_RANK,
                                         "targets": MT_TARGETS})
MT_REQUESTS, MT_NEW, MT_PROMPTS = 24, 32, (64, 512)
MT_STRIPES = (1, 8, 64)


def tenant_factors(mcfg, i, rank=MT_RANK, targets=MT_TARGETS, std=0.02, alpha=None):
    """Tenant i's (A, B) factors: std * N(0, 1) from ``default_rng(1000 +
    i)``, [L, d_in, rank] and [L, rank, d_out] f32 per target."""
    from shuffle_exchange_tpu_torch.inference.adapters import target_dims

    frng = np.random.default_rng(1000 + i)
    out = {}
    for t in targets:
        din, dout = target_dims(mcfg, t)
        out[t] = (std * frng.standard_normal((mcfg.n_layers, din, rank), dtype=np.float32),
                  std * frng.standard_normal((mcfg.n_layers, rank, dout), dtype=np.float32))
    return out


def multi_tenant_serving(model, params, prompts, n_layers, card, seed, stripes=MT_STRIPES,
                         config=MT_CONFIG, label="multi-tenant", put_loop=True):
    """3f: one engine (the pool's 4 slots, 64 tenants registered), the
    phase's 24 requests served closed-loop for each stripe of ``stripes``
    adapters: a warm serve, then the measured one with the launch
    counters zeroed just before and read just after (they must equal what
    its programs imply: B9 twice a layer and lane, no fused QKV on adapter
    rows). Every stripe must finish with no preemption and parks ==
    unparks, and the measured serves of the 8- and 64-adapter stripes add
    no program shape. Then, with ``put_loop``, ``put()`` of the 3b prompts
    under 8 distinct adapters + ``decode_loop`` (tokens equal to the
    single-token ``put()`` loop), its prefill program profiled (B9's
    tensor-core pair and its share) and one profiled decode window. Phase
    3i runs the 8-adapter stripe alone on BLOOM-1b7 (``config`` with
    ``quantize_weights`` for its int8 base)."""
    import torch

    from shuffle_exchange_tpu_torch import ops
    from shuffle_exchange_tpu_torch.inference import (ContinuousBatchingScheduler,
                                                      InferenceConfig, InferenceEngineV2)

    mcfg, V = model.config, model.config.vocab_size
    rng = np.random.default_rng([seed, 13])
    lo, hi = MT_PROMPTS
    reqs = [rng.integers(1, V, size=int(n)).tolist()
            for n in rng.integers(lo, hi + 1, size=MT_REQUESTS)]
    t0 = time.perf_counter()
    tenants = {f"tenant-{i:03d}": tenant_factors(mcfg, i) for i in range(max(stripes))}
    eng = InferenceEngineV2(model, params, InferenceConfig(**config))
    _check(eng._decode_kernel == "pallas", f"{label}: decode_kernel auto did not resolve "
           "to the fused kernels on the card")
    for aid, fac in tenants.items():
        eng.adapters.register(aid, fac)
    host_gb = sum(a.nbytes + b.nbytes for fac in tenants.values() for a, b in fac.values()) / 1e9
    pool_mb = sum(t.numel() * t.element_size()
                  for k in ("a", "b") for t in eng.adapters.device_operands()[k].values()) / 1e6
    print(f"[{label}] {len(tenants)} tenants registered ({host_gb:.2f} GB of f32 host "
          f"factors) over a {eng.adapters.slots}-slot pool of {pool_mb:.2f} MB in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    out = {"stripes": {}}
    for n in stripes:
        aids = [f"tenant-{i % n:03d}" for i in range(MT_REQUESTS)]
        t0 = time.perf_counter()
        ContinuousBatchingScheduler(eng).serve(reqs, max_new_tokens=MT_NEW, adapter_ids=aids)
        warm_s = time.perf_counter() - t0
        programs, pool0 = set(eng.program_shapes), eng.adapters.stats()
        by0 = dict(eng.dispatches_by_program)
        sched = ContinuousBatchingScheduler(eng)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        toks = sched.serve(reqs, max_new_tokens=MT_NEW, adapter_ids=aids)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = ops.launch_counts()
        st = sched.stats()
        by = {k: v - by0.get(k, 0) for k, v in eng.dispatches_by_program.items()}
        want = expected_launches(eng, n_layers, by=by)
        _check(launches == want, f"{label} {n}: launch counts {launches} != implied {want}")
        _check(len(toks) == MT_REQUESTS and all(len(t) == MT_NEW for t in toks.values()),
               f"{label} {n}: requests did not all finish with {MT_NEW} tokens")
        _check(all(0 <= t < V for ts in toks.values() for t in ts), "token out of range")
        ad = st["adapters"]
        _check(st["preemptions"] == 0 and ad["parks"] == ad["unparks"] and ad["pinned"] == 0,
               f"{label} {n}: preemptions {st['preemptions']}, parks {ad['parks']}, "
               f"unparks {ad['unparks']}, pinned {ad['pinned']}")
        new_programs = sorted(set(eng.program_shapes) - programs)
        if n > 1:
            _check(not new_programs, f"{label} {n}: the measured serve added program "
                   f"shapes {new_programs}")
        pool = {k: ad[k] - pool0[k] for k in ("hits", "misses", "evictions", "installs",
                                              "prefetch_hits", "prefetch_misses")}
        lookups = pool["hits"] + pool["misses"]
        r = dict(seconds=seconds, warm_seconds=warm_s, ticks=st["ticks"],
                 tokens_per_s=st["sustained_tokens_per_sec"], ttft_p50_s=st["ttft_p50_s"],
                 ttft_p95_s=st["ttft_p95_s"], tpot_p50_s=st["tpot_p50_s"],
                 tpot_p95_s=st["tpot_p95_s"], pool=pool,
                 pool_hit_rate=pool["hits"] / lookups if lookups else None,
                 parks=ad["parks"], unparks=ad["unparks"], preemptions=st["preemptions"],
                 programs=by, new_programs=new_programs, launches=launches)
        out["stripes"][n] = r
        print(f"[{label} {n} adapters] {MT_REQUESTS} requests x {MT_NEW} tokens in "
              f"{seconds:.2f} s (warm serve {warm_s:.2f} s): tok/s={r['tokens_per_s']} "
              f"ttft_p50/p95_s={r['ttft_p50_s']}/{r['ttft_p95_s']} "
              f"tpot_p50/p95_s={r['tpot_p50_s']}/{r['tpot_p95_s']} ticks={r['ticks']} "
              f"pool={json.dumps(pool)} hit_rate={r['pool_hit_rate']} parks={r['parks']} "
              f"unparks={r['unparks']} preemptions={r['preemptions']} "
              f"new_programs={new_programs} launches={launches} on {card}", flush=True)
    del eng, sched
    gc.collect()
    torch.cuda.empty_cache()
    if not put_loop:
        return out

    # put() + decode_loop under 8 distinct adapters, on a pool with a slot each
    put_cfg = dict(MT_CONFIG, adapters=dict(MT_CONFIG["adapters"], slots=len(prompts)))

    def setup(e):
        for i in range(len(prompts)):
            e.adapters.register(f"tenant-{i:03d}", tenants[f"tenant-{i:03d}"])
            e.configure_adapter(i, f"tenant-{i:03d}")

    out["put_decode_loop"] = put_decode_loop(model, params, prompts, n_layers, card,
                                             config=put_cfg, label="put adapters", setup=setup)
    gc.collect()
    torch.cuda.empty_cache()
    eng = InferenceEngineV2(model, params, InferenceConfig(**put_cfg))
    setup(eng)
    uids = list(range(len(prompts)))
    first = []
    # the put() prefill (B9's tensor-core pair on 8 x 1024 rows), then the
    # decode window (its row kernel), each profiled with B9's share
    prefill = profiled(lambda: first.extend(int(t) for t in eng.put(uids, prompts).argmax(-1)))
    eng.decode_loop(uids, first, 2)
    torch.cuda.synchronize()
    trace = profiled(lambda: eng.decode_loop(uids, first, 8))
    for what, t in (("trace_prefill", prefill), ("trace_decode_loop", trace)):
        if t:
            t["lora_share"] = sum(ms for kind, ms in t["by_kind_ms"].items()
                                  if kind.startswith("lora_delta")) / t["device_busy_ms"]
        out[what] = t
        print(f"[{what} adapters] {json.dumps(t) if t else 'no device kernels'}", flush=True)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Phase 3e: Mixtral-8x7B MoE serving, int8 experts and attention matrices
# ---------------------------------------------------------------------------

MOE_SERVE = dict(SERVE_CONFIG, quantize_weights=True, quant_bits=8,
                 serving=dict(SERVE_CONFIG["serving"], moe={"moe_impl": "ragged"}))
MOE_AUTO = dict(MOE_SERVE, serving=dict(SERVE_CONFIG["serving"], moe={"moe_impl": "auto"}))


def _seeded_storage(lead, K, N, std, gen, bits, device="cuda"):
    """A ``[*lead, K, N]`` QuantizedMatrix made slice by slice on the card:
    each ``[K, N]`` (one expert of one layer) drawn in bf16 from ``gen``
    and quantized at once by the port's ``quantize_weight`` (the function
    the engine's ``_quantize`` calls), so the bf16 stack never exists; the
    bytes are those the engine would make from the same bf16 weights."""
    import torch

    from shuffle_exchange_tpu_torch.ops.quant_matmul import QuantizedMatrix, quantize_weight

    q = scales = qm = None
    flat = int(np.prod(lead))
    for i in range(flat):
        w = (torch.randn(K, N, generator=gen, device=device) * std).bfloat16()
        qm = quantize_weight(w, 256, dtype=torch.bfloat16, bits=bits)
        if q is None:
            q = torch.empty(flat, *qm.q.shape, dtype=qm.q.dtype, device=device)
            scales = torch.empty(flat, *qm.scales.shape, dtype=torch.float32, device=device)
        q[i], scales[i] = qm.q, qm.scales
    return QuantizedMatrix(q.reshape(*lead, *q.shape[1:]),
                           scales.reshape(*lead, *scales.shape[1:]), qm.group_size,
                           torch.bfloat16, bits=bits, n_cols=N)


def mixtral_params(cfg, gen, bits=8, device="cuda"):
    """Seeded Mixtral-8x7B weights on the card with the JAX init's scales:
    the four attention matrices and the three expert stacks as ``bits``
    storage (``[L, K, N]`` and ``[L, E, K, N]``), the router, embedding,
    unembedding and norms in bf16. Returns (params, seconds)."""
    import torch

    from shuffle_exchange_tpu_torch.models import Transformer

    t0 = time.perf_counter()
    model = Transformer(cfg, device=device)
    L, E, D, Fd = cfg.n_layers, cfg.n_experts, cfg.d_model, cfg.ff_dim
    KVD = cfg.kv_heads * cfg.head_dim
    storage = {"layers.wq": ((L,), D, D), "layers.wk": ((L,), D, KVD),
               "layers.wv": ((L,), D, KVD), "layers.wo": ((L,), D, D),
               "layers.moe_w_gate": ((L, E), D, Fd), "layers.moe_w_up": ((L, E), D, Fd),
               "layers.moe_w_down": ((L, E), Fd, D)}
    params = {}
    for name, shape in model.param_shapes().items():
        scale = model._init_scale(name)
        if name in storage:
            lead, K, N = storage[name]
            params[name] = _seeded_storage(lead, K, N, scale, gen, bits, device)
        elif scale is None:
            params[name] = torch.full(shape, 1.0 if name.endswith("_w") else 0.0,
                                      dtype=torch.bfloat16, device=device)
        else:
            params[name] = (torch.randn(shape, generator=gen, device=device) * scale).bfloat16()
    torch.cuda.synchronize()
    return params, time.perf_counter() - t0


def mixtral_serving(cfg, seed, card, device="cuda"):
    """3e: Mixtral-8x7B at full width (``SERVE_LAYERS`` layers in the
    script) on one card, int8 experts
    and attention matrices: a counted ``serve()`` of the phase-3 requests
    with ``serving.moe.moe_impl`` "ragged" and "auto" (the capacity
    route), ``put()`` + ``decode_loop`` (tokens equal to the single-token
    ``put()`` loop) and the v1 ``generate`` (the capacity route), every
    engine over the one weight set, then a short profiled ragged serve.
    ``device`` is for a rehearsal at a tiny size on the CPU."""
    import torch

    from shuffle_exchange_tpu_torch.inference import InferenceConfig, InferenceEngineV2
    from shuffle_exchange_tpu_torch.models import Transformer

    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=device).manual_seed(seed + 3)
    params, make_s = mixtral_params(cfg, gen, device=device)
    model = Transformer(cfg, device=device)
    nbytes = weight_bytes(params)
    print(f"[mixtral] seeded {cfg.n_layers}-layer Mixtral-8x7B weights, int8 storage for the "
          f"experts and attention matrices: {nbytes / 1e9:.3f} GB made in {make_s:.2f} s "
          f"(peak {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB) on {card}", flush=True)
    out = {"weight_bytes": nbytes, "weights_made_s": make_s, "serve": {}}
    for label, config in (("ragged", MOE_SERVE), ("auto", MOE_AUTO)):
        r = counted_serve(model, params, np.random.default_rng([seed, 1]), config,
                          cfg.n_layers, card, label=f"mixtral {label}")
        _check(r["moe"]["dispatched"] > 0, f"mixtral {label}: no expert assignment counted")
        if label == "ragged":
            _check(r["moe"]["dropped"] == 0, "the dropless route dropped assignments")
        r["tokens"] = {int(u): t for u, t in r["tokens"].items()}
        out["serve"][label] = r
        gc.collect()
        torch.cuda.empty_cache()
    same = sum(out["serve"]["ragged"]["tokens"][u] == out["serve"]["auto"]["tokens"][u]
               for u in out["serve"]["ragged"]["tokens"])
    print(f"[mixtral] requests with equal tokens under ragged and auto (capacity drops, "
          f"bf16): {same} of {N_PROMPTS}", flush=True)
    prompts = loop_prompts(np.random.default_rng([seed, 5]), cfg.vocab_size)
    out["put_decode_loop"] = put_decode_loop(model, params, prompts, cfg.n_layers, card,
                                             config=MOE_SERVE, label="mixtral put")
    gc.collect()
    torch.cuda.empty_cache()
    out["v1_generate"] = v1_generate(model, params, prompts, cfg.n_layers, card,
                                     config=dict(V1_CONFIG, **_quant(8)),
                                     label="mixtral v1 generate")
    gc.collect()
    torch.cuda.empty_cache()
    out["trace"] = trace_serve(model, params, np.random.default_rng([seed, 4]), MOE_SERVE)
    print(f"[trace mixtral ragged] {json.dumps(out['trace']) if out['trace'] else 'no device'}",
          flush=True)
    # the put() prefill and 8 decode_loop steps, profiled apart
    eng = InferenceEngineV2(model, params, InferenceConfig(**MOE_SERVE))
    uids = list(range(len(prompts)))
    first = []
    out["trace_prefill"] = profiled(
        lambda: first.extend(int(t) for t in eng.put(uids, prompts).argmax(-1)), top_other=6)
    out["trace_decode_loop"] = profiled(lambda: eng.decode_loop(uids, first, 8), top_other=6)
    for what in ("trace_prefill", "trace_decode_loop"):
        print(f"[{what} mixtral] {json.dumps(out[what]) if out[what] else 'no device'}",
              flush=True)
    del eng
    out["peak_mem_GiB"] = torch.cuda.max_memory_allocated() / 2 ** 30
    weights = f"weights {nbytes / 1e9:.3f} GB made in {make_s:.2f} s"
    for label, r in out["serve"].items():
        print(f"[mixtral summary] serve {label}: {r['sustained_tokens_per_sec']:.2f} tok/s, "
              f"TTFT p50 {r['ttft_p50_s']:.3f} s, TPOT p50 {r['tpot_p50_s'] * 1e3:.1f} ms, "
              f"{weights}, moe {json.dumps(r['moe'])}", flush=True)
    p = out["put_decode_loop"]
    print(f"[mixtral summary] put + decode_loop: prefill {p['prefill_tokens_per_s']:.0f} tok/s, "
          f"decode {p['decode_loop_tokens_per_s']:.1f} tok/s ({p['decode_loop_ms_per_step']:.1f} "
          f"ms a step), {weights}, moe {json.dumps(p['moe'])}", flush=True)
    v = out["v1_generate"]
    print(f"[mixtral summary] v1 generate: {v['tokens_per_s']:.2f} tok/s, prefill "
          f"{v['prefill_ms']:.1f} ms, {v['decode_step_ms']:.1f} ms a decode step, {weights} "
          f"(the v1 engine keeps no routing counters, as in JAX)", flush=True)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


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


def _quant(bits):
    """The inference-config settings of a quantized engine (none for None)."""
    return {} if bits is None else dict(quantize_weights=True, quant_bits=bits)


# phase 4 with adapters: all four targets, a pool of rank 16 holding
# adapters of rank 8 and 16 (alpha 2r), uids 0-3 bound to them and to none
E2E_ADAPTERS = {"enabled": True, "slots": 4, "max_rank": 16}
E2E_BINDING = {0: "r8", 1: "r16", 2: None, 3: "r8"}
# phase 4g's: a pool of rank 128 holding adapters of ranks 16, 64 and 128
E2E_WIDE = (dict(E2E_ADAPTERS, max_rank=128), {0: "r128", 1: "r16", 2: None, 3: "r64"})


def e2e_adapters(engines, cfg, binding=E2E_BINDING):
    """Register the adapters ``binding`` names (``r<rank>``) on each engine
    (the same numpy factors) and bind the schedules' uids to them."""
    ranks = sorted({int(aid[1:]) for aid in binding.values() if aid})
    facs = {f"r{r}": tenant_factors(cfg, 500 + r, rank=r, targets=("wq", "wk", "wv", "wo"))
            for r in ranks}
    for e in engines:
        for aid, fac in facs.items():
            e.adapters.register(aid, fac, alpha=2.0 * int(aid[1:]))
        for uid, aid in binding.items():
            e.configure_adapter(uid, aid)


def host_weights(params):
    """The weights an engine serves, as f32 on the CPU: quantized matrices
    dequantized in f32 (the plain quantized matmul in f32 multiplies by
    exactly these), the rest cast."""
    import torch

    from shuffle_exchange_tpu_torch.ops.quant_matmul import QuantizedMatrix

    return {k: (v.dequantize(torch.float32).cpu() if isinstance(v, QuantizedMatrix)
                else v.detach().float().cpu()) for k, v in params.items()}


@contextlib.contextmanager
def card_kv(card, host):
    """For one call of the CPU engine after the same call on the card: the
    CPU engine's pool holds what the card engine stored (the one-byte rows
    and their scales, after its call) and its own pool writes are skipped,
    as RoutingReplay hands it the card's routing. The two engines' K/V
    projections differ in bf16 rounding, which moves some elements across
    an int8 or e4m3 rounding boundary; without this the CPU engine would
    attend over other stored values than the card's kernels read (phase 2k
    holds ``quantize_kv`` on the card to the CPU's bytes). Both engines run
    the same schedule, so their block tables agree (checked after)."""
    from shuffle_exchange_tpu_torch.inference import engine_v2 as ev2

    for name in ("k", "v", "k_scale", "v_scale"):
        getattr(host.cache, name).copy_(getattr(card.cache, name).cpu())
    writes = {n: getattr(ev2, n) for n in ("write_rows", "write_blocks", "append_token_kv")}
    for n in writes:
        setattr(ev2, n, lambda *a, **k: None)
    try:
        yield
    finally:
        for n, fn in writes.items():
            setattr(ev2, n, fn)
    for uid, desc in card._seqs.items():
        _check(host._seqs[uid].blocks == desc.blocks,
               f"uid {uid}: block tables differ between the card and the CPU engine")


def e2e_check(cfg, card_state, rng, card_device="cuda", decode_kernel="auto", quant_bits=None,
              adapters=False, kv=None):
    """Run the schedule on a bf16 engine on the card (``decode_kernel`` as
    given; ``quant_bits`` quantizes its weights; ``adapters`` adds phase
    4's adapter pool and bindings) and an f32 engine on the CPU ("xla":
    the paged plain versions) fed the weights and adapter factors the
    card engine serves (``adapters``: True for phase 4's pool, or a (pool
    config, binding) pair such as E2E_WIDE); ``kv`` ("int8" / "fp8")
    stores both engines' KV in that mode, the CPU engine attending over
    the card's stored bytes
    (``card_kv``). Returns per-tick errors."""
    from shuffle_exchange_tpu_torch.inference import InferenceConfig, InferenceEngineV2
    from shuffle_exchange_tpu_torch.models import Transformer

    pool, binding = adapters if isinstance(adapters, tuple) else (E2E_ADAPTERS, E2E_BINDING)
    icfg = dict(max_seq_len=512, kv_block_size=64, num_kv_blocks=24,
                serving={"token_budget": 256, "max_running": 8},
                **({"adapters": pool} if adapters else {}),
                **({"kv_cache_dtype": kv} if kv else {}))
    card = InferenceEngineV2(Transformer(cfg, device=card_device), card_state,
                             InferenceConfig(dtype="bfloat16", decode_kernel=decode_kernel,
                                             **_quant(quant_bits), **icfg), device=card_device)
    if decode_kernel == "auto" and card_device == "cuda":
        _check(card._decode_kernel == "pallas", "decode_kernel auto did not resolve to the "
               "fused kernels on the card")
    cpu_state = host_weights(card.params)
    host = InferenceEngineV2(Transformer(cfg, device="cpu"), cpu_state,
                             InferenceConfig(dtype="float32", decode_kernel="xla", **icfg),
                             device="cpu")
    if adapters:
        e2e_adapters((card, host), cfg, binding)
    ticks = []
    for tick in e2e_schedule(rng, cfg.vocab_size):
        got = card.step(*tick)
        with card_kv(card, host) if kv else contextlib.nullcontext():
            want = host.step(*tick)
        ticks.append(_compare(np.concatenate([a for a in got if a.size]),
                              np.concatenate([a for a in want if a.size])))
    return ticks


def _compare(got, want):
    err = np.abs(got - want)
    _check(np.isfinite(got).all(), "non-finite logits on the card")
    return dict(rows=int(got.shape[0]), max_abs_err=float(err.max()),
                ref_abs_max=float(np.abs(want).max()),
                within=bool(err.max() <= E2E_REL_TOL * np.abs(want).max()),
                argmax_agree=float(np.mean(got.argmax(-1) == want.argmax(-1))))


def report_e2e(label, e2e, against="the CPU f32 plain path"):
    """Print each call's error of ``e2e`` ({what: {decode kernel: calls}})
    and fail unless every call is within E2E_REL_TOL."""
    for what, by_dk in e2e.items():
        for dk, calls in by_dk.items():
            for i, t in enumerate(calls):
                print(f"[e2e {label}{what} {dk}] call {i}: rows={t['rows']} "
                      f"max_abs_err={t['max_abs_err']} (tol {E2E_REL_TOL} x |ref| max "
                      f"{t['ref_abs_max']}) argmax_agree={t['argmax_agree']}")
            _check(all(t["within"] for t in calls), f"depth-2 {label}{what} logits on the card "
                   f"({dk}) disagree with {against}")


def put_schedule(rng, V, lengths=(200, 120, 60, 30)):
    """A cold batched prefill of four prompts, single-token extensions of
    all four, then a multi-token extension of two (70 tokens: two extend
    chunks of 64 and 6) beside one single."""
    p = [rng.integers(1, V, size=n).tolist() for n in lengths]
    t = rng.integers(1, V, size=100).tolist()
    return [([0, 1, 2, 3], p),
            ([0, 1, 2, 3], [[x] for x in t[0:4]]),
            ([0, 1, 2, 3], [[x] for x in t[4:8]]),
            ([1, 3, 0], [t[8:78], t[78:83], [t[83]]])]


def e2e_put_check(cfg, card_state, rng, decode_kernels=("auto", "xla"), quant_bits=None,
                  adapters=False, kv=None):
    """The put() schedule on bf16 engines on the card (each decode path;
    ``quant_bits`` quantizes their weights; ``adapters`` adds phase 4's
    adapters; ``kv`` stores every engine's KV in that mode, with a CPU
    engine for each card engine that attends over its stored bytes,
    ``card_kv``) and on an f32 engine on the CPU fed the weights and
    factors they serve; per-call logits errors."""
    from shuffle_exchange_tpu_torch.inference import InferenceConfig, InferenceEngineV2
    from shuffle_exchange_tpu_torch.models import Transformer

    icfg = dict(max_seq_len=512, kv_block_size=64, num_kv_blocks=24,
                **({"adapters": E2E_ADAPTERS} if adapters else {}),
                **({"kv_cache_dtype": kv} if kv else {}))
    schedule = put_schedule(rng, cfg.vocab_size)
    cards = {dk: InferenceEngineV2(Transformer(cfg), card_state,
                                   InferenceConfig(dtype="bfloat16", decode_kernel=dk,
                                                   **_quant(quant_bits), **icfg))
             for dk in decode_kernels}
    weights = host_weights(cards[decode_kernels[0]].params)

    def cpu_engine():
        return InferenceEngineV2(Transformer(cfg, device="cpu"), weights,
                                 InferenceConfig(dtype="float32", decode_kernel="xla", **icfg),
                                 device="cpu")

    host = cpu_engine()
    if adapters:
        e2e_adapters((*cards.values(), host), cfg)
    want = None if kv else [host.put(*call) for call in schedule]
    out = {}
    for dk, card in cards.items():
        if kv:   # the CPU engine reads what this card engine stored
            host = cpu_engine()
            out[dk] = []
            for call in schedule:
                got = card.put(*call)
                with card_kv(card, host):
                    out[dk].append(_compare(got, host.put(*call)))
        else:
            out[dk] = [_compare(card.put(*call), w) for call, w in zip(schedule, want)]
        _check(card.program_shapes == host.program_shapes,
               f"put() programs on the card {sorted(card.program_shapes)} != the CPU "
               f"engine's {sorted(host.program_shapes)}")
    return out


def e2e_v1_check(cfg, card_state, rng, decode_kernels=("auto", "xla"), steps=4):
    """The v1 engine's prefill (flash kernel) and ``steps`` teacher-forced
    decode steps, bf16 on the card against f32 on the CPU; per-call
    logits errors."""
    import torch

    from shuffle_exchange_tpu_torch.inference import InferenceConfig, InferenceEngine
    from shuffle_exchange_tpu_torch.models import Transformer

    lens = np.asarray([200, 120, 60, 30], np.int32)
    ids = np.zeros((4, 256), np.int32)
    for i, n in enumerate(lens):
        ids[i, :n] = rng.integers(1, cfg.vocab_size, size=n)
    feed = rng.integers(1, cfg.vocab_size, size=(steps, 4)).astype(np.int32)

    def run(eng):
        dev = eng.device
        cache = eng._new_cache(4)
        pos = torch.from_numpy(lens).to(dev)
        logits = [eng._head(eng._prefill(torch.from_numpy(ids).to(dev), pos, cache))[:, 0]]
        for s_ in range(steps):
            logits.append(eng._decode_step(cache, torch.from_numpy(feed[s_]).to(dev), pos))
            pos = pos + 1
        return [lg.float().cpu().numpy() for lg in logits]

    cpu_state = {k: v.detach().float().cpu() for k, v in card_state.items()}
    want = run(InferenceEngine(Transformer(cfg, device="cpu"), cpu_state,
                               InferenceConfig(dtype="float32", decode_kernel="xla",
                                               max_seq_len=512), device="cpu"))
    out = {}
    for dk in decode_kernels:
        card = InferenceEngine(Transformer(cfg), card_state,
                               InferenceConfig(dtype="bfloat16", decode_kernel=dk,
                                               max_seq_len=512))
        out[dk] = [_compare(g, w) for g, w in zip(run(card), want)]
    return out


# ---------------------------------------------------------------------------
# Phase 4, MoE: depth-2 Mixtral, int8 and fp8, against the CPU f32 engine
# ---------------------------------------------------------------------------

# A routing flip (a row whose top-2 experts differ between the card's bf16
# engine and the CPU's f32 one) moves that row's FFN output by O(1), so the
# logits are held where routing agrees: the CPU engine replays the card's
# top-2 choices call by call (its gate weights still from its own f32
# logits), and every row whose own choice differs is reported with the gap
# between its 2nd and 3rd f32 router logits. The bf16 hidden state moves a
# router logit by its rounding (random router weights give logits of unit
# scale, ~1e-2 of noise after a layer); a flip needs two logits to cross,
# so a flip whose gap exceeds twice the largest difference between the two
# engines' router logits on its row cannot be noise: it is a fault (a
# wrong top-k rule, a tie broken the other way, TF32 products).
MOE_FLIP_RULE = "2nd-3rd f32 router-logit gap <= 2 x max |card - CPU router logit| of the row"
MOE_E2E_CONFIG = dict(max_seq_len=512, kv_block_size=64, num_kv_blocks=24,
                      serving={"token_budget": 256, "max_running": 8,
                               "moe": {"moe_impl": "ragged", "overload_policy": "drop"}})


def moe_e2e_schedule(rng, V):
    """step() ticks at lengths the CPU's f32 experts (2.8 B parameters)
    finish in seconds: two extend-only ticks, a mixed tick with a new uid,
    two decode-only ticks."""
    p = [rng.integers(1, V, size=n).tolist() for n in (100, 60, 30, 20)]
    t = rng.integers(1, V, size=16).tolist()
    return [([], [], [(0, p[0][:64]), (1, p[1][:40])]),
            ([], [], [(0, p[0][64:]), (1, p[1][40:]), (2, p[2])]),
            ([0, 1], t[0:2], [(3, p[3])]),
            ([0, 1, 2, 3], t[2:6], []),
            ([0, 1, 2, 3], t[6:10], [])]


def routing_difference(lg, their_logits, idx, theirs):
    """(each row's largest router-logit difference between two engines,
    whether its top-k set differs), on host tensors."""
    delta = (lg - their_logits).abs().amax(-1)
    return delta, (idx.cpu().sort(1).values != theirs.sort(1).values).any(1)


def flip_notes(lg, delta, flipped, k):
    """[(2nd-3rd router-logit gap, router-logit difference)] of the flipped
    rows."""
    if not flipped.any():
        return []
    top = lg.topk(k + 1, dim=-1).values[flipped]
    return list(zip((top[:, k - 1] - top[:, k]).tolist(), delta[flipped].tolist()))


def replayed_routing(logits, card, k, normalize_weights):
    """(weights, aux loss, masks) of the recorded choices ``card`` [S, k]
    computed from this call's own ``logits`` as ``topk_select`` computes
    them, so gradients flow through the replay."""
    import torch

    from shuffle_exchange_tpu_torch.moe.gating import _one_hot

    E = logits.shape[-1]
    gates = torch.softmax(logits.float(), dim=-1)
    masks = [_one_hot(card[:, j], E) for j in range(k)]
    w = torch.stack([(gates * m).sum(-1) for m in masks], dim=1)
    if normalize_weights and k > 1:
        w = w / torch.clamp(w.sum(1, keepdim=True), min=1e-9)
    aux = E * (gates.mean(0) * masks[0].mean(0)).sum()
    return w, aux, masks


class RoutingReplay:
    """Patches the port's one top-k rule (``moe.gating.topk_select``, also
    bound in ``moe.layer``): while recording, each call's choices are kept
    and logits (host copies); while replaying, each call returns the
    recorded choices, with weights and masks from this call's own logits,
    and notes (gap, router-logit difference) of every row whose own
    choice differs. Rows are told apart as tokens of sequences or padding
    (``watch``): padding rows attend over whatever the scratch block holds,
    which differs between the two engines, so only the tokens' flips and
    router logits are held to the rule; padding flips are counted."""

    def __init__(self):
        self.recorded, self.flips, self.calls, self.pending = [], [], 0, []
        self.replaying, self.max_logit_delta, self.pad_flips = False, 0.0, 0

    def watch(self, eng):
        """Wrap ``eng``'s programs so that each routing call of theirs knows
        which rows are tokens: a row whose block-table row starts with a
        real block, at a position below its new-token count (one mask per
        lane, per layer, in the order the layer runs its lanes)."""
        import torch

        L, scratch = eng._mcfg.n_layers, eng._scratch

        def rows(tables, T=1, nnew=None):
            real = tables[:, 0] != scratch
            if nnew is None:
                return real
            return (real[:, None] & (torch.arange(T)[None, :] < nnew[:, None])).reshape(-1)

        def wrap(name, lanes):
            program = getattr(eng, name)

            def run(*args, **kw):
                self.pending += lanes(*args) * L
                return program(*args, **kw)

            setattr(eng, name, run)

        wrap("_decode_program", lambda tok, pos, tables: [rows(tables)])
        wrap("_extend_program", lambda ids, start, nnew, tables: [
            rows(tables, ids.shape[1], nnew)])
        wrap("_prefill_program", lambda ids, plen, tables: [rows(tables, ids.shape[1], plen)])
        wrap("_mixed_program", lambda dtok, dpos, dtables, pids, pstart, pnnew, ptables: [
            rows(dtables), rows(ptables, pids.shape[1], pnnew)])

    def __enter__(self):
        from shuffle_exchange_tpu_torch.moe import gating, layer

        self._mods, self._orig = (gating, layer), gating.topk_select
        for m in self._mods:
            m.topk_select = self.select
        return self

    def __exit__(self, *exc):
        for m in self._mods:
            m.topk_select = self._orig

    def select(self, logits, k, normalize_weights=True, train=False, rng=None, noise_std=0.0):
        idx, w, aux, masks = self._orig(logits, k, normalize_weights, train, rng, noise_std)
        if not self.replaying:
            self.recorded.append((idx.cpu(), logits.float().cpu()))
            return idx, w, aux, masks
        theirs, their_logits = self.recorded[self.calls]
        self.calls += 1
        _check(theirs.shape == idx.shape, f"replayed routing {tuple(theirs.shape)} != this "
               f"call's {tuple(idx.shape)}: the engines ran different programs")
        real = self.pending.pop(0)
        _check(real.shape[0] == idx.shape[0], "routing call rows do not match the program")
        lg = logits.detach().float().cpu()
        delta, differ = routing_difference(lg, their_logits, idx, theirs)
        if real.any():
            self.max_logit_delta = max(self.max_logit_delta, float(delta[real].max()))
        self.pad_flips += int((differ & ~real).sum())
        self.flips += flip_notes(lg, delta, differ & real, k)
        card = theirs.to(logits.device)
        return (card,) + replayed_routing(logits, card, k, normalize_weights)


def moe_e2e_check(cfg, card_state, seed, bits):
    """Depth-2 Mixtral: the step() schedule and the put() schedule on a bf16
    engine on the card (``quant_bits`` experts and attention matrices,
    quantized by the engine; decode_kernel "auto", ragged routing) and on
    an f32 engine on the CPU fed the card engine's weights dequantized,
    routed as the card routed (``RoutingReplay``). Returns per-call logits
    errors and the flips."""
    from shuffle_exchange_tpu_torch.inference import InferenceConfig, InferenceEngineV2
    from shuffle_exchange_tpu_torch.models import Transformer

    def engines():
        card = InferenceEngineV2(Transformer(cfg), card_state,
                                 InferenceConfig(dtype="bfloat16", decode_kernel="auto",
                                                 **_quant(bits), **MOE_E2E_CONFIG))
        _check(card._decode_kernel == "pallas", "decode_kernel auto did not resolve to the "
               "fused kernels on the card")
        host = InferenceEngineV2(Transformer(cfg, device="cpu"), host_weights(card.params),
                                 InferenceConfig(dtype="float32", decode_kernel="xla",
                                                 **MOE_E2E_CONFIG), device="cpu")
        return card, host

    out = {}
    V = cfg.vocab_size
    for what, schedule, call in (
            ("step", moe_e2e_schedule(np.random.default_rng([seed, 13]), V),
             lambda eng, c: np.concatenate([a for a in eng.step(*c) if a.size])),
            ("put", put_schedule(np.random.default_rng([seed, 14]), V, (100, 60, 30, 20)),
             lambda eng, c: eng.put(*c))):
        card, host = engines()
        with RoutingReplay() as replay:
            replay.watch(host)
            got = [call(card, c) for c in schedule]
            replay.replaying = True
            want = [call(host, c) for c in schedule]
        _check(replay.calls == len(replay.recorded), f"{what}: the CPU engine made "
               f"{replay.calls} routing calls, the card {len(replay.recorded)}")
        rows = sum(int(r.shape[0]) for r, _ in replay.recorded)
        flips = sorted(replay.flips, reverse=True)
        out[what] = dict(calls=[_compare(g, w) for g, w in zip(got, want)],
                         routed_rows=rows, padding_row_flips=replay.pad_flips, flips=len(flips),
                         flip_gaps_top=[[round(g, 6), round(d, 6)] for g, d in flips[:10]],
                         max_router_logit_delta=replay.max_logit_delta,
                         flips_beyond_noise=sum(g > 2 * d for g, d in flips))
        del card, host
        gc.collect()
    return out


# ---------------------------------------------------------------------------
# Phase 2i: the ALiBi flash kernels (B11 forward, B12 dq, B13 dk/dv + dslope)
# ---------------------------------------------------------------------------

# The kernels and the plain versions (reference_alibi_attention_lse with P
# in f32; reference_alibi_attention_bwd on the kernel's out and lse) both
# form the bias slope_h * j in f32. out and the gradients are held as phases
# 2c/2d hold B14/B15. The lse carries the bias (~1,447 at S = 2048 for
# BLOOM's first slope), where one f32 step is 1.2e-4 and the kernel's log2
# domain rounds the score, the running max and the product with ln 2 once
# each: 1e-3 plus 1e-6 of |lse|. dslope_h = sum dS_ij * j is ill-conditioned:
# every score carries an f32 rounding of its bias (~1e-4 absolute at 1447),
# which moves each dS_ij by ~1e-4 of itself at random, while in a steep head
# (slope 2^-0.5: P sits on the last few keys) sum dS_ij * j cancels to
# sum dS_ij (j - i), a thousand times smaller than its terms. The kernel and
# the plain version round the scores at different points, so dslope is held
# per head to 1e-4 of the root-sum-square of its terms dS_ij * j: above the
# largest error of any head measured (5.1e-5 of it in this script's cells,
# 6.9e-5 with phase 2i's inputs drawn first) and below the smallest |dslope|
# of any head (1.8e-4 and 1.1e-4 of it), so a zero dslope fails in every
# head. The plain version adds slope_h * j (up to ~1,400) to its f32
# scores before lse is subtracted, so its P and dslope carry that rounding:
# against dslope computed in f64 from the same inputs and out
# (scripts/torch_dslope_draws.py --f64) it sits up to 1.51x DSLOPE_RSS off
# (seed 0 + 12, T<S, head 0), while the kernels, which form bias - lse
# first, stay within 0.0073x of it at every head of draws 4, 9 and 12
# (PERF.md section 7). Whether every head's |dslope| clears 1e-4 of its
# terms depends on the draw. Phase 2i draws from a generator of its own (the
# run's seed + ALIBI_DRAW), so no other phase's draws move its inputs. Of 16
# draws on the H100, 8 let a zero dslope pass in no head; at seed 0 +
# ALIBI_DRAW = 9 the least |dslope| is 3.5x its tolerance (T<S, head 3) and
# kernel and plain version differ by at most 0.49x. So a zero dslope must
# fail in every head of every cell but DSLOPE_UNBITTEN heads in all; the
# heads it leaves are reported.
ALIBI_LSE_TOL = "1e-3 + 1e-6*|plain lse|"
DSLOPE_RSS = 1e-4
DSLOPE_UNBITTEN = 0
ALIBI_DRAW = 9   # phase 2i's generator: the run's seed + ALIBI_DRAW
DSLOPE_TOL = f"{DSLOPE_RSS}*sqrt(sum over b, i, j of (dS_ij * j)^2), per head"
# (label, B compared, B timed, T, S, H, KV, Dh): BLOOM-1b7's training shape
# (T = S = 2047 after the label shift, 16 heads of 128) timed at its batch of
# 16; on block boundaries; T < S (the bottom-right diagonal); GQA (n_rep 2);
# head dim 64 (bloom-560m's heads)
ALIBI_CELLS = [
    ("bloom-1b7 train", 2, 16, 2047, 2047, 16, 16, 128),
    ("blocks", 1, 1, 2048, 2048, 16, 16, 128),
    ("T<S", 2, 2, 512, 2048, 16, 16, 128),
    ("gqa n_rep 2", 2, 2, 1024, 1024, 16, 8, 128),
    ("bloom-560m Dh 64", 2, 2, 2047, 2047, 16, 16, 64),
]


def lse_close(got, want):
    err = (got - want).abs()
    return err, bool((err <= 1e-3 + 1e-6 * want.abs()).all())


def alibi_generator(seed: int):
    """Phase 2i's own generator: the run's seed plus ALIBI_DRAW."""
    import torch

    return torch.Generator(device="cuda").manual_seed(seed + ALIBI_DRAW)


def alibi_draw(gen, B, T, S, H, KV, Dh):
    """(q, k, v, dout) of one phase-2i cell at batch B, bf16 on the card."""
    import torch

    return (torch.randn(B, T, H, Dh, generator=gen, device="cuda").bfloat16(),
            torch.randn(B, S, KV, Dh, generator=gen, device="cuda").bfloat16(),
            torch.randn(B, S, KV, Dh, generator=gen, device="cuda").bfloat16(),
            torch.randn(B, T, H, Dh, generator=gen, device="cuda").bfloat16())


def _alibi_masked_plain(q, k, v, slopes, dout, allowed):
    """(out bf16, lse, dq, dk, dv, dslope) by autograd through ALiBi
    attention in f32 over an explicit [T, S] mask: the yardstick for
    deliberately broken plain versions."""
    import torch

    from shuffle_exchange_tpu_torch.ops.flash_attention import repeat_kv

    G = q.shape[2] // k.shape[2]
    leaves = [t.float().requires_grad_(True) for t in (q, k, v, slopes)]
    qf, kf, vf, sf = leaves
    pos = torch.arange(k.shape[1], dtype=torch.float32, device=q.device)
    logits = torch.einsum("bthd,bshd->bhts", qf * q.shape[-1] ** -0.5, repeat_kv(kf, G))
    logits = (logits + sf[None, :, None, None] * pos).masked_fill(~allowed, -1e30)
    out = torch.einsum("bhts,bshd->bthd", torch.softmax(logits, -1), repeat_kv(vf, G))
    grads = torch.autograd.grad(out, leaves, dout.float())
    return (out.detach().bfloat16(), torch.logsumexp(logits.detach(), -1),
            *(g.detach() for g in grads))


def dslope_heads_within(got, want, rss):
    """Each head's |got - want| <= DSLOPE_RSS of its terms' root-sum-square."""
    return (got.float() - want.float()).abs() <= DSLOPE_RSS * rss


def dslope_close(got, want, rss):
    return (got.float() - want.float()).abs(), bool(dslope_heads_within(got, want, rss).all())


def _plain_ds(q, k, v, slopes, out, lse, dout):
    """The plain version's dS [B, H, T, S] f32."""
    import torch

    from shuffle_exchange_tpu_torch.ops.alibi_attention import _alibi_logits
    from shuffle_exchange_tpu_torch.ops.flash_attention import repeat_kv

    p = torch.exp(_alibi_logits(q, k, slopes, True) - lse[..., None])
    do = dout.float()
    dp = torch.einsum("bthd,bshd->bhts", do, repeat_kv(v, q.shape[2] // k.shape[2]).float())
    delta = (do * out.float()).sum(-1).permute(0, 2, 1)
    return p * (dp - delta[..., None])


def _alibi_bias_mask(slopes, T, S):
    """The [1, H, T, S] bf16 additive mask of ALiBi: slope_h * j where key j
    is visible (j <= i + S - T), -inf elsewhere (SDPA's yardstick form)."""
    import torch

    pos = torch.arange(S, dtype=torch.float32, device=slopes.device)
    bias = slopes[:, None, None] * pos
    vis = torch.ones(T, S, dtype=torch.bool, device=slopes.device).tril(S - T)
    return bias.masked_fill(~vis, float("-inf"))[None].bfloat16()


def check_alibi(gen):
    """B11, B12 and B13 against their plain versions in bf16 at every
    ALIBI_CELLS cell: out (PAGED_TOL), lse (ALIBI_LSE_TOL), dq, dk, dv and
    (GRAD_TOL) and dslope (DSLOPE_TOL), on a generator of its own seeded
    from ``gen``'s seed. At the training cell two runs give equal bits and
    a plain version with flipped slopes fails every tolerance; at T < S one
    with the top-left diagonal does; a zero dslope fails in every head of
    every cell but at most DSLOPE_UNBITTEN heads in all. Each cell is timed
    cold at its timed
    batch beside its bound (operations: forward 4, dq 6 and dk/dv 8 x pairs
    x H x Dh; the whole backward needs 10), the plain versions and SDPA with
    the materialised bf16 bias mask (its forward; its backward alone; both),
    a yardstick of time only. Returns
    (forward rows, dq rows, dk/dv rows)."""
    import torch
    import torch.nn.functional as F

    from shuffle_exchange_tpu_torch.models import alibi_slopes
    from shuffle_exchange_tpu_torch.ops import alibi_attention as al

    # the phase's own generator, seeded from the run's seed
    gen = alibi_generator(gen.initial_seed())
    fwd_rows, dq_rows, dkv_rows = [], [], []
    unbitten = []   # (cell, head) where a zero dslope passes
    for label, Bc, Bt, T, S, H, KV, Dh in ALIBI_CELLS:
        shape = dict(label=label, B=Bc, B_timed=Bt, T=T, S=S, H=H, KV=KV, Dh=Dh)
        slopes = torch.from_numpy(alibi_slopes(H)).cuda()
        draw = lambda B: alibi_draw(gen, B, T, S, H, KV, Dh)
        q, k, v, dout = draw(Bc)
        out, lse = al.alibi_flash_attention_lse(q, k, v, slopes)
        want_out, want_lse = al.reference_alibi_attention_lse(q, k, v, slopes, p_f32=True)
        torch.cuda.synchronize()
        out_err, out_ok = paged_close(out, want_out)
        lse_err, lse_ok = lse_close(lse, want_lse)
        _check(out_ok and lse_ok, f"ALiBi forward disagrees with its plain version at {shape}: "
               f"out {out_err.max().item()}, lse {lse_err.max().item()}")
        del want_out, want_lse
        got = al.alibi_flash_attention_bwd(q, k, v, slopes, out, lse, dout)
        want = al.reference_alibi_attention_bwd(q, k, v, slopes, out, lse, dout)
        torch.cuda.synchronize()
        names = ("dq", "dk", "dv", "dslope")
        ds = _plain_ds(q, k, v, slopes, out, lse, dout)
        pos = torch.arange(S, dtype=torch.float32, device="cuda")
        rss = (ds * pos).pow(2).sum(dim=(0, 2, 3)).sqrt()
        del ds

        def close(n, g, w):
            return dslope_close(g, w, rss) if n == "dslope" else grad_close(g, w)

        checks = {n: close(n, g, w) for n, g, w in zip(names, got, want)}
        errs = {n: e.max().item() for n, (e, _) in checks.items()}
        _check(all(ok for _, ok in checks.values()), f"ALiBi backward kernels disagree with "
               f"their plain version at {shape}: max abs err {errs}")
        common = dict(shape=shape, errs=errs, lse_max_abs_err=lse_err.max().item(),
                      fwd_out_max_abs_err=out_err.max().item())
        fwd = dict(common, max_abs_err=out_err.max().item(),
                   tolerance=f"{PAGED_TOL} (plain with P in f32); lse {ALIBI_LSE_TOL}")
        dq = dict(common, max_abs_err=errs["dq"], tolerance=GRAD_TOL)
        dkv = dict(common, max_abs_err=max(errs["dk"], errs["dv"]),
                   tolerance=f"{GRAD_TOL}; dslope {DSLOPE_TOL}",
                   dslope_err_over_rss=(checks["dslope"][0] / rss).tolist(),
                   dslope_over_rss=(want[3].abs() / rss).tolist())
        # a zero dslope fails in every head but DSLOPE_UNBITTEN in the phase
        zero_fails = ~dslope_heads_within(torch.zeros_like(want[3]), want[3], rss)
        heads = (~zero_fails).nonzero().flatten().tolist()
        unbitten += [(label, h) for h in heads]
        _check(len(unbitten) <= DSLOPE_UNBITTEN, "the dslope tolerance lets a zero dslope pass "
               f"in {len(unbitten)} heads (at most {DSLOPE_UNBITTEN}): {unbitten}")
        dkv["tolerance_bites"] = {
            "dslope_zero_in_every_head": bool(zero_fails.all()),
            "resolved_heads": int((want[3].float().abs() > 2 * DSLOPE_RSS * rss).sum()),
            "heads_not_bitten": heads}
        causal = torch.ones(T, S, dtype=torch.bool, device="cuda").tril(S - T)
        bites = {}
        if label == "bloom-1b7 train":
            again_fwd = al.alibi_flash_attention_lse(q, k, v, slopes)
            again = al.alibi_flash_attention_bwd(q, k, v, slopes, out, lse, dout)
            torch.cuda.synchronize()
            fwd["equal_bits_twice"] = dkv["equal_bits_twice"] = dq["equal_bits_twice"] = (
                all(torch.equal(a, b) for a, b in zip((out, lse, *got), (*again_fwd, *again))))
            _check(fwd["equal_bits_twice"], "two runs of the ALiBi kernels differ")
            bites["flipped_slopes"] = _alibi_masked_plain(q, k, v, slopes.flip(0), dout, causal)
        if T < S:
            top_left = torch.ones(T, S, dtype=torch.bool, device="cuda").tril()
            bites["top_left_diagonal"] = _alibi_masked_plain(q, k, v, slopes, dout, top_left)
        for what, (b_out, b_lse, *b_grads) in bites.items():
            fails = {"out": not paged_close(out, b_out)[1], "lse": not lse_close(lse, b_lse)[1]}
            fails.update({n: not close(n, g, w)[1] for n, g, w in zip(names, got, b_grads)})
            _check(all(fails.values()), f"an ALiBi tolerance does not catch {what}: {fails}")
            fwd.setdefault("tolerance_bites", {})[what] = fails
        del bites, want, got
        torch.cuda.empty_cache()

        # timed at the cell's timed batch: the training route (no dslope)
        if Bt != Bc:
            q, k, v, dout = draw(Bt)
            out, lse = al.alibi_flash_attention_lse(q, k, v, slopes)
        delta = al._launch_delta(out, dout)
        pairs = sum(min(i + S - T + 1, S) for i in range(T))
        elems = Bt * H * Dh * pairs
        qb, kvb = Bt * T * H * Dh * 2, Bt * S * KV * Dh * 2
        f_ms, f_by = bound(2 * qb + 2 * kvb + Bt * H * T * 4, 4.0 * elems)
        dq_ms, dq_by = bound(3 * qb + 2 * kvb + 2 * Bt * H * T * 4, 6.0 * elems)
        dkv_ms, dkv_by = bound(2 * qb + 4 * kvb + 2 * Bt * H * T * 4, 8.0 * elems)
        bwd_bound = bound(4 * qb + 4 * kvb + Bt * H * T * 4, 10.0 * elems)[0]
        run_fwd = lambda: al.alibi_flash_attention_lse(q, k, v, slopes)
        run_dq = lambda: al._launch_dq(q, k, v, slopes, dout, lse, delta)
        run_dkv = lambda: al._launch_dkv(q, k, v, slopes, dout, lse, delta, False)
        run_bwd = lambda: al.alibi_flash_attention_bwd(q, k, v, slopes, out, lse, dout,
                                                       need_dslope=False)
        plain_fwd = lambda: al.reference_alibi_attention_lse(q, k, v, slopes, p_f32=True)
        plain_bwd = lambda: al.reference_alibi_attention_bwd(q, k, v, slopes, out, lse, dout,
                                                             need_dslope=False)
        qs, ks, vs = (t.transpose(1, 2).contiguous().requires_grad_(True) for t in (q, k, v))
        mask = _alibi_bias_mask(slopes, T, S)
        lib_fwd = lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask,
                                                         enable_gqa=True)
        dos = dout.transpose(1, 2).contiguous()
        lib_all = lambda: torch.autograd.grad(lib_fwd(), (qs, ks, vs), dos)
        lib_out = lib_fwd()   # the backward alone is timed on this one forward
        lib_bwd = lambda: torch.autograd.grad(lib_out, (qs, ks, vs), dos, retain_graph=True)
        t_plain_fwd, t_plain_bwd = time_cold(plain_fwd, iters=3), time_cold(plain_bwd, iters=3)
        torch.cuda.empty_cache()
        t_lib_fwd, t_lib_all = time_cold(lib_fwd, iters=5), time_cold(lib_all, iters=5)
        t_lib_bwd = time_cold(lib_bwd, iters=5)
        timing = dict(visible_pairs=pairs, bwd_ms=time_cold(run_bwd, iters=10),
                      bwd_bound_ms=bwd_bound, bwd_host_us=host_us(run_bwd),
                      library="SDPA with a materialised [1, H, T, S] bf16 ALiBi mask, a "
                              "yardstick of time: its forward for the forward row, its "
                              "backward alone (dq, dk and dv) for the backward rows",
                      library_fwd_bwd_ms=t_lib_all, library_kernels=_sdpa_kernels(lib_all))
        fwd.update(timing, ms=time_cold(run_fwd, iters=10), host_us=host_us(run_fwd),
                   plain_ms=t_plain_fwd, library_ms=t_lib_fwd, bound_ms=f_ms, bound_by=f_by)
        dq.update(timing, ms=time_cold(run_dq, iters=10), host_us=host_us(run_dq),
                  plain_ms=t_plain_bwd, library_ms=t_lib_bwd, bound_ms=dq_ms, bound_by=dq_by)
        dkv.update(timing, ms=time_cold(run_dkv, iters=10), host_us=host_us(run_dkv),
                   plain_ms=t_plain_bwd, library_ms=t_lib_bwd, bound_ms=dkv_ms, bound_by=dkv_by)
        for row, n in ((fwd, 4.0), (dq, 6.0), (dkv, 8.0)):
            row["tflops"] = n * elems / (row["ms"] * 1e-3) / 1e12
        fwd_rows.append(fwd)
        dq_rows.append(dq)
        dkv_rows.append(dkv)
        del q, k, v, dout, out, lse, delta, qs, ks, vs, dos, mask, lib_out
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    return fwd_rows, dq_rows, dkv_rows


# ---------------------------------------------------------------------------
# Phase 2j: the serving kernels' ALiBi and bias forms (BLOOM and GPT-2)
# ---------------------------------------------------------------------------

BLOOM_WIDTHS = dict(D=2048, H=16, KV=16, Dh=128, F=8192)
GPT2_WIDTHS = dict(D=768, H=12, KV=12, Dh=64, F=3072)
# (label, H, KV, Dh): BLOOM-1b7's heads (timed), GPT-2's, and a GQA layout
# (group 4), where slopes given to the wrong heads differ from the MHA case
ALIBI_HEADS = [("bloom", 16, 16, 128), ("gpt2", 12, 12, 64), ("gqa", 16, 4, 128)]
ALIBI_MAX_LEN = 2048
# what a slope form's tolerance must catch: flipped slopes, the slopes of the
# neighbouring head, no slopes, and the bias slope_h * j formed in bf16
SLOPE_BITES = ("flipped", "wrong_heads", "zero", "bf16_bias")


def _slopes(H):
    import torch

    from shuffle_exchange_tpu_torch.models.transformer import alibi_slopes

    return torch.from_numpy(alibi_slopes(H)).cuda()


@contextlib.contextmanager
def _bias_formed_in_bf16():
    """The plain versions with ``slope_h * j`` rounded to bf16 before it joins
    the f32 score (a broken plain version: at j ~ 2000 bf16 steps by 8)."""
    from shuffle_exchange_tpu_torch.ops import fused_decode as fd
    from shuffle_exchange_tpu_torch.ops import paged_attention as pa

    orig = pa._alibi_bias
    pa._alibi_bias = fd._alibi_bias = lambda *a: orig(*a).bfloat16().float()
    try:
        yield
    finally:
        pa._alibi_bias = fd._alibi_bias = orig


def slope_bites(got, plain, slopes, rows=lambda x: x):
    """{bite: whether PAGED_TOL catches it}: ``plain(slopes)`` recomputed with
    broken slopes must NOT be within the tolerance of the kernel's output
    (``rows`` picks the rows the engine reads)."""
    import torch

    broken = {"flipped": slopes.flip(0), "wrong_heads": slopes.roll(1),
              "zero": torch.zeros_like(slopes)}
    out = {k: _bites(rows(got), rows(plain(s))) for k, s in broken.items()}
    with _bias_formed_in_bf16():
        out["bf16_bias"] = _bites(rows(got), rows(plain(slopes)))
    return out


def _alibi_sdpa(q, ck, cv, table, visible, slopes):
    """(yardstick call, the rows it returns as [B, C, H, Dh]): SDPA over the
    gathered K/V with ALiBi as an additive [B, H, C, S] bf16 mask of
    slope_h * (j - last visible key of the row), which the softmax takes as
    slope_h * j (a shift of a row cancels) while keeping the visible biases
    small enough for bf16; -inf past ``visible`` [B, C]."""
    import torch
    import torch.nn.functional as F

    qs, ks, vs, _ = _sdpa_inputs(q, ck, cv, table, visible)
    vis = torch.from_numpy(np.asarray(visible)).cuda().long()            # [B, C]
    j = torch.arange(ks.shape[2], device="cuda")
    rel = (j[None, None, :] - (vis - 1)[:, :, None]).float()             # [B, C, S]
    bias = slopes[None, :, None, None] * rel[:, None]                    # [B, H, C, S]
    mask = bias.masked_fill(j[None, None, None, :] >= vis[:, None, :, None],
                            float("-inf")).bfloat16()
    lib = lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask, enable_gqa=True)
    return lib, lambda: lib().transpose(1, 2)


def alibi_decode_case(gen, rng, H, KV, Dh, B=8, bs=64):
    """B sequences of up to ALIBI_MAX_LEN positions (the first exactly), in
    shuffled pool order, tables padded with -1."""
    import torch

    lens = np.concatenate([[ALIBI_MAX_LEN],
                           rng.integers(1, ALIBI_MAX_LEN + 1, size=B - 1)]).astype(np.int32)
    ck, cv, table = _paged_inputs(gen, rng, lens, H, KV, Dh, bs, pad=-1)
    q = torch.randn(B, 1, H, Dh, generator=gen, device="cuda").bfloat16()
    return q, ck, cv, table, lens


def check_alibi_decode(gen, rng):
    """B2 with slopes at each ALIBI_HEADS layout (timed at BLOOM's), held to
    its plain version with PAGED_TOL; every SLOPE_BITES bite must fail it."""
    import torch

    from shuffle_exchange_tpu_torch.ops.paged_attention import (paged_decode_attention,
                                                                paged_decode_reference)

    rows = []
    for label, H, KV, Dh in ALIBI_HEADS:
        q, ck, cv, table, lens = alibi_decode_case(gen, rng, H, KV, Dh)
        sl, kvl = _slopes(H), torch.from_numpy(lens).cuda()
        run = lambda: paged_decode_attention(q, ck, cv, table, kvl, alibi_slopes=sl)
        plain = lambda s: paged_decode_reference(q, ck, cv, table, kvl, p_f32=True,
                                                 alibi_slopes=s)
        got, want = run(), plain(sl)
        err, tol_ok = paged_close(got, want)
        bites, twice = slope_bites(got, plain, sl), equal_bits_twice(run)
        row = dict(shape=dict(label=label, B=len(lens), H=H, KV=KV, Dh=Dh, bs=ck.shape[2],
                              kv_len=lens.tolist(), table_width=int(table.shape[1])),
                   max_abs_err=err.max().item(), tolerance=PAGED_TOL, within=tol_ok,
                   tolerance_bites=bites, equal_bits_twice=twice)
        _check(tol_ok, f"paged decode kernel with slopes ({label}) disagrees with its plain "
               f"version: max abs err {row['max_abs_err']}")
        _check(all(bites.values()), f"paged decode ({label}): the tolerance misses {bites}")
        _check(twice, f"paged decode ({label}): two runs gave different bits")
        if label == "bloom":
            lib, lib_rows = _alibi_sdpa(q, ck, cv, table, lens[:, None], sl)
            b_ms, b_by = _decode_bound(q, ck, table, lens)
            row.update(library_max_abs_err=(lib_rows().float()
                                            - want.float()).abs().max().item(),
                       ms=time_cold(run), host_us=host_us(run),
                       ms_without_slopes=time_cold(
                           lambda: paged_decode_attention(q, ck, cv, table, kvl)),
                       plain_ms=time_plain(lambda: plain(sl)), library_ms=time_cold(lib),
                       library="SDPA, bf16 relative-ALiBi mask", bound_ms=b_ms,
                       bound_by=b_by)
        rows.append(row)
    return rows


def check_alibi_extend(gen, rng):
    """B3 with slopes: two 256-row chunks ending at ~1,800 and 2,048
    positions, each ALIBI_HEADS layout (timed at BLOOM's); rows < nnew."""
    import torch

    from shuffle_exchange_tpu_torch.ops.paged_attention import (paged_extend_attention,
                                                                paged_extend_reference)

    B, C, bs = 2, 256, 64
    start = np.asarray([ALIBI_MAX_LEN - 256, 1600], np.int32)
    nnew = np.asarray([256, 200], np.int32)
    pick = lambda x: torch.cat([x[b, :n].flatten() for b, n in enumerate(nnew)])
    rows = []
    for label, H, KV, Dh in ALIBI_HEADS:
        ck, cv, table = _paged_inputs(gen, rng, start + nnew, H, KV, Dh, bs, pad=-1)
        q = torch.randn(B, C, H, Dh, generator=gen, device="cuda").bfloat16()
        sl = _slopes(H)
        st, nn = torch.from_numpy(start).cuda(), torch.from_numpy(nnew).cuda()
        run = lambda: paged_extend_attention(q, ck, cv, table, st, nn, alibi_slopes=sl)
        plain = lambda s: paged_extend_reference(q, ck, cv, table, st, nn, p_f32=True,
                                                 alibi_slopes=s)
        got, want = run(), plain(sl)
        checks = [paged_close(got[b, :n], want[b, :n]) for b, n in enumerate(nnew)]
        tol_ok = all(ok for _, ok in checks)
        err = max(e.max().item() for e, _ in checks)
        bites, twice = slope_bites(got, plain, sl, rows=pick), equal_bits_twice(run)
        row = dict(shape=dict(label=label, B=B, C=C, H=H, KV=KV, Dh=Dh, bs=bs,
                              start=start.tolist(), nnew=nnew.tolist(),
                              table_width=int(table.shape[1])),
                   max_abs_err=err, tolerance=PAGED_TOL + " (rows < nnew)", within=tol_ok,
                   tolerance_bites=bites, equal_bits_twice=twice)
        _check(tol_ok, f"paged extend kernel with slopes ({label}) disagrees with its plain "
               f"version: max abs err {err}")
        _check(all(bites.values()), f"paged extend ({label}): the tolerance misses {bites}")
        _check(twice, f"paged extend ({label}): two runs gave different bits")
        if label == "bloom":
            visible = np.minimum(start[:, None] + np.arange(C)[None, :] + 1,
                                 (start + nnew)[:, None])
            lib, lib_rows = _alibi_sdpa(q, ck, cv, table, visible, sl)
            rows_seen = sum(int(s) * int(n) + int(n) * (int(n) + 1) // 2
                            for s, n in zip(start, nnew))
            nbytes = (2 * B * C * H * Dh * 2 + int((start + nnew).sum()) * KV * Dh * 2 * 2
                      + table.numel() * 4 + 2 * B * 4 + H * 4)
            b_ms, b_by = bound(nbytes, 4.0 * rows_seen * H * Dh)
            row.update(library_max_abs_err=(pick(lib_rows().float())
                                            - pick(want.float())).abs().max().item(),
                       ms=time_cold(run), host_us=host_us(run),
                       ms_without_slopes=time_cold(
                           lambda: paged_extend_attention(q, ck, cv, table, st, nn)),
                       plain_ms=time_plain(lambda: plain(sl)), library_ms=time_cold(lib),
                       library="SDPA, bf16 relative-ALiBi mask", bound_ms=b_ms,
                       bound_by=b_by)
        rows.append(row)
    return rows


def check_alibi_split(gen, rng):
    """B5 with slopes at each ALIBI_HEADS layout and split counts 1, 2, 4 and
    the wrapper's own (timed at BLOOM's heads with the wrapper's count);
    each split after the first starts mid-sequence, so a position counted
    from the split's start would show."""
    import torch

    from shuffle_exchange_tpu_torch.ops.fused_decode import (attention_splits,
                                                             fused_paged_decode_attention,
                                                             fused_paged_decode_reference)

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = []
    for label, H, KV, Dh in ALIBI_HEADS:
        q, ck, cv, table, lens = alibi_decode_case(gen, rng, H, KV, Dh)
        sl, kvl = _slopes(H), torch.from_numpy(lens).cuda()
        W = table.shape[1]
        for n in (None, 1, 2, 4):
            splits = attention_splits(len(lens), KV, W, ck.shape[2], sms) if n is None else n
            run = lambda: fused_paged_decode_attention(q, ck, cv, table, kvl, num_splits=n,
                                                       alibi_slopes=sl)
            plain = lambda s: fused_paged_decode_reference(q, ck, cv, table, kvl, splits,
                                                           alibi_slopes=s)
            got, want = run(), plain(sl)
            err, tol_ok = paged_close(got, want)
            bites = slope_bites(got, plain, sl)
            row = dict(shape=dict(label=label, B=len(lens), H=H, KV=KV, Dh=Dh,
                                  bs=ck.shape[2], kv_len=lens.tolist(), table_width=W,
                                  splits=splits, wrapper_splits=n is None),
                       max_abs_err=err.max().item(), tolerance=PAGED_TOL, within=tol_ok,
                       tolerance_bites=bites)
            _check(tol_ok, f"split-K decode kernel with slopes ({label}, splits {splits}) "
                   f"disagrees with its plain version: max abs err {row['max_abs_err']}")
            _check(all(bites.values()), f"split-K decode ({label}, splits {splits}): the "
                   f"tolerance misses {bites}")
            if label == "bloom" and n is None:
                lib = _alibi_sdpa(q, ck, cv, table, lens[:, None], sl)[0]
                b_ms, b_by = _decode_bound(q, ck, table, lens)
                row.update(ms=time_cold(run), host_us=host_us(run),
                           ms_without_slopes=time_cold(lambda: fused_paged_decode_attention(
                               q, ck, cv, table, kvl)),
                           plain_ms=time_plain(lambda: plain(sl)), library_ms=time_cold(lib),
                           library="SDPA, bf16 relative-ALiBi mask", bound_ms=b_ms,
                           bound_by=b_by)
            rows.append(row)
    return rows


def check_qkv_bias(gen, rng):
    """B4 with q/k/v biases and no RoPE, at BLOOM-1b7's and GPT-2's widths,
    with and without a pool, at 8 and 1 rows (timed: BLOOM, pool, 8 rows).
    Dropped biases must fail the tolerance; with a pool, every pool row
    but the appended ones stays as it was."""
    import torch

    from shuffle_exchange_tpu_torch.ops.fused_decode import (fused_qkv_rope,
                                                             fused_qkv_rope_reference)

    rows = []
    for label, wd in (("bloom", BLOOM_WIDTHS), ("gpt2", GPT2_WIDTHS)):
        D, H, KV, Dh = (wd[k] for k in ("D", "H", "KV", "Dh"))
        bs, W = 64, 32
        for pooled in (True, False):
            for B in (8, 1):
                pos = rng.integers(0, W * bs, size=B).astype(np.int32)
                table = np.full((B, W), -1, np.int32)
                table[np.arange(B), pos // bs] = np.arange(1, B + 1)
                y = torch.randn(B, D, generator=gen, device="cuda").bfloat16()
                w = [(torch.randn(D, n * Dh, generator=gen, device="cuda") * D ** -0.5)
                     .bfloat16() for n in (H, KV, KV)]
                b = [(0.5 * torch.randn(n * Dh, generator=gen, device="cuda")).bfloat16()
                     for n in (H, KV, KV)]
                bias = dict(zip(("bq", "bk", "bv"), b))
                pt, tt = torch.from_numpy(pos).cuda(), torch.from_numpy(table).cuda()
                kargs = pargs = ()
                if pooled:
                    pool = [torch.randn(B + 1, KV, bs, Dh, generator=gen, device="cuda")
                            .bfloat16() for _ in range(2)]
                    kp, pp = [p.clone() for p in pool], [p.clone() for p in pool]
                    kargs, pargs = (*kp, tt, pt), (*pp, tt, pt)
                run = lambda: fused_qkv_rope(y, *w, None, None, *kargs, n_heads=H,
                                             kv_heads=KV, **bias)
                plain = lambda **bk: fused_qkv_rope_reference(y, *w, None, None, *pargs,
                                                              n_heads=H, kv_heads=KV, **bk)
                got, want = run(), plain(**bias)
                torch.cuda.synchronize()
                checks = [paged_close(g, wt) for g, wt in zip(got, want)]
                tol_ok = all(ok for _, ok in checks)
                err = max(e.max().item() for e, _ in checks)
                pool_ok = True
                if pooled:
                    appended = torch.zeros(pool[0].shape[:3], dtype=torch.bool, device="cuda")
                    idx = (torch.arange(1, B + 1, device="cuda"), slice(None), pt.long() % bs)
                    appended[idx] = True
                    pool_ok = all(torch.equal(k_[~appended], p_[~appended])
                                  and torch.equal(k_[idx], new)
                                  for k_, p_, new in zip(kp, pool, got[1:]))
                # a plain version that drops the biases must fail, on every output
                dropped = plain() if not pooled else fused_qkv_rope_reference(
                    y, *w, None, None, n_heads=H, kv_heads=KV)
                bites = {"dropped_biases": all(_bites(g, d) for g, d in zip(got, dropped))}
                row = dict(shape=dict(label=label, B=B, D=D, H=H, KV=KV, Dh=Dh, bs=bs,
                                      pos=pos.tolist(), pool=pooled, rope=False, biases=True),
                           max_abs_err=err, tolerance=PAGED_TOL + " per head row",
                           within=tol_ok, tolerance_bites=bites)
                if pooled:
                    row["pool_rows_exact"] = pool_ok
                _check(tol_ok and pool_ok, f"fused QKV with biases, no RoPE ({label}, "
                       f"pool={pooled}, B={B}) disagrees: max abs err {err}, pool rows exact "
                       f"{pool_ok}")
                _check(all(bites.values()), f"fused QKV with biases ({label}): the tolerance "
                       f"misses dropped biases")
                if (label, pooled, B) == ("bloom", True, 8):
                    wqkv, bqkv = torch.cat(w, dim=1), torch.cat(b)
                    n_out = (H + 2 * KV) * Dh
                    nbytes = (D * n_out * 2 + n_out * 2 + B * D * 2 + B * n_out * 2
                              + B * 2 * KV * Dh * 2 + table.size * 4 + B * 4)
                    b_ms, b_by = bound(nbytes, 2.0 * B * D * n_out)
                    row.update(ms=time_cold(run), host_us=host_us(run),
                               ms_without_biases=time_cold(lambda: fused_qkv_rope(
                                   y, *w, None, None, *kargs, n_heads=H, kv_heads=KV)),
                               plain_ms=time_plain(lambda: plain(**bias)),
                               library_ms=time_cold(lambda: torch.addmm(bqkv, y, wqkv)),
                               library="torch.addmm(b, y, [wq|wk|wv]) (projection only)",
                               bound_ms=b_ms, bound_by=b_by)
                rows.append(row)
    return rows


# (activation, gated, norm, biases): BLOOM's form first (timed at 8 and 1
# rows), then each other fusable activation once. They are held to
# QUANT_MLP_TOL, for the reason given there: yn and a are rounded to bf16
# from f32 sums in another order than the plain version's, and the
# layernorm's mean and variance shift yn too, so a few of a row's yn and a
# elements round the other way. Over 40 draws x 5 forms of 8 rows at these
# widths on the H100 that left up to 1.9e-3 of the row's RMS beyond one
# bf16 step of the output (1.7x PAGED_TOL's 1e-3, at outputs near zero).
MLP_FORMS = [("gelu_new", False, "layernorm", True), ("gelu_pytorch_tanh", False, "layernorm", True),
             ("relu", False, "layernorm", True), ("silu", False, "layernorm", True),
             ("swiglu", True, "layernorm", False)]


def check_mlp_forms(gen):
    """B6 at BLOOM-1b7's widths (D 2048, F 8192): layernorm with its bias,
    fc biases, the plain (non-gated) MLP with each of gelu_new,
    gelu_pytorch_tanh, relu and silu, and the gated form under layernorm.
    Dropped fc biases and RMSNorm in place of layernorm must fail the
    tolerance (QUANT_MLP_TOL)."""
    import torch
    import torch.nn.functional as F

    from shuffle_exchange_tpu_torch.ops.fused_decode import fused_mlp, fused_mlp_reference

    D, Fd = BLOOM_WIDTHS["D"], BLOOM_WIDTHS["F"]
    randn = lambda *s, scale=1.0: (scale * torch.randn(*s, generator=gen, device="cuda")).bfloat16()
    ln_w, ln_b = (1 + randn(D, scale=0.1).float()).bfloat16(), randn(D, scale=0.1)
    wg, wu = randn(D, Fd, scale=D ** -0.5), randn(D, Fd, scale=D ** -0.5)
    wd = randn(Fd, D, scale=Fd ** -0.5)
    b_up, b_down = randn(Fd, scale=0.5), randn(D, scale=0.5)
    rows = []
    for act, gated, norm, biased in MLP_FORMS:
        for B in ((8, 1) if act == "gelu_new" else (8,)):
            h = randn(B, D)
            kw = dict(ln_b=ln_b, norm=norm, activation=act)
            bias = dict(b_up=b_up, b_down=b_down) if biased else {}
            g = wg if gated else None
            run = lambda: fused_mlp(h, h, ln_w, wu, wd, g, eps=1e-5, **kw, **bias)
            plain = lambda **o: fused_mlp_reference(h, h, ln_w, wu, wd, g, 1e-5, **{**kw, **bias,
                                                                                    **o})
            got, want = run(), plain()
            err, tol_ok = quant_mlp_close(got, want)
            bite = lambda **o: not quant_mlp_close(got, plain(**o))[1]
            bites = {"rmsnorm_for_layernorm": bite(norm="rmsnorm")}
            if biased:
                bites.update(dropped_b_up=bite(b_up=None), dropped_b_down=bite(b_down=None))
            row = dict(shape=dict(B=B, D=D, F=Fd, activation=act, gated=gated, norm=norm,
                                  biases=biased),
                       max_abs_err=err.max().item(),
                       max_rel_err=(err.max() / want.float().abs().max()).item(),
                       tolerance=QUANT_MLP_TOL, within=tol_ok, tolerance_bites=bites)
            _check(tol_ok, f"fused MLP ({act}, gated={gated}, {norm}, biases={biased}, B={B}) "
                   f"disagrees with its plain version: max abs err {row['max_abs_err']}")
            _check(all(bites.values()), f"fused MLP ({act}, B={B}): the tolerance misses "
                   f"{bites}")
            if act == "gelu_new" and B == 8:
                def cublas_sequence():
                    yn = F.layer_norm(h, (D,), ln_w, ln_b, 1e-5)
                    return h + torch.addmm(b_down, F.gelu(torch.addmm(b_up, yn, wu),
                                                          approximate="tanh"), wd)

                nbytes = 2 * D * Fd * 2 + (Fd + D) * 2 + 2 * D * 2 + 2 * B * D * 2
                b_ms, b_by = bound(nbytes, 2.0 * B * D * Fd * 2)
                row.update(ms=time_cold(run), host_us=host_us(run), plain_ms=time_plain(plain),
                           library_ms=None, cublas_sequence_ms=time_cold(cublas_sequence),
                           cublas_sequence_host_us=host_us(cublas_sequence),
                           bound_ms=b_ms, bound_by=b_by)
            rows.append(row)
    return rows


# ---------------------------------------------------------------------------
# Phase 2k: B2, B3 and B5 over int8 and fp8 KV scale planes
# ---------------------------------------------------------------------------

# (label, H, KV, Dh, ALiBi): Llama-3-8B's heads (timed) and BLOOM-1b7's, with
# its slopes (where slopes and scales meet)
KVQ_HEADS = [("llama", 32, 8, 128, False), ("bloom", 16, 16, 128, True)]
KVQ_MAX_LEN = 2048
KVQ_SPLITS = (None, 1, 2, 4)      # B5: the wrapper's own split count first (timed)


def quantized_pools(ck, cv, fmt):
    """(kq, k_scale, vq, v_scale): bf16 pools quantized on the card as the
    engine quantizes on write (one f32 scale per (token, kv head) row)."""
    import torch

    from shuffle_exchange_tpu_torch.inference.paged import quantize_kv

    store = torch.int8 if fmt == "int8" else torch.float8_e4m3fn
    kq, ks = quantize_kv(ck, store)
    vq, vs = quantize_kv(cv, store)
    return kq, ks, vq, vs


def kvq_bites(got, plain, planes, fmt, rows=lambda x: x):
    """{bite: whether PAGED_TOL catches it}: ``plain(kq, ks, vq, vs)`` on
    broken planes must NOT be within the tolerance of the kernel's output:
    the scale planes dropped (read as 1), the K and V scale planes swapped,
    the scales rolled by one position within each block, and the storage
    misread (int8 as unsigned, e4m3 as e5m2)."""
    import torch

    kq, ks, vq, vs = planes
    broken = {"scales_dropped": (kq, torch.ones_like(ks), vq, torch.ones_like(vs)),
              "planes_swapped": (kq, vs, vq, ks),
              "scales_rolled": (kq, ks.roll(1, dims=-1), vq, vs.roll(1, dims=-1))}
    if fmt == "int8":
        broken["read_unsigned"] = (kq.view(torch.uint8), ks, vq.view(torch.uint8), vs)
    else:
        broken["e4m3_read_as_e5m2"] = (kq.view(torch.float8_e5m2), ks,
                                       vq.view(torch.float8_e5m2), vs)
    return {k: _bites(rows(got), rows(plain(*p))) for k, p in broken.items()}


def _kvq_library(q, planes, table, visible, slopes=None):
    """The yardstick call: gather the rows through the table, dequantize
    them to bf16 and run SDPA over them with a boolean mask of ``visible``
    [B, C] positions (with slopes, _alibi_sdpa's bf16 ALiBi mask)."""
    import torch
    import torch.nn.functional as F

    from shuffle_exchange_tpu_torch.ops.paged_attention import gather_kv

    kq, ks, vq, vs = planes
    vis = torch.from_numpy(np.asarray(visible)).cuda().long()              # [B, C]
    j = torch.arange(table.shape[1] * kq.shape[2], device="cuda")
    mask = j[None, None, None, :] < vis[:, None, :, None]                  # [B, 1, C, S]
    if slopes is not None:
        rel = (j[None, None, :] - (vis - 1)[:, :, None]).float()
        mask = (slopes[None, :, None, None] * rel[:, None]).masked_fill(
            ~mask, float("-inf")).bfloat16()
    qs = q.transpose(1, 2)

    def call():
        k, v = gather_kv(kq, vq, table, ks, vs)
        return F.scaled_dot_product_attention(qs, k.bfloat16().transpose(1, 2),
                                              v.bfloat16().transpose(1, 2), attn_mask=mask,
                                              enable_gqa=True)
    return call


def _kvq_bound(q, kq, table, kv_rows, pairs):
    """The bound of one call: q and out in bf16, each of the ``kv_rows``
    K and V rows read once at 1 byte an element plus its 4-byte scale, the
    table and the lengths; 4 x pairs x H x Dh operations."""
    B, C, H, Dh = q.shape
    KV = kq.shape[1]
    nbytes = 2 * B * C * H * Dh * 2 + kv_rows * KV * (Dh + 4) * 2 + table.numel() * 4 + 2 * B * 4
    return bound(nbytes, 4.0 * pairs * H * Dh)


def quantize_on_card_equals_cpu(gen) -> dict:
    """{fmt: the stored bytes and the scales in which ``quantize_kv`` (the
    engines' quantize-on-write, plain PyTorch) on the card differs from the
    CPU} over bf16 rows of Llama's K shape, zero rows and rows at the
    storage maximum among them: both counts must be 0."""
    import torch

    from shuffle_exchange_tpu_torch.inference.paged import quantize_kv

    x = torch.randn(4096, 8, 128, generator=gen, device="cuda") * torch.rand(
        4096, 8, 1, generator=gen, device="cuda") * 30
    x[0] = 0
    x[1, :, 3] = 448.0
    x[2, :, 5] = -127.0
    x = x.bfloat16()
    out = {}
    for fmt, store in (("int8", torch.int8), ("fp8", torch.float8_e4m3fn)):
        qc, sc = quantize_kv(x, store)
        qh, sh = quantize_kv(x.cpu(), store)
        out[fmt] = {"bytes_differing": int((qc.cpu().view(torch.uint8)
                                            != qh.view(torch.uint8)).sum().item()),
                    "scales_differing": int((sc.cpu() != sh).sum().item())}
    return out


def check_kv_quant(gen, rng):
    """B2, B3 and B5 over int8 and e4m3 pools with their f32 scale planes,
    at Llama-3-8B's heads and BLOOM-1b7's (with its ALiBi slopes): 8
    sequences of up to KVQ_MAX_LEN positions (B2, B5 at 1, 2, 4 splits and
    its own count) and two 256-row chunks ending at ~1,800 and 2,048 (B3),
    pools in shuffled block order with -1 padding, each held to its plain
    version (gather, dequantize in f32) with PAGED_TOL; every kvq_bites bite
    must fail it. Timed at Llama's heads, cold L2, beside the bound (1 byte
    an element plus 4 a row), the plain version, the same kernel over the
    bf16 pool the planes were made from, and dequantize + SDPA on the
    gathered KV. The engines' quantize-on-write first: on the card it must
    give the CPU's bytes and scales. Returns rows by form name."""
    import torch

    from shuffle_exchange_tpu_torch.ops.fused_decode import (attention_splits,
                                                             fused_paged_decode_attention,
                                                             fused_paged_decode_reference)
    from shuffle_exchange_tpu_torch.ops.paged_attention import (paged_decode_attention,
                                                                paged_decode_reference,
                                                                paged_extend_attention,
                                                                paged_extend_reference)

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = {f"{k}[{fmt}]": [] for k in ("paged_decode_attention", "paged_extend_attention",
                                       "fused_paged_decode_attention") for fmt in KV_FORMATS}
    same = quantize_on_card_equals_cpu(gen)
    print(f"[kernel] quantize_kv, the card against the CPU (elements that differ): {same}",
          flush=True)
    _check(not any(n for d in same.values() for n in d.values()),
           f"quantize_kv on the card differs from the CPU's: {same}")
    B, C, bs = 8, 256, 64
    start, nnew = np.asarray([KVQ_MAX_LEN - C, 1600], np.int32), np.asarray([C, 200], np.int32)
    pick = lambda x: torch.cat([x[b, :n].flatten() for b, n in enumerate(nnew)])
    for label, H, KV, Dh, alibi in KVQ_HEADS:
        timed = label == "llama"
        lens = np.concatenate([[KVQ_MAX_LEN], rng.integers(1, KVQ_MAX_LEN + 1, size=B - 1)]
                              ).astype(np.int32)
        ck, cv, table = _paged_inputs(gen, rng, lens, H, KV, Dh, bs, pad=-1)
        q = torch.randn(B, 1, H, Dh, generator=gen, device="cuda").bfloat16()
        eck, ecv, etable = _paged_inputs(gen, rng, start + nnew, H, KV, Dh, bs, pad=-1)
        eq = torch.randn(2, C, H, Dh, generator=gen, device="cuda").bfloat16()
        kvl = torch.from_numpy(lens).cuda()
        st, nn = torch.from_numpy(start).cuda(), torch.from_numpy(nnew).cuda()
        sl = _slopes(H) if alibi else None
        W = table.shape[1]
        visible = np.minimum(start[:, None] + np.arange(C)[None, :] + 1, (start + nnew)[:, None])
        ext_pairs = sum(int(s) * int(n) + int(n) * (int(n) + 1) // 2 for s, n in zip(start, nnew))
        for fmt in KV_FORMATS:
            planes = quantized_pools(ck, cv, fmt)
            eplanes = quantized_pools(eck, ecv, fmt)
            cells = [("paged_decode_attention", None, planes, q,
                      lambda kq, ks, vq, vs: paged_decode_attention(
                          q, kq, vq, table, kvl, alibi_slopes=sl, k_scale=ks, v_scale=vs),
                      lambda kq, ks, vq, vs: paged_decode_reference(
                          q, kq, vq, table, kvl, p_f32=True, alibi_slopes=sl, k_scale=ks,
                          v_scale=vs),
                      lambda: paged_decode_attention(q, ck, cv, table, kvl, alibi_slopes=sl))]
            cells.append(("paged_extend_attention", None, eplanes, eq,
                          lambda kq, ks, vq, vs: paged_extend_attention(
                              eq, kq, vq, etable, st, nn, alibi_slopes=sl, k_scale=ks,
                              v_scale=vs),
                          lambda kq, ks, vq, vs: paged_extend_reference(
                              eq, kq, vq, etable, st, nn, p_f32=True, alibi_slopes=sl,
                              k_scale=ks, v_scale=vs),
                          lambda: paged_extend_attention(eq, eck, ecv, etable, st, nn,
                                                         alibi_slopes=sl)))
            for n in KVQ_SPLITS:
                splits = attention_splits(B, KV, W, bs, sms) if n is None else n
                cells.append(("fused_paged_decode_attention", n, planes, q,
                              lambda kq, ks, vq, vs, n=n: fused_paged_decode_attention(
                                  q, kq, vq, table, kvl, num_splits=n, alibi_slopes=sl,
                                  k_scale=ks, v_scale=vs),
                              lambda kq, ks, vq, vs, s_=splits: fused_paged_decode_reference(
                                  q, kq, vq, table, kvl, s_, alibi_slopes=sl, k_scale=ks,
                                  v_scale=vs),
                              lambda n=n: fused_paged_decode_attention(
                                  q, ck, cv, table, kvl, num_splits=n, alibi_slopes=sl)))
            for name, n, pl, qq, kernel, plain, bf16_pool in cells:
                extend = name == "paged_extend_attention"
                rows = pick if extend else (lambda x: x)
                got, want = kernel(*pl), plain(*pl)
                if extend:   # rows past nnew are padding the engine never reads
                    checks = [paged_close(got[b, :m], want[b, :m]) for b, m in enumerate(nnew)]
                    err, tol_ok = max(e.max().item() for e, _ in checks), all(
                        ok for _, ok in checks)
                else:
                    e, tol_ok = paged_close(got, want)
                    err = e.max().item()
                bites = kvq_bites(got, plain, pl, fmt, rows)
                shape = dict(label=label, fmt=fmt, B=qq.shape[0], C=qq.shape[1], H=H, KV=KV,
                             Dh=Dh, bs=bs, alibi=alibi,
                             table_width=int((etable if extend else table).shape[1]))
                if extend:
                    shape.update(start=start.tolist(), nnew=nnew.tolist())
                else:
                    shape.update(kv_len=lens.tolist())
                if name == "fused_paged_decode_attention":
                    shape.update(splits=attention_splits(B, KV, W, bs, sms) if n is None else n,
                                 wrapper_splits=n is None)
                row = dict(shape=shape, max_abs_err=err,
                           tolerance=PAGED_TOL + (" (rows < nnew)" if extend else ""),
                           within=tol_ok, tolerance_bites=bites)
                what = f"{name} [{fmt}] ({label}, {shape})"
                _check(tol_ok, f"{what} disagrees with its plain version: max abs err {err}")
                _check(all(bites.values()), f"{what}: the tolerance misses {bites}")
                if name != "fused_paged_decode_attention":
                    row["equal_bits_twice"] = equal_bits_twice(lambda: kernel(*pl))
                    _check(row["equal_bits_twice"], f"{what}: two runs gave different bits")
                if timed and n is None:
                    lib = _kvq_library(qq, pl, etable if extend else table,
                                       visible if extend else lens[:, None], sl)
                    row["library_max_abs_err"] = (rows(lib().transpose(1, 2).float())
                                                  - rows(want.float())).abs().max().item()
                    kv_rows = int((start + nnew).sum() if extend else lens.sum())
                    b_ms, b_by = _kvq_bound(qq, pl[0], etable if extend else table, kv_rows,
                                            ext_pairs if extend else kv_rows)
                    row.update(ms=time_cold(lambda: kernel(*pl)),
                               host_us=host_us(lambda: kernel(*pl)),
                               ms_bf16_pool=time_cold(bf16_pool),
                               plain_ms=time_plain(lambda: plain(*pl)),
                               library_ms=time_cold(lib),
                               library="dequantize + SDPA on the gathered KV",
                               bound_ms=b_ms, bound_by=b_by)
                out[f"{name}[{fmt}]"].append(row)
            del planes, eplanes
        del ck, cv, eck, ecv
    torch.cuda.synchronize()
    return out


# ---------------------------------------------------------------------------
# Phase 2l: B15 with splash's element mask (mask_np), through sparse_attention
# ---------------------------------------------------------------------------

# a long-context shape: one sequence of 8,192 positions, 16/4 heads of 128
SPARSE_T, SPARSE_H, SPARSE_KV, SPARSE_D = 8192, 16, 4, 128
SPARSE_EMPTY_T = 1024


def sparse_layouts(seed):
    """(label, SparsityConfig, T, layout): the Fixed and BigBird layouts at
    SPARSE_T (blocks of 128, causal), and a causal layout of 16-blocks at
    SPARSE_EMPTY_T whose sixth query block sees nothing (fully masked rows
    inside a partial tile)."""
    from shuffle_exchange_tpu_torch.ops import sparse_attention as sa

    fixed = sa.FixedSparsityConfig(block=128, num_local_blocks=4, num_global_blocks=1)
    bigbird = sa.BigBirdSparsityConfig(block=128, num_random_blocks=2,
                                       num_sliding_window_blocks=3, num_global_blocks=1,
                                       seed=seed)
    empty = np.tril(np.ones((SPARSE_EMPTY_T // 16,) * 2, bool))
    empty[5] = False
    return [("fixed", fixed, SPARSE_T, fixed.make_layout(SPARSE_T)),
            ("bigbird", bigbird, SPARSE_T, bigbird.make_layout(SPARSE_T)),
            ("empty_rows", sa.SparsityConfig(block=16), SPARSE_EMPTY_T, empty)]


def check_sparse_mask(gen, seed):
    """B15's element-mask form (forward, dq and dk/dv) against its plain
    version (reference_attention with the mask ANDed in, P in f32, the
    zero-row rule) on each sparse_layouts layout, causal: forward within
    PAGED_TOL, lse within LSE_TOL on rows with an allowed key, gradients
    within GRAD_TOL, fully masked rows exactly 0 in out and dq. Bites: the
    mask transposed, the causal AND dropped (forward and gradients), the
    kernels run on a tile map of the layout shifted by one key block (it
    skips allowed entries), and a plain version without the zero-row rule
    (the empty-row layout). impl="dense" on a CUDA tensor must raise.
    Timed at SPARSE_T beside the bound on the allowed pairs' operations,
    SDPA with the boolean mask (enable_gqa, forward and backward) and B15
    unmasked-causal at the same shape."""
    import torch
    import torch.nn.functional as F

    from shuffle_exchange_tpu_torch.ops import sparse_attention as sa
    from shuffle_exchange_tpu_torch.ops.flash_attention import (flash_attention,
                                                                flash_attention_bwd,
                                                                flash_attention_lse,
                                                                reference_attention,
                                                                reference_attention_bwd,
                                                                reference_attention_lse,
                                                                tile_mask)

    fwd_rows, bwd_rows = [], []
    B, H, KV, D = 1, SPARSE_H, SPARSE_KV, SPARSE_D
    for label, cfg, T, layout in sparse_layouts(seed):
        q = torch.randn(B, T, H, D, generator=gen, device="cuda").bfloat16()
        k = torch.randn(B, T, KV, D, generator=gen, device="cuda").bfloat16()
        v = torch.randn(B, T, KV, D, generator=gen, device="cuda").bfloat16()
        dout = torch.randn(B, T, H, D, generator=gen, device="cuda").bfloat16()
        em = sa.element_mask(layout, cfg.block, T, T, True)
        tm = tile_mask(em)
        t0 = time.perf_counter()
        tile_mask(sa.element_mask(np.roll(layout, 1, axis=1), cfg.block, T, T, True))
        map_ms = (time.perf_counter() - t0) * 1e3
        empty = torch.from_numpy(tm.empty_rows).cuda()
        out, lse = flash_attention_lse(q, k, v, False, None, mask=tm)
        want_out, want_lse = reference_attention_lse(q, k, v, False, None, p_f32=True, mask=tm)
        err, tol_ok = paged_close(out, want_out)
        lse_err = (lse - want_lse)[:, :, ~empty].abs().max().item()
        zero_rows = bool((out[:, empty] == 0).all().item())
        got = flash_attention_bwd(q, k, v, out, lse, dout, False, None, mask=tm)
        want = reference_attention_bwd(q, k, v, out, dout, False, None, mask=tm)
        torch.cuda.synchronize()
        gchecks = [grad_close(g, w) for g, w in zip(got, want)]
        errs = {n: e.max().item() for n, (e, _) in zip(("dq", "dk", "dv"), gchecks)}
        zero_rows = zero_rows and bool((got[0][:, empty] == 0).all().item())
        shape = dict(label=label, B=B, T=T, S=T, H=H, KV=KV, D=D, block=cfg.block,
                     causal=True, tiles={s: int((tm.state == i).sum())
                                         for i, s in enumerate(("empty", "full", "partial"))},
                     allowed_pairs=tm.allowed, empty_rows=int(tm.empty_rows.sum()))
        what = f"B15 with an element mask ({label})"
        _check(tol_ok and lse_err <= LSE_TOL, f"{what}: forward disagrees with its plain "
               f"version: max abs err {err.max().item()}, lse {lse_err}")
        _check(all(ok for _, ok in gchecks), f"{what}: backward disagrees with its plain "
               f"version: {errs}")
        _check(zero_rows, f"{what}: a fully masked row is not exactly 0 in out or dq")
        # the bites: broken masks for the plain versions, a shifted tile map for the kernels
        bad = {"mask_transposed": em.T.copy(),
               "causal_dropped": sa.element_mask(layout, cfg.block, T, T, False)}
        fbites = {n: _bites(out, reference_attention(q, k, v, False, None, p_f32=True, mask=m))
                  for n, m in bad.items()}
        gbites = {}
        for n, m in bad.items():
            broken = reference_attention_bwd(q, k, v, out, dout, False, None, mask=m)
            gbites[n] = {g: not grad_close(a, b_)[1]
                         for g, a, b_ in zip(("dq", "dk", "dv"), got, broken)}
            del broken
        shifted = tile_mask(sa.element_mask(np.roll(layout, 1, axis=1), cfg.block, T, T, True))
        s_out, s_lse = flash_attention_lse(q, k, v, False, None, mask=shifted)
        fbites["tile_map_shifted"] = _bites(s_out, want_out)
        s_grads = flash_attention_bwd(q, k, v, out, lse, dout, False, None, mask=shifted)
        gbites["tile_map_shifted"] = {g: not grad_close(a, b_)[1]
                                      for g, a, b_ in zip(("dq", "dk", "dv"), s_grads, want)}
        if tm.empty_rows.any():   # without the zero-row rule a masked row averages V
            uniform = want_out.clone()
            uniform[:, empty] = torch.repeat_interleave(v.float().mean(1), H // KV, dim=1
                                                        )[:, None].to(uniform.dtype)
            fbites["empty_row_nonzero"] = _bites(out, uniform)
        _check(all(fbites.values()), f"{what}: the forward tolerance misses {fbites}")
        _check(all(any(b.values()) for b in gbites.values()),
               f"{what}: the backward tolerance misses {gbites}")
        del s_out, s_lse, s_grads
        fwd = dict(shape=shape, max_abs_err=err.max().item(), lse_max_abs_err=lse_err,
                   tolerance=PAGED_TOL + f" (plain with P in f32); lse {LSE_TOL} abs on rows "
                   "with an allowed key", within=tol_ok, tolerance_bites=fbites,
                   zero_rows_exact=zero_rows, tile_map_ms=map_ms)
        bwd = dict(shape=shape, max_abs_err=max(errs.values()), errs=errs,
                   tolerance=GRAD_TOL, within=True, tolerance_bites=gbites,
                   zero_rows_exact=zero_rows)
        if T == SPARSE_T:
            pairs = tm.allowed * B
            nbytes = 2 * B * T * H * D * 2 + 2 * B * T * KV * D * 2
            f_ms, f_by = bound(nbytes, 4.0 * pairs * H * D)
            b_ms, b_by = bound(2 * nbytes + B * T * H * (D * 2 + 4), 10.0 * pairs * H * D)
            allowed = torch.from_numpy(em).cuda()[None, None]
            qs, ks, vs = (t.transpose(1, 2).contiguous().requires_grad_(True) for t in (q, k, v))
            lib_f = lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=allowed,
                                                           enable_gqa=True)
            lib_out = lib_f()
            dos = dout.transpose(1, 2).contiguous()
            lib_b = lambda: torch.autograd.grad(lib_out, (qs, ks, vs), dos, retain_graph=True)
            with torch.no_grad():
                run = lambda: flash_attention(q, k, v, causal=False, mask=tm)
                causal_run = lambda: flash_attention(q, k, v, causal=True)
                fwd.update(ms=time_cold(run, iters=10), host_us=host_us(run),
                           plain_ms=time_plain(lambda: reference_attention(
                               q, k, v, False, None, p_f32=True, mask=tm)),
                           library_ms=time_cold(lambda: lib_f(), iters=10),
                           library="SDPA with the boolean [T, S] attn_mask, enable_gqa",
                           library_kernels=_sdpa_kernels(lib_f),
                           unmasked_causal_ms=time_cold(causal_run, iters=10),
                           bound_ms=f_ms, bound_by=f_by)
            fwd["tflops"] = 4.0 * pairs * H * D / (fwd["ms"] * 1e-3) / 1e12
            c_out, c_lse = flash_attention_lse(q, k, v, True, None)
            bwd.update(ms=time_cold(lambda: flash_attention_bwd(q, k, v, out, lse, dout, False,
                                                                None, mask=tm), iters=10),
                       host_us=host_us(lambda: flash_attention_bwd(q, k, v, out, lse, dout,
                                                                   False, None, mask=tm)),
                       plain_ms=time_plain(lambda: reference_attention_bwd(
                           q, k, v, out, dout, False, None, mask=tm)),
                       library_ms=time_cold(lib_b, iters=10),
                       library="SDPA backward with the boolean attn_mask",
                       unmasked_causal_ms=time_cold(lambda: flash_attention_bwd(
                           q, k, v, c_out, c_lse, dout, True, None), iters=10),
                       bound_ms=b_ms, bound_by=b_by)
            bwd["tflops"] = 10.0 * pairs * H * D / (bwd["ms"] * 1e-3) / 1e12
            del qs, ks, vs, lib_out, dos, allowed, c_out, c_lse
        fwd_rows.append(fwd)
        bwd_rows.append(bwd)
        del q, k, v, dout, out, lse, want_out, want_lse, got, want
        torch.cuda.empty_cache()
    q = torch.zeros(1, 128, 2, 64, device="cuda", dtype=torch.bfloat16)
    try:
        sa.sparse_attention(q, q, q, sa.FixedSparsityConfig(block=16), impl="dense")
        refused = None
    except ValueError as e:
        refused = str(e)
    _check(refused is not None, "sparse_attention(impl='dense') ran on a CUDA tensor")
    fwd_rows[0]["dense_on_cuda_refused"] = refused
    torch.cuda.synchronize()
    return fwd_rows, bwd_rows


def sparse_user_call(seed):
    """The element-mask form's main path: one user call of
    ``sparse_attention`` on the Fixed layout at SPARSE_T under autograd,
    forward and backward; returns (out finite, grads finite)."""
    import torch

    from shuffle_exchange_tpu_torch.ops import sparse_attention as sa

    label, cfg, T, layout = sparse_layouts(seed)[0]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn(1, T, h, SPARSE_D, generator=gen, device="cuda").bfloat16()
               .requires_grad_(True) for h in (SPARSE_H, SPARSE_KV, SPARSE_KV))
    out = sa.sparse_attention(q, k, v, cfg, causal=True)
    out.float().square().mean().backward()
    torch.cuda.synchronize()
    return (bool(torch.isfinite(out).all().item()),
            all(bool(torch.isfinite(t.grad).all().item()) for t in (q, k, v)))


# ---------------------------------------------------------------------------
# Phases 3g and 4b: serve BLOOM-1b7 and GPT-2 (the ALiBi and learned-position
# families), and hold them at depth 2 against the CPU f32 engine
# ---------------------------------------------------------------------------

# GPT-2 holds 1,024 positions: prompts of 128-960 tokens leave room for the
# 32 new ones; BLOOM-1b7 takes phase 3's 2,048 and its prompts
GPT2_SERVE = dict(SERVE_CONFIG, max_seq_len=1024)
GPT2_V1 = dict(V1_CONFIG, max_seq_len=1024)


def family_serving(name, cfg, seed, card, config=SERVE_CONFIG, v1_config=V1_CONFIG,
                   longest=1024):
    """Phase 3g for one model at full width (as deep as ``cfg``), seeded weights made on
    the card: ``serve()`` with "auto" (which must resolve to the fused path)
    and "xla", ``put()`` + ``decode_loop`` against the single-token ``put()``
    loop, the v1 ``generate`` (each with its launch counters held to what
    the programs imply), and a profiled decode window. Returns the results
    and the weights (phase 4b cuts them to depth 2)."""
    import torch

    from shuffle_exchange_tpu_torch.models import Transformer, param_count

    t0 = time.perf_counter()
    model = Transformer(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(seed), dtype=torch.bfloat16)
    torch.cuda.synchronize()
    # the norm biases an RMSNorm model never reads are drawn all the same (as in JAX)
    n_params = sum(v.numel() for k, v in params.items() if cfg.norm == "layernorm"
                   or not (k.split(".")[-1].startswith("ln") and k.endswith("_b")))
    _check(n_params == param_count(cfg), f"{name}: {n_params} parameters != {param_count(cfg)}")
    print(f"[{name}] init {cfg.n_layers} layers, {n_params} parameters "
          f"({weight_bytes(params) / 1e9:.2f} GB bf16) in {time.perf_counter() - t0:.2f} s",
          flush=True)
    lo = 128
    serves = {}
    for label, dk in (("auto", "auto"), ("xla", "xla")):
        serves[label] = counted_serve(model, params, np.random.default_rng([seed, 1]),
                                      dict(config, decode_kernel=dk), cfg.n_layers, card,
                                      label=f"{name} {label}", prompt_range=(lo, longest))
    _check(serves["auto"]["resolved"] == "pallas",
           f"{name}: decode_kernel auto did not resolve to the fused kernels on the card")
    same = sum(serves["auto"]["tokens"][u] == serves["xla"]["tokens"][u]
               for u in serves["auto"]["tokens"])
    print(f"[{name}] requests with equal tokens on both decode paths (bf16, greedy): {same} "
          f"of {N_PROMPTS}", flush=True)
    prompts = loop_prompts(np.random.default_rng([seed, 5]), cfg.vocab_size, longest=longest)
    loop = put_decode_loop(model, params, prompts, cfg.n_layers, card, config=config,
                           label=f"{name} put")
    v1 = v1_generate(model, params, prompts, cfg.n_layers, card, config=v1_config,
                     label=f"{name} v1 generate")
    traces = {}
    trace = trace_decode_window(model, params, prompts, config=config, prefill=traces)
    print(f"[{name} trace decode_loop] {json.dumps(trace) if trace else 'no device kernels'}",
          flush=True)
    if cfg.position == "alibi":   # the put() prefill's attention is B11, by its kernel's name
        kinds = (traces["prefill"] or {}).get("kernels_by_kind", {})
        b11 = traces["prefill_launches"]["alibi_flash_attention"]
        _check(b11 > 0 and b11 % cfg.n_layers == 0
               and kinds.get("alibi_flash_attention (B11)") == b11
               and not any(k.startswith("flash_attention") for k in kinds),
               f"{name}: the put() prefill's {b11} B11 launches are not its profile's: {kinds}")
    return dict(serve=serves, put_decode_loop=loop, v1_generate=v1, trace_decode=trace,
                trace_prefill=traces["prefill"], params=n_params), params


def trace_decode_window(model, params, prompts, n_steps=8, config=SERVE_CONFIG, prefill=None):
    """Device time by kernel kind over a profiled ``decode_loop`` of
    ``n_steps`` steps, after a ``put()`` of ``prompts`` on a fresh engine
    (profiled too when ``prefill`` is a dict: its trace lands there under
    "prefill", its launches by kernel under "prefill_launches")."""
    from shuffle_exchange_tpu_torch import ops
    from shuffle_exchange_tpu_torch.inference import InferenceConfig, InferenceEngineV2

    eng = InferenceEngineV2(model, params, InferenceConfig(**config))
    uids = list(range(len(prompts)))
    put = lambda: [int(t) for t in eng.put(uids, prompts).argmax(-1)]
    if prefill is None:
        first = put()
    else:
        got, before = {}, ops.launch_counts()
        prefill["prefill"] = profiled(lambda: got.update(first=put()))
        prefill["prefill_launches"] = {k: n - before[k] for k, n in ops.launch_counts().items()}
        first = got["first"]
    return profiled(lambda: eng.decode_loop(uids, first, n_steps))


def family_e2e(name, cfg, params, seed):
    """Phase 4b: the model cut to depth 2, bf16 on the card under "auto" and
    "xla", against the CPU f32 engine: the ``step()``, ``put()`` and v1
    schedules, within E2E_REL_TOL."""
    cfg2 = dataclasses.replace(cfg, n_layers=2)
    state2 = {k: (v[:2] if k.startswith("layers.") else v) for k, v in params.items()}
    e2e = {"step": {}}
    t0 = time.perf_counter()
    for dk in ("auto", "xla"):
        e2e["step"][dk] = e2e_check(cfg2, state2, np.random.default_rng([seed, 2]),
                                    decode_kernel=dk)
    e2e["put"] = e2e_put_check(cfg2, state2, np.random.default_rng([seed, 7]))
    e2e["v1"] = e2e_v1_check(cfg2, state2, np.random.default_rng([seed, 8]))
    print(f"[e2e {name}] depth 2: step(), put() and v1 schedules in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    report_e2e(f"{name} ", e2e)
    return e2e


def kv_e2e(name, cfg, card_state, seed, formats=KV_FORMATS):
    """Phase 4c: a model cut to depth 2 with int8 and with fp8 KV on the
    card (bf16 weights) against the CPU f32 engine in the same KV mode:
    the ``step()`` schedule under "auto" and the ``put()`` schedule under
    "auto" and "xla", within E2E_REL_TOL."""
    e2e = {}
    t0 = time.perf_counter()
    for fmt in formats:
        e2e[f"step {fmt}"] = {"auto": e2e_check(cfg, card_state, np.random.default_rng([seed, 2]),
                                                kv=fmt)}
        e2e[f"put {fmt}"] = e2e_put_check(cfg, card_state, np.random.default_rng([seed, 7]),
                                          kv=fmt)
    print(f"[e2e {name} KV] depth 2: step() and put() schedules, {' and '.join(formats)} KV, "
          f"in {time.perf_counter() - t0:.2f} s", flush=True)
    report_e2e(f"{name} ", e2e, "the CPU f32 engine in the same KV mode")
    return e2e


# ---------------------------------------------------------------------------
# Phases 3i and 4d: quantized-weight and multi-tenant serving of BLOOM-1b7
# and GPT-2 (the layernorm / gelu / bias families), on phase 3g's weights
# ---------------------------------------------------------------------------

# BLOOM-1b7 serves every format, GPT-2 int8
FAMILY_QUANT = {"bloom-1b7": QUANT_FORMATS, "gpt2-small": (8,)}


def _fmt(bits) -> str:
    return "fp8" if bits == "fp8" else f"int{bits}"


def family_quant_serving(name, cfg, params, seed, card, config=SERVE_CONFIG,
                         v1_config=V1_CONFIG, longest=1024):
    """Phase 3i for one model, on phase 3g's bf16 weights (each engine
    quantizes them on the card and is freed before the next). For each
    format of FAMILY_QUANT: a counted ``serve()`` under "auto" (which must
    resolve to the fused path) and "xla", ``put()`` + ``decode_loop``
    against the single-token ``put()`` loop and the v1 ``generate``, each
    with its launch counters held to the programs: B8 on q, k, v, wo, w_up
    and w_down, and B7 never (the fc biases keep the MLP on the layer body,
    as in JAX); the weight bytes against bf16. BLOOM-1b7 then serves: its
    widths without fc biases (``mlp_bias=False``), int8, under "auto",
    where B7 runs once a layer and decode row in its layernorm + plain +
    gelu_new form; multi-tenant (phase 3f's pool and tenants, the
    8-adapter stripe) on the bf16 base and on an int8 base; and a profiled
    8-step int8 ``decode_loop`` (the idle share)."""
    import torch

    from shuffle_exchange_tpu_torch.models import Transformer

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    model, L = Transformer(cfg), cfg.n_layers
    dense_bytes = weight_bytes(params)
    prompts = loop_prompts(np.random.default_rng([seed, 5]), cfg.vocab_size, longest=longest)
    out = {"serve": {}, "put_decode_loop": {}, "v1_generate": {},
           "dense_weight_bytes": dense_bytes}
    runs = []
    for bits in FAMILY_QUANT[name]:
        fmt, qconf = _fmt(bits), dict(config, **_quant(bits))
        for dk in ("auto", "xla"):
            r = counted_serve(model, params, np.random.default_rng([seed, 1]),
                              dict(qconf, decode_kernel=dk), L, card,
                              label=f"{name} {fmt} {dk}", prompt_range=(128, longest))
            _check(dk != "auto" or r["resolved"] == "pallas", f"{name} {fmt}: decode_kernel "
                   "auto did not resolve to the fused kernels on the card")
            _check(r["launches"]["fused_mlp_quant"] == 0 and r["launches"]["quant_matmul"] > 0,
                   f"{name} {fmt} {dk}: the quantized MLP with fc biases left the layer body")
            print(f"[serve {name} {fmt} {dk}] weights {r['weight_bytes'] / 1e9:.3f} GB against "
                  f"{dense_bytes / 1e9:.3f} GB in bf16 ({r['weight_bytes'] / dense_bytes:.3f})",
                  flush=True)
            r["tokens"] = {int(u): t for u, t in r["tokens"].items()}
            out["serve"][f"{fmt} {dk}"] = r
            runs.append(r["launches"])
            free()
        out["put_decode_loop"][fmt] = put_decode_loop(model, params, prompts, L, card,
                                                      config=qconf, label=f"{name} put {fmt}")
        free()
        out["v1_generate"][fmt] = v1_generate(model, params, prompts, L, card,
                                              config=dict(v1_config, **_quant(bits)),
                                              label=f"{name} v1 generate {fmt}")
        runs += [out["put_decode_loop"][fmt]["launches"], out["v1_generate"][fmt]["launches"]]
        free()
    out["runs"] = runs
    if name != "bloom-1b7":
        return out
    # BLOOM-1b7's widths without fc biases: B7's layernorm + plain + gelu_new form
    nb_cfg = dataclasses.replace(cfg, mlp_bias=False)
    nb_params = {k: v for k, v in params.items() if k not in ("layers.b_up", "layers.b_down")}
    r = counted_serve(Transformer(nb_cfg), nb_params, np.random.default_rng([seed, 1]),
                      dict(config, **_quant(8)), L, card, label=f"{name} mlp_bias=False int8",
                      prompt_range=(128, longest))
    _check(r["resolved"] == "pallas" and r["launches"]["fused_mlp_quant"] > 0,
           f"{name} mlp_bias=False int8: B7 did not run ({r['launches']})")
    r["tokens"] = {int(u): t for u, t in r["tokens"].items()}
    out["serve"]["nobias int8 auto"] = r
    out["b7_form_launches"] = r["launches"]["fused_mlp_quant"]
    runs.append(r["launches"])
    del nb_params
    free()
    # multi-tenant: phase 3f's pool and tenants, 24 requests over 8 adapters
    out["multi_tenant"] = {}
    for base, bits in (("bf16", None), ("int8", 8)):
        mt = multi_tenant_serving(model, params, prompts, L, card, seed, stripes=(8,),
                                  config=dict(MT_CONFIG, **_quant(bits)),
                                  label=f"{name} multi-tenant {base}", put_loop=False)
        out["multi_tenant"][base] = mt["stripes"][8]
        runs.append(mt["stripes"][8]["launches"])
        free()
    out["trace_decode"] = trace_decode_window(model, params, prompts,
                                              config=dict(config, **_quant(8)))
    print(f"[trace {name} decode_loop int8] "
          f"{json.dumps(out['trace_decode']) if out['trace_decode'] else 'no device kernels'}",
          flush=True)
    free()
    return out


def family_quant_e2e(name, cfg, params, seed):
    """Phase 4d: BLOOM-1b7 cut to depth 2 with int8 weights on the card
    against the CPU f32 engine fed the weights it serves: the ``step()``
    schedule under "auto" and "xla" and the ``put()`` schedule under both,
    and its widths without fc biases (B7's layernorm form on the decode
    rows) under "auto", within E2E_REL_TOL."""
    cfg2 = dataclasses.replace(cfg, n_layers=2)
    state2 = {k: (v[:2] if k.startswith("layers.") else v) for k, v in params.items()}
    nb_cfg2 = dataclasses.replace(cfg2, mlp_bias=False)
    nb_state2 = {k: v for k, v in state2.items() if k not in ("layers.b_up", "layers.b_down")}
    t0 = time.perf_counter()
    e2e = {"step": {dk: e2e_check(cfg2, state2, np.random.default_rng([seed, 2]),
                                  decode_kernel=dk, quant_bits=8) for dk in ("auto", "xla")},
           "put": e2e_put_check(cfg2, state2, np.random.default_rng([seed, 7]), quant_bits=8)}
    e2e["step"]["auto mlp_bias=False"] = e2e_check(nb_cfg2, nb_state2,
                                                   np.random.default_rng([seed, 2]), quant_bits=8)
    print(f"[e2e {name} int8] depth 2: step() and put() schedules in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    report_e2e(f"{name} int8 ", e2e, "the CPU f32 engine")
    return e2e


# ---------------------------------------------------------------------------
# Phases 2n, 3j and 4e: parallel-block serving (GPT-J-6B, Pythia-1.4b)
# ---------------------------------------------------------------------------

# the published configs (EleutherAI/gpt-j-6b, EleutherAI/pythia-1.4b), as the
# fields config_from_hf reads them
GPTJ_6B = {"architectures": ["GPTJForCausalLM"], "model_type": "gptj", "n_embd": 4096,
           "n_head": 16, "n_layer": 28, "n_positions": 2048, "rotary_dim": 64,
           "vocab_size": 50400, "activation_function": "gelu_new", "layer_norm_epsilon": 1e-5,
           "tie_word_embeddings": False}
PYTHIA_1B4 = {"architectures": ["GPTNeoXForCausalLM"], "model_type": "gpt_neox",
              "hidden_size": 2048, "intermediate_size": 8192, "num_attention_heads": 16,
              "num_hidden_layers": 24, "max_position_embeddings": 2048, "rotary_pct": 0.25,
              "rotary_emb_base": 10000, "use_parallel_residual": True, "vocab_size": 50304,
              "hidden_act": "gelu", "layer_norm_eps": 1e-5, "tie_word_embeddings": False}
GPTJ_WIDTHS = dict(D=4096, H=16, KV=16, Dh=256, F=16384)
PYTHIA_WIDTHS = dict(D=2048, H=16, KV=16, Dh=128, F=8192, rd=32)
PB_MAX_LEN = 2048


def check_mlp_no_norm(gen):
    """B6 and B7 with ``apply_norm=False`` (GPT-J's shared layernorm: yn is
    y_src as given) at GPT-J-6B's widths (D 4096, F 16384, gelu_new): B6
    with the fc biases, B7 in int8 / int4 / fp8 at group 256 without them
    (the ``mlp_bias=False`` form), 8 and 1 rows, y_src != resid; held to
    QUANT_MLP_TOL. Bites: the layernorm applied anyway, ``ln_b`` read (added
    to y_src), y_src swapped for resid, B6's b_down dropped. Timed at 8 rows (B6 bf16, B7 each
    format) beside the bound, the plain version and the cuBLAS sequence
    (B7: dequantize + that sequence)."""
    import torch
    import torch.nn.functional as F

    from shuffle_exchange_tpu_torch.ops.fused_decode import (fused_mlp, fused_mlp_quant_reference,
                                                             fused_mlp_reference)
    from shuffle_exchange_tpu_torch.ops.quant_matmul import quantize_weight

    D, Fd = GPTJ_WIDTHS["D"], GPTJ_WIDTHS["F"]
    randn = lambda *s, scale=1.0: (scale * torch.randn(*s, generator=gen, device="cuda")).bfloat16()
    ln_w, ln_b = (1 + randn(D, scale=0.1).float()).bfloat16(), randn(D, scale=0.5)
    wu, wd = randn(D, Fd, scale=D ** -0.5), randn(Fd, D, scale=Fd ** -0.5)
    b_up, b_down = randn(Fd, scale=0.5), randn(D, scale=0.5)
    forms = [("bf16", None)] + [(_fmt(b), b) for b in QUANT_FORMATS]
    rows = []
    with _f32_reduction():
        for fmt, bits in forms:
            if bits is None:
                up, down, bias = wu, wd, dict(b_up=b_up, b_down=b_down)
                ref = lambda r, y, **o: fused_mlp_reference(r, y, ln_w, up, down, None, 1e-5,
                                                            **{**kw, **bias, **o})
            else:
                up, down = (quantize_weight(w, 256, bits=bits) for w in (wu, wd))
                bias = {}
                ref = lambda r, y, **o: fused_mlp_quant_reference(r, y, ln_w, up, down, None,
                                                                  1e-5, **{**kw, **o})
            kw = dict(ln_b=ln_b, norm="layernorm", activation="gelu_new", apply_norm=False)
            for B in (8, 1):
                resid, y = randn(B, D), randn(B, D)
                run = lambda: fused_mlp(resid, y, ln_w, up, down, None, eps=1e-5, **kw, **bias)
                got, want = run(), ref(resid, y)
                err, tol_ok = quant_mlp_close(got, want)
                bite = lambda r, yy, **o: not quant_mlp_close(got, ref(r, yy, **o))[1]
                bites = {"norm_applied": bite(resid, y, apply_norm=True),
                         "ln_b_read": bite(resid, (y.float() + ln_b.float()).bfloat16()),
                         "y_src_swapped_for_resid": bite(resid, resid)}
                if bits is None:   # B6's fc biases
                    bites["b_down_dropped"] = bite(resid, y, b_down=None)
                row = dict(shape=dict(B=B, D=D, F=Fd, fmt=fmt, gs=None if bits is None else 256,
                                      activation="gelu_new", norm="none", biases=bits is None),
                           max_abs_err=err.max().item(),
                           max_rel_err=(err.max() / want.float().abs().max()).item(),
                           tolerance=QUANT_MLP_TOL, within=tol_ok, tolerance_bites=bites)
                _check(tol_ok, f"fused MLP without its norm ({fmt}, B={B}) disagrees with its "
                       f"plain version: max abs err {row['max_abs_err']}")
                _check(all(bites.values()), f"fused MLP without its norm ({fmt}, B={B}): the "
                       f"tolerance misses {bites}")
                if B == 8:
                    wbytes = (2 * D * Fd * 2 + (Fd + D) * 2 if bits is None
                              else up.nbytes + down.nbytes)
                    nbytes = wbytes + 3 * B * D * 2
                    b_ms, b_by = bound(nbytes, 4.0 * B * D * Fd)
                    if bits is None:
                        lib = lambda: resid + torch.addmm(b_down, F.gelu(
                            torch.addmm(b_up, y, wu), approximate="tanh"), wd)
                        name = "the cuBLAS sequence (no one call)"
                    else:
                        lib = lambda: resid + F.gelu(y @ up.dequantize(), approximate="tanh") \
                            @ down.dequantize()
                        name = "dequantize() + the cuBLAS sequence"
                    row.update(ms=time_cold(run), host_us=host_us(run),
                               plain_ms=time_plain(lambda: ref(resid, y)),
                               library_ms=time_cold(lib) if bits is not None else None,
                               cublas_sequence_ms=time_cold(lib), library=name,
                               bound_ms=b_ms, bound_by=b_by)
                rows.append(row)
            del up, down
            torch.cuda.empty_cache()
    return rows


@contextlib.contextmanager
def _broken_rope(kind, rd):
    """The plain versions with a broken partial rotary (``rope_heads``
    replaced): "all_of_dh" rotates every column (the angles of rd/2 columns
    tiled over Dh/2), "partner_at_dh_half" pairs column d < rd/2 with d +
    Dh/2, "pass_through_rotated" also rotates columns >= rd by the same
    angles (tiled)."""
    import torch

    from shuffle_exchange_tpu_torch.ops import fused_decode as fd

    orig = fd.rope_heads

    def tiled(c, n):
        return c.repeat(1, -(-n // c.shape[1]))[:, :n]

    def broken(x, cos, sin):
        Dh, h = x.shape[-1], rd // 2
        if kind == "all_of_dh":
            return orig(x, tiled(cos, Dh // 2), tiled(sin, Dh // 2))
        if kind == "partner_at_dh_half":
            c, s = cos[:, None, :], sin[:, None, :]
            out = x.clone()
            x1, x2 = x[..., :h], x[..., Dh // 2:Dh // 2 + h]
            out[..., :h] = x1 * c - x2 * s
            out[..., Dh // 2:Dh // 2 + h] = x2 * c + x1 * s
            return out
        rest = Dh - rd
        return torch.cat([orig(x[..., :rd], cos, sin),
                          orig(x[..., rd:], tiled(cos, rest // 2), tiled(sin, rest // 2))], -1)

    fd.rope_heads = broken
    try:
        yield
    finally:
        fd.rope_heads = orig


PARTIAL_ROPE_BITES = ("all_of_dh", "partner_at_dh_half", "pass_through_rotated")


PARTIAL_ROPE_LAYOUTS = (("pythia", 16, 16), ("gqa", 16, 4))


def check_qkv_partial_rope(gen, rng, widths=PYTHIA_WIDTHS, layouts=PARTIAL_ROPE_LAYOUTS,
                           forms=((True, 8), (True, 1), (False, 8), (False, 1))):
    """B4 with partial rotary and q/k/v biases at ``widths`` (Pythia-1.4b's:
    rd 32 of Dh 128, D 2048; Pythia-2.8b's rd 20 of 80 in phase 2p), at each
    (label, H, KV) of ``layouts`` (Pythia-1.4b's 16 x 128 and a GQA 16 x 4)
    and each (pool, rows) of ``forms`` (timed: the first), held to
    PAGED_TOL; every PARTIAL_ROPE_BITES bite must fail it, and with a pool
    every pool row but the appended ones stays as it was."""
    import torch

    from shuffle_exchange_tpu_torch.models.transformer import rope_table
    from shuffle_exchange_tpu_torch.ops.fused_decode import (fused_qkv_rope,
                                                             fused_qkv_rope_reference)

    D, Dh, rd = widths["D"], widths["Dh"], widths["rd"]
    bs, W = 64, 32
    cos_t, sin_t = rope_table(W * bs, rd, 10000.0, device="cuda")
    rows = []
    for label, H, KV in layouts:
        for pooled, B in forms:
            pos = rng.integers(0, W * bs, size=B).astype(np.int32)
            table = np.full((B, W), -1, np.int32)
            table[np.arange(B), pos // bs] = np.arange(1, B + 1)
            y = torch.randn(B, D, generator=gen, device="cuda").bfloat16()
            w = [(torch.randn(D, n * Dh, generator=gen, device="cuda") * D ** -0.5)
                 .bfloat16() for n in (H, KV, KV)]
            b = [(0.5 * torch.randn(n * Dh, generator=gen, device="cuda")).bfloat16()
                 for n in (H, KV, KV)]
            bias = dict(zip(("bq", "bk", "bv"), b))
            pt, tt = torch.from_numpy(pos).cuda(), torch.from_numpy(table).cuda()
            cos, sin = cos_t[pt.long()].contiguous(), sin_t[pt.long()].contiguous()
            kargs = pargs = ()
            if pooled:
                pool = [torch.randn(B + 1, KV, bs, Dh, generator=gen, device="cuda")
                        .bfloat16() for _ in range(2)]
                kp = [p.clone() for p in pool]
                kargs = (*kp, tt, pt)
            run = lambda: fused_qkv_rope(y, *w, cos, sin, *kargs, n_heads=H, kv_heads=KV,
                                         **bias)
            plain = lambda: fused_qkv_rope_reference(y, *w, cos, sin, n_heads=H,
                                                     kv_heads=KV, **bias)
            got, want = run(), plain()
            torch.cuda.synchronize()
            checks = [paged_close(g, wt) for g, wt in zip(got, want)]
            tol_ok = all(ok for _, ok in checks)
            err = max(e.max().item() for e, _ in checks)
            pool_ok = True
            if pooled:
                appended = torch.zeros(pool[0].shape[:3], dtype=torch.bool, device="cuda")
                idx = (torch.arange(1, B + 1, device="cuda"), slice(None), pt.long() % bs)
                appended[idx] = True
                pool_ok = all(torch.equal(k_[~appended], p_[~appended])
                              and torch.equal(k_[idx], new)
                              for k_, p_, new in zip(kp, pool, got[1:]))
            bites = {}
            for kind in PARTIAL_ROPE_BITES:   # q and k rotate: either must show it
                with _broken_rope(kind, rd):
                    broken = plain()
                bites[kind] = _bites(got[0], broken[0]) and _bites(got[1], broken[1])
            row = dict(shape=dict(label=label, B=B, D=D, H=H, KV=KV, Dh=Dh, rd=rd, bs=bs,
                                  pos=pos.tolist(), pool=pooled, biases=True),
                       max_abs_err=err, tolerance=PAGED_TOL + " per head row",
                       within=tol_ok, tolerance_bites=bites)
            if pooled:
                row["pool_rows_exact"] = pool_ok
            _check(tol_ok and pool_ok, f"fused QKV with partial rotary ({label}, "
                   f"pool={pooled}, B={B}) disagrees: max abs err {err}, pool rows exact "
                   f"{pool_ok}")
            _check(all(bites.values()), f"fused QKV with partial rotary ({label}): the "
                   f"tolerance misses {bites}")
            if not rows:
                wqkv, bqkv = torch.cat(w, dim=1), torch.cat(b)
                n_out = (H + 2 * KV) * Dh
                nbytes = (D * n_out * 2 + n_out * 2 + B * D * 2 + B * n_out * 2
                          + 2 * B * (rd // 2) * 4 + B * 2 * KV * Dh * 2 + table.size * 4
                          + B * 4)
                b_ms, b_by = bound(nbytes, 2.0 * B * D * n_out)
                row.update(ms=time_cold(run), host_us=host_us(run),
                           plain_ms=time_plain(plain),
                           library_ms=time_cold(lambda: torch.addmm(bqkv, y, wqkv)),
                           library="torch.addmm(b, y, [wq|wk|wv]) (projection only)",
                           bound_ms=b_ms, bound_by=b_by)
            rows.append(row)
    return rows


def attention_bites(got, plain, q, rows=lambda x: x, pass_heads=None):
    """{bite: whether PAGED_TOL catches it}: the plain version with the
    softmax scale of head_dim 128 (q scaled by sqrt(2) in f32) and with each
    query head reading its neighbour's q; given the heads of one pass of
    the decode kernels over a group wider than a pass, also each query head
    reading the q of the head one pass on (a pass's head offset lost)."""
    bites = {"scale_of_dh_128": _bites(rows(got), rows(plain(q.float() * 2 ** 0.5))),
             "neighbouring_head": _bites(rows(got), rows(plain(q.roll(1, dims=2))))}
    if pass_heads is not None:
        bites["head_one_pass_on"] = _bites(rows(got), rows(plain(q.roll(-pass_heads, dims=2))))
    return bites


def head_dim_bites(got, plain, q, rows=lambda x: x):
    """{bite: whether PAGED_TOL catches it} of the head dims 80 and 96: the
    plain version with the softmax scale of the nearest other built head
    dim (64 at 80, 128 at 96: q scaled by sqrt(Dh / other) in f32), and its
    output with every head's columns shifted by one."""
    Dh = q.shape[-1]
    other = 64 if Dh < 96 else 128
    want = plain(q)
    return {f"softmax_scale_of_dh_{other}": _bites(rows(got), rows(plain(q.float() * (Dh / other) ** 0.5))),
            "columns_shifted": _bites(rows(got), rows(want.roll(1, dims=-1)))}


def check_paged_heads(gen, rng, H, KV, Dh, suffix, decode_rows=(8,), pools=("bf16",) + KV_FORMATS,
                      timed=("bf16",), alibi=False, dim_bites=False):
    """B2, B5 and B3 at H query heads of Dh over KV kv heads: 8 sequences of
    up to PB_MAX_LEN positions (B3: two 256-row chunks ending at 2,048 and
    1,800) in shuffled pool order with -1 padding, and for each other count
    in ``decode_rows`` the first sequences of those alone (the first is
    2,048 long), over each of ``pools`` (bf16, or int8 / fp8 with their
    scale planes); with ``alibi``, one more bf16 pass with slopes. Held to
    PAGED_TOL (the plain versions with P in f32); every attention_bites bite
    must fail it, and with ``dim_bites`` every head_dim_bites bite too. The
    ``timed`` pools' cells are timed beside their bound, plain version and
    SDPA over the gathered K/V. Returns {form[suffix]: rows}."""
    import torch
    import torch.nn.functional as F

    from shuffle_exchange_tpu_torch.ops.fused_decode import (attention_splits,
                                                             fused_paged_decode_attention,
                                                             fused_paged_decode_reference)
    from shuffle_exchange_tpu_torch.ops.paged_attention import (decode_passes,
                                                                paged_decode_attention,
                                                                paged_decode_reference,
                                                                paged_extend_attention,
                                                                paged_extend_reference)

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    per_pass, n_passes = decode_passes(H // KV, Dh)
    q8, ck, cv, table8, lens8 = alibi_decode_case(gen, rng, H, KV, Dh)
    B, C, bs = 2, 256, 64
    start = np.asarray([PB_MAX_LEN - 256, 1600], np.int32)
    nnew = np.asarray([256, 200], np.int32)
    eck, ecv, etable = _paged_inputs(gen, rng, start + nnew, H, KV, Dh, bs, pad=-1)
    eq = torch.randn(B, C, H, Dh, generator=gen, device="cuda").bfloat16()
    st, nn = torch.from_numpy(start).cuda(), torch.from_numpy(nnew).cuda()
    pick = lambda x: torch.cat([x[b, :n].flatten() for b, n in enumerate(nnew)])
    visible = np.minimum(start[:, None] + np.arange(C)[None, :] + 1, (start + nnew)[:, None])
    pairs = sum(int(s) * int(n) + int(n) * (int(n) + 1) // 2 for s, n in zip(start, nnew))
    slopes = _slopes(H) if alibi else None
    names = {f: f"{f}[{suffix}]" for f in ("paged_decode_attention",
                                           "fused_paged_decode_attention",
                                           "paged_extend_attention")}
    out = {n: [] for n in names.values()}
    passes = [(fmt, None) for fmt in pools] + ([("bf16", slopes)] if alibi else [])
    for fmt, sl in passes:
        if fmt == "bf16":
            planes, eplanes, sc, esc = (ck, None, cv, None), (eck, None, ecv, None), {}, {}
        else:
            planes, eplanes = quantized_pools(ck, cv, fmt), quantized_pools(eck, ecv, fmt)
            sc = dict(k_scale=planes[1], v_scale=planes[3])
            esc = dict(k_scale=eplanes[1], v_scale=eplanes[3])
        kq, vq, ekq, evq = planes[0], planes[2], eplanes[0], eplanes[2]
        # (bf16 K, bf16 V, the served planes, index words a row) of each kernel's pool
        dec_src, ext_src = (ck, cv, planes, 1), (eck, ecv, eplanes, 2)
        cells = []
        for nb in decode_rows:
            q, table, lens = q8[:nb], table8[:nb], lens8[:nb]
            kvl = torch.from_numpy(lens).cuda()
            splits = attention_splits(nb, KV, table.shape[1], bs, sms)
            cells += [
                (names["paged_decode_attention"], dict(B=nb, kv_len=lens.tolist(),
                                                       table_width=int(table.shape[1])),
                 lambda q=q, t=table, k=kvl: paged_decode_attention(q, kq, vq, t, k,
                                                                    alibi_slopes=sl, **sc),
                 lambda qq, t=table, k=kvl: paged_decode_reference(qq, kq, vq, t, k, p_f32=True,
                                                                   alibi_slopes=sl, **sc),
                 q, lambda x: x, table, lens[:, None], int(lens.sum()), int(lens.sum()), dec_src),
                (names["fused_paged_decode_attention"],
                 dict(B=nb, kv_len=lens.tolist(), table_width=int(table.shape[1]),
                      splits=splits),
                 lambda q=q, t=table, k=kvl: fused_paged_decode_attention(
                     q, kq, vq, t, k, alibi_slopes=sl, **sc),
                 lambda qq, t=table, k=kvl, n=splits: fused_paged_decode_reference(
                     qq, kq, vq, t, k, n, alibi_slopes=sl, **sc),
                 q, lambda x: x, table, lens[:, None], int(lens.sum()), int(lens.sum()), dec_src)]
        cells.append(
            (names["paged_extend_attention"], dict(B=B, C=C, start=start.tolist(),
                                                   nnew=nnew.tolist(),
                                                   table_width=int(etable.shape[1])),
             lambda: paged_extend_attention(eq, ekq, evq, etable, st, nn, alibi_slopes=sl,
                                            **esc),
             lambda qq: paged_extend_reference(qq, ekq, evq, etable, st, nn, p_f32=True,
                                               alibi_slopes=sl, **esc),
             eq, pick, etable, visible, int((start + nnew).sum()), pairs, ext_src))
        for form, shape, run, plain, qq, rows_of, table, vis, kv_rows, n_pairs, src in cells:
            got, want = run(), plain(qq)
            err, tol_ok = paged_close(rows_of(got), rows_of(want))
            bites = attention_bites(got, plain, qq, rows_of,
                                    pass_heads=per_pass if n_passes > 1 and "extend" not in form
                                    else None)
            if dim_bites:
                bites.update(head_dim_bites(got, plain, qq, rows_of))
            row = dict(shape=dict(H=H, KV=KV, Dh=Dh, bs=64, pool=fmt, alibi=sl is not None,
                                  heads_a_pass=per_pass, **shape),
                       max_abs_err=err.max().item(), tolerance=PAGED_TOL, within=tol_ok,
                       tolerance_bites=bites)
            _check(tol_ok, f"{form} over a {fmt} pool{' with slopes' if sl is not None else ''} "
                   f"disagrees with its plain version: max abs err {row['max_abs_err']}")
            _check(all(bites.values()), f"{form} ({fmt} pool): the tolerance misses {bites}")
            if not form.startswith("fused"):
                row["equal_bits_twice"] = equal_bits_twice(run)
                _check(row["equal_bits_twice"], f"{form} ({fmt} pool): two runs gave different "
                       f"bits")
            if fmt in timed and sl is None:
                k16, v16, served, words = src
                if fmt == "bf16":
                    nbytes = (2 * qq.numel() * 2 + kv_rows * KV * Dh * 4 + table.numel() * 4
                              + words * qq.shape[0] * 4)
                    b_ms, b_by = bound(nbytes, 4.0 * n_pairs * H * Dh)
                    qs, ks, vs, mask = _sdpa_inputs(qq, k16, v16, table, vis)
                    lib = lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask,
                                                                 enable_gqa=True)
                    what = "SDPA over the gathered K/V, boolean mask"
                else:
                    b_ms, b_by = _kvq_bound(qq, served[0], table, kv_rows, n_pairs)
                    lib = _kvq_library(qq, served, table, vis)
                    what = "dequantize + SDPA over the gathered K/V"
                row.update(ms=time_cold(run), host_us=host_us(run),
                           plain_ms=time_plain(lambda: plain(qq)), library_ms=time_cold(lib),
                           library=what, bound_ms=b_ms, bound_by=b_by)
            out[form].append(row)
    return out


# (B, T, S, H, KV, Dh, causal): the GPT-J prefill's shape first (timed, the
# kernels line's), a GQA layout with ragged T, and full attention T < S
FLASH_256_SHAPES = [(8, 1024, 1024, 16, 16, 256, True), (2, 1000, 1000, 16, 4, 256, True),
                    (2, 200, 1000, 16, 16, 256, False)]


def check_flash_forward(gen, shapes=FLASH_256_SHAPES, dim_bites=False):
    """The flash forward at ``shapes`` (FLASH_256_SHAPES: head_dim 256;
    FLASH_FALCON_SHAPES in phase 2o, FLASH_HEAD_DIM_SHAPES in 2p) against
    its plain version with P in f32, within PAGED_TOL. The first shape is
    timed beside the bound and SDPA (its backend named); there two launches
    give equal bits, and a plain version with the causal diagonal shifted
    by one, one with the softmax scale of head_dim 128 and one reading the
    neighbouring head's q must fail the tolerance."""
    import torch
    import torch.nn.functional as F

    from shuffle_exchange_tpu_torch.ops.flash_attention import (flash_attention,
                                                                reference_attention)

    rows = []
    for i, (B, T, S, H, KV, Dh, causal) in enumerate(shapes):
        q = torch.randn(B, T, H, Dh, generator=gen, device="cuda").bfloat16()
        k = torch.randn(B, S, KV, Dh, generator=gen, device="cuda").bfloat16()
        v = torch.randn(B, S, KV, Dh, generator=gen, device="cuda").bfloat16()
        run = lambda: flash_attention(q, k, v, causal=causal)
        plain = lambda qq: reference_attention(qq, k, v, causal, p_f32=True)
        got, want = run(), plain(q)
        torch.cuda.synchronize()
        err, tol_ok = paged_close(got, want)
        _check(tol_ok, f"flash attention disagrees with its plain version at {shapes[i]}: "
               f"max abs err {err.max().item()}")
        pairs = B * (T * (T + 1) // 2 if causal else T * S)
        row = dict(shape=dict(B=B, T=T, S=S, H=H, KV=KV, Dh=Dh, causal=causal),
                   max_abs_err=err.max().item(),
                   max_rel_err=(err.max() / want.float().abs().max()).item(),
                   tolerance=PAGED_TOL + " (plain with P in f32)", within=tol_ok,
                   visible_pairs=pairs)
        if i == 0:
            shifted = torch.ones(T, S, dtype=torch.bool, device="cuda").tril(1)
            row["tolerance_bites"] = dict(attention_bites(got, plain, q),
                                          diagonal_shifted=_bites(got, _masked_plain(
                                              q, k, v, shifted)),
                                          **(head_dim_bites(got, plain, q) if dim_bites else {}))
            _check(all(row["tolerance_bites"].values()), f"the flash tolerance at {shapes[i]} "
                   f"misses {row['tolerance_bites']}")
            qs, ks, vs = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            lib = lambda: F.scaled_dot_product_attention(qs, ks, vs, is_causal=causal,
                                                         enable_gqa=True)
            nbytes = 2 * B * T * H * Dh * 2 + 2 * B * S * KV * Dh * 2
            b_ms, b_by = bound(nbytes, 4.0 * pairs * H * Dh)
            row.update(ms=time_cold(run), host_us=host_us(run),
                       plain_ms=time_plain(lambda: plain(q)), library_ms=time_cold(lib),
                       library_kernels=_sdpa_kernels(lib), bound_ms=b_ms, bound_by=b_by)
            row["library_backend"] = _sdpa_backend(row["library_kernels"])
            row["tflops"] = 4.0 * pairs * H * Dh / (row["ms"] * 1e-3) / 1e12
            row["equal_bits_twice"] = equal_bits_twice(run)
            _check(row["equal_bits_twice"], f"two runs of the flash forward differ at "
                   f"{shapes[i]}")
        rows.append(row)
        del q, k, v, got, want
    torch.cuda.empty_cache()
    return rows


def check_parallel_block_forms(gen, seed):
    """Phase 2n: every kernel form the parallel-block families add, against
    its plain version with its bites. Returns {form: rows}."""
    t0 = time.perf_counter()
    rng = np.random.default_rng([seed, 19])
    forms = {"fused_mlp[no-norm]": [], "fused_mlp_quant[no-norm]": []}
    for r in check_mlp_no_norm(gen):
        forms["fused_mlp[no-norm]" if r["shape"]["fmt"] == "bf16"
              else "fused_mlp_quant[no-norm]"].append(r)
    forms["fused_qkv_rope[partial-rope]"] = check_qkv_partial_rope(gen, rng)
    forms.update(check_paged_heads(gen, rng, GPTJ_WIDTHS["H"], GPTJ_WIDTHS["KV"],
                                   GPTJ_WIDTHS["Dh"], "dh256"))
    forms["flash_attention[dh256]"] = check_flash_forward(gen)
    print(f"[kernel] parallel-block forms: {sum(len(r) for r in forms.values())} cells in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return forms


# GPT-J-6B's, Pythia-1.4b's, Falcon-7B's, Phi-3-mini's and Pythia-2.8b's
# fused decode row: per layer, B4 unless the QKV stays on the layer body
# (GPT-J's interleaved RoPE), B5 always, B6 unless the MLP does (Pythia's
# and Falcon's exact gelu), never B7 (bf16 weights)
PB_PER_LAYER = {"gpt-j-6b": dict(fused_qkv_rope=0, fused_paged_decode_attention=1, fused_mlp=1,
                                 fused_mlp_quant=0),
                "pythia-1.4b": dict(fused_qkv_rope=1, fused_paged_decode_attention=1,
                                    fused_mlp=0, fused_mlp_quant=0),
                "falcon-7b": dict(fused_qkv_rope=1, fused_paged_decode_attention=1, fused_mlp=0,
                                  fused_mlp_quant=0),
                "phi-3-mini": dict(fused_qkv_rope=1, fused_paged_decode_attention=1, fused_mlp=1,
                                   fused_mlp_quant=0),
                "pythia-2.8b": dict(fused_qkv_rope=1, fused_paged_decode_attention=1,
                                    fused_mlp=0, fused_mlp_quant=0)}


def parallel_block_serving(name, cfg, seed, card):
    """Phase 3j for one model at full width (as deep as ``cfg``) through
    phase 3g's ``family_serving``: ``serve()`` on
    "auto" and "xla", ``put()`` +
    ``decode_loop`` against the single-token ``put()`` loop, the v1
    ``generate``, a profiled decode window), then the fused decode step's
    launches held to PB_PER_LAYER exactly (31 ``decode_loop`` steps) and the
    prefill's flash forward once a layer. GPT-J-6B then serves its widths
    with ``mlp_bias=False`` at depth 2, int8 (B7 without its norm: 2 a
    decode row-step). Returns the results and the weights (phase 4e)."""
    import torch

    from shuffle_exchange_tpu_torch.models import Transformer

    out, params = family_serving(name, cfg, seed, card)
    L = cfg.n_layers
    loop = out["put_decode_loop"]["launches"]
    want = {k: n * L * LOOP_STEPS for k, n in PB_PER_LAYER[name].items()}
    want["flash_attention"] = L     # the one prefill program
    got = {k: loop[k] for k in want}
    _check(got == want, f"{name}: put() + {LOOP_STEPS} decode_loop steps launched {got}, "
           f"not {want}")
    xla = out["serve"]["xla"]
    ticks = xla["programs"].get("decode", 0) + xla["programs"].get("mixed", 0)
    _check(xla["launches"]["paged_decode_attention"] == L * ticks > 0
           and xla["launches"]["fused_paged_decode_attention"] == 0,
           f"{name}: the xla serve's {ticks} ticks with decode rows launched B2 "
           f"{xla['launches']['paged_decode_attention']} times, not {L} a tick")
    print(f"[{name}] a fused decode step launches, per layer: "
          f"{ {k: n for k, n in PB_PER_LAYER[name].items()} } (held exactly over "
          f"{LOOP_STEPS} steps); an xla decode tick B2 {L} times; the prefill's flash "
          f"forward once a layer", flush=True)
    if name == "gpt-j-6b":
        nb_cfg = dataclasses.replace(cfg, n_layers=2, mlp_bias=False)
        nb_params = {k: (v[:2] if k.startswith("layers.") else v) for k, v in params.items()
                     if k not in ("layers.b_up", "layers.b_down")}
        r = counted_serve(Transformer(nb_cfg), nb_params, np.random.default_rng([seed, 1]),
                          dict(SERVE_CONFIG, **_quant(8)), 2, card,
                          label=f"{name} mlp_bias=False int8 depth 2")
        dec = r["programs"].get("decode", 0) + r["programs"].get("mixed", 0)
        _check(r["resolved"] == "pallas" and r["launches"]["fused_mlp_quant"] == 2 * dec > 0,
               f"{name} mlp_bias=False int8: B7 did not launch 2 a decode row-step "
               f"({r['launches']}, {dec} decode programs)")
        r["tokens"] = {int(u): t for u, t in r["tokens"].items()}
        out["nobias_int8"] = r
        del nb_params
        gc.collect()
        torch.cuda.empty_cache()
    return out, params


# tiiuae/falcon-7b's published config, as the fields config_from_hf reads them
FALCON_7B = {"architectures": ["FalconForCausalLM"], "model_type": "falcon", "alibi": False,
             "bias": False, "hidden_size": 4544, "layer_norm_epsilon": 1e-5,
             "multi_query": True, "new_decoder_architecture": False,
             "num_attention_heads": 71, "num_hidden_layers": 32, "parallel_attn": True,
             "vocab_size": 65024}
FALCON_WIDTHS = dict(D=4544, H=71, KV=1, Dh=64, F=18176)
# (H, KV, Dh) of the decode kernels' group edges over one kv head: 16 heads
# (Falcon-40B's group; the widest whose warps split each key tile), 17 (the
# narrowest in whole row tiles, a one-head last tile), 9 at 128 and 5 at 256
WIDE_GROUP_EDGES = [(16, 1, 64), (17, 1, 64), (9, 1, 128), (5, 1, 256)]
# the extend kernel past 64 heads a kv head (its tiles span two chunk rows)
EXTEND_EDGE = (65, 1, 64)
# Falcon-7B's prefill: P = 8, T = 1024, 71 query heads over one kv head
FLASH_FALCON_SHAPES = [(8, 1024, 1024, 71, 1, 64, True)]
# depth-2 Falcon-7B and Pythia-2.8b against the CPU f32 engine: the largest
# logit error over every schedule, relative to the largest |logit| (the
# layernorm families sit at 0.1-0.8% of it; the Llama family, Phi-3-mini
# with it, at 1.0-1.5% in phase 4, whose E2E_REL_TOL holds it)
E2E_LOGIT_TOL = 0.01


def check_wide_group_forms(gen, seed):
    """Phase 2o: B2, B5 and B3 at Falcon-7B's group (71 x 64 over one kv
    head; 8 rows and 1 row; bf16, int8 and fp8 pools, the bf16 ones timed:
    the others' times are scripts/torch_kernel_digest.py's paged section;
    bf16 with slopes), at WIDE_GROUP_EDGES (bf16) and B3 at EXTEND_EDGE; B4 at
    Falcon-7B's widths (8 rows, pool) and the flash forward at its prefill.
    Returns {form: rows}."""
    t0 = time.perf_counter()
    rng = np.random.default_rng([seed, 24])
    H, KV, Dh = (FALCON_WIDTHS[k] for k in ("H", "KV", "Dh"))
    forms = check_paged_heads(gen, rng, H, KV, Dh, "wide-group", decode_rows=(8, 1),
                              alibi=True)
    for h, kv, dh in WIDE_GROUP_EDGES:
        for form, rows in check_paged_heads(gen, rng, h, kv, dh, "wide-group",
                                            pools=("bf16",)).items():
            forms[form] += rows
    for form, rows in check_paged_heads(gen, rng, *EXTEND_EDGE, "wide-group", decode_rows=(),
                                        pools=("bf16",)).items():
        forms[form] += rows
    forms["fused_qkv_rope[falcon-7b]"] = [check_fused_qkv(gen, rng, 8, widths=FALCON_WIDTHS,
                                                          theta=10000.0)]
    forms["flash_attention[falcon-7b]"] = check_flash_forward(gen, FLASH_FALCON_SHAPES)
    print(f"[kernel] wide-group forms: {sum(len(r) for r in forms.values())} cells in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return forms


def model_serving(name, cfg, seed, card):
    """Phase 3k (Falcon-7B) and 3l (Phi-3-mini, Pythia-2.8b): one model at
    full width (as deep as ``cfg``) through ``parallel_block_serving`` (the three entry
    points, a profiled decode window, a decode step's launches held exactly
    to PB_PER_LAYER[name]; an xla tick's B2 once a layer; the prefill's
    flash forward once a layer), with the ms per ``decode_loop`` step beside
    the weights' bytes over the card's memory rate. Returns the results and
    the weights (phases 4f, 4g)."""
    out, params = parallel_block_serving(name, cfg, seed, card)
    floor_ms = weight_bytes(params) / HBM_BYTES_PER_S * 1e3
    loop = out["put_decode_loop"]
    out["decode_loop_floor_ms"] = floor_ms
    auto = out["serve"]["auto"]
    print(f"[{name}] serve auto: {auto['sustained_tokens_per_sec']} tok/s, TPOT p50 "
          f"{auto['tpot_p50_s']} s, p95 {auto['tpot_p95_s']} s; decode_loop "
          f"{loop['decode_loop_ms_per_step']:.2f} ms a step against {floor_ms:.2f} ms of "
          f"weight bytes at {HBM_BYTES_PER_S / 1e12:.2f} TB/s on {card}", flush=True)
    return out, params


def model_e2e(name, cfg, params, seed, tol=E2E_LOGIT_TOL):
    """Phases 4f and 4g: phase 4b's ``family_e2e`` on the model cut to depth
    2, then the largest error over every call within ``tol`` of the largest
    |logit|."""
    e2e = family_e2e(name, cfg, params, seed)
    worst = max(t["max_abs_err"] / t["ref_abs_max"] for by_dk in e2e.values()
                for calls in by_dk.values() for t in calls)
    print(f"[e2e {name}] largest error over every schedule and decode path: {worst:.5f} "
          f"of the largest |logit| (tol {tol})", flush=True)
    _check(worst <= tol, f"depth-2 {name} sits {worst:.5f} of the largest logit from the CPU "
           f"f32 engine (tol {tol})")
    return dict(e2e, worst_rel=worst)


# microsoft/Phi-3-mini-4k-instruct's and EleutherAI/pythia-2.8b's published
# configs, as the fields config_from_hf reads them (Phi-3's sliding_window
# 2047 is not read, as in the JAX mapping: phase 3l stays below 2,048
# positions)
PHI3_MINI = {"architectures": ["Phi3ForCausalLM"], "model_type": "phi3", "hidden_size": 3072,
             "intermediate_size": 8192, "num_attention_heads": 32, "num_hidden_layers": 32,
             "num_key_value_heads": 32, "max_position_embeddings": 4096, "rope_theta": 10000.0,
             "rms_norm_eps": 1e-5, "hidden_act": "silu", "vocab_size": 32064,
             "tie_word_embeddings": False, "sliding_window": 2047}
PYTHIA_2B8 = dict(PYTHIA_1B4, hidden_size=2560, intermediate_size=10240, num_attention_heads=32,
                  num_hidden_layers=32)
PHI3_WIDTHS = dict(D=3072, H=32, KV=32, Dh=96, F=8192)
PYTHIA_2B8_WIDTHS = dict(D=2560, H=32, KV=32, Dh=80, F=10240, rd=20)
# (H, KV, Dh) of odd groups over one kv head at the head dims 80 and 96: a
# partly filled last row tile at each
HEAD_DIM_EDGES = [(13, 1, 80), (11, 1, 96)]
# the two prefills: P = 8, T = 1024, 32 heads of 96 and of 80
FLASH_HEAD_DIM_SHAPES = {96: [(8, 1024, 1024, 32, 32, 96, True)],
                         80: [(8, 1024, 1024, 32, 32, 80, True)]}
# B9 past the 64 columns of its shared-memory forms: two chunks, four, and
# a rank that is no multiple of 8 (a 64 + 64 + 8 split), on a 5-slot pool
# at phase 2g's decode tick, chunk rows and put() rows
WIDE_RANKS = (128, 256, 136)
WIDE_RANK_ROWS = [(8, 1), (2, 256), (8, 1024)]
# B9 past the ranks whose mid an expand block holds whole (512): 64-rank
# stages of mid beside B's, 16-byte rows and (1000) element loads with a
# short last stage, at a decode tick and chunk rows
STREAMED_RANKS = (1024, 1000)
STREAMED_RANK_ROWS = [(8, 1), (2, 256)]
# phase 3l's multi-tenant serve: Llama-3-8B at phase 3f's geometry with a
# rank-128 pool holding tenants of ranks 16, 64 and 128
WIDE_MT_RANKS = (16, 64, 128)
WIDE_MT_CONFIG = dict(MT_CONFIG, adapters=dict(MT_CONFIG["adapters"], max_rank=128))


def check_head_dim_forms(gen, seed):
    """Phase 2p: B2, B5 and B3 at Phi-3-mini's 32 x 96 and Pythia-2.8b's
    32 x 80 (8 and 1 rows; bf16, int8 and fp8 pools, the bf16 ones timed:
    the others' times are scripts/torch_kernel_digest.py's paged section;
    bf16 with slopes at 80) and at HEAD_DIM_EDGES (bf16), B4 at both families' heads
    (8 rows, pool; Pythia's partial rotary and biases), B6 at Phi-3-mini's
    widths (8 and 1 rows), the flash forward at both prefills, and B9 at
    WIDE_RANKS and STREAMED_RANKS. The attention forms carry head_dim_bites
    too. Returns {form: rows}."""
    import torch

    t0 = time.perf_counter()
    rng = np.random.default_rng([seed, 26])
    forms = {}
    for Dh, widths in ((96, PHI3_WIDTHS), (80, PYTHIA_2B8_WIDTHS)):
        forms.update(check_paged_heads(gen, rng, widths["H"], widths["KV"], Dh, f"dh{Dh}",
                                       decode_rows=(8, 1), alibi=Dh == 80, dim_bites=True))
    for h, kv, dh in HEAD_DIM_EDGES:
        for form, rows in check_paged_heads(gen, rng, h, kv, dh, f"dh{dh}", pools=("bf16",),
                                            dim_bites=True).items():
            forms[form] += rows
    forms["fused_qkv_rope[phi-3-mini]"] = [check_fused_qkv(gen, rng, 8, widths=PHI3_WIDTHS,
                                                           theta=10000.0)]
    forms["fused_qkv_rope[pythia-2.8b]"] = check_qkv_partial_rope(
        gen, rng, widths=PYTHIA_2B8_WIDTHS, layouts=(("pythia-2.8b", 32, 32),),
        forms=((True, 8),))
    forms["fused_mlp[phi-3-mini]"] = [check_fused_mlp(gen, B, widths=PHI3_WIDTHS)
                                      for B in (8, 1)]
    for Dh, shapes in FLASH_HEAD_DIM_SHAPES.items():
        forms[f"flash_attention[dh{Dh}]"] = check_flash_forward(gen, shapes, dim_bites=True)
    forms["lora_delta[wide-rank]"] = check_lora_gemm(gen, ranks=WIDE_RANKS, pools=(5,),
                                                     row_shapes=WIDE_RANK_ROWS)
    # on a generator of its own: the later phases' draws stay where they were
    forms["lora_delta[wide-rank]"] += check_lora_gemm(
        torch.Generator(device="cuda").manual_seed(seed + 4), ranks=STREAMED_RANKS, pools=(5,),
        row_shapes=STREAMED_RANK_ROWS)
    print(f"[kernel] head-dim and rank forms: {sum(len(r) for r in forms.values())} cells in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return forms


def wide_rank_serving(model, params, card, seed):
    """Phase 3l's multi-tenant serve: phase 3f's 24 requests on Llama-3-8B
    through a 4-slot pool of max_rank 128 over wq and wv, striped over six
    tenants of WIDE_MT_RANKS (two each, zero-padded to 128 as the pool
    pads them), the launch counters zeroed just before and held to what the
    programs imply just after; no preemption, parks == unparks."""
    import torch

    from shuffle_exchange_tpu_torch import ops
    from shuffle_exchange_tpu_torch.inference import (ContinuousBatchingScheduler,
                                                      InferenceConfig, InferenceEngineV2)

    mcfg, V = model.config, model.config.vocab_size
    rng = np.random.default_rng([seed, 13])
    lo, hi = MT_PROMPTS
    reqs = [rng.integers(1, V, size=int(n)).tolist()
            for n in rng.integers(lo, hi + 1, size=MT_REQUESTS)]
    eng = InferenceEngineV2(model, params, InferenceConfig(**WIDE_MT_CONFIG))
    _check(eng._decode_kernel == "pallas" and eng.adapters.max_rank == 128,
           "wide-rank serve: not the fused path over a rank-128 pool")
    ranks = [WIDE_MT_RANKS[i % len(WIDE_MT_RANKS)] for i in range(2 * len(WIDE_MT_RANKS))]
    for i, r in enumerate(ranks):
        eng.adapters.register(f"r{r}-{i}", tenant_factors(mcfg, 2000 + i, rank=r))
    aids = [f"r{ranks[i % len(ranks)]}-{i % len(ranks)}" for i in range(MT_REQUESTS)]
    by0 = dict(eng.dispatches_by_program)
    sched = ContinuousBatchingScheduler(eng)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    toks = sched.serve(reqs, max_new_tokens=MT_NEW, adapter_ids=aids)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = ops.launch_counts()
    st = sched.stats()
    by = {k: v - by0.get(k, 0) for k, v in eng.dispatches_by_program.items()}
    want = expected_launches(eng, mcfg.n_layers, by=by)
    _check(launches == want, f"wide-rank serve: launch counts {launches} != implied {want}")
    _check(len(toks) == MT_REQUESTS and all(len(t) == MT_NEW for t in toks.values())
           and all(0 <= t < V for ts in toks.values() for t in ts),
           "wide-rank serve: requests did not all finish with in-range tokens")
    ad = st["adapters"]
    _check(st["preemptions"] == 0 and ad["parks"] == ad["unparks"] and ad["pinned"] == 0,
           f"wide-rank serve: preemptions {st['preemptions']}, parks {ad['parks']}, unparks "
           f"{ad['unparks']}, pinned {ad['pinned']}")
    r = dict(seconds=seconds, ticks=st["ticks"], tokens_per_s=st["sustained_tokens_per_sec"],
             tpot_p50_s=st["tpot_p50_s"], tpot_p95_s=st["tpot_p95_s"], ranks=ranks,
             adapters={k: ad[k] for k in ("hits", "misses", "evictions", "parks", "unparks")},
             preemptions=st["preemptions"], programs=by, launches=launches)
    print(f"[wide-rank multi-tenant] {MT_REQUESTS} requests x {MT_NEW} tokens over tenants of "
          f"ranks {ranks} in a rank-128 pool: {seconds:.2f} s, tok/s={r['tokens_per_s']} "
          f"tpot_p50/p95_s={r['tpot_p50_s']}/{r['tpot_p95_s']} adapters={r['adapters']} "
          f"preemptions={r['preemptions']} launches={launches} on {card}", flush=True)
    del eng, sched
    gc.collect()
    torch.cuda.empty_cache()
    return r


# ---------------------------------------------------------------------------
# Phase 2q: the flash backward at head_dim 256 (GPT-J-6B's training)
# ---------------------------------------------------------------------------

# (label, B, T, S, H, KV, causal, segments), head_dim 256: GPT-J-6B's
# training shape at 2,048 positions (the kernels line's cell) and at the
# step's 2,047 after the label shift, a GQA group of 4 at ragged T, segment
# ids, and a full mask with T < S; every cell timed
FLASH_BWD_256_SHAPES = [
    ("gpt-j-6b", 8, 2048, 2048, 16, 16, True, False),
    ("gpt-j-6b step", 8, 2047, 2047, 16, 16, True, False),
    ("gqa 16/4", 2, 1000, 1000, 16, 4, True, False),
    ("segments", 2, 1000, 1000, 16, 16, True, True),
    ("full T<S", 2, 200, 1000, 16, 4, False, False),
]
# the Fixed layout (blocks of 128, causal) at 1,024 positions, 16/4 heads of 256
FLASH_BWD_256_MASK = (1024, 16, 4)


def _sdpa_backend(kernels) -> str:
    """Which SDPA backend ran, from the names of the kernels it launched
    (the profiler sometimes records none)."""
    if not kernels:
        return "not recorded (the profiler saw no kernel)"
    names = " ".join(kernels).lower()
    for key, backend in (("cudnn", "cuDNN"), ("flash", "flash attention"),
                         ("fmha", "memory-efficient"), ("efficient", "memory-efficient")):
        if key in names:
            return backend
    return "math (no fused backend took the call)"


def check_flash_bwd_256(gen, seed):
    """Phase 2q: the flash backward at head_dim 256 (the delta pass, the
    dk/dv pass and the dq pass: B14 as the n_rep = 1 case of B15, and
    B15's element-mask form, whose dk/dv pass is a dv and a dk launch)
    against its plain version (reference_attention_bwd on the kernel's own
    forward out), with the forward's out and lse, at FLASH_BWD_256_SHAPES
    and the Fixed layout of FLASH_BWD_256_MASK through a TileMask. At every
    cell a plain version with the softmax scale of head_dim 128 (and, where
    causal, one with the diagonal shifted by one) must fail the tolerance,
    and two runs of the forward and of the backward must give equal bits.
    Every cell timed (mean of 10, cold L2) beside
    its bound (10 x pairs x H x Dh at the bf16 peak), the plain version and
    SDPA's backward on the same operands (its backend named). Then one
    ``sparse_attention`` call at 256 under autograd, with the launch
    counters zeroed just before: forward and backward once each."""
    import torch
    import torch.nn.functional as F

    from shuffle_exchange_tpu_torch import ops
    from shuffle_exchange_tpu_torch.ops import sparse_attention as sa
    from shuffle_exchange_tpu_torch.ops.flash_attention import (flash_attention_bwd,
                                                                flash_attention_lse,
                                                                reference_attention,
                                                                reference_attention_bwd,
                                                                reference_attention_lse,
                                                                tile_mask)

    t0 = time.perf_counter()
    rng = np.random.default_rng([seed, 28])
    Dh = 256
    fixed = sa.FixedSparsityConfig(block=128, num_local_blocks=4, num_global_blocks=1)
    Tm, Hm, KVm = FLASH_BWD_256_MASK
    cells = FLASH_BWD_256_SHAPES + [("fixed mask", 1, Tm, Tm, Hm, KVm, True, "mask")]
    out_rows = []
    for i, (label, B, T, S, H, KV, causal, extra) in enumerate(cells):
        q = torch.randn(B, T, H, Dh, generator=gen, device="cuda").bfloat16()
        k = torch.randn(B, S, KV, Dh, generator=gen, device="cuda").bfloat16()
        v = torch.randn(B, S, KV, Dh, generator=gen, device="cuda").bfloat16()
        dout = torch.randn(B, T, H, Dh, generator=gen, device="cuda").bfloat16()
        seg, mask, em = None, None, None
        if extra is True:
            seg = torch.from_numpy(np.sort(rng.integers(0, 4, size=(B, T)), axis=1)
                                   .astype(np.int32)).cuda()
        if extra == "mask":
            em = sa.element_mask(fixed.make_layout(T), fixed.block, T, T, True)
            mask, causal = tile_mask(em), False
        out, lse = flash_attention_lse(q, k, v, causal, seg, mask=mask)
        want_out, want_lse = reference_attention_lse(q, k, v, causal, seg, p_f32=True,
                                                     mask=mask)
        torch.cuda.synchronize()
        out_err, out_ok = paged_close(out, want_out)
        lse_err = (lse - want_lse).abs().max().item()
        _check(out_ok and lse_err <= LSE_TOL, f"flash forward at 256 ({label}) disagrees with "
               f"its plain version: out {out_err.max().item()}, lse {lse_err}")
        del want_out, want_lse
        run = lambda: flash_attention_bwd(q, k, v, out, lse, dout, causal, seg, mask=mask)
        plain = lambda: reference_attention_bwd(q, k, v, out, dout, causal, seg, mask=mask)
        got, want = run(), plain()
        torch.cuda.synchronize()
        checks = [grad_close(g, w) for g, w in zip(got, want)]
        errs = {n: e.max().item() for n, (e, _) in zip(("dq", "dk", "dv"), checks)}
        _check(all(ok for _, ok in checks), f"flash backward at 256 ({label}) disagrees with "
               f"its plain version: {errs}")
        allowed = torch.ones(T, S, dtype=torch.bool, device="cuda")
        if em is not None:
            allowed = torch.from_numpy(em).cuda()
        elif causal:
            allowed = allowed.tril()
        if seg is not None:
            allowed = allowed[None] & (seg[:, :, None] == seg[:, None, :])
        pairs = int(allowed.sum().item()) * (1 if allowed.dim() == 3 else B)
        row = dict(shape=dict(label=label, B=B, T=T, S=S, H=H, KV=KV, Dh=Dh, causal=causal,
                              segment_ids=seg is not None, mask=mask is not None),
                   visible_pairs=pairs, max_abs_err=max(errs.values()), errs=errs,
                   lse_max_abs_err=lse_err, fwd_out_max_abs_err=out_err.max().item(),
                   tolerance=GRAD_TOL + f"; lse {LSE_TOL} abs; forward out {PAGED_TOL}",
                   within=True)
        again = run()
        torch.cuda.synchronize()
        row["equal_bits_twice"] = all(torch.equal(a, b_) for a, b_ in zip(got, again))
        row["fwd_equal_bits_twice"] = equal_bits_twice(
            lambda: flash_attention_lse(q, k, v, causal, seg, mask=mask)[0])
        _check(row["equal_bits_twice"] and row["fwd_equal_bits_twice"],
               f"two runs of the flash kernels at 256 differ ({label})")
        del again
        small = slice(0, 2)
        bites = {}
        if causal:   # the diagonal shifted by one
            shifted = torch.ones(T, S, dtype=torch.bool, device="cuda").tril(1)
            if seg is not None:
                shifted = shifted[None] & (seg[small, :, None] == seg[small, None, :])
            broken = _masked_plain_grads(q[small], k[small], v[small], dout[small], shifted)
            bites.update({f"diagonal_shifted_{n}": not grad_close(g[small], w)[1]
                          for n, g, w in zip(("dq", "dk", "dv"), got, broken)})
            del broken
        leaves = [t[small].float().requires_grad_(True) for t in (q, k, v)]
        scaled = torch.autograd.grad(   # the softmax scale of head_dim 128
            reference_attention(leaves[0] * 2 ** 0.5, leaves[1], leaves[2], causal,
                                None if seg is None else seg[small], p_f32=True, mask=mask),
            leaves, dout[small].float())
        bites.update({f"scale_of_dh_128_{n}": not grad_close(g[small], w.bfloat16())[1]
                      for n, g, w in zip(("dq", "dk", "dv"), got, scaled)})
        row["tolerance_bites"] = bites
        _check((not causal or any(bites[f"diagonal_shifted_{n}"] for n in ("dq", "dk", "dv")))
               and all(bites[f"scale_of_dh_128_{n}"] for n in ("dq", "dk", "dv")),
               f"the flash backward tolerance at 256 ({label}) misses {bites}")
        del leaves, scaled
        qs, ks, vs = (t.transpose(1, 2).contiguous().requires_grad_(True) for t in (q, k, v))
        dos = dout.transpose(1, 2).contiguous()
        sdpa_kw = dict(is_causal=causal, enable_gqa=True)
        if em is not None:
            sdpa_kw = dict(attn_mask=torch.from_numpy(em).cuda()[None, None], enable_gqa=True)
        elif seg is not None:
            sdpa_kw = dict(attn_mask=allowed[:, None], enable_gqa=True)
        lib_out = F.scaled_dot_product_attention(qs, ks, vs, **sdpa_kw)
        lib = lambda: torch.autograd.grad(lib_out, (qs, ks, vs), dos, retain_graph=True)
        nbytes = (3 * B * T * H * Dh * 2 + 2 * B * S * KV * Dh * 2 + B * H * T * 4   # reads
                  + B * T * H * Dh * 2 + 2 * B * S * KV * Dh * 2)                    # writes
        b_ms, b_by = bound(nbytes, 10.0 * pairs * H * Dh)
        kernels = _sdpa_kernels(lib)
        row.update(ms=time_cold(run, iters=10), host_us=host_us(run),
                   plain_ms=time_plain(plain), library_ms=time_cold(lib, iters=10),
                   library=f"SDPA backward (torch.autograd.grad of scaled_dot_product_attention"
                           f", enable_gqa{', boolean attn_mask' if 'attn_mask' in sdpa_kw else ''}"
                           f"): {_sdpa_backend(kernels)}",
                   library_kernels=kernels, bound_ms=b_ms, bound_by=b_by)
        row["tflops"] = 10.0 * pairs * H * Dh / (row["ms"] * 1e-3) / 1e12
        out_rows.append(row)
        del q, k, v, dout, out, lse, got, want, qs, ks, vs, dos, lib_out, allowed
        torch.cuda.empty_cache()
    # the element-mask form's user path at 256: one sparse_attention call under autograd
    gen2 = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn(1, Tm, h, Dh, generator=gen2, device="cuda").bfloat16()
               .requires_grad_(True) for h in (Hm, KVm, KVm))
    ops.reset_launch_counts()
    out = sa.sparse_attention(q, k, v, fixed, causal=True)
    out.float().square().mean().backward()
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    finite = bool(torch.isfinite(out).all().item()) and all(
        bool(torch.isfinite(t.grad).all().item()) for t in (q, k, v))
    _check(finite and launches["flash_attention"] == 1 and launches["flash_attention_bwd"] == 1
           and sum(launches.values()) == 2, f"sparse_attention at head_dim 256: finite {finite}, "
           f"launches {launches}")
    out_rows[-1]["sparse_attention_call"] = dict(finite=finite, launches={
        k_: n for k_, n in launches.items() if n})
    del q, k, v, out
    torch.cuda.empty_cache()
    print(f"[kernel] flash backward at head_dim 256: {len(out_rows)} cells in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return out_rows


# ---------------------------------------------------------------------------
# Phase 5: train the ladder's pick through initialize() + train_batch
# ---------------------------------------------------------------------------

# the training config of the JAX package's one-chip benchmark row: FusedAdam,
# bf16, ZeRO stage 3 (at world size 1 the stage changes nothing), at batch
# 32 x 1024 with full per-layer remat
TRAIN_CONFIG = {"train_batch_size": 32,
                "optimizer": {"type": "FusedAdam", "params": {"lr": 3e-4, "weight_decay": 0.1}},
                "bf16": {"enabled": True}, "zero_optimization": {"stage": 3},
                "steps_per_print": 10 ** 9}
TRAIN_BATCH, TRAIN_SEQ = 32, 1024
TRAIN_WARMUP, TRAIN_TIMED, TRAIN_FREE = 3, 5, 8
# phase 5b: bench.py's _config3 row (bench.py:2300-2311): its training
# config (FusedAdam, bf16, ZeRO stage 2 at world size 1) and fewer steps
MOE_TRAIN_CONFIG = dict(TRAIN_CONFIG, zero_optimization={"stage": 2})
MOE_TRAIN_STEPS = (2, 3, 4)
# phase 5c: BLOOM-1b7, built through config_from_hf from its published
# config.json (bigscience/bloom-1b7; the fields the mapping reads), under
# TRAIN_CONFIG at batch 16 x 2048 (16 x 2047 = 32,752 trained tokens a step)
BLOOM_1B7 = {"architectures": ["BloomForCausalLM"], "model_type": "bloom", "hidden_size": 2048,
             "n_head": 16, "n_layer": 24, "vocab_size": 250880, "layer_norm_epsilon": 1e-5}
BLOOM_BATCH, BLOOM_SEQ = 16, 2048
# phase 5d: bench.py's _config1 row (bench.py:2194-2210): GPT-2 125M, AdamW,
# ZeRO 1, bf16, batch 16 x 1024, the model's own (no) remat
CONFIG1 = {"train_batch_size": 16,
           "optimizer": {"type": "AdamW", "params": {"lr": 3e-4, "weight_decay": 0.1}},
           "bf16": {"enabled": True}, "zero_optimization": {"stage": 1},
           "steps_per_print": 10 ** 9}
GPT2_BATCH, GPT2_SEQ = 16, 1024
# 12 steps: at lr 3e-4 without warm-up, GPT-2 on one repeated batch spikes
# once within its first ~10 steps and falls again, in f32 on the CPU as in
# bf16 on the card (the port's f32 path equals the JAX engine's)
GPT2_STEPS = (3, 3, 6)
# phases 5e / 5f: (name, published config, layers (None = all), (batch, seq)):
# GPT-J-6B at 14 of its 28 layers (3.23 B parameters, 45.2 GB of state at 14
# bytes a parameter; all 28 layers, 6.05 B, do not fit one 80 GB card), the
# cut phase 3j serves, at batch 8 x 2048; Pythia-1.4b whole at BLOOM's batch
PB_TRAIN = [("gpt-j-6b", GPTJ_6B, 14, (8, 2048)),
            ("pythia-1.4b", PYTHIA_1B4, None, (BLOOM_BATCH, BLOOM_SEQ))]


def config3(moe_impl="capacity"):
    """bench.py:2300's 8-expert top-2 training model (mixtral-style, scaled
    to one chip): vocab 32768, d 1024, 8 layers, 8 heads / 2 KV heads, tied
    embeddings, capacity factor 1.25 (the config default), ff_dim 2816,
    full remat. About 0.61 B parameters, 0.19 B of them active a token."""
    from shuffle_exchange_tpu_torch.models import TransformerConfig

    return TransformerConfig(vocab_size=32768, d_model=1024, n_layers=8, n_heads=8,
                             n_kv_heads=2, max_seq_len=2048, activation="swiglu",
                             norm="rmsnorm", position="rope", tie_embeddings=True,
                             n_experts=8, moe_top_k=2, moe_impl=moe_impl, remat=True,
                             remat_policy="nothing_saveable")


def train_expected_launches(model, batch, seq, n_leaves, steps):
    """Launches per kernel that ``steps`` training steps imply: under full
    remat each layer runs its forward twice (the forward and the recompute
    in backward: both RMSNorms and the attention forward each time; an MoE
    layer's three expert products too) and its backward once (the attention
    backward; an MoE layer's three products' dx and dw); the chunked loss
    norms each chunk twice (it is checkpointed), the full-logits head once;
    AdamW steps every leaf. The attention kernels are the ALiBi ones
    (B11-B13) for an ALiBi model, else the flash ones (B14/B15); a layernorm
    model launches no RMSNorm (its layernorm is plain PyTorch)."""
    from shuffle_exchange_tpu_torch import ops
    from shuffle_exchange_tpu_torch.models.transformer import _remat_policy

    cfg = model.config
    L = cfg.n_layers
    twice = 2 if cfg.remat and _remat_policy(cfg.remat_policy) == "full" else 1
    chunk = model._loss_chunk(batch, seq - 1)
    head_norms = 2 * -(-(seq - 1) // chunk) if chunk else 1
    attn = "alibi_flash_attention" if cfg.position == "alibi" else "flash_attention"
    out = {k: 0 for k in ops.KERNEL_WRAPPERS}
    out.update({attn: L * twice * steps, f"{attn}_bwd": L * steps,
                "fused_adamw": n_leaves * steps})
    if cfg.norm == "rmsnorm":
        out["rmsnorm"] = (2 * L * twice + head_norms) * steps
    if cfg.n_experts > 0:
        out.update(grouped_matmul=3 * L * twice * steps, grouped_matmul_dx=3 * L * steps,
                   grouped_matmul_dw=3 * L * steps)
    return out


def active_params(cfg, n_params: int) -> int:
    """Parameters a token activates: all but the (E - k) / E of the routed
    expert stacks it does not reach (bench.py:2318 bills MoE MFU so)."""
    if cfg.n_experts == 0:
        return n_params
    experts = cfg.n_layers * cfg.n_experts * 3 * cfg.d_model * cfg.ff_dim
    return n_params - experts * (cfg.n_experts - cfg.moe_top_k) // cfg.n_experts


class _MoETap:
    """Records each ``moe_layer`` call's drop fraction and expert counts
    (device tensors) while it is open."""

    def __enter__(self):
        from shuffle_exchange_tpu_torch.moe import layer

        self.layer, self.orig, self.seen = layer, layer.moe_layer, []

        def tapped(*args, **kw):
            res = self.orig(*args, **kw)
            self.seen.append((res.metadata["drop_fraction"], res.metadata["expert_counts"]))
            return res

        layer.moe_layer = tapped
        return self

    def __exit__(self, *exc):
        self.layer.moe_layer = self.orig

    def summary(self):
        drops = [float(d) for d, _ in self.seen]
        counts = [c.float() for _, c in self.seen]
        peak = max(float(c.max() / c.mean()) for c in counts) if counts else None
        return dict(drop_fraction_by_layer=drops,
                    drop_fraction=sum(drops) / len(drops) if drops else None,
                    peak_expert_load_over_mean=peak)


def train(name, cfg, seed, card, device=None, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
          config=TRAIN_CONFIG, steps=(TRAIN_WARMUP, TRAIN_TIMED, TRAIN_FREE), remat=True):
    """``initialize`` + ``train_batch`` on one seeded batch, repeated:
    ``steps`` = (warm-up steps, steps each synchronised (p50), steps with
    one synchronisation at the end (tokens/s)) under the training
    ``config``. The launch counters are zeroed just before the first step
    and read just after the last; they must equal what the program
    implies. An MoE model's MFU bills the activated parameters, and one
    evaluation of the batch after the steps reads each layer's drop
    fraction and peak expert load. Then one profiled step. ``remat``
    False keeps the config's own (no) remat, as ``bench.py``'s ``_config1``
    trains GPT-2. ``device``, ``batch`` and ``seq`` are for a rehearsal at a
    tiny size on the CPU."""
    import torch

    import shuffle_exchange_tpu_torch as sxt
    from shuffle_exchange_tpu_torch import ops
    from shuffle_exchange_tpu_torch.models import Transformer

    on_card = device is None
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    warmup, timed, free = steps
    if remat:
        cfg = dataclasses.replace(cfg, remat=True, remat_policy="nothing_saveable")
    model = Transformer(dataclasses.replace(cfg, max_seq_len=seq), device=device)
    t0 = time.perf_counter()
    engine, opt, loader, sched = sxt.initialize(
        model=model, config=dict(config, train_batch_size=batch), seed=seed, device=device)
    sync()
    init_s = time.perf_counter() - t0
    n_params = sum(m.numel() for m in engine.state.master.values())
    ids = np.random.default_rng([seed, 9]).integers(0, cfg.vocab_size, size=(batch, seq))
    data = {"input_ids": ids.astype(np.int32)}
    tokens = batch * (seq - 1)

    if on_card:
        torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    losses, per_step = [], []
    for _ in range(warmup):
        losses.append(float(engine.train_batch(data)))
    for _ in range(timed):
        t0 = time.perf_counter()
        losses.append(float(engine.train_batch(data)))       # float(): synchronised
        per_step.append(time.perf_counter() - t0)
    sync()
    t0 = time.perf_counter()
    pending = [engine.train_batch(data) for _ in range(free)]
    sync()
    free_s = time.perf_counter() - t0
    losses += [float(x) for x in pending]
    launches = ops.launch_counts()
    steps = warmup + timed + free
    want = train_expected_launches(model, batch, seq, len(engine.state.master), steps)
    moe = None
    if cfg.n_experts > 0:
        with _MoETap() as tap:
            engine.eval_batch(data)
        moe = tap.summary()
    _check(launches == want, f"training launch counts {launches} != implied {want}")
    _check(all(math.isfinite(x) for x in losses), f"non-finite training loss: {losses}")
    _check(losses[-1] < losses[0], f"the loss did not fall on the repeated batch: {losses}")
    _check(engine.state.step == steps and engine.global_steps == steps,
           f"{engine.state.step} updates over {steps} steps")
    p50 = sorted(per_step)[len(per_step) // 2]
    tps = tokens * free / free_s
    n_active = active_params(cfg, n_params)
    out = dict(model=name, params=n_params, batch=batch, seq=seq, steps=steps, init_s=init_s,
               step_p50_ms=p50 * 1e3, step_ms=[t * 1e3 for t in per_step],
               tokens_per_s=tps, tokens_per_step=tokens,
               mfu_6n=6.0 * n_active * tps / BF16_FLOP_PER_S, active_params=n_active,
               moe=moe, moe_impl=cfg.moe_impl if cfg.n_experts else None, losses=losses,
               grad_norm=engine.get_global_grad_norm(), launches=launches,
               launches_per_step={k: v // steps for k, v in launches.items()},
               peak_mem_GiB=(torch.cuda.max_memory_allocated() / 2 ** 30 if on_card else None))
    billed = ("6 x activated params (attention, embedding, router and k/E of the experts: "
              f"{n_active / 1e9:.3f} B) x tokens/s" if cfg.n_experts else "6 x params x tokens/s")
    print(f"[train] {name} ({n_params / 1e9:.3f} B params), batch {batch} x {seq}, bf16, "
          f"{'full remat' if cfg.remat else 'no remat'}, {config['optimizer']['type']}, ZeRO "
          f"{config['zero_optimization']['stage']}: init {init_s:.2f} s; step p50 {out['step_p50_ms']:.1f} ms over "
          f"{timed} synchronised steps; {tps:.0f} tokens/s over {free} unsynchronised steps; "
          f"MFU {100 * out['mfu_6n']:.2f}% of {BF16_FLOP_PER_S / 1e12:.0f} TFLOP/s dense bf16 "
          f"by {billed} (bills neither attention nor the remat recompute); MoE {moe}; peak "
          f"memory {out['peak_mem_GiB']} GiB; loss {losses[0]:.4f} -> {losses[-1]:.4f}; "
          f"launches per step {out['launches_per_step']} on {card}", flush=True)
    if on_card:
        out["trace"] = profiled(lambda: engine.train_batch(data), top_other=12)
        print(f"[trace train {name}] one step: {json.dumps(out['trace'])} on {card}", flush=True)
    return out


# ---------------------------------------------------------------------------
# Phase 6: depth 2 on the card (bf16) against the CPU plain path in f32
# ---------------------------------------------------------------------------

# One step of a 2-layer model in bf16 against f32: the loss to 2% and every
# gradient leaf to 3% of the leaf's largest |value|, as phase 4 holds the
# logits (bf16 keeps 8 bits; activations, the weights' forward copy and the
# gradients with respect to it are all rounded to it; the worst leaf
# measured on the H100 is at 1.96%). Three steps of AdamW at lr 3e-4 move
# each weight by at most ~1e-3, so the trajectories stay that close.
TRAIN_LOSS_TOL, TRAIN_GRAD_TOL = 0.02, 0.03


# Phase 6b replays the card's routing into the CPU engine: bf16 on the card
# against f32 on the CPU changes top-k choices near ties, and one flipped
# token moves an expert's gradient far beyond the 3% the leaves are held to.
class TrainRoutingReplay:
    """Patches the port's one top-k rule (``moe.gating.topk_select``, also
    bound in ``moe.layer``) for a training comparison of an ``n_layers``
    model under full remat. Each engine's pass (``start``) makes the same
    sequence of routing calls: a no-grad forward (one call a layer), and a
    step's forward and its recompute in backward (2L calls: layers 0..L-1,
    then L-1..0). While recording (the card), each call's choices and f32
    logits are kept, and a recompute's must equal its forward's bit for bit
    (the drops and saved shapes follow them). While replaying (the CPU),
    call i returns the card's call-i choices with the weights and the aux
    loss computed from this call's own ``logits`` tensor, so gradients flow
    as without the replay; rows whose own choice differs are noted with
    their 2nd-3rd router-logit gap and the row's largest router-logit
    difference between the engines."""

    def __init__(self, n_layers: int):
        self.L, self.recorded, self.flips, self.rows = n_layers, [], [], 0
        self.max_logit_delta, self.remat_pairs = 0.0, 0
        self.replaying, self.calls, self.block = False, 0, []

    def __enter__(self):
        from shuffle_exchange_tpu_torch.moe import gating, layer

        self._mods, self._orig = (gating, layer), gating.topk_select
        for m in self._mods:
            m.topk_select = self.select
        return self

    def __exit__(self, *exc):
        for m in self._mods:
            m.topk_select = self._orig

    def start(self, replaying: bool) -> None:
        """Begin one engine's pass: the card's records, or their replay."""
        self.replaying, self.calls, self.block = replaying, 0, []
        if not replaying:
            self.recorded = []

    def _record(self, idx, logits):
        import torch

        self.recorded.append((idx.cpu(), logits.detach().float().cpu()))
        if not logits.requires_grad:
            return
        self.block.append(len(self.recorded) - 1)
        p = len(self.block) - 1
        if p >= self.L:             # the recompute of layer 2L - 1 - p
            fwd = self.recorded[self.block[2 * self.L - 1 - p]]
            now = self.recorded[-1]
            _check(torch.equal(fwd[0], now[0]) and torch.equal(fwd[1], now[1]),
                   "a remat recompute routed differently from its forward on the card")
            self.remat_pairs += 1
        if len(self.block) == 2 * self.L:
            self.block = []

    def select(self, logits, k, normalize_weights=True, train=False, rng=None, noise_std=0.0):
        idx, w, aux, masks = self._orig(logits, k, normalize_weights, train, rng, noise_std)
        if not self.replaying:
            self._record(idx, logits)
            return idx, w, aux, masks
        theirs, their_logits = self.recorded[self.calls]
        self.calls += 1
        _check(theirs.shape == idx.shape, f"replayed routing {tuple(theirs.shape)} != this "
               f"call's {tuple(idx.shape)}: the engines ran different programs")
        lg = logits.detach().float().cpu()
        delta, differ = routing_difference(lg, their_logits, idx, theirs)
        self.rows += int(idx.shape[0])
        self.max_logit_delta = max(self.max_logit_delta, float(delta.max()))
        self.flips += flip_notes(lg, delta, differ, k)
        card = theirs.to(logits.device)
        return (card,) + replayed_routing(logits, card, k, normalize_weights)

    def report(self):
        _check(self.calls == len(self.recorded), f"the CPU engine made {self.calls} routing "
               f"calls, the card {len(self.recorded)}")
        flips = sorted(self.flips, reverse=True)
        return dict(routed_rows=self.rows, flips=len(flips),
                    flip_gaps_top=[[round(g, 6), round(d, 6)] for g, d in flips[:10]],
                    max_router_logit_delta=self.max_logit_delta,
                    flips_beyond_noise=sum(g > 2 * d for g, d in flips),
                    remat_recomputes_bit_equal=self.remat_pairs)


def train_e2e_check(cfg, seed, card_device=None, batch=2, seq=128, config=TRAIN_CONFIG):
    """The training model cut to 2 layers: the card's bf16 loss and every
    gradient leaf (``forward`` / ``backward`` / ``get_full_grad``) against
    a CPU f32 engine started from the same weights, a 3-step loss
    trajectory, and a skipped step (a NaN weight) that must leave master,
    moments and the step count bit-equal and launch no AdamW. An MoE
    model's CPU engine routes as the card routed (``TrainRoutingReplay``;
    flips are reported). ``card_device``, ``batch`` and ``seq`` are for a
    rehearsal at a tiny size on the CPU."""
    import torch

    import shuffle_exchange_tpu_torch as sxt
    from shuffle_exchange_tpu_torch import ops
    from shuffle_exchange_tpu_torch.models import Transformer

    cfg = dataclasses.replace(cfg, n_layers=2, remat=True, remat_policy="nothing_saveable",
                              max_seq_len=seq)
    base = dict(config, train_batch_size=batch)
    card, *_ = sxt.initialize(model=Transformer(cfg, device=card_device), config=base, seed=seed,
                              device=card_device)
    start = {k: v.detach().cpu().clone() for k, v in card.state.master.items()}
    host_cfg = {k: v for k, v in base.items() if k != "bf16"}
    host, *_ = sxt.initialize(model=Transformer(cfg, device="cpu"), params=start,
                              config=host_cfg, device="cpu")
    ids = np.random.default_rng([seed, 10]).integers(0, cfg.vocab_size, size=(batch, seq))
    data = {"input_ids": ids.astype(np.int32)}

    replay = TrainRoutingReplay(cfg.n_layers) if cfg.n_experts else None

    def each_engine():
        for label, eng in (("card", card), ("cpu", host)):
            if replay is not None:
                replay.start(replaying=label == "cpu")
            yield label, eng

    losses = {"card": [], "cpu": []}
    with replay or contextlib.nullcontext():
        for label, eng in each_engine():
            eng.forward(data)
            losses[label].append(float(eng.backward()))
        leaves = {}
        for name in start:
            got, want = card.get_full_grad(name), host.get_full_grad(name)
            _check(np.isfinite(got).all(), f"non-finite gradient {name} on the card")
            scale = float(np.abs(want).max())
            leaves[name] = dict(max_abs_err=float(np.abs(got - want).max()), ref_abs_max=scale)
        # the k bias's gradient is zero in exact arithmetic (softmax ignores
        # a per-row shift of the scores): both engines return rounding noise
        # there, held to the largest |value| of all leaves
        top = max(leaf["ref_abs_max"] for leaf in leaves.values())
        for name, leaf in leaves.items():
            scale = top if name.endswith("b_k") else leaf["ref_abs_max"]
            leaf["rel"] = leaf["max_abs_err"] / scale if scale else 0.0
        for label, eng in each_engine():
            eng.step()
            losses[label] += [float(eng.train_batch(data)) for _ in range(2)]
    loss_rel = [abs(a - b) / abs(b) for a, b in zip(losses["card"], losses["cpu"])]

    # a skipped step: a NaN weight makes the loss non-finite
    card.set_full_fp32_param("ln_f_w", np.full(cfg.d_model, np.nan, np.float32))
    st = card.state
    bits = lambda: [t.detach().view(torch.int32).clone() for d in
                    (st.master, st.opt_state.mu, st.opt_state.nu) for t in d.values()]
    before, step_before = bits(), (st.step, st.opt_state.count)
    ops.reset_launch_counts()
    skipped_loss = float(card.train_batch(data))
    skipped = dict(loss_is_nan=math.isnan(skipped_loss),
                   state_bit_equal=all(torch.equal(a, b) for a, b in zip(before, bits())),
                   step_unchanged=(st.step, st.opt_state.count) == step_before,
                   adamw_launches=ops.launch_counts()["fused_adamw"])
    out = dict(losses=losses, loss_rel=loss_rel, leaves=leaves, skipped=skipped,
               worst_leaf=max(leaves, key=lambda n: leaves[n]["rel"]))
    if replay is not None:
        out["routing"] = replay.report()
    return out


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
    from shuffle_exchange_tpu_torch.models import Transformer, llama3_8b, mixtral_8x7b
    from shuffle_exchange_tpu_torch.ops import _build
    from shuffle_exchange_tpu_torch.ops.lora_gemm import ROW_RANK
    from shuffle_exchange_tpu_torch.ops.quant_matmul import GEMV_ROWS as QMM_GEMV_ROWS

    t_start = time.perf_counter()
    t_mark = [t_start, "start"]

    def phase(name):
        """Prints the seconds the phase that ends here took (and the
        script's total so far): the per-phase times of PERF.md's cells."""
        now = time.perf_counter()
        print(f"[phase] {t_mark[1]} took {now - t_mark[0]:.1f} s (at {now - t_start:.1f} s); "
              f"{name} starts", flush=True)
        t_mark[:] = [now, name]

    card = card_line()
    # the MoE router's f32 logits must be full f32 products (moe_layer raises otherwise)
    _check(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmuls are on")
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    phase("1")
    # 1. build: one nvcc per source, all at once
    t0 = time.perf_counter()
    libs = _build.build_all(["paged_attention", "fused_decode", "flash_attention", "fused_adam",
                             "quant_matmul", "grouped_gemm", "lora_gemm", "alibi_attention"])
    nvcc_s = time.perf_counter() - t0
    for stem, lib in libs.items():
        print(f"[build] nvcc {stem}.cu -> {lib.name}")
        print(lib.with_suffix(".log").read_text().strip())
    print(f"[build] {len(libs)} sources in {nvcc_s:.2f} s", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    t0 = time.perf_counter()
    x = torch.randn(8, 4096, generator=gen, device="cuda").bfloat16()
    ops.rmsnorm(x, torch.ones(4096, device="cuda", dtype=torch.bfloat16))
    torch.cuda.synchronize()
    print(f"[build] triton rmsnorm first launch (compile): {time.perf_counter() - t0:.2f} s",
          flush=True)

    phase("2")
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
    mlp = [check_fused_mlp(gen, B) for B in (8, 1, 16)]
    fsweep = check_fused_decode_sweep(gen, fused_rng)
    print(f"[kernel] split-K decode sweep {SWEEP}: {json.dumps(fsweep)}", flush=True)
    del case
    phase("2c")
    # 2c. the prefill's flash kernel, and B4 without a pool (v1 decode)
    flash_rng = np.random.default_rng([args.seed, 6])
    flash = check_flash(gen, flash_rng)
    qkv += [check_fused_qkv(gen, flash_rng, B, pooled=False) for B in (8, 1)]
    phase("2d")
    # 2d. the training kernels: flash backward (and the forward's lse), AdamW
    fbwd = check_flash_bwd(gen, np.random.default_rng([args.seed, 11]))
    adamw = check_fused_adamw(gen)
    phase("2e")
    # 2e. the quantized serving kernels
    qmm = check_quant_matmul(gen)
    qmlp = check_fused_mlp_quant(gen)
    phase("2f")
    # 2f. the grouped GEMM of the MoE experts
    t0 = time.perf_counter()
    ggm = check_grouped_gemm(gen, np.random.default_rng([args.seed, 12]))
    print(f"[kernel] grouped_matmul: {len(ggm)} cells in {time.perf_counter() - t0:.1f} s",
          flush=True)
    phase("2h")
    # 2h. the grouped GEMM's backward (B16-dx, B16-dw)
    t0 = time.perf_counter()
    ggb = check_grouped_gemm_bwd(gen, np.random.default_rng([args.seed, 15]))
    print(f"[kernel] grouped_matmul_dx / _dw: {len(ggb)} cells in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    phase("2g")
    # 2g. the LoRA delta of multi-tenant serving
    t0 = time.perf_counter()
    lora = check_lora_gemm(gen)
    print(f"[kernel] lora_delta: {len(lora)} cells in {time.perf_counter() - t0:.1f} s",
          flush=True)
    phase("2i")
    # 2i. the ALiBi flash kernels (B11, B12, B13)
    t0 = time.perf_counter()
    al_fwd, al_dq, al_dkv = check_alibi(gen)
    print(f"[kernel] alibi: {len(al_fwd)} cells in {time.perf_counter() - t0:.1f} s", flush=True)
    phase("2j")
    # 2j. the serving kernels' ALiBi and bias forms (BLOOM-1b7's and GPT-2's shapes)
    t0 = time.perf_counter()
    j_rng = np.random.default_rng([args.seed, 16])
    forms = {"paged_decode_attention[alibi]": check_alibi_decode(gen, j_rng),
             "paged_extend_attention[alibi]": check_alibi_extend(gen, j_rng),
             "fused_paged_decode_attention[alibi]": check_alibi_split(gen, j_rng),
             "fused_qkv_rope[bias,no-rope]": check_qkv_bias(gen, j_rng),
             "fused_mlp[layernorm,bias,plain]": check_mlp_forms(gen)}
    print(f"[kernel] ALiBi and bias forms: {sum(len(r) for r in forms.values())} cells in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    phase("2k")
    # 2k. B2, B3 and B5 over int8 and fp8 KV scale planes (Llama's and BLOOM's heads)
    t0 = time.perf_counter()
    kv_forms = check_kv_quant(gen, np.random.default_rng([args.seed, 17]))
    print(f"[kernel] KV scale-plane forms: {sum(len(r) for r in kv_forms.values())} cells in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    phase("2l")
    # 2l. B15 with an element mask, then one user call of sparse_attention
    # (forward and backward) with the counters zeroed just before
    t0 = time.perf_counter()
    sp_fwd, sp_bwd = check_sparse_mask(gen, args.seed)
    ops.reset_launch_counts()
    sparse_finite = sparse_user_call(args.seed)
    sparse_launches = ops.launch_counts()
    _check(all(sparse_finite), f"sparse_attention gave non-finite values (out, grads): "
           f"{sparse_finite}")
    _check(sparse_launches["flash_attention"] == 1 and sparse_launches["flash_attention_bwd"] == 1
           and sum(sparse_launches.values()) == 2,
           f"sparse_attention forward + backward did not launch B15's mask form once each: "
           f"{sparse_launches}")
    mask_forms = {"flash_attention[mask]": sp_fwd, "flash_attention_bwd[mask]": sp_bwd}
    phase("2m")
    # 2m. B7's norm, gate and activation forms at Llama's, BLOOM's and GPT-2's widths
    t0 = time.perf_counter()
    mq_forms = {"fused_mlp_quant[forms]": check_mlp_quant_forms(gen)}
    print(f"[kernel] B7 forms: {len(mq_forms['fused_mlp_quant[forms]'])} cells in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    print(f"[kernel] B15 with an element mask: {len(sp_fwd)} layouts in "
          f"{time.perf_counter() - t0:.1f} s; a sparse_attention call launched "
          f"{sparse_launches['flash_attention']} forward and "
          f"{sparse_launches['flash_attention_bwd']} backward", flush=True)
    phase("2n")
    # 2n. the parallel-block families' forms: B6/B7 without their norm, B4's
    # partial rotary, B2/B3/B5 and the flash forward at head_dim 256
    pb_forms = check_parallel_block_forms(gen, args.seed)
    phase("2o")
    # 2o. B2, B3 and B5 at any query-head group (Falcon-7B's 71 heads over one
    # kv head, the group edges), B4 and the flash forward at Falcon-7B's
    wg_forms = check_wide_group_forms(gen, args.seed)
    phase("2p")
    # 2p. B2, B3, B5 and the flash forward at head dims 80 and 96 (Pythia-2.8b,
    # Phi-3-mini), B4 and B6 at their widths, B9 above rank 64
    hd_forms = check_head_dim_forms(gen, args.seed)
    phase("2q")
    # 2q. the flash backward at head_dim 256 (GPT-J-6B's training; its mask form)
    fb256 = check_flash_bwd_256(gen, args.seed)
    checked = {"rmsnorm": rms, "paged_decode_attention": [dec], "paged_extend_attention": [ext],
               "fused_qkv_rope": qkv, "fused_paged_decode_attention": [fdec],
               "fused_mlp": mlp, "fused_mlp_quant": qmlp, "quant_matmul": qmm,
               "grouped_matmul": ggm,
               "grouped_matmul_dx": [r for r in ggb if r["shape"]["which"] == "dx"],
               "grouped_matmul_dw": [r for r in ggb if r["shape"]["which"] == "dw"],
               "lora_delta": lora, "flash_attention": flash,
               "flash_attention_bwd": fbwd, "fused_adamw": adamw,
               "alibi_flash_attention": al_fwd, "alibi_flash_attention_bwd_dq": al_dq,
               "alibi_flash_attention_bwd_dkv": al_dkv, **forms, **kv_forms, **mask_forms,
               **mq_forms, **pb_forms, **wg_forms, **hd_forms,
               "flash_attention_bwd[dh256]": fb256,
               "grouped_matmul[int8 / fp8, > 16 rows]": [
                   r for r in ggm if r["shape"]["fmt"] != "bf16" and r["shape"]["N"] > 16],
               "quant_matmul[wgmma]": [r for r in qmm if r["shape"]["M"] > QMM_GEMV_ROWS],
               "lora_delta[tensor cores]": [r for r in lora + hd_forms["lora_delta[wide-rank]"]
                                            if r["shape"]["T"] > 1 or r["shape"]["R"] > ROW_RANK],
               "flash_attention_bwd[dh64]": [r for r in fbwd if r["shape"]["Dh"] == 64]}
    for name, rows in checked.items():
        for r in rows:
            extra = {k: r[k] for k in ("tolerance_bites", "pool_rows_exact",
                                       "cublas_sequence_ms", "cublas_sequence_host_us",
                                       "library", "tflops", "library_kernels", "errs",
                                       "lse_max_abs_err", "fwd_out_max_abs_err",
                                       "equal_bits_twice", "fwd_equal_bits_twice",
                                       "library_backend", "library_fwd_ms", "fwd_bound_ms",
                                       "autograd_max_err_over_rms", "fwd_lse_ms",
                                       "gbytes_per_s", "dense_cublas_ms",
                                       "dense_cublas_sequence_ms", "library_sequence_ms",
                                       "null_rows_zero", "rows_equal_solo",
                                       "rows_past_sum_zero", "empty_groups_zero",
                                       "bwd_ms", "bwd_bound_ms", "bwd_host_us",
                                       "visible_pairs", "library_fwd_bwd_ms",
                                       "library_max_abs_err", "ms_without_slopes",
                                       "ms_without_biases", "ms_bf16_pool",
                                       "unmasked_causal_ms", "zero_rows_exact",
                                       "tile_map_ms", "dense_on_cuda_refused",
                                       "sparse_attention_call") if k in r}
            timed = ("" if "ms" not in r else
                     f"kernel_ms={r['ms']} host_us={r['host_us']} plain_ms={r['plain_ms']} "
                     f"library_ms={r['library_ms']} bound_ms={r['bound_ms']} ({r['bound_by']}) ")
            print(f"[kernel] {name} {json.dumps(r['shape'])}: max_abs_err={r['max_abs_err']} "
                  f"(tol {r['tolerance']}) {timed}{json.dumps(extra)} on {card}", flush=True)

    phase("3")
    # 3. serve Llama-3-8B at full width, SERVE_LAYERS layers: "auto" (the
    # fused kernels on the card), then "xla" (the paged decode kernel)
    cfg = dataclasses.replace(llama3_8b(), n_layers=SERVE_LAYERS)
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

    phase("3b")
    # 3b. put() + decode_loop, 3c. the v1 generate, on the same prompts
    prompts = loop_prompts(np.random.default_rng([args.seed, 5]), cfg.vocab_size)
    loop = put_decode_loop(model, params, prompts, cfg.n_layers, card)
    v1 = v1_generate(model, params, prompts, cfg.n_layers, card)
    same = sum(v1["tokens"][i][1:] == loop["tokens"][i] for i in range(N_PROMPTS))
    print(f"[v1 generate] sequences whose tokens equal put() + decode_loop's (bf16, plain "
          f"decode attention vs split-K): {same} of {N_PROMPTS}", flush=True)
    runs = [serves["auto"]["launches"], serves["xla"]["launches"], loop["launches"],
            v1["launches"]]

    phase("3d")
    # 3d. weight-quantized serving: each format through serve(), int8
    # through put() + decode_loop and the v1 generate
    quant = quant_serving(model, params, prompts, cfg.n_layers, card, args.seed,
                          serves["auto"])
    runs += [r["launches"] for r in quant["serve"].values()]
    runs += [quant["put_decode_loop"]["launches"], quant["v1_generate"]["launches"]]
    # the int8 put() prefill's matrices ran B8's wgmma form: 7 a layer
    qmm_kinds = (quant["trace_prefill"] or {}).get("kernels_by_kind", {})
    qmm_wg_launches = qmm_kinds.get(QMM_KIND, 0)
    _check(qmm_wg_launches == 7 * cfg.n_layers,
           f"the int8 put() prefill did not launch B8's wgmma kernel 7 times a layer: "
           f"{qmm_kinds}")

    # where the device time goes: short profiled runs of each path
    traces = {}
    for label, config in (("auto", SERVE_CONFIG), ("xla", XLA_CONFIG)):
        traces[label] = trace_serve(model, params, np.random.default_rng([args.seed, 4]), config)
    traces["put_decode_loop"] = trace_put_decode_loop(model, params, prompts)
    for label, t in traces.items():
        print(f"[trace {label}] {json.dumps(t) if t else 'no device kernels recorded'}",
              flush=True)
    # the bf16 decode window's MLP ran B6's two GEMV kernels a layer and step
    b6_launches = (traces["put_decode_loop"] or {}).get("kernels_by_kind", {}).get(B6_KIND, 0)
    _check(b6_launches == 2 * cfg.n_layers * 8,
           f"the bf16 decode window did not launch B6's two GEMV kernels a layer and step: "
           f"{(traces['put_decode_loop'] or {}).get('kernels_by_kind')}")

    phase("3f")
    # 3f. multi-tenant LoRA serving on the same weights
    t0 = time.perf_counter()
    tenants = multi_tenant_serving(model, params, prompts, cfg.n_layers, card, args.seed)
    print(f"[multi-tenant] phase 3f in {time.perf_counter() - t0:.1f} s", flush=True)
    runs += [r["launches"] for r in tenants["stripes"].values()]
    runs.append(tenants["put_decode_loop"]["launches"])
    # the adapters' put() prefill ran B9's tensor-core pair: once per adapted
    # projection (wq, wv) a layer, each call a shrink and an expand launch
    lora_kinds = (tenants["trace_prefill"] or {}).get("kernels_by_kind", {})
    lora_tc_launches = lora_kinds.get(LORA_SHRINK_KIND, 0)
    _check(lora_tc_launches == lora_kinds.get(LORA_EXPAND_KIND, 0)
           == len(MT_TARGETS) * cfg.n_layers,
           f"the adapters' put() prefill did not launch B9's tensor-core pair twice a layer: "
           f"{lora_kinds}")
    # 3l (part). the same geometry over a rank-128 pool (tenants of ranks 16, 64, 128)
    t0 = time.perf_counter()
    wide_rank = wide_rank_serving(model, params, card, args.seed)
    print(f"[wide-rank multi-tenant] in {time.perf_counter() - t0:.1f} s", flush=True)
    runs.append(wide_rank["launches"])

    phase("3h")
    # 3h. int8 and fp8 KV serving on the same weights
    t0 = time.perf_counter()
    kvserve = kv_quant_serving(model, params, prompts, cfg.n_layers, card, args.seed,
                               serves["auto"])
    print(f"[kv] phase 3h in {time.perf_counter() - t0:.1f} s", flush=True)
    kv_runs = {fmt: [r["launches"] for key, r in kvserve["serve"].items()
                     if key.startswith(fmt)] + [kvserve["put_decode_loop"][fmt]["launches"]]
               for fmt in KV_FORMATS}
    runs += [r for rs in kv_runs.values() for r in rs]

    phase("4")
    # 4. depth 2 on the card, fused and not, against the CPU f32 plain path
    cfg2 = dataclasses.replace(cfg, n_layers=2)
    state2 = {k: (v[:2] if k.startswith("layers.") else v) for k, v in params.items()}
    e2e = {"step": {}}
    for dk in ("auto", "xla"):
        t0 = time.perf_counter()
        e2e["step"][dk] = e2e_check(cfg2, state2, np.random.default_rng([args.seed, 2]),
                                    decode_kernel=dk)
        print(f"[e2e {dk}] {len(e2e['step'][dk])} step() ticks in "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
    t0 = time.perf_counter()
    e2e["put"] = e2e_put_check(cfg2, state2, np.random.default_rng([args.seed, 7]))
    e2e["v1"] = e2e_v1_check(cfg2, state2, np.random.default_rng([args.seed, 8]))
    print(f"[e2e] put() and v1 schedules in {time.perf_counter() - t0:.2f} s", flush=True)
    # the quantized engines, each against the CPU f32 engine fed the
    # weights it serves
    t0 = time.perf_counter()
    for bits in QUANT_FORMATS:
        e2e["step"][f"auto {bits}"] = e2e_check(cfg2, state2,
                                                np.random.default_rng([args.seed, 2]),
                                                quant_bits=bits)
        e2e["put"][f"auto {bits}"] = e2e_put_check(cfg2, state2,
                                                   np.random.default_rng([args.seed, 7]),
                                                   decode_kernels=("auto",),
                                                   quant_bits=bits)["auto"]
    print(f"[e2e quantized] step() and put() schedules of three formats in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    # with adapters (bf16 and int8 bases), against the CPU f32 engine with
    # the same factors
    t0 = time.perf_counter()
    for bits, name in ((None, "auto adapters"), (8, "auto int8 adapters")):
        e2e["step"][name] = e2e_check(cfg2, state2, np.random.default_rng([args.seed, 2]),
                                      quant_bits=bits, adapters=True)
        e2e["put"][name] = e2e_put_check(cfg2, state2, np.random.default_rng([args.seed, 7]),
                                         decode_kernels=("auto",), quant_bits=bits,
                                         adapters=True)["auto"]
    # 4g (part). one step() schedule over a rank-128 pool (ranks 16, 64, 128)
    e2e["step"]["auto adapters r128"] = e2e_check(cfg2, state2,
                                                  np.random.default_rng([args.seed, 2]),
                                                  adapters=E2E_WIDE)
    print(f"[e2e adapters] step() and put() schedules, bf16 and int8 bases, and a rank-128 "
          f"pool's step() schedule in {time.perf_counter() - t0:.2f} s", flush=True)
    phase("4c")
    # 4c. int8 and fp8 KV at depth 2 against the CPU f32 engine in the same mode
    kv_e2es = {"llama-3-8b": kv_e2e("llama-3-8b", cfg2, state2, args.seed)}
    report_e2e("", e2e)

    phase("3e")
    # 3e. Mixtral-8x7B at full width, SERVE_LAYERS layers, int8; the Llama
    # weights go first
    del model, params, state2
    gc.collect()
    torch.cuda.empty_cache()
    mcfg = dataclasses.replace(mixtral_8x7b(), n_layers=SERVE_LAYERS)
    t0 = time.perf_counter()
    mixtral = mixtral_serving(mcfg, args.seed, card)
    print(f"[mixtral] phase 3e in {time.perf_counter() - t0:.1f} s", flush=True)
    # the put() prefill's expert products ran B16's int8 wgmma form: 3 a layer
    prefill_kinds = (mixtral["trace_prefill"] or {}).get("kernels_by_kind", {})
    qgmm_launches = prefill_kinds.get(QGMM_KIND, 0)
    _check(qgmm_launches == 3 * mcfg.n_layers,
           f"Mixtral's int8 put() prefill did not launch B16's quantized wgmma kernel 3 times "
           f"a layer: {prefill_kinds}")
    # the decode window's expert products (16 rows a tick) ran B16's tensor-core
    # GEMV, found by its kernel's name: its device ms a tick of the 8 steps
    dec = mixtral["trace_decode_loop"] or {}
    gemv_launches = dec.get("kernels_by_kind", {}).get(GEMV_KIND, 0)
    gemv_ms = dec.get("by_kind_ms", {}).get(GEMV_KIND, 0.0) / 8
    mixtral["b16_decode"] = dict(launches=gemv_launches, ms_per_tick=gemv_ms,
                                 layers=mcfg.n_layers)
    print(f"[trace_decode_loop mixtral] B16 decode rows (tensor-core GEMV): {gemv_launches} "
          f"launches by name over 8 ticks at {mcfg.n_layers} layers, {gemv_ms:.4f} device ms a "
          f"tick ({gemv_ms / mcfg.n_layers:.4f} a layer; of {dec.get('device_busy_ms', 0) / 8:.4f} "
          f"busy ms a tick)", flush=True)
    _check(gemv_launches == 3 * mcfg.n_layers * 8,
           f"Mixtral's int8 decode window did not launch B16's tensor-core GEMV 3 times a layer "
           f"and tick: {dec.get('kernels_by_kind')}")
    runs += [r["launches"] for r in mixtral["serve"].values()]
    runs += [mixtral["put_decode_loop"]["launches"], mixtral["v1_generate"]["launches"]]
    # 4, MoE: depth 2, int8 and fp8, against the CPU f32 engine
    t0 = time.perf_counter()
    mcfg2 = dataclasses.replace(mcfg, n_layers=2)
    mstate2 = Transformer(mcfg2).init(torch.Generator(device="cuda").manual_seed(args.seed + 9),
                                      dtype=torch.bfloat16)
    moe_e2e = {}
    for bits in (8, "fp8"):
        name = "fp8" if bits == "fp8" else "int8"
        moe_e2e[name] = moe_e2e_check(mcfg2, mstate2, args.seed, bits)
        for what, r in moe_e2e[name].items():
            for i, t in enumerate(r["calls"]):
                print(f"[e2e mixtral {name} {what}] call {i}: rows={t['rows']} "
                      f"max_abs_err={t['max_abs_err']} (tol {E2E_REL_TOL} x |ref| max "
                      f"{t['ref_abs_max']}) argmax_agree={t['argmax_agree']}")
            print(f"[e2e mixtral {name} {what}] routed rows {r['routed_rows']} (all layers), "
                  f"flips on tokens {r['flips']} (on padding rows "
                  f"{r['padding_row_flips']}); largest [2nd-3rd f32 router-logit gap, router-logit "
                  f"difference] of the flips {r['flip_gaps_top']}; largest router-logit "
                  f"difference {r['max_router_logit_delta']} (rule: {MOE_FLIP_RULE})",
                  flush=True)
            _check(all(t["within"] for t in r["calls"]), f"depth-2 Mixtral {name} {what} "
                   "logits on the card disagree with the CPU f32 engine where routing agrees")
            _check(r["flips_beyond_noise"] == 0, f"depth-2 Mixtral {name} {what}: "
                   f"{r['flips_beyond_noise']} routing flips wider than the router logits' "
                   f"difference explains")
    del mstate2
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[e2e mixtral] int8 and fp8 in {time.perf_counter() - t0:.1f} s", flush=True)

    phase("3g")
    # 3g. BLOOM-1b7 (ALiBi) and GPT-2 125M (learned positions) at full width,
    # SERVE_LAYERS layers; 4b. each cut to depth 2 against the CPU f32 engine
    from shuffle_exchange_tpu_torch.models import config_from_hf, gpt2_small

    families, family_e2es, fquant, fquant_e2e = {}, {}, {}, {}
    for name, fcfg, fconf, fv1, longest in (
            ("bloom-1b7", config_from_hf(BLOOM_1B7), SERVE_CONFIG, V1_CONFIG, 1024),
            ("gpt2-small", gpt2_small(), GPT2_SERVE, GPT2_V1, 960)):
        fcfg = dataclasses.replace(fcfg, n_layers=min(fcfg.n_layers, SERVE_LAYERS))
        t0 = time.perf_counter()
        families[name], fparams = family_serving(name, fcfg, args.seed + 21, card, fconf, fv1,
                                                 longest)
        t1 = time.perf_counter()
        family_e2es[name] = family_e2e(name, fcfg, fparams, args.seed)
        print(f"[{name}] phase 3g in {t1 - t0:.1f} s, 4b in {time.perf_counter() - t1:.1f} s",
              flush=True)
        if name == "bloom-1b7":   # where slopes and scales meet: int8 KV, then 4c
            t1 = time.perf_counter()
            fprompts = loop_prompts(np.random.default_rng([args.seed + 21, 5]), fcfg.vocab_size,
                                    longest=longest)
            families[name]["kv"] = kv_quant_serving(
                Transformer(fcfg), fparams, fprompts, fcfg.n_layers, card, args.seed + 21,
                families[name]["serve"]["auto"], formats=("int8",), decode_kernels=("auto",),
                config=fconf, prompt_range=(128, longest), label=f"{name} ", trace=False)
            kv_runs["int8"] += [r["launches"] for r in families[name]["kv"]["serve"].values()]
            kv_runs["int8"].append(families[name]["kv"]["put_decode_loop"]["int8"]["launches"])
            runs += kv_runs["int8"][-2:]
            t2 = time.perf_counter()
            kv_e2es[name] = kv_e2e(name, dataclasses.replace(fcfg, n_layers=2),
                                   {k: (v[:2] if k.startswith("layers.") else v)
                                    for k, v in fparams.items()}, args.seed)
            print(f"[{name}] int8 KV serving in {t2 - t1:.1f} s, 4c in "
                  f"{time.perf_counter() - t2:.1f} s", flush=True)
        # 3i. quantized weights and multi-tenant adapters on the same weights;
        # 4d. BLOOM-1b7 int8 at depth 2 against the CPU f32 engine
        t1 = time.perf_counter()
        qcfg, qparams = fcfg, fparams
        fquant[name] = family_quant_serving(name, qcfg, qparams, args.seed + 21, card, fconf,
                                            fv1, longest)
        del qparams
        runs += fquant[name].pop("runs")
        t2 = time.perf_counter()
        if name == "bloom-1b7":
            fquant_e2e[name] = family_quant_e2e(name, fcfg, fparams, args.seed)
        print(f"[{name}] phase 3i in {t2 - t1:.1f} s, 4d in {time.perf_counter() - t2:.1f} s",
              flush=True)
        del fparams
        gc.collect()
        torch.cuda.empty_cache()
    family_runs = {name: [f["serve"]["auto"]["launches"], f["serve"]["xla"]["launches"],
                          f["put_decode_loop"]["launches"], f["v1_generate"]["launches"]]
                   for name, f in families.items()}
    runs += [r for rs in family_runs.values() for r in rs]
    # each new form's launches on the path that runs it: the slopes on
    # BLOOM's, B4's biases without RoPE on both, B6's layernorm form on BLOOM's
    form_models = {"paged_decode_attention[alibi]": ("bloom-1b7",),
                   "paged_extend_attention[alibi]": ("bloom-1b7",),
                   "fused_paged_decode_attention[alibi]": ("bloom-1b7",),
                   "fused_qkv_rope[bias,no-rope]": ("bloom-1b7", "gpt2-small"),
                   "fused_mlp[layernorm,bias,plain]": ("bloom-1b7",)}
    form_launches = {form: sum(r[form.split("[")[0]] for m in models_ for r in family_runs[m])
                     for form, models_ in form_models.items()}
    form_launches["grouped_matmul[int8 / fp8, > 16 rows]"] = qgmm_launches
    form_launches["quant_matmul[wgmma]"] = qmm_wg_launches
    form_launches["lora_delta[tensor cores]"] = lora_tc_launches
    _check(all(n > 0 for n in form_launches.values()),
           f"a kernel form never launched on its serving path: {form_launches}")
    _check(all(r["rmsnorm"] == 0 for rs in family_runs.values() for r in rs),
           "a layernorm model launched the RMSNorm kernel")
    # the scale-plane forms' launches on the int8 / fp8 KV runs (3h, BLOOM's
    # int8 serve), the mask form's on the sparse_attention call
    kv_launches = {f"{k}[{fmt}]": sum(r[k] for r in kv_runs[fmt]) for fmt in KV_FORMATS
                   for k in ("paged_decode_attention", "paged_extend_attention",
                             "fused_paged_decode_attention")}
    _check(all(n > 0 for n in kv_launches.values()),
           f"a scale-plane form never launched on its serving path: {kv_launches}")
    form_launches.update(kv_launches)
    form_launches.update({f"{k}[mask]": sparse_launches[k]
                          for k in ("flash_attention", "flash_attention_bwd")})
    # B7's new forms on BLOOM-1b7's widths without fc biases (3i)
    form_launches["fused_mlp_quant[forms]"] = fquant["bloom-1b7"]["b7_form_launches"]

    phase("3j")
    # 3j. GPT-J-6B (shared-layernorm parallel blocks, interleaved RoPE, head
    # dim 256) and Pythia-1.4b (two layernorms, partial rotary) at full width,
    # SERVE_LAYERS layers; 4e. each cut to depth 2 against the CPU f32 engine
    pblocks, pb_e2es = {}, {}
    for name, hf in (("gpt-j-6b", GPTJ_6B), ("pythia-1.4b", PYTHIA_1B4)):
        pcfg = config_from_hf(hf)
        pcfg = dataclasses.replace(pcfg, n_layers=min(pcfg.n_layers, SERVE_LAYERS))
        t0 = time.perf_counter()
        pblocks[name], pparams = parallel_block_serving(name, pcfg, args.seed + 23, card)
        t1 = time.perf_counter()
        pb_e2es[name] = family_e2e(name, pcfg, pparams, args.seed)
        print(f"[{name}] phase 3j in {t1 - t0:.1f} s, 4e in {time.perf_counter() - t1:.1f} s",
              flush=True)
        del pparams
        gc.collect()
        torch.cuda.empty_cache()
    pb_runs = {name: [p["serve"]["auto"]["launches"], p["serve"]["xla"]["launches"],
                      p["put_decode_loop"]["launches"], p["v1_generate"]["launches"]]
               for name, p in pblocks.items()}
    runs += [r for rs in pb_runs.values() for r in rs]
    runs.append(pblocks["gpt-j-6b"]["nobias_int8"]["launches"])
    _check(all(r["rmsnorm"] == 0 for rs in pb_runs.values() for r in rs),
           "a layernorm model launched the RMSNorm kernel")
    # each new form's launches on the path that runs it: head_dim 256 and B6
    # without its norm on GPT-J's, B4's partial rotary on Pythia's, B7
    # without its norm on GPT-J's mlp_bias=False int8 serve
    pb_models = {"fused_mlp[no-norm]": "gpt-j-6b", "fused_qkv_rope[partial-rope]": "pythia-1.4b",
                 "paged_decode_attention[dh256]": "gpt-j-6b",
                 "paged_extend_attention[dh256]": "gpt-j-6b",
                 "fused_paged_decode_attention[dh256]": "gpt-j-6b",
                 "flash_attention[dh256]": "gpt-j-6b"}
    for form, m in pb_models.items():
        form_launches[form] = sum(r[form.split("[")[0]] for r in pb_runs[m])
    form_launches["fused_mlp_quant[no-norm]"] = \
        pblocks["gpt-j-6b"]["nobias_int8"]["launches"]["fused_mlp_quant"]
    _check(all(form_launches[f] > 0 for f in pb_forms),
           f"a parallel-block kernel form never launched on its serving path: "
           f"{ {f: form_launches[f] for f in pb_forms} }")

    phase("3k")
    # 3k. Falcon-7B (multi-query: 71 heads of 64 over one kv head; the
    # shared-layernorm parallel block) at full width, SERVE_LAYERS layers;
    # 4f. cut to depth 2 against the CPU f32 engine
    fcfg = dataclasses.replace(config_from_hf(FALCON_7B), n_layers=SERVE_LAYERS)
    t0 = time.perf_counter()
    falcon, fparams = model_serving("falcon-7b", fcfg, args.seed + 25, card)
    t1 = time.perf_counter()
    falcon_e2es = model_e2e("falcon-7b", fcfg, fparams, args.seed)
    print(f"[falcon-7b] phase 3k in {t1 - t0:.1f} s, 4f in {time.perf_counter() - t1:.1f} s",
          flush=True)
    del fparams
    gc.collect()
    torch.cuda.empty_cache()
    falcon_runs = [falcon["serve"]["auto"]["launches"], falcon["serve"]["xla"]["launches"],
                   falcon["put_decode_loop"]["launches"], falcon["v1_generate"]["launches"]]
    runs += falcon_runs
    _check(all(r["rmsnorm"] == 0 for r in falcon_runs),
           "a layernorm model launched the RMSNorm kernel")
    for form in wg_forms:
        form_launches[form] = sum(r[form.split("[")[0]] for r in falcon_runs)
    _check(all(form_launches[f] > 0 for f in wg_forms),
           f"a wide-group kernel form never launched on Falcon-7B's serving path: "
           f"{ {f: form_launches[f] for f in wg_forms} }")

    phase("3l")
    # 3l. Phi-3-mini (head dim 96) and Pythia-2.8b (head dim 80) at full width,
    # SERVE_LAYERS layers; 4g. each cut to depth 2 against the CPU f32 engine
    hdims, hd_e2es = {}, {}
    for name, hf in (("phi-3-mini", PHI3_MINI), ("pythia-2.8b", PYTHIA_2B8)):
        hcfg = dataclasses.replace(config_from_hf(hf), n_layers=SERVE_LAYERS)
        t0 = time.perf_counter()
        hdims[name], hparams = model_serving(name, hcfg, args.seed + 27, card)
        t1 = time.perf_counter()
        hd_e2es[name] = model_e2e(name, hcfg, hparams, args.seed,
                                  E2E_REL_TOL if hcfg.norm == "rmsnorm" else E2E_LOGIT_TOL)
        print(f"[{name}] phase 3l in {t1 - t0:.1f} s, 4g in {time.perf_counter() - t1:.1f} s",
              flush=True)
        del hparams
        gc.collect()
        torch.cuda.empty_cache()
    hd_runs = {name: [h["serve"]["auto"]["launches"], h["serve"]["xla"]["launches"],
                      h["put_decode_loop"]["launches"], h["v1_generate"]["launches"]]
               for name, h in hdims.items()}
    runs += [r for rs in hd_runs.values() for r in rs]
    _check(all(r["rmsnorm"] == 0 for r in hd_runs["pythia-2.8b"]),
           "a layernorm model launched the RMSNorm kernel")
    # each new form's launches on the path that runs it: head dim 96, B4 and
    # B6 at Phi-3-mini's widths on Phi-3-mini's; head dim 80 and B4's rd 20
    # on Pythia-2.8b's; B9 above rank 64 on the rank-128 serve
    hd_models = {"[dh96]": "phi-3-mini", "[phi-3-mini]": "phi-3-mini",
                 "[dh80]": "pythia-2.8b", "[pythia-2.8b]": "pythia-2.8b"}
    for form in hd_forms:
        base, tag = form.split("[")[0], "[" + form.split("[")[1]
        form_launches[form] = (wide_rank["launches"][base] if tag == "[wide-rank]" else
                               sum(r[base] for r in hd_runs[hd_models[tag]]))
    _check(all(form_launches[f] > 0 for f in hd_forms),
           f"a head-dim or rank form never launched on its serving path: "
           f"{ {f: form_launches[f] for f in hd_forms} }")

    phase("5")
    # 5. train the ladder's pick at full width and depth; 6. depth 2 against
    # the CPU
    from shuffle_exchange_tpu_torch.models import pick_ladder_config

    mem = torch.cuda.get_device_properties(0).total_memory
    pick, train_cfg = pick_ladder_config(mem)
    print(f"[train] the ladder rule picks {pick} for {mem / 2 ** 30:.1f} GiB of device memory",
          flush=True)
    trained = train(pick, train_cfg, args.seed, card)
    t0 = time.perf_counter()
    te2e = train_e2e_check(train_cfg, args.seed)
    print(f"[e2e train] depth 2, bf16 on the card against f32 on the CPU in "
          f"{time.perf_counter() - t0:.2f} s: losses {te2e['losses']} (relative differences "
          f"{te2e['loss_rel']}, tol {TRAIN_LOSS_TOL}); worst gradient leaf "
          f"{te2e['worst_leaf']} {te2e['leaves'][te2e['worst_leaf']]} (tol {TRAIN_GRAD_TOL} x the "
          f"leaf's largest |value|); skipped step {te2e['skipped']} on {card}", flush=True)
    for name, leaf in te2e["leaves"].items():
        print(f"[e2e train] grad {name}: max_abs_err={leaf['max_abs_err']} "
              f"ref_abs_max={leaf['ref_abs_max']} rel={leaf['rel']}")
    _check(all(r <= TRAIN_LOSS_TOL for r in te2e["loss_rel"]),
           f"depth-2 training losses on the card disagree with the CPU f32 path: {te2e['losses']}")
    _check(all(leaf["rel"] <= TRAIN_GRAD_TOL for leaf in te2e["leaves"].values()),
           f"depth-2 gradients on the card disagree with the CPU f32 path: {te2e['worst_leaf']}")
    sk = te2e["skipped"]
    _check(sk["loss_is_nan"] and sk["state_bit_equal"] and sk["step_unchanged"]
           and sk["adamw_launches"] == 0, f"a skipped step changed the state: {sk}")

    phase("5b")
    # 5b. MoE training: bench.py's _config3 model at full width and depth,
    # under "capacity" (the bench row) and "ragged" (dropless); 6b. cut to
    # depth 2 against the CPU f32 engine routed as the card routed
    gc.collect()
    torch.cuda.empty_cache()
    moe_trained = {}
    for impl in ("capacity", "ragged"):
        t0 = time.perf_counter()
        moe_trained[impl] = train(f"config3-{impl}", config3(impl), args.seed, card,
                                  config=MOE_TRAIN_CONFIG, steps=MOE_TRAIN_STEPS)
        print(f"[train moe] {impl} in {time.perf_counter() - t0:.1f} s", flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    me2e = train_e2e_check(config3("capacity"), args.seed, config=MOE_TRAIN_CONFIG)
    r = me2e["routing"]
    print(f"[e2e train moe] depth 2 _config3 (capacity), bf16 on the card against f32 on the "
          f"CPU routed as the card routed, in {time.perf_counter() - t0:.2f} s: losses "
          f"{me2e['losses']} (relative differences {me2e['loss_rel']}, tol {TRAIN_LOSS_TOL}); "
          f"worst gradient leaf {me2e['worst_leaf']} {me2e['leaves'][me2e['worst_leaf']]} (tol "
          f"{TRAIN_GRAD_TOL} x the leaf's largest |value|); routed rows {r['routed_rows']}, "
          f"flips {r['flips']}, largest [2nd-3rd f32 router-logit gap, router-logit "
          f"difference] of the flips {r['flip_gaps_top']}, largest router-logit difference "
          f"{r['max_router_logit_delta']} (rule: {MOE_FLIP_RULE}); remat recomputes bit-equal "
          f"to their forwards: {r['remat_recomputes_bit_equal']}; skipped step "
          f"{me2e['skipped']} on {card}", flush=True)
    for name, leaf in me2e["leaves"].items():
        print(f"[e2e train moe] grad {name}: max_abs_err={leaf['max_abs_err']} "
              f"ref_abs_max={leaf['ref_abs_max']} rel={leaf['rel']}")
    _check(all(x <= TRAIN_LOSS_TOL for x in me2e["loss_rel"]),
           f"depth-2 MoE training losses on the card disagree with the CPU f32 path: "
           f"{me2e['losses']}")
    _check(all(leaf["rel"] <= TRAIN_GRAD_TOL for leaf in me2e["leaves"].values()),
           f"depth-2 MoE gradients on the card disagree with the CPU f32 path: "
           f"{me2e['worst_leaf']}")
    _check(r["flips_beyond_noise"] == 0, f"depth-2 MoE training: {r['flips_beyond_noise']} "
           "routing flips wider than the router logits' difference explains")
    _check(r["remat_recomputes_bit_equal"] > 0, "no remat recompute was checked")
    sk = me2e["skipped"]
    _check(sk["loss_is_nan"] and sk["state_bit_equal"] and sk["step_unchanged"]
           and sk["adamw_launches"] == 0, f"a skipped MoE step changed the state: {sk}")

    phase("5c")
    # 5c. BLOOM-1b7 (ALiBi: B11-B13) at full width and depth; 5d. GPT-2
    # under _config1 (B14 on the MHA path); 6c. BLOOM cut to depth 2 against
    # the CPU f32 engine
    from shuffle_exchange_tpu_torch.models import config_from_hf, gpt2_small

    gc.collect()
    torch.cuda.empty_cache()
    bloom_cfg = config_from_hf(BLOOM_1B7)
    t0 = time.perf_counter()
    bloom = train("bloom-1b7", bloom_cfg, args.seed, card, batch=BLOOM_BATCH, seq=BLOOM_SEQ,
                  steps=MOE_TRAIN_STEPS)
    print(f"[train bloom] phase 5c in {time.perf_counter() - t0:.1f} s", flush=True)
    # the profiled step ran the ALiBi wgmma kernels by name: B11 2L (full
    # remat), B12 and B13 L
    bloom_kinds = (bloom.get("trace") or {}).get("kernels_by_kind", {})
    L_bloom = bloom_cfg.n_layers
    _check([bloom_kinds.get(k) for k in ("alibi_flash_attention (B11)", "alibi dq (B12)",
                                         "alibi dk/dv (B13)")] == [2 * L_bloom, L_bloom, L_bloom],
           f"BLOOM-1b7's profiled step did not run B11 2L and B12 / B13 L times: {bloom_kinds}")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    gpt2 = train("gpt2-small (_config1)", gpt2_small(), args.seed, card, batch=GPT2_BATCH,
                 seq=GPT2_SEQ, config=CONFIG1, steps=GPT2_STEPS, remat=False)
    print(f"[train gpt2] phase 5d in {time.perf_counter() - t0:.1f} s", flush=True)
    # GPT-2's step ran the flash backward at head_dim 64 once a layer, on the
    # wgmma dk/dv and dq kernels (its profiled step)
    form_launches["flash_attention_bwd[dh64]"] = gpt2["launches"]["flash_attention_bwd"]
    gpt2_layers = gpt2_small().n_layers
    gpt2_kinds = (gpt2.get("trace") or {}).get("kernels_by_kind", {})
    _check(gpt2["launches_per_step"]["flash_attention_bwd"] == gpt2_layers
           and all(gpt2_kinds.get(f"flash_attention_bwd (wgmma {k})") == gpt2_layers
                   for k in ("dk/dv", "dq")),
           f"GPT-2's training step did not run the wgmma flash backward at head_dim 64 once a "
           f"layer: {gpt2['launches_per_step']}, profiled step {gpt2_kinds}")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    be2e = train_e2e_check(bloom_cfg, args.seed)
    print(f"[e2e train bloom] depth 2 BLOOM-1b7, bf16 on the card against f32 on the CPU in "
          f"{time.perf_counter() - t0:.2f} s: losses {be2e['losses']} (relative differences "
          f"{be2e['loss_rel']}, tol {TRAIN_LOSS_TOL}); worst gradient leaf "
          f"{be2e['worst_leaf']} {be2e['leaves'][be2e['worst_leaf']]} (tol {TRAIN_GRAD_TOL} x the "
          f"leaf's largest |value|); skipped step {be2e['skipped']} on {card}", flush=True)
    for name, leaf in be2e["leaves"].items():
        print(f"[e2e train bloom] grad {name}: max_abs_err={leaf['max_abs_err']} "
              f"ref_abs_max={leaf['ref_abs_max']} rel={leaf['rel']}")
    _check(all(x <= TRAIN_LOSS_TOL for x in be2e["loss_rel"]),
           f"depth-2 BLOOM training losses on the card disagree with the CPU f32 path: "
           f"{be2e['losses']}")
    _check(all(leaf["rel"] <= TRAIN_GRAD_TOL for leaf in be2e["leaves"].values()),
           f"depth-2 BLOOM gradients on the card disagree with the CPU f32 path: "
           f"{be2e['worst_leaf']}")
    sk = be2e["skipped"]
    _check(sk["loss_is_nan"] and sk["state_bit_equal"] and sk["step_unchanged"]
           and sk["adamw_launches"] == 0, f"a skipped BLOOM step changed the state: {sk}")

    phase("5e")
    # 5e. GPT-J-6B's widths at 14 of its 28 layers (head_dim 256: the flash
    # backward's 256 form); 5f. Pythia-1.4b whole; 6d. each cut to depth 2
    # against the CPU f32 engine
    pb_trained, pb_te2e = {}, {}
    for name, hf, layers, (batch, seq) in PB_TRAIN:
        pcfg = config_from_hf(hf)
        pcfg = dataclasses.replace(pcfg, n_layers=layers or pcfg.n_layers)
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        pb_trained[name] = train(name, pcfg, args.seed, card, batch=batch, seq=seq,
                                 steps=MOE_TRAIN_STEPS)
        print(f"[train {name}] phase {'5e' if layers else '5f'} in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        e2e = pb_te2e[name] = train_e2e_check(pcfg, args.seed)
        print(f"[e2e train {name}] phase 6d, depth 2, bf16 on the card against f32 on the CPU "
              f"in {time.perf_counter() - t0:.2f} s: losses {e2e['losses']} (relative "
              f"differences {e2e['loss_rel']}, tol {TRAIN_LOSS_TOL}); worst gradient leaf "
              f"{e2e['worst_leaf']} {e2e['leaves'][e2e['worst_leaf']]} (tol {TRAIN_GRAD_TOL} x "
              f"the leaf's largest |value|); skipped step {e2e['skipped']} on {card}", flush=True)
        for leaf_name, leaf in e2e["leaves"].items():
            print(f"[e2e train {name}] grad {leaf_name}: max_abs_err={leaf['max_abs_err']} "
                  f"ref_abs_max={leaf['ref_abs_max']} rel={leaf['rel']}")
        _check(all(x <= TRAIN_LOSS_TOL for x in e2e["loss_rel"]),
               f"depth-2 {name} training losses on the card disagree with the CPU f32 path: "
               f"{e2e['losses']}")
        _check(all(leaf["rel"] <= TRAIN_GRAD_TOL for leaf in e2e["leaves"].values()),
               f"depth-2 {name} gradients on the card disagree with the CPU f32 path: "
               f"{e2e['worst_leaf']}")
        sk = e2e["skipped"]
        _check(sk["loss_is_nan"] and sk["state_bit_equal"] and sk["step_unchanged"]
               and sk["adamw_launches"] == 0, f"a skipped {name} step changed the state: {sk}")
    # the backward's 256 form on GPT-J's training path: once a layer and step
    gptj_train = pb_trained["gpt-j-6b"]
    form_launches["flash_attention_bwd[dh256]"] = gptj_train["launches"]["flash_attention_bwd"]
    _check(gptj_train["launches_per_step"]["flash_attention_bwd"] == PB_TRAIN[0][2],
           f"GPT-J-6B's training step did not launch the flash backward at head_dim 256 once "
           f"a layer: {gptj_train['launches_per_step']}")

    runs.append(trained["launches"])
    runs += [t["launches"] for t in moe_trained.values()]
    runs += [bloom["launches"], gpt2["launches"]]
    runs += [t["launches"] for t in pb_trained.values()]
    launches = {k: sum(r[k] for r in runs) for k in ops.KERNEL_WRAPPERS}
    _check(all(n > 0 for n in launches.values()), f"a kernel never launched: {launches}")

    replaces = {"rmsnorm": "shuffle_exchange_tpu/ops/rmsnorm.py:87",
                "paged_decode_attention": "shuffle_exchange_tpu/ops/paged_attention.py:39",
                "paged_extend_attention": "shuffle_exchange_tpu/ops/paged_attention.py:216",
                "fused_qkv_rope": "shuffle_exchange_tpu/ops/fused_decode.py:130",
                "fused_paged_decode_attention": "shuffle_exchange_tpu/ops/fused_decode.py:324",
                "fused_mlp": "shuffle_exchange_tpu/ops/fused_decode.py:536",
                "fused_mlp_quant": "shuffle_exchange_tpu/ops/fused_decode.py:634",
                "quant_matmul": "shuffle_exchange_tpu/ops/quant_matmul.py:217",
                "grouped_matmul": "shuffle_exchange_tpu/ops/grouped_gemm.py:63",
                "grouped_matmul_dx": "shuffle_exchange_tpu/ops/grouped_gemm.py:63",
                "grouped_matmul_dw": "shuffle_exchange_tpu/ops/grouped_gemm.py:63",
                "lora_delta": "shuffle_exchange_tpu/ops/lora_gemm.py:60",
                "flash_attention": "shuffle_exchange_tpu/ops/flash_attention.py:122",
                "flash_attention_bwd": "shuffle_exchange_tpu/ops/flash_attention.py:122",
                "fused_adamw": "shuffle_exchange_tpu/ops/fused_adam.py:40",
                "alibi_flash_attention": "shuffle_exchange_tpu/ops/alibi_attention.py:279",
                "alibi_flash_attention_bwd_dq": "shuffle_exchange_tpu/ops/alibi_attention.py:365",
                "alibi_flash_attention_bwd_dkv":
                    "shuffle_exchange_tpu/ops/alibi_attention.py:365"}
    paged_cu = "shuffle_exchange_tpu_torch/ops/csrc/paged_attention.cu"
    fused_cu = "shuffle_exchange_tpu_torch/ops/csrc/fused_decode.cu"
    flash_cu = "shuffle_exchange_tpu_torch/ops/csrc/flash_attention.cu"
    alibi_cu = "shuffle_exchange_tpu_torch/ops/csrc/alibi_attention.cu"
    sources = {"rmsnorm": ("triton", "shuffle_exchange_tpu_torch/ops/rmsnorm_triton.py"),
               "paged_decode_attention": ("cuda", paged_cu),
               "paged_extend_attention": ("cuda", paged_cu),
               "fused_qkv_rope": ("cuda", fused_cu),
               "fused_paged_decode_attention": ("cuda", fused_cu),
               "fused_mlp": ("cuda", fused_cu), "fused_mlp_quant": ("cuda", fused_cu),
               "quant_matmul": ("cuda", "shuffle_exchange_tpu_torch/ops/csrc/quant_matmul.cu"),
               "grouped_matmul": ("cuda", "shuffle_exchange_tpu_torch/ops/csrc/grouped_gemm.cu"),
               "grouped_matmul_dx": ("cuda",
                                     "shuffle_exchange_tpu_torch/ops/csrc/grouped_gemm.cu"),
               "grouped_matmul_dw": ("cuda",
                                     "shuffle_exchange_tpu_torch/ops/csrc/grouped_gemm.cu"),
               "lora_delta": ("cuda", "shuffle_exchange_tpu_torch/ops/csrc/lora_gemm.cu"),
               "flash_attention": ("cuda", flash_cu), "flash_attention_bwd": ("cuda", flash_cu),
               "fused_adamw": ("cuda", "shuffle_exchange_tpu_torch/ops/csrc/fused_adam.cu"),
               "alibi_flash_attention": ("cuda", alibi_cu),
               "alibi_flash_attention_bwd_dq": ("cuda", alibi_cu),
               "alibi_flash_attention_bwd_dkv": ("cuda", alibi_cu)}
    # B12 and B13 launch together under one wrapper (and one counter)
    counter = {"alibi_flash_attention_bwd_dq": "alibi_flash_attention_bwd",
               "alibi_flash_attention_bwd_dkv": "alibi_flash_attention_bwd"}
    phase("report")
    kernels = []
    for name, rows in checked.items():
        base = name.split("[")[0]
        route, source = sources[base]
        m = rows[0]           # timed at the first (largest) shape
        if name == "grouped_matmul":    # the main path's cell: a decode tick's int8 w_gate
            m = next(r for r in rows if r["shape"]["fmt"] == "8" and r["shape"]["N"] == 16
                     and r["shape"]["K"] == 4096 and r["shape"]["groups"] == "ragged")
        if name.startswith("grouped_matmul[int8"):   # a put()'s 16,384 rows of int8 w_gate
            m = next(r for r in rows if r["shape"]["fmt"] == "8" and r["shape"]["N"] == 16384
                     and r["shape"]["K"] == 4096 and r["shape"]["groups"] == "ragged")
        if name in ("grouped_matmul_dx", "grouped_matmul_dw"):   # phase 5b's bench row
            m = next(r for r in rows if r["shape"]["label"] == "config3 capacity"
                     and r["shape"]["K"] == 1024)
        if name == "lora_delta":        # the main path's cell: a decode tick of phase 3f's pool
            m = next(r for r in rows if (r["shape"]["B"], r["shape"]["T"], r["shape"]["N"],
                                         r["shape"]["R"], r["shape"]["S"]) == (8, 1, 4096, 8, 5))
        if name == "lora_delta[tensor cores]":   # phase 3f's put(): 8 x 1024 rows at rank 8
            m = next(r for r in rows if (r["shape"]["B"], r["shape"]["T"], r["shape"]["N"],
                                         r["shape"]["R"], r["shape"]["S"]) == (8, 1024, 4096, 8, 5))
        if name == "quant_matmul[wgmma]":   # an int8 put()'s 8,192 rows of w_gate
            m = next(r for r in rows if (r["shape"]["bits"], r["shape"]["M"], r["shape"]["K"],
                                         r["shape"]["N"]) == ("8", 8192, 4096, 14336))
        kernels.append({"name": name, "route": route, "source": source,
                        "replaces": replaces[base],
                        "launches": (form_launches[name] if name in form_launches
                                     else launches[counter.get(name, name)]),
                        "max_abs_err": max(r["max_abs_err"] for r in rows),
                        "ms": m["ms"], "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
                        "bound_by": m["bound_by"], "library_ms": m["library_ms"]})
    for s_ in [*serves.values(), *(s_ for f in [*families.values(), *pblocks.values(), falcon,
                                                *hdims.values()]
                                   for s_ in f["serve"].values())]:
        s_["tokens"] = {int(u): t for u, t in s_["tokens"].items()}
    result = {"card": card, "seconds": time.perf_counter() - t_start,
              "build": {"nvcc_s": nvcc_s}, "kernels": kernels,
              "kernel_checks": dict(checked, paged_sweep=sweep, fused_decode_sweep=fsweep),
              "serve": serves, "put_decode_loop": loop, "v1_generate": v1, "trace": traces,
              "quant_serving": quant, "multi_tenant": tenants, "mixtral": mixtral,
              "moe_e2e": moe_e2e,
              "e2e": e2e, "train": trained, "train_e2e": te2e, "train_moe": moe_trained,
              "train_moe_e2e": me2e, "train_bloom": bloom, "train_gpt2": gpt2,
              "train_bloom_e2e": be2e, "train_parallel_block": pb_trained,
              "train_parallel_block_e2e": pb_te2e, "alibi_gpt2_serving": families,
              "alibi_gpt2_e2e": family_e2es, "form_launches": form_launches,
              "kv_quant_serving": kvserve, "kv_e2e": kv_e2es,
              "family_quant_serving": fquant, "family_quant_e2e": fquant_e2e,
              "parallel_block_serving": pblocks, "parallel_block_e2e": pb_e2es,
              "falcon_serving": falcon, "falcon_e2e": falcon_e2es,
              "head_dim_serving": hdims, "head_dim_e2e": hd_e2es,
              "wide_rank_serving": wide_rank,
              "sparse_user_call": {"launches": sparse_launches, "finite": sparse_finite}}
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
