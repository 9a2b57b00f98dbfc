"""Digest and time the PyTorch port's kernels on one CUDA card.

Runs the flash-attention kernels (B14 / B15 forward and backward, and
B15's element-mask form), the
grouped GEMM (B16 forward over bf16 and int8 stacks, its dx and dw; at the
main paths' shapes in every format beside ``torch._grouped_mm``, the bf16
forward, dx and dw held to their plain versions), the
quantized matmul (B8, both forms; at a tick's 256 chunk rows and a put()'s
8,192 rows on Llama-3-8B's four matrices in each format beside dequantize
+ ``torch.matmul``), where the tree has them the ALiBi
kernels (B11-B13), the paged serving kernels (B2 decode, B5 split-K
decode, B3 extend over bf16, int8 and fp8 pools) and the LoRA delta (B9 at
the chip smoke test's phase-2g cells, ranks 8, 16 and 64, then 128, 256
and 136; its multi-token cells at ranks 8, 64 and 128 beside gather + two
bf16 ``torch.bmm``, ``library_sequence_ms``; one-token rows at ranks 8-64
on the row kernel and on the tensor-core pair, ``pair_ms``, where the tree
has the pair) on seeded inputs, and prints for
each cell a SHA-256 of its output bytes and its mean cold-L2 time. B2, B5
and B3 cells are also held to their plain versions (``within`` PAGED_TOL,
as the chip smoke test holds them; B5 at the tree's own split count), so
trees that round differently still compare, and their bf16 cells carry the
time of one SDPA call over the gathered K/V (``sdpa_ms``); where the tree
folds B5's merge into its last split, B5's cells also time both merges
(``fold_ms``, ``merge_launch_ms``). So are the dense flash cells: the forward
within PAGED_TOL of ``reference_attention`` with P in f32, the backward
within GRAD_TOL of ``reference_attention_bwd`` on the kernel's own out,
both with ``equal_bits_twice``, beside one SDPA call on the same operands
(``sdpa_ms``, ``sdpa_bwd_ms`` for the backward, the backend SDPA ran
named); each forward cell also holds the plain version with P cast to one
bf16 term to the same tolerance (``p_bf16_within``: whether the kernels'
hi + lo split of P could go). The element-mask cells (``sparse_attention``'s layouts through a
``TileMask``) and the ALiBi cells are compared by digest alone, the ALiBi
cells (head dims 128 and 64, with dslope) with ``equal_bits_twice``; the
``alibi`` section also runs the tree's own phase 2i (``check_alibi``: its
times beside their bounds and dslope's per-head margins). Cells
of forms a tree does not build (head dims 80 and 96, the backward at 256,
ranks above 64) run only where it builds them, after the others, so both
trees give the common cells the same inputs. ``--sections`` picks some of
them (``flash alibi grouped quant paged lora sweeps moe_train alibi_train
decode_gemv gemv_plan``; ``decode_gemv`` times B16's decode rows, B7, B6
and B8's decode rows on the tensor-core GEMV of ``ops/csrc/mma_gemv.cuh``
(B6 beside the cuBLAS sequence it replaces and over many draws against
its plain version and the f64 function, B8 beside dequantize +
``torch.matmul``), and, where the tree has the plans, B16 at 32 and 64 rows
and B8 at 8-64 rows on the GEMV beside the wgmma forms, and whether
PyTorch's CUDA mean of x^2 equals B6's statistics order bit for bit;
``b6_b8`` runs only B6's and B8's part of it; ``gemv_plan``
times the GEMV's cells at every split count (one tree: the plan replaced
for the call);
``sweeps`` times the cells ``chip_smoke.py`` checks but does not time;
``moe_train`` runs the chip smoke test's phase 5b, the _config3 MoE
training steps, and ``alibi_train`` its phase 5c, BLOOM-1b7's training
steps, each with the tree's own ``chip_smoke.train``). Two trees whose digests match
computed bit-equal results, so a refactor of the kernel sources (shared
headers, say) is checked against its parent by running this script on
both, parent-change-change-parent in one session:

    git archive <parent> | tar -x -C build/parent
    python3 scripts/torch_kernel_digest.py --tree build/parent --out a.json
    python3 scripts/torch_kernel_digest.py --tree . --out b.json

Each run times its cells once; run parent and change twice each, in turn,
to see how far the times of one tree move between runs.

``--tree`` is the checkout whose ``shuffle_exchange_tpu_torch`` is imported
(and whose ``ops/csrc`` sources are built, into that checkout's ``build/``).
It needs a card; it exits 1 without one.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

FLUSH_BYTES = 256 << 20   # written between timed launches: more than the 50 MB L2

# (label, B, T, S, H, KV, Dh, causal, segment ids): the shapes the chip
# smoke test and the training paths give B14 / B15
FLASH_CELLS = [
    ("B15 train fwd+bwd", 32, 1023, 1023, 16, 4, 128, True, False),
    ("B15 prefill fwd", 8, 1024, 1024, 32, 8, 128, True, False),
    ("B14 MHA fwd+bwd", 2, 1000, 1000, 32, 32, 128, True, False),
    ("B14 gpt2 fwd+bwd", 16, 1023, 1023, 12, 12, 64, True, False),
    ("segments fwd+bwd", 2, 512, 512, 8, 8, 64, True, True),
    ("full T<S fwd", 1, 300, 700, 8, 4, 128, False, False),
    # the head dims 80 and 96 (Pythia-2.8b's and Phi-3-mini's prefill), where built
    ("phi-3-mini prefill fwd", 8, 1024, 1024, 32, 32, 96, True, False),
    ("pythia-2.8b prefill fwd", 8, 1024, 1024, 32, 32, 80, True, False),
    # Falcon-7B's prefill: 71 query heads of 64 over one kv head
    ("falcon-7b prefill fwd", 8, 1024, 1024, 71, 1, 64, True, False),
    # GPT-J-6B's training at head_dim 256 (its backward where built)
    ("gpt-j-6b train fwd+bwd", 8, 2047, 2047, 16, 16, 256, True, False),
    # GPT-J-6B's prefill (P=8, T=1024) and the chip smoke test's GQA cell at 256
    ("gpt-j-6b prefill fwd", 8, 1024, 1024, 16, 16, 256, True, False),
    ("gqa 16/4 x 256 fwd+bwd", 2, 1000, 1000, 16, 4, 256, True, False),
]
# (label, T, H, KV, Dh, layout): B15's element-mask form through a TileMask,
# the chip smoke test's sparse_attention layouts (blocks of 128, causal)
MASK_CELLS = [("mask fixed 8192 fwd+bwd", 8192, 16, 4, 128, "fixed"),
              ("mask bigbird 8192 fwd+bwd", 8192, 16, 4, 128, "bigbird"),
              ("mask fixed 1024 x 256 fwd+bwd", 1024, 16, 4, 256, "fixed")]
# (label, B, T, S, H, KV, Dh): digested with dslope, equal bits twice; the
# third is bloom-560m's heads, so both built head dims are digested
ALIBI_CELLS = [("B11-B13 bloom-1b7", 2, 2047, 2047, 16, 16, 128),
               ("B11-B13 gqa T<S", 2, 512, 1024, 16, 8, 128),
               ("B11-B13 bloom-560m Dh 64", 2, 2047, 2047, 16, 16, 64)]
GROUPED_SIZES = {"16 rows": [3, 0, 5, 1, 0, 4, 2, 1],
                 "4096 rows": [700, 0, 1300, 96, 512, 4, 1000, 484]}
# B16 at the main paths' shapes, 8 experts, each cell timed beside its bound
# and torch._grouped_mm (the chip smoke test's yardsticks): the forward over
# Mixtral-8x7B's w_gate / w_down in each format at a decode tick's 2 and 16
# rows, a chunk tick's 512 and a put()'s 16,384 ragged rows; dx and dw at
# bench.py's _config3 [1024, 2816] and its transpose on the capacity route's
# 8 x 10,230 rows and the ragged route's 65,472 (ragged and one_expert), and
# at Mixtral's w_gate with 16,384 ragged rows. The forward of 512 rows or
# more in every format, dx and dw are held to their plain versions
# (PAGED_TOL per row) with equal bits twice.
GROUPED_FWD = [((4096, 14336), rows) for rows in (2, 16, 512, 16384)] + \
              [((14336, 4096), rows) for rows in (2, 16, 512, 16384)]
GROUPED_BWD = [("config3 capacity", (1024, 2816), 8 * 10230, "balanced"),
               ("config3 capacity", (2816, 1024), 8 * 10230, "balanced"),
               ("config3 ragged", (1024, 2816), 65472, "ragged"),
               ("config3 ragged", (2816, 1024), 65472, "ragged"),
               ("config3 ragged", (1024, 2816), 65472, "one_expert"),
               ("config3 ragged", (2816, 1024), 65472, "one_expert"),
               ("mixtral", (4096, 14336), 16384, "ragged")]
# (label, H, KV, Dh, ALiBi slopes): the heads of the chip smoke test's B2 / B3
# / B5 cells (Llama-3-8B's, BLOOM-1b7's with slopes, GPT-J-6B's at head_dim
# 256) and a GQA group at head_dim 64; each at 8 sequences of up to 2,048
# positions (B3: two 256-row chunks starting at each pair of EXTEND_STARTS:
# ending at 2,048 and 1,800, and the chip smoke test's phase-2 cell)
PAGED_CELLS = [("llama 32/8x128", 32, 8, 128, False), ("bloom 16x128 alibi", 16, 16, 128, True),
               ("gpt-j 16x256", 16, 16, 256, False), ("gqa 16/2x64", 16, 2, 64, False),
               # where built: Phi-3-mini's and Pythia-2.8b's heads (with slopes)
               ("phi-3-mini 32x96", 32, 32, 96, False),
               ("pythia-2.8b 32x80 alibi", 32, 32, 80, True),
               # Falcon-7B's group: 71 query heads over one kv head
               ("falcon-7b 71/1x64", 71, 1, 64, False)]
EXTEND_STARTS = ((1792, 1600), (512, 700))
# B9 at the chip smoke test's phase-2g cells (D 4096; N 4096 / 1024; ranks
# 8, 16, 64; pools of 5 and 65 slots; rows 1 x 1, 8 x 1, 2 x 256, 8 x 1024),
# then, where built, ranks past 64 on the 5-slot pool
LORA_D, LORA_N, LORA_R, LORA_S = 4096, (4096, 1024), (8, 16, 64), (5, 65)
LORA_ROWS = [(1, 1), (8, 1), (2, 256), (8, 1024)]
LORA_WIDE_R = (128, 256, 136)
LORA_SEQ_R = (8, 64, 128)   # ranks whose multi-token cells time gather + two torch.bmm too
LORA_ROUTE_R = (8, 16, 32, 64)   # one-token rows timed on the row kernel and on the pair
# "sweeps": the cells `chip_smoke.py` checks but does not time (to stay
# within its time limit): phase 2c's flash shapes past its two
# timed ones, 2e's quantized matmul on Llama-3-8B's other three matrix
# shapes, 2f's grouped GEMM at Mixtral-8x7B's expert shapes in every format
# and group pattern but its ragged bf16 / int8 cells, and 2m's B7 forms
# past BLOOM-1b7's (the chip smoke test's `mlp_quant_cells`)
SWEEP_FLASH = [(2, 1000, 1000, 32, 8, 128, True, False), (2, 200, 200, 32, 32, 128, True, False),
               (2, 1000, 1000, 32, 32, 128, True, False), (2, 200, 200, 16, 2, 64, True, False),
               (2, 1000, 1000, 16, 2, 64, True, False), (2, 200, 1000, 32, 8, 128, False, False),
               (2, 1000, 1000, 32, 8, 128, True, True), (3, 1, 1, 8, 2, 128, True, False),
               (3, 37, 37, 8, 2, 64, True, True)]
SWEEP_QUANT_SHAPES = [(4096, 4096), (4096, 1024), (14336, 4096)]
SWEEP_QUANT_ROWS = [8, 1, 256, 8192]
SWEEP_GG_SHAPES = [(4096, 14336), (14336, 4096)]
SWEEP_GG_ROWS = [2, 16, 512, 16384]
SWEEP_GG_PATTERNS = ("balanced", "one_expert", "empty_ends", "ragged")
QUANT_PREFILL_ROWS = 8192   # B8's prefill cells: a put() of 8 prompts padded to 1024
QUANT_CHUNK_ROWS = 256      # and its chunk cells: a tick's 256-token budget
QUANT_FEW_ROWS = 64         # and a tick of few rows past the GEMV's (B8's short tile)
SECTIONS = ("flash", "alibi", "grouped", "quant", "paged", "lora", "sweeps", "moe_train",
            "alibi_train", "decode_gemv", "b6_b8", "gemv_plan")


def gemv_rows(gg) -> int:
    """The most rows a tree's grouped GEMV sends to its GEMV form (its
    GEMV_MAX_N: one count, or one a weight format)."""
    limit = gg.GEMV_MAX_N
    return max(limit.values()) if isinstance(limit, dict) else limit


def time_cold(fn, iters: int = 10) -> float:
    """Mean device ms of ``fn`` with the L2 flushed before each call."""
    import torch

    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    for _ in range(2):
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


def digest(tensors) -> str:
    import torch

    h = hashlib.sha256()
    for t in tensors:
        if t is not None:
            h.update(t.contiguous().view(-1).view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


def sdpa_call(q, k, v, table, visible, slopes):
    """One SDPA call over the gathered bf16 K/V with the rows' visible
    lengths [B, C] (and ALiBi as an additive mask)."""
    import torch
    import torch.nn.functional as F

    from shuffle_exchange_tpu_torch.ops.paged_attention import gather_kv

    kg, vg = gather_kv(k, v, table)
    S = kg.shape[1]
    pos = torch.arange(S, device=q.device)
    allowed = pos[None, None, :] < visible[:, :, None]                # [B, C, S]
    if slopes is None:
        mask = allowed[:, None]
    else:
        bias = slopes.float()[:, None, None] * pos.float()            # [H, 1, S]
        mask = torch.where(allowed[:, None], bias[None], float("-inf")).bfloat16()
    qs, ks, vs = (x.transpose(1, 2).contiguous() for x in (q, kg, vg))
    return lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask, enable_gqa=True)


def b5_splits(fd, pa, B, H, KV, Dh, W, bs) -> int:
    """The split count the tree's B5 wrapper picks on this card (the
    redesigned rule takes the block size; the first design counted the
    group's head chunks)."""
    import inspect

    import torch

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    if "bs" in inspect.signature(fd.attention_splits).parameters:
        return fd.attention_splits(B, KV, W, bs, sms)
    return fd.attention_splits(B, KV, W, sms, pa.decode_head_chunk(H // KV, Dh)[1])


def paged_cells(gen, seed) -> dict:
    """B2, B5 and B3 at PAGED_CELLS over bf16, int8 and fp8 pools."""
    import numpy as np
    import torch

    from chip_smoke import paged_close   # the tree's PAGED_TOL
    from shuffle_exchange_tpu_torch.inference.paged import quantize_kv
    from shuffle_exchange_tpu_torch.models import alibi_slopes
    from shuffle_exchange_tpu_torch.ops.fused_decode import (fused_paged_decode_attention,
                                                             fused_paged_decode_reference)
    from shuffle_exchange_tpu_torch.ops.paged_attention import (paged_decode_attention,
                                                                paged_decode_reference,
                                                                paged_extend_attention,
                                                                paged_extend_reference)

    rng = np.random.default_rng(seed)
    bs, cells = 64, {}

    def pool(lens, KV, Dh):
        nb = [-(-int(n) // bs) for n in lens]
        ids = rng.permutation(np.arange(1, 1 + sum(nb))).tolist()
        table = np.full((len(lens), 1 << max(0, (max(nb) - 1).bit_length())), -1, np.int32)
        for b, n in enumerate(nb):
            table[b, :n] = [ids.pop() for _ in range(n)]
        k, v = (torch.randn(1 + sum(nb), KV, bs, Dh, generator=gen, device="cuda").bfloat16()
                for _ in range(2))
        return k, v, torch.from_numpy(table).cuda()

    pa = importlib.import_module("shuffle_exchange_tpu_torch.ops.paged_attention")
    fd = importlib.import_module("shuffle_exchange_tpu_torch.ops.fused_decode")

    for label, H, KV, Dh, alibi in PAGED_CELLS:
        if Dh not in pa.HEAD_DIMS:
            continue
        slopes = torch.from_numpy(alibi_slopes(H)).cuda() if alibi else None
        lens = np.concatenate([[2048], rng.integers(1, 2049, size=7)]).astype(np.int32)
        k, v, table = pool(lens, KV, Dh)
        q = torch.randn(8, 1, H, Dh, generator=gen, device="cuda").bfloat16()
        kvl = torch.from_numpy(lens).cuda()
        splits = b5_splits(fd, pa, 8, H, KV, Dh, table.shape[1], bs)
        nnew = torch.tensor([256, 200], dtype=torch.int32, device="cuda")
        ext = []
        for st in EXTEND_STARTS:
            start = torch.tensor(st, dtype=torch.int32, device="cuda")
            ek, ev, etable = pool((start + nnew).tolist(), KV, Dh)
            eq = torch.randn(2, 256, H, Dh, generator=gen, device="cuda").bfloat16()
            ext.append((st, start, ek, ev, etable, eq))
        for fmt in ("bf16", "int8", "fp8"):
            store = torch.int8 if fmt == "int8" else torch.float8_e4m3fn

            def stored(x, y):
                """(x, y, scale keywords) as the pool holds them in ``fmt``."""
                if fmt == "bf16":
                    return x, y, {}
                (xq, xs), (yq, ys) = quantize_kv(x, store), quantize_kv(y, store)
                return xq, yq, dict(k_scale=xs, v_scale=ys)

            kk, vv, sc = stored(k, v)
            # (name, kernel, plain version with P in f32, rows compared, SDPA)
            runs = [(f"B2 {label} {fmt}", lambda: paged_decode_attention(
                        q, kk, vv, table, kvl, alibi_slopes=slopes, **sc),
                     lambda: paged_decode_reference(q, kk, vv, table, kvl, p_f32=True,
                                                    alibi_slopes=slopes, **sc),
                     lambda x: x, (q, k, v, table, kvl[:, None])),
                    (f"B5 {label} {fmt}", lambda: fused_paged_decode_attention(
                        q, kk, vv, table, kvl, alibi_slopes=slopes, **sc),
                     lambda: fused_paged_decode_reference(q, kk, vv, table, kvl, splits,
                                                          alibi_slopes=slopes, **sc),
                     lambda x: x, (q, k, v, table, kvl[:, None]))]
            for st, start, ek, ev, etable, eq in ext:
                ekk, evv, esc = stored(ek, ev)
                at = "" if st == EXTEND_STARTS[0] else f" at {st}"
                vis = torch.minimum(start[:, None] + torch.arange(256, device="cuda")[None] + 1,
                                    (start + nnew)[:, None])
                runs.append((f"B3 {label} {fmt}{at}",
                             lambda start=start, ekk=ekk, evv=evv, etable=etable, eq=eq, esc=esc:
                             paged_extend_attention(eq, ekk, evv, etable, start, nnew,
                                                    alibi_slopes=slopes, **esc),
                             lambda start=start, ekk=ekk, evv=evv, etable=etable, eq=eq, esc=esc:
                             paged_extend_reference(eq, ekk, evv, etable, start, nnew,
                                                    p_f32=True, alibi_slopes=slopes, **esc),
                             # rows past nnew are padding the engine never reads
                             lambda x: torch.cat([x[b, :n] for b, n in enumerate(nnew.tolist())]),
                             (eq, ek, ev, etable, vis)))
            for name, fn, plain, rows, lib in runs:
                out = fn()
                cells[name] = dict(digest=digest([out]), ms=time_cold(fn))
                err, ok = paged_close(rows(out), rows(plain()))
                cells[name].update(max_abs_err=err.max().item(), within=ok)
                if fmt == "bf16":
                    cells[name]["sdpa_ms"] = time_cold(sdpa_call(*lib, slopes))
                if name.startswith("B5"):
                    cells[name]["splits"] = splits
                    if hasattr(fd, "folds"):   # both merges, whichever the wrapper takes
                        sms = torch.cuda.get_device_properties(0).multi_processor_count
                        cells[name].update(folds=fd.folds(8, KV, H // KV, Dh, splits, sms), **{
                            f"{key}_ms": time_cold(lambda f=f: fd._launch_attention(
                                q, kk, vv, table, kvl, None, slopes, fold=f, **sc))
                            for key, f in (("fold", True), ("merge_launch", False))})
    return cells


def lora_cells(gen) -> dict:
    """B9 at the phase-2g cells, then at LORA_WIDE_R where the tree takes
    ranks past 64; the slots as phase 2g gives them."""
    import torch

    lg = importlib.import_module("shuffle_exchange_tpu_torch.ops.lora_gemm")

    def slots_of(B, S):
        return [1] if B == 1 else [1, S - 1] if B == 2 else [0, 1, S - 1, 1, 0, 2, S - 1, 3]

    cells = {}
    grid = [(S, R) for S in LORA_S for R in LORA_R]
    grid += [(LORA_S[0], R) for R in LORA_WIDE_R
             if hasattr(lg, "CHUNK_RANK") or hasattr(lg, "ROW_RANK")]
    for S, R in grid:
        for N in LORA_N:
            a = (torch.randn(S, LORA_D, R, generator=gen, device="cuda") * LORA_D ** -0.5).bfloat16()
            b = (torch.randn(S, R, N, generator=gen, device="cuda") * R ** -0.5).bfloat16()
            a[0].zero_()
            b[0].zero_()
            for B, T in LORA_ROWS:
                slots = torch.tensor(slots_of(B, S), dtype=torch.int32, device="cuda")
                x = torch.randn(B, T, LORA_D, generator=gen, device="cuda").bfloat16()
                fn = lambda: lg.lora_delta(x, a, b, slots)
                cell = dict(digest=digest([fn()]), ms=time_cold(fn, 5 if B * T > 1024 else 10))
                if T > 1 and R in LORA_SEQ_R and S == LORA_S[0] and N == LORA_N[0]:
                    idx = slots.long()
                    cell["library_sequence_ms"] = time_cold(
                        lambda: torch.bmm(torch.bmm(x, a[idx]), b[idx]), 5)
                cells[f"B9 S{S} R{R} N{N} {B}x{T}"] = cell
    if hasattr(lg, "ROW_RANK"):   # a tree whose row kernel has a rank cutoff
        cells.update(lora_route_cells(lg, gen, slots_of))
    return cells


def lora_route_cells(lg, gen, slots_of) -> dict:
    """One-token rows at LORA_ROUTE_R on the row kernel (``ms``) and on
    the tensor-core pair (``pair_ms``: the wrapper with ROW_RANK at 0),
    the cells that place the row kernel's rank cutoff."""
    import torch

    cells = {}
    S = LORA_S[0]
    for R in LORA_ROUTE_R:
        for N in LORA_N:
            a = (torch.randn(S, LORA_D, R, generator=gen, device="cuda") * LORA_D ** -0.5).bfloat16()
            b = (torch.randn(S, R, N, generator=gen, device="cuda") * R ** -0.5).bfloat16()
            for B in (1, 8):
                slots = torch.tensor(slots_of(B, S), dtype=torch.int32, device="cuda")
                x = torch.randn(B, 1, LORA_D, generator=gen, device="cuda").bfloat16()
                fn = lambda: lg.lora_delta(x, a, b, slots)
                cell = dict(row_kernel=R <= lg.ROW_RANK, digest=digest([fn()]), ms=time_cold(fn))
                saved, lg.ROW_RANK = lg.ROW_RANK, 0
                try:
                    cell.update(pair_digest=digest([fn()]), pair_ms=time_cold(fn))
                finally:
                    lg.ROW_RANK = saved
                cells[f"B9 route S{S} R{R} N{N} {B}x1"] = cell
    return cells


def grouped_cells(gen, seed) -> dict:
    """The GROUPED_FWD and GROUPED_BWD cells: a digest and the mean cold-L2
    time of each beside its bound and torch._grouped_mm's time; the forward
    past 16 rows in every format, dx and dw also ``within`` their plain
    versions and ``equal_bits_twice``."""
    import numpy as np
    import torch

    from chip_smoke import (_f32_reduction, _library_bwd, _library_grouped, bound,
                            group_pattern, paged_close)

    gg, qmm = (importlib.import_module(f"shuffle_exchange_tpu_torch.ops.{m}") for m in
               ("grouped_gemm", "quant_matmul"))
    rng = np.random.default_rng(seed)

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda") * scale).bfloat16()

    def cell(fn, plain, lib, nbytes, flops, iters):
        out = fn()
        row = dict(digest=digest([out]), ms=time_cold(fn, iters), library_ms=time_cold(lib, 3))
        row["bound_ms"], row["bound_by"] = bound(nbytes, flops)
        row["tflops"] = flops / (row["ms"] * 1e-3) / 1e12
        if plain is not None:
            err, ok = paged_close(out, plain())
            row.update(max_abs_err=err.max().item(), within=ok,
                       equal_bits_twice=digest([fn()]) == row["digest"])
        return row

    cells = {}
    with _f32_reduction():
        for (K, F), N in GROUPED_FWD:
            w16 = randn(8, K, F, scale=K ** -0.5)
            x = randn(N, K)
            sizes_np = group_pattern("ragged", N, 8, rng)
            sizes = torch.from_numpy(sizes_np).cuda()
            used = int((sizes_np > 0).sum())
            lib16 = _library_grouped(x, w16, sizes)[0]
            for fmt in ("bf16", 8, "fp8"):
                w = w16 if fmt == "bf16" else qmm.quantize_weight(w16, 256, bits=fmt)
                expert_bytes = K * F * 2 if fmt == "bf16" else w.nbytes / 8
                lib = lib16 if fmt == "bf16" else (lambda w=w: (w.dequantize(), lib16()))
                plain = ((lambda w=w: gg.grouped_matmul_reference(x, w, sizes))
                         if N > gemv_rows(gg) else None)
                cells[f"B16 {'int8' if fmt == 8 else fmt} {N}x[{K}, {F}] ragged"] = cell(
                    lambda w=w: gg.grouped_matmul(x, w, sizes), plain, lib,
                    N * K * 2 + used * expert_bytes + N * F * 2, 2.0 * N * K * F,
                    5 if N > 1024 else 10)
                del w
            del w16, x
            torch.cuda.empty_cache()
        for label, (K, F), N, pattern in GROUPED_BWD:
            sizes_np = group_pattern(pattern, N, 8, rng)
            sizes = torch.from_numpy(sizes_np).cuda()
            used = int((sizes_np > 0).sum())
            x, dout, w = randn(N, K), randn(N, F), randn(8, K, F, scale=K ** -0.5)
            flops = 2.0 * N * K * F
            cells[f"B16-dx {label} {N}x[{K}, {F}] {pattern}"] = cell(
                lambda: gg.grouped_matmul_dx(dout, w, sizes),
                lambda: gg.grouped_matmul_dx_reference(dout, w, sizes),
                _library_bwd("dx", dout, w, sizes)[0],
                N * F * 2 + used * K * F * 2 + N * K * 2, flops, 5)
            cells[f"B16-dw {label} {N}x[{K}, {F}] {pattern}"] = cell(
                lambda: gg.grouped_matmul_dw(x, dout, sizes),
                lambda: gg.grouped_matmul_dw_reference(x, dout, sizes),
                _library_bwd("dw", x, dout, sizes)[0],
                N * (K + F) * 2 + 8 * K * F * 2, flops, 5)
            del x, dout, w
            torch.cuda.empty_cache()
    return cells


def quant_prefill_cells(qmm, gen) -> dict:
    """B8 at a put()'s 8,192 rows, a tick's 256 chunk rows and 64 rows (the
    short tile) on Llama-3-8B's four matrices (the chip smoke test's QUANT_SHAPES) in each
    format at group 256, beside its bound, the library yardstick
    (dequantize() + torch.matmul: one dequantize of the stored weight, then
    cuBLAS) and cuBLAS on the dense bf16 weight."""
    import torch

    from chip_smoke import QUANT_FORMATS, QUANT_SHAPES, _f32_reduction, bound

    cells = {}
    with _f32_reduction():
        for K, N in QUANT_SHAPES:
            w = (torch.randn(K, N, generator=gen, device="cuda") * K ** -0.5).bfloat16()
            xs = {QUANT_PREFILL_ROWS: torch.randn(QUANT_PREFILL_ROWS, K, generator=gen,
                                                  device="cuda").bfloat16()}
            xs[QUANT_CHUNK_ROWS] = torch.randn(QUANT_CHUNK_ROWS, K, generator=gen,
                                               device="cuda").bfloat16()
            xs[QUANT_FEW_ROWS] = torch.randn(QUANT_FEW_ROWS, K, generator=gen,
                                             device="cuda").bfloat16()
            for rows, x in xs.items():
                dense_ms = time_cold(lambda: x @ w)
                for bits in QUANT_FORMATS:
                    qm = qmm.quantize_weight(w, 256, bits=bits)
                    fn = lambda: qmm.quant_matmul(x, qm)
                    row = dict(digest=digest([fn()]), ms=time_cold(fn),
                               library_ms=time_cold(lambda: x @ qm.dequantize()),
                               library="dequantize() + torch.matmul", dense_cublas_ms=dense_ms)
                    row["bound_ms"], row["bound_by"] = bound(
                        rows * K * 2 + qm.nbytes + rows * N * 2, 2.0 * rows * K * N)
                    row["library_over_kernel"] = row["library_ms"] / row["ms"]
                    what = {QUANT_PREFILL_ROWS: "prefill", QUANT_CHUNK_ROWS: "chunk"}.get(
                        rows, "few rows")
                    cells[f"B8 {bits} {rows}x[{K}, {N}] {what}"] = row
                    del qm
            del w, xs
            torch.cuda.empty_cache()
    return cells


def moe_train_cells(seed) -> dict:
    """The chip smoke test's phase 5b on this tree (its ``train`` at its
    MOE_TRAIN_CONFIG and MOE_TRAIN_STEPS): bench.py's _config3 model under
    "capacity" and "ragged", step p50, tokens/s, MFU and the profiled
    step's device ms by kernel kind, with the grouped GEMMs' (B16, dx, dw)
    share of the step's busy device time."""
    import gc

    import torch

    from chip_smoke import MOE_TRAIN_CONFIG, MOE_TRAIN_STEPS, card_line, config3, train

    cells = {}
    for impl in ("capacity", "ragged"):
        r = train(f"config3-{impl}", config3(impl), seed, card_line(), config=MOE_TRAIN_CONFIG,
                  steps=MOE_TRAIN_STEPS)
        trace = r.get("trace") or {}
        kinds = trace.get("by_kind_ms", {})
        b16 = sum(v for k, v in kinds.items() if k.startswith("grouped_matmul"))
        busy = trace.get("device_busy_ms")
        cells[f"config3-{impl} train step"] = dict(
            step_p50_ms=r["step_p50_ms"], step_ms=r["step_ms"], tokens_per_s=r["tokens_per_s"],
            mfu_6n=r["mfu_6n"], peak_mem_GiB=r["peak_mem_GiB"], losses=r["losses"],
            device_busy_ms=busy, idle_share=trace.get("idle_share"), grouped_ms=b16,
            grouped_share=b16 / busy if busy else None, by_kind_ms=kinds,
            kernels_by_kind=trace.get("kernels_by_kind"))
        del r
        gc.collect()
        torch.cuda.empty_cache()
    return cells


def alibi_phase_cells(seed) -> dict:
    """The chip smoke test's phase 2i on this tree (its ``check_alibi``:
    B11-B13 against their plain versions at ``ALIBI_CELLS``, on the phase's
    own generator, each cell timed at its timed batch on the training
    route): per cell the forward, dq, dk/dv and whole-backward times
    beside their bounds, the errors, and dslope's per-head error over the
    root-sum-square of its terms (its tolerance is 1e-4)."""
    import torch

    from chip_smoke import check_alibi

    cells = {}
    gen = torch.Generator(device="cuda").manual_seed(seed)
    for f, q, k in zip(*check_alibi(gen)):
        shape = f["shape"]
        cells[f"2i {shape['label']} (B={shape['B_timed']})"] = dict(
            fwd_ms=f["ms"], fwd_bound_ms=f["bound_ms"], dq_ms=q["ms"], dq_bound_ms=q["bound_ms"],
            dkv_ms=k["ms"], dkv_bound_ms=k["bound_ms"], bwd_ms=f["bwd_ms"],
            bwd_bound_ms=f["bwd_bound_ms"], library_fwd_ms=f["library_ms"],
            library_bwd_ms=q["library_ms"], errs=f["errs"], out_max_abs_err=f["max_abs_err"],
            lse_max_abs_err=f["lse_max_abs_err"], equal_bits_twice=f.get("equal_bits_twice"),
            dslope_err_over_rss=k["dslope_err_over_rss"],
            dslope_bites=k["tolerance_bites"], bites=f.get("tolerance_bites"))
    return cells


def alibi_train_cells(seed) -> dict:
    """The chip smoke test's phase 5c on this tree (its ``train`` of
    BLOOM-1b7 at full width and depth, batch 16 x 2048, full remat): step
    p50, tokens/s, MFU and the profiled step's device ms by kernel kind,
    with the ALiBi kernels' share of the step's busy device time."""
    import gc

    import torch

    from chip_smoke import (BLOOM_1B7, BLOOM_BATCH, BLOOM_SEQ, MOE_TRAIN_STEPS, card_line,
                            train)
    from shuffle_exchange_tpu_torch.models import config_from_hf

    r = train("bloom-1b7", config_from_hf(BLOOM_1B7), seed, card_line(), batch=BLOOM_BATCH,
              seq=BLOOM_SEQ, steps=MOE_TRAIN_STEPS)
    trace = r.get("trace") or {}
    kinds = trace.get("by_kind_ms", {})
    alibi = sum(v for k, v in kinds.items() if k.startswith("alibi"))
    busy = trace.get("device_busy_ms")
    cell = dict(step_p50_ms=r["step_p50_ms"], step_ms=r["step_ms"], tokens_per_s=r["tokens_per_s"],
                mfu_6n=r["mfu_6n"], peak_mem_GiB=r["peak_mem_GiB"], losses=r["losses"],
                device_busy_ms=busy, idle_share=trace.get("idle_share"), alibi_ms=alibi,
                alibi_share=alibi / busy if busy else None, by_kind_ms=kinds,
                kernels_by_kind=trace.get("kernels_by_kind"))
    del r
    gc.collect()
    torch.cuda.empty_cache()
    return {"bloom-1b7 train step": cell}


# "decode_gemv": the tensor-core GEMV of B16's decode rows and of B7 (its
# plan is ops/decode_gemv.py): B16 at a decode tick's 2 and 16 rows over
# Mixtral-8x7B's two expert shapes in every format and group pattern, B7 at
# the chip smoke test's mlp_quant_cells at 1, 8 and 16 rows; where the tree
# has the GEMV's plan, B16 at 32 and 64 rows on the GEMV (GEMV_MAX_N raised
# for the call, ``gemv_ms``) and on the wgmma forms (``wgmma_ms``)
DG_B16_ROWS = (2, 16)
DG_B7_ROWS = (1, 8, 16)
DG_WIDE_ROWS = (32, 64)


def b16_draws(seed, has_plan=True) -> dict:
    """The group sizes decode_gemv_cells draws for each (K, F, fmt, N,
    pattern) cell, replayed from its generator (the split sweep times the
    same cells)."""
    import numpy as np

    from chip_smoke import GG_PATTERNS, group_pattern

    rng = np.random.default_rng(seed)
    out = {}
    for K, F_ in ((4096, 14336), (14336, 4096)):
        for fmt in ("bf16", 8, "fp8"):
            for N in DG_B16_ROWS + (DG_WIDE_ROWS if has_plan else ()):
                for pattern in (GG_PATTERNS if N in DG_B16_ROWS else ("ragged",)):
                    out[(K, F_, fmt, N, pattern)] = group_pattern(pattern, N, 8, rng)
    return out


def decode_gemv_cells(gen, seed) -> dict:
    """The ``decode_gemv`` cells: a digest and the mean cold-L2 time of
    each, held to its plain version (B16: PAGED_TOL per row; B7:
    QUANT_MLP_TOL) with equal bits twice; the ragged B16 cells and the
    B7 cells beside their bounds and library yardsticks (torch._grouped_mm,
    dequantize + torch._grouped_mm, dequantize + the cuBLAS sequence)."""
    import torch
    import torch.nn.functional as F

    from chip_smoke import (GG_PATTERNS, MQ_WIDTHS, _f32_reduction, _library_grouped, bound,
                            mlp_quant_cells, paged_close, quant_mlp_close)

    gg, qmm, fd = (importlib.import_module(f"shuffle_exchange_tpu_torch.ops.{m}") for m in
                   ("grouped_gemm", "quant_matmul", "fused_decode"))
    has_plan = importlib.util.find_spec("shuffle_exchange_tpu_torch.ops.decode_gemv") is not None
    draws = b16_draws(seed, has_plan)

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda") * scale).bfloat16()

    def held(fn, plain, close):
        out = fn()
        err, ok = close(out, plain())
        return out, dict(digest=digest([out]), max_abs_err=err.max().item(), within=ok,
                         equal_bits_twice=digest([fn()]) == digest([out]))

    cells = {}
    with _f32_reduction():
        for K, F_ in ((4096, 14336), (14336, 4096)):
            w16 = randn(8, K, F_, scale=K ** -0.5)
            for fmt in ("bf16", 8, "fp8"):
                w = w16 if fmt == "bf16" else qmm.quantize_weight(w16, 256, bits=fmt)
                expert_bytes = K * F_ * 2 if fmt == "bf16" else w.nbytes / 8
                name = "int8" if fmt == 8 else fmt
                rows = DG_B16_ROWS + (DG_WIDE_ROWS if has_plan else ())
                for N in rows:
                    x = randn(N, K)
                    for pattern in (GG_PATTERNS if N in DG_B16_ROWS else ("ragged",)):
                        sizes_np = draws[(K, F_, fmt, N, pattern)]
                        sizes = torch.from_numpy(sizes_np).cuda()
                        fn = lambda: gg.grouped_matmul(x, w, sizes)
                        plain = lambda: gg.grouped_matmul_reference(x, w, sizes)
                        _, row = held(fn, plain, paged_close)
                        row["ms"] = time_cold(fn, 10)
                        if pattern == "ragged":
                            used = int((sizes_np > 0).sum())
                            nbytes = N * K * 2 + used * expert_bytes + N * F_ * 2
                            row["bound_ms"], row["bound_by"] = bound(nbytes, 2.0 * N * K * F_)
                            lib = _library_grouped(x, w16, sizes)[0]
                            row["library_ms"] = time_cold(
                                lib if fmt == "bf16" else (lambda: (w.dequantize(), lib())), 5)
                        if N in DG_WIDE_ROWS:   # the GEMV and the wgmma form at these rows
                            wide = gg.GEMV_MAX_N
                            gg.GEMV_MAX_N = dict.fromkeys(wide, max(DG_WIDE_ROWS))
                            try:
                                _, g = held(fn, plain, paged_close)
                                row.update(gemv_ms=time_cold(fn, 10), gemv_within=g["within"],
                                           gemv_digest=g["digest"])
                            finally:
                                gg.GEMV_MAX_N = wide
                            gg.GEMV_MAX_N = dict.fromkeys(wide, 0)
                            try:
                                row["wgmma_ms"] = time_cold(fn, 10)
                            finally:
                                gg.GEMV_MAX_N = wide
                        cells[f"B16 {name} {N}x[{K}, {F_}] {pattern}"] = row
                del w
            del w16
            torch.cuda.empty_cache()
        made = {}
        for norm, gated, act, bits, width, _ in mlp_quant_cells():
            D, Fd = MQ_WIDTHS[width]
            if (width, bits) not in made:
                made.clear()
                torch.cuda.empty_cache()
                made[(width, bits)] = [qmm.quantize_weight(randn(*shape, scale=shape[0] ** -0.5),
                                                           256, bits=bits)
                                       for shape in ((D, Fd), (D, Fd), (Fd, D))]
            qg, qu, qd = made[(width, bits)]
            qg = qg if gated else None
            ln_w, ln_b = (1 + randn(D, scale=0.1)), randn(D, scale=0.1)
            kw = dict(ln_b=ln_b, norm=norm, activation=act)
            fn_act = {"silu": F.silu, "relu": F.relu}.get(
                act, lambda v: F.gelu(v, approximate="tanh"))
            for B in DG_B7_ROWS:
                key = f"B7 {norm} {'gated' if gated else 'plain'} {act} {bits} {width} {B}"
                if key in cells:
                    continue
                h = (randn(B, D) + randn(B, 1, scale=0.5)).bfloat16()
                fn = lambda: fd.fused_mlp(h, h, ln_w, qu, qd, qg, eps=1e-5, **kw)
                plain = lambda: fd.fused_mlp_quant_reference(h, h, ln_w, qu, qd, qg, 1e-5, **kw)
                _, row = held(fn, plain, quant_mlp_close)
                row["ms"] = time_cold(fn, 10)
                mats = [m for m in (qg, qu, qd) if m is not None]
                nbytes = sum(m.nbytes for m in mats) + 3 * B * D * 2 + 2 * D * 2
                row["bound_ms"], row["bound_by"] = bound(nbytes, 2.0 * B * D * Fd * len(mats))

                def library():
                    yn = (F.layer_norm(h, (D,), ln_w, ln_b, 1e-5) if norm == "layernorm" else
                          F.rms_norm(h, (D,), ln_w, 1e-5))
                    u = yn @ qu.dequantize()
                    a = fn_act(yn @ qg.dequantize()) * u if gated else fn_act(u)
                    return h + a @ qd.dequantize()

                row["library_ms"] = time_cold(library, 5)
                cells[key] = row
        made.clear()
    torch.cuda.empty_cache()
    return cells


# B6 (the bf16 fused MLP) and B8's decode rows, on the tensor-core GEMV
# where the tree has moved them there: B6 as the engines call it (resid and
# y_src the same rows) at Llama-3-8B's widths (gated, RMSNorm, 1 / 8 / 16
# rows), GPT-J-6B's without its norm (plain gelu_new, fc biases, 8 rows) and
# Phi-3-mini's (gated, RMSNorm, 8 rows), each beside the cuBLAS sequence it
# replaces; B8 at 8 rows over Llama-3-8B's four attention matrices (wq, wk,
# wv, wo: "a layer") and w_gate in each format at group 256, beside
# dequantize + torch.matmul; and, where the tree has B8's GEMV plan, B8 at
# 9-64 rows on the GEMV (GEMV_ROWS raised for the call, ``gemv_ms``) and on
# the wgmma short tile (``wgmma_ms``) over w_gate, wq, wk and w_down
B6_CELLS = [("llama-3-8b", 4096, 14336, True, "rmsnorm", "swiglu", False, (1, 8, 16)),
            ("gpt-j-6b no norm", 4096, 16384, False, None, "gelu_new", True, (8,)),
            ("phi-3-mini", 3072, 8192, True, "rmsnorm", "swiglu", False, (8,))]
B6_DRAWS = 40
B8_ATTN = {"wq": (4096, 4096), "wk": (4096, 1024), "wv": (4096, 1024), "wo": (4096, 4096),
           "w_gate": (4096, 14336)}
B8_BOUNDARY_ROWS = (8, 9, 16, 32, 64)
B8_BOUNDARY_SHAPES = {"w_gate": (4096, 14336), "wq": (4096, 4096), "wk": (4096, 1024),
                      "w_down": (14336, 4096)}


def b6_f64(h, ln_w, wg, wu, wd, eps=1e-5):
    """B6's gated RMSNorm form in f64 with its bf16 rounding points (yn and
    a rounded to bf16, one cast at the end): the function both the kernel
    and the f32 plain version approximate."""
    import torch
    import torch.nn.functional as F

    x = h.double()
    yn = (x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * ln_w.double()).bfloat16()
    yn = yn.double()
    a = (F.silu(yn @ wg.double()) * (yn @ wu.double())).bfloat16().double()
    return (x + a @ wd.double()).bfloat16()


# (rows, D) of the statistics-order cells: the widths B6 serves
B6_ORDER_SHAPES = [(r, D) for D in (4096, 3072, 2560, 2048, 768) for r in (1, 2, 4, 8, 16, 20)]


def rows_tree(rows: int, D: int) -> int:
    """fused_decode.cu's rows_tree: PyTorch's threads a row in its CUDA
    reduction of [rows, D] f32 over D."""
    h = w = 1
    while 2 * h <= rows and h < 16:
        h *= 2
    while 2 * w <= D // 4:
        w *= 2
    return max(min(w, 512 // h), 32)


def sumsq_mean_kernel_order(x):
    """mean(x^2) over each row of x [rows, D] (bf16 values, numpy f32) in
    the order of fused_decode.cu's rms_stats_torch_order: thread t of tree
    adds 4-element loads t, t + tree, ... into 4 accumulators, then the 4
    in order; threads t and t + h add for h = tree / 2 ... 32; shuffles down
    by 16 ... 1 (lane l + o past 31 adds itself); times fl(1 / D)."""
    import numpy as np

    rows, D = x.shape
    tree = rows_tree(rows, D)
    n4 = D // 4
    loads = -(-n4 // tree) * tree
    sq = np.zeros((rows, loads * 4), np.float32)
    sq[:, :D] = x * x
    sq = sq.reshape(rows, loads // tree, tree, 4)
    acc = np.zeros((rows, tree, 4), np.float32)
    for i in range(sq.shape[1]):
        acc = acc + sq[:, i]
    v = ((acc[..., 0] + acc[..., 1]) + acc[..., 2]) + acc[..., 3]
    h = tree // 2
    while h >= 32:
        v = np.concatenate([v[:, :h] + v[:, h:2 * h], v[:, h:]], axis=1)
        h //= 2
    v = v[:, :32]
    for o in (16, 8, 4, 2, 1):
        v = v + np.concatenate([v[:, o:], v[:, 32 - o:]], axis=1)
    return v[:, 0] * np.float32(1.0 / D)


def b6_order_cells(gen) -> dict:
    """Whether PyTorch's CUDA ``(x * x).mean(-1)`` (the plain version's RMSNorm
    statistic) equals, bit for bit, the sum in B6's kernel order
    (sumsq_mean_kernel_order) and the f64 sum rounded once, row by row, at
    B6_ORDER_SHAPES."""
    import numpy as np
    import torch

    cells = {}
    for rows, D in B6_ORDER_SHAPES:
        x = torch.randn(rows, D, generator=gen, device="cuda").bfloat16()
        xf = x.float()
        torch_mean = (xf * xf).mean(-1).cpu().numpy()
        xn = xf.cpu().numpy()
        f64 = ((xn.astype(np.float64) ** 2).sum(-1) / D).astype(np.float32)
        cells[f"B6 statistics order {rows}x{D}"] = dict(
            tree=rows_tree(rows, D), rows=rows,
            kernel_order_equal=int((sumsq_mean_kernel_order(xn) == torch_mean).sum()),
            f64_equal=int((f64 == torch_mean).sum()))
    return cells


def b6_draws(kernel, plain, exact, draw) -> dict:
    """Over B6_DRAWS draws: how often (and how far, the largest ratio) the
    kernel against the plain version, the kernel against the f64 function
    and the plain version against it are beyond PAGED_TOL, and the kernel
    against the plain version beyond QUANT_MLP_TOL."""
    def ratio(got, want, rms_share):
        got, want = got.float(), want.float()
        rms = want.pow(2).mean(-1, keepdim=True).sqrt()
        return ((got - want).abs() / (2 ** -7 * want.abs() + rms_share * rms)).max().item()

    pairs = {"kernel_vs_plain": [], "kernel_vs_f64": [], "plain_vs_f64": [],
             "kernel_vs_plain_quant_mlp_tol": []}
    for _ in range(B6_DRAWS):
        h = draw()
        got, want, f64 = kernel(h), plain(h), exact(h)
        pairs["kernel_vs_plain"].append(ratio(got, want, 1e-3))
        pairs["kernel_vs_f64"].append(ratio(got, f64, 1e-3))
        pairs["plain_vs_f64"].append(ratio(want, f64, 1e-3))
        pairs["kernel_vs_plain_quant_mlp_tol"].append(ratio(got, want, 2 ** -7))
    return {k: dict(beyond=sum(r > 1 for r in v), max=max(v)) for k, v in pairs.items()}


def b6_b8_cells(gen) -> dict:
    """B6 and B8's decode-row cells (above): a digest and the mean cold-L2
    time of each, held to its plain version (PAGED_TOL, as the chip smoke
    test holds them; B6's no-norm form QUANT_MLP_TOL) with equal bits twice,
    beside its bound and yardstick; and B6's gated forms over B6_DRAWS
    draws of 8 and 16 rows each against the f32 plain version and the f64
    function (b6_draws)."""
    import torch
    import torch.nn.functional as F

    from chip_smoke import _f32_reduction, bound, paged_close, quant_mlp_close

    qmm, fd = (importlib.import_module(f"shuffle_exchange_tpu_torch.ops.{m}") for m in
               ("quant_matmul", "fused_decode"))

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda") * scale).bfloat16()

    def held(fn, plain, close):
        out = fn()
        err, ok = close(out, plain())
        return dict(digest=digest([out]), max_abs_err=err.max().item(), within=ok,
                    equal_bits_twice=digest([fn()]) == digest([out]))

    cells = {}
    with _f32_reduction():
        for label, D, Fd, gated, norm, act, biased, rows in B6_CELLS:
            wg = randn(D, Fd, scale=D ** -0.5) if gated else None
            wu, wd = randn(D, Fd, scale=D ** -0.5), randn(Fd, D, scale=Fd ** -0.5)
            ln_w = (1 + randn(D, scale=0.1).float()).bfloat16()
            bias = dict(b_up=randn(Fd, scale=0.5), b_down=randn(D, scale=0.5)) if biased else {}
            kw = dict(norm=norm or "layernorm", activation=act, apply_norm=norm is not None,
                      **bias)
            for B in rows:
                h = randn(B, D)
                fn = lambda: fd.fused_mlp(h, h, ln_w, wu, wd, wg, eps=1e-5, **kw)
                plain = lambda: fd.fused_mlp_reference(h, h, ln_w, wu, wd, wg, 1e-5, **kw)
                row = held(fn, plain, paged_close if norm else quant_mlp_close)

                def cublas_sequence():
                    yn = F.rms_norm(h, (D,), ln_w, 1e-5) if norm else h
                    if gated:
                        return h + (F.silu(yn @ wg) * (yn @ wu)) @ wd
                    return h + torch.addmm(bias["b_down"], F.gelu(
                        torch.addmm(bias["b_up"], yn, wu), approximate="tanh"), wd)

                n_w = 3 if gated else 2
                nbytes = n_w * D * Fd * 2 + 2 * B * D * 2 + (D * 2 if norm else 0) + (
                    (Fd + D) * 2 if biased else 0)
                row["bound_ms"], row["bound_by"] = bound(nbytes, 2.0 * B * D * Fd * n_w)
                row.update(ms=time_cold(fn, 10), cublas_sequence_ms=time_cold(cublas_sequence, 10))
                cells[f"B6 {label} {B}"] = row
            if gated:   # the tolerances over B6_DRAWS draws of 8 and of 16 rows
                for B in (8, 16):
                    cells[f"B6 {label} {B}: {B6_DRAWS} draws"] = b6_draws(
                        lambda h: fd.fused_mlp(h, h, ln_w, wu, wd, wg, eps=1e-5, **kw),
                        lambda h: fd.fused_mlp_reference(h, h, ln_w, wu, wd, wg, 1e-5, **kw),
                        lambda h: b6_f64(h, ln_w, wg, wu, wd), lambda: randn(B, D))
            del wg, wu, wd
            torch.cuda.empty_cache()
        for bits in (8, 4, "fp8"):
            for name, (K, N) in B8_ATTN.items():
                w = randn(K, N, scale=K ** -0.5)
                qm = qmm.quantize_weight(w, 256, bits=bits)
                x = randn(8, K)
                fn = lambda: qmm.quant_matmul(x, qm)
                row = held(fn, lambda: qmm.quant_matmul_reference(x, qm), paged_close)
                row["bound_ms"], row["bound_by"] = bound(8 * K * 2 + qm.nbytes + 8 * N * 2,
                                                         2.0 * 8 * K * N)
                row.update(ms=time_cold(fn, 20),
                           library_ms=time_cold(lambda: x @ qm.dequantize(), 10))
                cells[f"B8 {bits} 8x{name} [{K}, {N}]"] = row
        if hasattr(qmm, "gemv_plan"):
            gemv_rows = qmm.GEMV_ROWS
            for name, (K, N) in B8_BOUNDARY_SHAPES.items():
                w = randn(K, N, scale=K ** -0.5)
                for bits in (8, 4, "fp8"):
                    qm = qmm.quantize_weight(w, 256, bits=bits)
                    for M in B8_BOUNDARY_ROWS:
                        x = randn(M, K)
                        fn = lambda: qmm.quant_matmul(x, qm)
                        row = {}
                        try:
                            for route, limit in (("gemv", max(B8_BOUNDARY_ROWS)), ("wgmma", 0)):
                                qmm.GEMV_ROWS = limit
                                g = held(fn, lambda: qmm.quant_matmul_reference(x, qm),
                                         paged_close)
                                row.update({f"{route}_ms": time_cold(fn, 10),
                                            f"{route}_within": g["within"],
                                            f"{route}_equal_bits_twice": g["equal_bits_twice"]})
                        finally:
                            qmm.GEMV_ROWS = gemv_rows
                        row["bound_ms"], row["bound_by"] = bound(M * K * 2 + qm.nbytes + M * N * 2,
                                                                 2.0 * M * K * N)
                        cells[f"B8 boundary {bits} {M}x{name} [{K}, {N}]"] = row
                    del qm
                del w
                torch.cuda.empty_cache()
    return cells


# "gemv_plan": a split sweep of the tensor-core GEMV (decode_gemv.plan's
# cost, re-fitted from it): each cell timed at every split count of a
# range (decode_gemv.plan replaced for the call by the forced split of the
# reduction over K), with the plan's own pick named. B6 at Llama-3-8B's
# widths, 8 rows (its down GEMV's K 14336, then its up GEMV's K 4096), B16
# bf16 at Mixtral's w_down and w_gate, 16 ragged rows, B7 int8 at 8 rows
# (down, then up), B8 int8 at 8 rows on w_gate, wq and w_down
PLAN_SPLITS = (1, 2, 3, 4, 5, 6, 7, 8, 10, 12, 14, 16, 20, 24, 28, 32)


def plan_sweep_cells(gen, seed) -> dict:
    """The ``gemv_plan`` cells (above): ms by split count and the plan's
    pick (every split count held to the plain version: PAGED_TOL, B7
    QUANT_MLP_TOL)."""
    import torch

    from chip_smoke import _f32_reduction, paged_close, quant_mlp_close

    dg, gg, qmm, fd = (importlib.import_module(f"shuffle_exchange_tpu_torch.ops.{m}") for m in
                       ("decode_gemv", "grouped_gemm", "quant_matmul", "fused_decode"))
    orig = dg.plan

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda") * scale).bfloat16()

    def options(K, unit):
        """(splits, chunk) of each split count of PLAN_SPLITS the plan could take."""
        units = -(-K // unit)
        least = min(units, -(-dg.WARPS * dg.STAGE_ROWS // unit))
        out = {}
        for s in PLAN_SPLITS:
            per = -(-units // s)
            if per >= least:
                out.setdefault(-(-K // (per * unit)), per * unit)
        return out

    def sweep(fn, plain, close, K, unit):
        picked = {}

        def spy(*a):
            got = orig(*a)
            if a[0] == K:
                picked["plan"] = got[0]
            return got

        dg.plan = spy
        try:
            fn()
        finally:
            dg.plan = orig
        row = dict(plan_splits=picked.get("plan"), ms={}, within={})
        for s, chunk in options(K, unit).items():
            dg.plan = lambda *a, s=s, chunk=chunk: (s, chunk) if a[0] == K else orig(*a)
            try:
                out = fn()
                row["within"][s] = close(out, plain())[1]
                row["ms"][s] = time_cold(fn, 10)
            finally:
                dg.plan = orig
        row["best_splits"] = min(row["ms"], key=row["ms"].get)
        row["plan_over_best"] = row["ms"].get(row["plan_splits"], float("nan")) / min(
            row["ms"].values())
        return row

    cells = {}
    with _f32_reduction():
        D, Fd = 4096, 14336
        wg, wu = randn(D, Fd, scale=D ** -0.5), randn(D, Fd, scale=D ** -0.5)
        wd = randn(Fd, D, scale=Fd ** -0.5)
        ln_w = (1 + randn(D, scale=0.1).float()).bfloat16()
        h = randn(8, D)
        fn = lambda: fd.fused_mlp(h, h, ln_w, wu, wd, wg, eps=1e-5)
        plain = lambda: fd.fused_mlp_reference(h, h, ln_w, wu, wd, wg, 1e-5)
        for what, K in (("down", Fd), ("up", D)):
            cells[f"split sweep: B6 llama-3-8b 8, {what} GEMV"] = sweep(fn, plain, paged_close,
                                                                       K, 32)
        q = [qmm.quantize_weight(w, 256, bits=8) for w in (wg, wu, wd)]
        fn = lambda: fd.fused_mlp(h, h, ln_w, q[1], q[2], q[0], eps=1e-5)
        plain = lambda: fd.fused_mlp_quant_reference(h, h, ln_w, q[1], q[2], q[0], 1e-5)
        for what, K in (("down", Fd), ("up", D)):
            cells[f"split sweep: B7 int8 llama-3-8b 8, {what} GEMV"] = sweep(
                fn, plain, quant_mlp_close, K, 256)
        for name, (K, N), w in (("w_gate", (D, Fd), wg), ("wq", (D, D), wg[:, :D].contiguous()),
                                ("wk", (D, 1024), wg[:, :1024].contiguous()),
                                ("w_down", (Fd, D), wd)):
            qm = qmm.quantize_weight(w, 256, bits=8)
            x = randn(8, K)
            if hasattr(qmm, "gemv_plan"):
                cells[f"split sweep: B8 int8 8x{name}"] = sweep(
                    lambda: qmm.quant_matmul(x, qm), lambda: qmm.quant_matmul_reference(x, qm),
                    paged_close, K, 256)
        del wg, wu, wd, q
        torch.cuda.empty_cache()
        # decode_gemv_cells' own B16 bf16 cells (their group sizes replayed)
        draws = b16_draws(seed)
        for K, F_ in ((14336, 4096), (4096, 14336)):
            w16 = randn(8, K, F_, scale=K ** -0.5)
            for N in (16, 2):
                x = randn(N, K)
                sizes = torch.from_numpy(draws[(K, F_, "bf16", N, "ragged")]).cuda()
                cells[f"split sweep: B16 bf16 {N}x[{K}, {F_}] ragged"] = sweep(
                    lambda: gg.grouped_matmul(x, w16, sizes),
                    lambda: gg.grouped_matmul_reference(x, w16, sizes), paged_close, K, 32)
            del w16
            torch.cuda.empty_cache()
    return cells


def flash_cells(fa, gen, randn, seed) -> dict:
    """The FLASH_CELLS (each dense cell held to its plain version, equal
    bits twice, beside SDPA) and the MASK_CELLS."""
    import torch
    import torch.nn.functional as F

    from chip_smoke import _sdpa_backend, _sdpa_kernels, grad_close, paged_close

    def sdpa(q, k, v, causal, segs):
        """(forward, backward) of one SDPA call on the same operands."""
        qs, ks, vs = (t.transpose(1, 2).contiguous().requires_grad_(True) for t in (q, k, v))
        kw = dict(is_causal=causal, enable_gqa=True)
        if segs is not None:   # segment ids (T == S) as a boolean mask, causal ANDed in
            allowed = segs[:, :, None] == segs[:, None, :]
            if causal:
                allowed = allowed & torch.ones_like(allowed[0]).tril()
            kw = dict(attn_mask=allowed[:, None], enable_gqa=True)
        fwd = lambda: F.scaled_dot_product_attention(qs, ks, vs, **kw)
        out = fwd()
        dos = torch.randn_like(out)
        return fwd, lambda: torch.autograd.grad(out, (qs, ks, vs), dos, retain_graph=True)

    cells = {}
    for label, B, T, S, H, KV, Dh, causal, seg in FLASH_CELLS:
        if Dh not in fa.HEAD_DIMS:
            continue
        q, k, v = randn(B, T, H, Dh), randn(B, S, KV, Dh), randn(B, S, KV, Dh)
        dout = randn(B, T, H, Dh)
        segs = None
        if seg:
            segs = torch.cumsum(torch.rand(B, T, generator=gen, device="cuda") < 0.01, 1).int()
        fwd = lambda: fa.flash_attention_lse(q, k, v, causal, segs)
        out, lse = fwd()
        want = fa.reference_attention(q, k, v, causal, segs, p_f32=True)
        err, ok = paged_close(out, want)
        # P as one bf16 term (the plain version's cast) against the same tolerance:
        # what a kernel without the hi + lo split could at best reach
        err1, ok1 = paged_close(fa.reference_attention(q, k, v, causal, segs), want)
        lib_fwd, lib_bwd = sdpa(q, k, v, causal, segs)
        cells[f"{label}: forward"] = dict(
            digest=digest((out, lse)), ms=time_cold(fwd), max_abs_err=err.max().item(),
            within=ok, equal_bits_twice=digest(fwd()) == digest(fwd()),
            sdpa_ms=time_cold(lib_fwd), sdpa_backend=_sdpa_backend(_sdpa_kernels(lib_fwd)),
            p_bf16_max_abs_err=err1.max().item(), p_bf16_within=ok1)
        del err, err1, want
        if "bwd" in label and Dh in fa.BWD_HEAD_DIMS:
            bwd = lambda: fa.flash_attention_bwd(q, k, v, out, lse, dout, causal, segs)
            got = bwd()
            checks = [grad_close(g, w) for g, w in
                      zip(got, fa.reference_attention_bwd(q, k, v, out, dout, causal, segs))]
            cells[f"{label}: backward"] = dict(
                digest=digest(got), ms=time_cold(bwd),
                max_abs_err=max(e.max().item() for e, _ in checks),
                within=all(c for _, c in checks), equal_bits_twice=digest(bwd()) == digest(bwd()),
                sdpa_bwd_ms=time_cold(lib_bwd),
                sdpa_backend=_sdpa_backend(_sdpa_kernels(lib_bwd)))
            del got, checks
        del q, k, v, dout, out, lse, lib_fwd, lib_bwd
        torch.cuda.empty_cache()
    sa = importlib.import_module("shuffle_exchange_tpu_torch.ops.sparse_attention")
    configs = {"fixed": sa.FixedSparsityConfig(block=128, num_local_blocks=4,
                                               num_global_blocks=1),
               "bigbird": sa.BigBirdSparsityConfig(block=128, num_random_blocks=2,
                                                   num_sliding_window_blocks=3,
                                                   num_global_blocks=1, seed=seed)}
    for label, T, H, KV, Dh, kind in MASK_CELLS:
        if Dh not in fa.BWD_HEAD_DIMS:
            continue
        cfg = configs[kind]
        mask = fa.tile_mask(sa.element_mask(cfg.make_layout(T), cfg.block, T, T, True))
        q, k, v, dout = randn(1, T, H, Dh), randn(1, T, KV, Dh), randn(1, T, KV, Dh), randn(1, T, H, Dh)
        fwd = lambda: fa.flash_attention_lse(q, k, v, False, None, mask=mask)
        out, lse = fwd()
        bwd = lambda: fa.flash_attention_bwd(q, k, v, out, lse, dout, False, None, mask=mask)
        cells[f"{label}: forward"] = dict(digest=digest((out, lse)), ms=time_cold(fwd))
        cells[f"{label}: backward"] = dict(digest=digest(bwd()), ms=time_cold(bwd))
    return cells


def sweep_cells(gen, seed) -> dict:
    """The SWEEP_* cells: a digest and the mean cold-L2 time of each."""
    import numpy as np
    import torch

    from chip_smoke import MQ_FIRST, MQ_WIDTHS, group_pattern, mlp_quant_cells

    fa, gg, qmm, fd = (importlib.import_module(f"shuffle_exchange_tpu_torch.ops.{m}") for m in
                       ("flash_attention", "grouped_gemm", "quant_matmul", "fused_decode"))
    rng = np.random.default_rng(seed)

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda") * scale).bfloat16()

    cells = {}
    for B, T, S, H, KV, Dh, causal, seg in SWEEP_FLASH:
        q, k, v = randn(B, T, H, Dh), randn(B, S, KV, Dh), randn(B, S, KV, Dh)
        segs = None
        if seg:
            segs = torch.from_numpy(np.sort(rng.integers(0, 4, size=(B, T)), axis=1)
                                    .astype(np.int32)).cuda()
        fn = lambda: fa.flash_attention(q, k, v, causal, segs)
        cells[f"flash {B}x{T}x{S} {H}/{KV}x{Dh}{'' if causal else ' full'}"
              f"{' seg' if seg else ''}: forward"] = dict(digest=digest([fn()]), ms=time_cold(fn))
    for K, N in SWEEP_QUANT_SHAPES:
        w = randn(K, N, scale=K ** -0.5)
        for bits in (8, 4, "fp8"):
            qm = qmm.quantize_weight(w, 256, bits=bits)
            for rows in SWEEP_QUANT_ROWS:
                x = randn(rows, K)
                fn = lambda: qmm.quant_matmul(x, qm)
                cells[f"B8 {bits} {rows}x[{K}, {N}]"] = dict(digest=digest([fn()]),
                                                             ms=time_cold(fn))
    for K, F in SWEEP_GG_SHAPES:
        w16 = randn(8, K, F, scale=K ** -0.5)
        for fmt in ("bf16", 8, "fp8"):
            w = w16 if fmt == "bf16" else qmm.quantize_weight(w16, 256, bits=fmt)
            for N in SWEEP_GG_ROWS:
                x = randn(N, K)
                for pattern in SWEEP_GG_PATTERNS:
                    sizes = torch.from_numpy(group_pattern(pattern, N, 8, rng)).cuda()
                    if pattern == "ragged":
                        continue   # timed by chip_smoke.py
                    fn = lambda: gg.grouped_matmul(x, w, sizes)
                    cells[f"B16 {fmt} {N}x[{K}, {F}] {pattern}"] = dict(
                        digest=digest([fn()]), ms=time_cold(fn, 5 if N > 1024 else 10))
            del w
        del w16
        torch.cuda.empty_cache()
    made = {}
    for norm, gated, act, bits, width, B in mlp_quant_cells():
        if (norm, gated, act, bits, width, B) in MQ_FIRST:
            continue   # timed by chip_smoke.py
        D, Fd = MQ_WIDTHS[width]
        if (width, bits) not in made:
            made.clear()
            made[(width, bits)] = [qmm.quantize_weight(randn(*shape, scale=shape[0] ** -0.5), 256,
                                                       bits=bits)
                                   for shape in ((D, Fd), (D, Fd), (Fd, D))]
        qg, qu, qd = made[(width, bits)]
        ln_w, ln_b = (1 + randn(D, scale=0.1)), randn(D, scale=0.1)
        h = randn(B, D)
        fn = lambda: fd.fused_mlp(h, h, ln_w, qu, qd, qg if gated else None, eps=1e-5,
                                  ln_b=ln_b, norm=norm, activation=act)
        cells[f"B7 {norm} {'gated' if gated else 'plain'} {act} {bits} {width} {B}"] = dict(
            digest=digest([fn()]), ms=time_cold(fn))
    return cells


def run(tree: Path, seed: int, sections=SECTIONS) -> dict:
    import torch

    sys.path.insert(0, str(tree))
    import shuffle_exchange_tpu_torch as sxt

    if not Path(sxt.__file__).resolve().is_relative_to(tree):
        raise RuntimeError(f"imported {sxt.__file__}, not the package under {tree}")
    # the modules (``ops`` exports functions of the same names)
    fa, gg, qmm, _build = (importlib.import_module(f"shuffle_exchange_tpu_torch.ops.{m}") for m in
                           ("flash_attention", "grouped_gemm", "quant_matmul", "_build"))

    # one nvcc per source the sections run, all at once
    sources = {"flash": ("flash_attention",), "alibi": ("alibi_attention",),
               "moe_train": ("flash_attention", "grouped_gemm", "fused_adam"),
               "alibi_train": ("alibi_attention", "fused_adam"),
               "grouped": ("grouped_gemm",), "quant": ("quant_matmul",),
               "paged": ("paged_attention", "fused_decode"), "lora": ("lora_gemm",),
               "sweeps": ("flash_attention", "quant_matmul", "grouped_gemm", "fused_decode"),
               "decode_gemv": ("grouped_gemm", "fused_decode", "quant_matmul"),
               "b6_b8": ("fused_decode", "quant_matmul"),
               "gemv_plan": ("grouped_gemm", "fused_decode", "quant_matmul")}
    _build.build_all(sorted({s for sec in sections for s in sources[sec]
                             if (_build.CSRC / f"{s}.cu").exists()}))

    gens = [torch.Generator(device="cuda").manual_seed(seed * 10 + i) for i in range(6)]
    gen = gens[0]   # each section draws from its own generator: a tree without the
                    # ALiBi kernels gives the later sections the same inputs

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda") * scale).bfloat16()

    cells = {}
    if "flash" in sections:
        cells.update(flash_cells(fa, gen, randn, seed))
    try:
        from shuffle_exchange_tpu_torch.models import alibi_slopes
        al = importlib.import_module("shuffle_exchange_tpu_torch.ops.alibi_attention")
    except ImportError:
        al = None
    if "alibi" not in sections:
        al = None
    gen = gens[1]
    for label, B, T, S, H, KV, Dh in (ALIBI_CELLS if al is not None else []):
        slopes = torch.from_numpy(alibi_slopes(H)).cuda()
        q, k, v = randn(B, T, H, Dh), randn(B, S, KV, Dh), randn(B, S, KV, Dh)
        dout = randn(B, T, H, Dh)
        fwd = lambda: al.alibi_flash_attention_lse(q, k, v, slopes)
        out, lse = fwd()
        bwd = lambda: al.alibi_flash_attention_bwd(q, k, v, slopes, out, lse, dout)
        cells[f"{label}: forward"] = dict(digest=digest((out, lse)), ms=time_cold(fwd),
                                          equal_bits_twice=digest(fwd()) == digest(fwd()))
        cells[f"{label}: backward + dslope"] = dict(
            digest=digest(bwd()), ms=time_cold(bwd),
            equal_bits_twice=digest(bwd()) == digest(bwd()))
    if al is not None:
        cells.update(alibi_phase_cells(seed))

    gen = gens[2]
    E, K, F = 8, 1024, 2816   # bench.py's _config3 expert shapes
    w = randn(E, K, F, scale=K ** -0.5)
    w8 = qmm.quantize_weight(w, 256, bits=8)
    for what, sizes in (GROUPED_SIZES.items() if "grouped" in sections else []):
        gs = torch.tensor(sizes, dtype=torch.int32, device="cuda")
        N = sum(sizes)
        x, dy = randn(N, K), randn(N, F)
        for name, fn in ((f"B16 bf16 {what}", lambda: gg.grouped_matmul(x, w, gs)),
                         (f"B16 int8 {what}", lambda: gg.grouped_matmul(x, w8, gs)),
                         (f"B16-dx {what}", lambda: gg.grouped_matmul_dx(dy, w, gs)),
                         (f"B16-dw {what}", lambda: gg.grouped_matmul_dw(x, dy, gs))):
            cells[name] = dict(digest=digest([fn()]), ms=time_cold(fn))

    gen = gens[3]
    wq = randn(4096, 14336, scale=4096 ** -0.5)
    for bits in ((8, 4) if "quant" in sections else ()):
        qm = qmm.quantize_weight(wq, 256, bits=bits)
        for rows in (8, 256):
            x = randn(rows, 4096)
            fn = lambda: qmm.quant_matmul(x, qm)
            cells[f"B8 int{bits} {rows} rows"] = dict(digest=digest([fn()]), ms=time_cold(fn))
    if "quant" in sections:
        cells.update(quant_prefill_cells(qmm, torch.Generator(device="cuda").manual_seed(
            seed * 10 + 8)))
    if "paged" in sections:
        cells.update(paged_cells(gens[4], seed))
    if "lora" in sections:
        cells.update(lora_cells(gens[5]))
    if "sweeps" in sections:
        cells.update(sweep_cells(torch.Generator(device="cuda").manual_seed(seed * 10 + 6), seed))
    if "grouped" in sections:
        cells.update(grouped_cells(torch.Generator(device="cuda").manual_seed(seed * 10 + 7),
                                   seed))
    if "moe_train" in sections:
        cells.update(moe_train_cells(seed))
    if "alibi_train" in sections:
        cells.update(alibi_train_cells(seed))
    if "decode_gemv" in sections:
        cells.update(decode_gemv_cells(torch.Generator(device="cuda").manual_seed(seed * 10 + 9),
                                       seed))
    if {"decode_gemv", "b6_b8"} & set(sections):
        cells.update(b6_b8_cells(torch.Generator(device="cuda").manual_seed(seed * 10 + 10)))
        cells.update(b6_order_cells(torch.Generator(device="cuda").manual_seed(seed * 10 + 12)))
    if "gemv_plan" in sections:
        cells.update(plan_sweep_cells(torch.Generator(device="cuda").manual_seed(seed * 10 + 11),
                                      seed))
    return cells


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--sections", nargs="+", choices=SECTIONS, default=list(SECTIONS))
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("torch_kernel_digest: no CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    tree = Path(args.tree).resolve()
    result = dict(tree=str(tree), card=card, cells=run(tree, args.seed, args.sections))
    text = json.dumps(result, indent=1)
    if args.out:
        Path(args.out).write_text(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
