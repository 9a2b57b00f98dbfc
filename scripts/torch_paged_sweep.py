"""Sweep the paged decode kernel's (B2) split rule and time the paged extend
kernel (B3) at head_dim 256 past one wave, on one CUDA card.

B2: at the decode cells of Llama-3-8B (8, 32 and 64 rows, 1,024 and 2,048
positions), Falcon-7B's group (8 rows and 1), GPT-J-6B, BLOOM-1b7,
Phi-3-mini and Pythia-2.8b (8 rows to 2,048 positions, the first row
full), the wrapper's ``decode_splits`` against fixed split lengths of
128-1,024 positions and one split; at Llama-3-8B's 2,048 positions and at
Phi-3-mini's and Pythia-2.8b's 32 x 32 kv heads also over int8 and fp8
pools. Each split choice is
monkeypatched into ``paged_attention.decode_splits`` and timed with the
chip smoke test's cold-L2 timer, the wrapper's rule and one split twice
(first and last), each held to PAGED_TOL and equal bits twice. B3: GPT-J-6B's
16 x 256 heads at 2, 4 and 8 chunks of 256 rows (128, 256 and 512 blocks)
over bf16 and int8 pools, beside one SDPA call over the gathered K/V (bf16);
where the tree's wrapper still chooses the extend kernel's key groups
(``extend_key_groups``), both choices are timed.

    python3 scripts/torch_paged_sweep.py --out sweep.json
    python3 scripts/torch_paged_sweep.py --tree build/parent --out parent.json

``--tree`` is the checkout whose ``chip_smoke.py`` and
``shuffle_exchange_tpu_torch`` are imported. It needs a card; it exits 1
without one.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

# (label, B, H, KV, Dh, longest sequence, ALiBi, pool formats)
DECODE_CELLS = [("falcon-7b", 8, 71, 1, 64, 2048, False, ("bf16",)),
                ("falcon-7b 1 row", 1, 71, 1, 64, 2048, False, ("bf16",)),
                ("llama-3-8b", 8, 32, 8, 128, 1024, False, ("bf16",)),
                ("llama-3-8b 2k", 8, 32, 8, 128, 2048, False, ("bf16", "int8", "fp8")),
                ("llama-3-8b 32 rows", 32, 32, 8, 128, 1024, False, ("bf16",)),
                ("llama-3-8b 64 rows", 64, 32, 8, 128, 1024, False, ("bf16",)),
                ("gpt-j-6b", 8, 16, 16, 256, 2048, False, ("bf16",)),
                ("bloom-1b7", 8, 16, 16, 128, 2048, False, ("bf16",)),
                ("phi-3-mini", 8, 32, 32, 96, 2048, False, ("bf16", "int8", "fp8")),
                ("pythia-2.8b", 8, 32, 32, 80, 2048, True, ("bf16", "int8", "fp8"))]
FIXED = (128, 192, 256, 384, 512, 1024)
EXTEND_ROWS = (2, 4, 8)        # chunks of 256 rows at GPT-J-6B's heads
EXTEND_STARTS = (1600, 512)


def pools(ck, cv, fmt):
    import torch

    from shuffle_exchange_tpu_torch.inference.paged import quantize_kv

    if fmt == "bf16":
        return ck, cv, {}
    dt = torch.int8 if fmt == "int8" else torch.float8_e4m3fn
    (kq, ks), (vq, vs) = quantize_kv(ck, dt), quantize_kv(cv, dt)
    return kq, vq, dict(k_scale=ks.contiguous(), v_scale=vs.contiguous())


def decode_cells(cs, tpa, gen, rng) -> dict:
    import numpy as np
    import torch
    import torch.nn.functional as F

    from shuffle_exchange_tpu_torch.models import alibi_slopes

    rule = tpa.decode_splits
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = {}
    for label, B, H, KV, Dh, longest, alibi, fmts in DECODE_CELLS:
        lens = np.concatenate([[longest], rng.integers(1, longest + 1, size=B - 1)])
        lens = lens.astype(np.int32)
        ck, cv, table = cs._paged_inputs(gen, rng, lens, H, KV, Dh, 64, pad=-1)
        q = torch.randn(B, 1, H, Dh, generator=gen, device="cuda").bfloat16()
        kvl = torch.from_numpy(lens).cuda()
        sl = (torch.as_tensor(alibi_slopes(H), dtype=torch.float32, device="cuda")
              if alibi else None)
        W = table.shape[1]
        choices = [("rule", rule), ("one split", lambda B_, K_, W_, bs, s: (1, W_ * bs))]
        choices += [(str(L), lambda B_, K_, W_, bs, s, L=L: (-(-W_ * bs // L), L))
                    for L in FIXED if L < W * 64]
        for fmt in fmts:
            kk, vv, sc = pools(ck, cv, fmt)
            want = tpa.paged_decode_reference(q, kk, vv, table, kvl, p_f32=True,
                                              alibi_slopes=sl, **sc)
            row = {}
            if fmt == "bf16" and sl is None:
                qs, ks, vs, mask = cs._sdpa_inputs(q, ck, cv, table, lens[:, None])
                row["sdpa_ms"] = cs.time_cold(lambda: F.scaled_dot_product_attention(
                    qs, ks, vs, attn_mask=mask, enable_gqa=True))
            try:
                for name, split in choices + choices[:2][::-1]:
                    tpa.decode_splits = split
                    run = lambda: tpa.paged_decode_attention(q, kk, vv, table, kvl,
                                                             alibi_slopes=sl, **sc)
                    ok = cs.paged_close(run(), want)[1] and cs.equal_bits_twice(run)
                    r = row.setdefault(name, {"splits": split(B, KV, W, 64, sms),
                                              "ms": [], "within": True})
                    r["ms"].append(cs.time_cold(run))
                    r["within"] = r["within"] and ok
            finally:
                tpa.decode_splits = rule
            out[f"B2 {label} {fmt}"] = row
            print(f"B2 {label} {fmt}", json.dumps(row), flush=True)
    return out


def extend_cells(cs, tpa, gen, rng) -> dict:
    import numpy as np
    import torch
    import torch.nn.functional as F

    H = KV = 16
    Dh = 256
    groups = getattr(tpa, "extend_key_groups", None)
    out = {}
    for fmt in ("bf16", "int8"):
        for B in EXTEND_ROWS:
            for base in EXTEND_STARTS:
                start = (base + 64 * np.arange(B)).astype(np.int32)
                nnew = np.full(B, 256, np.int32)
                nnew[-1] = 200
                ck, cv, table = cs._paged_inputs(gen, rng, start + nnew, H, KV, Dh, 64, pad=-1)
                kk, vv, sc = pools(ck, cv, fmt)
                q = torch.randn(B, 256, H, Dh, generator=gen, device="cuda").bfloat16()
                st, nn = torch.from_numpy(start).cuda(), torch.from_numpy(nnew).cuda()
                want = tpa.paged_extend_reference(q, kk, vv, table, st, nn, p_f32=True, **sc)
                row = {}
                if fmt == "bf16":
                    vis = np.minimum(start[:, None] + np.arange(256)[None, :] + 1,
                                     (start + nnew)[:, None])
                    qs, ks, vs, mask = cs._sdpa_inputs(q, ck, cv, table, vis)
                    row["sdpa_ms"] = cs.time_cold(
                        lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask))
                forms = [("kernel", None)] if groups is None else [
                    ("1 key group", 1), ("2 key groups", 2), ("2 key groups", 2),
                    ("1 key group", 1)]
                try:
                    for name, g in forms:
                        if g is not None:
                            tpa.extend_key_groups = lambda *a, g=g: g
                        run = lambda: tpa.paged_extend_attention(q, kk, vv, table, st, nn, **sc)
                        got = run()
                        ok = all(cs.paged_close(got[b, :n], want[b, :n])[1]
                                 for b, n in enumerate(nnew))
                        r = row.setdefault(name, {"ms": [], "within": True})
                        r["ms"].append(cs.time_cold(run))
                        r["within"] = r["within"] and ok and cs.equal_bits_twice(run)
                finally:
                    if groups is not None:
                        tpa.extend_key_groups = groups
                key = f"B3 gpt-j-6b {fmt} {B} x 256 from {base}"
                out[key] = row
                print(key, json.dumps(row), flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("torch_paged_sweep: no CUDA card", file=sys.stderr)
        return 1
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree))
    import importlib

    import chip_smoke as cs
    import numpy as np

    tpa = importlib.import_module("shuffle_exchange_tpu_torch.ops.paged_attention")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    rng = np.random.default_rng(args.seed)
    result = dict(tree=str(tree), card=card, cells={**decode_cells(cs, tpa, gen, rng),
                                                    **extend_cells(cs, tpa, gen, rng)})
    if args.out:
        Path(args.out).write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
