"""Serve Llama-3-8B and Falcon-7B through one tree of the PyTorch port on
one CUDA card and print the scheduler's end-to-end numbers.

For each model (full width and depth, bf16 weights seeded on the card) and
each decode path (``decode_kernel`` "auto", which resolves to the fused
kernels, and "xla", which runs the paged decode kernel B2), one warm serve
builds and first-launches what the path needs, then one serve of the chip
smoke test's 8 requests x 32 new tokens (prompts of 128-1,024 tokens, the
same draws in every tree) gives TTFT p50 / p95, TPOT p50 / p95 and
sustained tokens/s from ``sched.stats()``. Every chunked-prefill tick
runs the extend kernel B3 on both paths.

``--tree`` is the checkout whose ``chip_smoke.py`` and
``shuffle_exchange_tpu_torch`` are imported, so a parent commit unpacked
with ``git archive`` is served by its own code. Compare two trees in turns
on one card, parent-change-change-parent:

    python3 scripts/torch_serve_ab.py --tree build/parent --out a.json
    python3 scripts/torch_serve_ab.py --tree . --out b.json

Host-side numbers (TTFT, TPOT) move with the host's load: read them beside
the other tree's runs on the same card. It needs a card; it exits 1
without one.
"""

from __future__ import annotations

import argparse
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

MODELS = ("llama-3-8b", "falcon-7b")
STATS = ("ttft_p50_s", "ttft_p95_s", "tpot_p50_s", "tpot_p95_s", "sustained_tokens_per_sec",
         "ticks")


def run(tree: Path, seed: int, models=MODELS) -> dict:
    import numpy as np
    import torch

    sys.path.insert(0, str(tree))
    import chip_smoke as cs
    import shuffle_exchange_tpu_torch as sxt
    from shuffle_exchange_tpu_torch.models import Transformer, config_from_hf, llama3_8b
    from shuffle_exchange_tpu_torch.ops import _build

    for mod in (cs, sxt):
        if not Path(mod.__file__).resolve().is_relative_to(tree):
            raise RuntimeError(f"imported {mod.__file__}, not the one under {tree}")
    _build.build_all(["paged_attention", "fused_decode", "flash_attention", "quant_matmul",
                      "grouped_gemm", "lora_gemm", "alibi_attention"])
    configs = {"llama-3-8b": llama3_8b, "falcon-7b": lambda: config_from_hf(cs.FALCON_7B)}
    out = {}
    for name in models:
        cfg = configs[name]()
        model = Transformer(cfg)
        params = model.init(torch.Generator(device="cuda").manual_seed(seed),
                            dtype=torch.bfloat16)
        torch.cuda.synchronize()
        for label, config in (("auto", cs.SERVE_CONFIG), ("xla", cs.XLA_CONFIG)):
            cs.serve(model, params, np.random.default_rng([seed, 99]), config=config,
                     n_prompts=2, max_new=4)
            t0 = time.perf_counter()
            _, sched, eng, _ = cs.serve(model, params, np.random.default_rng([seed, 1]),
                                        config=config)
            torch.cuda.synchronize()
            stats = sched.stats()
            out[f"{name} {label}"] = dict({k: stats[k] for k in STATS},
                                          seconds=time.perf_counter() - t0,
                                          resolved=eng._decode_kernel)
            print(f"[serve {name} {label}] {json.dumps(out[f'{name} {label}'])}", flush=True)
            del eng, sched
        del model, params
        gc.collect()
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--models", nargs="+", choices=MODELS, default=list(MODELS))
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("torch_serve_ab: no CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    tree = Path(args.tree).resolve()
    result = dict(tree=str(tree), card=card, serves=run(tree, args.seed, args.models))
    text = json.dumps(result, indent=1)
    if args.out:
        Path(args.out).write_text(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
