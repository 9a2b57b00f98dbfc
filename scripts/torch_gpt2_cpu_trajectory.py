"""Train the port's ``gpt2_small`` on the CPU in f32 under ``bench.py``'s
``_config1`` optimizer (AdamW, lr 3e-4, weight decay 0.1, ZeRO 1) on one
seeded batch, repeated, and print each step's loss and global grad norm.

The batch is drawn as ``chip_smoke.py``'s training phases draw theirs
(``default_rng([seed, 9])``; a batch of 4 is the first 4 rows of phase
5d's 16), so the trajectory is an f32 witness of what phase 5d trains in
bf16 on the card:

    python3 scripts/torch_gpt2_cpu_trajectory.py --layers 12 --seq 1024 --batch 4
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=12)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import shuffle_exchange_tpu_torch as sxt
    from shuffle_exchange_tpu_torch.models import Transformer, gpt2_small

    cfg = dataclasses.replace(gpt2_small(), n_layers=args.layers, max_seq_len=args.seq)
    config = {"train_batch_size": args.batch, "zero_optimization": {"stage": 1},
              "optimizer": {"type": "AdamW", "params": {"lr": 3e-4, "weight_decay": 0.1}},
              "steps_per_print": 10 ** 9}
    engine, *_ = sxt.initialize(model=Transformer(cfg, device="cpu"), config=config,
                                seed=args.seed, device="cpu")
    ids = np.random.default_rng([args.seed, 9]).integers(0, cfg.vocab_size,
                                                         size=(args.batch, args.seq))
    batch = {"input_ids": ids.astype(np.int32)}
    for step in range(args.steps):
        t0 = time.perf_counter()
        loss = float(engine.train_batch(batch))
        print(f"step {step}: loss {loss} grad_norm {engine.get_global_grad_norm()} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
