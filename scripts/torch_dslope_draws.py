"""How far phase 2i's dslope bite reaches, draw by draw, on one CUDA card.

``chip_smoke.py`` phase 2i holds the ALiBi backward's dslope per head to
DSLOPE_RSS of the root-sum-square of its terms dS_ij * j, and requires a
zero dslope to fail that tolerance in every head but DSLOPE_UNBITTEN of the
phase. Whether a head's |dslope| clears DSLOPE_RSS of its terms depends on
the draw (PERF.md section 7). For each generator offset given (the phase's
generator is the run's seed plus ALIBI_DRAW), this script draws the phase's
cells exactly as phase 2i does (ALIBI_CELLS in order, the compared batch,
then the timed batch where it differs), runs the kernels' forward and
backward, and prints per cell the smallest |dslope_h| / (DSLOPE_RSS x
rss_h) over heads (the bite's margin: above 1 a zero dslope fails), the
heads below 1, and the largest kernel error |dslope_h - plain_h| /
(DSLOPE_RSS x rss_h) (below 1: the kernel holds). With ``--f64`` it also
computes a second witness, dslope in f64 from the same q, k, v, dout and
the kernels' out (the scores, their log-sum-exp, P, dP, delta and dS all
in f64), and prints per cell the largest |kernel - f64| and |plain - f64|
in the same units, and both at the head where kernel and plain differ
most: which of the two f32 computations sits off the function.

    python3 scripts/torch_dslope_draws.py --seed 0 --offsets 2 3 4 5
    python3 scripts/torch_dslope_draws.py --seed 0 --offsets 4 12 --f64

It needs a card; it exits 1 without one.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def dslope_f64(q, k, v, slopes, out, dout):
    """dslope [H] in f64 from q, k, v, dout and the forward's out: scores
    q k^T Dh^-0.5 + slope_h j under the bottom-right causal mask, P by their
    f64 log-sum-exp, dS = P (dO V^T - rowsum(dO out)), sum of dS_ij j."""
    import torch

    from shuffle_exchange_tpu_torch.ops.flash_attention import repeat_kv

    B, T, H, Dh = q.shape
    S = k.shape[1]
    G = H // k.shape[2]
    s = torch.einsum("bthd,bshd->bhts", q.double() * Dh ** -0.5, repeat_kv(k, G).double())
    pos = torch.arange(S, dtype=torch.float64, device=q.device)
    s += slopes.double()[None, :, None, None] * pos
    s.masked_fill_(~torch.ones(T, S, dtype=torch.bool, device=q.device).tril(S - T),
                   float("-inf"))
    p = torch.softmax(s, dim=-1)
    del s
    do = dout.double()
    ds = torch.einsum("bthd,bshd->bhts", do, repeat_kv(v, G).double())
    ds -= (do * out.double()).sum(-1).permute(0, 2, 1)[..., None]
    ds *= p
    del p
    return (ds * pos).sum(dim=(0, 2, 3))


def margins(seed: int, offset: int, f64: bool = False) -> dict:
    import torch

    import chip_smoke as cs
    from shuffle_exchange_tpu_torch.models import alibi_slopes
    from shuffle_exchange_tpu_torch.ops import alibi_attention as al

    gen = torch.Generator(device="cuda").manual_seed(seed + offset)
    cells = {}
    for label, Bc, Bt, T, S, H, KV, Dh in cs.ALIBI_CELLS:
        slopes = torch.from_numpy(alibi_slopes(H)).cuda()
        q, k, v, dout = cs.alibi_draw(gen, Bc, T, S, H, KV, Dh)
        out, lse = al.alibi_flash_attention_lse(q, k, v, slopes)
        got = al.alibi_flash_attention_bwd(q, k, v, slopes, out, lse, dout)[3]
        want = al.reference_alibi_attention_bwd(q, k, v, slopes, out, lse, dout)[3]
        ds = cs._plain_ds(q, k, v, slopes, out, lse, dout)
        pos = torch.arange(S, dtype=torch.float32, device="cuda")
        tol = cs.DSLOPE_RSS * (ds * pos).pow(2).sum(dim=(0, 2, 3)).sqrt()
        bite = want.float().abs() / tol
        err = (got.float() - want.float()).abs() / tol
        cells[label] = dict(min_bite=bite.min().item(), head=int(bite.argmin()),
                            below_1=(bite < 1).nonzero().flatten().tolist(),
                            max_err=err.max().item())
        if f64:
            exact = dslope_f64(q, k, v, slopes, out, dout)
            kern = (got.double() - exact).abs() / tol.double()
            plain = (want.double() - exact).abs() / tol.double()
            h = int(err.argmax())
            cells[label].update(kernel_vs_f64=kern.max().item(), plain_vs_f64=plain.max().item(),
                                worst_head=h, worst_kernel_vs_f64=kern[h].item(),
                                worst_plain_vs_f64=plain[h].item())
        del q, k, v, dout, out, lse, ds
        if Bt != Bc:   # the timed batch's draw, as phase 2i takes it
            cs.alibi_draw(gen, Bt, T, S, H, KV, Dh)
        torch.cuda.empty_cache()
    return cells


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--offsets", type=int, nargs="+", default=[2])
    ap.add_argument("--f64", action="store_true", help="add the f64 witness of each dslope")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("torch_dslope_draws: no CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    for offset in args.offsets:
        cells = margins(args.seed, offset, args.f64)
        below = sum(len(c["below_1"]) for c in cells.values())
        print(json.dumps(dict(seed=args.seed, offset=offset, heads_below_1=below,
                              min_bite=min(c["min_bite"] for c in cells.values()),
                              max_err=max(c["max_err"] for c in cells.values()), cells=cells)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
