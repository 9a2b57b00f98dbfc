"""Where B6 (the fused MLP over bf16 weights) rounds apart from its plain
version, on one CUDA card.

B6 rounds two intermediates to bf16: yn = bf16(norm(y)) and a =
bf16(act(g) * u). One element of either rounded the other way moves the
output by up to ~1.5e-3 of its row's RMS, past PAGED_TOL near zero, so
``chip_smoke.py`` phases 2b / 2p need both to round as the plain version
rounds them. This script reads both off the card and counts, per draw of 8
rows at Phi-3-mini's and Llama-3-8B's widths:

- ``ratio``: the largest |kernel - plain| / PAGED_TOL of the output;
- ``yn_mis``: yn elements where the kernel differs from the plain version
  (the kernel's yn read back through identity weights: the plain MLP with
  relu, w_up = w_down = I, resid 0, on y and on -y);
- ``a_k_p``, ``a_k_64``, ``a_p_64``: elements of a where kernel, plain
  version (f32 sums) and the f64 sums (from the plain version's yn) differ
  (the kernel's a read back through w_down columns of the identity).

``--phase-2p`` instead runs ``chip_smoke.py`` up to its phase 2p and
records each ``check_fused_mlp`` call there (2b's and 2p's, on the draws
those phases make at the seed given) with the same counts and whether the
check passed, then stops.

    python3 scripts/torch_b6_rounding.py --draws 30 12
    python3 scripts/torch_b6_rounding.py --phase-2p

It needs a card; it exits 1 without one.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

WIDTHS = {"phi-3-mini": (3072, 8192), "llama-3-8b": (4096, 14336)}


def paged_ratio(got, want) -> float:
    got, want = got.float(), want.float()
    rms = want.pow(2).mean(-1, keepdim=True).sqrt()
    return ((got - want).abs() / (2 ** -7 * want.abs() + 1e-3 * rms)).max().item()


def analyse(h, ln_w, wg, wu, wd) -> dict:
    """The counts above for one gated RMSNorm call (resid = y = h)."""
    import torch
    import torch.nn.functional as F

    from shuffle_exchange_tpu_torch.ops import fused_decode as fd

    B, D = h.shape
    Fd = wu.shape[1]
    dev = h.device
    eye = torch.eye(D, device=dev, dtype=torch.bfloat16)
    zero = torch.zeros(B, D, device=dev, dtype=torch.bfloat16)
    got = fd.fused_mlp(h, h, ln_w, wu, wd, wg, eps=1e-5)
    want = fd.fused_mlp_reference(h, h, ln_w, wu, wd, wg, eps=1e-5)
    relu = dict(eps=1e-5, activation="relu")
    yn_k = (fd.fused_mlp(zero, h, ln_w, eye, eye, None, **relu).float()
            - fd.fused_mlp(zero, (-h.float()).bfloat16(), ln_w, eye, eye, None, **relu).float())
    x = h.float()
    yn = (x * torch.rsqrt((x * x).mean(-1, keepdim=True) + 1e-5) * ln_w.float()).bfloat16()
    a_k = []
    for c0 in range(0, Fd, D):
        sel = torch.zeros(Fd, D, device=dev, dtype=torch.bfloat16)
        idx = torch.arange(c0, min(c0 + D, Fd), device=dev)
        sel[idx, idx - c0] = 1
        a_k.append(fd.fused_mlp(zero, h, ln_w, wu, sel, wg, eps=1e-5)[:, :min(D, Fd - c0)])
    a_k = torch.cat(a_k, 1)
    a_p = (F.silu(yn.float() @ wg.float()) * (yn.float() @ wu.float())).bfloat16()
    a_64 = (F.silu(yn.double() @ wg.double()) * (yn.double() @ wu.double())).bfloat16()
    return dict(ratio=paged_ratio(got, want), yn_mis=int((yn_k != yn.float()).sum()),
                a_k_p=int((a_k != a_p).sum()), a_k_64=int((a_k != a_64).sum()),
                a_p_64=int((a_p != a_64).sum()))


def draw(gen, B, D, Fd):
    """(h, ln_w, wg, wu, wd) as chip_smoke.py's check_fused_mlp draws them."""
    import torch

    h = torch.randn(B, D, generator=gen, device="cuda").bfloat16()
    ln_w = (1 + 0.1 * torch.randn(D, generator=gen, device="cuda")).bfloat16()
    wg, wu = [(torch.randn(D, Fd, generator=gen, device="cuda") * D ** -0.5).bfloat16()
              for _ in range(2)]
    wd = (torch.randn(Fd, D, generator=gen, device="cuda") * Fd ** -0.5).bfloat16()
    return h, ln_w, wg, wu, wd


def draws(counts, seed: int) -> None:
    import torch

    for (label, (D, Fd)), n in zip(WIDTHS.items(), counts):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        rows = [analyse(*draw(gen, 8, D, Fd)) for _ in range(n)]
        for i, r in enumerate(rows):
            print(json.dumps(dict(widths=label, draw=i, **r)), flush=True)
        print(json.dumps(dict(widths=label, draws=n, beyond=sum(r["ratio"] > 1 for r in rows),
                              max_ratio=max(r["ratio"] for r in rows),
                              **{k: sum(r[k] for r in rows)
                                 for k in ("yn_mis", "a_k_p", "a_k_64", "a_p_64")})), flush=True)


class _Stop(Exception):
    pass


def phase_2p(seed: int) -> None:
    import torch

    import chip_smoke as cs

    check = cs.check_fused_mlp

    def recorded(gen, B, widths=cs.LLAMA_WIDTHS):
        g2 = torch.Generator(device="cuda")
        g2.set_state(gen.get_state())
        info = dict(D=widths["D"], B=B, **analyse(*draw(g2, B, widths["D"], widths["F"])))
        try:
            row, info["passed"] = check(gen, B, widths), True
        except RuntimeError as e:
            row, info["passed"], info["error"] = None, False, str(e)
        print(json.dumps(info), flush=True)
        if widths is cs.PHI3_WIDTHS and B == 1:
            raise _Stop()
        if row is None and widths is not cs.PHI3_WIDTHS:
            raise RuntimeError(info["error"])
        return row or {}

    cs.check_fused_mlp = recorded
    try:
        cs.main(["--seed", str(seed)])
    except _Stop:
        print("stopped after phase 2p's B6 cells", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=None,
                    help="the draws' generator (default 7); with --phase-2p chip_smoke.py's "
                    "--seed (default 0)")
    ap.add_argument("--draws", type=int, nargs=2, default=[30, 12],
                    help="draws at Phi-3-mini's and at Llama-3-8B's widths")
    ap.add_argument("--phase-2p", action="store_true")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("torch_b6_rounding: no CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    if args.phase_2p:
        phase_2p(0 if args.seed is None else args.seed)
    else:
        draws(args.draws, 7 if args.seed is None else args.seed)
    return 0


if __name__ == "__main__":
    sys.exit(main())
