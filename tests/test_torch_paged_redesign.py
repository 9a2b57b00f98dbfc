"""The paged decode (B2) and extend (B3) kernels' schedules and arithmetic,
on the CPU: what of their design can be held without the card.

- B2's split rule (``paged_attention.decode_splits``): every split
  non-empty, the table covered, splits of 256 positions, cut (to no fewer
  than 128) only where the (sequence, kv head, split) blocks would not
  reach one an SM on 132 SMs, one split (no merge) where the (sequence, kv
  head) blocks alone reach two an SM; pinned at Llama-3-8B's, Falcon-7B's and
  GPT-J-6B's decode shapes, the lengths an H100 sweep ran fastest.
- A plain split-then-merge in the kernel's order (each split's f32
  (acc, m, l) over its positions, splits past the sequence's end not read,
  B5's merge) at B2's split counts equals ``paged_decode_reference(...,
  p_f32=True)`` within 1e-6 in f32, and the JAX Pallas kernel in interpret
  mode at a GQA and a Falcon-like group within 1e-5.
- The one-byte pools' arithmetic of both kernels (rows widened to bf16
  exactly, the K row scale on the score's column, the V row scale on the
  probability's column) equals the plain versions' dequantize-then-multiply
  within 1e-5 in f32.
- A mirror of B3's block schedule (row -> (head, chunk row), longest
  first) covers every (head, chunk row) exactly once.
- The wrappers hand the C entry points the split count, the split length
  and f32 partials of the right shapes (none with one split).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shuffle_exchange_tpu_torch.inference import paged as tpaged

jpa = importlib.import_module("shuffle_exchange_tpu.ops.paged_attention")
tpa = importlib.import_module("shuffle_exchange_tpu_torch.ops.paged_attention")
tfd = importlib.import_module("shuffle_exchange_tpu_torch.ops.fused_decode")

T = torch.from_numpy
NEG = -1e30
SMS = 132
# (label, B, KV, W, bs): the decode shapes B2 serves
DECODE_SHAPES = [("llama-3-8b", 8, 8, 16, 64), ("falcon-7b", 8, 1, 32, 64),
                 ("gpt-j-6b", 8, 16, 32, 64), ("one row", 1, 8, 16, 64),
                 ("bs 16", 5, 8, 4, 16), ("falcon-7b one row", 1, 1, 32, 64),
                 ("long table", 8, 1, 64, 64), ("llama-3-8b x16", 16, 8, 16, 64)]
# (splits, split length) the H100 sweep ran fastest at (or within 3% of)
PINNED = {"llama-3-8b": (4, 256), "falcon-7b": (16, 128), "gpt-j-6b": (8, 256),
          "falcon-7b one row": (16, 128)}


@pytest.mark.parametrize("label,B,KV,W,bs", DECODE_SHAPES, ids=[s[0] for s in DECODE_SHAPES])
def test_decode_split_rule(label, B, KV, W, bs):
    S, L = tpa.decode_splits(B, KV, W, bs, SMS)
    P = W * bs
    assert S == 1 or L % tpa.DECODE_SPLIT_UNIT == 0
    assert S * L >= P and (S - 1) * L < P            # covered, none empty
    if S > 1:
        assert B * KV < 2 * SMS and tpa.DECODE_SPLIT_MIN <= L <= tpa.DECODE_SPLIT_LEN
        # cut below 256 only where 256 leaves the grid under one block an SM
        assert L == tpa.DECODE_SPLIT_LEN or B * KV * -(-P // tpa.DECODE_SPLIT_LEN) < SMS
        # and only as far as one block an SM, or the floor of 128
        assert B * KV * S >= SMS or L == tpa.DECODE_SPLIT_MIN
    else:   # the (sequence, kv head) blocks fill the card, or one split is all there is
        assert B * KV >= 2 * SMS or P <= tpa.DECODE_SPLIT_LEN
    assert (S, L) == PINNED.get(label, (S, L))


def test_decode_split_rule_one_split_when_the_grid_fills_the_card():
    assert tpa.decode_splits(40, 8, 16, 64, SMS) == (1, 1024)   # 320 blocks >= 264
    assert tpa.decode_splits(33, 8, 7, 16, SMS) == (1, 112)
    assert tpa.decode_splits(32, 8, 16, 64, SMS) == (4, 256)    # 256 < 264
    # B5's rule (split_count stays in fused_decode.py) is unchanged
    assert tfd.split_count(32, 7) == (7, 5) and tfd.split_count(16, 40) == (16, 1)


def split_merge_decode(q, ck, cv, table, kv_len, splits, split_len, slopes=None,
                       k_scale=None, v_scale=None):
    """B2's arithmetic in plain PyTorch, f32: split s holds positions
    [s * L, min(len, (s + 1) * L)); its (acc, m, l) with masked scores -1e30
    and masked probabilities exactly 0; splits at or past len are not
    written and not read; the merge of the first ceil(len / L) splits."""
    B, _, H, Dh = q.shape
    KV, bs = ck.shape[1], ck.shape[2]
    G = H // KV
    W = table.shape[1]
    k, v = tpa.gather_kv(ck, cv, table, k_scale, v_scale)
    k, v = k.float(), v.float()
    qf = q.float().reshape(B, KV, G, Dh) * Dh ** -0.5
    out = torch.zeros(B, KV, G, Dh)
    for b in range(B):
        n = min(int(kv_len[b]), W * bs)
        parts = []
        for s in range(splits):
            lo, hi = s * split_len, min(n, (s + 1) * split_len)
            if lo >= hi:
                continue
            pos = torch.arange(lo, min((s + 1) * split_len, W * bs))
            sc = torch.einsum("kgd,pkd->kgp", qf[b], k[b, pos])
            if slopes is not None:
                sc = sc + slopes.float().reshape(KV, G, 1) * pos.float()
            valid = pos < hi
            sc = torch.where(valid, sc, torch.full_like(sc, NEG))
            m = sc.amax(-1)
            p = torch.where(valid, torch.exp(sc - m[..., None]), torch.zeros_like(sc))
            parts.append((m, p.sum(-1), torch.einsum("kgp,pkd->kgd", p, v[b, pos])))
        if not parts:
            continue
        mg = torch.stack([m for m, _, _ in parts]).amax(0)
        l, o = torch.zeros_like(mg), torch.zeros(KV, G, Dh)
        for m, ls, acc in parts:
            w = torch.exp(m - mg)
            l = l + w * ls
            o = o + w[..., None] * acc
        out[b] = o / l.clamp_min(1e-30)[..., None]
    return out.reshape(B, 1, H, Dh)


def _decode_case(H, KV, Dh, lens, bs, seed):
    rng = np.random.default_rng(seed)
    nb = [-(-int(n) // bs) for n in lens]
    W = 2 * max(nb)                      # half the table past every sequence's end
    nblk = 1 + sum(nb)
    ids = rng.permutation(np.arange(1, nblk)).tolist()
    table = np.full((len(lens), W), -1, np.int32)
    for b, n in enumerate(nb):
        table[b, :n] = [ids.pop() for _ in range(n)]
    ck = rng.standard_normal((nblk, KV, bs, Dh)).astype(np.float32)
    cv = rng.standard_normal((nblk, KV, bs, Dh)).astype(np.float32)
    q = rng.standard_normal((len(lens), 1, H, Dh)).astype(np.float32)
    return q, ck, cv, table, np.asarray(lens, np.int32)


# (label, H, KV, Dh, lens, bs, SMs): B2's split counts at a GQA group and at
# Falcon's (71 over one kv head), a sequence that ends inside its first
# split, MHA with a one-position sequence
MERGE_CASES = [("gqa 8/2x32", 8, 2, 32, [37, 100, 5], 16, SMS),
               ("falcon 71/1x16", 71, 1, 16, [90, 17, 64], 16, SMS),
               ("mha 4x16", 4, 4, 16, [1, 300], 8, 16)]


@pytest.mark.parametrize("alibi", [False, True])
@pytest.mark.parametrize("label,H,KV,Dh,lens,bs,sms", MERGE_CASES,
                         ids=[c[0] for c in MERGE_CASES])
def test_split_then_merge_equals_the_plain_decode(label, H, KV, Dh, lens, bs, sms, alibi):
    q, ck, cv, table, kvl = _decode_case(H, KV, Dh, lens, bs, seed=H + Dh)
    W = table.shape[1]
    S, L = tpa.decode_splits(len(lens), KV, W, bs, sms)
    assert S > 1 and (S - 1) * L >= min(lens)       # some split lies past a sequence's end
    slopes = T(np.linspace(0.5, 0.01, H).astype(np.float32)) if alibi else None
    want = tpa.paged_decode_reference(T(q), T(ck), T(cv), T(table), T(kvl), p_f32=True,
                                      alibi_slopes=slopes)
    for splits, split_len in ((S, L), (W * bs // 16, 16), (1, W * bs)):
        got = split_merge_decode(T(q), T(ck), T(cv), T(table), T(kvl), splits, split_len,
                                 slopes)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=1e-6)
    if not alibi and label != "mha 4x16":
        jwant = jpa.paged_decode_attention_pallas(
            jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(table),
            jnp.asarray(kvl), interpret=True)
        np.testing.assert_allclose(
            split_merge_decode(T(q), T(ck), T(cv), T(table), T(kvl), S, L).numpy(),
            np.asarray(jwant), rtol=1e-5, atol=1e-5)
    # the bite: a split whose last position is dropped
    bad = split_merge_decode(T(q), T(ck), T(cv), T(table), T(kvl - 1), S, L, slopes)
    assert not np.allclose(bad.numpy(), want.numpy(), rtol=1e-6, atol=1e-6)


def _widened(x):
    """Stored one-byte values as the kernels widen them: bf16, exactly."""
    w = x.float().bfloat16().float()
    assert torch.equal(w, x.float())
    return w


@pytest.mark.parametrize("fmt", ["int8", "fp8"])
def test_one_byte_pools_scale_columns(fmt):
    """B2 / B3 over a one-byte pool: S = q . widen(kq) times the K row scale
    on the score's column, P times the V row scale on its column before P V;
    equal to the plain versions' float(q) * scale within 1e-5 in f32."""
    dtype = torch.int8 if fmt == "int8" else torch.float8_e4m3fn
    H, KV, Dh, bs, C = 8, 2, 32, 16, 5
    rng = np.random.default_rng(7)
    start = np.asarray([20, 0], np.int32)
    nnew = np.asarray([5, 3], np.int32)
    q, ck, cv, table, _ = _decode_case(H, KV, Dh, start + nnew, bs, seed=11)
    (kq, ks), (vq, vs) = (tpaged.quantize_kv(T(a), dtype) for a in (ck, cv))
    eq = T(rng.standard_normal((2, C, H, Dh)).astype(np.float32))
    want = tpa.paged_extend_reference(eq, kq, vq, T(table), T(start), T(nnew), p_f32=True,
                                      k_scale=ks, v_scale=vs)
    # the kernel's order: raw rows gathered, widened, scales applied to S / P columns
    k, v = tpa.gather_kv(_widened(kq), _widened(vq), T(table))
    ksg, vsg = tpa.gather_kv(ks[..., None], vs[..., None], T(table))
    G, S = H // KV, k.shape[1]
    qf = eq.reshape(2, C, KV, G, Dh)
    sc = torch.einsum("bckgd,bskd->bckgs", qf, k) * Dh ** -0.5
    sc = sc * ksg[..., 0].permute(0, 2, 1)[:, None, :, None, :]
    lim = T(start)[:, None].long() + torch.arange(C)[None] + 1
    valid = (torch.arange(S)[None, None] < lim[..., None])[:, :, None, None, :]
    sc = torch.where(valid, sc, torch.full_like(sc, NEG))
    p = torch.where(valid, torch.exp(sc - sc.amax(-1, keepdim=True)), torch.zeros_like(sc))
    l = p.sum(-1, keepdim=True)
    pv = p * vsg[..., 0].permute(0, 2, 1)[:, None, :, None, :]
    got = (torch.einsum("bckgs,bskd->bckgd", pv, v) / l).reshape(2, C, H, Dh)
    for b, n in enumerate(nnew):
        np.testing.assert_allclose(got[b, :n].numpy(), want[b, :n].numpy(), rtol=1e-5,
                                   atol=1e-5)


def extend_schedule(B, KV, G, C, rows=64):
    """B3's blocks in issue order: (b, kv, [(head g, chunk row c) of each
    row, None for a padding row]), the C entry point's TC / RT / NZ and the
    kernel's head_of / row_of."""
    TC = rows // G if G <= rows else 1
    RT = G * TC if G <= rows else rows
    GT = G * TC
    total = -(-C // TC) * GT
    NZ = -(-total // RT)
    blocks = []
    for x in range(B * KV * NZ):
        bk, z = x % (B * KV), NZ - 1 - x // (B * KV)
        u0 = z * RT
        R = min(RT, total - u0)
        assert R > 0
        cells = []
        for r in range(rows):
            if r >= R:
                cells.append(None)
                continue
            g, c = (u0 + r) % GT // TC, (u0 + r) // GT * TC + (u0 + r) % GT % TC
            cells.append((g, c) if c < C else None)
        c_first = u0 // GT * TC
        c_last = min((u0 + R - 1) // GT * TC + TC, C) - 1
        assert all(c_first <= c <= c_last for cell in cells if cell for c in [cell[1]])
        blocks.append((bk // KV, bk % KV, cells, c_last))
    return blocks


@pytest.mark.parametrize("C", [1, 37, 256])
@pytest.mark.parametrize("G", [1, 4, 8, 65, 71])
def test_extend_schedule_covers_every_row_once_longest_first(G, C):
    B, KV = 2, 3
    blocks = extend_schedule(B, KV, G, C)
    seen = {}
    for b, kv, cells, _ in blocks:
        for cell in cells:
            if cell is not None:
                key = (b, kv, *cell)
                seen[key] = seen.get(key, 0) + 1
    want = {(b, kv, g, c) for b in range(B) for kv in range(KV) for g in range(G)
            for c in range(C)}
    assert set(seen) == want and set(seen.values()) == {1}
    lasts = [c_last for _, _, _, c_last in blocks]
    assert lasts == sorted(lasts, reverse=True)       # the longest blocks go first
    if G > 64:    # a block spans at most two chunk rows
        assert all(len({cell[1] for cell in cells if cell}) <= 2 for _, _, cells, _ in blocks)


class _Lib:   # records each C call's arguments
    def __init__(self, calls):
        self.calls = calls

    def __getattr__(self, name):
        return lambda *args: self.calls.setdefault(name, args) and 0


@pytest.mark.parametrize("B,KV,splits", [(8, 1, 16), (8, 8, 4), (40, 8, 1)])
def test_wrappers_hand_the_c_entry_points_splits_and_partials(monkeypatch, B, KV, splits):
    calls, made = {}, {}
    lib = _Lib(calls)
    monkeypatch.setattr(tpa, "_lib", lambda: lib)
    monkeypatch.setattr(tpa, "pool_kind", lambda *a: 0)
    monkeypatch.setattr(tpa, "_sms", lambda dev: SMS)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: type("S", (), {"cuda_stream": 0}))
    real_empty = torch.empty

    def empty(*shape, **kw):
        t = real_empty(*shape, **kw)
        made[t.data_ptr()] = (tuple(t.shape), t.dtype)
        return t

    monkeypatch.setattr(torch, "empty", empty)
    H, Dh, bs = (71, 64, 64) if KV == 1 else (32, 128, 64)
    W = 32 if KV == 1 else 16
    q = torch.zeros(B, 1, H, Dh, dtype=torch.bfloat16)
    pool = torch.zeros(2, KV, bs, Dh, dtype=torch.bfloat16)
    table = torch.ones(B, W, dtype=torch.int32)
    lens = torch.full((B,), W * bs, dtype=torch.int32)
    assert tpa._launch("decode", q, pool, pool, table, lens).shape == q.shape
    args = calls["sxt_paged_decode"]
    assert len(args) == len(tpa._SIGNATURES["sxt_paged_decode"])
    S, L = tpa.decode_splits(B, KV, W, bs, SMS)
    assert S == splits
    assert args[12:22] == (0, B, H, KV, Dh, bs, W, S, L, Dh ** -0.5)
    if S == 1:
        assert args[9:12] == (None, None, None)
    else:   # acc [B, S, H, Dh], then m and l [B, S, H], in one f32 buffer
        rows = B * S * H
        assert made[args[9]] == ((rows * (Dh + 2),), torch.float32)
        assert args[10:12] == (args[9] + 4 * rows * Dh, args[9] + 4 * rows * (Dh + 1))
    eq = torch.zeros(2, 8, H, Dh, dtype=torch.bfloat16)
    assert tpa._launch("extend", eq, pool, pool, table[:2], lens[:2]).shape == eq.shape
    args = calls["sxt_paged_extend"]
    assert len(args) == len(tpa._SIGNATURES["sxt_paged_extend"])
    assert args[9:18] == (0, 2, 8, H, KV, Dh, bs, W, Dh ** -0.5)
