"""The split-K decode of the fused decode layer (B5) redesigned for Hopper
(``ops/csrc/fused_decode.cu`` over ``ops/csrc/paged_decode.cuh``: B2's
tensor-core decode body over JAX's table-entry splits, the merge folded into
the last split of each (sequence, kv head)), on the CPU: what of its design
can be held without the card.

- The default split rule (``fused_decode.attention_splits``): B2's
  positions per split (``paged_attention.decode_splits``) in whole table
  entries; pinned at Llama-3-8B's, Falcon-7B's and GPT-J-6B's decode shapes
  on 132 SMs; every split non-empty and the table covered, at those shapes
  and across a grid of batch, kv heads, widths and block sizes.
- A plain split-then-merge in the kernel's order (each live split's f32
  (acc, m, l) in the log2 domain, the one-byte pools' K scale on the
  score's column and V scale on the probability's column; live splits are
  those that start before the sequence's end, and split 0; one live split
  writes its output directly, else the last merges all of them in split
  order in base 2) equals ``fused_paged_decode_reference`` within 1e-6 in
  f32 (1e-5 with ALiBi slopes: the log2 domain's bias carries f32's
  rounding into the weights), and ``fused_paged_decode_attention_pallas(interpret=True)`` within
  1e-5 at a GQA group, a Falcon-like 71/1 group at a small head dim, with
  ALiBi slopes, and over int8 / e4m3 pools; a mirror that drops one split
  from the merge misses it.
- The merge folds into the last split only where a (sequence, kv head)'s
  partials are few and the grid about one wave (``folds``: at most 16K f32
  values and 4 blocks an SM); the wrapper hands
  ``sxt_fused_paged_decode`` the operands, the split count, the f32
  partials (one buffer) and then the int32 counters, zero and one per
  (sequence, kv head), kept per (device, stream); none of those with one
  split, and no counters when the merge runs as a second kernel.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shuffle_exchange_tpu_torch.inference import paged as tpaged

jfd = importlib.import_module("shuffle_exchange_tpu.ops.fused_decode")
tpa = importlib.import_module("shuffle_exchange_tpu_torch.ops.paged_attention")
tfd = importlib.import_module("shuffle_exchange_tpu_torch.ops.fused_decode")
dg = importlib.import_module("shuffle_exchange_tpu_torch.ops.decode_gemv")

T = torch.from_numpy
NEG = -1e30
LOG2E = 1.4426950408889634
SMS = 132
# (label, B, KV, W, bs): the decode shapes B5 serves (the chip smoke test's
# and the digest's cells: 8 rows to 2,048 positions, tables of 32 entries)
DECODE_SHAPES = [("llama-3-8b", 8, 8, 32, 64), ("falcon-7b", 8, 1, 32, 64),
                 ("gpt-j-6b", 8, 16, 32, 64), ("llama-3-8b 1024", 8, 8, 16, 64),
                 ("one row", 1, 8, 32, 64), ("bs 16", 5, 8, 4, 16),
                 ("bs 256", 8, 1, 8, 256), ("mha 32 rows", 32, 32, 32, 64)]
# split counts at B2's split lengths: 256 positions (4 entries of 64), 128 at
# Falcon-7B's 8 (sequence, kv head) blocks (2 entries)
PINNED = {"llama-3-8b": 8, "falcon-7b": 16, "gpt-j-6b": 8, "llama-3-8b 1024": 4}


@pytest.mark.parametrize("label,B,KV,W,bs", DECODE_SHAPES, ids=[s[0] for s in DECODE_SHAPES])
def test_default_split_rule(label, B, KV, W, bs):
    S = tfd.attention_splits(B, KV, W, bs, SMS)
    per = tpa.decode_splits(B, KV, W, bs, SMS)[1]
    spb = -(-W // S)
    assert tfd.split_count(W, S) == (S, spb)
    assert (S - 1) * spb < W <= S * spb                 # none empty, the table covered
    assert S == tfd.split_count(W, -(-W // max(1, per // bs)))[0]   # B2's length in entries
    assert spb <= max(1, per // bs)
    assert S == PINNED.get(label, S)
    if B * KV >= 2 * SMS:
        assert S == 1


@pytest.mark.parametrize("bs", [16, 64, 256])
def test_every_split_non_empty_and_the_table_covered(bs):
    for B in (1, 3, 8, 33):
        for KV in (1, 2, 8, 32):
            for W in (1, 2, 5, 16, 31, 64):
                S = tfd.attention_splits(B, KV, W, bs, SMS)
                spb = -(-W // S)
                assert 1 <= S <= W and (S - 1) * spb < W <= S * spb
                # at least B2's length in whole entries, rounded down, spread evenly
                per = tpa.decode_splits(B, KV, W, bs, SMS)[1]
                assert S == -(-W // max(1, per // bs)) or S == tfd.split_count(
                    W, -(-W // max(1, per // bs)))[0]


def kernel_order_decode(q, ck, cv, table, kv_len, splits, slopes=None, k_scale=None,
                        v_scale=None, drop_split=None):
    """B5's arithmetic in plain PyTorch, f32, in its order: split s holds the
    table entries [s * spb, (s + 1) * spb), positions [s * L, min(len, (s +
    1) * L)) with L = spb * bs; its (acc, m, l) with scores in the log2
    domain (the one-byte pools' K row scale on the score's column, the V
    row scale on the probability's column), masked probabilities exactly 0.
    Live splits: those that start before the end, and split 0; one live
    split writes its output directly, else the merge of all live splits in
    split order, base 2. ``drop_split`` leaves one split out of the merge
    (the bite)."""
    B, _, H, Dh = q.shape
    KV, bs = ck.shape[1], ck.shape[2]
    G, W = H // KV, table.shape[1]
    S, spb = tfd.split_count(W, splits)
    L = spb * bs
    if k_scale is None:
        k, v = tpa.gather_kv(ck, cv, table)
        ksg = vsg = None
    else:   # raw rows (exact in f32) and their scales, applied to columns
        k, v = tpa.gather_kv(ck.float(), cv.float(), table)
        ksg, vsg = (tpa.gather_kv(a[..., None], a[..., None], table)[0][..., 0]
                    for a in (k_scale, v_scale))
    k, v = k.float(), v.float()
    qf = q.float().reshape(B, KV, G, Dh)
    out = torch.zeros(B, KV, G, Dh)
    for b in range(B):
        n = min(int(kv_len[b]), W * bs)
        live = max(1, min(S, -(-n // L)))
        parts = []
        for s in range(live):
            pos = torch.arange(s * L, min((s + 1) * L, W * bs))
            sc = torch.einsum("kgd,pkd->kgp", qf[b], k[b, pos]) * (Dh ** -0.5 * LOG2E)
            if ksg is not None:
                sc = sc * ksg[b, pos].T[:, None, :]
            if slopes is not None:
                sc = sc + (slopes.float() * LOG2E).reshape(KV, G, 1) * pos.float()
            valid = pos < n
            sc = torch.where(valid, sc, torch.full_like(sc, NEG))
            m = sc.amax(-1)
            p = torch.where(valid, torch.exp2(sc - m[..., None]), torch.zeros_like(sc))
            pv = p if vsg is None else p * vsg[b, pos].T[:, None, :]
            parts.append((m, p.sum(-1), torch.einsum("kgp,pkd->kgd", pv, v[b, pos])))
        if live == 1:
            m, ls, acc = parts[0]
            out[b] = acc * (1.0 / ls.clamp_min(1e-30))[..., None]
            continue
        parts = [x for i, x in enumerate(parts) if i != drop_split]
        mg = parts[0][0]
        for m, _, _ in parts[1:]:
            mg = torch.maximum(mg, m)
        l, o = torch.zeros_like(mg), torch.zeros(KV, G, Dh)
        for m, ls, acc in parts:
            w = torch.exp2(m - mg)
            l = l + w * ls
            o = o + w[..., None] * acc
        out[b] = o / l.clamp_min(1e-30)[..., None]
    return out.reshape(B, 1, H, Dh)


def _case(H, KV, Dh, lens, bs, seed, fmt="f32"):
    """f32 q, pools (f32, or int8 / e4m3 with their scale planes) holding
    the sequences in shuffled blocks behind -1-padded tables half again as
    wide as the longest sequence needs."""
    rng = np.random.default_rng(seed)
    nb = [-(-int(n) // bs) for n in lens]
    W = max(1, max(nb)) * 3 // 2 + 1
    nblk = 1 + sum(nb)
    ids = rng.permutation(np.arange(1, nblk)).tolist()
    table = np.full((len(lens), W), -1, np.int32)
    for b, n in enumerate(nb):
        table[b, :n] = [ids.pop() for _ in range(n)]
    ck, cv = (rng.standard_normal((nblk, KV, bs, Dh)).astype(np.float32) for _ in range(2))
    q = rng.standard_normal((len(lens), 1, H, Dh)).astype(np.float32)
    sc = {}
    if fmt != "f32":
        dtype = torch.int8 if fmt == "int8" else torch.float8_e4m3fn
        (ck, ks), (cv, vs) = (tpaged.quantize_kv(T(a), dtype) for a in (ck, cv))
        sc = dict(k_scale=ks, v_scale=vs)
    else:
        ck, cv = T(ck), T(cv)
    return T(q), ck, cv, T(table), T(np.asarray(lens, np.int32)), sc


def _jax(q, ck, cv, table, lens, splits, slopes, sc):
    jsc = {}
    if sc:
        jdt = jnp.int8 if ck.dtype == torch.int8 else jnp.float8_e4m3fn
        ck, cv = (jnp.asarray(t.float().numpy()).astype(jdt) for t in (ck, cv))
        jsc = {k: jnp.asarray(v.numpy()) for k, v in sc.items()}
    else:
        ck, cv = jnp.asarray(ck.numpy()), jnp.asarray(cv.numpy())
    return np.asarray(jfd.fused_paged_decode_attention_pallas(
        jnp.asarray(q.numpy()), ck, cv, jnp.asarray(table.numpy()), jnp.asarray(lens.numpy()),
        alibi_slopes=None if slopes is None else jnp.asarray(slopes.numpy()),
        num_splits=splits, interpret=True, **jsc))


# (label, H, KV, Dh, lens, bs, fmt, alibi): a GQA group, a Falcon-like group of
# 71 over one kv head at a small head dim, ALiBi slopes, one-byte pools; a
# one-position sequence and sequences that end inside their first split
MIRROR_CASES = [("gqa 8/2x32", 8, 2, 32, [37, 100, 5], 16, "f32", False),
                ("falcon 71/1x16", 71, 1, 16, [90, 17, 64], 16, "f32", False),
                ("gqa alibi", 8, 2, 32, [1, 77, 120], 16, "f32", True),
                ("int8 4/2x32", 4, 2, 32, [33, 70, 2], 16, "int8", False),
                ("fp8 alibi 6/3x16", 6, 3, 16, [50, 9, 64], 8, "fp8", True)]


@pytest.mark.parametrize("label,H,KV,Dh,lens,bs,fmt,alibi", MIRROR_CASES,
                         ids=[c[0] for c in MIRROR_CASES])
def test_kernel_order_split_merge_matches_the_plain_version_and_jax(label, H, KV, Dh, lens, bs,
                                                                     fmt, alibi):
    q, ck, cv, table, kvl, sc = _case(H, KV, Dh, lens, bs, seed=H + Dh, fmt=fmt)
    W = table.shape[1]
    slopes = T(np.linspace(0.5, 0.01, H).astype(np.float32)) if alibi else None
    default = tfd.attention_splits(len(lens), KV, W, bs, SMS)
    for splits in sorted({1, 2, 3, W, default}):
        want = tfd.fused_paged_decode_reference(q, ck, cv, table, kvl, splits, slopes, **sc)
        got = kernel_order_decode(q, ck, cv, table, kvl, splits, slopes, **sc)
        # with slopes the log2-domain bias (up to ~86 here) carries f32's
        # rounding (~5e-6 of p) into the weights: 1e-5 there
        tol = 1e-5 if alibi else 1e-6
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=tol, atol=tol)
        if splits in (2, W):
            np.testing.assert_allclose(got.numpy(), _jax(q, ck, cv, table, kvl, splits, slopes,
                                                         sc), rtol=1e-5, atol=1e-5)
    # the bite: the longest sequence's merge without its last live split
    splits = W
    S, spb = tfd.split_count(W, splits)
    last = -(-max(lens) // (spb * bs)) - 1
    assert last >= 1
    bad = kernel_order_decode(q, ck, cv, table, kvl, splits, slopes, drop_split=last, **sc)
    want = tfd.fused_paged_decode_reference(q, ck, cv, table, kvl, splits, slopes, **sc)
    assert not np.allclose(bad.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)


def test_an_empty_sequence_gives_zeros_from_split_zero():
    """kv_len 0: split 0 is live, sees no key, and writes 0 (l = 0, out =
    0 / 1e-30), as the plain version does; a length-1 sequence reads one
    key."""
    q, ck, cv, table, kvl, _ = _case(4, 2, 16, [0, 1, 40], 8, seed=3)
    for splits in (1, 3):
        got = kernel_order_decode(q, ck, cv, table, kvl, splits)
        want = tfd.fused_paged_decode_reference(q, ck, cv, table, kvl, splits)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=1e-6)
        assert not got[0].any()


class _Lib:   # records each C call's arguments
    def __init__(self, calls):
        self.calls = calls

    def __getattr__(self, name):
        return lambda *args: self.calls.setdefault(name, args) and 0


@pytest.mark.parametrize("B,KV,G,Dh,splits,want",
                         [(8, 8, 4, 128, 8, True), (8, 1, 71, 64, 16, False),
                          (8, 16, 1, 256, 8, False), (8, 32, 1, 96, 8, False),
                          (8, 2, 8, 64, 11, True), (8, 8, 8, 64, 1, False),
                          (1, 8, 16, 128, 8, True), (1, 8, 16, 128, 9, False),
                          (66, 1, 1, 64, 8, True), (67, 1, 1, 64, 8, False)],
                         ids=["llama", "falcon", "gpt-j", "phi-3-mini", "gqa-16/2",
                              "one-split", "partials-at-the-limit", "partials-past-it",
                              "blocks-at-the-limit", "blocks-past-it"])
def test_the_merge_folds_where_the_partials_are_few_and_the_grid_one_wave(B, KV, G, Dh, splits,
                                                                          want):
    assert tfd.folds(B, KV, G, Dh, splits, SMS) is want
    assert want == (splits > 1 and G * Dh * splits <= tfd.FOLD_MAX_PARTIALS
                    and B * KV * splits <= tfd.FOLD_MAX_BLOCKS_PER_SM * SMS)


@pytest.mark.parametrize("fold", [None, True, False], ids=["auto", "fold", "merge-launch"])
@pytest.mark.parametrize("B,H,KV,Dh,W,num_splits,splits",
                         [(8, 71, 1, 64, 32, None, 16), (8, 32, 8, 128, 32, None, 8),
                          (8, 16, 16, 256, 32, None, 8), (40, 32, 8, 128, 16, None, 1),
                          (3, 8, 2, 96, 5, 3, 3), (3, 8, 2, 80, 5, 5, 5)],
                         ids=["falcon", "llama", "gpt-j", "one-split", "explicit-3", "per-entry"])
def test_wrapper_hands_the_c_entry_point_splits_partials_and_counters(monkeypatch, B, H, KV,
                                                                      Dh, W, num_splits,
                                                                      splits, fold):
    calls, made = {}, {}
    monkeypatch.setattr(tfd, "_lib", lambda: _Lib(calls))
    monkeypatch.setattr(tfd, "pool_kind", lambda *a: 0)
    monkeypatch.setattr(tfd, "_sms", lambda dev: SMS)
    monkeypatch.setattr(dg, "_COUNTERS", {})
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: type("S", (), {"cuda_stream": 7}))
    real_empty = torch.empty

    def empty(*shape, **kw):
        t = real_empty(*shape, **kw)
        made[t.data_ptr()] = (tuple(t.shape), t.dtype)
        return t

    monkeypatch.setattr(torch, "empty", empty)
    bs = 64
    q = torch.zeros(B, 1, H, Dh, dtype=torch.bfloat16)
    pool = torch.zeros(2, KV, bs, Dh, dtype=torch.bfloat16)
    table = torch.ones(B, W, dtype=torch.int32)
    lens = torch.full((B,), W * bs, dtype=torch.int32)
    out = tfd._launch_attention(q, pool, pool, table, lens, num_splits, fold=fold)
    assert out.shape == q.shape
    args = calls["sxt_fused_paged_decode"]
    assert len(args) == len(tfd._SIGNATURES["sxt_fused_paged_decode"])
    assert args[:3] == (q.data_ptr(), pool.data_ptr(), pool.data_ptr())
    assert args[3:5] == (None, None) and args[7] is None       # no scales, no slopes
    assert args[8] == out.data_ptr()
    assert args[13:] == (0, B, H, KV, Dh, bs, W, splits, Dh ** -0.5, 7)
    if splits == 1:
        assert args[9:13] == (None, None, None, None)
        return
    rows = B * splits * H   # acc [B, S, H, Dh], then m and l [B, S, H], in one f32 buffer
    assert made[args[9]] == ((rows * (Dh + 2),), torch.float32)
    assert args[10:12] == (args[9] + 4 * rows * Dh, args[9] + 4 * rows * (Dh + 1))
    if not (tfd.folds(B, KV, H // KV, Dh, splits, SMS) if fold is None else fold):
        assert args[12] is None
        return
    counters = dg._COUNTERS[(q.device, 7)]
    assert args[12] == counters.data_ptr()
    assert counters.dtype == torch.int32 and counters.numel() >= B * KV
    assert not counters.any()          # zero between calls: the kernel leaves them so
    # the next call on the same stream reuses them
    calls.clear()
    tfd._launch_attention(q, pool, pool, table, lens, num_splits, fold=fold)
    assert calls["sxt_fused_paged_decode"][12] == counters.data_ptr()
