"""The ALiBi flash kernels redesigned for Hopper (B11 forward, B12 dq, B13
dk/dv + dslope: the ALiBi instances of the dense flash kernels'
warp-specialised wgmma bodies, ``ops/csrc/wgmma_flash.cuh``, wrapped in
``ops/csrc/alibi_attention.cu``), on the CPU: what of their design can be
held without the card. The mirrors and schedules are those of
``test_torch_flash_redesign.py`` with the ALiBi form switched on.

- Each ALiBi instance's shared memory (head dims 64 and 128; the dk/dv
  pass with the dslope partials' 32 bytes) equals the CUDA source's
  ``Wg*`` structs' and fits an H100 block.
- The schedules with the bottom-right diagonal (off = S - T; T == S,
  ragged T, T < S; n_rep 1 and 2): the blocks in chunks of 16 (sequence,
  kv head) groups, longest first within a chunk, every (sequence, head,
  query tile) and (sequence, kv head, key tile) once; each consumer's
  live key tiles cover every key
  j <= i + off of its rows and skip only tiles wholly above that
  diagonal; the dk/dv iterations visit each (query head, query tile at or
  below the shifted diagonal) once, heads ascending, at the query split
  (128) and the key split (64).
- An f32 mirror of the new arithmetic (the bias at the absolute key in the
  log2-domain FMA, masked P exactly 0, queries past T at lse +1e30, the
  dslope partials per (sequence, head, 64-key tile) summed in the
  wrapper's order) equals JAX ``_alibi_flash_fwd_impl`` and
  ``_flash_bwd_impl`` in interpret mode (out, lse, dq, dk, dv within
  1e-5; dslope within 1e-5 of the root-sum-square of its terms dS_ij * j),
  at head dims 64 and 128, MHA, GQA, T < S and ragged T; mirrors broken
  the three ways the card check bites (flipped slopes, the top-left
  diagonal, a zero dslope) miss.
- The wrappers hand the C entry points the slopes, T and S (the offset),
  the dslope partial buffer or null (``need_dslope``); the removed
  mma.sync kernels' names are gone from the sources; a profile names the
  new kernels B11 / B12 / B13.
"""

import importlib
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_flash_redesign import (KNOWN_SMEM, SMEM_LIMIT, WG_ROWS, _Lib, _source_tiles,
                                       dkv_iterations, key_split_live, live_tiles,
                                       mirror_backward, mirror_forward, wgmma_smem_bytes,
                                       wgmma_tiles)

from shuffle_exchange_tpu_torch.models import alibi_slopes

jalibi = importlib.import_module("shuffle_exchange_tpu.ops.alibi_attention")
tal = importlib.import_module("shuffle_exchange_tpu_torch.ops.alibi_attention")
CSRC = Path(tal.__file__).parent / "csrc"
T_ = torch.from_numpy
HEAD_DIMS = (64, 128)
RED_BYTES = 32   # the dk/dv pass's dslope partials: one f32 for each of 8 consumer warps
CHUNK = 16       # (sequence, kv head) groups a chunk of the ALiBi block orders (kAlibiChunk)


def alibi_fwd_blocks(B, T, H, KV, BM):
    """The forward's and the dq pass's blocks in issue order, (b, h, qt):
    the kernels' ``alibi_block_of_rows``: chunks of CHUNK (sequence, kv
    head) groups, within a chunk by query tile (longest first), then
    group, then the group's query heads."""
    G, nqt, n = H // KV, -(-T // BM), B * KV
    blocks = []
    for x in range(n * nqt * G):
        chunk, rem = divmod(x, CHUNK * nqt * G)
        groups = min(CHUNK, n - chunk * CHUNK)
        rank, at = divmod(rem, groups * G)
        grp = chunk * CHUNK + at // G
        blocks.append((grp // KV, grp % KV * G + at % G, nqt - 1 - rank))
    return blocks


def alibi_dkv_blocks(B, S, KV, BN):
    """The dk/dv pass's blocks in issue order, (b, kv head, key tile): the
    kernels' ``alibi_block_of_keys``: chunks of CHUNK groups, within a
    chunk by key tile (tile 0, with the most query tiles, first)."""
    nkt, n = -(-S // BN), B * KV
    blocks = []
    for x in range(n * nkt):
        chunk, rem = divmod(x, CHUNK * nkt)
        groups = min(CHUNK, n - chunk * CHUNK)
        kt, at = divmod(rem, groups)
        grp = chunk * CHUNK + at
        blocks.append((grp // KV, grp % KV, kt))
    return blocks


def _chunks(blocks, n_groups, per_group):
    """The issue order cut into its chunks of CHUNK groups."""
    out, start = [], 0
    for c0 in range(0, n_groups, CHUNK):
        size = min(CHUNK, n_groups - c0) * per_group
        out.append(blocks[start:start + size])
        start += size
    return out


# ---------------------------------------------------------------------------
# Shared memory
# ---------------------------------------------------------------------------


SMEM_CASES = [(which, dh, dslope) for dh in HEAD_DIMS for which in ("fwd", "dq", "dkv")
              for dslope in ((False, True) if which == "dkv" else (False,))]


@pytest.mark.parametrize("which,dh,dslope", SMEM_CASES,
                         ids=[f"{w}-{d}{'-dslope' if s else ''}" for w, d, s in SMEM_CASES])
def test_alibi_instances_shared_memory_matches_the_source(which, dh, dslope):
    """The ALiBi instances are the dense bodies': the same blocks, plus
    the dk/dv pass's 8 f32 partials after its mbarriers when it writes
    dslope (the launcher asks for SMEM + RED_BYTES then)."""
    src = _source_tiles({"fwd": "WgFwd", "dq": "WgDq", "dkv": "WgDkv"}[which], dh)
    smem = wgmma_smem_bytes(which, dh) + (RED_BYTES if dslope else 0)
    assert src["SMEM"] + (src["RED_BYTES"] if dslope else 0) == smem
    assert smem == KNOWN_SMEM[(which, dh)] + (RED_BYTES if dslope else 0)
    assert smem <= SMEM_LIMIT
    if which == "dkv":   # the key split at 64, the query split at 128
        assert src["KEY_SPLIT"] == (dh == 64) and src["RED_BYTES"] == RED_BYTES
    text = (CSRC / "alibi_attention.cu").read_text()
    assert "Sh::SMEM + (DSLOPE ? Sh::RED_BYTES : 0)" in text


# ---------------------------------------------------------------------------
# Schedules with the bottom-right diagonal
# ---------------------------------------------------------------------------

# (T, S): T == S on and off tile boundaries, ragged T (BLOOM trains at
# T = S = 2047 after the label shift), T < S with offsets on and off a tile
SCHEDULE_SHAPES = [(1, 1), (37, 37), (128, 128), (200, 200), (255, 255), (64, 200),
                   (77, 300), (129, 130), (1, 300)]


@pytest.mark.parametrize("dh", HEAD_DIMS)
@pytest.mark.parametrize("T,S", SCHEDULE_SHAPES, ids=[f"{t}x{s}" for t, s in SCHEDULE_SHAPES])
@pytest.mark.parametrize("B,H,KV", [(2, 4, 2), (3, 16, 8)], ids=["one-chunk", "two-chunks"])
def test_forward_and_dq_tiles_cover_every_visible_key(dh, T, S, B, H, KV):
    """Every (sequence, head, query tile) once, longest first within a
    chunk of 16 (sequence, kv head) groups, the chunks in group order; a
    consumer's live key tiles hold every key j <= i + off of its rows (and
    keys up to S only), and the tiles it skips lie wholly above its rows'
    diagonal."""
    off = S - T
    for which in ("fwd", "dq"):
        BM, BN, _ = wgmma_tiles(dh)[which]
        blocks = alibi_fwd_blocks(B, T, H, KV, BM)
        assert sorted(blocks) == sorted({(b, h, qt) for b in range(B) for h in range(H)
                                         for qt in range(-(-T // BM))})
        assert len(blocks) == len(set(blocks))
        G = H // KV
        groups = [{(b * KV + h // G) for b, h, _ in c}
                  for c in _chunks(blocks, B * KV, -(-T // BM) * G)]
        assert groups == [set(range(c0, min(c0 + CHUNK, B * KV)))
                          for c0 in range(0, B * KV, CHUNK)]
        for chunk in _chunks(blocks, B * KV, -(-T // BM) * G):
            loads = [live_tiles(qt * BM, T, S, True, BM, BN, off)[0] for _, _, qt in chunk]
            assert loads == sorted(loads, reverse=True)
        for qt in range(-(-T // BM)):
            for w in range(BM // WG_ROWS):
                r0 = qt * BM + w * WG_ROWS
                n_kv, live = live_tiles(r0, T, S, True, BM, BN, off)
                assert n_kv <= -(-S // BN) and live == list(range(len(live)))
                seen = {j * BN + c for j in live for c in range(BN)}
                for r in range(r0, min(r0 + WG_ROWS, T)):
                    assert set(range(min(r + off + 1, S))) <= seen
                for j in set(range(n_kv)) - set(live):
                    assert j * BN > r0 + WG_ROWS - 1 + off


@pytest.mark.parametrize("split", ["query", "key"])
@pytest.mark.parametrize("T,S", SCHEDULE_SHAPES, ids=[f"{t}x{s}" for t, s in SCHEDULE_SHAPES])
@pytest.mark.parametrize("n_rep", [1, 2])
def test_dkv_iterations_visit_every_query_tile_below_the_shifted_diagonal(split, T, S, n_rep):
    """For each key tile: every (query head of the group, query tile with a
    query that sees one of the tile's keys) once, heads ascending, query
    tiles ascending; the first query tile is max(0, (k0 - off) / 64). Under
    the key split each consumer's 64 keys are covered once and it skips
    only query tiles wholly above its keys' diagonal."""
    BN = 64 if split == "query" else 128
    kvh, off, BQ = 1, S - T, 64
    owners = np.zeros(S, np.int64)
    nkt = -(-S // BN)
    for B, KV in ((1, 2), (3, 8)):   # one chunk of groups; two, the second partial
        blocks = alibi_dkv_blocks(B, S, KV, BN)
        assert sorted(blocks) == [(b, g, kt) for b in range(B) for g in range(KV)
                                  for kt in range(nkt)]
        for chunk in _chunks(blocks, B * KV, nkt):   # key tile 0 (the most query tiles) first
            assert [kt for _, _, kt in chunk] == sorted(kt for _, _, kt in chunk)
    for kt in range(-(-S // BN)):
        k0 = kt * BN
        its = dkv_iterations(kt, kvh, n_rep, T, True, BQ, BN, off)
        assert its == sorted(its) and len(its) == len(set(its)) >= n_rep
        assert its[0][1] == max(0, int((k0 - off) / BQ))   # C's division, toward zero
        for w in range(BN // WG_ROWS):
            kw0 = k0 + w * WG_ROWS
            live = key_split_live(its, kw0, True, BQ, off) if split == "key" else its
            for _, qt in set(its) - set(live):   # skipped: every query before every key
                assert qt * BQ + BQ - 1 + off < kw0
            for key in range(kw0, min(kw0 + WG_ROWS, S)):
                owners[key] += 1
                for g in range(n_rep):
                    tiles = {qt for h, qt in live if h == kvh * n_rep + g}
                    assert {i // BQ for i in range(max(0, key - off), T)} <= tiles
    assert (owners == 1).all()


# ---------------------------------------------------------------------------
# The arithmetic, mirrored in f32, against the TPU kernels in interpret mode
# ---------------------------------------------------------------------------

# (B, T, S, H, KV, Dh)
CASES = [(1, 256, 256, 2, 2, 128), (1, 256, 256, 4, 2, 64), (1, 192, 320, 2, 1, 128),
         (2, 77, 77, 4, 2, 64), (1, 77, 200, 2, 2, 128)]
CASE_IDS = ["mha-128", "gqa-64", "t<s-gqa-128", "ragged-gqa-64", "ragged-t<s-128"]


def _inputs(B, T, S, H, KV, Dh, seed):
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal(s).astype(np.float32)
                   for s in ((B, T, H, Dh), (B, S, KV, Dh), (B, S, KV, Dh), (B, T, H, Dh)))
    # BLOOM's slopes, scaled so that the bias matters at these lengths
    return q, k, v, (alibi_slopes(H) * 0.25).astype(np.float32), do


def _jax(q, k, v, slopes, do):
    """(out, lse, dq, dk, dv, dslope) of the TPU kernels in interpret mode."""
    jq, jk, jv, js, jdo = (jnp.asarray(a) for a in (q, k, v, slopes, do))
    out, lse = jalibi._alibi_flash_fwd_impl(jq, jk, jv, js, True, True)
    grads = jalibi._flash_bwd_impl(jq, jk, jv, js, out, lse, jdo, None, True, True)
    return [np.asarray(x) for x in (out, lse, *grads)]


def _dslope_rss(q, k, v, slopes, do, out, lse):
    """Per head, the root-sum-square of dslope's terms dS_ij * j."""
    tq, tk, tv, ts, tdo = (T_(a) for a in (q, k, v, slopes, do))
    p = torch.exp(tal._alibi_logits(tq, tk, ts, True) - lse[..., None])
    G = q.shape[2] // k.shape[2]
    dp = torch.einsum("bthd,bshd->bhts", tdo, tv.repeat_interleave(G, 2))
    delta = (tdo * out).sum(-1).permute(0, 2, 1)
    ds = p * (dp - delta[..., None])
    return (ds * torch.arange(k.shape[1]).float()).pow(2).sum(dim=(0, 2, 3)).sqrt().numpy()


def _mirror(q, k, v, slopes, do, **broken):
    tq, tk, tv, ts, tdo = (T_(a) for a in (q, k, v, slopes, do))
    out, lse = mirror_forward(tq, tk, tv, True, slopes=ts, **broken)
    grads = mirror_backward(tq, tk, tv, out, tdo, lse, True, slopes=ts, **broken)
    return [out, lse, *grads]


NAMES = ("out", "lse", "dq", "dk", "dv", "dslope")


def _misses(got, want, rss):
    """The names whose tolerance the mirror's results miss."""
    bad = [n for n, g, w in zip(NAMES[:5], got, want)
           if not np.allclose(g.numpy(), w, rtol=1e-5, atol=1e-5)]
    if not (np.abs(np.asarray(got[5]) - want[5]) <= 1e-5 * rss).all():
        bad.append("dslope")
    return bad


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_mirror_matches_the_tpu_kernels_in_interpret_mode(case):
    q, k, v, slopes, do = _inputs(*case, seed=sum(case))
    got = _mirror(q, k, v, slopes, do)
    want = _jax(q, k, v, slopes, do)
    for name, g, w in zip(NAMES[:5], got, want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-5, err_msg=name)
    rss = _dslope_rss(q, k, v, slopes, do, got[0], got[1])
    assert (rss > 0).all()
    np.testing.assert_array_less(np.abs(got[5].numpy() - want[5]), 1e-5 * rss + 1e-30)


@pytest.mark.parametrize("bite", ["flipped slopes", "top-left diagonal", "zero dslope"])
def test_broken_mirrors_miss(bite):
    """The three ways the card check bites, each against the mirror's own
    tolerances: flipped slopes and the top-left diagonal (at T < S) miss
    out, lse and every gradient; a zero dslope misses in every head."""
    q, k, v, slopes, do = _inputs(*CASES[2], seed=sum(CASES[2]))
    want = _jax(q, k, v, slopes, do)
    if bite == "zero dslope":
        got = _mirror(q, k, v, slopes, do)
        rss = _dslope_rss(q, k, v, slopes, do, got[0], got[1])
        assert _misses(got, want, rss) == []
        assert not (np.abs(want[5]) <= 1e-5 * rss).any()
        return
    broken = (_mirror(q, k, v, slopes[::-1].copy(), do) if bite == "flipped slopes"
              else _mirror(q, k, v, slopes, do, off=0))
    rss = _dslope_rss(q, k, v, slopes, do, broken[0], broken[1])
    assert _misses(broken, want, rss) == list(NAMES)


# ---------------------------------------------------------------------------
# The C arguments and the sources
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dh", HEAD_DIMS)
@pytest.mark.parametrize("need_dslope", [True, False])
def test_wrappers_hand_the_c_entry_points_slopes_offset_and_partials(monkeypatch, dh,
                                                                     need_dslope):
    calls, made = {}, {}
    monkeypatch.setattr(tal, "_lib", lambda: _Lib(calls))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: type("S", (), {"cuda_stream": 0}))
    real_empty = torch.empty

    def empty(*shape, **kw):
        t = real_empty(*shape, **kw)
        made[t.data_ptr()] = (tuple(t.shape), t.dtype)
        return t

    monkeypatch.setattr(torch, "empty", empty)
    B, T, S, H, KV = 2, 37, 100, 8, 2
    q = torch.zeros(B, T, H, dh, dtype=torch.bfloat16)
    k = torch.zeros(B, S, KV, dh, dtype=torch.bfloat16)
    v = torch.zeros(B, S, KV, dh, dtype=torch.bfloat16)
    slopes = torch.from_numpy(alibi_slopes(H))
    out, lse = tal._launch(q, k, v, slopes, want_lse=True)
    args = calls["sxt_alibi_fwd_bf16"]
    assert args[:6] == (q.data_ptr(), k.data_ptr(), v.data_ptr(), slopes.data_ptr(),
                        out.data_ptr(), lse.data_ptr())
    assert made[args[5]] == ((B, H, T), torch.float32)
    # T and S: the kernels take the bottom-right offset S - T from them
    assert args[6:13] == (B, T, S, H, KV, dh, dh ** -0.5)
    tal._launch_bwd(q, k, v, slopes, out, lse, q, need_dslope)
    delta = calls["sxt_alibi_bwd_delta_bf16"]
    assert made[delta[2]] == ((B, H, T), torch.float32) and delta[3:7] == (B, T, H, dh)
    dkv = calls["sxt_alibi_bwd_dkv_bf16"]
    assert dkv[:7] == (q.data_ptr(), k.data_ptr(), v.data_ptr(), slopes.data_ptr(),
                       q.data_ptr(), lse.data_ptr(), delta[2])
    if need_dslope:   # one partial a (sequence, head, 64-key tile)
        assert made[dkv[9]] == ((B, H, -(-S // 64)), torch.float32)
    else:
        assert dkv[9] is None
    assert dkv[10:17] == (B, T, S, H, KV, dh, dh ** -0.5)
    dq = calls["sxt_alibi_bwd_dq_bf16"]
    assert dq[3] == slopes.data_ptr() and dq[6] == delta[2]
    assert dq[8:15] == (B, T, S, H, KV, dh, dh ** -0.5)


REMOVED = ("alibi_fwd_kernel", "alibi_bwd_delta_kernel", "alibi_bwd_dkv_kernel",
           "alibi_bwd_dq_kernel")


def test_the_mma_sync_alibi_kernels_are_gone():
    """B11-B13 are the wgmma bodies' ALiBi instances; the old mma.sync
    kernels and their delta kernel are gone from every source, and the
    ALiBi unit stages nothing by cp.async or ldmatrix itself."""
    sources = {f.name: f.read_text() for f in CSRC.glob("*.cu*")}
    for name in REMOVED:
        assert not [f for f, t in sources.items() if re.search(rf"\b{name}\b", t)], name
    alibi = sources["alibi_attention.cu"]
    for body, form in (("wg_fwd", "kAlibi"), ("wg_dq", "kAlibi"), ("wg_dkv", "F"),
                       ("wg_dkv_keys", "F")):
        assert f"{body}<DH, {form}>(" in alibi
    for call in ("mma_bf16(", "ldsm_x4(", "cp_async16(", "load_tile<", "flash_tile.cuh"):
        assert call not in alibi
    assert "flash_bwd_delta_kernel<DH>" in alibi   # the dense delta pass itself
    assert "kAlibi" not in sources["flash_attention.cu"]


def test_profiles_name_the_new_kernels():
    """chip_smoke's kernel kinds tell B11 / B12 / B13 from the dense flash
    kernels whose names theirs contain."""
    import chip_smoke

    kinds = {"void (anonymous namespace)::alibi_wg_fwd_kernel<128>(CUtensorMap_st)":
             "alibi_flash_attention (B11)",
             "alibi_wg_dq_kernel<64>": "alibi dq (B12)",
             "alibi_wg_dkv_kernel<128, (<unnamed>::Form)2>": "alibi dk/dv (B13)",
             "alibi_wg_dkv_keys_kernel<64, (<unnamed>::Form)1>": "alibi dk/dv (B13)",
             "wg_fwd_kernel<128>": "flash_attention (wgmma forward)",
             "wg_dkv_keys_kernel<64>": "flash_attention_bwd (wgmma dk/dv)"}
    for name, kind in kinds.items():
        assert chip_smoke._kernel_kind(name) == kind, name
    assert "alibi" not in chip_smoke._kernel_kind("flash_bwd_delta_kernel<128>")

