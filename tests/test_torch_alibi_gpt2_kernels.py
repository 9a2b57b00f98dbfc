"""The serving kernels' ALiBi and bias forms (BLOOM and GPT-2 serving)
against the JAX package.

Each plain version in ``shuffle_exchange_tpu_torch/ops/paged_attention.py``
and ``ops/fused_decode.py`` meets its JAX Pallas kernel in interpret mode
(as ``tests/test_paged_attention.py`` and ``tests/test_fused_decode.py``
run them) on the same inputs, made with numpy from a seed:

- B2 / B3 with ALiBi slopes: MHA and GQA (the head-to-slope map ``h = kv *
  G + g`` shows only there), ragged lengths, block tables whose blocks lie
  in shuffled pool order and are padded with -1 (so the bias must follow
  the logical position, not the pool slot);
- B5 with slopes at split counts 1, 2 and 4 (a split starts mid-sequence);
- B4 with q/k/v biases and no RoPE, with and without a pool;
- B6 with layernorm + its bias + fc biases + ``gelu_new``, non-gated, and
  each of the five fusable activations.

f32 within 1e-5 (another summation order); bf16 within one bf16 step
(2^-7 of |want| plus 1e-5) against the kernels run on bf16 inputs, at the
kernels' own rounding points. The tolerance is shown to fail on flipped
slopes, slopes given to the wrong heads, zero slopes and dropped biases.
The CUDA kernels run only on the card (``chip_smoke.py`` phase 2j).
"""

import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shuffle_exchange_tpu.inference import engine as jengine
from shuffle_exchange_tpu.inference import paged as jpaged
from shuffle_exchange_tpu.models import transformer as jtf
from shuffle_exchange_tpu_torch.models import transformer as ttf

jpa = importlib.import_module("shuffle_exchange_tpu.ops.paged_attention")
jfd = importlib.import_module("shuffle_exchange_tpu.ops.fused_decode")
tpa = importlib.import_module("shuffle_exchange_tpu_torch.ops.paged_attention")
tfd = importlib.import_module("shuffle_exchange_tpu_torch.ops.fused_decode")

T = torch.from_numpy
F32_TOL = 1e-5


def _np(x):
    return np.asarray(x, np.float32)


def _bf16(x):
    """numpy f32 -> (torch bf16, jax bf16) holding the same values."""
    t = T(np.ascontiguousarray(x)).bfloat16()
    return t, jnp.asarray(t.float().numpy(), jnp.bfloat16)


def _one_bf16_step(got, want) -> bool:
    got, want = _np(got), _np(want)
    return bool((np.abs(got - want) <= 2 ** -7 * np.abs(want) + 1e-5).all())


def _scrambled(lens, bs, pad_blocks, rng):
    """A block table padded with -1 whose real blocks are a random
    permutation of 1..n: consecutive logical blocks lie anywhere in the
    pool (block 0 is scratch)."""
    nb = [-(-int(n) // bs) for n in lens]
    ids = rng.permutation(np.arange(1, 1 + sum(nb))).tolist()
    table = np.full((len(lens), max(nb) + pad_blocks), -1, np.int32)
    for b, n in enumerate(nb):
        table[b, :n] = [ids.pop() for _ in range(n)]
    return table, 1 + sum(nb)


def _decode_inputs(lens, H, KV, seed, Dh=32, bs=16, pad_blocks=2):
    rng = np.random.default_rng(seed)
    table, nblk = _scrambled(lens, bs, pad_blocks, rng)
    ck, cv = (rng.standard_normal((nblk, KV, bs, Dh)).astype(np.float32) for _ in range(2))
    q = rng.standard_normal((len(lens), 1, H, Dh)).astype(np.float32)
    return q, ck, cv, table, np.asarray(lens, np.int32)


def _slopes(H):
    s = ttf.alibi_slopes(H)
    np.testing.assert_array_equal(s, np.asarray(jtf.alibi_slopes(H), np.float32))
    return s


#: broken slopes the tolerance must catch
BITES = {"flipped": lambda s: s[::-1].copy(), "wrong-heads": lambda s: np.roll(s, 1),
         "zero": np.zeros_like}

HEADS = [(8, 8), (8, 2)]
HEAD_IDS = ["MHA", "GQA-G4"]
LENS = [30, 49, 1, 100]


# ---------------------------------------------------------------------------
# B2: paged decode with slopes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("H,KV", HEADS, ids=HEAD_IDS)
def test_paged_decode_alibi_plain_matches_pallas(H, KV):
    q, ck, cv, table, kvl = _decode_inputs(LENS, H, KV, seed=H + KV)
    sl = _slopes(H)
    got = tpa.paged_decode_attention(T(q), T(ck), T(cv), T(table), T(kvl),
                                     alibi_slopes=T(sl)).numpy()
    want = jpa.paged_decode_attention_pallas(
        *(jnp.asarray(a) for a in (q, ck, cv, table, kvl)), alibi_slopes=jnp.asarray(sl),
        interpret=True)
    np.testing.assert_allclose(got, _np(want), rtol=F32_TOL, atol=F32_TOL)
    k, v = jpaged.gather_kv(jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(table))
    engine_plain = jengine.decode_attention(jnp.asarray(q), k, v, jnp.asarray(kvl),
                                            alibi_slopes=jnp.asarray(sl))
    np.testing.assert_allclose(got, _np(engine_plain), rtol=F32_TOL, atol=F32_TOL)
    for name, broken in BITES.items():
        bad = tpa.paged_decode_reference(T(q), T(ck), T(cv), T(table), T(kvl),
                                         alibi_slopes=T(broken(sl)))
        assert not np.allclose(got, bad.numpy(), rtol=F32_TOL, atol=F32_TOL), name


@pytest.mark.parametrize("H,KV", HEADS, ids=HEAD_IDS)
def test_paged_decode_alibi_plain_bf16_within_one_step(H, KV):
    q, ck, cv, table, kvl = _decode_inputs(LENS, H, KV, seed=H + KV + 1)
    sl = _slopes(H)
    (tq, jq), (tk, jk), (tv, jv) = _bf16(q), _bf16(ck), _bf16(cv)
    got = tpa.paged_decode_reference(tq, tk, tv, T(table), T(kvl), p_f32=True,
                                     alibi_slopes=T(sl))
    want = jpa.paged_decode_attention_pallas(jq, jk, jv, jnp.asarray(table), jnp.asarray(kvl),
                                             alibi_slopes=jnp.asarray(sl), interpret=True)
    assert got.dtype == torch.bfloat16
    assert _one_bf16_step(got.float(), want.astype(jnp.float32))
    for name, broken in BITES.items():
        bad = tpa.paged_decode_reference(tq, tk, tv, T(table), T(kvl), p_f32=True,
                                         alibi_slopes=T(broken(sl)))
        assert not _one_bf16_step(bad.float(), want.astype(jnp.float32)), name


# ---------------------------------------------------------------------------
# B3: paged extend with slopes
# ---------------------------------------------------------------------------


def _extend_inputs(H, KV, seed, C=8, Dh=32, bs=16):
    rng = np.random.default_rng(seed)
    start = np.asarray([17, 40, 0], np.int32)
    nnew = np.asarray([8, 5, 8], np.int32)
    table, nblk = _scrambled(start + nnew, bs, 1, rng)
    ck, cv = (rng.standard_normal((nblk, KV, bs, Dh)).astype(np.float32) for _ in range(2))
    q = rng.standard_normal((len(start), C, H, Dh)).astype(np.float32)
    return q, ck, cv, table, start, nnew


def _rows(x, nnew):
    """The rows the engine reads: row c < nnew[b] of each sequence."""
    return np.concatenate([_np(x)[b, :n] for b, n in enumerate(nnew)])


@pytest.mark.parametrize("H,KV", HEADS, ids=HEAD_IDS)
def test_paged_extend_alibi_plain_matches_pallas(H, KV):
    q, ck, cv, table, start, nnew = _extend_inputs(H, KV, seed=H * KV)
    sl = _slopes(H)
    got = tpa.paged_extend_attention(T(q), T(ck), T(cv), T(table), T(start), T(nnew),
                                     alibi_slopes=T(sl))
    want = jpa.paged_extend_attention_pallas(
        *(jnp.asarray(a) for a in (q, ck, cv, np.maximum(table, 0), start, nnew)),
        alibi_slopes=jnp.asarray(sl), interpret=True)
    np.testing.assert_allclose(_rows(got, nnew), _rows(want, nnew), rtol=F32_TOL, atol=F32_TOL)
    for name, broken in BITES.items():
        bad = tpa.paged_extend_reference(T(q), T(ck), T(cv), T(table), T(start), T(nnew),
                                         alibi_slopes=T(broken(sl)))
        assert not np.allclose(_rows(got, nnew), _rows(bad, nnew), rtol=F32_TOL,
                               atol=F32_TOL), name


@pytest.mark.parametrize("H,KV", HEADS, ids=HEAD_IDS)
def test_paged_extend_alibi_plain_bf16_within_one_step(H, KV):
    q, ck, cv, table, start, nnew = _extend_inputs(H, KV, seed=H * KV + 1)
    sl = _slopes(H)
    (tq, jq), (tk, jk), (tv, jv) = _bf16(q), _bf16(ck), _bf16(cv)
    got = tpa.paged_extend_reference(tq, tk, tv, T(table), T(start), T(nnew), p_f32=True,
                                     alibi_slopes=T(sl))
    want = jpa.paged_extend_attention_pallas(
        jq, jk, jv, jnp.asarray(np.maximum(table, 0)), jnp.asarray(start), jnp.asarray(nnew),
        alibi_slopes=jnp.asarray(sl), interpret=True)
    assert _one_bf16_step(_rows(got.float(), nnew), _rows(want.astype(jnp.float32), nnew))


# ---------------------------------------------------------------------------
# B5: split-K decode with slopes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("splits", [1, 2, 4])
def test_fused_decode_alibi_plain_matches_pallas(splits):
    q, ck, cv, table, kvl = _decode_inputs(LENS, 8, 2, seed=splits)
    sl = _slopes(8)
    args = tuple(T(a) for a in (q, ck, cv, table, kvl))
    got = tfd.fused_paged_decode_attention(*args, num_splits=splits,
                                           alibi_slopes=T(sl)).numpy()
    jargs = tuple(jnp.asarray(a) for a in (q, ck, cv, table, kvl))
    want = jfd.fused_paged_decode_attention_pallas(*jargs, num_splits=splits,
                                                   alibi_slopes=jnp.asarray(sl), interpret=True)
    np.testing.assert_allclose(got, _np(want), rtol=F32_TOL, atol=F32_TOL)
    # the oracle of tests/test_fused_decode.py: gather, then the engine's decode
    k, v = jpaged.gather_kv(jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(table))
    oracle = jengine.decode_attention(jargs[0], k, v, jargs[4], alibi_slopes=jnp.asarray(sl))
    np.testing.assert_allclose(got, _np(oracle), rtol=F32_TOL, atol=F32_TOL)
    for name, broken in BITES.items():
        bad = tfd.fused_paged_decode_reference(*args, splits, alibi_slopes=T(broken(sl)))
        assert not np.allclose(got, bad.numpy(), rtol=F32_TOL, atol=F32_TOL), name


def test_fused_decode_alibi_plain_bf16_within_one_step():
    q, ck, cv, table, kvl = _decode_inputs(LENS, 8, 2, seed=11)
    sl = _slopes(8)
    (tq, jq), (tk, jk), (tv, jv) = _bf16(q), _bf16(ck), _bf16(cv)
    got = tfd.fused_paged_decode_attention(tq, tk, tv, T(table), T(kvl), num_splits=4,
                                           alibi_slopes=T(sl))
    want = jfd.fused_paged_decode_attention_pallas(
        jq, jk, jv, jnp.asarray(table), jnp.asarray(kvl), num_splits=4,
        alibi_slopes=jnp.asarray(sl), interpret=True)
    assert _one_bf16_step(got.float(), want.astype(jnp.float32))


# ---------------------------------------------------------------------------
# B4: QKV with biases and no RoPE
# ---------------------------------------------------------------------------


def _qkv_bias_inputs(seed, H=4, KV=2, D=64, Dh=16, bs=8):
    rng = np.random.default_rng(seed)
    pos = np.asarray([0, 8, 13, 21], np.int32)
    table, nblk = _scrambled(pos + 1, bs, 1, rng)
    y = rng.standard_normal((len(pos), D)).astype(np.float32)
    w = [rng.standard_normal((D, n * Dh)).astype(np.float32) * 0.1 for n in (H, KV, KV)]
    b = [rng.standard_normal(n * Dh).astype(np.float32) * 0.5 for n in (H, KV, KV)]
    pool = [rng.standard_normal((nblk, KV, bs, Dh)).astype(np.float32) for _ in range(2)]
    blk = table[np.arange(len(pos)), pos // bs]
    return y, w, b, pool, table, pos, blk, pos % bs


@pytest.mark.parametrize("pooled", [True, False], ids=["pool", "no-pool"])
def test_fused_qkv_bias_no_rope_plain_matches_pallas(pooled):
    H, KV = 4, 2
    y, w, b, pool, table, pos, blk, off = _qkv_bias_inputs(seed=3)
    pk, pv = T(pool[0].copy()), T(pool[1].copy())
    pool_args = (pk, pv, T(table), T(pos)) if pooled else ()
    got = tfd.fused_qkv_rope(T(y), *(T(m) for m in w), None, None, *pool_args, n_heads=H,
                             kv_heads=KV, bq=T(b[0]), bk=T(b[1]), bv=T(b[2]))
    jpool = dict(pool_k=jnp.asarray(pool[0]), pool_v=jnp.asarray(pool[1]),
                 blk=jnp.asarray(blk), off=jnp.asarray(off)) if pooled else {}
    want = jfd.fused_qkv_rope_pallas(jnp.asarray(y), *(jnp.asarray(m) for m in w),
                                     *(jnp.asarray(x) for x in b), n_heads=H, kv_heads=KV,
                                     interpret=True, **jpool)
    outs = list(got) + ([pk, pv] if pooled else [])
    assert len(outs) == len(want)
    for g, wt in zip(outs, want):
        np.testing.assert_allclose(g.numpy(), _np(wt), rtol=F32_TOL, atol=F32_TOL)
    dropped = tfd.fused_qkv_rope_reference(T(y), *(T(m) for m in w), None, None, n_heads=H,
                                           kv_heads=KV)
    for g, d in zip(got, dropped):
        assert not np.allclose(g.numpy(), d.numpy(), rtol=F32_TOL, atol=F32_TOL)


def test_fused_qkv_bias_no_rope_plain_bf16_within_one_step():
    H, KV = 4, 2
    y, w, b, pool, table, pos, blk, off = _qkv_bias_inputs(seed=4)
    ty, jy = _bf16(y)
    tw, jw = zip(*(_bf16(m) for m in w))
    tb, jb = zip(*(_bf16(x) for x in b))
    tp, jp = zip(*(_bf16(p) for p in pool))
    pk, pv = tp[0].clone(), tp[1].clone()
    got = tfd.fused_qkv_rope(ty, *tw, None, None, pk, pv, T(table), T(pos), n_heads=H,
                             kv_heads=KV, bq=tb[0], bk=tb[1], bv=tb[2])
    want = jfd.fused_qkv_rope_pallas(jy, *jw, *jb, n_heads=H, kv_heads=KV, pool_k=jp[0],
                                     pool_v=jp[1], blk=jnp.asarray(blk), off=jnp.asarray(off),
                                     interpret=True)
    for g, wt in zip(list(got) + [pk, pv], want):
        assert _one_bf16_step(g.float(), wt.astype(jnp.float32))


# ---------------------------------------------------------------------------
# B6: layernorm, fc biases, the plain MLP and the activations
# ---------------------------------------------------------------------------


def _mlp_inputs(seed, B=3, D=128, Fd=512):
    rng = np.random.default_rng(seed)
    resid, y = (rng.standard_normal((B, D)).astype(np.float32) for _ in range(2))
    ln_w = (1 + 0.1 * rng.standard_normal(D)).astype(np.float32)
    ln_b = (0.1 * rng.standard_normal(D)).astype(np.float32)
    wg, wu = (rng.standard_normal((D, Fd)).astype(np.float32) * 0.05 for _ in range(2))
    wd = rng.standard_normal((Fd, D)).astype(np.float32) * 0.05
    b_up = (0.5 * rng.standard_normal(Fd)).astype(np.float32)
    b_down = (0.5 * rng.standard_normal(D)).astype(np.float32)
    return dict(resid=resid, y=y, ln_w=ln_w, ln_b=ln_b, w_up=wu, w_down=wd, w_gate=wg,
                b_up=b_up, b_down=b_down)


#: (activation, gated, norm, biases): BLOOM's form first, then each fusable
#: activation once
MLP_CASES = [("gelu_new", False, "layernorm", True), ("gelu_pytorch_tanh", False, "layernorm", True),
             ("relu", False, "rmsnorm", True), ("silu", False, "layernorm", False),
             ("swiglu", True, "layernorm", False), ("swiglu", True, "rmsnorm", False)]
MLP_IDS = ["gelu_new-ln-bias", "gelu_pytorch_tanh-ln-bias", "relu-rms-bias", "silu-ln",
           "swiglu-ln", "swiglu-rms"]


def _port_mlp(a, act, gated, norm, bias, cast=T, drop=()):
    kw = {k: cast(a[k]) for k in ("b_up", "b_down") if bias and k not in drop}
    return tfd.fused_mlp(cast(a["resid"]), cast(a["y"]), cast(a["ln_w"]), cast(a["w_up"]),
                         cast(a["w_down"]), cast(a["w_gate"]) if gated else None, eps=1e-5,
                         ln_b=cast(a["ln_b"]), norm=norm, activation=act, **kw)


def _jax_mlp(a, act, gated, norm, bias, cast=jnp.asarray):
    kw = {k: cast(a[k]) for k in ("b_up", "b_down")} if bias else {}
    return jfd.fused_mlp_pallas(cast(a["resid"]), cast(a["y"]), cast(a["ln_w"]),
                                cast(a["ln_b"]), cast(a["w_up"]), cast(a["w_down"]),
                                cast(a["w_gate"]) if gated else None, norm=norm, eps=1e-5,
                                activation=act, interpret=True, **kw)


@pytest.mark.parametrize("act,gated,norm,bias", MLP_CASES, ids=MLP_IDS)
def test_fused_mlp_forms_plain_match_pallas(act, gated, norm, bias):
    a = _mlp_inputs(seed=len(act) + gated)
    got = _port_mlp(a, act, gated, norm, bias).numpy()
    want = _np(_jax_mlp(a, act, gated, norm, bias))
    assert np.abs(got - want).max() <= F32_TOL * np.abs(want).max()
    if bias:
        for drop in ("b_up", "b_down"):
            bad = _port_mlp(a, act, gated, norm, bias, drop=(drop,)).numpy()
            assert np.abs(bad - want).max() > F32_TOL * np.abs(want).max(), drop


@pytest.mark.parametrize("act,gated,norm,bias", MLP_CASES[:1] + MLP_CASES[2:3],
                         ids=MLP_IDS[:1] + MLP_IDS[2:3])
def test_fused_mlp_forms_plain_bf16_within_one_step(act, gated, norm, bias):
    a = _mlp_inputs(seed=7)
    got = _port_mlp(a, act, gated, norm, bias, cast=lambda x: _bf16(x)[0])
    want = _jax_mlp(a, act, gated, norm, bias, cast=lambda x: _bf16(x)[1])
    assert got.dtype == torch.bfloat16
    assert _one_bf16_step(got.float(), want.astype(jnp.float32))
    for drop in ("b_up", "b_down"):
        bad = _port_mlp(a, act, gated, norm, bias, cast=lambda x: _bf16(x)[0], drop=(drop,))
        assert not _one_bf16_step(bad.float(), want.astype(jnp.float32)), drop


def test_fused_mlp_refuses_exact_gelu_and_quantized_bias_forms():
    a = {k: T(v) for k, v in _mlp_inputs(seed=1).items()}
    with pytest.raises(ValueError, match="not fusable"):
        tfd.fused_mlp(a["resid"], a["y"], a["ln_w"], a["w_up"], a["w_down"], None,
                      norm="layernorm", activation="gelu")
    from shuffle_exchange_tpu_torch.ops.quant_matmul import quantize_weight

    q = [quantize_weight(a[k], group_size=128, bits=8) for k in ("w_up", "w_down", "w_gate")]
    # quantized weights with fc biases raise as JAX's fused_mlp does; the
    # layernorm form without them runs (B7's plain version)
    with pytest.raises(ValueError, match="fc biases"):
        tfd.fused_mlp(a["resid"], a["y"], a["ln_w"], *q, ln_b=a["ln_b"], norm="layernorm",
                      b_up=a["b_up"], b_down=a["b_down"])
    out = tfd.fused_mlp(a["resid"], a["y"], a["ln_w"], *q, ln_b=a["ln_b"], norm="layernorm")
    assert torch.isfinite(out).all()
    # apply_norm=False (GPT-J's shared layernorm) runs since the parallel-block
    # slice: the norm's weights are not read, and y enters as it is
    no_norm = tfd.fused_mlp(a["resid"], a["y"], a["ln_w"], *q, ln_b=a["ln_b"],
                            norm="layernorm", apply_norm=False)
    torch.testing.assert_close(no_norm, tfd.fused_mlp_quant_reference(
        a["resid"], a["y"], 0 * a["ln_w"], *q, norm="rmsnorm", apply_norm=False),
        rtol=0, atol=0)
    assert (no_norm - out).abs().max() > 1e-3


# ---------------------------------------------------------------------------
# Which decode layers fuse
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("activation", ["swiglu", "silu", "relu", "gelu", "gelu_new",
                                        "gelu_pytorch_tanh"])
@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm"])
@pytest.mark.parametrize("position", ["rope", "learned", "alibi"])
def test_decode_fusion_eligibility_equals_jax(activation, norm, position):
    assert tfd.FUSABLE_ACTIVATIONS == jfd.FUSABLE_ACTIVATIONS
    kw = dict(vocab_size=97, d_model=64, n_layers=2, n_heads=4, activation=activation,
              norm=norm, position=position)
    got = ttf.decode_fusion_eligibility(ttf.TransformerConfig(**kw))
    want = jtf.decode_fusion_eligibility(jtf.TransformerConfig(**kw))
    assert {k: v is None for k, v in got.items()} == {
        k: want[k] is None for k in ("qkv", "mlp")}
    moe = dataclasses.replace(ttf.TransformerConfig(**kw), n_experts=2)
    assert ttf.decode_fusion_eligibility(moe)["mlp"] is not None
