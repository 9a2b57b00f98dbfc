"""The PyTorch port's fused decode path (``decode_kernel: "pallas"``)
against the JAX package.

Kernels: each plain version in ``shuffle_exchange_tpu_torch/ops/
fused_decode.py`` meets its JAX Pallas kernel, run in interpret mode as
``tests/test_fused_decode.py`` runs it, on the same inputs made with numpy
from a seed:

- QKV + RoPE + append: f32 within 1e-5 (another summation order), with a
  -1-padded table, padding rows and G = 2 and 4; every pool row other
  than the appended ones unchanged;
- split-K decode: f32 within 1e-5 for num_splits 1, 2, 3 and the table
  width, kv_len 1, block edges, ragged lengths and -1 padding; against
  the port's ``paged_decode_reference(p_f32=True)`` within 1e-5;
- norm + SwiGLU MLP + residual: f32 within 1e-5 of the largest |out|;
- each in bf16 within one bf16 step (2^-7 of |want|, plus 1e-5 absolute
  for values near zero): both sides round f32 values that differ only in
  summation order, at the same points.

Engine: the port's "pallas" engine on the CPU (the plain versions) against
JAX's "pallas" engine with ``SXT_FUSED_INTERPRET=1``, in f32: per-tick
``step()`` logits within 1e-4, and ``serve()`` tokens equal to the JAX
scheduler's exactly, with and without preemption. The JAX engine drops to
its XLA body when a fused kernel fails, so the tests count the traces of
the three JAX kernels to show the fused path ran there.

The CUDA kernels run only on the card, where ``chip_smoke.py`` holds each
against its plain version.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shuffle_exchange_tpu.inference import ContinuousBatchingScheduler as JScheduler
from shuffle_exchange_tpu.inference import InferenceConfig as JConfig
from shuffle_exchange_tpu.inference import InferenceEngineV2 as JEngine
from shuffle_exchange_tpu.models import Transformer as JTransformer
from shuffle_exchange_tpu.models import tiny as jtiny
from shuffle_exchange_tpu.models.transformer import rope_table as jrope_table
from shuffle_exchange_tpu_torch.inference import (ContinuousBatchingScheduler, InferenceConfig,
                                                  InferenceEngine, InferenceEngineV2)
from shuffle_exchange_tpu_torch.models import Transformer, params_from_numpy, tiny
from shuffle_exchange_tpu_torch.models.transformer import decode_fusion_eligibility

jfd = importlib.import_module("shuffle_exchange_tpu.ops.fused_decode")
tfd = importlib.import_module("shuffle_exchange_tpu_torch.ops.fused_decode")
tpa = importlib.import_module("shuffle_exchange_tpu_torch.ops.paged_attention")

T = torch.from_numpy


def _np(x):
    return np.asarray(x)


def _bf16(x):
    """numpy f32 -> (torch bf16, jax bf16) holding the same values."""
    t = T(np.ascontiguousarray(x)).bfloat16()
    return t, jnp.asarray(t.float().numpy(), jnp.bfloat16)


def _within_one_bf16_step(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    err = np.abs(got - want)
    assert (err <= 2 ** -7 * np.abs(want) + 1e-5).all(), err.max()


def _tables(lens, bs, width, pad):
    """Block tables for ragged lengths padded to ``width`` with ``pad``;
    block 0 is the scratch block, real blocks count up from 1."""
    t = np.full((len(lens), width), pad, np.int32)
    nxt = iter(range(1, 1 + sum(-(-int(n) // bs) for n in lens)))
    for b, n in enumerate(lens):
        for j in range(-(-int(n) // bs)):
            t[b, j] = next(nxt)
    return t


# ---------------------------------------------------------------------------
# QKV + RoPE + append
# ---------------------------------------------------------------------------


def _qkv_inputs(H, KV, pad, seed):
    """Three real rows at positions 0, 8 (the first slot of a fresh block)
    and 13, then two padding rows as the engine packs them: the same
    hidden row, position 0, a table of ``pad`` entries (the scratch block
    0, or -1, read as block 0)."""
    rng = np.random.default_rng(seed)
    D, Dh, bs, W = 64, 16, 8, 3
    pos = np.asarray([0, 8, 13, 0, 0], np.int32)
    B = len(pos)
    y = rng.standard_normal((B, D)).astype(np.float32)
    y[4] = y[3]
    w = [rng.standard_normal((D, n * Dh)).astype(np.float32) * 0.1 for n in (H, KV, KV)]
    table = _tables(pos[:3] + 1, bs, W, pad)
    table = np.concatenate([table, np.full((2, W), pad, np.int32)])
    nblk = 1 + int(table.max())
    pool = [rng.standard_normal((nblk, KV, bs, Dh)).astype(np.float32) for _ in range(2)]
    cos_t, sin_t = jrope_table(64, Dh, 10000.0)
    cos, sin = np.array(jnp.take(cos_t, pos, axis=0)), np.array(jnp.take(sin_t, pos, axis=0))
    blk = np.maximum(table, 0)[np.arange(B), pos // bs]
    return y, w, cos, sin, pool, table, pos, blk, pos % bs


def _port_qkv(y, w, cos, sin, pool, table, pos, H, KV, cast=T):
    pk, pv = cast(pool[0].copy()), cast(pool[1].copy())
    q, k, v = tfd.fused_qkv_rope(cast(y), *(cast(m) for m in w), T(cos), T(sin), pk, pv,
                                 T(table), T(pos), n_heads=H, kv_heads=KV)
    return (q, k, v), (pk, pv)


def _jax_qkv(y, w, cos, sin, pool, blk, off, H, KV, cast=jnp.asarray):
    q, k, v, pk, pv = jfd.fused_qkv_rope_pallas(
        cast(y), *(cast(m) for m in w), cos=jnp.asarray(cos), sin=jnp.asarray(sin),
        n_heads=H, kv_heads=KV, pool_k=cast(pool[0]), pool_v=cast(pool[1]),
        blk=jnp.asarray(blk), off=jnp.asarray(off), interpret=True)
    return (q, k, v), (pk, pv)


QKV_CASES = [(4, 2, -1), (8, 2, 0)]
QKV_IDS = ["G2-neg-pad", "G4-scratch-pad"]


@pytest.mark.parametrize("H,KV,pad", QKV_CASES, ids=QKV_IDS)
def test_fused_qkv_rope_plain_matches_pallas(H, KV, pad):
    y, w, cos, sin, pool, table, pos, blk, off = _qkv_inputs(H, KV, pad, seed=H)
    got, got_pool = _port_qkv(y, w, cos, sin, pool, table, pos, H, KV)
    want, want_pool = _jax_qkv(y, w, cos, sin, pool, blk, off, H, KV)
    for g, wt in zip(got + got_pool, want + want_pool):
        np.testing.assert_allclose(g.numpy(), _np(wt), rtol=1e-5, atol=1e-5)
    appended = np.zeros(pool[0].shape[:3], bool)
    appended[blk, :, off] = True
    for g, before in zip(got_pool, pool):
        np.testing.assert_array_equal(g.numpy()[~appended], before[~appended])
        assert not np.array_equal(g.numpy()[appended], before[appended])


@pytest.mark.parametrize("H,KV,pad", QKV_CASES, ids=QKV_IDS)
def test_fused_qkv_rope_plain_bf16_within_one_step(H, KV, pad):
    y, w, cos, sin, pool, table, pos, blk, off = _qkv_inputs(H, KV, pad, seed=H + 1)
    got, got_pool = _port_qkv(y, w, cos, sin, pool, table, pos, H, KV,
                              cast=lambda a: _bf16(a)[0])
    want, want_pool = _jax_qkv(y, w, cos, sin, pool, blk, off, H, KV,
                               cast=lambda a: _bf16(a)[1])
    assert got[0].dtype == torch.bfloat16
    for g, wt in zip(got + got_pool, want + want_pool):
        _within_one_bf16_step(g.float().numpy(), _np(wt.astype(jnp.float32)))


# ---------------------------------------------------------------------------
# Split-K paged decode
# ---------------------------------------------------------------------------

DECODE_LENS = {"kv1": [1], "block-edges": [16, 32, 17], "ragged": [30, 49, 1, 100]}


def _decode_inputs(lens, H, KV, seed, Dh=32, bs=16, pad_blocks=2):
    rng = np.random.default_rng(seed)
    width = max(-(-n // bs) for n in lens) + pad_blocks
    table = _tables(lens, bs, width, -1)
    nblk = 1 + int(table.max())
    ck, cv = (rng.standard_normal((nblk, KV, bs, Dh)).astype(np.float32) for _ in range(2))
    q = rng.standard_normal((len(lens), 1, H, Dh)).astype(np.float32)
    return q, ck, cv, table, np.asarray(lens, np.int32)


@pytest.mark.parametrize("lens", list(DECODE_LENS.values()), ids=list(DECODE_LENS))
@pytest.mark.parametrize("splits", [1, 2, 3, "width"])
def test_fused_decode_plain_matches_pallas(splits, lens):
    q, ck, cv, table, kvl = _decode_inputs(lens, 8, 4, seed=len(lens))
    n = table.shape[1] if splits == "width" else splits
    got = tfd.fused_paged_decode_attention(T(q), T(ck), T(cv), T(table), T(kvl),
                                           num_splits=n).numpy()
    want = jfd.fused_paged_decode_attention_pallas(
        *(jnp.asarray(a) for a in (q, ck, cv, table, kvl)), num_splits=n, interpret=True)
    np.testing.assert_allclose(got, _np(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("H,KV", [(8, 4), (8, 2)], ids=["G2", "G4"])
def test_fused_decode_plain_bf16_within_one_step(H, KV):
    q, ck, cv, table, kvl = _decode_inputs(DECODE_LENS["ragged"], H, KV, seed=H + KV)
    (tq, jq), (tk, jk), (tv, jv) = _bf16(q), _bf16(ck), _bf16(cv)
    got = tfd.fused_paged_decode_attention(tq, tk, tv, T(table), T(kvl), num_splits=3)
    want = jfd.fused_paged_decode_attention_pallas(jq, jk, jv, jnp.asarray(table),
                                                   jnp.asarray(kvl), num_splits=3,
                                                   interpret=True)
    assert got.dtype == torch.bfloat16
    _within_one_bf16_step(got.float().numpy(), _np(want.astype(jnp.float32)))


@pytest.mark.parametrize("splits", [1, 2, 5])
def test_fused_decode_plain_equals_paged_reference_p_f32(splits):
    """The split merge changes nothing beyond rounding: the split-K plain
    version equals the dense plain decode with f32 softmax weights."""
    q, ck, cv, table, kvl = _decode_inputs(DECODE_LENS["ragged"], 8, 2, seed=7)
    args = tuple(T(a) for a in (q, ck, cv, table, kvl))
    got = tfd.fused_paged_decode_reference(*args, num_splits=splits)
    want = tpa.paged_decode_reference(*args, p_f32=True)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# Norm + SwiGLU MLP + residual
# ---------------------------------------------------------------------------


def _mlp_inputs(seed):
    rng = np.random.default_rng(seed)
    B, D, F = 3, 128, 512
    resid, y = (rng.standard_normal((B, D)).astype(np.float32) for _ in range(2))
    lnw = (1 + 0.1 * rng.standard_normal(D)).astype(np.float32)
    wg, wu = (rng.standard_normal((D, F)).astype(np.float32) * 0.05 for _ in range(2))
    wd = rng.standard_normal((F, D)).astype(np.float32) * 0.05
    return resid, y, lnw, wu, wd, wg


def _jax_mlp(resid, y, lnw, wu, wd, wg):
    return jfd.fused_mlp_pallas(resid, y, lnw, None, wu, wd, wg, norm="rmsnorm", eps=1e-5,
                                activation="swiglu", apply_norm=True, interpret=True)


def test_fused_mlp_plain_matches_pallas():
    args = _mlp_inputs(5)
    got = tfd.fused_mlp(*(T(a) for a in args), eps=1e-5).numpy()
    want = _np(_jax_mlp(*(jnp.asarray(a) for a in args)))
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_fused_mlp_plain_bf16_within_one_step():
    pairs = [_bf16(a) for a in _mlp_inputs(6)]
    got = tfd.fused_mlp(*(t for t, _ in pairs), eps=1e-5)
    want = _jax_mlp(*(j for _, j in pairs))
    assert got.dtype == torch.bfloat16
    _within_one_bf16_step(got.float().numpy(), _np(want.astype(jnp.float32)))


# ---------------------------------------------------------------------------
# The engine against JAX's fused engine
# ---------------------------------------------------------------------------

MODEL = dict(vocab=97, d=64, layers=2, heads=4, seq=128, activation="swiglu",
             norm="rmsnorm", position="rope", n_kv_heads=2, tie_embeddings=False)


@pytest.fixture(scope="module")
def models():
    jm = JTransformer(jtiny(**MODEL))
    jp = jm.init(jax.random.PRNGKey(1))
    tm = Transformer(tiny(**MODEL), device="cpu")
    state = params_from_numpy(jax.tree.map(np.asarray, jp))
    tm.load_params(state)
    return jm, jp, tm, state


def _cfg(cls, decode_kernel="pallas", num_kv_blocks=40):
    return cls(dtype="float32", max_seq_len=64, kv_block_size=8, num_kv_blocks=num_kv_blocks,
               decode_kernel=decode_kernel,
               serving={"token_budget": 16, "max_running": 4, "chunk_min": 4})


@pytest.fixture
def jax_fused(monkeypatch):
    """JAX's fused kernels through the Pallas interpreter, each wrapped to
    count its traces: the JAX engine drops to its XLA body when a fused
    kernel fails, so a trace count of 0 would mean the fused path did not
    run there."""
    monkeypatch.setenv("SXT_FUSED_INTERPRET", "1")
    traces = dict.fromkeys(("fused_qkv_rope_pallas", "fused_paged_decode_attention_pallas",
                            "fused_mlp_pallas"), 0)
    for name in traces:
        fn = getattr(jfd, name)

        def counted(*a, _fn=fn, _name=name, **kw):
            traces[_name] += 1
            return _fn(*a, **kw)

        monkeypatch.setattr(jfd, name, counted)
    return traces


def _engines(models, decode_kernel="pallas", num_kv_blocks=40):
    jm, jp, tm, state = models
    return (JEngine(jm, jp, _cfg(JConfig, decode_kernel, num_kv_blocks)),
            InferenceEngineV2(tm, state, _cfg(InferenceConfig, decode_kernel, num_kv_blocks),
                              device="cpu"))


def _prompts(seed, lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 90, size=int(n)).tolist() for n in lengths]


def test_step_schedule_logits_match_jax_fused(models, jax_fused):
    """Extend-only, mixed and decode-only ticks through both fused
    engines: per-tick logits within 1e-4."""
    je, te = _engines(models)
    assert je._decode_kernel == te._decode_kernel == "pallas"
    p = _prompts(0, (12, 5, 22))
    toks = np.random.default_rng(9).integers(1, 90, size=16).tolist()
    schedule = [
        ([], [], [(0, p[0][:10]), (1, p[1])]),                      # extend only
        ([1], toks[:1], [(0, p[0][10:]), (2, p[2][:8])]),           # mixed
        ([0, 1], toks[1:3], [(2, p[2][8:])]),                       # mixed
        ([0, 1, 2], toks[3:6], []),                                 # decode only
        ([0, 2], toks[6:8], []),
        ([2], toks[8:9], [(3, p[1][:3])]),                          # a new uid mid-decode
    ]
    for tick in schedule:
        jd, jpl = je.step(*tick)
        td, tpl = te.step(*tick)
        np.testing.assert_allclose(td, jd, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(tpl, jpl, rtol=1e-4, atol=1e-4)
    assert te.dispatches_by_program.keys() == {"extend", "mixed", "decode"}
    assert all(n > 0 for n in jax_fused.values()), jax_fused


@pytest.mark.parametrize("case", ["concurrent", "preemption"])
def test_serve_tokens_equal_the_jax_fused_scheduler(models, jax_fused, case):
    if case == "concurrent":
        prompts, max_new, blocks = _prompts(0, (12, 5, 22, 9)), 8, 40
    else:   # 6 usable blocks of 8 slots cannot hold both requests' KV
        prompts, max_new, blocks = _prompts(1, (20, 18)), 12, 7
    je, te = _engines(models, num_kv_blocks=blocks)
    js, ts = JScheduler(je), ContinuousBatchingScheduler(te)
    want = js.serve(prompts, max_new_tokens=max_new)
    got = ts.serve(prompts, max_new_tokens=max_new)
    assert got == want
    assert ts.ticks == js.ticks and ts.preemptions == js.preemptions
    if case == "preemption":
        assert ts.preemptions > 0, "the pool was sized to force preemption"
    assert all(n > 0 for n in jax_fused.values()), jax_fused


def test_fused_tokens_equal_the_paged_kernel_path(models):
    _, _, tm, state = models
    prompts = _prompts(3, (12, 5, 22, 9, 30))
    outs = {}
    for dk in ("xla", "pallas"):
        eng = InferenceEngineV2(tm, state, _cfg(InferenceConfig, dk), device="cpu")
        outs[dk] = ContinuousBatchingScheduler(eng).serve(prompts, max_new_tokens=10)
    assert outs["pallas"] == outs["xla"]


# ---------------------------------------------------------------------------
# Rules
# ---------------------------------------------------------------------------


def test_auto_is_the_paged_kernel_path_on_a_cpu_engine(models):
    _, te = _engines(models, decode_kernel="auto")
    assert te._decode_kernel == "xla" and not (te._fuse_qkv or te._fuse_mlp)


def test_llama_is_fusable_and_pallas_on_nothing_fusable_raises(models):
    _, _, tm, state = models
    assert decode_fusion_eligibility(tm.config) == {"qkv": None, "mlp": None}
    unfusable = dataclasses.replace(tm.config, rope_interleaved=True, n_experts=2)
    elig = decode_fusion_eligibility(unfusable)
    assert "interleaved" in elig["qkv"] and "MoE" in elig["mlp"]
    for change, reason in (({"activation": "gelu"}, "not fusable"),
                           ({"norm": "layernorm"}, "RMSNorm")):
        elig = decode_fusion_eligibility(dataclasses.replace(tm.config, **change))
        assert elig["qkv"] is None and reason in elig["mlp"]
    model = Transformer(tiny(**MODEL), device="cpu")
    model.config = unfusable   # a structure the port's model refuses to build
    with pytest.raises(ValueError, match="no part of the decode layer is fusable"):
        InferenceEngine(model, state, _cfg(InferenceConfig), device="cpu")
    eng = InferenceEngine(model, state, _cfg(InferenceConfig, "auto"), device="cpu")
    assert eng._decode_kernel == "xla"


@pytest.mark.parametrize("which,kw,item", [
    ("qkv", {"bq": torch.zeros(16)}, "item 4"),
    ("attention", {"alibi_slopes": torch.ones(4)}, "item 3"),
    ("attention", {"k_scale": torch.ones(3, 2, 8), "v_scale": torch.ones(3, 2, 8)}, "item 3"),
    ("mlp", {"b_up": torch.zeros(32), "b_down": torch.zeros(16)}, "item 4"),
], ids=["qkv-bias", "attention-alibi", "attention-kv-scales", "mlp-bias"])
def test_fused_wrappers_refuse_unported_features(which, kw, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP queue A, {item}"):
        if which == "qkv":
            pool = torch.zeros(3, 2, 8, 4)
            tfd.fused_qkv_rope(torch.zeros(1, 16), torch.zeros(16, 16), torch.zeros(16, 8),
                               torch.zeros(16, 8), torch.zeros(1, 2), torch.zeros(1, 2), pool,
                               pool.clone(), torch.zeros(1, 1, dtype=torch.int32),
                               torch.zeros(1, dtype=torch.int32), n_heads=4, kv_heads=2, **kw)
        elif which == "attention":
            pool = torch.zeros(3, 2, 8, 4)
            tfd.fused_paged_decode_attention(torch.zeros(1, 1, 4, 4), pool, pool,
                                             torch.zeros(1, 1, dtype=torch.int32),
                                             torch.ones(1, dtype=torch.int32), **kw)
        else:
            x = torch.zeros(1, 16)
            tfd.fused_mlp(x, x, torch.ones(16), torch.zeros(16, 32), torch.zeros(32, 16),
                          torch.zeros(16, 32), **kw)


def test_fused_wrappers_on_cpu_do_not_count_launches():
    wrappers = (tfd.fused_qkv_rope, tfd.fused_paged_decode_attention, tfd.fused_mlp)
    before = [w.launches for w in wrappers]
    y, w, cos, sin, pool, table, pos, _, _ = _qkv_inputs(4, 2, -1, seed=0)
    _port_qkv(y, w, cos, sin, pool, table, pos, 4, 2)
    q, ck, cv, table, kvl = _decode_inputs([5, 20], 4, 2, seed=0)
    tfd.fused_paged_decode_attention(T(q), T(ck), T(cv), T(table), T(kvl))
    tfd.fused_mlp(*(T(a) for a in _mlp_inputs(0)))
    assert [w.launches for w in wrappers] == before
