"""The PyTorch port's prefill entry points against the JAX package.

Kernels, on the same inputs made with numpy from a seed:

- the plain ``flash_attention`` against JAX ``reference_attention`` in
  f32, within 1e-5 (another summation order): GQA groups 1, 2 and 4, head
  dims 8, 64 and 128, T = S in {1, 7, 64, 200}, causal and full, with and
  without segment ids;
- against ``splash_attention_gqa(..., interpret=True)`` at
  ``tests/test_ops.py``'s shape, within that test's 2e-3 (the kernel's
  own blocked softmax);
- B4 without a pool (the v1 engine's form) against
  ``fused_qkv_rope_pallas`` in interpret mode: within 1e-5 in f32 and one
  bf16 step in bf16.

Engines, in f32 on ``device="cpu"`` (every wrapper takes its plain
version), with the tiny Llama and the configs of
``tests/test_torch_serving.py`` / ``tests/test_serving_scheduler.py``:

- ``put()`` logits within 1e-4 of the JAX engine's per call, with equal
  free blocks, ``query()`` and program shapes, over cold prompts of
  several lengths in one call, single- and multi-token extensions and a
  known uid with no new tokens;
- ``decode_loop`` tokens equal the JAX engine's and a loop of
  single-token ``put()`` calls exactly; the scheduler's ``serve()`` equals
  the port's own ``put()`` + ``decode_loop`` reference;
- ``decode_kernel: "pallas"`` (the fused plain versions) gives the tokens
  of ``"xla"``, and the logits and tokens of JAX's ``"pallas"`` engine run
  through the Pallas interpreter (whose kernel traces are counted: the
  JAX engine drops to its XLA body when a fused kernel fails);
- v1 greedy ``generate`` equals JAX's exactly, with ragged prompt lengths
  and EOS padding, on both decode paths;
- refused ``put()`` / ``decode_loop`` calls raise the JAX engine's message
  and leave the engine as it was.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shuffle_exchange_tpu.inference import InferenceConfig as JConfig
from shuffle_exchange_tpu.inference import InferenceEngine as JEngineV1
from shuffle_exchange_tpu.inference import InferenceEngineV2 as JEngine
from shuffle_exchange_tpu.models import Transformer as JTransformer
from shuffle_exchange_tpu.models import tiny as jtiny
from shuffle_exchange_tpu.ops.flash_attention import reference_attention as jreference
from shuffle_exchange_tpu.ops.flash_attention import splash_attention_gqa
from shuffle_exchange_tpu_torch.inference import (ContinuousBatchingScheduler, InferenceConfig,
                                                  InferenceEngineV2, init_inference)
from shuffle_exchange_tpu_torch.models import Transformer, params_from_numpy, tiny
from shuffle_exchange_tpu_torch.ops import flash_attention

jfd = importlib.import_module("shuffle_exchange_tpu.ops.fused_decode")
tfd = importlib.import_module("shuffle_exchange_tpu_torch.ops.fused_decode")

T = torch.from_numpy


def _within_one_bf16_step(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    err = np.abs(got - want)
    assert (err <= 2 ** -7 * np.abs(want) + 1e-5).all(), err.max()


# ---------------------------------------------------------------------------
# Flash attention: the plain version against the JAX package
# ---------------------------------------------------------------------------


def _attn_inputs(B, L, H, KV, Dh, seed, segments=False):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, L, H, Dh)).astype(np.float32)
    k = rng.standard_normal((B, L, KV, Dh)).astype(np.float32)
    v = rng.standard_normal((B, L, KV, Dh)).astype(np.float32)
    seg = np.sort(rng.integers(0, 3, size=(B, L)), axis=1).astype(np.int32) if segments else None
    return q, k, v, seg


@pytest.mark.parametrize("segments", [False, True], ids=["noseg", "seg"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("L", [1, 7, 64, 200])
@pytest.mark.parametrize("G,Dh", [(1, 64), (2, 128), (4, 8)], ids=["G1-Dh64", "G2-Dh128",
                                                                   "G4-Dh8"])
def test_flash_plain_matches_jax_reference(G, Dh, L, causal, segments):
    KV = 2
    q, k, v, seg = _attn_inputs(2, L, KV * G, KV, Dh, seed=L + G, segments=segments)
    got = flash_attention(T(q), T(k), T(v), causal=causal,
                          segment_ids=None if seg is None else T(seg)).numpy()
    want = jreference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                      segment_ids=None if seg is None else jnp.asarray(seg))
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("segments", [False, True], ids=["noseg", "seg"])
def test_flash_plain_matches_splash_interpret(segments):
    q, k, v, seg = _attn_inputs(1, 256, 4, 2, 128, seed=0, segments=segments)
    got = flash_attention(T(q), T(k), T(v), causal=True,
                          segment_ids=None if seg is None else T(seg)).numpy()
    want = splash_attention_gqa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
                                segment_ids=None if seg is None else jnp.asarray(seg),
                                interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-3, atol=2e-3)


def test_flash_plain_p_f32_differs_from_the_cast_only_by_rounding():
    """``p_f32`` keeps the softmax weights in f32 (the card's yardstick);
    in bf16 it differs from the reference's cast by less than a bf16 step
    of the weights, and in f32 not at all."""
    q, k, v, _ = _attn_inputs(2, 64, 4, 2, 64, seed=3)
    mod = importlib.import_module("shuffle_exchange_tpu_torch.ops.flash_attention")
    f32 = [mod.reference_attention(T(q), T(k), T(v), True, None, p_f32=p) for p in (False, True)]
    torch.testing.assert_close(f32[0], f32[1], rtol=0, atol=0)
    b = [mod.reference_attention(T(q).bfloat16(), T(k).bfloat16(), T(v).bfloat16(), True, None,
                                 p_f32=p).float() for p in (False, True)]
    assert 0 < (b[0] - b[1]).abs().max() < 2 ** -6 * b[1].abs().max()


# ---------------------------------------------------------------------------
# B4 without a pool
# ---------------------------------------------------------------------------


def _qkv_nopool_inputs(H, KV, seed):
    rng = np.random.default_rng(seed)
    B, D, Dh = 3, 64, 16
    y = rng.standard_normal((B, D)).astype(np.float32)
    w = [rng.standard_normal((D, n * Dh)).astype(np.float32) * 0.1 for n in (H, KV, KV)]
    pos = np.asarray([0, 9, 30], np.int32)
    ang = pos[:, None] / 10000.0 ** (np.arange(0, Dh, 2) / Dh)[None, :]
    return y, w, np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("H,KV", [(4, 2), (8, 2)], ids=["G2", "G4"])
def test_fused_qkv_without_pool_matches_pallas(H, KV, dtype):
    y, w, cos, sin = _qkv_nopool_inputs(H, KV, seed=H + (dtype == "bf16"))
    if dtype == "bf16":
        tc = lambda a: T(np.ascontiguousarray(a)).bfloat16()
        jc = lambda a: jnp.asarray(tc(a).float().numpy(), jnp.bfloat16)
    else:
        tc, jc = T, jnp.asarray
    got = tfd.fused_qkv_rope(tc(y), *(tc(m) for m in w), T(cos), T(sin), n_heads=H, kv_heads=KV)
    want = jfd.fused_qkv_rope_pallas(jc(y), *(jc(m) for m in w), cos=jnp.asarray(cos),
                                     sin=jnp.asarray(sin), n_heads=H, kv_heads=KV,
                                     interpret=True)
    assert len(want) == 3
    for g, wt in zip(got, want):
        if dtype == "bf16":
            assert g.dtype == torch.bfloat16
            _within_one_bf16_step(g.float().numpy(), np.asarray(wt.astype(jnp.float32)))
        else:
            np.testing.assert_allclose(g.numpy(), np.asarray(wt), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# The engines
# ---------------------------------------------------------------------------

MODEL = dict(vocab=97, d=32, layers=2, heads=4, seq=128, activation="swiglu",
             norm="rmsnorm", position="rope", n_kv_heads=2, tie_embeddings=False)


@pytest.fixture(scope="module")
def models():
    jm = JTransformer(jtiny(**MODEL))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = Transformer(tiny(**MODEL), device="cpu")
    state = params_from_numpy(jax.tree.map(np.asarray, jp))
    tm.load_params(state)
    return jm, jp, tm, state


def _cfg(cls, decode_kernel="xla", num_kv_blocks=40, **kw):
    return cls(dtype="float32", max_seq_len=64, kv_block_size=8, num_kv_blocks=num_kv_blocks,
               decode_kernel=decode_kernel,
               serving={"token_budget": 16, "max_running": 4, "chunk_min": 4}, **kw)


def _engines(models, decode_kernel="xla", num_kv_blocks=40, **kw):
    jm, jp, tm, state = models
    return (JEngine(jm, jp, _cfg(JConfig, decode_kernel, num_kv_blocks, **kw)),
            InferenceEngineV2(tm, state, _cfg(InferenceConfig, decode_kernel, num_kv_blocks,
                                              **kw), device="cpu"))


def _prompts(seed, lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 90, size=int(n)).tolist() for n in lengths]


@pytest.fixture
def jax_fused(monkeypatch):
    """JAX's fused kernels through the Pallas interpreter, each wrapped to
    count its traces."""
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


def _put_schedule(seed):
    p = _prompts(seed, (12, 5, 22, 7, 11))
    t = np.random.default_rng(seed + 100).integers(1, 90, size=8).tolist()
    return [
        ([0, 1, 2], [p[0], p[1], p[2]]),     # three cold prompts: P = 4, tpad 32
        ([0], [t[:1]]),                      # a single-token extension
        ([1], [p[4]]),                       # 11 tokens from 5: chunks of 8 and 3
        ([2, 0, 3], [[], t[1:2], p[3]]),     # no new tokens, a single, a cold prompt
        ([3, 1, 0], [t[2:3], t[3:5], t[5:6]]),
    ]


@pytest.mark.parametrize("decode_kernel", ["xla", "pallas"])
def test_put_matches_jax(models, decode_kernel, request):
    traces = request.getfixturevalue("jax_fused") if decode_kernel == "pallas" else None
    je, te = _engines(models, decode_kernel)
    assert te._decode_kernel == decode_kernel
    for uids, toks in _put_schedule(0):
        want = je.put(uids, toks)
        got = te.put(uids, toks)
        assert got.shape == want.shape == (len(uids), 97)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
        assert te.free_blocks == je.free_blocks
        for uid in range(4):
            assert te.query(uid) == je.query(uid)
            if uid in te._seqs:
                assert te._seqs[uid].seen_tokens == je._seqs[uid].seen_tokens
                assert te._seqs[uid].blocks == je._seqs[uid].blocks
    assert te.program_shapes == je.program_shapes
    assert {k[0] for k in te.program_shapes} == {"prefill", "decode", "extend"}
    assert te.dispatch_count == je.dispatch_count
    if traces is not None:
        assert all(n > 0 for n in traces.values()), traces


def test_decode_loop_matches_jax_and_the_put_loop(models):
    je, te = _engines(models)
    _, ref = _engines(models)
    prompts = _prompts(4, (9, 20, 3))
    uids = [0, 1, 2]
    first = [int(np.argmax(r)) for r in te.put(uids, prompts)]
    je.put(uids, prompts)
    ref.put(uids, prompts)
    d0 = te.dispatch_count
    got = te.decode_loop(uids, first, 7)
    want = je.decode_loop(uids, first, 7)
    assert got.dtype == np.int32 and got.shape == (3, 7)
    np.testing.assert_array_equal(got, want)
    assert te.dispatch_count - d0 == 1
    assert ("decode_loop", 3, 7, te._binned_width(max(len(d.blocks) for d in te._seqs.values()))) \
        in te.program_shapes
    assert te.program_shapes == je.program_shapes
    nxt, host = first, []
    for _ in range(7):
        nxt = [int(np.argmax(r)) for r in ref.put(uids, [[t] for t in nxt])]
        host.append(nxt)
    np.testing.assert_array_equal(got, np.asarray(host).T)
    for u in uids:
        assert te._seqs[u].seen_tokens == ref._seqs[u].seen_tokens == je._seqs[u].seen_tokens
        np.testing.assert_allclose(te._seqs[u].last_logits, je._seqs[u].last_logits,
                                   rtol=1e-4, atol=1e-4)
    assert te.free_blocks == je.free_blocks
    # the next put continues from the same state on all three
    nxt = [[int(t)] for t in got[:, -1]]
    np.testing.assert_allclose(te.put(uids, nxt), je.put(uids, nxt), rtol=1e-4, atol=1e-4)


def test_decode_loop_matches_jax_fused(models, jax_fused):
    je, te = _engines(models, "pallas")
    prompts = _prompts(5, (14, 6))
    lt, lj = te.put([0, 1], prompts), je.put([0, 1], prompts)
    np.testing.assert_allclose(lt, lj, rtol=1e-4, atol=1e-4)
    first = [int(np.argmax(r)) for r in lt]
    np.testing.assert_array_equal(te.decode_loop([0, 1], first, 5),
                                  je.decode_loop([0, 1], first, 5))
    assert all(n > 0 for n in jax_fused.values()), jax_fused


def _reference(tm, state, prompt, n_new, decode_kernel="xla"):
    """The sequential serving reference of ``tests/test_serving_scheduler.py``:
    one put() prefill, then decode_loop."""
    eng = InferenceEngineV2(tm, state, _cfg(InferenceConfig, decode_kernel), device="cpu")
    first = int(np.argmax(eng.put([0], [prompt])[0]))
    if n_new == 1:
        return [first]
    return [first] + [int(t) for t in eng.decode_loop([0], [first], n_new - 1)[0]]


@pytest.mark.parametrize("decode_kernel", ["xla", "pallas"])
def test_serve_equals_the_put_decode_loop_reference(models, decode_kernel):
    _, _, tm, state = models
    prompts = _prompts(0, (12, 5, 22, 9))
    want = [_reference(tm, state, p, 8, decode_kernel) for p in prompts]
    eng = InferenceEngineV2(tm, state, _cfg(InferenceConfig, decode_kernel), device="cpu")
    out = ContinuousBatchingScheduler(eng).serve(prompts, max_new_tokens=8)
    assert [out[u] for u in out] == want
    assert eng.free_blocks == eng.allocator.num_blocks - 1


def test_fused_and_paged_paths_give_equal_tokens(models):
    _, _, tm, state = models
    prompts = _prompts(6, (30, 11, 4))
    outs = {}
    for dk in ("xla", "pallas"):
        eng = InferenceEngineV2(tm, state, _cfg(InferenceConfig, dk), device="cpu")
        first = [int(np.argmax(r)) for r in eng.put([0, 1, 2], prompts)]
        outs[dk] = (first, eng.decode_loop([0, 1, 2], first, 9).tolist())
    assert outs["pallas"] == outs["xla"]


# ---------------------------------------------------------------------------
# Admission
# ---------------------------------------------------------------------------


def _state(eng):
    return (eng.free_blocks, eng.dispatch_count,
            {u: (d.seen_tokens, list(d.blocks)) for u, d in eng._seqs.items()})


@pytest.mark.parametrize("case", ["blocks", "seq-len", "batch", "decode-loop-seq-len",
                                  "decode-loop-blocks"])
def test_refused_calls_match_jax_and_change_nothing(models, case):
    blocks = 6 if case in ("blocks", "decode-loop-blocks") else 40
    je, te = _engines(models, num_kv_blocks=blocks, max_batch_size=2)
    p = _prompts(7, (10, 6, 5))
    for eng in (je, te):
        eng.put([0, 1, 2], [p[0], p[1], p[2]])
    before = _state(te)
    call = {
        "blocks": lambda e: e.put([3], [list(range(1, 40))]),
        "seq-len": lambda e: e.put([0], [list(range(1, 60))]),
        "batch": lambda e: e.put([0, 1, 2], [[1], [2], [3]]),
        "decode-loop-seq-len": lambda e: e.decode_loop([0], [1], 60),
        "decode-loop-blocks": lambda e: e.decode_loop([0, 1, 2], [1, 2, 3], 20),
    }[case]
    errs = []
    for eng in (je, te):
        with pytest.raises((RuntimeError, ValueError)) as e:
            call(eng)
        errs.append(str(e.value))
    assert errs[1] == errs[0]
    assert any(s in errs[1] for s in ("KV blocks", "max_seq_len", "max_batch_size"))
    assert _state(te) == before
    assert te.free_blocks == je.free_blocks


def test_put_rejects_malformed_batches(models):
    _, te = _engines(models)
    te.put([0], [[1, 2, 3]])
    before = _state(te)
    for uids, toks, msg in (([0, 0], [[1], [2]], "duplicate uid"),
                            ([5], [[]], "new uid 5 with no tokens"),
                            ([1, 2], [[1]], "must align")):
        with pytest.raises(ValueError, match=msg):
            te.put(uids, toks)
    with pytest.raises(ValueError, match="unknown"):
        te.decode_loop([9], [1], 2)
    assert _state(te) == before


# ---------------------------------------------------------------------------
# v1 generate
# ---------------------------------------------------------------------------


def _v1(models, decode_kernel, **kw):
    jm, jp, tm, state = models
    cfg = dict(dtype="float32", max_seq_len=64, decode_kernel=decode_kernel, **kw)
    return JEngineV1(jm, jp, JConfig(**cfg)), init_inference(tm, state, cfg, device="cpu")


@pytest.mark.parametrize("decode_kernel", ["xla", "pallas"])
def test_v1_generate_matches_jax(models, decode_kernel, request):
    traces = request.getfixturevalue("jax_fused") if decode_kernel == "pallas" else None
    je, te = _v1(models, decode_kernel)
    rng = np.random.default_rng(11)
    ids = rng.integers(1, 90, size=(3, 13)).astype(np.int32)
    lens = np.asarray([13, 6, 9], np.int32)
    ids[1, 6:] = 0
    ids[2, 9:] = 0
    want = je.generate(ids, prompt_lengths=lens, max_new_tokens=10)
    got = te.generate(ids, prompt_lengths=lens, max_new_tokens=10)
    assert got.dtype == np.int32 and got.shape == (3, 10)
    np.testing.assert_array_equal(got, want)
    # an EOS one row reaches mid-stream: later positions of that row pad
    eos = int(want[1, 4])
    want = je.generate(ids, prompt_lengths=lens, max_new_tokens=10, eos_token_id=eos)
    got = te.generate(ids, prompt_lengths=lens, max_new_tokens=10, eos_token_id=eos)
    np.testing.assert_array_equal(got, want)
    first = int(np.argmax(got[1] == eos))
    assert (got[1, first + 1:] == 0).all() and first <= 4
    if traces is not None:
        assert traces["fused_qkv_rope_pallas"] > 0 and traces["fused_mlp_pallas"] > 0, traces


def test_v1_generate_equals_put_and_decode_loop(models):
    """The dense-cache engine and the paged one agree: greedy tokens of one
    prompt through v1 generate and through put() + decode_loop."""
    _, te = _v1(models, "xla")
    _, _, tm, state = models
    prompt = _prompts(12, (17,))[0]
    got = te.generate(np.asarray([prompt], np.int32), max_new_tokens=8)[0].tolist()
    assert got == _reference(tm, state, prompt, 8)
