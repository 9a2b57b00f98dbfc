"""Parallel-block serving (GPT-J, GPT-NeoX / Pythia) of the PyTorch port
against the JAX package, on the CPU, in f32.

Three tinies with ``tests/test_hf.py``'s structures: GPT-J (d 64, 4 heads,
``rotary_dim`` 8 interleaved, a shared layernorm, ``gelu_new``, an
unembedding bias), GPT-NeoX (``rotary_pct`` 0.5 rotate-half, two
layernorms, q/k/v/out biases, exact gelu) and NeoX with ``gelu_new``, whose
MLP fuses with ``y_src`` (the block's input) apart from ``resid``. Each gets
the JAX init with every norm weight and bias (the unembedding bias too)
drawn from numpy, so a dropped bias or a misplaced norm shows. Held to the
JAX package:

- ``config_from_hf`` field for field on GPT-J-6B's and Pythia-1.4b's
  published configs, the parameter leaves and counts, and the converter
  both ways bit for bit;
- ``apply_rope`` partial and interleaved against JAX's ``apply_rope``,
  exact in f32;
- the plain B6 / B7 with ``apply_norm=False`` against ``fused_mlp_pallas``
  / ``fused_mlp_quant_pallas(interpret=True)`` and the plain B4 with rd <
  Dh against ``fused_qkv_rope_pallas(interpret=True)`` (1e-5);
- the engines: ``step()`` and ``put()`` logits within 1e-4, ``serve()``,
  ``decode_loop`` and the v1 ``generate`` tokens exact, on "xla" and on
  "pallas" with JAX's kernels in interpret mode (``SXT_FUSED_INTERPRET``).
  The JAX engines drop to their XLA body silently when a fused kernel
  fails, so the ``routes`` fixture counts JAX's Pallas traces and the port
  wrappers' calls: GPT-J never reaches B4 (interleaved RoPE) and reaches B6
  with ``apply_norm=False``; NeoX reaches B4 (partial rotary) and, under
  ``gelu_new``, B6 with its norm;
- the launch counters with the kernel gate opened onto the plain versions;
- the refusals: training on either structure, the flash backward at
  head_dim 256, ALiBi at head_dim 256; Falcon's config and the split-K and
  paged wrappers at its group no longer refuse (``tests/test_torch_falcon.py``
  holds Falcon serving against the JAX package).
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import shuffle_exchange_tpu_torch as sxt
from shuffle_exchange_tpu.inference import ContinuousBatchingScheduler as JScheduler
from shuffle_exchange_tpu.inference import InferenceConfig as JConfig
from shuffle_exchange_tpu.inference import InferenceEngine as JEngineV1
from shuffle_exchange_tpu.inference import InferenceEngineV2 as JEngine
from shuffle_exchange_tpu.models import Transformer as JTransformer
from shuffle_exchange_tpu.models import hf as jhf
from shuffle_exchange_tpu.models import tiny as jtiny
from shuffle_exchange_tpu.models import transformer as jtf
from shuffle_exchange_tpu_torch.inference import (ContinuousBatchingScheduler, InferenceConfig,
                                                  InferenceEngineV2, init_inference)
from shuffle_exchange_tpu_torch.models import (Transformer, config_from_hf, param_count,
                                               params_from_numpy, params_to_numpy, tiny)
from shuffle_exchange_tpu_torch.models import transformer as ttf

jfd = importlib.import_module("shuffle_exchange_tpu.ops.fused_decode")
jqm = importlib.import_module("shuffle_exchange_tpu.ops.quant_matmul")
tqm = importlib.import_module("shuffle_exchange_tpu_torch.ops.quant_matmul")
tfd = importlib.import_module("shuffle_exchange_tpu_torch.ops.fused_decode")
tfa = importlib.import_module("shuffle_exchange_tpu_torch.ops.flash_attention")
tal = importlib.import_module("shuffle_exchange_tpu_torch.ops.alibi_attention")
tpa = importlib.import_module("shuffle_exchange_tpu_torch.ops.paged_attention")
tie = importlib.import_module("shuffle_exchange_tpu_torch.inference.engine")
tie2 = importlib.import_module("shuffle_exchange_tpu_torch.inference.engine_v2")

T = torch.from_numpy
TOL = 1e-4
GPTJ = dict(vocab=96, d=64, layers=2, heads=4, seq=64, activation="gelu_new", norm="layernorm",
            position="rope", rope_theta=10000.0, rotary_dim=8, rope_interleaved=True,
            parallel_block=True, parallel_shared_ln=True, tie_embeddings=False,
            unembed_bias=True)
NEOX = dict(vocab=96, d=64, layers=2, heads=4, seq=64, d_ff=128, activation="gelu",
            norm="layernorm", position="rope", rope_theta=10000.0, rotary_dim=8,
            parallel_block=True, attn_qkv_bias=True, attn_out_bias=True, tie_embeddings=False)
SHAPES = {"gptj": GPTJ, "neox": NEOX, "neox-gelu_new": dict(NEOX, activation="gelu_new")}
KINDS = list(SHAPES)
#: the fused kernels each tiny's "pallas" decode runs (B5 always, on the paged
#: engine; B4 not under GPT-J's interleaved RoPE; B6 not under exact gelu)
FUSED = {"gptj": {"attention", "mlp"}, "neox": {"qkv", "attention"},
         "neox-gelu_new": {"qkv", "attention", "mlp"}}
JAX_KERNELS = {"qkv": "fused_qkv_rope_pallas", "attention": "fused_paged_decode_attention_pallas",
               "mlp": "fused_mlp_pallas"}

# the published configs (EleutherAI/gpt-j-6b, EleutherAI/pythia-1.4b), as the
# fields config_from_hf reads them
GPTJ_6B = {"architectures": ["GPTJForCausalLM"], "model_type": "gptj", "n_embd": 4096,
           "n_head": 16, "n_layer": 28, "n_positions": 2048, "rotary_dim": 64,
           "vocab_size": 50400, "activation_function": "gelu_new", "layer_norm_epsilon": 1e-5,
           "tie_word_embeddings": False}
PYTHIA_1B4 = {"architectures": ["GPTNeoXForCausalLM"], "model_type": "gpt_neox",
              "hidden_size": 2048, "intermediate_size": 8192, "num_attention_heads": 16,
              "num_hidden_layers": 24, "max_position_embeddings": 2048, "rotary_pct": 0.25,
              "rotary_emb_base": 10000, "use_parallel_residual": True, "vocab_size": 50304,
              "hidden_act": "gelu", "layer_norm_eps": 1e-5, "tie_word_embeddings": False}


def _tree(kind, seed=1):
    """The JAX init of the ``kind`` tiny with its norm weights and biases
    (the unembedding bias included) drawn from numpy, as nested f32 numpy."""
    tree = jax.tree.map(np.asarray, JTransformer(jtiny(**SHAPES[kind])).init(
        jax.random.PRNGKey(0)))
    rng = np.random.default_rng(seed)

    def walk(node):
        for name, leaf in node.items():
            if isinstance(leaf, dict):
                walk(leaf)
            elif name.endswith("_w") and name.startswith("ln"):
                node[name] = (1 + 0.2 * rng.normal(size=leaf.shape)).astype(np.float32)
            elif name.endswith("_b") or name.startswith("b_"):
                node[name] = (0.1 * rng.normal(size=leaf.shape)).astype(np.float32)

    walk(tree)
    return tree


@pytest.fixture(scope="module", params=KINDS)
def models(request):
    kind = request.param
    tree = _tree(kind)
    jm = JTransformer(jtiny(**SHAPES[kind]))
    tm = Transformer(tiny(**SHAPES[kind]), device="cpu")
    state = params_from_numpy(tree)
    tm.load_params(state)
    return kind, jm, jax.tree.map(jnp.asarray, tree), tm, state


def _cfg(cls, decode_kernel, **kw):
    return cls(dtype="float32", max_seq_len=64, kv_block_size=8, num_kv_blocks=40,
               decode_kernel=decode_kernel,
               serving={"token_budget": 16, "max_running": 4, "chunk_min": 4}, **kw)


def _engines(models, decode_kernel):
    _, jm, jp, tm, state = models
    return (JEngine(jm, jp, _cfg(JConfig, decode_kernel)),
            InferenceEngineV2(tm, state, _cfg(InferenceConfig, decode_kernel), device="cpu"))


def _prompts(seed, lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 90, size=int(n)).tolist() for n in lengths]


# ---------------------------------------------------------------------------
# Configs, leaves, the converter
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("hf", [GPTJ_6B, PYTHIA_1B4, dict(PYTHIA_1B4, use_parallel_residual=False,
                                                          attention_bias=False)],
                         ids=["gpt-j-6b", "pythia-1.4b", "neox-sequential"])
def test_config_from_hf_matches_jax_field_for_field(hf):
    got, want = config_from_hf(hf), jhf.config_from_hf(hf)
    for f in dataclasses.fields(got):
        assert getattr(got, f.name) == getattr(want, f.name), f.name
    ttf.check_servable(got)


def test_published_widths_and_parameter_counts():
    gptj, pythia = config_from_hf(GPTJ_6B), config_from_hf(PYTHIA_1B4)
    assert (gptj.head_dim, gptj.rotary_dims, gptj.ff_dim) == (256, 64, 16384)
    assert (pythia.head_dim, pythia.rotary_dims, pythia.ff_dim) == (128, 32, 8192)
    for cfg in (gptj, pythia):
        shapes = jax.eval_shape(JTransformer(jhf.config_from_hf(
            GPTJ_6B if cfg is gptj else PYTHIA_1B4)).init, jax.random.PRNGKey(0))
        want = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
        assert param_count(cfg) == want
    assert param_count(gptj) == 6_050_882_784 and param_count(pythia) == 1_414_647_808


@pytest.mark.parametrize("kind", KINDS)
def test_leaves_and_the_converter_round_trip_bit_for_bit(kind):
    tree = jax.tree.map(np.asarray, JTransformer(jtiny(**SHAPES[kind])).init(
        jax.random.PRNGKey(3)))
    model = Transformer(tiny(**SHAPES[kind]), device="cpu")
    state = params_from_numpy(tree)
    assert {k: tuple(v.shape) for k, v in state.items()} == model.param_shapes()
    assert ("layers.ln2_w" in state) == (kind != "gptj")
    assert ("unembed_b" in state) == (kind == "gptj")
    assert sum(v.numel() for v in state.values()) == param_count(model.config)
    back = params_to_numpy(state)
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        node = back
        for key in path:
            node = node[key.key]
        np.testing.assert_array_equal(node, leaf)
    port_init = model.init(torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in port_init.items()} == model.param_shapes()


# ---------------------------------------------------------------------------
# RoPE forms and the kernels' plain versions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("interleaved", [False, True], ids=["rotate-half", "interleaved"])
@pytest.mark.parametrize("rd", [16, 8, 4], ids=["full", "half", "quarter"])
def test_apply_rope_forms_equal_jax_exactly(interleaved, rd):
    rng = np.random.default_rng(rd)
    x = rng.standard_normal((2, 7, 3, 16)).astype(np.float32)
    cos, sin = (np.array(t) for t in jtf.rope_table(7, rd, 10000.0))
    want = np.asarray(jtf.apply_rope(jnp.asarray(x), cos, sin, interleaved=interleaved))
    got = ttf.apply_rope(T(x), T(cos), T(sin), interleaved=interleaved).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[..., rd:], x[..., rd:])   # pass-through columns


def _mlp_inputs(seed, B=3, D=64, F=128):
    rng = np.random.default_rng(seed)
    resid, y = (rng.standard_normal((B, D)).astype(np.float32) for _ in range(2))
    ws = [(rng.standard_normal(s) * s[0] ** -0.5).astype(np.float32)
          for s in ((D, F), (D, F), (F, D))]
    b_up = (0.1 * rng.standard_normal(F)).astype(np.float32)
    b_down = (0.1 * rng.standard_normal(D)).astype(np.float32)
    ln = (1 + 0.2 * rng.standard_normal(D)).astype(np.float32)
    return resid, y, ws, b_up, b_down, ln


@pytest.mark.parametrize("gated,bias", [(False, True), (False, False), (True, False)],
                         ids=["plain-bias", "plain", "gated"])
def test_mlp_without_norm_plain_matches_pallas(gated, bias):
    resid, y, (wg, wu, wd), b_up, b_down, ln = _mlp_inputs(seed=int(gated) + 2 * int(bias))
    act = "swiglu" if gated else "gelu_new"
    bkw = {"b_up": b_up, "b_down": b_down} if bias else {}
    want = np.asarray(jfd.fused_mlp_pallas(
        jnp.asarray(resid), jnp.asarray(y), jnp.asarray(ln), None, jnp.asarray(wu),
        jnp.asarray(wd), jnp.asarray(wg) if gated else None,
        **{k: jnp.asarray(v) for k, v in bkw.items()}, norm="layernorm", activation=act,
        apply_norm=False, interpret=True))
    got = tfd.fused_mlp(T(resid), T(y), T(ln), T(wu), T(wd), T(wg) if gated else None,
                        ln_b=T(ln), norm="layernorm", activation=act, apply_norm=False,
                        **{k: T(v) for k, v in bkw.items()}).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    # the bites: the norm applied anyway, y_src swapped for resid
    normed = tfd.fused_mlp(T(resid), T(y), T(ln), T(wu), T(wd), T(wg) if gated else None,
                           ln_b=T(ln), norm="layernorm", activation=act,
                           **{k: T(v) for k, v in bkw.items()}).numpy()
    swapped = tfd.fused_mlp(T(resid), T(resid), T(ln), T(wu), T(wd), T(wg) if gated else None,
                            norm="layernorm", activation=act, apply_norm=False,
                            **{k: T(v) for k, v in bkw.items()}).numpy()
    for bad in (normed, swapped):
        assert np.abs(bad - want).max() > 1e-3 * np.abs(want).max()


@pytest.mark.parametrize("bits", [8, 4, "fp8"], ids=["int8", "int4", "fp8"])
@pytest.mark.parametrize("gated", [False, True], ids=["plain", "gated"])
def test_quantized_mlp_without_norm_plain_matches_pallas(bits, gated):
    resid, y, ws, _, _, ln = _mlp_inputs(seed=7)
    act = "swiglu" if gated else "gelu_new"
    jw = [jqm.quantize_weight(jnp.asarray(w), 32, bits=bits) for w in ws]
    tw = [tqm.quantize_weight(T(w), 32, bits=bits) for w in ws]
    want = np.asarray(jfd.fused_mlp_quant_pallas(
        jnp.asarray(resid), jnp.asarray(y), jnp.asarray(ln), jnp.asarray(ln), jw[1], jw[2],
        jw[0] if gated else None, norm="layernorm", activation=act, apply_norm=False,
        interpret=True))
    got = tfd.fused_mlp(T(resid), T(y), T(ln), tw[1], tw[2], tw[0] if gated else None,
                        ln_b=T(ln), norm="layernorm", activation=act, apply_norm=False).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def _qkv_inputs(seed, H=4, KV=2, Dh=32, rd=8, B=3, bs=8):
    rng = np.random.default_rng(seed)
    D = 64
    y = rng.standard_normal((B, D)).astype(np.float32)
    w = [(rng.standard_normal((D, n * Dh)) * D ** -0.5).astype(np.float32) for n in (H, KV, KV)]
    b = [(0.1 * rng.standard_normal(n * Dh)).astype(np.float32) for n in (H, KV, KV)]
    pos = np.asarray([5, 17, 30][:B], np.int32)
    table = np.arange(B * 4, dtype=np.int32).reshape(B, 4) + 1
    pool = [rng.standard_normal((B * 4 + 1, KV, bs, Dh)).astype(np.float32) for _ in range(2)]
    cos_t, sin_t = jtf.rope_table(64, rd, 10000.0)
    cos, sin = np.asarray(cos_t)[pos], np.asarray(sin_t)[pos]
    return y, w, b, cos, sin, pool, table, pos


@pytest.mark.parametrize("H,KV,rd", [(4, 4, 8), (4, 2, 8), (4, 2, 32)],
                         ids=["mha-rd8", "gqa-rd8", "gqa-full"])
@pytest.mark.parametrize("pooled", [True, False], ids=["pool", "no-pool"])
def test_partial_rotary_qkv_plain_matches_pallas(H, KV, rd, pooled):
    y, w, b, cos, sin, pool, table, pos = _qkv_inputs(seed=H + KV + rd, H=H, KV=KV, rd=rd)
    bs = pool[0].shape[2]
    blk = table[np.arange(len(pos)), pos // bs]
    jkw = dict(pool_k=jnp.asarray(pool[0]), pool_v=jnp.asarray(pool[1]), blk=jnp.asarray(blk),
               off=jnp.asarray(pos % bs)) if pooled else {}
    want = jfd.fused_qkv_rope_pallas(jnp.asarray(y), *(jnp.asarray(m) for m in w),
                                     *(jnp.asarray(x) for x in b), cos=jnp.asarray(cos),
                                     sin=jnp.asarray(sin), n_heads=H, kv_heads=KV,
                                     interpret=True, **jkw)
    pk, pv = T(pool[0].copy()), T(pool[1].copy())
    tkw = dict(pool_k=pk, pool_v=pv, block_table=T(table), pos=T(pos)) if pooled else {}
    got = tfd.fused_qkv_rope(T(y), *(T(m) for m in w), T(cos), T(sin), n_heads=H,
                             kv_heads=KV, bq=T(b[0]), bk=T(b[1]), bv=T(b[2]), **tkw)
    got = list(got) + ([pk, pv] if pooled else [])
    for g, wt in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wt).reshape(g.shape), rtol=1e-5,
                                   atol=1e-5)
    q = got[0].numpy()
    # the bites: rotation over all of Dh, and the pass-through columns rotated
    full = tfd.rope_heads(T(np.zeros((len(pos), 1, 32), np.float32) + 1), T(cos), T(sin))
    assert np.array_equal(full[..., rd:].numpy(), np.ones_like(full[..., rd:].numpy()))
    if rd < 32:
        qc, qs = jtf.rope_table(64, 32, 10000.0)
        whole = tfd.fused_qkv_rope(T(y), *(T(m) for m in w), T(np.asarray(qc)[pos]),
                                   T(np.asarray(qs)[pos]), n_heads=H, kv_heads=KV,
                                   bq=T(b[0]), bk=T(b[1]), bv=T(b[2]))[0].numpy()
        assert np.abs(whole - q).max() > 1e-3


# ---------------------------------------------------------------------------
# The engines against the JAX engines
# ---------------------------------------------------------------------------


@pytest.fixture
def routes(monkeypatch):
    """JAX's fused kernels in interpret mode; per fused kernel, JAX's traces
    and the port wrapper's calls, and the apply_norm of JAX's B6 traces."""
    monkeypatch.setenv("SXT_FUSED_INTERPRET", "1")
    counts = {"jax": dict.fromkeys(JAX_KERNELS, 0), "port": dict.fromkeys(JAX_KERNELS, 0),
              "jax_apply_norm": set()}

    def counted(fn, side, key):
        def wrapper(*a, **kw):
            counts[side][key] += 1
            if side == "jax" and key == "mlp":
                counts["jax_apply_norm"].add(kw.get("apply_norm", True))
            return fn(*a, **kw)
        return wrapper

    for key, name in JAX_KERNELS.items():
        monkeypatch.setattr(jfd, name, counted(getattr(jfd, name), "jax", key))
    for mod, name, key in ((tie, "fused_qkv_rope", "qkv"), (tie, "fused_mlp", "mlp"),
                           (tie2, "fused_qkv_rope", "qkv"),
                           (tie2, "fused_paged_decode_attention", "attention")):
        monkeypatch.setattr(mod, name, counted(getattr(mod, name), "port", key))
    return counts


def _check_routes(counts, kind, kernels=("qkv", "attention", "mlp")):
    for key in kernels:
        want = key in FUSED[kind]
        assert (counts["jax"][key] > 0) == want, (kind, counts)
        assert (counts["port"][key] > 0) == want, (kind, counts)
    if "mlp" in kernels and "mlp" in FUSED[kind]:   # GPT-J's shared ln: B6 without its norm
        assert counts["jax_apply_norm"] == {kind != "gptj"}, counts


def _routes_if(decode_kernel, request):
    return request.getfixturevalue("routes") if decode_kernel == "pallas" else None


@pytest.mark.parametrize("decode_kernel", ["xla", "pallas"])
def test_step_schedule_logits_match_jax(models, decode_kernel, request):
    counts = _routes_if(decode_kernel, request)
    je, te = _engines(models, decode_kernel)
    assert je._decode_kernel == te._decode_kernel == decode_kernel
    p = _prompts(0, (12, 5, 22))
    toks = np.random.default_rng(9).integers(1, 90, size=16).tolist()
    schedule = [
        ([], [], [(0, p[0][:10]), (1, p[1])]),                      # extend only
        ([1], toks[:1], [(0, p[0][10:]), (2, p[2][:8])]),           # mixed
        ([0, 1], toks[1:3], [(2, p[2][8:])]),                       # mixed
        ([0, 1, 2], toks[3:6], []),                                 # decode only
        ([2], toks[8:9], [(3, p[1][:3])]),                          # a new uid mid-decode
    ]
    for tick in schedule:
        jd, jpl = je.step(*tick)
        td, tpl = te.step(*tick)
        np.testing.assert_allclose(td, jd, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(tpl, jpl, rtol=TOL, atol=TOL)
    if counts is not None:
        _check_routes(counts, models[0])


@pytest.mark.parametrize("decode_kernel", ["xla", "pallas"])
def test_serve_tokens_equal_the_jax_scheduler(models, decode_kernel, request):
    counts = _routes_if(decode_kernel, request)
    je, te = _engines(models, decode_kernel)
    prompts = _prompts(2, (12, 5, 22, 9))
    want = JScheduler(je).serve(prompts, max_new_tokens=8)
    got = ContinuousBatchingScheduler(te).serve(prompts, max_new_tokens=8)
    assert got == want
    if counts is not None:
        _check_routes(counts, models[0])


@pytest.mark.parametrize("decode_kernel", ["xla", "pallas"])
def test_put_and_decode_loop_match_jax(models, decode_kernel, request):
    counts = _routes_if(decode_kernel, request)
    je, te = _engines(models, decode_kernel)
    prompts = _prompts(4, (9, 20, 3))
    uids = [0, 1, 2]
    lt, lj = te.put(uids, prompts), je.put(uids, prompts)
    np.testing.assert_allclose(lt, lj, rtol=TOL, atol=TOL)
    first = [int(np.argmax(r)) for r in lt]
    np.testing.assert_array_equal(te.decode_loop(uids, first, 6),
                                  je.decode_loop(uids, first, 6))
    if counts is not None:
        _check_routes(counts, models[0])


@pytest.mark.parametrize("decode_kernel", ["xla", "pallas"])
def test_v1_generate_matches_jax(models, decode_kernel, request):
    counts = _routes_if(decode_kernel, request)
    kind, jm, jp, tm, state = models
    cfg = dict(dtype="float32", max_seq_len=64, decode_kernel=decode_kernel)
    je, te = JEngineV1(jm, jp, JConfig(**cfg)), init_inference(tm, state, cfg, device="cpu")
    rng = np.random.default_rng(11)
    ids = rng.integers(1, 90, size=(3, 13)).astype(np.int32)
    lens = np.asarray([13, 6, 9], np.int32)
    ids[1, 6:] = 0
    ids[2, 9:] = 0
    want = je.generate(ids, prompt_lengths=lens, max_new_tokens=10)
    np.testing.assert_array_equal(te.generate(ids, prompt_lengths=lens, max_new_tokens=10),
                                  want)
    if counts is not None:   # the v1 decode step: fused QKV (no pool) and MLP, no B5
        _check_routes(counts, kind, ("qkv", "mlp"))


def test_the_unembedding_bias_moves_the_logits():
    tm = Transformer(tiny(**GPTJ), device="cpu")
    state = params_from_numpy(_tree("gptj"))
    x = torch.randn(2, 1, 64)
    with_b = tm.head(state, x)
    without = tm.head(dict(state, unembed_b=torch.zeros_like(state["unembed_b"])), x)
    torch.testing.assert_close(with_b - without, state["unembed_b"].expand(2, 1, -1))


# ---------------------------------------------------------------------------
# Launch accounting, with the kernel gate opened onto the plain versions
# ---------------------------------------------------------------------------


@pytest.fixture
def counted_port(monkeypatch):
    """Every port wrapper takes its "kernel" branch with the plain version
    standing in for the launch, so the launch counters move as on the card."""
    from shuffle_exchange_tpu_torch import ops

    for m in (tfd, tpa, tfa):
        monkeypatch.setattr(m, "use_kernel", lambda t: True)
    monkeypatch.setattr(tfd, "_launch_qkv", lambda y, wq, wk, wv, cos, sin, pk, pv, bt, pos, H,
                        KV, biases: tfd.fused_qkv_rope_reference(
                            y, wq, wk, wv, cos, sin, pk, pv, bt, pos, n_heads=H, kv_heads=KV,
                            bq=biases[0], bk=biases[1], bv=biases[2]))
    monkeypatch.setattr(tfd, "_launch_mlp", lambda *a, **k: tfd.fused_mlp_reference(*a, **k))
    monkeypatch.setattr(tfd, "_launch_attention", lambda q, ck, cv, bt, kl, n, sl=None:
                        tfd.fused_paged_decode_reference(q, ck, cv, bt, kl, 2 if n is None else n,
                                                         sl))
    monkeypatch.setattr(tpa, "_launch", lambda kind, q, ck, cv, bt, lens, sl=None: (
        tpa.paged_decode_reference(q, ck, cv, bt, lens, alibi_slopes=sl) if kind == "decode" else
        tpa.paged_extend_reference(q, ck, cv, bt, lens, torch.full_like(lens, q.shape[1]),
                                   alibi_slopes=sl)))
    monkeypatch.setattr(tfa, "_launch", lambda q, k, v, causal, seg, want_lse:
                        tfa.reference_attention_lse(q, k, v, causal, seg))
    monkeypatch.setattr(tfa, "check_operands", lambda *a, **k: None)
    for fn in ops.KERNEL_WRAPPERS.values():
        monkeypatch.setattr(fn, "launches", 0)
    return ops


@pytest.mark.parametrize("decode_kernel", ["pallas", "xla"])
def test_launch_counters_follow_the_programs(models, counted_port, decode_kernel):
    """Per layer and decode row on "pallas": B5 always, B4 unless GPT-J's
    interleaved RoPE keeps the QKV on the layer body, B6 unless exact gelu
    keeps the MLP there; no RMSNorm (layernorm). Chunk rows the extend
    kernel, prefill rows the flash kernel; "xla" decode rows the paged
    decode kernel."""
    kind, *_ = models
    _, te = _engines(models, decode_kernel)
    prompts = _prompts(4, (9, 20, 3))
    uids = [0, 1, 2]
    first = [int(np.argmax(r)) for r in te.put(uids, prompts)]
    te.decode_loop(uids, first, 3)
    te.put([1], [_prompts(5, (11,))[0]])
    by = te.dispatches_by_program
    L, fused = 2, decode_kernel == "pallas"
    dec = by.get("decode", 0) + by.get("mixed", 0) + 3
    ext = by.get("extend", 0) + by.get("mixed", 0)
    want = {k: 0 for k in counted_port.KERNEL_WRAPPERS}
    want.update(flash_attention=L * by["prefill"], paged_extend_attention=L * ext,
                paged_decode_attention=0 if fused else L * dec,
                fused_paged_decode_attention=L * dec if fused else 0,
                fused_qkv_rope=L * dec if fused and "qkv" in FUSED[kind] else 0,
                fused_mlp=L * dec if fused and "mlp" in FUSED[kind] else 0)
    assert counted_port.launch_counts() == want


# ---------------------------------------------------------------------------
# Refusals
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", KINDS)
def test_training_refuses_the_parallel_block_structures(kind):
    """No longer refused: each parallel-block structure (interleaved and
    partial RoPE, the unembedding bias) trains through ``initialize`` and
    ``train_batch`` on the CPU with a finite loss
    (``tests/test_torch_train_parallel_blocks.py`` holds its gradients and
    trajectories against the JAX package)."""
    model = Transformer(tiny(**SHAPES[kind]), device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    assert np.isfinite(model.loss(params, {"input_ids": np.asarray([[1, 2, 3, 4]])}).item())
    engine, *_ = sxt.initialize(model=model, config={
        "train_batch_size": 1, "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}}},
        device="cpu")
    assert np.isfinite(float(engine.train_batch({"input_ids": np.asarray([[1, 2, 3, 4, 5]])})))
    ttf.check_supported(dataclasses.replace(tiny(tie_embeddings=False), unembed_bias=True))


def test_falcon_and_the_wide_split_k_groups_refuse(monkeypatch):
    """Neither refuses: Falcon-7B's config maps as JAX maps it, and the
    split-K and paged wrappers hand its group (71 query heads of 64 over one
    kv head; B3 also 65) to their C entry points, B5 with B2's split
    length in whole table entries (16 splits of 2 entries for 8 rows of 32
    table entries of 64 positions on 132 SMs)."""
    falcon = {"architectures": ["FalconForCausalLM"], "model_type": "falcon",
              "hidden_size": 4544, "num_attention_heads": 71, "num_hidden_layers": 32,
              "vocab_size": 65024, "multi_query": True, "parallel_attn": True}
    cfg, jcfg = config_from_hf(falcon), jhf.config_from_hf(falcon)
    assert all(getattr(cfg, f.name) == getattr(jcfg, f.name) for f in dataclasses.fields(cfg))
    assert (cfg.n_heads, cfg.kv_heads, cfg.head_dim) == (71, 1, 64)
    calls = {}

    class Lib:   # records each C call's arguments
        def __getattr__(self, name):
            return lambda *args: calls.setdefault(name, args) and 0

    # the device and storage checks pass as on the card; the C call is recorded
    for mod in (tfd, tpa):
        monkeypatch.setattr(mod, "_lib", Lib)
        monkeypatch.setattr(mod, "pool_kind", lambda *a: 0)
    for mod in (tfd, tpa):
        monkeypatch.setattr(mod, "_sms", lambda dev: 132)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: type("S", (), {"cuda_stream": 0}))
    q = torch.zeros(8, 1, 71, 64, dtype=torch.bfloat16)
    pool = torch.zeros(33, 1, 64, 64, dtype=torch.bfloat16)
    table = torch.arange(1, 33, dtype=torch.int32).repeat(8, 1)
    lens = torch.full((8,), 2048, dtype=torch.int32)
    assert tfd._launch_attention(q, pool, pool, table, lens, None).shape == q.shape
    assert calls["sxt_fused_paged_decode"][14:17] == (8, 71, 1)
    assert calls["sxt_fused_paged_decode"][20] == 16 == tfd.attention_splits(8, 1, 32, 64, 132)
    assert tfd.attention_splits(1, 1, 32, 64, 132) == 16
    assert tpa._launch("decode", q, pool, pool, table, lens).shape == q.shape
    assert calls["sxt_paged_decode"][13:16] == (8, 71, 1)
    eq = torch.zeros(2, 8, 65, 64, dtype=torch.bfloat16)
    assert tpa._launch("extend", eq, pool, pool, table[:2], lens[:2]).shape == eq.shape
    assert calls["sxt_paged_extend"][10:14] == (2, 8, 65, 1)


def test_head_dim_256_refusals_of_the_flash_backward_and_alibi():
    """The flash forward and backward and the paged kernels take 256 (the
    forward and the paged kernels 80 and 96 too); the flash backward
    refuses 80 / 96 naming item 4 (h); the ALiBi kernels take 64 and 128
    alone, as the TPU ones do."""
    q = torch.zeros(1, 8, 2, 256, dtype=torch.bfloat16)
    tfa.check_operands(q, q, q)   # the forward is built for 256, and the backward
    tfa.check_operands(q, q, q, backward=True, out=q, dout=q)
    assert 256 in tfa.BWD_HEAD_DIMS
    for dh in (80, 96):
        q80 = torch.zeros(1, 8, 2, dh, dtype=torch.bfloat16)
        tfa.check_operands(q80, q80, q80)
        with pytest.raises(ValueError, match=f"head_dim {dh} not built .*item 4 \\(h\\)"):
            tfa.check_operands(q80, q80, q80, backward=True, out=q80, dout=q80)
    with pytest.raises(ValueError, match="head_dim 256 not built"):
        tal.check_operands(q, q, q, torch.ones(2))
    assert {80, 96, 256} <= set(tpa.HEAD_DIMS) and 256 not in tal.HEAD_DIMS
