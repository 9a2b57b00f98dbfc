"""Weight-quantized serving of the layernorm / gelu / bias families in the
PyTorch port against the JAX package, on the CPU, in f32.

- B7's forms: the plain quantized fused MLP (``fused_mlp_quant_reference``
  behind ``fused_mlp``) against ``fused_mlp_quant_pallas(interpret=True)``
  for every norm (RMSNorm, layernorm with its bias), gate (SwiGLU form or
  the plain MLP), fusable activation and storage format, within 1e-4;
  broken plain versions (a dropped ``ln_b``, the gate read on the plain
  form, gelu_new computed as relu, layernorm computed as RMSNorm) must
  miss it.
- Engines on ``tests/serve_alibi_gpt2_cases.py``'s BLOOM- and GPT-2-shaped
  tinies (norm weights and biases drawn from numpy) with
  ``quantize_weights`` int8 / int4 / fp8 at group 32: ``step()`` and
  ``put()`` logits within 1e-4, ``decode_loop`` / ``serve()`` / v1 tokens
  exact, on "xla" and "pallas". The fc biases keep the MLP on the layer
  body on both sides (JAX's "quantized MLP weights with fc biases"), and
  the quantized q/k/v leave the fused QKV kernel, so "pallas" runs only
  the split-K attention fused; the JAX kernels' traces and the port
  wrappers' calls are counted, since the JAX engine drops to its XLA body
  silently when a fused kernel fails.
- BLOOM's tiny with ``mlp_bias=False``: the quantized MLP reaches B7 in its
  layernorm + plain + ``gelu_new`` form on both sides (JAX's
  ``fused_mlp_quant_pallas`` traced, the port's ``fused_mlp_quant``
  called), on every entry point.
- BLOOM's tiny with int8 weights over an int8 KV pool.
- The engines' stored quantized bytes and scales equal JAX's; biases,
  norms, positions, ``embed_ln`` and the tied embedding stay as given.
- The launch counters with the kernel gate opened onto the plain versions.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shuffle_exchange_tpu.inference import ContinuousBatchingScheduler as JScheduler
from shuffle_exchange_tpu.inference import InferenceConfig as JConfig
from shuffle_exchange_tpu.inference import InferenceEngine as JEngineV1
from shuffle_exchange_tpu.inference import InferenceEngineV2 as JEngine
from shuffle_exchange_tpu.models import Transformer as JTransformer
from shuffle_exchange_tpu.models import tiny as jtiny
from shuffle_exchange_tpu_torch.inference import (ContinuousBatchingScheduler, InferenceConfig,
                                                  InferenceEngineV2, init_inference)
from shuffle_exchange_tpu_torch.models import Transformer, params_from_numpy, tiny
from test_torch_quant import BIT_IDS, BITS, _bytes, _jax_q_bytes, counted_port  # noqa: F401
from test_torch_train_alibi_gpt2 import SHAPES, _tree

jqm = importlib.import_module("shuffle_exchange_tpu.ops.quant_matmul")
jfd = importlib.import_module("shuffle_exchange_tpu.ops.fused_decode")
tqm = importlib.import_module("shuffle_exchange_tpu_torch.ops.quant_matmul")
tfd = importlib.import_module("shuffle_exchange_tpu_torch.ops.fused_decode")
tie = importlib.import_module("shuffle_exchange_tpu_torch.inference.engine")
tie2 = importlib.import_module("shuffle_exchange_tpu_torch.inference.engine_v2")

T = torch.from_numpy
TOL = 1e-4
GS = 32     # the tinies' width: every matrix takes the same group

# ---------------------------------------------------------------------------
# B7's forms: the plain version against the Pallas kernel in interpret mode
# ---------------------------------------------------------------------------

ACTIVATIONS = ("silu", "relu", "gelu_new", "gelu_pytorch_tanh")


def _mlp_case(bits, seed, B=3, D=128, F=256, gs=64):
    rng = np.random.default_rng(seed)
    resid, y = (rng.standard_normal((B, D)).astype(np.float32) for _ in range(2))
    lnw = (1 + 0.2 * rng.standard_normal(D)).astype(np.float32)
    lnb = (0.3 * rng.standard_normal(D)).astype(np.float32)
    ws = [(rng.standard_normal(s) * s[0] ** -0.5).astype(np.float32)
          for s in ((D, F), (D, F), (F, D))]
    jw = [jqm.quantize_weight(jnp.asarray(w), gs, bits=bits) for w in ws]
    tw = [tqm.quantize_weight(T(w), gs, bits=bits) for w in ws]
    return (resid, y, lnw, lnb), jw, tw


def _pallas(act, resid, y, lnw, lnb, jw, gated, norm):
    jg, ju, jd = jw
    return np.asarray(jfd.fused_mlp_quant_pallas(
        jnp.asarray(resid), jnp.asarray(y), jnp.asarray(lnw), jnp.asarray(lnb), ju, jd,
        jg if gated else None, norm=norm, eps=1e-5, activation=act, interpret=True))


@pytest.mark.parametrize("bits", BITS, ids=BIT_IDS)
@pytest.mark.parametrize("act", ACTIVATIONS)
@pytest.mark.parametrize("gated", [True, False], ids=["gated", "plain"])
@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm"])
def test_b7_form_plain_matches_pallas(norm, gated, act, bits):
    (resid, y, lnw, lnb), jw, (tg, tu, td) = _mlp_case(bits, seed=len(act) + gated)
    gate = tg if gated else None
    got = tfd.fused_mlp(T(resid), T(y), T(lnw), tu, td, gate, eps=1e-5, ln_b=T(lnb), norm=norm,
                        activation=act).numpy()
    want = _pallas(act, resid, y, lnw, lnb, jw, gated, norm)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(got, tfd.fused_mlp_quant(
        T(resid), T(y), T(lnw), tu, td, gate, ln_b=T(lnb), norm=norm, activation=act).numpy())
    assert tfd.fused_mlp_quant.launches == 0      # a CPU tensor takes the plain version


def _broken(name, resid, y, lnw, lnb, tw, gated, norm, act):
    """A plain version with one deliberate fault."""
    f32 = torch.float32
    g, u, d = (w.dequantize(f32) for w in tw)
    x = T(y)
    if norm == "layernorm" and name != "layernorm-as-rmsnorm":
        yn = (x - x.mean(-1, keepdim=True)) / torch.sqrt(x.var(-1, keepdim=True,
                                                                unbiased=False) + 1e-5)
        yn = yn * T(lnw) + (0 if name == "dropped-ln_b" else T(lnb))
    else:
        yn = x * torch.rsqrt((x * x).mean(-1, keepdim=True) + 1e-5) * T(lnw)
    fn = tfd._act_f32("relu" if name == "gelu_new-as-relu" else act)
    uu = yn @ u
    if gated:
        a = fn(yn @ g) * uu
    else:
        a = fn(uu) * uu if name == "gate-read-on-plain" else fn(uu)
    return (T(resid) + a @ d).numpy()


@pytest.mark.parametrize("bite,gated,norm,act", [
    ("dropped-ln_b", False, "layernorm", "gelu_new"),
    ("gate-read-on-plain", False, "rmsnorm", "relu"),
    ("gelu_new-as-relu", True, "layernorm", "gelu_new"),
    ("layernorm-as-rmsnorm", False, "layernorm", "gelu_pytorch_tanh"),
], ids=lambda v: v if isinstance(v, str) else None)
@pytest.mark.parametrize("bits", BITS, ids=BIT_IDS)
def test_b7_broken_plain_versions_miss_the_tolerance(bits, bite, gated, norm, act):
    (resid, y, lnw, lnb), jw, tw = _mlp_case(bits, seed=3)
    want = _pallas(act, resid, y, lnw, lnb, jw, gated, norm)
    good = _broken("none", resid, y, lnw, lnb, tw, gated, norm, act)
    np.testing.assert_allclose(good, want, rtol=TOL, atol=TOL)
    bad = _broken(bite, resid, y, lnw, lnb, tw, gated, norm, act)
    assert not np.allclose(bad, want, rtol=TOL, atol=TOL), bite


# ---------------------------------------------------------------------------
# Engines against the JAX engines
# ---------------------------------------------------------------------------

#: the three tinies: BLOOM's and GPT-2's shapes, and BLOOM's without fc biases
#: (the form that reaches B7: layernorm + plain MLP + gelu_new)
MODELS = {"bloom": ("bloom", {}), "gpt2": ("gpt2", {}),
          "bloom-nobias": ("bloom", {"mlp_bias": False})}
JAX_KERNELS = {"qkv": "fused_qkv_rope_pallas", "attention": "fused_paged_decode_attention_pallas",
               "mlp": "fused_mlp_pallas", "mlp_quant": "fused_mlp_quant_pallas"}
#: the fused kernels "pallas" decode rows run under quantized weights: the
#: quantized q/k/v leave the fused QKV kernel, and an MLP with fc biases
#: stays on the layer body
FUSED = {"bloom": {"attention"}, "gpt2": {"attention"}, "bloom-nobias": {"attention", "mlp_quant"}}


@pytest.fixture(scope="module", params=list(MODELS))
def models(request):
    kind, kw = MODELS[request.param]
    tree = _tree(kind, seed=1, **kw)
    jm = JTransformer(jtiny(**SHAPES[kind], **kw))
    jp = jax.tree.map(jnp.asarray, tree)
    tm = Transformer(tiny(**SHAPES[kind], **kw), device="cpu")
    state = params_from_numpy(tree)
    tm.load_params(state)
    return request.param, jm, jp, tm, state


@pytest.fixture
def routes(monkeypatch):
    """JAX's fused kernels through the Pallas interpreter; per fused
    kernel, the JAX kernel's traces and the port wrapper's calls."""
    monkeypatch.setenv("SXT_FUSED_INTERPRET", "1")
    counts = {"jax": dict.fromkeys(JAX_KERNELS, 0), "port": dict.fromkeys(JAX_KERNELS, 0)}

    def counted(fn, side, key):
        def wrapper(*a, **kw):
            counts[side][key] += 1
            return fn(*a, **kw)
        return wrapper

    for key, name in JAX_KERNELS.items():
        monkeypatch.setattr(jfd, name, counted(getattr(jfd, name), "jax", key))
    for mod, name, key in ((tie, "fused_qkv_rope", "qkv"), (tie2, "fused_qkv_rope", "qkv"),
                           (tie2, "fused_paged_decode_attention", "attention"),
                           (tfd, "fused_mlp_quant", "mlp_quant")):
        monkeypatch.setattr(mod, name, counted(getattr(mod, name), "port", key))
    return counts


def _check_routes(counts, name, kernels=tuple(JAX_KERNELS)):
    """Each side ran exactly the fused kernels the model earns; the port's
    dense ``fused_mlp`` is not wrapped (``fused_mlp_quant`` is called
    through it)."""
    for key in kernels:
        want = key in FUSED[name]
        assert (counts["jax"][key] > 0) == want, (key, counts)
        if key != "mlp":
            assert (counts["port"][key] > 0) == want, (key, counts)


def _cfg(cls, bits, decode_kernel, num_kv_blocks=40, **kw):
    return cls(dtype="float32", max_seq_len=64, kv_block_size=8, num_kv_blocks=num_kv_blocks,
               decode_kernel=decode_kernel, quantize_weights=True, quant_bits=bits,
               quant_group_size=GS, serving={"token_budget": 16, "max_running": 4,
                                             "chunk_min": 4}, **kw)


def _engines(models, bits, decode_kernel, num_kv_blocks=40):
    _, jm, jp, tm, state = models
    return (JEngine(jm, jp, _cfg(JConfig, bits, decode_kernel, num_kv_blocks)),
            InferenceEngineV2(tm, state, _cfg(InferenceConfig, bits, decode_kernel,
                                              num_kv_blocks), device="cpu"))


def _prompts(seed, lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 90, size=int(n)).tolist() for n in lengths]


def _routes_if(decode_kernel, request):
    return request.getfixturevalue("routes") if decode_kernel == "pallas" else None


@pytest.mark.parametrize("decode_kernel", ["xla", "pallas"])
@pytest.mark.parametrize("bits", BITS, ids=BIT_IDS)
def test_step_schedule_logits_match_jax(models, bits, decode_kernel, request):
    counts = _routes_if(decode_kernel, request)
    je, te = _engines(models, bits, decode_kernel)
    assert je._decode_kernel == te._decode_kernel == decode_kernel
    assert isinstance(te.params["layers.w_up"], tqm.QuantizedMatrix)
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
        np.testing.assert_allclose(td, jd, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(tpl, jpl, rtol=TOL, atol=TOL)
    if counts is not None:
        _check_routes(counts, models[0])


@pytest.mark.parametrize("decode_kernel", ["xla", "pallas"])
@pytest.mark.parametrize("bits", BITS, ids=BIT_IDS)
def test_serve_tokens_equal_the_jax_scheduler(models, bits, decode_kernel, request):
    counts = _routes_if(decode_kernel, request)
    je, te = _engines(models, bits, decode_kernel)
    prompts = _prompts(2, (12, 5, 22, 9))
    js, ts = JScheduler(je), ContinuousBatchingScheduler(te)
    want = js.serve(prompts, max_new_tokens=8)
    got = ts.serve(prompts, max_new_tokens=8)
    assert got == want
    assert ts.ticks == js.ticks and ts.preemptions == js.preemptions == 0
    if counts is not None:
        _check_routes(counts, models[0])


@pytest.mark.parametrize("decode_kernel", ["xla", "pallas"])
@pytest.mark.parametrize("bits", BITS, ids=BIT_IDS)
def test_put_and_decode_loop_match_jax(models, bits, decode_kernel, request):
    counts = _routes_if(decode_kernel, request)
    je, te = _engines(models, bits, decode_kernel)
    prompts = _prompts(4, (9, 20, 3))
    uids = [0, 1, 2]
    lt, lj = te.put(uids, prompts), je.put(uids, prompts)
    np.testing.assert_allclose(lt, lj, rtol=TOL, atol=TOL)
    first = [int(np.argmax(r)) for r in lt]
    np.testing.assert_array_equal(te.decode_loop(uids, first, 6), je.decode_loop(uids, first, 6))
    ext = _prompts(5, (11,))[0]
    np.testing.assert_allclose(te.put([1], [ext]), je.put([1], [ext]), rtol=TOL, atol=TOL)
    assert te.program_shapes == je.program_shapes
    if counts is not None:
        _check_routes(counts, models[0])


@pytest.mark.parametrize("decode_kernel", ["xla", "pallas"])
@pytest.mark.parametrize("bits", BITS, ids=BIT_IDS)
def test_v1_generate_matches_jax(models, bits, decode_kernel, request):
    counts = _routes_if(decode_kernel, request)
    name, jm, jp, tm, state = models
    cfg = dict(dtype="float32", max_seq_len=64, decode_kernel=decode_kernel,
               quantize_weights=True, quant_bits=bits, quant_group_size=GS)
    je, te = JEngineV1(jm, jp, JConfig(**cfg)), init_inference(tm, state, cfg, device="cpu")
    rng = np.random.default_rng(11)
    ids = rng.integers(1, 90, size=(3, 13)).astype(np.int32)
    lens = np.asarray([13, 6, 9], np.int32)
    ids[1, 6:] = 0
    ids[2, 9:] = 0
    want = je.generate(ids, prompt_lengths=lens, max_new_tokens=10)
    np.testing.assert_array_equal(te.generate(ids, prompt_lengths=lens, max_new_tokens=10), want)
    if counts is not None:   # the v1 decode step: the fused MLP alone
        _check_routes(counts, name, ("qkv", "mlp", "mlp_quant"))


@pytest.mark.parametrize("bits", BITS, ids=BIT_IDS)
def test_stored_weights_equal_jax(models, bits):
    """The quantized leaves' bytes and scales equal the JAX engine's; every
    other leaf (biases, norms, learned positions, ``embed_ln``, the tied
    embedding) equals the weights given."""
    name, _, _, _, state = models
    je, te = _engines(models, bits, "xla")
    jtree = jax.tree.map(np.asarray, je.params)
    fed = params_from_numpy(jtree)
    assert set(fed) == set(te.params) and "unembed" not in te.params
    quantized = {k for k, v in te.params.items() if isinstance(v, tqm.QuantizedMatrix)}
    want = {"layers." + n for n in ("wq", "wk", "wv", "wo", "w_up", "w_down")}
    assert quantized == want
    for k, v in te.params.items():
        if k in quantized:
            f = fed[k]
            assert (f.bits, f.group_size, f.shape) == (v.bits, v.group_size, v.shape)
            np.testing.assert_array_equal(_bytes(v.q), _bytes(f.q))
            np.testing.assert_array_equal(v.scales.numpy(), f.scales.numpy())
        else:
            np.testing.assert_array_equal(v.numpy(), fed[k].numpy())
            np.testing.assert_array_equal(v.numpy(), state[k].numpy())


# ---------------------------------------------------------------------------
# Launch accounting, with the kernel gate opened onto the plain versions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("decode_kernel", ["pallas", "xla"])
def test_launch_counters_follow_the_programs(models, counted_port, decode_kernel):
    """Per layer, every row takes B8 on q, k, v and wo; the MLP takes B8 on
    w_up and w_down, except on a fused decode row of the bias-free MLP,
    which takes B7 once. Decode rows take the split-K attention (fused) or
    the paged decode kernel, chunk rows the extend kernel; layernorm is
    plain PyTorch, so no RMSNorm launch."""
    name = models[0]
    _, te = _engines(models, 8, decode_kernel)
    p = _prompts(0, (12, 5))
    for tick in ([], [], [(0, p[0]), (1, p[1])]), ([0, 1], [3, 4], []), ([1], [5], [(2, p[1])]):
        te.step(*tick)
    by = te.dispatches_by_program
    L = 2
    dec, ext = by["decode"] + by["mixed"], by["extend"] + by["mixed"]
    fused = decode_kernel == "pallas"
    b7 = fused and name == "bloom-nobias"
    want = {k: 0 for k in counted_port.KERNEL_WRAPPERS}
    want.update(paged_extend_attention=L * ext,
                quant_matmul=6 * L * ext + (4 if b7 else 6) * L * dec)
    if fused:
        want.update(fused_paged_decode_attention=L * dec, fused_mlp_quant=L * dec if b7 else 0)
    else:
        want.update(paged_decode_attention=L * dec)
    assert counted_port.launch_counts() == want


@pytest.mark.parametrize("decode_kernel", ["xla", "pallas"])
def test_int8_kv_under_int8_weights_matches_jax(decode_kernel, request):
    """BLOOM's tiny with int8 weights over an int8 KV pool: the slopes and
    the scale planes in one attention kernel, the quantized q/k/v with
    their biases outside the fused QKV kernel; ``step()`` and ``put()``
    logits within 1e-4 and ``decode_loop`` tokens exact."""
    counts = _routes_if(decode_kernel, request)
    tree = _tree("bloom", seed=1)
    jm, tm = JTransformer(jtiny(**SHAPES["bloom"])), Transformer(tiny(**SHAPES["bloom"]),
                                                                 device="cpu")
    state = params_from_numpy(tree)
    tm.load_params(state)
    je = JEngine(jm, jax.tree.map(jnp.asarray, tree),
                 _cfg(JConfig, 8, decode_kernel, kv_cache_dtype="int8"))
    te = InferenceEngineV2(tm, state, _cfg(InferenceConfig, 8, decode_kernel,
                                           kv_cache_dtype="int8"), device="cpu")
    assert te.cache.quantized
    p = _prompts(0, (12, 5))
    for tick in ([], [], [(0, p[0]), (1, p[1])]), ([0, 1], [3, 4], []), ([1], [5], [(2, p[1])]):
        jd, jpl = je.step(*tick)
        td, tpl = te.step(*tick)
        np.testing.assert_allclose(td, jd, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(tpl, jpl, rtol=TOL, atol=TOL)
    prompts = _prompts(4, (9, 20))
    lt = te.put([5, 6], prompts)
    np.testing.assert_allclose(lt, je.put([5, 6], prompts), rtol=TOL, atol=TOL)
    first = [int(np.argmax(r)) for r in lt]
    np.testing.assert_array_equal(te.decode_loop([5, 6], first, 6),
                                  je.decode_loop([5, 6], first, 6))
    if counts is not None:
        _check_routes(counts, "bloom", ("qkv", "attention", "mlp", "mlp_quant"))
