"""The PyTorch port's weight-quantized serving against the JAX package.

Everything runs for the three storage formats (int8, packed int4, e4m3),
on inputs made with numpy from a seed:

- Quantizer: ``quantize_weight`` gives JAX's ``q`` and ``scales`` bit for
  bit (2-D and stacked weights, the group halving to 32 and its refusal
  below), e4m3 rounding at every midpoint between codes up to 448 equals
  JAX's, the int4 bytes equal JAX's packing, and the flat ``quantize_
  dequantize`` round trip (a trailing partial group) equals JAX's.
- The quantized matmul's plain version meets JAX ``quant_matmul`` (its
  default, the dequantize-into-the-dot formula) and ``_quant_matmul_pallas
  (interpret=True)`` in f32 within 2e-4 (``tests/test_ops.py``'s
  tolerance) on ragged rows, and the default within one bf16 step in bf16.
- The quantized fused MLP's plain version meets ``fused_mlp_quant_pallas
  (interpret=True)`` in f32 within 1e-4; ``mlp_weights_fusable`` gives the
  JAX reasons.
- Engines (the tiny Llama of ``tests/test_torch_fused_decode.py``, f32,
  ``quant_group_size`` 64) against the JAX engines with
  ``SXT_FUSED_INTERPRET=1``: v1 ``generate`` tokens exact, ``step()``
  logits within 1e-4 on both decode paths, ``put()`` logits within 1e-4,
  ``decode_loop`` and ``serve()`` tokens exact (with preemption too). The
  JAX engine drops to its XLA body when a fused kernel fails, so the
  tests count the traces of its kernels; the port's launch counters are
  read with the kernel gate opened onto the plain versions.
- Config: the ``quant`` section, ``quant_bits`` spellings and refusals,
  ``dtype: "int8"``, as the JAX config reads them.

The CUDA kernels run only on the card, where ``chip_smoke.py`` holds each
against its plain version.
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
from shuffle_exchange_tpu_torch.config import ConfigError
from shuffle_exchange_tpu_torch.inference import (ContinuousBatchingScheduler, InferenceConfig,
                                                  InferenceEngineV2, init_inference)
from shuffle_exchange_tpu_torch.models import (QuantizedArrays, Transformer, params_from_numpy,
                                               params_to_numpy, tiny)

jq = importlib.import_module("shuffle_exchange_tpu.ops.quant")
jqm = importlib.import_module("shuffle_exchange_tpu.ops.quant_matmul")
jfd = importlib.import_module("shuffle_exchange_tpu.ops.fused_decode")
tq = importlib.import_module("shuffle_exchange_tpu_torch.ops.quant")
tqm = importlib.import_module("shuffle_exchange_tpu_torch.ops.quant_matmul")
tfd = importlib.import_module("shuffle_exchange_tpu_torch.ops.fused_decode")

T = torch.from_numpy
BITS = [8, 4, "fp8"]
BIT_IDS = ["int8", "int4", "fp8"]


def _bytes(t: torch.Tensor) -> np.ndarray:
    return (t.view(torch.uint8) if t.dtype == tqm.FP8 else t).numpy()


def _jax_q_bytes(qm) -> np.ndarray:
    q = np.asarray(qm.q)
    return q.view(np.uint8) if qm.bits == "fp8" else q


def _within_one_bf16_step(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    err = np.abs(got - want)
    assert (err <= 2 ** -7 * np.abs(want) + 1e-5).all(), err.max()


# ---------------------------------------------------------------------------
# Quantizer
# ---------------------------------------------------------------------------

SHAPES = {"2d": (256, 128), "stacked": (3, 512, 384), "halved-to-32": (2, 96, 64)}


@pytest.mark.parametrize("shape", list(SHAPES.values()), ids=list(SHAPES))
@pytest.mark.parametrize("bits", BITS, ids=BIT_IDS)
def test_quantize_weight_is_bit_equal_to_jax(bits, shape):
    w = np.random.default_rng(len(shape)).standard_normal(shape).astype(np.float32)
    want = jqm.quantize_weight(jnp.asarray(w), 256, bits=bits)
    got = tqm.quantize_weight(T(w), 256, bits=bits)
    assert got.group_size == want.group_size == (32 if shape[-2] == 96 else 256)
    assert got.shape == tuple(want.shape) and got.ndim == want.ndim
    assert got.nbytes == want.nbytes
    np.testing.assert_array_equal(_bytes(got.q), _jax_q_bytes(want))
    np.testing.assert_array_equal(got.scales.numpy(), np.asarray(want.scales))
    np.testing.assert_array_equal(got.dequantize().numpy(), np.asarray(want.dequantize()))


@pytest.mark.parametrize("bits", BITS, ids=BIT_IDS)
def test_quantize_weight_refuses_groups_below_32(bits):
    w = np.ones((80, 64), np.float32)
    with pytest.raises(ValueError):
        jqm.quantize_weight(jnp.asarray(w), 256, bits=bits)
    with pytest.raises(ValueError, match="K=80"):
        tqm.quantize_weight(T(w), 256, bits=bits)
    with pytest.raises(ValueError, match="bits"):
        tqm.quantize_weight(T(w), 256, bits=16)


def test_fp8_rounding_near_448_equals_jax():
    """Every midpoint between neighbouring e4m3 codes in [0, 448], one f32
    step either side of it, and the codes themselves, scaled so that one
    group's absmax maps to 448: the port's bytes equal JAX's."""
    codes = np.unique(np.abs(np.arange(256, dtype=np.uint8).view(jnp.float8_e4m3fn)
                             .astype(np.float32)))
    codes = codes[np.isfinite(codes)]
    mids = (codes[1:] + codes[:-1]) / 2
    vals = np.concatenate([codes, mids, np.nextafter(mids, 0), np.nextafter(mids, 1e9)])
    vals = np.concatenate([vals, -vals]).astype(np.float32) * np.float32(0.37)
    K = 32 * -(-len(vals) // 32)
    w = np.zeros((K, 2), np.float32)
    w[:len(vals), 0] = vals
    w[::32, :] = 448 * np.float32(0.37)            # every group's absmax
    w[:len(vals), 1] = vals[::-1] * np.float32(1.1)
    want = jqm.quantize_weight(jnp.asarray(w), 32, bits="fp8")
    got = tqm.quantize_weight(T(w), 32, bits="fp8")
    np.testing.assert_array_equal(_bytes(got.q), _jax_q_bytes(want))
    assert np.abs(got.q.float().numpy()).max() == 448


@pytest.mark.parametrize("gs", [32, 64, 256])
def test_int4_packing_equals_jax_bytes(gs):
    rng = np.random.default_rng(gs)
    q = rng.integers(-7, 8, size=(2, 2 * gs, 48)).astype(np.int32)
    want = np.asarray(jqm._pack_int4(jnp.asarray(q), gs))
    got = tqm._pack_int4(T(q), gs)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tqm._unpack_int4(got, gs).numpy(), q)
    np.testing.assert_array_equal(np.asarray(jqm._unpack_int4(jnp.asarray(want), gs)), q)
    # row r of a group holds the low nibble, row r + gs/2 the high one
    assert got[0, 0, 0].item() == (q[0, 0, 0] & 0xF) | ((q[0, gs // 2, 0] & 0xF) << 4)


@pytest.mark.parametrize("kind", ["int8", "fp8"])
def test_quantize_dequantize_equals_jax(kind):
    """Flat groups of 64 over a [5, 77] tensor: the trailing group is 1/64
    real values and 63 zeros of padding."""
    x = np.random.default_rng(3).standard_normal((5, 77)).astype(np.float32) * 3
    if kind == "int8":
        want, got = jq.quantize_dequantize(jnp.asarray(x), 64), tq.quantize_dequantize(T(x), 64)
        jqs, tqs = jq.quantize_int8(jnp.asarray(x), 64), tq.quantize_int8(T(x), 64)
    else:
        want = jq.quantize_dequantize_fp8(jnp.asarray(x), 64)
        got = tq.quantize_dequantize_fp8(T(x), 64)
        jqs, tqs = jq.quantize_fp8(jnp.asarray(x), 64), tq.quantize_fp8(T(x), 64)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(_bytes(tqs[0]), np.asarray(jqs[0]).view(
        np.uint8 if kind == "fp8" else np.int8))
    np.testing.assert_array_equal(tqs[1].numpy(), np.asarray(jqs[1]))
    assert tqs[0].shape == (7, 64)


# ---------------------------------------------------------------------------
# The quantized matmul (B8)
# ---------------------------------------------------------------------------


def _pair(bits, K, N, gs, seed, dtype=np.float32):
    w = (np.random.default_rng(seed).standard_normal((K, N)) * K ** -0.5).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    return (jqm.quantize_weight(jnp.asarray(w), gs, dtype=jdt, bits=bits),
            tqm.quantize_weight(T(w), gs, dtype=tdt, bits=bits))


@pytest.mark.parametrize("N", [128, 384])
@pytest.mark.parametrize("M", [1, 19, 37])
@pytest.mark.parametrize("bits", BITS, ids=BIT_IDS)
def test_quant_matmul_plain_matches_jax_f32(bits, M, N):
    jw, tw = _pair(bits, 256, N, 128, seed=M + N)
    x = np.random.default_rng(M).standard_normal((M, 256)).astype(np.float32)
    got = (T(x) @ tw).numpy()                       # __rmatmul__ -> quant_matmul
    np.testing.assert_array_equal(got, tqm.quant_matmul(T(x), tw).numpy())
    for want in (jqm.quant_matmul(jnp.asarray(x), jw),
                 jqm._quant_matmul_pallas(jnp.asarray(x), jw, interpret=True)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("bits", BITS, ids=BIT_IDS)
def test_quant_matmul_plain_bf16_within_one_step(bits):
    jw, tw = _pair(bits, 512, 256, 64, seed=1, dtype="bf16")
    x = np.random.default_rng(2).standard_normal((2, 9, 512)).astype(np.float32)
    tx = T(x).bfloat16()
    got = tx @ tw
    want = jqm.quant_matmul(jnp.asarray(tx.float().numpy(), jnp.bfloat16), jw)
    assert got.dtype == torch.bfloat16 and got.shape == (2, 9, 256)
    _within_one_bf16_step(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


def test_quantized_matrix_surface():
    w = np.random.default_rng(0).standard_normal((4, 128, 64)).astype(np.float32)
    qm = tqm.quantize_weight(T(w), 64, bits=4)
    assert qm.shape == (4, 128, 64) and qm.q.shape == (4, 64, 64) and qm.ndim == 3
    assert qm.nbytes == 4 * 64 * 64 + 4 * 4 * 2 * 64
    layer = qm[2]
    assert layer.shape == (128, 64) and layer.bits == 4 and layer.group_size == 64
    np.testing.assert_array_equal(layer.dequantize().numpy(), qm.dequantize()[2].numpy())
    assert qm.to("cpu", torch.bfloat16).dequantize().dtype == torch.bfloat16
    with pytest.raises(IndexError):
        layer[0]
    with pytest.raises(ValueError, match="2D"):
        tqm.quant_matmul(torch.zeros(1, 128), qm)
    with pytest.raises(ValueError, match="impl"):
        tqm.quant_matmul(torch.zeros(1, 128), layer, impl="xla")
    with pytest.raises(ValueError, match="contraction"):
        torch.zeros(1, 64) @ layer


def test_quant_matmul_on_cpu_counts_no_launch():
    _, tw = _pair(8, 256, 128, 64, seed=0)
    before = tqm.quant_matmul.launches
    torch.zeros(3, 256) @ tw
    assert tqm.quant_matmul.launches == before


# ---------------------------------------------------------------------------
# The quantized fused MLP (B7)
# ---------------------------------------------------------------------------


def _mlp_case(bits, gs, B, seed, D=128, F=256):
    rng = np.random.default_rng(seed)
    resid, y = (rng.standard_normal((B, D)).astype(np.float32) for _ in range(2))
    lnw = (1 + 0.1 * rng.standard_normal(D)).astype(np.float32)
    ws = [(rng.standard_normal(s) * s[0] ** -0.5).astype(np.float32)
          for s in ((D, F), (D, F), (F, D))]
    jw = [jqm.quantize_weight(jnp.asarray(w), gs, bits=bits) for w in ws]
    tw = [tqm.quantize_weight(T(w), gs, bits=bits) for w in ws]
    return (resid, y, lnw), jw, tw


@pytest.mark.parametrize("gs", [32, 64])
@pytest.mark.parametrize("B", [1, 3, 8])
@pytest.mark.parametrize("bits", BITS, ids=BIT_IDS)
def test_fused_mlp_quant_plain_matches_pallas(bits, B, gs):
    (resid, y, lnw), (jg, ju, jd), (tg, tu, td) = _mlp_case(bits, gs, B, seed=B + gs)
    got = tfd.fused_mlp(T(resid), T(y), T(lnw), tu, td, tg, eps=1e-5).numpy()
    want = jfd.fused_mlp_quant_pallas(jnp.asarray(resid), jnp.asarray(y), jnp.asarray(lnw),
                                      None, ju, jd, jg, norm="rmsnorm", eps=1e-5,
                                      activation="swiglu", interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(got, tfd.fused_mlp_quant_reference(
        T(resid), T(y), T(lnw), tu, td, tg).numpy())


def test_mlp_weights_fusable_gives_the_jax_reasons():
    _, (jg, ju, jd), (tg, tu, td) = _mlp_case(8, 64, 1, seed=0)
    _, (jg4, _, _), (tg4, _, _) = _mlp_case(4, 64, 1, seed=0)
    _, (jg32, _, _), (tg32, _, _) = _mlp_case(8, 32, 1, seed=0)
    dense_j, dense_t = jnp.zeros((128, 256)), torch.zeros(128, 256)
    cases = [((ju, jd, jg), (tu, td, tg)), ((ju, jd, dense_j), (tu, td, dense_t)),
             ((ju, jd, jg4), (tu, td, tg4)), ((ju, jd, jg32), (tu, td, tg32)),
             ((dense_j, dense_j.T, dense_j), (dense_t, dense_t.T, dense_t))]
    reasons = [tfd.mlp_weights_fusable(*t) for _, t in cases]
    assert reasons == [jfd.mlp_weights_fusable(*j) for j, _ in cases]
    assert reasons[0] is None and reasons[4] is None
    assert "mixed dense/quantized" in reasons[1] and "mixed group_size/bits" in reasons[2]


@pytest.mark.parametrize("kw,err,match", [
    ({"b_up": torch.zeros(256), "b_down": torch.zeros(128)}, ValueError, "fc biases"),
    ({"gate": None, "activation": "gelu"}, ValueError, "not fusable"),
    ({"apply_norm": False}, None, None),
    ({"gate": "dense"}, ValueError, "mixed dense/quantized"),
    ({"up": "dense"}, ValueError, "mixed dense/quantized"),
], ids=["biases", "non-gated", "apply-norm", "dense-gate", "dense-up"])
def test_quantized_fused_mlp_refusals(kw, err, match):
    """Quantized weights with fc biases raise as JAX's ``fused_mlp`` does
    (the engines keep that MLP on the layer body); the plain MLP takes
    every fusable activation but not exact gelu; mixed dense and
    quantized weights raise with JAX's reason. ``apply_norm=False`` (GPT-J's
    shared layernorm) is refused no more since the parallel-block slice:
    both wrappers meet ``fused_mlp_quant_pallas(apply_norm=False)`` in
    interpret mode."""
    (resid, y, lnw), (jg, ju, jd), (tg, tu, td) = _mlp_case(8, 64, 2, seed=1)
    if err is None:
        want = np.asarray(jfd.fused_mlp_quant_pallas(
            jnp.asarray(resid), jnp.asarray(y), jnp.asarray(lnw), None, ju, jd, jg,
            norm="rmsnorm", eps=1e-5, activation="swiglu", interpret=True, **kw))
        for fn in (tfd.fused_mlp, tfd.fused_mlp_quant):
            got = fn(T(resid), T(y), T(lnw), tu, td, tg, **kw).numpy()
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
        return
    kw = dict(kw)
    gate, up = kw.pop("gate", tg), kw.pop("up", tu)
    gate = torch.zeros(128, 256) if gate == "dense" else gate
    up = torch.zeros(128, 256) if up == "dense" else up
    with pytest.raises(err, match=match):
        tfd.fused_mlp(T(resid), T(y), T(lnw), up, td, gate, **kw)
    if "b_up" in kw:   # JAX's wrapper refuses the same combination
        with pytest.raises(ValueError, match="fc biases"):
            jfd.fused_mlp(jnp.asarray(resid), jnp.asarray(y), jnp.asarray(lnw), None, ju, jd,
                          jg, b_up=jnp.zeros(256), b_down=jnp.zeros(128))
    else:   # fused_mlp_quant takes no biases
        with pytest.raises(err, match=match):
            tfd.fused_mlp_quant(T(resid), T(y), T(lnw), up, td, gate, **kw)


def test_fused_qkv_refuses_quantized_weights():
    _, tw = _pair(8, 64, 64, 32, seed=0)
    with pytest.raises(ValueError, match="quant_matmul"):
        tfd.fused_qkv_rope(torch.zeros(1, 64), tw, tw, tw, torch.zeros(1, 8), torch.zeros(1, 8),
                           n_heads=4, kv_heads=4)


# ---------------------------------------------------------------------------
# Engines against the JAX engines
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


def _cfg(cls, bits, decode_kernel="pallas", num_kv_blocks=40, **kw):
    return cls(dtype="float32", max_seq_len=64, kv_block_size=8, num_kv_blocks=num_kv_blocks,
               decode_kernel=decode_kernel, quantize_weights=True, quant_bits=bits,
               quant_group_size=64, serving={"token_budget": 16, "max_running": 4,
                                             "chunk_min": 4}, **kw)


@pytest.fixture
def jax_fused(monkeypatch):
    """JAX's fused kernels through the Pallas interpreter, each wrapped to
    count its traces (the JAX engine drops to its XLA body when one
    fails)."""
    monkeypatch.setenv("SXT_FUSED_INTERPRET", "1")
    traces = dict.fromkeys(("fused_qkv_rope_pallas", "fused_paged_decode_attention_pallas",
                            "fused_mlp_pallas", "fused_mlp_quant_pallas"), 0)
    for name in traces:
        fn = getattr(jfd, name)

        def counted(*a, _fn=fn, _name=name, **kw):
            traces[_name] += 1
            return _fn(*a, **kw)

        monkeypatch.setattr(jfd, name, counted)
    return traces


def _fused_traces_ok(traces):
    """The JAX engine ran the attention-only fusion and the quantized MLP
    kernel, and neither of the dense kernels."""
    assert traces["fused_paged_decode_attention_pallas"] > 0, traces
    assert traces["fused_mlp_quant_pallas"] > 0, traces
    assert traces["fused_qkv_rope_pallas"] == traces["fused_mlp_pallas"] == 0, traces


def _engines(models, bits, decode_kernel="pallas", num_kv_blocks=40):
    jm, jp, tm, state = models
    return (JEngine(jm, jp, _cfg(JConfig, bits, decode_kernel, num_kv_blocks)),
            InferenceEngineV2(tm, state, _cfg(InferenceConfig, bits, decode_kernel,
                                              num_kv_blocks), device="cpu"))


def _prompts(seed, lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 90, size=int(n)).tolist() for n in lengths]


STEP_SCHEDULE_PROMPTS = (12, 5, 22)


def _step_schedule():
    p = _prompts(0, STEP_SCHEDULE_PROMPTS)
    toks = np.random.default_rng(9).integers(1, 90, size=16).tolist()
    return [
        ([], [], [(0, p[0][:10]), (1, p[1])]),                      # extend only
        ([1], toks[:1], [(0, p[0][10:]), (2, p[2][:8])]),           # mixed
        ([0, 1], toks[1:3], [(2, p[2][8:])]),                       # mixed
        ([0, 1, 2], toks[3:6], []),                                 # decode only
        ([0, 2], toks[6:8], []),
        ([2], toks[8:9], [(3, p[1][:3])]),                          # a new uid mid-decode
    ]


@pytest.mark.parametrize("decode_kernel", ["pallas", "xla"])
@pytest.mark.parametrize("bits", BITS, ids=BIT_IDS)
def test_step_logits_match_jax(models, bits, decode_kernel, request):
    traces = request.getfixturevalue("jax_fused") if decode_kernel == "pallas" else None
    je, te = _engines(models, bits, decode_kernel)
    assert je._decode_kernel == te._decode_kernel == decode_kernel
    assert isinstance(te.params["layers.wq"], tqm.QuantizedMatrix)
    assert te.params["layers.wq"].group_size == 64 and te.params["layers.wq"].bits == bits
    for tick in _step_schedule():
        jd, jpl = je.step(*tick)
        td, tpl = te.step(*tick)
        np.testing.assert_allclose(td, jd, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(tpl, jpl, rtol=1e-4, atol=1e-4)
    assert te.dispatches_by_program.keys() == {"extend", "mixed", "decode"}
    if traces is not None:
        _fused_traces_ok(traces)


@pytest.mark.parametrize("bits", BITS, ids=BIT_IDS)
def test_put_and_decode_loop_match_jax(models, bits, jax_fused):
    je, te = _engines(models, bits)
    prompts = _prompts(5, (14, 6, 19))
    lt, lj = te.put([0, 1, 2], prompts), je.put([0, 1, 2], prompts)
    np.testing.assert_allclose(lt, lj, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(te.put([1], [[7, 8, 9, 10, 11, 12, 13, 14, 15, 16]]),
                               je.put([1], [[7, 8, 9, 10, 11, 12, 13, 14, 15, 16]]),
                               rtol=1e-4, atol=1e-4)
    first = [int(np.argmax(r)) for r in lt]
    np.testing.assert_array_equal(te.decode_loop([0, 1, 2], first, 6),
                                  je.decode_loop([0, 1, 2], first, 6))
    assert te.program_shapes == je.program_shapes
    _fused_traces_ok(jax_fused)


@pytest.mark.parametrize("case", ["concurrent", "preemption"])
@pytest.mark.parametrize("bits", BITS, ids=BIT_IDS)
def test_serve_tokens_equal_the_jax_scheduler(models, bits, case, jax_fused):
    if case == "concurrent":
        prompts, max_new, blocks = _prompts(0, (12, 5, 22, 9)), 8, 40
    else:   # 6 usable blocks of 8 slots cannot hold both requests' KV
        prompts, max_new, blocks = _prompts(1, (20, 18)), 12, 7
    je, te = _engines(models, bits, num_kv_blocks=blocks)
    js, ts = JScheduler(je), ContinuousBatchingScheduler(te)
    want = js.serve(prompts, max_new_tokens=max_new)
    got = ts.serve(prompts, max_new_tokens=max_new)
    assert got == want
    assert ts.ticks == js.ticks and ts.preemptions == js.preemptions
    if case == "preemption":
        assert ts.preemptions > 0, "the pool was sized to force preemption"
    _fused_traces_ok(jax_fused)


def _v1(models, bits, decode_kernel="pallas"):
    jm, jp, tm, state = models
    cfg = dict(dtype="float32", max_seq_len=64, decode_kernel=decode_kernel,
               quantize_weights=True, quant_bits=bits, quant_group_size=64)
    return JEngineV1(jm, jp, JConfig(**cfg)), init_inference(tm, state, cfg, device="cpu")


@pytest.mark.parametrize("bits", BITS, ids=BIT_IDS)
def test_v1_generate_matches_jax_and_the_dequantized_dense_engine(models, bits, jax_fused):
    je, te = _v1(models, bits)
    rng = np.random.default_rng(11)
    ids = rng.integers(1, 90, size=(3, 13)).astype(np.int32)
    lens = np.asarray([13, 6, 9], np.int32)
    want = je.generate(ids, prompt_lengths=lens, max_new_tokens=10)
    got = te.generate(ids, prompt_lengths=lens, max_new_tokens=10)
    np.testing.assert_array_equal(got, want)
    assert jax_fused["fused_mlp_quant_pallas"] > 0, jax_fused
    # the same engine fed the weights it serves, dequantized and dense
    _, _, tm, _ = models
    dense = {k: (v.dequantize() if isinstance(v, tqm.QuantizedMatrix) else v)
             for k, v in te.params.items()}
    ref = init_inference(tm, dense, dict(dtype="float32", max_seq_len=64,
                                         decode_kernel="pallas"), device="cpu")
    np.testing.assert_array_equal(ref.generate(ids, prompt_lengths=lens, max_new_tokens=10), got)


@pytest.mark.parametrize("bits", BITS, ids=BIT_IDS)
def test_a_jax_quantized_tree_crosses_bit_for_bit(models, bits):
    """params_from_numpy of a JAX-quantized tree gives the port's own
    quantization, and params_to_numpy gives JAX's children back."""
    jm, jp, tm, state = models
    je = JEngine(jm, jp, _cfg(JConfig, bits, "xla"))
    jtree = jax.tree.map(np.asarray, je.params)
    fed = params_from_numpy(jtree)
    own = InferenceEngineV2(tm, state, _cfg(InferenceConfig, bits, "xla"), device="cpu").params
    assert set(fed) == set(own)
    for k, v in own.items():
        if isinstance(v, tqm.QuantizedMatrix):
            f = fed[k]
            assert (f.bits, f.group_size, f.shape, f.dtype) == (v.bits, v.group_size, v.shape,
                                                                  v.dtype)
            np.testing.assert_array_equal(_bytes(f.q), _bytes(v.q))
            np.testing.assert_array_equal(f.scales.numpy(), v.scales.numpy())
        else:
            np.testing.assert_array_equal(fed[k].numpy(), v.numpy())
    back = params_to_numpy(own)["layers"]["w_up"]
    assert isinstance(back, QuantizedArrays) and back.bits == bits and back.dtype == "float32"
    jw = jtree["layers"]["w_up"]
    np.testing.assert_array_equal(back.q, _jax_q_bytes(jw))
    np.testing.assert_array_equal(back.scales, np.asarray(jw.scales))
    # a port engine fed the quantized tree serves what the self-quantizing one does
    a = InferenceEngineV2(tm, fed, InferenceConfig(dtype="float32", max_seq_len=64,
                                                   kv_block_size=8, num_kv_blocks=40,
                                                   decode_kernel="xla"), device="cpu")
    b = InferenceEngineV2(tm, state, _cfg(InferenceConfig, bits, "xla"), device="cpu")
    p = _prompts(2, (11, 4))
    np.testing.assert_array_equal(a.put([0, 1], p), b.put([0, 1], p))


# ---------------------------------------------------------------------------
# Launch accounting, with the kernel gate opened onto the plain versions
# ---------------------------------------------------------------------------


@pytest.fixture
def counted_port(monkeypatch):
    """Every port wrapper takes its "kernel" branch with the plain version
    standing in for the launch, so the launch counters move as on the card."""
    from shuffle_exchange_tpu_torch import ops

    pa = importlib.import_module("shuffle_exchange_tpu_torch.ops.paged_attention")
    rn = importlib.import_module("shuffle_exchange_tpu_torch.ops.rmsnorm")
    fa = importlib.import_module("shuffle_exchange_tpu_torch.ops.flash_attention")
    for m in (tfd, tqm, pa, rn, fa):
        monkeypatch.setattr(m, "use_kernel", lambda t: True)
    monkeypatch.setattr(tqm, "_launch", tqm.quant_matmul_reference)
    monkeypatch.setattr(tfd, "_launch_mlp_quant",
                        lambda *a, **k: tfd.fused_mlp_quant_reference(*a, **k))
    monkeypatch.setattr(tfd, "_launch_attention", lambda q, ck, cv, bt, kl, n, sl=None:
                        tfd.fused_paged_decode_reference(q, ck, cv, bt, kl, 2 if n is None else n,
                                                         sl))
    monkeypatch.setattr(pa, "_launch", lambda kind, q, ck, cv, bt, lens, sl=None: (
        pa.paged_decode_reference(q, ck, cv, bt, lens, alibi_slopes=sl) if kind == "decode" else
        pa.paged_extend_reference(q, ck, cv, bt, lens, torch.full_like(lens, q.shape[1]),
                                  alibi_slopes=sl)))

    def norm(x, w, eps, residual):
        rn.rmsnorm.launches += 1
        return rn.rmsnorm_reference(x, w, eps)

    monkeypatch.setattr(rn, "_launch", norm)
    monkeypatch.setattr(fa, "_launch", lambda q, k, v, causal, seg, want_lse:
                        fa.reference_attention_lse(q, k, v, causal, seg))
    monkeypatch.setattr(fa, "check_operands", lambda *a, **k: None)
    for fn in ops.KERNEL_WRAPPERS.values():
        monkeypatch.setattr(fn, "launches", 0)
    return ops


@pytest.mark.parametrize("decode_kernel", ["pallas", "xla"])
def test_launch_counters_follow_the_programs(models, counted_port, decode_kernel):
    """Per layer: a fused decode row runs 4 quantized matmuls (q, k, v,
    wo), the split-K attention, the quantized fused MLP and one RMSNorm;
    an unfused one 7 quantized matmuls, the paged decode kernel and two
    RMSNorms; chunk rows 7 quantized matmuls, the extend kernel and two
    RMSNorms; each program one more RMSNorm for the head."""
    _, te = _engines(models, 8, decode_kernel)
    for tick in _step_schedule():
        te.step(*tick)
    by = te.dispatches_by_program
    L = 2
    dec, ext = by["decode"] + by["mixed"], by["extend"] + by["mixed"]
    fused = decode_kernel == "pallas"
    want = {k: 0 for k in counted_port.KERNEL_WRAPPERS}
    want.update(rmsnorm=(2 * L + 1) * ext + ((L + 1) if fused else (2 * L + 1)) * dec,
                paged_extend_attention=L * ext,
                quant_matmul=7 * L * ext + (4 if fused else 7) * L * dec)
    if fused:
        want.update(fused_paged_decode_attention=L * dec, fused_mlp_quant=L * dec)
    else:
        want.update(paged_decode_attention=L * dec)
    assert counted_port.launch_counts() == want


def test_v1_launch_counters_follow_the_programs(models, counted_port):
    _, te = _v1(models, "fp8")
    te.generate(np.ones((2, 5), np.int32), max_new_tokens=4)
    L, steps = 2, 3
    want = {k: 0 for k in counted_port.KERNEL_WRAPPERS}
    want.update(flash_attention=L, rmsnorm=(2 * L + 1) + (L + 1) * steps,
                quant_matmul=7 * L + 4 * L * steps, fused_mlp_quant=L * steps)
    assert counted_port.launch_counts() == want


# ---------------------------------------------------------------------------
# Config
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d,want", [
    ({"quant": {"enabled": True, "bits": "FP8 "}}, (True, "fp8")),
    ({"quant": {"enabled": True, "bits": "4"}}, (True, 4)),
    ({"quant": {"enabled": False}}, (False, 8)),
    ({"quant_bits": 4.0, "quantize_weights": True}, (True, 4)),
    ({"dtype": "int8"}, (True, 8)),
    ({"dtype": "torch.int8", "quant_bits": "fp8"}, (True, "fp8")),
], ids=["quant-fp8", "quant-4", "quant-off", "bits-float", "dtype-int8", "torch-int8"])
def test_quant_config_reads_as_jax(d, want):
    port, ref = InferenceConfig.from_dict(d), JConfig.from_dict(d)
    assert (port.quantize_weights, port.quant_bits) == want
    assert (ref.quantize_weights, ref.quant_bits) == want
    assert port.dtype == ref.dtype
    assert port.quant_group_size == ref.quant_group_size == 2048


@pytest.mark.parametrize("bad", [3, "int8", 16, None, "fp16"])
def test_bad_quant_bits_raise_naming_the_field(bad):
    with pytest.raises(ConfigError, match="quant_bits"):
        InferenceConfig.from_dict({"quant_bits": bad})
    with pytest.raises(ConfigError, match="quant_bits"):
        InferenceConfig(quant_bits=bad)
