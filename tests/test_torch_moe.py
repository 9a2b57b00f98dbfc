"""The PyTorch port's MoE layer and its grouped GEMM against the JAX package.

On inputs made with numpy from a seed, in f32 on the CPU (where the
grouped-GEMM wrapper takes its plain version):

- Gating: ``topk_select``, ``topk_gating_compact`` and ``topk_gating`` give
  JAX's expert ids, buffer slots, kept masks and drop fraction exactly and
  its weights and aux loss within 1e-6, with exact logit ties (the lower
  expert id wins, as ``jnp.argmax`` breaks them).
- The plain grouped GEMM meets ``jax.lax.ragged_dot`` and JAX
  ``grouped_matmul`` over int8 / fp8 ``QuantizedMatrix`` stacks (which it
  dequantizes first) in f32 within 1e-5, with empty groups, one row and a
  single full group, and bf16 within one bf16 step.
- ``moe_layer`` for all four impls (dense, int8 and fp8 experts, with and
  without expert biases): output within 1e-5, expert counts and the drop
  fraction exact.
- The kernel gate: a CPU tensor takes the plain version and counts no
  launch; the route refuses what the kernel does not take on a CUDA
  tensor. The model presets, the MoE parameter layout, the conversion of
  JAX trees with ``[L, E]`` quantized stacks, and the serving config
  against JAX's.

The CUDA kernel runs only on the card, where ``chip_smoke.py`` phase 2f
holds it against its plain version.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shuffle_exchange_tpu.inference import InferenceConfig as JConfig
from shuffle_exchange_tpu.inference import InferenceEngineV2 as JEngine
from shuffle_exchange_tpu.models import Transformer as JTransformer
from shuffle_exchange_tpu_torch.config import ConfigError
from shuffle_exchange_tpu_torch.inference import InferenceConfig, InferenceEngineV2
from shuffle_exchange_tpu_torch.models import (QuantizedArrays, Transformer, params_from_numpy,
                                               params_to_numpy)

jg = importlib.import_module("shuffle_exchange_tpu.moe.gating")
jl = importlib.import_module("shuffle_exchange_tpu.moe.layer")
jgg = importlib.import_module("shuffle_exchange_tpu.ops.grouped_gemm")
jqm = importlib.import_module("shuffle_exchange_tpu.ops.quant_matmul")
jtf = importlib.import_module("shuffle_exchange_tpu.models.transformer")
jic = importlib.import_module("shuffle_exchange_tpu.inference.config")
tg = importlib.import_module("shuffle_exchange_tpu_torch.moe.gating")
tl = importlib.import_module("shuffle_exchange_tpu_torch.moe.layer")
tgg = importlib.import_module("shuffle_exchange_tpu_torch.ops.grouped_gemm")
tqm = importlib.import_module("shuffle_exchange_tpu_torch.ops.quant_matmul")
ttf = importlib.import_module("shuffle_exchange_tpu_torch.models.transformer")
tic = importlib.import_module("shuffle_exchange_tpu_torch.inference.config")

T = torch.from_numpy
MOE = dict(vocab=97, d=32, layers=2, heads=4, seq=128, experts=4, n_kv_heads=2,
           tie_embeddings=False)


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _tied_logits(seed, S=24, E=6):
    """Router logits on a coarse grid, so many rows hold exact ties."""
    rng = np.random.default_rng(seed)
    lg = (np.round(rng.standard_normal((S, E)) * 2) / 2).astype(np.float32)
    lg[0] = 0.5                         # a row tied across every expert
    lg[1, :3] = lg[1].max() + 1         # a three-way tie at the top
    return lg


# ---------------------------------------------------------------------------
# Gating
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("norm", [True, False], ids=["renorm", "raw"])
def test_topk_select_equals_jax_with_ties(k, norm):
    lg = _tied_logits(k)
    ji, jw, jaux, jm = jg.topk_select(jnp.asarray(lg), k, normalize_weights=norm)
    ti, tw, taux, tm = tg.topk_select(T(lg), k, normalize_weights=norm)
    assert ti.dtype == torch.int32
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=0, atol=1e-6)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=0, atol=1e-6)
    for a, b in zip(tm, jm):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(ti[1].numpy(), np.arange(k))   # ties: lower id first


@pytest.mark.parametrize("cf,drop", [(0.5, True), (1.25, True), (1.0, False)],
                         ids=["cf0.5", "cf1.25", "no-drop"])
@pytest.mark.parametrize("k", [1, 2])
def test_capacity_gating_equals_jax(k, cf, drop):
    lg = _tied_logits(10 + k)
    kw = dict(k=k, capacity_factor=cf, train=False, drop_tokens=drop)
    ja, ta = jg.topk_gating_compact(jnp.asarray(lg), **kw), tg.topk_gating_compact(T(lg), **kw)
    assert ta.capacity == ja.capacity
    for name in ("eidx", "loc", "kept"):
        np.testing.assert_array_equal(_np(getattr(ta, name)), np.asarray(getattr(ja, name)))
    np.testing.assert_allclose(ta.weights.numpy(), np.asarray(ja.weights), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(ta.metadata["expert_counts"].numpy(),
                                  np.asarray(ja.metadata["expert_counts"]))
    assert float(ta.metadata["drop_fraction"]) == float(ja.metadata["drop_fraction"])
    jd, td = jg.topk_gating(jnp.asarray(lg), **kw), tg.topk_gating(T(lg), **kw)
    np.testing.assert_allclose(td.combine_weights.numpy(), np.asarray(jd.combine_weights),
                               rtol=0, atol=1e-6)
    np.testing.assert_array_equal(td.dispatch_mask.numpy(), np.asarray(jd.dispatch_mask))
    assert tg.compute_capacity(37, 8, 2, 1.25) == jg.compute_capacity(37, 8, 2, 1.25)


def test_gate_noise_raises_naming_moe_training():
    with pytest.raises(NotImplementedError, match="item 9"):
        tg.topk_select(torch.zeros(2, 4), 2, train=True, rng=torch.Generator(),
                       noise_std=1.0)


# ---------------------------------------------------------------------------
# The plain grouped GEMM
# ---------------------------------------------------------------------------

GROUPS = {"ragged": [3, 1, 4, 2], "empty-ends": [0, 5, 7, 0], "one-row": [0, 1, 0, 0],
          "one-group": [0, 0, 9, 0]}


def _stack(kind, rng, E=4, K=64, F=96):
    w = (rng.standard_normal((E, K, F)) * 0.1).astype(np.float32)
    if kind == "f32":
        return jnp.asarray(w), T(w)
    bits = 8 if kind == "int8" else "fp8"
    return (jqm.quantize_weight(jnp.asarray(w), 32, bits=bits),
            tqm.quantize_weight(T(w), 32, bits=bits))


@pytest.mark.parametrize("kind", ["f32", "int8", "fp8"])
@pytest.mark.parametrize("groups", list(GROUPS.values()), ids=list(GROUPS))
def test_grouped_matmul_plain_matches_jax(kind, groups):
    rng = np.random.default_rng(len(groups) + sum(groups))
    jw, tw = _stack(kind, rng)
    sizes = np.asarray(groups, np.int32)
    x = rng.standard_normal((int(sizes.sum()), 64)).astype(np.float32)
    want = jgg.grouped_matmul(jnp.asarray(x), jw, jnp.asarray(sizes))
    got = tgg.grouped_matmul(T(x), tw, T(sizes))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    if kind == "f32":
        oracle = jax.lax.ragged_dot(jnp.asarray(x), jw, jnp.asarray(sizes))
        np.testing.assert_allclose(got.numpy(), np.asarray(oracle), rtol=1e-5, atol=1e-5)


def test_grouped_matmul_bf16_within_one_step():
    rng = np.random.default_rng(7)
    sizes = np.asarray([5, 0, 11, 3], np.int32)
    x = rng.standard_normal((19, 64)).astype(np.float32)
    w = (rng.standard_normal((4, 64, 48)) * 0.1).astype(np.float32)
    want = np.asarray(jax.lax.ragged_dot(jnp.asarray(x, jnp.bfloat16),
                                         jnp.asarray(w, jnp.bfloat16),
                                         jnp.asarray(sizes)).astype(jnp.float32))
    got = tgg.grouped_matmul(T(x).bfloat16(), T(w).bfloat16(), T(sizes))
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - want)
    assert (err <= 2 ** -7 * np.abs(want) + 1e-5).all(), err.max()


def test_grouped_matmul_rows_past_the_groups_are_zero_and_shapes_are_checked():
    x, w = torch.randn(6, 8), torch.randn(2, 8, 4)
    out = tgg.grouped_matmul(x, w, torch.tensor([2, 1], dtype=torch.int32))
    assert out[3:].abs().max() == 0 and out[:3].abs().max() > 0
    for bad in ((x, w, torch.tensor([6], dtype=torch.int32)),
                (x[:, :4], w, torch.tensor([3, 3], dtype=torch.int32)),
                (x, w[0], torch.tensor([3, 3], dtype=torch.int32))):
        with pytest.raises(ValueError):
            tgg.grouped_matmul(*bad)


def test_grouped_matmul_on_cpu_counts_no_launch(monkeypatch):
    monkeypatch.setattr(tgg.grouped_matmul, "launches", 0)
    tgg.grouped_matmul(torch.randn(3, 8), torch.randn(2, 8, 4),
                       torch.tensor([1, 2], dtype=torch.int32))
    assert tgg.grouped_matmul.launches == 0


def test_the_route_is_the_tensors_device():
    dispatch = importlib.import_module("shuffle_exchange_tpu_torch.ops.dispatch")
    assert dispatch.resolve_grouped_gemm("moe", torch.zeros(1)) == "plain"
    with pytest.raises(ValueError, match="no kernel"):
        dispatch.resolve_grouped_gemm("moe", torch.zeros(1, device="meta"))
    with pytest.raises(ValueError, match="kind"):
        dispatch.resolve_grouped_gemm("dense", torch.zeros(1))
    assert dispatch.resolve_grouped_gemm("lora", torch.zeros(1)) == "plain"
    with pytest.raises(ValueError, match="no kernel"):
        dispatch.resolve_grouped_gemm("lora", torch.zeros(1, device="meta"))


@pytest.mark.parametrize("w,err,match", [
    (lambda: torch.zeros(2, 64, 32, dtype=torch.float32), TypeError, "bf16"),
    (lambda: tqm.quantize_weight(torch.randn(2, 64, 32), 32, bits=4).to(None, torch.bfloat16),
     TypeError, "int4"),
    (lambda: tqm.quantize_weight(torch.randn(2, 64, 40), 32, bits=8).to(None, torch.bfloat16),
     ValueError, "multiple of 16"),
    (lambda: tqm.quantize_weight(torch.randn(2, 64, 32), 32, bits=8), TypeError, "bf16"),
], ids=["f32-weights", "int4", "ragged-F", "f32-compute"])
def test_kernel_operands_refuse_what_the_kernel_does_not_take(w, err, match):
    """On a CUDA tensor the wrapper checks the operands before the launch;
    what the kernel does not take raises and never reaches the plain
    version."""
    with pytest.raises(err, match=match):
        tgg._weight_operands(w(), torch.device("cpu"), 64, w().shape[-1])


def test_gemv_split_covers_k_in_whole_groups():
    """The decode-row GEMV's plan (``gemv_split``: splits, chunk) cuts K
    into whole scale groups (bf16 weights: gs 8, whole 32-row stages) and
    covers it once."""
    for K, gs, elt in ((4096, 256, 1), (14336, 256, 1), (64, 32, 1), (72, 8, 2)):
        for F, E, N in ((14336, 8, 16), (4096, 8, 2), (64, 4, 3)):
            splits, chunk = tgg.gemv_split(K, gs, F, E, N, elt, 132)
            assert chunk % (gs if elt == 1 else 32) == 0
            assert splits * chunk >= K > (splits - 1) * chunk


# ---------------------------------------------------------------------------
# The MoE layer
# ---------------------------------------------------------------------------


def _experts(rng, kind, bias, E=4, D=32, Fd=64):
    dense = {"w_gate": (E, D, Fd), "w_up": (E, D, Fd), "w_down": (E, Fd, D)}
    arrays = {k: (rng.standard_normal(s) * 0.1).astype(np.float32) for k, s in dense.items()}
    if bias:
        arrays.update(b_gate=(rng.standard_normal((E, Fd)) * 0.1).astype(np.float32),
                      b_up=(rng.standard_normal((E, Fd)) * 0.1).astype(np.float32),
                      b_down=(rng.standard_normal((E, D)) * 0.1).astype(np.float32))
    jp, tp = {}, {}
    for k, v in arrays.items():
        if kind != "f32" and k.startswith("w_"):
            bits = 8 if kind == "int8" else "fp8"
            jp[k], tp[k] = (jqm.quantize_weight(jnp.asarray(v), 256, bits=bits),
                            tqm.quantize_weight(T(v), 256, bits=bits))
        else:
            jp[k], tp[k] = jnp.asarray(v), T(v)
    return jp, tp


@pytest.mark.parametrize("kind,bias", [("f32", False), ("f32", True), ("int8", False),
                                       ("fp8", True)],
                         ids=["f32", "f32-bias", "int8", "fp8-bias"])
@pytest.mark.parametrize("impl", ["ragged", "capacity", "capacity_einsum", "auto"])
def test_moe_layer_equals_jax(impl, kind, bias):
    rng = np.random.default_rng(3)
    jp, tp = _experts(rng, kind, bias)
    gate = (rng.standard_normal((32, 4)) * 0.5).astype(np.float32)
    x = rng.standard_normal((2, 7, 32)).astype(np.float32)
    kw = dict(k=2, impl=impl, train=False, capacity_factor=0.75, scanned=True)
    want = jl.moe_layer(jnp.asarray(gate), jp, jnp.asarray(x), **kw)
    got = tl.moe_layer(T(gate), tp, T(x), **kw)
    assert got.output.shape == x.shape
    np.testing.assert_allclose(got.output.numpy(), np.asarray(want.output), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(got.metadata["expert_counts"].numpy(),
                                  np.asarray(want.metadata["expert_counts"]))
    assert float(got.metadata["drop_fraction"]) == float(want.metadata["drop_fraction"])
    np.testing.assert_allclose(float(got.aux_loss), float(want.aux_loss), rtol=0, atol=1e-6)
    if impl in ("capacity", "auto"):
        assert float(got.metadata["drop_fraction"]) > 0, "capacity 0.75 was to force drops"


def test_resolve_moe_impl_and_refusals():
    for args in (("auto", 1, True), ("auto", 1, False), ("auto", 2, False), ("ragged", 4, True)):
        assert tl.resolve_moe_impl(*args) == jl.resolve_moe_impl(*args)
    x, gate = torch.randn(3, 8), torch.randn(8, 2)
    experts = {k: torch.randn(2, 8, 8) for k in ("w_gate", "w_up", "w_down")}
    with pytest.raises(ValueError, match="moe impl"):
        tl.moe_layer(gate, experts, x, impl="einsum")

    class Mesh:
        shape = {"expert": 2, "data": 4}

    with pytest.raises(NotImplementedError, match="item 12"):
        tl.moe_layer(gate, experts, x, mesh=Mesh())
    with pytest.raises(NotImplementedError, match="item 4"):
        tl.moe_layer(gate, experts, x, activation="gelu", impl="ragged")


def test_init_expert_mlp_has_jax_leaves_and_scales():
    jp = jl.init_expert_mlp(jax.random.PRNGKey(0), 8, 64, 256, bias=True)
    tp = tl.init_expert_mlp(torch.Generator().manual_seed(0), 8, 64, 256, bias=True)
    assert {k: tuple(v.shape) for k, v in tp.items()} == {k: v.shape for k, v in jp.items()}
    for k in ("w_gate", "w_up", "w_down"):
        assert abs(float(tp[k].std()) / float(jnp.std(jp[k])) - 1) < 0.05, k


# ---------------------------------------------------------------------------
# Model, conversion and config
# ---------------------------------------------------------------------------

FIELDS = ("vocab_size", "d_model", "n_layers", "n_heads", "n_kv_heads", "d_ff", "max_seq_len",
          "activation", "norm", "position", "rope_theta", "tie_embeddings", "n_experts",
          "moe_top_k", "capacity_factor", "moe_impl", "moe_shared_expert_ff", "moe_norm_topk",
          "moe_layer_pattern", "aux_loss_coef")


@pytest.mark.parametrize("preset", [lambda m: m.mixtral_8x7b(), lambda m: m.tiny_moe(**MOE),
                                    lambda m: m.tiny_moe(**MOE, moe_shared_expert_ff=48)],
                         ids=["mixtral-8x7b", "tiny-moe", "tiny-moe-shared"])
def test_presets_and_parameter_layout_equal_jax(preset):
    jc, tc = preset(jtf), preset(ttf)
    for f in FIELDS:
        assert getattr(tc, f) == getattr(jc, f), f
    if tc.n_layers > 2:       # Mixtral: 46.70 B parameters, only counted
        assert round(ttf.param_count(tc) / 1e9, 2) == 46.70
        return
    jtree = JTransformer(jc).init(jax.random.PRNGKey(0))
    jshapes = {f"layers.{k}" if k in jtree["layers"] else k: v.shape
               for k, v in list(jtree["layers"].items()) + list(jtree.items()) if k != "layers"}
    assert Transformer(tc, device="cpu").param_shapes() == jshapes
    state = params_from_numpy(jax.tree.map(np.asarray, jtree))
    model = Transformer(tc, device="cpu")
    model.load_params(state)
    drawn = Transformer(tc, device="cpu").init(torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in drawn.items()} == jshapes
    j_std = float(jnp.std(jtree["layers"]["moe_w_down"]))
    assert abs(float(drawn["layers.moe_w_down"].std()) / j_std - 1) < 0.1


def test_moe_training_raises_naming_item_9_and_serving_does_not():
    """MoE training is ported: ``initialize()`` trains one step and the
    training forward runs; interleaved dense and MoE layers still raise
    naming item 9. Serving is unaffected."""
    import shuffle_exchange_tpu_torch as sxt

    model = Transformer(ttf.tiny_moe(**MOE), device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    batch = {"input_ids": np.ones((2, 5), np.int32)}
    assert np.isfinite(float(model.loss(params, batch)))
    assert model.apply(params, [[1, 2]]).shape == (1, 2, 97)
    eng, *_ = sxt.initialize(model=model, device="cpu",
                             config={"train_batch_size": 2,
                                     "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}}})
    assert np.isfinite(float(eng.train_batch(batch))) and eng.state.step == 1
    with pytest.raises(NotImplementedError, match="moe_layer_pattern; ROADMAP queue A, item 9"):
        Transformer(ttf.tiny_moe(**MOE, moe_layer_pattern=(True, False)), device="cpu")
    eng = InferenceEngineV2(model, params, InferenceConfig(max_seq_len=64, kv_block_size=8,
                                                           num_kv_blocks=16), device="cpu")
    dl, pl = eng.step([], [], [(0, [1, 2, 3])])
    assert pl.shape == (1, 97) and np.isfinite(pl).all()


def test_optional_expert_biases_load_and_unknown_leaves_raise():
    model = Transformer(ttf.tiny_moe(**MOE), device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    extra = {k: torch.zeros(s) for k, s in model.optional_shapes().items()}
    model.load_params({**params, **extra})
    assert set(model.params()) == set(params) | set(extra)
    with pytest.raises(ValueError, match="unexpected"):
        model.load_params({**params, "layers.moe_b_bogus": torch.zeros(1)})
    with pytest.raises(ValueError, match="shape"):
        model.load_params({**params, "layers.moe_b_up": torch.zeros(3)})


@pytest.mark.parametrize("bits", [8, "fp8"], ids=["int8", "fp8"])
def test_a_jax_quantized_moe_tree_crosses_both_ways(bits):
    """The JAX engine's [L, E, K, N] expert storage becomes the port's
    QuantizedMatrix bit for bit, equal to what the port's own engine makes;
    ``params_to_numpy`` gives JAX's children back."""
    jm = JTransformer(jtf.tiny_moe(**MOE))
    jp = jm.init(jax.random.PRNGKey(0))
    cfg = dict(dtype="float32", max_seq_len=64, kv_block_size=8, num_kv_blocks=16,
               quantize_weights=True, quant_bits=bits)
    jtree = jax.tree.map(np.asarray, JEngine(jm, jp, JConfig(**cfg)).params)
    fed = params_from_numpy(jtree)
    tm = Transformer(ttf.tiny_moe(**MOE), device="cpu")
    own = InferenceEngineV2(tm, params_from_numpy(jax.tree.map(np.asarray, jp)),
                            InferenceConfig(**cfg), device="cpu").params
    assert set(fed) == set(own)
    for name in ("layers.moe_w_gate", "layers.moe_w_up", "layers.moe_w_down"):
        f, o = fed[name], own[name]
        assert isinstance(f, tqm.QuantizedMatrix) and f.shape[:2] == (2, 4)
        assert (f.bits, f.group_size, f.shape) == (o.bits, o.group_size, o.shape)
        np.testing.assert_array_equal(f.q.view(torch.uint8).numpy(),
                                      o.q.view(torch.uint8).numpy())
        np.testing.assert_array_equal(f.scales.numpy(), o.scales.numpy())
        assert isinstance(o[1], tqm.QuantizedMatrix) and o[1].shape == o.shape[1:]
    back = params_to_numpy(own)["layers"]["moe_w_up"]
    assert isinstance(back, QuantizedArrays) and back.bits == bits
    jw = jtree["layers"]["moe_w_up"]
    q = np.asarray(jw.q)
    np.testing.assert_array_equal(back.q, q.view(np.uint8) if bits == "fp8" else q)
    np.testing.assert_array_equal(back.scales, np.asarray(jw.scales))


def test_moe_serving_config_reads_as_jax():
    port, ref = tic.MoEServingConfig(), jic.MoEServingConfig()
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    d = {"serving": {"moe": {"moe_impl": "ragged", "capacity_factor": "2",
                             "overload_policy": "drop", "overload_threshold": 1.5}}}
    got = InferenceConfig.from_dict(d).serving.moe
    assert dataclasses.asdict(got) == dataclasses.asdict(JConfig.from_dict(d).serving.moe)
    assert InferenceConfig.from_dict({"serving": {"moe": None}}).serving.moe == port


@pytest.mark.parametrize("moe", [{"moe_impl": "einsum"}, {"capacity_factor": 0},
                                 {"overload_policy": "queue"}, {"overload_threshold": -1},
                                 {"bogus": 1}])
def test_bad_moe_serving_config_raises_as_in_jax(moe):
    with pytest.raises(Exception):
        JConfig.from_dict({"serving": {"moe": moe}})
    with pytest.raises(ConfigError, match="serving.moe"):
        InferenceConfig.from_dict({"serving": {"moe": moe}})
