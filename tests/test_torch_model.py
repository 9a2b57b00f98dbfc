"""The PyTorch port's Llama model pieces against the JAX package.

Weights move between the packages as numpy arrays under the flattened
JAX names (``models/convert.py``); the round trip must be bit-equal. The
model's forward pieces (RMSNorm ``_norm``, the rope table, rotate-half
RoPE, the f32 head) are held against the JAX functions in f32 on the
same inputs, to 1e-6 (the same arithmetic in another summation order).
"""

import math

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from shuffle_exchange_tpu.models import Transformer as JTransformer
from shuffle_exchange_tpu.models import tiny as jtiny
from shuffle_exchange_tpu.models import transformer as jtf
from shuffle_exchange_tpu_torch.config import ConfigError
from shuffle_exchange_tpu_torch.inference import (InferenceConfig, InferenceEngine,
                                                  InferenceEngineV2,
                                                  init_inference)
from shuffle_exchange_tpu_torch.models import (Transformer, TransformerConfig,
                                               get_model, llama3_8b,
                                               params_from_numpy,
                                               params_to_numpy, tiny)
from shuffle_exchange_tpu_torch.models import transformer as ttf
from shuffle_exchange_tpu_torch.ops import QuantizedMatrix

LLAMA_TINY = dict(vocab=97, d=32, layers=2, heads=4, seq=128, activation="swiglu",
                  norm="rmsnorm", position="rope", n_kv_heads=2, tie_embeddings=False)


@pytest.fixture(scope="module")
def jax_tree():
    model = JTransformer(jtiny(**LLAMA_TINY))
    return jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(0)))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def test_jax_init_names_and_shapes_equal_the_port(jax_tree):
    model = Transformer(tiny(**LLAMA_TINY), device="cpu")
    want = {k: tuple(v.shape) for k, v in _flat(jax_tree).items()}
    assert model.param_shapes() == want
    state = params_from_numpy(jax_tree)
    assert {k: tuple(v.shape) for k, v in state.items()} == want
    model.load_params(state)
    assert set(model.params()) == set(want)


def test_round_trip_is_bit_equal(jax_tree):
    back = _flat(params_to_numpy(params_from_numpy(jax_tree)))
    for name, arr in _flat(jax_tree).items():
        assert back[name].dtype == arr.dtype, name
        np.testing.assert_array_equal(back[name], arr, err_msg=name)


def test_bf16_leaves_move_bit_for_bit(jax_tree):
    tree = jax.tree.map(lambda a: a.astype(ml_dtypes.bfloat16), jax_tree)
    state = params_from_numpy(tree)
    for name, arr in _flat(tree).items():
        t = state[name]
        assert t.dtype == torch.bfloat16
        np.testing.assert_array_equal(t.view(torch.int16).numpy(), arr.view(np.int16))
    back = _flat(params_to_numpy(state))
    for name, arr in _flat(tree).items():
        np.testing.assert_array_equal(back[name], arr.astype(np.float32))


def test_port_init_follows_the_jax_scales():
    """A seeded ``torch.Generator`` draws with the JAX init's scales: norm
    weights one, norm biases zero, each projection's std its fan-in rule."""
    cfg = tiny(vocab=512, d=256, layers=4, heads=4, seq=64, activation="swiglu",
               norm="rmsnorm", position="rope", n_kv_heads=2, tie_embeddings=False)
    model = Transformer(cfg, device="cpu")
    p1 = model.init(torch.Generator().manual_seed(1))
    p2 = Transformer(cfg, device="cpu").init(torch.Generator().manual_seed(1))
    L, D, Fd, HD = cfg.n_layers, cfg.d_model, cfg.ff_dim, cfg.n_heads * cfg.head_dim
    scales = {"embed": 0.02, "unembed": 0.02, "layers.wq": D ** -0.5, "layers.wk": D ** -0.5,
              "layers.wv": D ** -0.5, "layers.w_gate": D ** -0.5, "layers.w_up": D ** -0.5,
              "layers.wo": 1 / math.sqrt(2 * L) / math.sqrt(HD),
              "layers.w_down": 1 / math.sqrt(2 * L) / math.sqrt(Fd)}
    for name, t in p1.items():
        assert torch.equal(t, p2[name]), f"{name}: same seed, other draw"
        if name in scales:
            assert abs(t.std().item() / scales[name] - 1) < 0.05, name
        elif name.endswith("_w"):
            assert torch.equal(t, torch.ones_like(t)), name
        else:
            assert torch.equal(t, torch.zeros_like(t)), name


def test_norm_rope_and_head_match_jax(jax_tree):
    cfg = jtiny(**LLAMA_TINY)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, cfg.d_model)).astype(np.float32)
    w = jax_tree["layers"]["ln1_w"][0] + 0.1 * rng.standard_normal(cfg.d_model).astype(np.float32)
    want = np.asarray(jtf._norm(jnp.asarray(x), jnp.asarray(w), 0, "rmsnorm", eps=1e-5))
    got = ttf._norm(torch.from_numpy(x), torch.from_numpy(w), eps=1e-5).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)

    jc, js = jtf.rope_table(16, cfg.head_dim, cfg.rope_theta)
    tc, ts = ttf.rope_table(16, cfg.head_dim, cfg.rope_theta)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6, atol=1e-6)
    q = rng.standard_normal((2, 16, 4, cfg.head_dim)).astype(np.float32)
    np.testing.assert_allclose(ttf.apply_rope(torch.from_numpy(q), tc, ts).numpy(),
                               np.asarray(jtf.apply_rope(jnp.asarray(q), jc, js)),
                               rtol=1e-6, atol=1e-6)

    jm = JTransformer(cfg)
    tm = Transformer(tiny(**LLAMA_TINY), device="cpu")
    state = params_from_numpy(jax_tree)
    want = np.asarray(jm.head(jax_tree, jnp.asarray(x)))
    got = tm.head(state, torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    emb, (c, s) = tm.embed(state, torch.tensor([[3, 5, 7]]))
    np.testing.assert_array_equal(emb.numpy(), jax_tree["embed"][[[3, 5, 7]]])
    assert c.shape == (3, cfg.head_dim // 2)


def test_logits_stay_f32_for_bf16_operands():
    x = torch.randn(3, 64).bfloat16()
    w = torch.randn(64, 11).bfloat16()
    out = ttf.logits_f32(x, w)
    assert out.dtype == torch.float32
    torch.testing.assert_close(out, x.float() @ w.float(), rtol=0, atol=0)


@pytest.mark.parametrize("override", [
    {"norm": "layernorm"}, {"activation": "gelu"}, {"position": "alibi"},
    {"position": "learned"}, {"rope_interleaved": True}, {"rotary_dim": 4},
    {"parallel_block": True}, {"embed_ln": True}, {"post_ln": True},
    {"attn_qkv_bias": True}, {"n_experts": 4, "moe_layer_pattern": (True, False)},
    {"local_attention_window": 8},
    {"attention_pattern": ("global", "local")},
])
def test_structures_outside_the_llama_family_raise(override):
    """Structures the training forward takes since the GPT-2 / BLOOM slice
    build a model, and every serving entry point (v1, v2, init_inference)
    serves them, in bf16 weights, quantized weights and (the paged engine)
    with adapters. Interleaved and partial RoPE and parallel blocks serve
    the same way since the parallel-block slice, and train since the
    parallel-block training slice. The rest still refuse the model
    itself."""
    cfg = tiny(**{**LLAMA_TINY, **override})
    parallel_forms = {"rope_interleaved", "rotary_dim", "parallel_block"}
    if set(override) & ({"norm", "activation", "position", "embed_ln", "attn_qkv_bias"}
                        | parallel_forms):
        model = Transformer(cfg, device="cpu")
        params = model.init(torch.Generator().manual_seed(0))
        icfg = dict(max_seq_len=64, kv_block_size=8, num_kv_blocks=16)
        quant = dict(icfg, quantize_weights=True, quant_group_size=32)
        for c in (icfg, quant):
            v1 = init_inference(model, params, dict(c), device="cpu")
            assert v1.generate([[1, 2, 3]], max_new_tokens=2).shape == (1, 2)
            v2 = InferenceEngineV2(model, params, InferenceConfig(**c), device="cpu")
            assert np.isfinite(v2.put([0], [[1, 2, 3]])).all()
        assert isinstance(v2.params["layers.wq"], QuantizedMatrix)
        v2 = InferenceEngineV2(model, params, InferenceConfig(**icfg, adapters={"enabled": True}),
                               device="cpu")
        assert np.isfinite(v2.put([0], [[1, 2, 3]])).all()
        with pytest.raises(ConfigError, match="paged InferenceEngineV2"):
            InferenceEngine(model, params, InferenceConfig(adapters={"enabled": True}),
                            device="cpu")
        if set(override) & parallel_forms:
            assert np.isfinite(model.loss(params, {"input_ids": np.asarray([[1, 2, 3, 4]])})
                               .item())
        return
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Transformer(cfg, device="cpu")


def test_presets_and_registry():
    cfg = llama3_8b()
    assert (cfg.d_model, cfg.n_layers, cfg.n_heads, cfg.kv_heads, cfg.head_dim, cfg.ff_dim,
            cfg.vocab_size, cfg.rope_theta, cfg.tie_embeddings) == \
        (4096, 32, 32, 8, 128, 14336, 128256, 500000.0, False)
    for f in ("vocab_size", "d_model", "n_layers", "n_heads", "n_kv_heads", "d_ff",
              "max_seq_len", "activation", "norm", "position", "rope_theta", "tie_embeddings"):
        assert getattr(cfg, f) == getattr(jtf.llama3_8b(), f), f
    assert isinstance(get_model("tiny", device="cpu", activation="swiglu", norm="rmsnorm",
                                position="rope").config, TransformerConfig)


def test_load_params_refuses_wrong_names_and_shapes(jax_tree):
    model = Transformer(tiny(**LLAMA_TINY), device="cpu")
    state = params_from_numpy(jax_tree)
    with pytest.raises(ValueError, match="missing"):
        model.load_params({k: v for k, v in state.items() if k != "unembed"})
    bad = dict(state, **{"layers.wq": state["layers.wq"][:1]})
    with pytest.raises(ValueError, match="layers.wq"):
        model.load_params(bad)
