"""BLOOM- and GPT-2-shaped training of the PyTorch port against the JAX
package, on the CPU.

A BLOOM-shaped ``tiny()`` (ALiBi, ``embed_ln``, layernorm, ``gelu_new``,
q/k/v/out and fc biases, tied) and a GPT-2-shaped one (learned positions,
exact gelu, biases) get one set of weights: the JAX init with every norm
weight and bias (ones and zeros there) replaced by numpy-seeded values, so
a dropped or misplaced bias shows. Moved over as numpy, the port's loss and
every gradient leaf are held against ``jax.grad(model.loss)`` in f32 to 1e-4
relative to each leaf's largest |value|, with and without remat and
``labels``; the JAX side takes its jnp references on the CPU (its ALiBi
kernel gate is closed there). Then 5-step trajectories, the final master
and both Adam moments against the JAX engine on the 8-device virtual mesh:
``bench.py``'s ``_config1`` (AdamW, ZeRO 1) on the GPT-2 tiny and the
``cfg2`` row (FusedAdam, ZeRO 3) on the BLOOM tiny, f32 within 1e-4 and
bf16 within 2e-2 (loss) and 5e-2 (leaves), as
``tests/test_torch_train_engine.py`` holds the Llama engine. Last, the port's
``config_from_hf`` against JAX's on published configs, and the parameter
counts of BLOOM-1b7 and ``gpt2_small`` against the JAX init's leaves.

The k bias's gradient is zero in exact arithmetic (a per-head shift of k
moves every score of a row by the same q . b_k, and softmax ignores it), so
both packages hand back f32 noise of order 1e-10 there: its leaves are held
relative to the largest |value| of all leaves instead of their own.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import shuffle_exchange_tpu as jsxt
import shuffle_exchange_tpu_torch as sxt
from shuffle_exchange_tpu.models import Transformer as JTransformer
from shuffle_exchange_tpu.models import hf as jhf
from shuffle_exchange_tpu.models import tiny as jtiny
from shuffle_exchange_tpu.models import transformer as jtf
from shuffle_exchange_tpu_torch.models import (Transformer, config_from_hf, gpt2_large,
                                               gpt2_small, param_count, params_from_numpy,
                                               params_to_numpy, tiny, train_state_to_numpy)

BLOOM = dict(vocab=97, d=32, layers=2, heads=4, seq=64, activation="gelu_new", norm="layernorm",
             position="alibi", embed_ln=True, attn_qkv_bias=True, attn_out_bias=True)
GPT2 = dict(vocab=97, d=32, layers=2, heads=4, seq=64, activation="gelu", norm="layernorm",
            position="learned", attn_qkv_bias=True, attn_out_bias=True)
SHAPES = {"bloom": BLOOM, "gpt2": GPT2}
REL = 1e-4

# BLOOM-1b7's published config.json (bigscience/bloom-1b7), bloom-560m's and
# gpt2's, as the fields config_from_hf reads them
BLOOM_1B7 = {"architectures": ["BloomForCausalLM"], "model_type": "bloom", "hidden_size": 2048,
             "n_head": 16, "n_layer": 24, "vocab_size": 250880, "layer_norm_epsilon": 1e-5,
             "apply_residual_connection_post_layernorm": False, "offset_alibi": 100,
             "pretraining_tp": 2, "slow_but_exact": False, "initializer_range": 0.02}
BLOOM_560M = dict(BLOOM_1B7, hidden_size=1024)
GPT2_HF = {"architectures": ["GPT2LMHeadModel"], "model_type": "gpt2", "activation_function":
           "gelu_new", "n_ctx": 1024, "n_embd": 768, "n_head": 12, "n_layer": 12,
           "n_positions": 1024, "layer_norm_epsilon": 1e-5, "vocab_size": 50257}
LLAMA_HF = {"architectures": ["LlamaForCausalLM"], "model_type": "llama", "hidden_size": 4096,
            "intermediate_size": 14336, "num_attention_heads": 32, "num_hidden_layers": 32,
            "num_key_value_heads": 8, "max_position_embeddings": 8192, "rms_norm_eps": 1e-5,
            "rope_theta": 500000.0, "vocab_size": 128256, "tie_word_embeddings": False}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _tree(kind, seed=0, **kw):
    """The JAX init of the ``kind`` tiny with its norm weights and biases
    drawn from a numpy generator, as a nested dict of f32 numpy arrays."""
    tree = jax.tree.map(np.asarray, JTransformer(jtiny(**SHAPES[kind], **kw)).init(
        jax.random.PRNGKey(0)))
    rng = np.random.default_rng(seed)

    def walk(node):
        for name, leaf in node.items():
            if isinstance(leaf, dict):
                walk(leaf)
            elif name.endswith("_w") and name.startswith(("ln", "embed_ln")):
                node[name] = (1 + 0.2 * rng.normal(size=leaf.shape)).astype(np.float32)
            elif name.endswith("_b") or name.startswith("b_"):
                node[name] = (0.1 * rng.normal(size=leaf.shape)).astype(np.float32)

    walk(tree)
    return tree


def _scales(tree):
    """Each leaf's comparison scale: its largest |value|, the tree's for the
    k bias (zero gradient in exact arithmetic)."""
    top = max(float(np.abs(w).max()) for w in tree.values())
    return {name: max(top if name.endswith("b_k") else float(np.abs(w).max()), 1e-12)
            for name, w in tree.items()}


def _batch(B=4, T=33, labels=False, seed=0):
    rng = np.random.default_rng(seed)
    batch = {"input_ids": rng.integers(0, 97, size=(B, T)).astype(np.int32)}
    if labels:
        lab = rng.integers(0, 97, size=(B, T)).astype(np.int32)
        lab[rng.random((B, T)) < 0.3] = -100
        batch["labels"] = lab
    return batch


def test_leaves_cross_by_name_and_round_trip_bit_equal():
    for kind in SHAPES:
        tree = _tree(kind)
        model = Transformer(tiny(**SHAPES[kind]), device="cpu")
        assert model.param_shapes() == {k: v.shape for k, v in _flat(tree).items()}
        back = _flat(params_to_numpy(params_from_numpy(tree)))
        for name, arr in _flat(tree).items():
            np.testing.assert_array_equal(back[name], arr, err_msg=name)
        model.load_params(params_from_numpy(tree))
    names = set(Transformer(tiny(**BLOOM), device="cpu").param_shapes())
    assert {"embed_ln_w", "embed_ln_b", "layers.b_q", "layers.b_o", "layers.b_up"} <= names
    assert "pos_embed" in Transformer(tiny(**GPT2), device="cpu").param_shapes()


def _hold_loss_and_grads(kind, tree, batch, **kw):
    """The port's loss and every gradient leaf against ``jax.grad`` of the
    JAX model's loss, both built as ``tiny(**SHAPES[kind], **kw)``."""
    jm = JTransformer(jtiny(**SHAPES[kind], **kw))
    tm = Transformer(tiny(**SHAPES[kind], **kw), device="cpu")
    tp = {k: v.requires_grad_(True) for k, v in params_from_numpy(tree).items()}
    jloss, jgrads = jax.value_and_grad(jm.loss)(jax.tree.map(jnp.asarray, tree),
                                                {k: jnp.asarray(v) for k, v in batch.items()})
    loss = tm.loss(tp, batch)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=REL)
    grads = torch.autograd.grad(loss, list(tp.values()))
    want = _flat(jax.tree.map(np.asarray, jgrads))
    assert set(want) == set(tp)
    scales = _scales(want)
    for name, g in zip(tp, grads):
        w, scale = want[name], scales[name]
        np.testing.assert_allclose(g.numpy() / scale, w / scale, atol=REL, err_msg=name)


@pytest.mark.parametrize("kind", list(SHAPES))
@pytest.mark.parametrize("remat,labels", [(False, False), (True, True), (True, False)],
                         ids=["plain-shift", "remat-labels", "remat-shift"])
def test_loss_and_every_gradient_equal_jax(kind, remat, labels):
    _hold_loss_and_grads(kind, _tree(kind), _batch(labels=labels), remat=remat,
                         remat_policy="nothing_saveable")


# the knobs no preset sets away from their defaults: OPT's learned-position
# offset, Falcon's slope scale (1/sqrt(Dh)) and bias-free MLP
KNOBS = {"gpt2-pos_offset-2": ("gpt2", dict(pos_offset=2)),
         "gpt2-mlp_bias-off": ("gpt2", dict(mlp_bias=False)),
         "bloom-alibi_slope_scale": ("bloom", dict(alibi_slope_scale=8 ** -0.5)),
         "bloom-mlp_bias-off": ("bloom", dict(mlp_bias=False))}


@pytest.mark.parametrize("kind,knobs", list(KNOBS.values()), ids=list(KNOBS))
def test_knobs_off_their_defaults_equal_jax(kind, knobs):
    """Leaves, parameter count, loss and every gradient leaf against the
    JAX package with ``pos_offset``, ``alibi_slope_scale`` or ``mlp_bias``
    away from its default."""
    tree = _tree(kind, **knobs)
    cfg = tiny(**SHAPES[kind], **knobs)
    flat = _flat(tree)
    assert Transformer(cfg, device="cpu").param_shapes() == {k: v.shape for k, v in flat.items()}
    assert param_count(cfg) == sum(v.size for v in flat.values())
    _hold_loss_and_grads(kind, tree, _batch(labels=True), **knobs)


@pytest.mark.parametrize("kind", list(SHAPES))
def test_apply_logits_and_the_chunked_loss_equal_jax(kind):
    tree = _tree(kind, seed=1)
    jm, tm = JTransformer(jtiny(**SHAPES[kind])), Transformer(tiny(**SHAPES[kind]), device="cpu")
    tp = params_from_numpy(tree)
    ids = _batch()["input_ids"]
    with torch.no_grad():
        got = tm.apply(tp, ids)
    np.testing.assert_allclose(got.numpy(), np.asarray(jm.apply(jax.tree.map(jnp.asarray, tree),
                                                                jnp.asarray(ids))), atol=1e-4)
    chunked = Transformer(tiny(**SHAPES[kind], loss_chunk=8), device="cpu")
    with torch.no_grad():
        np.testing.assert_allclose(chunked.loss(tp, _batch()).item(), tm.loss(tp, _batch()).item(),
                                   rtol=1e-6)


CFG1 = {"train_batch_size": 8, "steps_per_print": 10 ** 9, "zero_optimization": {"stage": 1},
        "optimizer": {"type": "AdamW", "params": {"lr": 3e-4, "weight_decay": 0.1}}}
CFG2 = {"train_batch_size": 8, "steps_per_print": 10 ** 9, "zero_optimization": {"stage": 3},
        "optimizer": {"type": "FusedAdam", "params": {"lr": 3e-4, "weight_decay": 0.1}}}
BF16 = {"bf16": {"enabled": True}}
N = 5


def _jax_moments(jeng):
    found = {}

    def walk(node):
        if hasattr(node, "mu") and hasattr(node, "nu"):
            found.update(count=int(node.count), mu=node.mu, nu=node.nu)
        elif isinstance(node, (tuple, list)):
            for x in node:
                walk(x)

    walk(jax.device_get(jeng.state.opt_state))
    return found["count"], _flat(found["mu"]), _flat(found["nu"])


@pytest.mark.parametrize("kind,config,loss_tol,leaf_tol", [
    ("gpt2", CFG1, 1e-4, 1e-4), ("gpt2", dict(CFG1, **BF16), 2e-2, 5e-2),
    ("bloom", CFG2, 1e-4, 1e-4), ("bloom", dict(CFG2, **BF16), 2e-2, 5e-2),
], ids=["gpt2-cfg1-f32", "gpt2-cfg1-bf16", "bloom-cfg2-f32", "bloom-cfg2-bf16"])
def test_five_step_trajectory_and_final_state_equal_the_jax_engine(kind, config, loss_tol,
                                                                   leaf_tol):
    kw = dict(remat=True, remat_policy="nothing_saveable")
    tree = _tree(kind)
    jeng, *_ = jsxt.initialize(model=JTransformer(jtiny(**SHAPES[kind], **kw)),
                               params=jax.tree.map(jnp.asarray, tree), config=dict(config))
    teng, *_ = sxt.initialize(model=Transformer(tiny(**SHAPES[kind], **kw), device="cpu"),
                              params=params_from_numpy(tree), config=dict(config), device="cpu")
    batch = _batch(B=8, T=17)
    jlosses = [float(jeng.train_batch(batch)) for _ in range(N)]
    tlosses = [float(teng.train_batch(batch)) for _ in range(N)]
    np.testing.assert_allclose(tlosses, jlosses, rtol=loss_tol)
    assert tlosses[-1] < tlosses[0]
    got = train_state_to_numpy(teng)
    count, mu, nu = _jax_moments(jeng)
    assert got["count"] == count == N
    for what, want in (("master", _flat(jax.device_get(jeng.state.master))), ("mu", mu),
                       ("nu", nu)):
        have = _flat(got[what])
        assert set(have) == set(want)
        scales = _scales(want)
        for name, w in want.items():
            scale = scales[name]
            np.testing.assert_allclose(have[name] / scale, w / scale, atol=leaf_tol,
                                       err_msg=f"{what}.{name}")


@pytest.mark.parametrize("hf", [BLOOM_1B7, BLOOM_560M, GPT2_HF, LLAMA_HF],
                         ids=["bloom-1b7", "bloom-560m", "gpt2", "llama-3-8b"])
def test_config_from_hf_equals_jax_field_by_field(hf):
    got, want = config_from_hf(dict(hf)), jhf.config_from_hf(dict(hf))
    for f in dataclasses.fields(got):
        assert getattr(got, f.name) == getattr(want, f.name), f.name


def test_config_from_hf_refuses_unported_families():
    with pytest.raises(NotImplementedError, match="item 14"):
        config_from_hf({"architectures": ["OPTForCausalLM"], "hidden_size": 64})
    with pytest.raises(ValueError, match="Unsupported"):
        config_from_hf({"architectures": ["NoSuchModel"]})


def test_param_counts_equal_the_jax_init():
    """BLOOM-1b7 is 1,722,408,960 parameters and ``gpt2_small`` 124,439,808,
    as the JAX init's leaves count them under ``jax.eval_shape``."""
    for cfg, jcfg, n in ((config_from_hf(BLOOM_1B7), jhf.config_from_hf(BLOOM_1B7),
                          1_722_408_960),
                         (gpt2_small(), jtf.gpt2_small(), 124_439_808)):
        shapes = jax.eval_shape(JTransformer(jcfg).init, jax.random.PRNGKey(0))
        assert sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes)) == n
        assert param_count(cfg) == n
        assert sum(int(np.prod(s)) for s in
                   Transformer(cfg, device="cpu").param_shapes().values()) == n
    for port, ref in ((gpt2_small(), jtf.gpt2_small()), (gpt2_large(), jtf.gpt2_large())):
        for f in dataclasses.fields(port):
            assert getattr(port, f.name) == getattr(ref, f.name), f.name
