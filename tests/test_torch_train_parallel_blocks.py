"""Parallel-block training (GPT-J, GPT-NeoX / Pythia, Falcon) of the
PyTorch port against the JAX package, on the CPU, in f32.

- The flash backward at head_dim 256 (GPT-J-6B's heads): the plain
  versions behind ``flash_attention_lse`` / ``flash_attention_bwd`` against
  ``jax.vjp`` of ``splash_attention_gqa(..., interpret=True)`` (MHA and
  GQA, causal) within 5e-4, the JAX package's own tolerance for its Pallas
  kernels, and against ``jax.vjp`` of ``reference_attention`` within 1e-5
  at a ragged shape with segment ids.
- The loss and every gradient leaf against ``jax.grad`` of the JAX model's
  loss, within 1e-4 of each leaf's largest |value|, on
  ``tests/test_torch_parallel_blocks.py``'s GPT-J and NeoX tinies (norm
  weights and biases drawn from numpy, so a dropped bias shows), a
  Falcon-shaped tiny (one shared layernorm, one kv head, no biases) and a
  GPT-J tiny at head_dim 256: without remat, under full remat with
  ``labels``, and through the chunked loss (``loss_chunk`` > 0, so GPT-J's
  unembedding bias passes through ``chunked_loss``).
- 5-step trajectories, the final master and both Adam moments, against
  the JAX engine on the 8-device virtual mesh: ``bench.py``'s ``_config1``
  on the NeoX tiny and the ``cfg2`` row on the GPT-J tiny, f32 within 1e-4
  and bf16 within 2e-2 (loss) and 5e-2 (leaves), as
  ``tests/test_torch_train_alibi_gpt2.py`` holds BLOOM and GPT-2.
- GPT-J-6B at 14 of its 28 layers (the chip smoke test's training cut) and
  Pythia-1.4b whole: the parameter counts against the JAX init's leaves.
"""

import dataclasses
import importlib

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
from shuffle_exchange_tpu.ops.flash_attention import reference_attention as jreference
from shuffle_exchange_tpu.ops.flash_attention import splash_attention_gqa
from shuffle_exchange_tpu_torch.models import (Transformer, config_from_hf, param_count,
                                               params_from_numpy, tiny, train_state_to_numpy)
from shuffle_exchange_tpu_torch.models.transformer import check_supported
from test_torch_parallel_blocks import GPTJ, GPTJ_6B, NEOX, PYTHIA_1B4
from test_torch_train_alibi_gpt2 import BF16, CFG1, CFG2, _flat, _jax_moments, _scales

tfa = importlib.import_module("shuffle_exchange_tpu_torch.ops.flash_attention")

FALCON = dict(vocab=96, d=64, layers=2, heads=4, n_kv_heads=1, seq=64, activation="gelu",
              norm="layernorm", position="rope", rope_theta=10000.0, parallel_block=True,
              parallel_shared_ln=True, mlp_bias=False, tie_embeddings=False)
# GPT-J's structure at its head_dim (256): two heads of d 512, rotary_dim 64
GPTJ_256 = dict(GPTJ, d=512, heads=2, rotary_dim=64)
SHAPES = {"gptj": GPTJ, "neox": NEOX, "falcon": FALCON, "gptj-dh256": GPTJ_256}
REL = 1e-4
V = 96


def _tree(kind, seed=1, **kw):
    """The JAX init of the ``kind`` tiny with its norm weights and biases
    (the unembedding bias included) drawn from numpy, as nested f32 numpy."""
    tree = jax.tree.map(np.asarray, JTransformer(jtiny(**SHAPES[kind], **kw)).init(
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


def _batch(B=4, T=33, labels=False, seed=0):
    rng = np.random.default_rng(seed)
    batch = {"input_ids": rng.integers(0, V, size=(B, T)).astype(np.int32)}
    if labels:
        lab = rng.integers(0, V, size=(B, T)).astype(np.int32)
        lab[rng.random((B, T)) < 0.3] = -100
        batch["labels"] = lab
    return batch


# ---------------------------------------------------------------------------
# The flash backward at head_dim 256
# ---------------------------------------------------------------------------


def _qkvd(B, T, H, KV, Dh, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32)
            for s in ((B, T, H, Dh), (B, T, KV, Dh), (B, T, KV, Dh), (B, T, H, Dh))]


@pytest.mark.parametrize("H,KV", [(2, 2), (4, 2)], ids=["mha", "gqa"])
def test_flash_backward_at_256_equals_splash_in_interpret_mode(H, KV):
    q, k, v, do = _qkvd(1, 128, H, KV, 256, seed=5)
    jout, vjp = jax.vjp(lambda q, k, v: splash_attention_gqa(q, k, v, True, interpret=True),
                        *(jnp.asarray(a) for a in (q, k, v)))
    want = [np.asarray(g) for g in vjp(jnp.asarray(do))]
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    out, lse = tfa.flash_attention_lse(tq, tk, tv, True)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=5e-4, atol=5e-4)
    got = tfa.flash_attention_bwd(tq, tk, tv, out, lse, tdo, True)
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(g.numpy(), w, rtol=5e-4, atol=5e-4, err_msg=name)


def test_flash_backward_at_256_equals_jax_autodiff_with_segment_ids():
    B, T, H, KV = 2, 77, 4, 2
    q, k, v, do = _qkvd(B, T, H, KV, 256, seed=6)
    seg = np.sort(np.random.default_rng(7).integers(0, 3, size=(B, T)), axis=1).astype(np.int32)
    jout, vjp = jax.vjp(lambda q, k, v: jreference(q, k, v, True, jnp.asarray(seg)),
                        *(jnp.asarray(a) for a in (q, k, v)))
    want = [np.asarray(g) for g in vjp(jnp.asarray(do))]
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    tseg = torch.from_numpy(seg)
    out, lse = tfa.flash_attention_lse(tq, tk, tv, True, tseg)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=1e-5)
    got = tfa.flash_attention_bwd(tq, tk, tv, out, lse, tdo, True, tseg)
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(g.numpy(), w, atol=1e-5, err_msg=name)


# ---------------------------------------------------------------------------
# The model's loss and gradients
# ---------------------------------------------------------------------------

MODES = {"no-remat": (dict(), False), "full-remat-labels": (
    dict(remat=True, remat_policy="nothing_saveable"), True), "chunked-loss": (
    dict(loss_chunk=8), False)}


@pytest.mark.parametrize("kind", list(SHAPES))
@pytest.mark.parametrize("mode", list(MODES))
def test_loss_and_every_gradient_equal_jax(kind, mode):
    kw, labels = MODES[mode]
    tree = _tree(kind)
    batch = _batch(B=2 if kind == "gptj-dh256" else 4, labels=labels)
    jm = JTransformer(jtiny(**SHAPES[kind], **kw))
    tm = Transformer(tiny(**SHAPES[kind], **kw), device="cpu")
    if mode == "chunked-loss":
        assert tm._loss_chunk(*batch["input_ids"][:, 1:].shape) == 8
    tp = {k: v.requires_grad_(True) for k, v in params_from_numpy(tree).items()}
    jloss, jgrads = jax.value_and_grad(jm.loss)(jax.tree.map(jnp.asarray, tree),
                                                {k: jnp.asarray(v) for k, v in batch.items()})
    loss = tm.loss(tp, batch)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=REL)
    grads = torch.autograd.grad(loss, list(tp.values()))
    want = _flat(jax.tree.map(np.asarray, jgrads))
    assert set(want) == set(tp)
    assert ("layers.ln2_w" in want) == (kind == "neox")
    assert ("unembed_b" in want) == kind.startswith("gptj")
    scales = _scales(want)
    for name, g in zip(tp, grads):
        w, scale = want[name], scales[name]
        np.testing.assert_allclose(g.numpy() / scale, w / scale, atol=REL, err_msg=name)


def test_the_unembedding_bias_moves_the_chunked_loss():
    """The chunked loss reads ``unembed_b``: zeroing it moves the loss, and
    the chunked and full-logits losses agree with it in place."""
    tree = _tree("gptj")
    tp = params_from_numpy(tree)
    full = Transformer(tiny(**GPTJ, loss_chunk=0), device="cpu")
    chunked = Transformer(tiny(**GPTJ, loss_chunk=8), device="cpu")
    with torch.no_grad():
        a, b = chunked.loss(tp, _batch()).item(), full.loss(tp, _batch()).item()
        np.testing.assert_allclose(a, b, rtol=1e-6)
        zeroed = dict(tp, unembed_b=torch.zeros_like(tp["unembed_b"]))
        assert abs(chunked.loss(zeroed, _batch()).item() - a) > 1e-3


# ---------------------------------------------------------------------------
# Trajectories against the JAX engine
# ---------------------------------------------------------------------------

N = 5


@pytest.mark.parametrize("kind,config,loss_tol,leaf_tol", [
    ("neox", CFG1, 1e-4, 1e-4), ("neox", dict(CFG1, **BF16), 2e-2, 5e-2),
    ("gptj", CFG2, 1e-4, 1e-4), ("gptj", dict(CFG2, **BF16), 2e-2, 5e-2),
], ids=["neox-cfg1-f32", "neox-cfg1-bf16", "gptj-cfg2-f32", "gptj-cfg2-bf16"])
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


# ---------------------------------------------------------------------------
# The chip smoke test's training models
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("hf,layers,n", [(GPTJ_6B, 14, 3_231_909_088),
                                         (PYTHIA_1B4, 24, 1_414_647_808)],
                         ids=["gpt-j-6b-14-layers", "pythia-1.4b"])
def test_training_models_count_the_jax_init_leaves(hf, layers, n):
    """GPT-J-6B cut to 14 layers (its shared layernorm: no ln2 leaves) and
    Pythia-1.4b whole, counted by ``param_count``, by the port's leaves and
    by the JAX init's under ``jax.eval_shape``; both pass
    ``check_supported``."""
    cfg = dataclasses.replace(config_from_hf(hf), n_layers=layers)
    jcfg = dataclasses.replace(jhf.config_from_hf(hf), n_layers=layers)
    shapes = jax.eval_shape(JTransformer(jcfg).init, jax.random.PRNGKey(0))
    assert sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes)) == n
    assert param_count(cfg) == n
    model = Transformer(cfg, device="cpu")
    assert sum(int(np.prod(s)) for s in model.param_shapes().values()) == n
    assert ("layers.ln2_w" in model.param_shapes()) == (hf is PYTHIA_1B4)
    check_supported(cfg)
