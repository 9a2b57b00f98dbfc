"""The port's training forward against the JAX package, on the CPU.

A Llama-shaped ``tiny()`` gets one set of weights (the JAX init, moved
over as numpy arrays) and one numpy-seeded batch; the loss, the chunked
loss and every gradient leaf of the port are held against
``jax.grad(model.loss)`` in f32 to 1e-4 relative to each leaf's largest
|value| (the same arithmetic in another summation order), with and without
``remat``. The JAX side reaches no Pallas kernel on the CPU (its flash and
RMSNorm wrappers take their references there, as its own tests run them).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shuffle_exchange_tpu.models import Transformer as JTransformer
from shuffle_exchange_tpu.models import tiny as jtiny
from shuffle_exchange_tpu_torch.models import Transformer, params_from_numpy, tiny
from shuffle_exchange_tpu_torch.models import transformer as ttf

LLAMA = dict(vocab=97, d=32, layers=3, heads=4, seq=64, activation="swiglu", norm="rmsnorm",
             position="rope", n_kv_heads=2)
REL = 1e-4


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def _pair(**kw):
    """(jax model, jax params, port model, port params requiring grad)."""
    jm = JTransformer(jtiny(**LLAMA, **kw))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = Transformer(tiny(**LLAMA, **kw), device="cpu")
    tp = {k: v.requires_grad_(True)
          for k, v in params_from_numpy(jax.tree.map(np.asarray, jp)).items()}
    return jm, jp, tm, tp


def _batch(B=4, T=33, labels=False, seed=0):
    rng = np.random.default_rng(seed)
    batch = {"input_ids": rng.integers(0, LLAMA["vocab"], size=(B, T)).astype(np.int32)}
    if labels:
        lab = rng.integers(0, LLAMA["vocab"], size=(B, T)).astype(np.int32)
        lab[rng.random((B, T)) < 0.3] = -100
        batch["labels"] = lab
    return batch


def _assert_grads(tm, tp, jgrads, loss):
    grads = torch.autograd.grad(loss, list(tp.values()), allow_unused=True)
    want = _flat(jax.tree.map(np.asarray, jgrads))
    assert set(want) == set(tp)
    for (name, _), g in zip(tp.items(), grads):
        w = want[name]
        if g is None:       # the norm biases: unused by RMSNorm, zero in JAX
            assert name.endswith("_b") and not w.any(), name
            continue
        scale = max(np.abs(w).max(), 1e-12)
        np.testing.assert_allclose(g.numpy() / scale, w / scale, atol=REL, err_msg=name)


@pytest.mark.parametrize("tie,remat,labels", [
    (True, False, False), (True, True, True), (False, True, False), (False, False, True)],
    ids=["tied-plain-shift", "tied-remat-labels", "untied-remat-shift", "untied-plain-labels"])
def test_loss_and_every_gradient_equal_jax(tie, remat, labels):
    kw = dict(tie_embeddings=tie, remat=remat, remat_policy="nothing_saveable")
    jm, jp, tm, tp = _pair(**kw)
    batch = _batch(labels=labels)
    jloss, jgrads = jax.value_and_grad(jm.loss)(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    loss = tm.loss(tp, batch)
    assert loss.dtype == torch.float32
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=REL)
    _assert_grads(tm, tp, jgrads, loss)


@pytest.fixture(scope="module")
def jax_chunked():
    """The JAX loss and gradients with the chunked loss (8 tokens a chunk;
    the JAX package's own tests hold it equal to its full-logits path)."""
    jm = JTransformer(jtiny(**LLAMA, loss_chunk=8))
    jp = jm.init(jax.random.PRNGKey(0))
    return jax.value_and_grad(jm.loss)(jp, {"input_ids": jnp.asarray(_batch()["input_ids"])})


@pytest.mark.parametrize("chunk", [0, 8, 5, 256, -1])
def test_chunked_loss_equals_head_and_token_loss(chunk, jax_chunked):
    """Any chunk size (ragged last chunk, larger than T, auto) gives the
    loss and gradients of the full-logits path, and the JAX chunked loss."""
    _, _, tm, tp = _pair(loss_chunk=chunk)
    batch = _batch()
    jloss, jgrads = jax_chunked
    loss = tm.loss(tp, batch)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=REL)
    _assert_grads(tm, tp, jgrads, loss)
    with torch.no_grad():
        ids = torch.from_numpy(batch["input_ids"]).long()
        nll, cnt = tm.token_loss(tm.apply(tp, ids[:, :-1]), ids[:, 1:])
    np.testing.assert_allclose(loss.item(), (nll / cnt).item(), rtol=1e-6)


def test_loss_chunk_rule_equals_jax():
    for B, T, vocab, c in ((32, 1023, 128256, -1), (2, 64, 97, -1), (4, 2048, 32000, -1),
                           (2, 64, 97, 16), (2, 10, 97, 16), (2, 64, 97, 0)):
        kw = dict(LLAMA, vocab=vocab, loss_chunk=c)
        assert (Transformer(tiny(**kw), device="cpu")._loss_chunk(B, T)
                == JTransformer(jtiny(**kw))._loss_chunk(B, T))
    assert Transformer(tiny(**dict(LLAMA, vocab=128256)), device="cpu")._loss_chunk(32, 1023) == 256


def test_apply_logits_equal_jax():
    jm, jp, tm, tp = _pair()
    ids = _batch()["input_ids"]
    with torch.no_grad():
        got = tm.apply(tp, ids)
    want = np.asarray(jm.apply(jp, jnp.asarray(ids)))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


def test_stacked_leaves_get_one_stacked_gradient_and_biases_none():
    _, _, tm, tp = _pair()
    loss = tm.loss(tp, _batch())
    grads = dict(zip(tp, torch.autograd.grad(loss, list(tp.values()), allow_unused=True)))
    assert grads["layers.wq"].shape == tp["layers.wq"].shape
    assert grads["layers.ln1_b"] is None and grads["ln_f_b"] is None
    assert grads["embed"].abs().sum() > 0          # tied: lookup and every loss chunk


def test_model_own_parameters_train_like_a_module():
    """``loss(None, batch)`` differentiates the model's own parameters,
    whose state-dict names stay the flattened JAX names."""
    tm = Transformer(tiny(**LLAMA), device="cpu")
    tm.init(torch.Generator().manual_seed(0))
    assert set(tm.state_dict()) == set(tm.param_shapes())
    tm.loss(None, _batch()).backward()
    assert tm.layers["wq"].grad is not None and tm._parameters["embed"].grad is not None
    assert not tm.params()["embed"].requires_grad


@pytest.mark.parametrize("policy,item", [
    ("dots_saveable", "item 4"), ("save_ffn", "item 4"), ("save_attn_seams", "item 4"),
    ("dots_with_no_batch_dims_saveable", "item 4"), ("save_flash_lse", "item 5"),
    ("offload_kv_host", "item 12")])
def test_unported_remat_policies_raise_naming_their_item(policy, item):
    tm = Transformer(tiny(**LLAMA, remat=True, remat_policy=policy), device="cpu")
    tp = tm.init(torch.Generator().manual_seed(0))
    with pytest.raises(NotImplementedError, match=f"ROADMAP queue A, {item}"):
        tm.loss(tp, _batch())
    assert ttf._remat_policy("none") is None
    assert ttf._remat_policy("full") == ttf._remat_policy("nothing_saveable") == "full"
    with pytest.raises(ValueError, match="unknown remat_policy"):
        ttf._remat_policy("everything")


def test_new_config_fields_keep_the_jax_names_and_defaults():
    port, ref = tiny(), jtiny()
    for name in ("remat", "remat_policy", "loss_chunk", "aux_loss_coef", "causal"):
        assert getattr(port, name) == getattr(ref, name), name
    with pytest.raises(NotImplementedError, match="item 4"):
        Transformer(dataclasses.replace(tiny(**LLAMA), causal=False), device="cpu")
    with pytest.raises(NotImplementedError, match="item 14"):
        tm = Transformer(tiny(**LLAMA), device="cpu")
        tm.loss(tm.init(torch.Generator().manual_seed(0)),
                dict(_batch(), pld_theta=np.ones(4, np.float32)))


def test_ladder_rule_equals_the_bench_rule():
    """The port's copy of the training ladder: names, sizes and the pick for
    a range of device memories equal ``bench.py``'s."""
    import bench

    for hbm in (16e9, 40e9, 80e9, 85e9, 141e9, 400e9, 1e9):
        name, cfg = ttf.pick_ladder_config(int(hbm))
        jname, jcfg = bench.pick_config2(int(hbm))
        assert name == jname, hbm
        assert ttf.param_count(cfg) == bench._param_count(jcfg)
        for f in ("vocab_size", "d_model", "n_layers", "n_heads", "n_kv_heads", "tie_embeddings"):
            assert getattr(cfg, f) == getattr(jcfg, f), (name, f)
        assert cfg.ff_dim == jcfg.ff_dim
    assert ttf.pick_ladder_config(80 * 2 ** 30)[0] == "llama3-1b-style"
    assert ttf.param_count(ttf.pick_ladder_config(80 * 2 ** 30)[1]) == 1_235_814_400
