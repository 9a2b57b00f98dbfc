"""Cases of BLOOM- and GPT-2-shaped serving of the PyTorch port against the
JAX engines, on the CPU, in f32. ``test_torch_serve_bloom.py`` and
``test_torch_serve_gpt2.py`` collect them, each for its model (``KIND`` in
the collecting module), so that the two run on separate test workers.

A BLOOM-shaped ``tiny()`` (ALiBi, ``embed_ln``, layernorm, ``gelu_new``,
q/k/v/out and fc biases, tied) and a GPT-2-shaped one (learned positions,
exact gelu, biases, layernorm) get the JAX init with every norm weight and
bias replaced by numpy-seeded values, so a dropped or misplaced bias
shows. Both packages' engines then serve the same requests:

- ``step()`` schedules (extend-only, mixed, decode-only ticks and a new
  uid mid-decode): logits within 1e-4;
- ``ContinuousBatchingScheduler.serve``: tokens equal to the JAX
  scheduler's;
- ``put()`` + ``decode_loop``: ``put()`` logits within 1e-4 and the loop's
  tokens equal;
- the v1 ``generate``: tokens equal.

Each on "xla" (the paged kernels' plain versions with the slopes) and on
"pallas" (the fused kernels' plain versions: B4 with biases and no RoPE,
B5 with the slopes, B6 in BLOOM's layernorm + biases + ``gelu_new`` form;
GPT-2's exact gelu keeps its MLP on the layer body, as in JAX). On
"pallas" the JAX engine runs its Pallas kernels in interpret mode
(``SXT_FUSED_INTERPRET=1``) and drops to its XLA body silently when one
fails, so the test counts the JAX kernels' traces and the port wrappers'
calls: both must show the fused route the model earns.
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
# the training tests' tinies and weights (norm weights and biases drawn from numpy)
from test_torch_train_alibi_gpt2 import SHAPES, _tree

jfd = importlib.import_module("shuffle_exchange_tpu.ops.fused_decode")
tie = importlib.import_module("shuffle_exchange_tpu_torch.inference.engine")
tie2 = importlib.import_module("shuffle_exchange_tpu_torch.inference.engine_v2")

TOL = 1e-4
#: the fused kernels each model's "pallas" decode runs (GPT-2's exact gelu
#: does not fuse)
FUSED = {"bloom": {"qkv", "attention", "mlp"}, "gpt2": {"qkv", "attention"}}
JAX_KERNELS = {"qkv": "fused_qkv_rope_pallas", "attention": "fused_paged_decode_attention_pallas",
               "mlp": "fused_mlp_pallas"}


@pytest.fixture(scope="module")
def models(request):
    kind = request.module.KIND
    tree = _tree(kind, seed=1)
    jm = JTransformer(jtiny(**SHAPES[kind]))
    jp = jax.tree.map(jnp.asarray, tree)
    tm = Transformer(tiny(**SHAPES[kind]), device="cpu")
    state = params_from_numpy(tree)
    tm.load_params(state)
    return kind, jm, jp, tm, state


def _cfg(cls, decode_kernel, num_kv_blocks=40):
    return cls(dtype="float32", max_seq_len=64, kv_block_size=8, num_kv_blocks=num_kv_blocks,
               decode_kernel=decode_kernel,
               serving={"token_budget": 16, "max_running": 4, "chunk_min": 4})


@pytest.fixture
def routes(monkeypatch):
    """Turn on JAX's interpret-mode fused kernels and count, per fused
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
    for mod, name, key in ((tie, "fused_qkv_rope", "qkv"), (tie, "fused_mlp", "mlp"),
                           (tie2, "fused_qkv_rope", "qkv"),
                           (tie2, "fused_paged_decode_attention", "attention")):
        monkeypatch.setattr(mod, name, counted(getattr(mod, name), "port", key))
    return counts


def _check_routes(counts, kind, kernels=("qkv", "attention", "mlp")):
    for key in kernels:
        want = key in FUSED[kind]
        assert (counts["jax"][key] > 0) == want, counts
        assert (counts["port"][key] > 0) == want, counts


def _engines(models, decode_kernel, num_kv_blocks=40):
    kind, jm, jp, tm, state = models
    return (JEngine(jm, jp, _cfg(JConfig, decode_kernel, num_kv_blocks)),
            InferenceEngineV2(tm, state, _cfg(InferenceConfig, decode_kernel, num_kv_blocks),
                              device="cpu"))


def _prompts(seed, lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 90, size=int(n)).tolist() for n in lengths]


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
        ([0, 2], toks[6:8], []),
        ([2], toks[8:9], [(3, p[1][:3])]),                          # a new uid mid-decode
    ]
    for tick in schedule:
        jd, jpl = je.step(*tick)
        td, tpl = te.step(*tick)
        np.testing.assert_allclose(td, jd, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(tpl, jpl, rtol=TOL, atol=TOL)
    assert te.dispatches_by_program.keys() == {"extend", "mixed", "decode"}
    if counts is not None:
        _check_routes(counts, models[0])


@pytest.mark.parametrize("decode_kernel", ["xla", "pallas"])
def test_serve_tokens_equal_the_jax_scheduler(models, decode_kernel, request):
    counts = _routes_if(decode_kernel, request)
    je, te = _engines(models, decode_kernel)
    prompts = _prompts(2, (12, 5, 22, 9))
    want = JScheduler(je).serve(prompts, max_new_tokens=8)
    sched = ContinuousBatchingScheduler(te)
    got = sched.serve(prompts, max_new_tokens=8)
    assert got == want
    assert all(len(t) == 8 for t in got.values())
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
    got = te.decode_loop(uids, first, 6)
    np.testing.assert_array_equal(got, je.decode_loop(uids, first, 6))
    # a multi-token extension (two extend chunks) after the loop
    ext = _prompts(5, (11,))[0]
    np.testing.assert_allclose(te.put([1], [ext]), je.put([1], [ext]), rtol=TOL, atol=TOL)
    assert te.program_shapes == je.program_shapes
    if counts is not None:
        _check_routes(counts, models[0], ("qkv", "attention"))


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
    got = te.generate(ids, prompt_lengths=lens, max_new_tokens=10)
    np.testing.assert_array_equal(got, want)
    if counts is not None:   # the v1 decode step: fused QKV (no pool) and MLP
        _check_routes(counts, kind, ("qkv", "mlp"))


def test_embed_at_matches_jax_past_the_position_table(models):
    """``embed_ln`` before the learned positions, and a position past the
    table reads its last row (JAX's ``mode="clip"``)."""
    je, te = _engines(models, "xla")
    ids = np.asarray([[5, 7, 9], [1, 2, 3]], np.int32)
    pos = np.asarray([0, 62], np.int32)     # the second row runs to 64 of a 64-row table
    want, _, wpos = je._embed_at(je.params, jnp.asarray(ids), jnp.asarray(pos))
    got, gpos = te._embed_at(torch.from_numpy(ids), torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(gpos.numpy(), np.asarray(wpos))
