"""The PyTorch port's paged serving slice against the JAX package.

The JAX ``InferenceEngineV2`` and ``ContinuousBatchingScheduler`` and the
port's (on ``device="cpu"``, where every kernel wrapper takes its plain
version) get the same weights and the same requests, in f32, with
``decode_kernel: "xla"``:

- a teacher-forced ``step()`` schedule of extend-only, mixed and
  decode-only ticks gives per-tick logits within 1e-4 (f32, another
  summation order in the matmuls and the softmax), the same free blocks
  and the same program shapes;
- ``serve()`` gives exactly the JAX scheduler's tokens, also when a small
  pool forces preemptions on both sides.

The model and config shapes are those of ``tests/test_serving_scheduler.py``
so the JAX programs come from the compile cache that file fills.
"""

import jax
import numpy as np
import pytest
import torch

from shuffle_exchange_tpu.inference import ContinuousBatchingScheduler as JScheduler
from shuffle_exchange_tpu.inference import InferenceConfig as JConfig
from shuffle_exchange_tpu.inference import InferenceEngineV2 as JEngine
from shuffle_exchange_tpu.models import Transformer as JTransformer
from shuffle_exchange_tpu.models import tiny as jtiny
from shuffle_exchange_tpu_torch.inference import (ContinuousBatchingScheduler,
                                                  InferenceConfig,
                                                  InferenceEngineV2)
from shuffle_exchange_tpu_torch.models import Transformer, params_from_numpy, tiny

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


def _cfg(cls, num_kv_blocks=40):
    return cls(dtype="float32", max_seq_len=64, kv_block_size=8,
               num_kv_blocks=num_kv_blocks, decode_kernel="xla",
               serving={"token_budget": 16, "max_running": 4, "chunk_min": 4})


def _engines(models, num_kv_blocks=40):
    jm, jp, tm, state = models
    return (JEngine(jm, jp, _cfg(JConfig, num_kv_blocks)),
            InferenceEngineV2(tm, state, _cfg(InferenceConfig, num_kv_blocks), device="cpu"))


def _prompts(seed, lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 90, size=int(n)).tolist() for n in lengths]


def test_step_schedule_logits_match_jax(models):
    """Extend-only, mixed and decode-only ticks, with a flush between:
    per-tick logits within 1e-4, equal free blocks and program shapes."""
    je, te = _engines(models)
    p = _prompts(0, (12, 5, 22))
    toks = np.random.default_rng(9).integers(1, 90, size=16).tolist()
    schedule = [
        ([], [], [(0, p[0][:10]), (1, p[1])]),                      # extend only
        ([1], toks[:1], [(0, p[0][10:]), (2, p[2][:8])]),           # mixed
        ([0, 1], toks[1:3], [(2, p[2][8:])]),                       # mixed, chunk bin 16
        ([0, 1, 2], toks[3:6], []),                                 # decode only
        ("flush", [1]),
        ([0, 2], toks[6:8], []),
        ([2], toks[8:9], [(3, p[1][:3])]),                          # a new uid mid-decode
    ]
    kinds = set()
    for tick in schedule:
        if tick[0] == "flush":
            je.flush(tick[1])
            te.flush(tick[1])
        else:
            jd, jpl = je.step(*tick)
            td, tpl = te.step(*tick)
            assert td.shape == jd.shape and tpl.shape == jpl.shape
            np.testing.assert_allclose(td, jd, rtol=1e-4, atol=1e-4)
            np.testing.assert_allclose(tpl, jpl, rtol=1e-4, atol=1e-4)
            kinds.add("mixed" if tick[0] and tick[2] else "decode" if tick[0] else "extend")
        assert te.free_blocks == je.free_blocks
        for uid in (0, 1, 2, 3):
            assert te.query(uid) == je.query(uid)
    assert kinds == {"extend", "mixed", "decode"}
    assert te.program_shapes == je.program_shapes
    assert te.dispatch_count == je.dispatch_count == 6


def test_step_admission_rejection_matches_jax(models):
    """All-or-nothing admission: a tick the pool cannot fund raises with
    the same named numbers and changes nothing on either side."""
    je, te = _engines(models, num_kv_blocks=4)
    p = _prompts(1, (20, 12))
    errs = []
    for eng in (je, te):
        with pytest.raises(RuntimeError) as e:
            eng.step([], [], [(0, p[0]), (1, p[1])])
        errs.append(str(e.value))
        assert eng.free_blocks == 3 and not eng._seqs
    assert errs[0] == errs[1]
    assert "needs 5 KV blocks, 3 free" in errs[1]


@pytest.mark.parametrize("case", ["concurrent", "preemption"])
def test_serve_tokens_equal_the_jax_scheduler(models, case):
    if case == "concurrent":
        prompts, max_new, blocks = _prompts(0, (12, 5, 22, 9)), 8, 40
    else:   # 6 usable blocks of 8 slots cannot hold both requests' KV
        prompts, max_new, blocks = _prompts(1, (20, 18)), 12, 7
    je, te = _engines(models, num_kv_blocks=blocks)
    js, ts = JScheduler(je), ContinuousBatchingScheduler(te)
    want = js.serve(prompts, max_new_tokens=max_new)
    got = ts.serve(prompts, max_new_tokens=max_new)
    assert got == want
    assert all(len(t) == max_new for t in got.values())
    assert ts.ticks == js.ticks and ts.preemptions == js.preemptions
    if case == "preemption":
        assert ts.preemptions > 0, "the pool was sized to force preemption"
    assert te.dispatch_count == ts.ticks
    assert te.free_blocks == te.allocator.num_blocks - 1
    stats = ts.stats()
    assert stats["requests"] == len(prompts) and stats["ticks"] == ts.ticks
    assert stats["generated_tokens"] == len(prompts) * max_new


def test_serve_with_arrivals_and_streaming(models):
    _, te = _engines(models)
    streamed = []
    sched = ContinuousBatchingScheduler(te, on_token=lambda u, t: streamed.append((u, t)))
    prompts = _prompts(2, (6, 11, 4))
    out = sched.serve(prompts, max_new_tokens=5, arrivals=[0.0, 0.0, 0.01])
    for uid, toks in out.items():
        assert [t for u, t in streamed if u == uid] == toks
    with pytest.raises(ValueError, match="exceeds max_seq_len"):
        sched.submit(list(range(1, 60)), max_new_tokens=8)
    with pytest.raises(ValueError, match="usable"):
        ContinuousBatchingScheduler(_engines(models, num_kv_blocks=3)[1]).submit(
            list(range(1, 30)), max_new_tokens=4)


def test_engine_state_lives_on_the_requested_device(models):
    _, te = _engines(models)
    assert te.device == torch.device("cpu")
    assert te.cache.k.device.type == "cpu" and te.cache.k.dtype == torch.float32
    assert te.cache.k.shape == (2, 40, 2, 8, 8)
    assert all(v.device.type == "cpu" for v in te.params.values())
