"""Multi-tenant LoRA serving of the layernorm / gelu / bias families in the
PyTorch port against the JAX package, on the CPU, in f32.

The BLOOM- and GPT-2-shaped tinies of ``tests/serve_alibi_gpt2_cases.py``
(norm weights and biases drawn from numpy) serve under an adapter pool on
all four targets (wq, wk, wv, wo), factors of 0.5 std so that the
adapters move greedy tokens (smaller ones leave the tokens of these
widths unchanged, and a dropped delta would pass):

- ``step()`` schedules with adapter and base rows mixed on every lane:
  logits within 1e-4, equal slots, pool counters and planes, on "xla"
  and "pallas" (the q/k/v and ``b_o`` biases join each adapted
  projection, so a dropped bias or delta shows);
- ``put()`` + ``decode_loop``: logits within 1e-4, tokens exact;
- six tenants over two slots through the scheduler: tokens exact, equal
  adapter stats, parks that all unpark, no preemption;
- an int8 base under the adapters (B8 and B9 together);
- the launch counters with the kernel gate opened onto the plain versions:
  B9 once per adapted projection, layer and lane, and no fused QKV launch
  on adapter rows (JAX's B4 is traced 0 times too; BLOOM's adapter decode
  rows take B5 with the slopes and B6 in its layernorm + biases + gelu_new
  form).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shuffle_exchange_tpu.inference import ContinuousBatchingScheduler as JScheduler
from shuffle_exchange_tpu.inference import InferenceConfig as JConfig
from shuffle_exchange_tpu.inference import InferenceEngineV2 as JEngine
from shuffle_exchange_tpu.models import Transformer as JTransformer
from shuffle_exchange_tpu.models import tiny as jtiny
from shuffle_exchange_tpu_torch.inference import (ContinuousBatchingScheduler, InferenceConfig,
                                                  InferenceEngineV2)
from shuffle_exchange_tpu_torch.inference.adapters import SUPPORTED_TARGETS
from shuffle_exchange_tpu_torch.models import (Transformer, adapter_pool_to_numpy,
                                               params_from_numpy, tiny)
from test_torch_adapters import _bind, _register, _slots, _step_schedule
from test_torch_train_alibi_gpt2 import SHAPES, _tree

jfd = importlib.import_module("shuffle_exchange_tpu.ops.fused_decode")
tlg = importlib.import_module("shuffle_exchange_tpu_torch.ops.lora_gemm")

TOL = 1e-4
RANK = 4
SERVING = {"token_budget": 16, "max_running": 4, "chunk_min": 4}
JAX_KERNELS = ("fused_qkv_rope_pallas", "fused_paged_decode_attention_pallas", "fused_mlp_pallas")


@pytest.fixture(scope="module", params=["bloom", "gpt2"])
def models(request):
    kind = request.param
    tree = _tree(kind, seed=1)
    jm = JTransformer(jtiny(**SHAPES[kind]))
    jp = jax.tree.map(jnp.asarray, tree)
    tm = Transformer(tiny(**SHAPES[kind]), device="cpu")
    state = params_from_numpy(tree)
    tm.load_params(state)
    return kind, jm, jp, tm, state


@pytest.fixture
def jax_fused(monkeypatch):
    """JAX's fused kernels through the Pallas interpreter, each wrapped to
    count its traces."""
    monkeypatch.setenv("SXT_FUSED_INTERPRET", "1")
    traces = dict.fromkeys(JAX_KERNELS, 0)
    for name in traces:
        fn = getattr(jfd, name)

        def counted(*a, _fn=fn, _name=name, **kw):
            traces[_name] += 1
            return _fn(*a, **kw)

        monkeypatch.setattr(jfd, name, counted)
    return traces


def _fused_ran(kind, decode_kernel, traces):
    """Under "pallas" adapter decode rows keep JAX's split-K attention (and
    BLOOM's fused MLP; GPT-2's exact gelu does not fuse) and bypass its
    fused QKV kernel."""
    if decode_kernel == "pallas":
        assert traces["fused_paged_decode_attention_pallas"] > 0, traces
        assert (traces["fused_mlp_pallas"] > 0) == (kind == "bloom"), traces
    assert traces["fused_qkv_rope_pallas"] == 0, traces


def _icfg(cls, slots, decode_kernel, **kw):
    return cls(dtype="float32", max_seq_len=64, kv_block_size=8, num_kv_blocks=40,
               decode_kernel=decode_kernel, serving=SERVING,
               adapters={"enabled": True, "slots": slots, "max_rank": RANK}, **kw)


def _engines(models, decode_kernel, slots=3, **kw):
    _, jm, jp, tm, state = models
    je = JEngine(jm, jp, _icfg(JConfig, slots, decode_kernel, **kw))
    te = InferenceEngineV2(tm, state, _icfg(InferenceConfig, slots, decode_kernel, **kw),
                           device="cpu")
    _register((je, te), tm.config, std=0.5, targets=SUPPORTED_TARGETS)
    return je, te


def _prompts(seed, lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 90, size=int(n)).tolist() for n in lengths]


@pytest.mark.parametrize("decode_kernel", ["xla", "pallas"])
def test_step_logits_match_jax(models, jax_fused, decode_kernel):
    """Per-tick logits within 1e-4, equal slots, pool counters and planes;
    the adapters move the logits of their rows and leave the null slot's
    bit-equal."""
    kind = models[0]
    je, te = _engines(models, decode_kernel)
    _bind((je, te), {0: "ad0", 2: "ad1", 3: "ad2"})
    first = None
    for tick in _step_schedule():
        jd, jpl = je.step(*tick)
        td, tpl = te.step(*tick)
        np.testing.assert_allclose(td, jd, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(tpl, jpl, rtol=TOL, atol=TOL)
        assert _slots(te) == _slots(je)
        assert te.adapters.stats() == je.adapters.stats()
        first = tpl if first is None else first
    planes = adapter_pool_to_numpy(te.adapters)
    for t in te.adapters.targets:
        np.testing.assert_array_equal(planes[f"{t}.a"], np.asarray(je.adapters.a[t]))
        np.testing.assert_array_equal(planes[f"{t}.b"], np.asarray(je.adapters.b[t]))
    _fused_ran(kind, decode_kernel, jax_fused)
    base = InferenceEngineV2(models[3], models[4], _icfg(InferenceConfig, 3, decode_kernel),
                             device="cpu")
    bl = base.step(*_step_schedule()[0])[1]
    assert np.abs(bl[0] - first[0]).max() > 1e-2 and np.array_equal(bl[1], first[1])


@pytest.mark.parametrize("decode_kernel", ["xla", "pallas"])
def test_put_and_decode_loop_match_jax(models, jax_fused, decode_kernel):
    je, te = _engines(models, decode_kernel)
    _bind((je, te), {0: "ad0", 1: "ad1", 3: "ad2"})
    prompts = _prompts(5, (14, 6, 19, 9))
    lt, lj = te.put([0, 1, 2, 3], prompts), je.put([0, 1, 2, 3], prompts)
    np.testing.assert_allclose(lt, lj, rtol=TOL, atol=TOL)
    ext = [[7, 8, 9, 10, 11, 12, 13, 14, 15, 16], [5]]
    np.testing.assert_allclose(te.put([1, 2], ext), je.put([1, 2], ext), rtol=TOL, atol=TOL)
    first = [int(np.argmax(r)) for r in lt]
    got = te.decode_loop([0, 1, 2, 3], first, 6)
    np.testing.assert_array_equal(got, je.decode_loop([0, 1, 2, 3], first, 6))
    assert _slots(te) == _slots(je) and te.adapters.stats() == je.adapters.stats()
    _fused_ran(models[0], decode_kernel, jax_fused)


@pytest.mark.parametrize("decode_kernel", ["xla", "pallas"])
def test_six_tenants_over_two_slots_serve_as_jax(models, jax_fused, decode_kernel):
    """More tenants than slots serve to completion by LRU paging,
    token-exact against the JAX scheduler; the adapters change the tokens
    of the same prompts served without them."""
    je, te = _engines(models, decode_kernel, slots=2)
    prompts = [[2 + i, 5, 9, 13 + i] for i in range(6)]
    aids = ["ad0", "ad1", "ad2", None, "ad0", "ad2"]
    js, ts = JScheduler(je), ContinuousBatchingScheduler(te)
    want = js.serve(prompts, max_new_tokens=6, adapter_ids=aids)
    got = ts.serve(prompts, max_new_tokens=6, adapter_ids=aids)
    assert got == want
    st = ts.stats()["adapters"]
    assert st == js.stats()["adapters"]
    assert st["evictions"] >= 1 and st["parks"] >= 1 and st["unparks"] == st["parks"]
    assert ts.preemptions == 0 == js.preemptions and ts.ticks == js.ticks
    bare = ContinuousBatchingScheduler(te).serve(prompts, max_new_tokens=6)
    moved = [u for u in got if aids[u] is not None and got[u] != bare[u]]
    assert moved, "the adapters moved no token: the comparison would pass without them"
    assert all(got[u] == bare[u] for u in got if aids[u] is None)
    _fused_ran(models[0], decode_kernel, jax_fused)


@pytest.mark.parametrize("decode_kernel", ["xla", "pallas"])
def test_int8_base_with_adapters_matches_jax(models, jax_fused, decode_kernel):
    je, te = _engines(models, decode_kernel, quantize_weights=True, quant_bits=8,
                      quant_group_size=32)
    _bind((je, te), {0: "ad0", 2: "ad1", 3: "ad2"})
    for tick in _step_schedule():
        jd, jpl = je.step(*tick)
        td, tpl = te.step(*tick)
        np.testing.assert_allclose(td, jd, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(tpl, jpl, rtol=TOL, atol=TOL)
    assert te.adapters.stats() == je.adapters.stats()
    prompts = _prompts(6, (7, 12))
    lt = te.put([5, 6], prompts)
    np.testing.assert_allclose(lt, je.put([5, 6], prompts), rtol=TOL, atol=TOL)
    first = [int(np.argmax(r)) for r in lt]
    np.testing.assert_array_equal(te.decode_loop([5, 6], first, 4),
                                  je.decode_loop([5, 6], first, 4))
    if decode_kernel == "pallas":   # quantized q/k/v and fc biases: the attention alone fuses
        assert jax_fused["fused_paged_decode_attention_pallas"] > 0, jax_fused
        assert jax_fused["fused_qkv_rope_pallas"] == jax_fused["fused_mlp_pallas"] == 0


# ---------------------------------------------------------------------------
# Launch accounting, with the kernel gate opened onto the plain versions
# ---------------------------------------------------------------------------


@pytest.fixture
def counted_port(monkeypatch):
    """Every port wrapper takes its "kernel" branch with the plain version
    standing in for the launch, so the launch counters move as on the card."""
    from shuffle_exchange_tpu_torch import ops

    pa = importlib.import_module("shuffle_exchange_tpu_torch.ops.paged_attention")
    fa = importlib.import_module("shuffle_exchange_tpu_torch.ops.flash_attention")
    aa = importlib.import_module("shuffle_exchange_tpu_torch.ops.alibi_attention")
    fd = importlib.import_module("shuffle_exchange_tpu_torch.ops.fused_decode")
    for m in (fd, pa, fa, aa):
        monkeypatch.setattr(m, "use_kernel", lambda t: True)
    monkeypatch.setattr(tlg, "resolve_grouped_gemm", lambda kind, t: "kernel")
    monkeypatch.setattr(tlg, "_launch", tlg.lora_delta_reference)
    monkeypatch.setattr(fd, "_launch_qkv", lambda y, wq, wk, wv, c, s, pk, pv, bt, pos, H, KV, b:
                        fd.fused_qkv_rope_reference(y, wq, wk, wv, c, s, pk, pv, bt, pos,
                                                    n_heads=H, kv_heads=KV, bq=b[0], bk=b[1],
                                                    bv=b[2]))
    monkeypatch.setattr(fd, "_launch_attention", lambda q, ck, cv, bt, kl, n, sl=None:
                        fd.fused_paged_decode_reference(q, ck, cv, bt, kl, 2 if n is None else n,
                                                         sl))
    monkeypatch.setattr(fd, "_launch_mlp", lambda *a, **k: fd.fused_mlp_reference(*a, **k))
    monkeypatch.setattr(pa, "_launch", lambda kind, q, ck, cv, bt, lens, sl=None: (
        pa.paged_decode_reference(q, ck, cv, bt, lens, alibi_slopes=sl) if kind == "decode" else
        pa.paged_extend_reference(q, ck, cv, bt, lens, torch.full_like(lens, q.shape[1]),
                                  alibi_slopes=sl)))
    for fn in ops.KERNEL_WRAPPERS.values():
        monkeypatch.setattr(fn, "launches", 0)
    return ops


@pytest.mark.parametrize("decode_kernel", ["pallas", "xla"])
def test_launch_counters_follow_the_programs(models, counted_port, decode_kernel):
    """Per layer and lane of every program, B9 once for each of the four
    adapted projections; adapter decode rows on the fused path take the
    split-K attention and (BLOOM) the fused MLP, never the fused QKV
    kernel; layernorm is plain PyTorch (no RMSNorm launch)."""
    kind, _, _, tm, state = models
    te = InferenceEngineV2(tm, state, _icfg(InferenceConfig, 3, decode_kernel), device="cpu")
    _register((te,), tm.config, std=0.5, targets=SUPPORTED_TARGETS)
    _bind((te,), {0: "ad0", 2: "ad1", 3: "ad2"})
    for tick in _step_schedule():
        te.step(*tick)
    by = te.dispatches_by_program
    L = 2
    dec, ext = by["decode"] + by["mixed"], by["extend"] + by["mixed"]
    fused = decode_kernel == "pallas"
    want = {k: 0 for k in counted_port.KERNEL_WRAPPERS}
    want.update(paged_extend_attention=L * ext, lora_delta=4 * L * (dec + ext))
    if fused:
        want.update(fused_paged_decode_attention=L * dec,
                    fused_mlp=L * dec if kind == "bloom" else 0)
    else:
        want["paged_decode_attention"] = L * dec
    assert counted_port.launch_counts() == want
