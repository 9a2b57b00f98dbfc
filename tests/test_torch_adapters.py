"""The PyTorch port's multi-tenant LoRA serving against the JAX package.

The model is ``tests/test_adapters.py``'s tiny Llama (vocab 97, width 32,
2 layers, GQA 4/2), its weights drawn by JAX and moved over by name,
served in f32 on the CPU (every kernel wrapper takes its plain version),
with adapter factors made from numpy seeds and registered on both
engines:

- the LoRA delta's plain version (B9) within 1e-5 of ``lora_delta_oracle``
  and of ``lora_delta_pallas`` in interpret mode, null rows exactly zero,
  rows independent bit for bit;
- the adapter pool's contracts (``tests/test_adapters.py``'s) on the
  port's pool, and one scripted sequence on both pools with equal slot
  numbers, counters and planes (bit-equal in f32);
- ``step()`` and ``put()`` logits within 1e-4 and ``decode_loop`` tokens
  exact against the JAX engine under ``decode_kernel`` "xla" and "pallas"
  (JAX's fused kernels in interpret mode, their traces counted); the
  six-tenants-over-two-slots serve token-exact with equal adapter stats
  and no preemption; mixed-vs-solo tokens, zero new program shapes for a
  new adapter, ``submit`` / ``configure_adapter`` and the admission
  refusal as in JAX; an int8 base and a ``tiny_moe`` model with adapters;
- the launch counters, with the kernel gate opened onto the plain
  versions: B9 once per adapted projection, layer and lane, and no fused
  QKV launch on adapter decode rows.
"""

import importlib

import jax
import numpy as np
import pytest
import torch

from shuffle_exchange_tpu.inference import ContinuousBatchingScheduler as JScheduler
from shuffle_exchange_tpu.inference import InferenceConfig as JConfig
from shuffle_exchange_tpu.inference import InferenceEngineV2 as JEngine
from shuffle_exchange_tpu.inference.adapters import AdapterPool as JPool
from shuffle_exchange_tpu.inference.adapters import pool_bytes as jpool_bytes
from shuffle_exchange_tpu.models import Transformer as JTransformer
from shuffle_exchange_tpu.models.transformer import tiny as jtiny
from shuffle_exchange_tpu.models.transformer import tiny_moe as jtiny_moe
from shuffle_exchange_tpu.ops import fused_decode as jfd
from shuffle_exchange_tpu.ops.lora_gemm import lora_delta_oracle, lora_delta_pallas
from shuffle_exchange_tpu.testing import faults as jfaults
from shuffle_exchange_tpu_torch.config import ConfigError
from shuffle_exchange_tpu_torch.inference import (AdapterPoolDry, ContinuousBatchingScheduler,
                                                  InferenceConfig, InferenceEngineV2)
from shuffle_exchange_tpu_torch.inference.adapters import (NULL_SLOT, SUPPORTED_TARGETS,
                                                           AdapterPool, pool_bytes, target_dims)
from shuffle_exchange_tpu_torch.models import (Transformer, adapter_pool_to_numpy,
                                               params_from_numpy, tiny, tiny_moe)
from shuffle_exchange_tpu_torch.testing import faults
from shuffle_exchange_tpu_torch.testing.faults import InjectedFault

tlg = importlib.import_module("shuffle_exchange_tpu_torch.ops.lora_gemm")

RANK = 4
MODEL = dict(vocab=97, d=32, layers=2, heads=4, seq=128, activation="swiglu", norm="rmsnorm",
             position="rope", n_kv_heads=2, tie_embeddings=False)
SERVING = {"token_budget": 16, "max_running": 4, "chunk_min": 4}


@pytest.fixture(scope="module")
def models():
    jm = JTransformer(jtiny(**MODEL))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = Transformer(tiny(**MODEL), device="cpu")
    state = params_from_numpy(jax.tree.map(np.asarray, jp))
    tm.load_params(state)
    return jm, jp, tm, state


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.clear()
    jfaults.clear()
    yield
    faults.clear()
    jfaults.clear()


def _icfg(cls, slots=2, max_rank=RANK, decode_kernel="xla", **kw):
    return cls(dtype="float32", max_seq_len=64, kv_block_size=8, num_kv_blocks=40,
               decode_kernel=decode_kernel, serving=SERVING,
               adapters={"enabled": True, "slots": slots, "max_rank": max_rank}, **kw)


def _factors(mcfg, seed, rank=3, targets=("wq", "wk"), std=0.05):
    """Random (A, B) factor pairs per target; the rank below the pool's
    ceiling so the zero padding is exercised on every registration."""
    rng = np.random.default_rng(seed)
    out = {}
    for t in targets:
        din, dout = target_dims(mcfg, t)
        out[t] = ((rng.standard_normal((mcfg.n_layers, din, rank)) * std).astype(np.float32),
                  (rng.standard_normal((mcfg.n_layers, rank, dout)) * std).astype(np.float32))
    return out


def _register(engines, mcfg, n=3, std=0.05, targets=("wq", "wk")):
    for i in range(n):
        fac = _factors(mcfg, seed=10 + i, std=std, targets=targets)
        for e in engines:
            e.adapters.register(f"ad{i}", fac, alpha=8.0)


def _engines(models, decode_kernel="xla", slots=2, std=0.5, targets=SUPPORTED_TARGETS, **kw):
    """A JAX and a port engine with the same three adapters (0.5-std
    factors on all four targets unless asked otherwise: large enough that
    they change greedy tokens)."""
    jm, jp, tm, state = models
    je = JEngine(jm, jp, _icfg(JConfig, slots, decode_kernel=decode_kernel, **kw))
    te = InferenceEngineV2(tm, state, _icfg(InferenceConfig, slots, decode_kernel=decode_kernel,
                                            **kw), device="cpu")
    _register((je, te), tm.config, std=std, targets=targets)
    return je, te


def _prompts(seed, lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 90, size=int(n)).tolist() for n in lengths]


@pytest.fixture
def jax_fused(monkeypatch):
    """JAX's fused kernels through the Pallas interpreter, each wrapped to
    count its traces (the JAX engine drops to its XLA body when a fused
    kernel fails, so a count of 0 would mean the fused path did not run)."""
    monkeypatch.setenv("SXT_FUSED_INTERPRET", "1")
    traces = dict.fromkeys(("fused_qkv_rope_pallas", "fused_paged_decode_attention_pallas",
                            "fused_mlp_pallas"), 0)
    for name in traces:
        fn = getattr(jfd, name)

        def counted(*a, _fn=fn, _name=name, **kw):
            traces[_name] += 1
            return _fn(*a, **kw)

        monkeypatch.setattr(jfd, name, counted)
    return traces


def _fused_ran(decode_kernel, traces):
    """Under "pallas" adapter decode rows keep JAX's split-K attention and
    fused MLP and bypass its fused QKV kernel."""
    if decode_kernel == "pallas":
        assert traces["fused_paged_decode_attention_pallas"] > 0, traces
        assert traces["fused_mlp_pallas"] > 0, traces
        assert traces["fused_qkv_rope_pallas"] == 0, traces


# ---------------------------------------------------------------------------
# B9's plain version against the oracle and the Pallas kernel
# ---------------------------------------------------------------------------


def _gemm_operands(B=5, T=4, D=256, R=8, N=128, S=4, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    a = (rng.standard_normal((S, D, R)) * 0.1).astype(np.float32)
    b = (rng.standard_normal((S, R, N)) * 0.1).astype(np.float32)
    a[0], b[0] = 0.0, 0.0    # slot 0 is the null adapter
    slots = np.array([0, 1, 2, 1, 3], np.int32)[:B]
    return x, a, b, slots


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("R", [8, 16])
def test_plain_delta_matches_the_oracle_and_the_pallas_kernel(R):
    x, a, b, slots = _gemm_operands(R=R)
    got = tlg.lora_delta(*_t(x, a, b, slots)).numpy()
    np.testing.assert_allclose(got, np.asarray(lora_delta_oracle(x, a, b, slots)),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got, np.asarray(lora_delta_pallas(x, a, b, slots, interpret=True)),
                               atol=1e-5, rtol=1e-5)
    assert tlg.lora_delta.launches == 0       # a CPU tensor takes the plain version


def test_null_slot_adds_exact_zero_and_rows_are_independent():
    x, a, b, slots = _gemm_operands()
    zero = tlg.lora_delta(*_t(x, a, b, np.zeros(5, np.int32))).numpy()
    assert np.array_equal(zero, np.zeros((5, 4, 128), np.float32))
    mixed = tlg.lora_delta(*_t(x, a, b, slots)).numpy()
    assert np.array_equal(mixed[0], np.zeros((4, 128), np.float32))
    for i, s in enumerate(slots):
        solo = tlg.lora_delta(*_t(x[i:i + 1], a, b, np.array([s], np.int32))).numpy()
        np.testing.assert_array_equal(mixed[i], solo[0])


def test_kernel_refuses_what_it_does_not_take():
    """The card's wrapper has no shape gate (JAX's sends unaligned shapes to
    its oracle): any D, N and rank go to the kernel (a rank above 64 reaches
    the operand checks like any other), and operands of the wrong type
    raise before any launch."""
    x, a, b, slots = _t(*_gemm_operands(B=2, D=40, R=8, N=24))
    with pytest.raises(TypeError, match="bf16"):
        tlg._launch(x, torch.zeros(4, 40, 65), torch.zeros(4, 65, 24), slots[:2])
    with pytest.raises(TypeError, match="bf16"):
        tlg._launch(x, a, b, slots[:2])
    with pytest.raises(ValueError, match="chain"):
        tlg.lora_delta(x, a, b[:, :4], slots[:2])


# ---------------------------------------------------------------------------
# The adapter pool (tests/test_adapters.py's contracts, on the port's pool)
# ---------------------------------------------------------------------------


@pytest.fixture
def pool(models):
    return AdapterPool(models[2].config, slots=2, max_rank=RANK, targets=SUPPORTED_TARGETS,
                       device="cpu")


def test_pool_bytes_formula(models):
    tcfg = models[2].config
    one_slot = pool_bytes(tcfg, 0, RANK)
    assert one_slot > 0 and one_slot == jpool_bytes(models[0].config, 0, RANK)
    assert pool_bytes(tcfg, 3, RANK) == 4 * one_slot
    assert pool_bytes(tcfg, 3, 2 * RANK) == 2 * pool_bytes(tcfg, 3, RANK)
    wq = pool_bytes(tcfg, 0, RANK, targets=("wq",))
    din, dout = target_dims(tcfg, "wq")
    assert wq < one_slot and wq == tcfg.n_layers * RANK * (din + dout) * 4


class TestAdapterPool:
    def test_register_is_content_keyed(self, pool, models):
        fac = _factors(models[2].config, seed=1)
        v1 = pool.register("a", fac, alpha=8.0)
        assert pool.registered("a") and pool.version("a") == v1
        assert pool.register("a", fac, alpha=8.0) == v1
        assert pool.register("a", _factors(models[2].config, seed=2), alpha=8.0) == v1 + 1

    def test_acquire_release_lru_eviction(self, pool, models):
        for i, aid in enumerate(("a", "b", "c")):
            pool.register(aid, _factors(models[2].config, seed=i))
        sa, sb = pool.acquire("a"), pool.acquire("b")
        assert NULL_SLOT not in (sa, sb) and sa != sb
        assert pool.slot_of("a") == sa and pool.stats()["resident"] == 2
        with pytest.raises(AdapterPoolDry):
            pool.acquire("c")
        pool.release("a")
        assert pool.slot_of("a") == sa
        assert pool.acquire("c") == sa and pool.slot_of("a") is None
        assert pool.stats()["evictions"] == 1 and pool.stats()["resident"] == 2
        assert pool.acquire("b") == sb and pool.stats()["hits"] >= 1
        pool.release("b")
        pool.release("b")
        assert pool.can_acquire("a")
        with pytest.raises(RuntimeError, match="without a matching acquire"):
            pool.release("b")

    def test_acquire_unknown_raises(self, pool):
        with pytest.raises(KeyError):
            pool.acquire("never-registered")

    def test_pool_dry_is_atomic(self, pool, models):
        for i, aid in enumerate(("a", "b", "c")):
            pool.register(aid, _factors(models[2].config, seed=i))
        pool.acquire("a")
        pool.acquire("b")
        before, resident = pool.stats(), set(pool.resident_ids())
        with pytest.raises(AdapterPoolDry):
            pool.acquire("c")
        assert pool.stats() == before and set(pool.resident_ids()) == resident

    def test_can_acquire_all_counts_batch_holdings(self, pool, models):
        for i, aid in enumerate(("a", "b", "c")):
            pool.register(aid, _factors(models[2].config, seed=i))
        pool.acquire("a")
        assert pool.can_acquire_all(["a", "b"]) == (True, "")
        ok, why = pool.can_acquire_all(["a", "b", "c"])
        assert not ok and "c" in why and "adapter pool dry" in why
        assert pool.can_acquire_all(["a", "a", "b"])[0]

    def test_prefetch_stages_ahead(self, pool, models):
        for i, aid in enumerate(("a", "b")):
            pool.register(aid, _factors(models[2].config, seed=i))
        assert pool.prefetch("a") and not pool.prefetch("never-registered")
        pool.acquire("a")
        st = pool.stats()
        assert st["prefetches"] == 1 and st["prefetch_hits"] == 1
        assert not pool.prefetch("a")

    def test_adapter_fetch_fault_is_atomic(self, pool, models):
        for i, aid in enumerate(("a", "b", "c")):
            pool.register(aid, _factors(models[2].config, seed=i))
        pool.acquire("a")
        pool.acquire("b")
        pool.release("a")
        before, resident = pool.stats(), set(pool.resident_ids())
        planes = adapter_pool_to_numpy(pool)
        faults.arm("adapter_fetch")
        with pytest.raises(InjectedFault):
            pool.acquire("c")
        assert pool.stats() == before and set(pool.resident_ids()) == resident
        assert all(np.array_equal(v, adapter_pool_to_numpy(pool)[k]) for k, v in planes.items())
        faults.clear()
        assert pool.acquire("c") != NULL_SLOT


def test_scripted_pool_sequence_matches_the_jax_pool(models):
    """Register / acquire / release / prefetch / re-register on both pools:
    equal slot numbers, LRU order and counters at every step, and equal
    device planes (f32) at the end."""
    jcfg, tcfg = models[0].config, models[2].config
    jpool = JPool(jcfg, slots=3, max_rank=RANK, targets=("wq", "wv", "wo"), prefetch_depth=2)
    tpool = AdapterPool(tcfg, slots=3, max_rank=RANK, targets=("wq", "wv", "wo"),
                        prefetch_depth=2, device="cpu")
    facs = {f"t{i}": _factors(tcfg, 20 + i, rank=1 + i % RANK,
                              targets=("wq", "wv", "wo")[:1 + i % 3]) for i in range(5)}
    script = [("register", "t0"), ("register", "t1"), ("register", "t2"), ("register", "t3"),
              ("register", "t4"), ("acquire", "t0"), ("acquire", "t1"), ("prefetch", "t2"),
              ("acquire", "t2"), ("release", "t0"), ("prefetch", "t3"), ("prefetch", "t4"),
              ("acquire", "t3"), ("acquire", "t1"), ("release", "t1"), ("release", "t1"),
              ("reregister", "t3"), ("acquire", "t4"), ("release", "t2"), ("acquire", "t0"),
              ("reregister", "t0")]
    for op, aid in script:
        out = []
        for p in (jpool, tpool):
            if op == "register":
                out.append(p.register(aid, facs[aid], alpha=4.0))
            elif op == "reregister":
                out.append(p.register(aid, _factors(tcfg, 99, targets=("wq",)), alpha=2.0))
            else:
                out.append(getattr(p, op)(aid))
        assert out[0] == out[1], (op, aid, out)
        assert jpool.stats() == tpool.stats(), (op, aid)
        assert jpool.resident_ids() == tpool.resident_ids(), (op, aid)
    planes = adapter_pool_to_numpy(tpool)
    assert sorted(planes) == ["wo.a", "wo.b", "wq.a", "wq.b", "wv.a", "wv.b"]
    for t in tpool.targets:
        np.testing.assert_array_equal(planes[f"{t}.a"], np.asarray(jpool.a[t]))
        np.testing.assert_array_equal(planes[f"{t}.b"], np.asarray(jpool.b[t]))


# ---------------------------------------------------------------------------
# The engines against the JAX engines
# ---------------------------------------------------------------------------


def _step_schedule():
    p = _prompts(0, (12, 5, 22))
    toks = np.random.default_rng(9).integers(1, 90, size=16).tolist()
    return [
        ([], [], [(0, p[0][:10]), (1, p[1])]),                      # extend only
        ([1], toks[:1], [(0, p[0][10:]), (2, p[2][:8])]),           # mixed
        ([0, 1], toks[1:3], [(2, p[2][8:])]),                       # mixed
        ([0, 1, 2], toks[3:6], []),                                 # decode only
        ([2], toks[8:9], [(3, p[1][:3])]),                          # a new uid mid-decode
    ]


def _bind(engines, binding):
    for e in engines:
        for uid, aid in binding.items():
            e.configure_adapter(uid, aid)


def _slots(eng):
    return {u: (d.adapter_id, d.adapter_slot) for u, d in eng._seqs.items()}


@pytest.mark.parametrize("decode_kernel", ["xla", "pallas"])
def test_step_logits_match_jax(models, jax_fused, decode_kernel):
    """Mixed adapters and base-model rows on every lane: per-tick logits
    within 1e-4, the same slots and pool counters; the adapters change the
    logits (the delta is live)."""
    je, te = _engines(models, decode_kernel, slots=3)
    _bind((je, te), {0: "ad0", 2: "ad1", 3: "ad2"})
    first = None
    for tick in _step_schedule():
        jd, jpl = je.step(*tick)
        td, tpl = te.step(*tick)
        np.testing.assert_allclose(td, jd, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(tpl, jpl, rtol=1e-4, atol=1e-4)
        assert _slots(te) == _slots(je)
        assert te.adapters.stats() == je.adapters.stats()
        first = tpl if first is None else first
    assert te.dispatches_by_program.keys() == {"extend", "mixed", "decode"}
    _fused_ran(decode_kernel, jax_fused)
    # the same first tick with no adapter bound: uid 0's logits move, uid
    # 1's (the null slot both times) are bit-equal
    base = InferenceEngineV2(models[2], models[3], _icfg(InferenceConfig, 3,
                                                         decode_kernel=decode_kernel),
                             device="cpu")
    bl = base.step(*_step_schedule()[0])[1]
    assert np.abs(bl[0] - first[0]).max() > 1e-2 and np.array_equal(bl[1], first[1])


@pytest.mark.parametrize("decode_kernel", ["xla", "pallas"])
def test_put_and_decode_loop_match_jax(models, jax_fused, decode_kernel):
    je, te = _engines(models, decode_kernel, slots=3)
    _bind((je, te), {0: "ad0", 1: "ad1", 3: "ad2"})
    prompts = _prompts(5, (14, 6, 19, 9))
    lt, lj = te.put([0, 1, 2, 3], prompts), je.put([0, 1, 2, 3], prompts)
    np.testing.assert_allclose(lt, lj, rtol=1e-4, atol=1e-4)
    ext = [[7, 8, 9, 10, 11, 12, 13, 14, 15, 16], [5]]
    np.testing.assert_allclose(te.put([1, 2], ext), je.put([1, 2], ext), rtol=1e-4, atol=1e-4)
    first = [int(np.argmax(r)) for r in lt]
    np.testing.assert_array_equal(te.decode_loop([0, 1, 2, 3], first, 6),
                                  je.decode_loop([0, 1, 2, 3], first, 6))
    assert _slots(te) == _slots(je)
    assert te.program_shapes == je.program_shapes
    assert te.adapters.stats() == je.adapters.stats()
    _fused_ran(decode_kernel, jax_fused)


@pytest.mark.parametrize("decode_kernel", ["xla", "pallas"])
def test_six_tenants_over_two_slots_serve_as_jax(models, jax_fused, decode_kernel):
    """tests/test_adapters.py's scenario: more tenants than slots serve to
    completion by LRU paging, token-exact against the JAX scheduler, with
    equal adapter stats, parks that all unpark, no preemption and every
    slot unpinned at the end."""
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
    assert set(st["tokens_by_adapter"]) == {"ad0", "ad1", "ad2"} and st["pinned"] == 0
    assert te.dispatch_count == ts.ticks
    _fused_ran(decode_kernel, jax_fused)


def test_mixed_batch_tokens_equal_solo_runs_and_adapters_are_live(models):
    _, te = _engines(models, slots=3)
    prompts = [[2 + i, 5, 9, 13 + i] for i in range(4)]
    aids = ["ad0", "ad1", "ad2", None]
    mixed = ContinuousBatchingScheduler(te).serve(prompts, max_new_tokens=6, adapter_ids=aids)
    for i, uid in enumerate(sorted(mixed)):
        solo = ContinuousBatchingScheduler(te).serve([prompts[i]], max_new_tokens=6,
                                                     adapter_ids=[aids[i]])
        assert mixed[uid] == list(solo.values())[0], (i, aids[i])
    base = ContinuousBatchingScheduler(te).serve([prompts[0]], max_new_tokens=6)
    assert list(base.values())[0] != mixed[sorted(mixed)[0]], "the adapter changed nothing"


def test_new_adapter_adds_no_program_shape(models):
    _, te = _engines(models)
    sched = ContinuousBatchingScheduler(te)
    prompts = [[3, 7, 11], [4, 8, 12]]
    sched.serve(prompts, max_new_tokens=4, adapter_ids=["ad0", None])
    programs = set(te.program_shapes)
    assert programs
    te.adapters.register("ad9", _factors(models[2].config, seed=99), alpha=8.0)
    out = sched.serve(prompts, max_new_tokens=4, adapter_ids=["ad9", "ad1"])
    assert all(len(v) == 4 for v in out.values())
    assert set(te.program_shapes) == programs


def test_submit_validation_and_configure_adapter_rebinding_as_jax(models):
    je, te = _engines(models, slots=3)
    jm, jp, tm, state = models
    for sched in (ContinuousBatchingScheduler(te), JScheduler(je)):
        with pytest.raises(ValueError, match="not registered"):
            sched.submit([1, 2, 3], adapter_id="never-published")
    plain = InferenceEngineV2(tm, state, InferenceConfig(dtype="float32", max_seq_len=64,
                                                         kv_block_size=8, num_kv_blocks=40),
                              device="cpu")
    assert plain.adapters is None and ContinuousBatchingScheduler(plain).stats()["adapters"] is None
    with pytest.raises(ValueError, match="disabled"):
        ContinuousBatchingScheduler(plain).submit([1, 2, 3], adapter_id="ad0")
    with pytest.raises(RuntimeError, match="disabled"):
        plain.configure_adapter(0, "ad0")
    for e in (je, te):
        with pytest.raises(KeyError, match="not registered"):
            e.configure_adapter(0, "never-published")
    # a live uid rebinds in place: the new adapter pinned before the old released
    prompt = [[4, 5, 6, 7]]
    _bind((je, te), {0: "ad0"})
    np.testing.assert_allclose(te.put([0], prompt), je.put([0], prompt), rtol=1e-4, atol=1e-4)
    for aid in ("ad1", None, "ad2", "ad2"):
        _bind((je, te), {0: aid})
        assert _slots(te) == _slots(je) and te.adapters.stats() == je.adapters.stats()
        np.testing.assert_allclose(te.put([0], [[9]]), je.put([0], [[9]]), rtol=1e-4, atol=1e-4)
    te.flush([0])
    je.flush([0])
    assert te.adapters.stats() == je.adapters.stats() and te.adapters.stats()["pinned"] == 0


def test_admission_refusal_names_the_adapter_pool(models):
    """A batch whose pending adapters cannot all be pinned is refused before
    any change, naming the adapter pool and not KV, on both engines."""
    je, te = _engines(models, slots=2)
    uids, toks = (9101, 9102, 9103), [[1, 2, 3]] * 3
    _bind((je, te), dict(zip(uids, ("ad0", "ad1", "ad2"))))
    for e in (je, te):
        before, free = e.adapters.stats(), e.allocator.free_blocks
        ok, _, why = e._admission_detail(list(uids), [3, 3, 3])
        assert not ok and "adapter pool" in why and "KV is fine" in why
        with pytest.raises(RuntimeError, match="adapter pool"):
            e.put(list(uids), toks)
        assert e.adapters.stats() == before and e.allocator.free_blocks == free
        assert all(u not in e._seqs for u in uids)


def test_a_failed_fetch_in_put_leaves_nothing_pinned(models):
    """put() pins a call's new adapters before any other change and
    releases them when a later fetch fails."""
    _, te = _engines(models, slots=3)
    _bind((te,), {0: "ad0", 1: "ad1"})
    faults.arm("adapter_fetch", fire_nth=2)
    before, free = te.adapters.stats(), te.allocator.free_blocks
    with pytest.raises(InjectedFault):
        te.put([0, 1], [[1, 2, 3], [4, 5]])
    st = te.adapters.stats()
    assert st["pinned"] == 0 and st["misses"] == before["misses"] + 1
    assert te.allocator.free_blocks == free and not te._seqs
    assert te.put([0, 1], [[1, 2, 3], [4, 5]]).shape == (2, 97)
    assert _slots(te) == {0: ("ad0", 3), 1: ("ad1", 2)}


# ---------------------------------------------------------------------------
# Compositions: an int8 base, an MoE model
# ---------------------------------------------------------------------------


def test_int8_base_with_adapters_matches_jax(models, jax_fused):
    je, te = _engines(models, "pallas", slots=3, quantize_weights=True, quant_bits=8)
    _bind((je, te), {0: "ad0", 2: "ad1", 3: "ad2"})
    for tick in _step_schedule():
        jd, jpl = je.step(*tick)
        td, tpl = te.step(*tick)
        np.testing.assert_allclose(td, jd, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(tpl, jpl, rtol=1e-4, atol=1e-4)
    assert te.adapters.stats() == je.adapters.stats()


def test_moe_model_with_adapters_serves_as_jax():
    cfg = dict(vocab=97, d=32, layers=2, heads=4, seq=128, experts=4, n_kv_heads=2,
               tie_embeddings=False)
    jm = JTransformer(jtiny_moe(**cfg))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = Transformer(tiny_moe(**cfg), device="cpu")
    state = params_from_numpy(jax.tree.map(np.asarray, jp))
    tm.load_params(state)
    serving = dict(SERVING, moe={"moe_impl": "ragged"})
    kw = dict(dtype="float32", max_seq_len=64, kv_block_size=8, num_kv_blocks=40,
              serving=serving, adapters={"enabled": True, "slots": 2, "max_rank": RANK})
    je, te = JEngine(jm, jp, JConfig(**kw)), InferenceEngineV2(tm, state, InferenceConfig(**kw),
                                                               device="cpu")
    _register((je, te), tm.config, std=0.5, targets=SUPPORTED_TARGETS)
    prompts = _prompts(3, (5, 11, 17, 9))
    aids = ["ad0", None, "ad1", "ad2"]
    js, ts = JScheduler(je), ContinuousBatchingScheduler(te)
    assert ts.serve(prompts, max_new_tokens=5, adapter_ids=aids) == \
        js.serve(prompts, max_new_tokens=5, adapter_ids=aids)
    assert ts.stats()["adapters"] == js.stats()["adapters"]
    assert ts.stats()["moe"] == js.stats()["moe"] and ts.preemptions == 0


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
    fd = importlib.import_module("shuffle_exchange_tpu_torch.ops.fused_decode")
    for m in (fd, pa, rn, fa):
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


@pytest.mark.parametrize("decode_kernel,targets", [("pallas", ("wq", "wv")),
                                                   ("xla", SUPPORTED_TARGETS)])
def test_launch_counters_follow_the_programs(models, counted_port, decode_kernel, targets):
    """Per layer and lane of every program, B9 once for each adapted
    projection; adapter decode rows on the fused path take the split-K
    attention and the fused MLP and never the fused QKV kernel."""
    tm, state = models[2:]
    icfg = InferenceConfig(dtype="float32", max_seq_len=64, kv_block_size=8, num_kv_blocks=40,
                           decode_kernel=decode_kernel, serving=SERVING,
                           adapters={"enabled": True, "slots": 3, "max_rank": RANK,
                                     "targets": targets})
    te = InferenceEngineV2(tm, state, icfg, device="cpu")
    _register((te,), tm.config, targets=targets)
    _bind((te,), {0: "ad0", 2: "ad1", 3: "ad2", 9: "ad0"})
    for tick in _step_schedule():
        te.step(*tick)
    logits = te.put([9], [_prompts(1, (13,))[0]])
    te.decode_loop([9], [int(logits[0].argmax())], 3)
    by = te.dispatches_by_program
    L = 2
    dec = by["decode"] + by["mixed"] + 3
    ext = by["extend"] + by["mixed"]
    pre = by["prefill"]
    fused = decode_kernel == "pallas"
    want = {k: 0 for k in counted_port.KERNEL_WRAPPERS}
    want.update(rmsnorm=(2 * L + 1) * (ext + pre) + ((L + 1) if fused else (2 * L + 1)) * dec,
                paged_extend_attention=L * ext, flash_attention=L * pre,
                lora_delta=len(targets) * L * (dec + ext + pre))
    if fused:
        want.update(fused_paged_decode_attention=L * dec, fused_mlp=L * dec)
    else:
        want["paged_decode_attention"] = L * dec
    assert counted_port.launch_counts() == want


def test_cuda_engine_refuses_a_rank_above_the_kernel_limit(models, monkeypatch):
    """The LoRA kernels take every rank (past 512 the expand stages mid's
    ranks beside B's), so no pool rank is refused when the engine is built
    for the card: a rank-1024 pool gets past the config checks and fails
    here only where the weights move to a card this build of PyTorch lacks;
    the CPU engine takes it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    icfg = _icfg(InferenceConfig, max_rank=1024)
    with pytest.raises(Exception) as err:
        InferenceEngineV2(models[2], models[3], icfg, device="cuda")
    assert not isinstance(err.value, ConfigError) and "CUDA" in str(err.value)
    eng = InferenceEngineV2(models[2], models[3], icfg, device="cpu")
    assert eng.adapters.max_rank == 1024


def test_adapters_config_as_jax():
    """The section's defaults and validation are JAX's; the v1 engine
    refuses it (the JAX v1 engine never reads it)."""
    for d in ({}, {"enabled": True, "slots": 3, "targets": ["wq", "wo"]}):
        t, j = InferenceConfig.from_dict({"adapters": d}).adapters, JConfig.from_dict(
            {"adapters": d}).adapters
        assert (t.enabled, t.slots, t.max_rank, t.targets, t.prefetch_depth) == \
            (j.enabled, j.slots, j.max_rank, j.targets, j.prefetch_depth)
    for bad in ({"slots": 0}, {"targets": ("w_up",)}, {"prefetch_depth": -1}, {"bogus": 1},
                {"enabled": "yes"}):
        with pytest.raises(ConfigError, match="adapters"):
            InferenceConfig.from_dict({"adapters": bad})
