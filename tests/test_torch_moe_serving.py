"""The PyTorch port's MoE serving against the JAX engines.

The model is ``tests/test_moe_serving.py``'s ``tiny_moe`` (vocab 97, width
32, 2 layers, 4 experts, top-2, GQA 4/2), its weights drawn by JAX and
moved over by name, served in f32 on the CPU (every kernel wrapper takes
its plain version) with the JAX test's serving config, for
``serving.moe.moe_impl`` "ragged" (dropless) and "auto" (the capacity
route, as JAX resolves it under its scanned stack), with dense, int8 and
fp8 experts (and int4, which keeps the rounding emulation):

- ``step()`` and ``put()`` logits within 1e-4 (the port's decode rows on
  both of its decode paths); ``decode_loop``, ``serve()`` and the v1
  ``generate`` (the capacity route) tokens exact;
- the routing counters (``moe_dispatched``, ``moe_dropped``,
  ``moe_expert_load_max``), ``moe_pressure()`` and the scheduler's ``moe``
  stats equal JAX's after the same serve, and the expert storage equals
  JAX's bit for bit;
- expert-capacity admission (park, never preempt; "drop" admits; the
  engine's refusal names the resource) as ``TestCapacityAdmission`` holds
  it for JAX;
- the launch counters, with the kernel gate opened onto the plain
  versions, count three grouped-GEMM launches per layer and lane of every
  program.
"""

import importlib

import jax
import numpy as np
import pytest
import torch

from shuffle_exchange_tpu.inference import ContinuousBatchingScheduler as JScheduler
from shuffle_exchange_tpu.inference import InferenceConfig as JConfig
from shuffle_exchange_tpu.inference import InferenceEngine as JEngineV1
from shuffle_exchange_tpu.inference import InferenceEngineV2 as JEngine
from shuffle_exchange_tpu.models import Transformer as JTransformer
from shuffle_exchange_tpu.models.transformer import tiny_moe as jtiny_moe
from shuffle_exchange_tpu_torch.inference import (ContinuousBatchingScheduler, InferenceConfig,
                                                  InferenceEngineV2, init_inference)
from shuffle_exchange_tpu_torch.models import Transformer, params_from_numpy, tiny_moe

tqm = importlib.import_module("shuffle_exchange_tpu_torch.ops.quant_matmul")
tgg = importlib.import_module("shuffle_exchange_tpu_torch.ops.grouped_gemm")

MODEL = dict(vocab=97, d=32, layers=2, heads=4, seq=128, experts=4, n_kv_heads=2,
             tie_embeddings=False)
QUANT = {"dense": {}, "int8": dict(quantize_weights=True, quant_bits=8),
         "fp8": dict(quantize_weights=True, quant_bits="fp8"),
         "int4": dict(quantize_weights=True, quant_bits=4)}


@pytest.fixture(scope="module")
def models():
    jm = JTransformer(jtiny_moe(**MODEL))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = Transformer(tiny_moe(**MODEL), device="cpu")
    state = params_from_numpy(jax.tree.map(np.asarray, jp))
    tm.load_params(state)
    return jm, jp, tm, state


def _cfg(cls, impl, quant="dense", num_kv_blocks=40, moe=None, **kw):
    serving = {"token_budget": 16, "max_running": 4, "chunk_min": 4,
               "moe": {"moe_impl": impl, **(moe or {})}}
    return cls(dtype="float32", max_seq_len=64, kv_block_size=8, num_kv_blocks=num_kv_blocks,
               serving=serving, **QUANT[quant], **kw)


def _engines(models, impl, quant="dense", port_decode="auto", **kw):
    jm, jp, tm, state = models
    return (JEngine(jm, jp, _cfg(JConfig, impl, quant, **kw)),
            InferenceEngineV2(tm, state, _cfg(InferenceConfig, impl, quant,
                                              decode_kernel=port_decode, **kw), device="cpu"))


def _prompts(seed, lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 90, size=int(n)).tolist() for n in lengths]


def _counters(eng):
    return (eng.moe_dispatched, eng.moe_dropped, eng.moe_expert_load_max, eng.moe_pressure())


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


@pytest.mark.parametrize("impl,quant,port_decode", [
    ("ragged", "dense", "xla"), ("ragged", "int8", "pallas"), ("auto", "dense", "pallas"),
    ("auto", "fp8", "xla")])
def test_step_logits_and_counters_match_jax(models, impl, quant, port_decode):
    """Per-tick logits within 1e-4 (the port's decode rows through its
    fused or its paged path, JAX's through its XLA body: the same f32
    function) and the routing counters after every tick. The "drop"
    policy lets the new uid of the last tick in under any expert
    pressure."""
    je, te = _engines(models, impl, quant, port_decode, moe={"overload_policy": "drop"})
    assert te._decode_kernel == port_decode
    for tick in _step_schedule():
        jd, jpl = je.step(*tick)
        td, tpl = te.step(*tick)
        np.testing.assert_allclose(td, jd, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(tpl, jpl, rtol=1e-4, atol=1e-4)
        assert _counters(te) == _counters(je)
    assert te.dispatches_by_program.keys() == {"extend", "mixed", "decode"}
    if impl == "auto":
        assert te.moe_dropped > 0, "the capacity route was to drop assignments"


@pytest.mark.parametrize("impl,quant", [("ragged", "dense"), ("ragged", "fp8"),
                                        ("auto", "int8")])
def test_put_and_decode_loop_match_jax(models, impl, quant):
    je, te = _engines(models, impl, quant)
    prompts = _prompts(5, (14, 6, 19))
    lt, lj = te.put([0, 1, 2], prompts), je.put([0, 1, 2], prompts)
    np.testing.assert_allclose(lt, lj, rtol=1e-4, atol=1e-4)
    ext = [[7, 8, 9, 10, 11, 12, 13, 14, 15, 16]]
    np.testing.assert_allclose(te.put([1], ext), je.put([1], ext), rtol=1e-4, atol=1e-4)
    first = [int(np.argmax(r)) for r in lt]
    np.testing.assert_array_equal(te.decode_loop([0, 1, 2], first, 6),
                                  je.decode_loop([0, 1, 2], first, 6))
    assert te.program_shapes == je.program_shapes
    assert _counters(te) == _counters(je)


@pytest.mark.parametrize("impl,quant", [("ragged", "dense"), ("ragged", "int8"),
                                        ("ragged", "int4"), ("auto", "dense"),
                                        ("auto", "fp8")])
def test_serve_tokens_and_moe_stats_equal_the_jax_scheduler(models, impl, quant):
    je, te = _engines(models, impl, quant)
    js, ts = JScheduler(je), ContinuousBatchingScheduler(te)
    prompts = _prompts(3, (5, 11, 17, 9))
    want = js.serve(prompts, max_new_tokens=5)
    got = ts.serve(prompts, max_new_tokens=5)
    assert got == want
    assert (ts.ticks, ts.preemptions) == (js.ticks, js.preemptions)
    assert ts.stats()["moe"] == js.stats()["moe"]
    assert te.dispatch_count == ts.ticks
    if impl == "ragged":
        assert ts.stats()["moe"]["dropped"] == 0


@pytest.mark.parametrize("quant", ["dense", "int8", "fp8"])
def test_v1_generate_matches_jax(models, quant):
    """The v1 engine takes the model config's impl ("auto": the capacity
    route at the prefill's and each decode step's row counts)."""
    jm, jp, tm, state = models
    cfg = dict(dtype="float32", max_seq_len=64, **QUANT[quant])
    je, te = JEngineV1(jm, jp, JConfig(**cfg)), init_inference(tm, state, cfg, device="cpu")
    ids = np.random.default_rng(11).integers(1, 90, size=(3, 13)).astype(np.int32)
    lens = np.asarray([13, 6, 9], np.int32)
    np.testing.assert_array_equal(te.generate(ids, prompt_lengths=lens, max_new_tokens=8),
                                  je.generate(ids, prompt_lengths=lens, max_new_tokens=8))


@pytest.mark.parametrize("quant", ["int8", "fp8", "int4"])
def test_expert_storage_equals_jax(models, quant):
    """int8 / fp8 experts become [L, E, K, N] storage with JAX's bytes and
    scales (one layer's stack a view); int4 experts stay dense leaves
    holding JAX's rounded values, beside packed int4 attention weights."""
    je, te = _engines(models, "ragged", quant)
    for name in ("moe_w_gate", "moe_w_up", "moe_w_down"):
        j, t = je.params["layers"][name], te.params[f"layers.{name}"]
        if quant == "int4":
            assert not isinstance(t, tqm.QuantizedMatrix)
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
            continue
        assert isinstance(t, tqm.QuantizedMatrix) and t.shape[:2] == (2, 4)
        q = np.asarray(j.q)
        np.testing.assert_array_equal(t.q.view(torch.uint8).numpy(), q.view(np.uint8))
        np.testing.assert_array_equal(t.scales.numpy(), np.asarray(j.scales))
        assert te._layer_weights[1][name].q.data_ptr() == t.q[1].data_ptr()
    assert isinstance(te.params["layers.wq"], tqm.QuantizedMatrix)
    assert te.params["layers.wq"].bits == QUANT[quant]["quant_bits"]
    assert not isinstance(te.params["layers.moe_gate"], tqm.QuantizedMatrix)


# ---------------------------------------------------------------------------
# Expert capacity as an admission resource
# ---------------------------------------------------------------------------


def _seed_pressure(eng, per_expert=100):
    """Fake one tick's routing counts: everything on expert 0, so
    ``moe_pressure()`` reads far over capacity."""
    counts = np.zeros((2, eng._mcfg.n_experts), np.int32)
    counts[:, 0] = per_expert
    eng._note_moe_counts((counts, np.zeros(2, np.float32)))
    eng._moe_last_total = int(counts[-1].sum())


def _park_run(eng, sched):
    sched.submit([1, 2, 3], max_new_tokens=8)
    sched.tick()                          # admitted before any pressure
    _seed_pressure(eng)
    pressure = eng.moe_pressure()
    sched.submit([4, 5, 6], max_new_tokens=4)
    sched.tick()
    parked = dict(sched.stats()["moe"])
    n = 0
    while sched.tick() and n < 300:
        n += 1
    return pressure, parked, sched.stats()


def test_overload_parks_never_preempts_then_drains_as_jax(models):
    """Seeded routing pressure holds the NEW request at its FIFO seat while
    the running one ticks; the real counts drain the pressure and the
    parked request unparks and completes, with no preemption, exactly as
    the JAX scheduler does."""
    je, te = _engines(models, "ragged")
    jr = _park_run(je, JScheduler(je))
    tr = _park_run(te, ContinuousBatchingScheduler(te))
    assert tr[0] > 1.0 and tr[0] == jr[0]
    assert tr[1]["capacity_parks"] >= 1 and tr[1]["waiting"] == 1 and tr[1] == jr[1]
    final = tr[2]
    assert final["requests"] == 2 and final["preemptions"] == 0
    assert final["moe"]["unparks"] >= 1 and final["moe"]["waiting"] == 0
    assert final["moe"] == jr[2]["moe"] and final["ticks"] == jr[2]["ticks"]


def test_drop_policy_admits_under_pressure(models):
    _, te = _engines(models, "auto", moe={"overload_policy": "drop"})
    sched = ContinuousBatchingScheduler(te)
    sched.submit([1, 2, 3], max_new_tokens=4)
    sched.tick()
    _seed_pressure(te)
    sched.submit([4, 5, 6], max_new_tokens=4)
    sched.tick()
    assert sched.stats()["moe"]["capacity_parks"] == 0
    assert sched.stats()["running"] == 2


def test_engine_admission_detail_names_expert_pressure(models):
    _, te = _engines(models, "ragged")
    assert te.moe_pressure() == 0.0                  # no ticks yet
    te.put([0], [[1, 2, 3]])                          # a running sequence to drain
    _seed_pressure(te)
    ok, _, why = te._admission_detail([7], [4])
    assert not ok and "expert capacity" in why and "KV is fine" in why
    assert te._admission_detail([0], [1])[0]          # running uids always pass
    with pytest.raises(RuntimeError, match="expert capacity"):
        te.put([7], [[1, 2]])
    assert 7 not in te._seqs


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
    for m in (fd, tqm, pa, rn, fa):
        monkeypatch.setattr(m, "use_kernel", lambda t: True)
    monkeypatch.setattr(tgg, "resolve_grouped_gemm", lambda kind, t: "kernel")
    monkeypatch.setattr(tgg, "_launch", tgg.grouped_matmul_reference)
    monkeypatch.setattr(tqm, "_launch", tqm.quant_matmul_reference)
    monkeypatch.setattr(fd, "_launch_qkv", lambda y, wq, wk, wv, c, s, pk, pv, bt, pos, H, KV, b:
                        fd.fused_qkv_rope_reference(y, wq, wk, wv, c, s, pk, pv, bt, pos,
                                                    n_heads=H, kv_heads=KV, bq=b[0], bk=b[1],
                                                    bv=b[2]))
    monkeypatch.setattr(fd, "_launch_attention", lambda q, ck, cv, bt, kl, n, sl=None:
                        fd.fused_paged_decode_reference(q, ck, cv, bt, kl, 2 if n is None else n,
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


@pytest.mark.parametrize("quant,decode_kernel", [("dense", "pallas"), ("int8", "pallas"),
                                                 ("fp8", "xla")])
def test_launch_counters_follow_the_programs(models, counted_port, quant, decode_kernel):
    """Per layer and lane of every program: three grouped-GEMM launches and
    two RMSNorms (the MoE FFN does not fuse); decode rows on the fused path
    with dense attention weights take the fused QKV and the split-K
    attention, with quantized ones the quantized matmul for q, k, v and wo
    and the split-K attention; chunk rows the extend kernel (and with
    quantized weights four quantized matmuls); put()'s prefill the flash
    kernel; each program one more RMSNorm for the head."""
    _, _, tm, state = models
    te = InferenceEngineV2(tm, state, _cfg(InferenceConfig, "ragged", quant,
                                           moe={"overload_policy": "drop"},
                                           decode_kernel=decode_kernel), device="cpu")
    for tick in _step_schedule():
        te.step(*tick)
    logits = te.put([9], [_prompts(1, (13,))[0]])
    te.decode_loop([9], [int(logits[0].argmax())], 3)
    by = te.dispatches_by_program
    L = 2
    dec = by["decode"] + by["mixed"] + 3
    ext = by["extend"] + by["mixed"]
    pre = by["prefill"]
    fused, quantized = decode_kernel == "pallas", quant != "dense"
    want = {k: 0 for k in counted_port.KERNEL_WRAPPERS}
    want.update(rmsnorm=(2 * L + 1) * (dec + ext + pre), grouped_matmul=3 * L * (dec + ext + pre),
                paged_extend_attention=L * ext, flash_attention=L * pre)
    if fused:
        want["fused_paged_decode_attention"] = L * dec
        if not quantized:
            want["fused_qkv_rope"] = L * dec
    else:
        want["paged_decode_attention"] = L * dec
    if quantized:
        want["quant_matmul"] = 4 * L * (dec + ext + pre)
    assert counted_port.launch_counts() == want


def test_v1_launch_counters_follow_the_programs(models, counted_port):
    _, _, tm, state = models
    te = init_inference(tm, state, dict(dtype="float32", max_seq_len=64,
                                        decode_kernel="pallas"), device="cpu")
    te.generate(np.ones((2, 5), np.int32), max_new_tokens=4)
    L, steps = 2, 3
    want = {k: 0 for k in counted_port.KERNEL_WRAPPERS}
    want.update(flash_attention=L, rmsnorm=(2 * L + 1) * (1 + steps),
                grouped_matmul=3 * L * (1 + steps), fused_qkv_rope=L * steps)
    assert counted_port.launch_counts() == want
