"""Multi-tenant LoRA at adapter ranks past 64 in the PyTorch port against
the JAX package, on the CPU, in f32.

- the LoRA delta's plain version (B9) within 1e-5 of ``lora_delta_oracle``
  and of ``lora_delta_pallas`` in interpret mode at ranks 128, 256 and 72
  (no multiple of 64; the kernel's rank chunks are 64 wide), null rows
  exactly zero;
- the wrapper's launch on a card (its C entry point stood in for here):
  one-token rows up to rank 8 pass no scratch (the row kernel), every
  other call mid's two bf16 terms [2, B, T, R rounded up to 16] and its
  splits of D and N; nothing refuses a rank;
- a serve on ``tests/test_adapters.py``'s tiny model with a pool of
  ``max_rank`` 128 holding tenants of ranks 16, 64 and 128 (zero-padded to
  128 as both pools pad them): tokens equal to the JAX scheduler's on
  "xla" and "pallas" (JAX's fused kernels in interpret mode), equal
  adapter stats, no preemption.
"""

import ctypes
import importlib

import numpy as np
import pytest
import torch
from test_torch_adapters import _icfg, _prompts, jax_fused, models  # noqa: F401  (fixtures)

from shuffle_exchange_tpu.inference import ContinuousBatchingScheduler as JScheduler
from shuffle_exchange_tpu.inference import InferenceConfig as JConfig
from shuffle_exchange_tpu.inference import InferenceEngineV2 as JEngine
from shuffle_exchange_tpu.ops.lora_gemm import lora_delta_oracle, lora_delta_pallas
from shuffle_exchange_tpu_torch.inference import (ContinuousBatchingScheduler, InferenceConfig,
                                                  InferenceEngineV2)
from shuffle_exchange_tpu_torch.inference.adapters import SUPPORTED_TARGETS, target_dims

tlg = importlib.import_module("shuffle_exchange_tpu_torch.ops.lora_gemm")

T = torch.from_numpy
RANKS = (16, 64, 128)        # the tenants of the rank-128 pool


def _gemm_operands(R, B=5, T_=4, D=256, N=128, S=4, seed=0):
    rng = np.random.default_rng(seed + R)
    x = rng.standard_normal((B, T_, D)).astype(np.float32)
    a = (rng.standard_normal((S, D, R)) * 0.1).astype(np.float32)
    b = (rng.standard_normal((S, R, N)) * 0.1).astype(np.float32)
    a[0], b[0] = 0.0, 0.0    # slot 0 is the null adapter
    slots = np.array([0, 1, 2, 1, 3], np.int32)[:B]
    return x, a, b, slots


@pytest.mark.parametrize("R", [128, 256, 72])
def test_plain_delta_matches_the_oracle_and_the_pallas_kernel(R):
    x, a, b, slots = _gemm_operands(R)
    got = tlg.lora_delta(T(x), T(a), T(b), T(slots)).numpy()
    np.testing.assert_allclose(got, np.asarray(lora_delta_oracle(x, a, b, slots)),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got, np.asarray(lora_delta_pallas(x, a, b, slots, interpret=True)),
                               atol=1e-5, rtol=1e-5)
    assert np.array_equal(got[0], np.zeros_like(got[0]))      # the null row
    assert tlg.lora_delta.launches == 0       # a CPU tensor takes the plain version


@pytest.mark.parametrize("R,T_", [(8, 1), (64, 1), (64, 40), (65, 1), (128, 40), (136, 3), (512, 1),
                                  (1024, 1)])
def test_launch_passes_mid_scratch_past_the_shared_memory_ranks(R, T_, monkeypatch):
    """One-token rows up to ROW_RANK take the row kernel and get a null
    ``mid``; every other call hands the tensor-core pair mid's two bf16
    terms [2, B, T, R rounded up to 16] and the splits of D and N the
    schedule gives. No rank is refused: rank 1024 launches the pair."""
    calls = []

    class Lib:
        @staticmethod
        def sxt_lora_delta_bf16(*args):
            calls.append(args)
            return 0

    monkeypatch.setattr(tlg, "_lib", lambda: Lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: type("S", (), {"cuda_stream": 0}))
    B, D, N, S = 3, 48, 40, 4
    x = torch.zeros(B, T_, D, dtype=torch.bfloat16)
    a, b = torch.zeros(S, D, R, dtype=torch.bfloat16), torch.zeros(S, R, N, dtype=torch.bfloat16)
    slots = torch.tensor([0, 1, 3], dtype=torch.int32)
    made = []
    real_empty = torch.empty
    monkeypatch.setattr(torch, "empty", lambda *s_, **k: made.append(s_) or real_empty(*s_, **k))
    out = tlg._launch(x, a, b, slots)
    assert out.shape == (B, T_, N) and len(calls) == 1
    args = calls[0]
    assert len(args) == 16 and args[6:12] == (B, T_, D, R, N, S)
    row_kernel = T_ == 1 and R <= tlg.ROW_RANK
    assert (args[5] is None) == row_kernel
    if row_kernel:
        assert args[12:15] == (0, 0, 0)
    else:
        assert made[-1] == (2, B, T_, -(-R // 16) * 16)   # mid's terms, after out
        assert args[12:14] == tlg.shrink_splits(T_, D, R)
        assert args[14] == tlg.expand_col_splits(B, T_, N)


def test_c_signature_carries_the_scratch_pointer():
    """The ctypes signature the wrapper sets: six pointers (x, A, B, slots,
    out, mid), six shape ints, three split ints (D splits, their rows, N
    splits), the stream."""
    lib = type("L", (), {})()
    lib.sxt_lora_delta_bf16 = type("F", (), {})()
    lib.sxt_lora_error_string = type("F", (), {})()
    _build = importlib.import_module("shuffle_exchange_tpu_torch.ops._build")
    saved_load, saved = _build.load, list(tlg._LIB)
    try:
        _build.load = lambda stem: lib
        tlg._LIB.clear()
        tlg._lib()
        assert lib.sxt_lora_delta_bf16.argtypes == [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + [
            ctypes.c_void_p]
    finally:
        _build.load = saved_load
        tlg._LIB[:] = saved


def _wide_factors(mcfg, rank, seed, std=0.5):
    rng = np.random.default_rng(seed)
    out = {}
    for t in SUPPORTED_TARGETS:
        din, dout = target_dims(mcfg, t)
        out[t] = ((rng.standard_normal((mcfg.n_layers, din, rank)) * std / rank ** 0.5)
                  .astype(np.float32),
                  (rng.standard_normal((mcfg.n_layers, rank, dout)) * std).astype(np.float32))
    return out


@pytest.mark.parametrize("decode_kernel", ["xla", "pallas"])
def test_rank_128_pool_serves_as_jax(models, jax_fused, decode_kernel):
    """Six requests over tenants of ranks 16, 64 and 128 (and one without an
    adapter) through a 2-slot pool of max_rank 128: tokens equal to the JAX
    scheduler's, equal adapter stats, parks that all unpark, no
    preemption; the adapters move some request's tokens."""
    jm, jp, tm, state = models
    je = JEngine(jm, jp, _icfg(JConfig, 2, max_rank=128, decode_kernel=decode_kernel))
    te = InferenceEngineV2(tm, state, _icfg(InferenceConfig, 2, max_rank=128,
                                            decode_kernel=decode_kernel), device="cpu")
    for i, r in enumerate(RANKS):
        fac = _wide_factors(tm.config, r, seed=30 + i)
        for e in (je, te):
            e.adapters.register(f"r{r}", fac, alpha=2.0 * r)
    assert te.adapters.max_rank == je.adapters.max_rank == 128
    prompts = _prompts(6, (4, 9, 6, 5, 7, 3))
    aids = ["r16", "r64", "r128", None, "r128", "r16"]
    js, ts = JScheduler(je), ContinuousBatchingScheduler(te)
    want = js.serve(prompts, max_new_tokens=6, adapter_ids=aids)
    got = ts.serve(prompts, max_new_tokens=6, adapter_ids=aids)
    assert got == want
    st = ts.stats()["adapters"]
    assert st == js.stats()["adapters"]
    assert st["parks"] == st["unparks"] and st["pinned"] == 0
    assert ts.preemptions == 0 == js.preemptions
    base = ContinuousBatchingScheduler(InferenceEngineV2(
        tm, state, _icfg(InferenceConfig, 2, max_rank=128, decode_kernel=decode_kernel),
        device="cpu")).serve(prompts, max_new_tokens=6)
    assert base != got and base[3] == got[3]     # adapters are live; the unadapted row is not moved
    if decode_kernel == "pallas":
        assert jax_fused["fused_paged_decode_attention_pallas"] > 0, jax_fused
