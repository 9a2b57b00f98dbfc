"""Rules of the PyTorch port that hold on any machine.

- No module of ``shuffle_exchange_tpu_torch`` imports ``jax`` or the JAX
  package. The check reads the sources (an AST walk): the test process
  has imported JAX already, so ``sys.modules`` would say nothing.
- Entry points run on the card unless the caller asks for the CPU; with
  no card and no such request they raise.
- Keys and structures the slice does not port raise, naming the ROADMAP
  item; the config fields it does port keep the JAX defaults and
  validation.
"""

import ast
import dataclasses
import importlib
import pathlib

import numpy as np
import pytest
import torch

from shuffle_exchange_tpu.config import ConfigError as JConfigError
from shuffle_exchange_tpu.inference import InferenceConfig as JConfig
from shuffle_exchange_tpu.inference import ServingConfig as JServing
from shuffle_exchange_tpu.inference.paged import BlockedAllocator as JAllocator
from shuffle_exchange_tpu_torch.config import ConfigError
from shuffle_exchange_tpu_torch.inference import (InferenceConfig, InferenceEngineV2,
                                                  ServingConfig)
from shuffle_exchange_tpu_torch.inference.paged import BlockedAllocator
from shuffle_exchange_tpu_torch.models import Transformer, tiny
from shuffle_exchange_tpu_torch.ops import dispatch

PORT = pathlib.Path(__file__).resolve().parents[1] / "shuffle_exchange_tpu_torch"
LLAMA = dict(vocab=64, d=32, layers=1, heads=4, seq=64, activation="swiglu",
             norm="rmsnorm", position="rope", n_kv_heads=2, tie_embeddings=False)


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_sources_import_neither_jax_nor_the_jax_package():
    files = sorted(PORT.rglob("*.py"))
    assert len(files) > 10
    bad = [(str(f.relative_to(PORT)), name) for f in files for name in _imports(f)
           if name.split(".")[0] in ("jax", "jaxlib", "shuffle_exchange_tpu", "flax", "optax")]
    assert bad == []


def test_no_cuda_and_no_cpu_request_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Transformer(tiny(**LLAMA))
    with pytest.raises(RuntimeError, match="CUDA"):
        dispatch.resolve_device("cuda")
    model = Transformer(tiny(**LLAMA), device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InferenceEngineV2(model, params, InferenceConfig(max_seq_len=64, kv_block_size=8))
    eng = InferenceEngineV2(model, params, InferenceConfig(max_seq_len=64, kv_block_size=8),
                            device="cpu")
    assert eng.cache.k.device.type == "cpu"


def test_kernel_gate_follows_the_tensor():
    assert dispatch.use_kernel(torch.zeros(1)) is False
    with pytest.raises(ValueError, match="no kernel"):
        dispatch.use_kernel(torch.zeros(1, device="meta"))


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    build = importlib.import_module("shuffle_exchange_tpu_torch.ops._build")
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build("paged_attention")
    assert build.library_path("paged_attention").name.startswith("paged_attention-")


def test_library_name_follows_the_shared_headers(monkeypatch, tmp_path):
    """An edit to a ``csrc/*.cuh`` header both sources include renames
    their libraries, so a stale build is never loaded."""
    build = importlib.import_module("shuffle_exchange_tpu_torch.ops._build")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// v1\n")
    before = build.library_path("k")
    (tmp_path / "h.cuh").write_text("// v2\n")
    assert build.library_path("k") != before


@pytest.mark.parametrize("mode,want", [("auto", "xla"), ("xla", "xla")])
def test_decode_kernel_resolves_to_the_paged_kernels(mode, want):
    """On the CPU "auto" is the paged-kernel layer body, as JAX's "auto"
    is off its accelerator."""
    assert dispatch.resolve_decode_kernel(mode, "cpu") == want


@pytest.mark.parametrize("mode,device,want", [
    ("auto", "cuda", "pallas"), ("pallas", "cuda", "pallas"), ("pallas", "cpu", "pallas"),
    ("xla", "cuda", "xla")])
def test_decode_kernel_resolution_by_device(mode, device, want):
    assert dispatch.resolve_decode_kernel(mode, device) == want


def test_fused_decode_kernels_are_not_ported_yet():
    """The rules of "pallas" (the fused decode kernels): no environment
    variable or flag is needed to run it on the CPU, where it builds an
    engine over the plain versions, and a bad mode raises."""
    with pytest.raises(ValueError, match="decode_kernel"):
        dispatch.resolve_decode_kernel("cuda", "cpu")
    model = Transformer(tiny(**LLAMA), device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    eng = InferenceEngineV2(model, params, InferenceConfig(
        max_seq_len=64, kv_block_size=8, decode_kernel="pallas"), device="cpu")
    assert (eng._decode_kernel, eng._fuse_qkv, eng._fuse_mlp) == ("pallas", True, True)
    dl, _ = eng.step([], [], [(0, [1, 2, 3])])
    dl, _ = eng.step([0], [4])
    assert dl.shape == (1, 64) and np.isfinite(dl).all()


@pytest.mark.parametrize("d", [
    {"kv_cache_dtype": "int8"}, {"kv_cache_dtype": "fp8"}, {"prefix_caching": True},
    {"speculative": {"enabled": True}}, {"adapters": {"enabled": True}},
    {"kv_tier": {"enabled": True}}, {"router": {}}, {"sampling": {"temperature": 0.7}},
    {"seed": 1},
    {"serving": {"moe": {}}}, {"serving": {"speculative": {"k": 4}}},
], ids=lambda d: "-".join(f"{k}" for k in d) + "-" + str(next(iter(d.values())))[:12])
def test_unported_config_keys_raise_naming_the_roadmap(d):
    with pytest.raises(ConfigError, match="ROADMAP"):
        InferenceConfig.from_dict(d)


@pytest.mark.parametrize("d", [
    {"decode_kernel": "cuda"}, {"dtype": "int4"}, {"max_seq_len": 0},
    {"num_kv_blocks": 0}, {"quantize_weights": True}, {"prefix_caching": "yes"},
    {"serving": {"token_budget": 0}}, {"serving": {"max_running": 9, "token_budget": 8}},
    {"serving": {"chunk_min": 300}}, {"serving": {"chunk_bins": ["x"]}},
    {"serving": {"bogus": 1}},
])
def test_bad_config_raises(d):
    with pytest.raises(ConfigError):
        InferenceConfig.from_dict(d)


def test_config_defaults_equal_the_jax_package():
    names = ("dtype", "max_batch_size", "max_seq_len", "decode_kernel", "kv_block_size",
             "num_kv_blocks", "kv_cache_dtype", "prefix_caching")
    port, ref = InferenceConfig(), JConfig()
    assert {n: getattr(port, n) for n in names} == {n: getattr(ref, n) for n in names}
    for f in dataclasses.fields(ServingConfig):
        assert getattr(port.serving, f.name) == getattr(ref.serving, f.name), f.name
    assert InferenceConfig.from_dict({"dtype": "bf16"}).torch_dtype() == torch.bfloat16
    assert InferenceConfig.from_dict({"dtype": "fp32"}).dtype == JConfig.from_dict(
        {"dtype": "fp32"}).dtype


@pytest.mark.parametrize("kw", [
    {}, {"token_budget": 16, "max_running": 4, "chunk_min": 4},
    {"token_budget": 100, "chunk_min": 7}, {"token_budget": 64, "chunk_bins": [48, 8, 16]},
])
def test_chunk_ladder_equals_the_jax_package(kw):
    port, ref = ServingConfig(**kw), JServing(**kw)
    assert port.bins() == ref.bins()
    for c in range(1, 2 * port.token_budget + 3):
        assert port.bin_chunk(c) == ref.bin_chunk(c), c


def test_serving_validation_matches_the_jax_package():
    for kw in ({"token_budget": 0}, {"max_running": 0}, {"chunk_min": 0},
               {"token_budget": 8, "max_running": 9}, {"chunk_bins": [0, 4]}):
        with pytest.raises(JConfigError):
            JServing(**kw)
        with pytest.raises(ConfigError):
            ServingConfig(**kw)


def test_allocator_trace_equals_the_jax_allocator():
    """A seeded trace of allocate/retain/free leaves both allocators with
    the same blocks handed out, in the same order, and the same refusals."""
    rng = np.random.default_rng(0)
    port, ref = BlockedAllocator(24), JAllocator(24)
    held = []
    for _ in range(300):
        op = rng.integers(0, 3)
        if op == 0:
            n = int(rng.integers(1, 6))
            if n > ref.free_blocks:
                for a in (port, ref):
                    with pytest.raises(RuntimeError, match="out of KV blocks"):
                        a.allocate(n)
                continue
            got, want = port.allocate(n), ref.allocate(n)
            assert got == want
            held.extend(got)
        elif op == 1 and held:
            b = held[int(rng.integers(len(held)))]
            port.retain([b])
            ref.retain([b])
            held.append(b)
        elif held:
            b = held.pop(int(rng.integers(len(held))))
            port.free([b])
            ref.free([b])
        assert (port.free_blocks, port.live_blocks, port.shared_blocks) == \
            (ref.free_blocks, ref.live_blocks, ref.shared_blocks)
    port.free(held)
    ref.free(held)
    assert port.free_blocks == ref.free_blocks == 24
    for a in (port, ref):
        with pytest.raises(ValueError, match="double free"):
            a.free([3])
