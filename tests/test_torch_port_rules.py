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
from shuffle_exchange_tpu_torch.inference import (InferenceConfig, InferenceEngine,
                                                  InferenceEngineV2, ServingConfig,
                                                  init_inference)
from shuffle_exchange_tpu_torch.inference.paged import BlockedAllocator
from shuffle_exchange_tpu_torch.models import Transformer, tiny
from shuffle_exchange_tpu_torch.ops import dispatch

tfa = importlib.import_module("shuffle_exchange_tpu_torch.ops.flash_attention")

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


def test_flash_wrapper_raises_on_a_meta_tensor():
    q = torch.zeros(1, 4, 2, 64, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tfa.flash_attention(q, q, q, causal=True)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_flash_wrapper_causal_needs_t_equal_s(causal):
    """Causal with T != S is refused on every device, naming the two
    diagonal alignments of the JAX package; the full mask takes any T, S."""
    q, k = torch.randn(1, 3, 2, 64), torch.randn(1, 5, 2, 64)
    if causal:
        with pytest.raises(ValueError, match="aligns the diagonal bottom-right"):
            tfa.flash_attention(q, k, k, causal=True)
    else:
        assert tfa.flash_attention(q, k, k, causal=False).shape == q.shape


@pytest.mark.parametrize("Dh", [32, 96, 256])
def test_flash_kernel_operand_check_refuses_unbuilt_head_dims(Dh):
    """On a CUDA tensor the wrapper calls this check before the launch; a
    head_dim the kernel is not built for raises there, naming its ROADMAP
    item, and never reaches the plain version. The forward is built for
    256 (GPT-J-6B's prefill) and 96 (Phi-3-mini's); the backward for 256
    (GPT-J-6B's training) and not for 96, where it names item 4 (h)."""
    q = torch.zeros(1, 8, 4, Dh, dtype=torch.bfloat16)
    k = torch.zeros(1, 8, 2, Dh, dtype=torch.bfloat16)
    if Dh == 256:
        tfa.check_operands(q, k, k)
        tfa.check_operands(q, k, k, backward=True, out=q, dout=q)
    elif Dh == 96:
        tfa.check_operands(q, k, k)
        with pytest.raises(ValueError, match=f"head_dim {Dh} not built .*item 4 \\(h\\)"):
            tfa.check_operands(q, k, k, backward=True, out=q, dout=q)
    else:
        with pytest.raises(ValueError, match=f"head_dim {Dh} not built .*item 4 \\(h\\)"):
            tfa.check_operands(q, k, k)
    q, k = torch.zeros(1, 8, 4, 64, dtype=torch.bfloat16), torch.zeros(1, 8, 2, 64)
    tfa.check_operands(q, k.bfloat16(), k.bfloat16())
    for bad, err in ((k, TypeError), (k.bfloat16().transpose(1, 2), ValueError)):
        with pytest.raises(err):
            tfa.check_operands(q, bad, bad)


def _v1_engine(**cfg):
    model = Transformer(tiny(**LLAMA), device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    return model, params, init_inference(model, params, dict(max_seq_len=64, **cfg),
                                         device="cpu")


@pytest.mark.parametrize("what,item", [
    ("config-temperature", "item 3"), ("config-top_k", "item 3"), ("config-top_p", "item 3"),
    ("generate-temperature", "item 3"), ("generate-rng", "item 3"),
    ("tensor_parallel", "item 12"), ("quantize_weights-lora", "InferenceEngineV2"),
    ("hf-path", "item 14"),
    ("hf-object", "item 14"), ("checkpoint", "item 7"), ("forward", "item 4"),
    ("kv_cache_dtype-int8", "InferenceEngineV2"), ("kv_cache_dtype-fp8", "InferenceEngineV2")])
def test_v1_refusals_name_their_roadmap_item(what, item):
    model, params, eng = _v1_engine()
    calls = {
        "config-temperature": lambda: init_inference(model, params, {"temperature": 0.7}),
        "config-top_k": lambda: init_inference(model, params, {"top_k": 40}),
        "config-top_p": lambda: init_inference(model, params, {"top_p": 0.9}),
        "generate-temperature": lambda: eng.generate([[1, 2]], temperature=0.5),
        "generate-rng": lambda: eng.generate([[1, 2]], rng=torch.Generator()),
        "tensor_parallel": lambda: init_inference(model, params, {"tensor_parallel": 2}),
        "quantize_weights-lora": lambda: init_inference(
            model, params, {"quantize_weights": True, "adapters": {"enabled": True}}),
        "hf-path": lambda: init_inference("meta-llama/Meta-Llama-3-8B", params, {}),
        "hf-object": lambda: init_inference(torch.nn.Linear(2, 2), params, {}),
        "checkpoint": lambda: init_inference(model, params, {}, checkpoint="ckpt"),
        "forward": lambda: eng.forward([[1, 2]]),
        # JAX's v1 engine never reads kv_cache_dtype; the port refuses it there
        "kv_cache_dtype-int8": lambda: init_inference(model, params, {"kv_cache_dtype": "int8"}),
        "kv_cache_dtype-fp8": lambda: init_inference(model, params, {"kv_cache_dtype": "fp8"}),
    }
    # adapters and int8/fp8 KV are ported to the paged engine: the v1 engine names it
    match = f"ROADMAP queue A, {item}" if item.startswith("item") else item
    with pytest.raises((ConfigError, NotImplementedError), match=match):
        calls[what]()


def test_moe_serves_quantized_and_its_training_and_expert_axis_raise():
    """MoE serving is accepted, quantized experts included; MoE training
    (``initialize()``, the training forward) trains one step, while
    interleaved dense and MoE layers still raise naming item 9 and an
    expert axis above 1 names item 12."""
    import shuffle_exchange_tpu_torch as sxt
    from shuffle_exchange_tpu_torch.models import tiny_moe
    from shuffle_exchange_tpu_torch.moe import moe_layer

    moe_cfg = {k: v for k, v in LLAMA.items() if k not in ("activation", "norm", "position")}
    model = Transformer(tiny_moe(**moe_cfg), device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    eng = init_inference(model, params, {"max_seq_len": 64, "quantize_weights": True},
                         device="cpu")
    assert eng.generate([[1, 2, 3]], max_new_tokens=2).shape == (1, 2)
    trainer, *_ = sxt.initialize(
        model=model, device="cpu",
        config={"train_batch_size": 1, "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}}})
    batch = {"input_ids": np.ones((1, 4), np.int32)}
    assert np.isfinite(float(trainer.train_batch(batch))) and trainer.global_steps == 1
    assert np.isfinite(float(model.loss(params, batch)))
    with pytest.raises(NotImplementedError, match="ROADMAP queue A, item 9"):
        Transformer(tiny_moe(**moe_cfg, moe_layer_pattern=(True, False)), device="cpu")

    class Mesh:
        shape = {"expert": 2}

    experts = {k[len("layers.moe_"):]: v[0] for k, v in params.items()
               if k.startswith("layers.moe_w_")}
    with pytest.raises(NotImplementedError, match="ROADMAP queue A, item 12"):
        moe_layer(params["layers.moe_gate"][0], experts, torch.randn(2, 32), mesh=Mesh())


def test_v1_greedy_generate_on_the_cpu_engine():
    _, _, eng = _v1_engine(max_new_tokens=5, decode_kernel="pallas")
    assert isinstance(eng, InferenceEngine) and eng._decode_kernel == "pallas"
    out = eng.generate(np.asarray([[3, 4, 5], [6, 7, 0]]), prompt_lengths=[3, 2])
    assert out.shape == (2, 5) and out.dtype == np.int32
    assert ((0 <= out) & (out < 64)).all()
    with pytest.raises(ValueError, match="max_seq_len"):
        eng.generate(np.ones((1, 60), np.int32), max_new_tokens=8)
    with pytest.raises(ValueError, match="max_batch_size"):
        eng.generate(np.ones((9, 2), np.int32))


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
    {"speculative": {"enabled": True}}, {"adapters": {"enabled": True, "targets": ("w_up",)}},
    {"kv_tier": {"enabled": True}}, {"router": {}}, {"sampling": {"temperature": 0.7}},
    {"seed": 1},
    {"serving": {"speculative": {"k": 4}}},
], ids=lambda d: "-".join(f"{k}" for k in d) + "-" + str(next(iter(d.values())))[:12])
def test_unported_config_keys_raise_naming_the_roadmap(d):
    if "kv_cache_dtype" in d:
        # int8/fp8 KV is ported (the paged engine): accepted as JAX accepts it
        assert (InferenceConfig.from_dict(d).kv_cache_dtype
                == JConfig.from_dict(d).kv_cache_dtype == d["kv_cache_dtype"])
        return
    if "adapters" in d:
        # the section is ported: a bad one raises as JAX's AdapterConfig does
        with pytest.raises(JConfigError, match="adapters.targets"):
            JConfig.from_dict(d)
        with pytest.raises(ConfigError, match="adapters.targets"):
            InferenceConfig.from_dict(d)
        return
    with pytest.raises(ConfigError, match="ROADMAP"):
        InferenceConfig.from_dict(d)


@pytest.mark.parametrize("d", [
    {"decode_kernel": "cuda"}, {"dtype": "int4"}, {"max_seq_len": 0},
    {"num_kv_blocks": 0}, {"quant_bits": 3}, {"prefix_caching": "yes"},
    {"serving": {"token_budget": 0}}, {"serving": {"max_running": 9, "token_budget": 8}},
    {"serving": {"chunk_min": 300}}, {"serving": {"chunk_bins": ["x"]}},
    {"serving": {"bogus": 1}},
])
def test_bad_config_raises(d):
    with pytest.raises(ConfigError):
        InferenceConfig.from_dict(d)


def test_config_defaults_equal_the_jax_package():
    names = ("dtype", "max_batch_size", "max_seq_len", "decode_kernel", "kv_block_size",
             "num_kv_blocks", "kv_cache_dtype", "prefix_caching", "tensor_parallel",
             "max_new_tokens", "eos_token_id", "pad_token_id", "temperature", "top_k",
             "top_p", "quantize_weights", "quant_bits", "quant_group_size")
    port, ref = InferenceConfig(), JConfig()
    assert {n: getattr(port, n) for n in names} == {n: getattr(ref, n) for n in names}
    for f in dataclasses.fields(ServingConfig):
        a, b = getattr(port.serving, f.name), getattr(ref.serving, f.name)
        if dataclasses.is_dataclass(a):     # the moe section: the same fields and values
            a, b = dataclasses.asdict(a), dataclasses.asdict(b)
        assert a == b, f.name
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


# ---------------------------------------------------------------------------
# The training slice
# ---------------------------------------------------------------------------


def test_ast_rule_covers_the_training_modules():
    files = {str(f.relative_to(PORT)) for f in PORT.rglob("*.py")}
    assert {"__init__.py", "config/config.py", "config/config_utils.py", "runtime/engine.py",
            "runtime/optimizers.py", "runtime/lr_schedules.py", "runtime/loss_scaler.py",
            "ops/fused_adam.py", "ops/flash_attention.py", "models/convert.py"} <= files
    for f in ("ops/csrc/fused_adam.cu", "ops/csrc/flash_attention.cu"):
        assert (PORT / f).exists()


def test_ast_rule_covers_the_quantized_serving_modules():
    files = {str(f.relative_to(PORT)) for f in PORT.rglob("*.py")}
    assert {"ops/quant.py", "ops/quant_matmul.py", "ops/fused_decode.py",
            "models/convert.py", "inference/engine.py"} <= files
    for f in ("ops/csrc/quant_matmul.cu", "ops/csrc/quant_gemv.cuh"):
        assert (PORT / f).exists()


def test_ast_rule_covers_the_alibi_and_gpt2_modules():
    files = {str(f.relative_to(PORT)) for f in PORT.rglob("*.py")}
    assert {"ops/alibi_attention.py", "models/hf.py", "models/transformer.py"} <= files
    assert (PORT / "ops/csrc/alibi_attention.cu").exists()


def test_ast_rule_covers_the_moe_modules():
    files = {str(f.relative_to(PORT)) for f in PORT.rglob("*.py")}
    assert {"moe/__init__.py", "moe/gating.py", "moe/layer.py", "ops/grouped_gemm.py"} <= files
    assert (PORT / "ops/csrc/grouped_gemm.cu").exists()


def _train_cfg(**extra):
    return dict({"train_batch_size": 4,
                 "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}}}, **extra)


def test_initialize_without_a_card_and_without_cpu_request_raises(monkeypatch):
    import shuffle_exchange_tpu_torch as sxt

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = Transformer(tiny(**LLAMA), device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sxt.initialize(model=model, config=_train_cfg())
    engine, opt, loader, sched = sxt.initialize(model=model, config=_train_cfg(), device="cpu")
    assert engine.device.type == "cpu" and engine.module is model and loader is None
    assert all(m.dtype == torch.float32 for m in engine.state.master.values())


@pytest.mark.parametrize("section,item", [
    ({"zero_optimization": {"stage": 2, "cpu_offload": True}}, "item 12"),
    ({"zero_optimization": {"offload_param": {"device": "nvme"}}}, "item 12"),
    ({"zero_optimization": {"zero_quantized_gradients": True}}, "item 12"),
    ({"zero_optimization": {"zero_hpz_partition_size": 2}}, "item 12"),
    ({"zeropp": {"bucket_mb": 16}}, "item 12"), ({"mesh": {"fsdp": 2}}, "item 12"),
    ({"mesh": {"tensor": 2}}, "item 12"), ({"pipeline": {"stages": 2}}, "item 12"),
    ({"tensor_parallel": {"tp_size": 2}}, "item 12"), ({"sequence_parallel_size": 2}, "item 12"),
    ({"context_parallel": {"degree": 2}}, "item 12"), ({"lora": {"enabled": True}}, "item 10"),
    ({"shuffle_exchange": {"enabled": True, "method": "RR"}}, "item 11"),
    ({"data_efficiency": {"enabled": True}}, "item 14"),
    ({"curriculum_learning": {"enabled": True}}, "item 14"),
    ({"checkpoint": {"writer": "fast"}}, "item 7"), ({"tensorboard": {"enabled": True}}, "item 14"),
    ({"flops_profiler": {"enabled": True}}, "item 14"), ({"wall_clock_breakdown": True}, "item 14"),
    ({"hybrid_engine": {"enabled": True}}, "item 13"), ({"elasticity": {"enabled": True}}, "item 14"),
    ({"progressive_layer_drop": {"enabled": True}}, "item 14"),
    ({"resilience": {"nonfinite_policy": "rollback"}}, "item 7"),
    ({"resilience": {"keep_last_n": 2}}, "item 7"), ({"autotuning": {"enabled": True}}, "item 14"),
], ids=lambda v: next(iter(v)) + "-" + str(next(iter(v.values())))[:24] if isinstance(v, dict)
   else None)
def test_unported_training_sections_raise_naming_their_item(section, item):
    from shuffle_exchange_tpu_torch.config import SXConfig

    with pytest.raises(ConfigError, match=f"ROADMAP queue A, {item}"):
        SXConfig.load(_train_cfg(**section))


def test_unported_sections_at_their_inert_defaults_are_accepted():
    """What the JAX loader accepts with the feature off loads here too,
    legacy spellings included."""
    from shuffle_exchange_tpu.config import SXConfig as JSX
    from shuffle_exchange_tpu_torch.config import SXConfig

    doc = _train_cfg(zeropp={"bucket_mb": 32}, lora={"enabled": False}, mesh={"data": -1},
                     checkpoint={"tag_validation": "Warn"}, tensorboard={"enabled": False},
                     pipeline={"stages": 0}, shuffle_exchange={"method": "RR"},
                     bfloat16={"enabled": "true"}, gradient_clipping="1.0",
                     zero_optimization={"stage": "2", "reduce_bucket_size": "5e8",
                                        "stage3_gather_fp16_weights_on_model_save": True},
                     steps_per_print=5, resilience={"nonfinite_policy": "off"})
    port, ref = SXConfig.load(doc), JSX.load(doc, world_size=1)
    for name in ("train_batch_size", "train_micro_batch_size_per_gpu",
                 "gradient_accumulation_steps", "gradient_clipping", "steps_per_print"):
        assert getattr(port, name) == getattr(ref, name), name
    assert port.bf16.enabled and port.train_dtype == torch.bfloat16
    assert port.zero_optimization.stage == ref.zero_optimization.stage == 2
    assert port.zero_optimization.reduce_bucket_size == ref.zero_optimization.reduce_bucket_size
    assert port.zero_optimization.stage3_gather_16bit_weights_on_model_save
    assert port.resilience.nonfinite_policy == "off"
    with pytest.raises(ConfigError, match="world size 8"):
        SXConfig.load(_train_cfg(), world_size=8)


def test_training_config_defaults_and_batch_triangle_equal_the_jax_package():
    from shuffle_exchange_tpu import config as jc
    from shuffle_exchange_tpu_torch import config as tc

    for cls in ("FP16Config", "BF16Config", "ZeroConfig", "OffloadConfig", "OptimizerConfig",
                "SchedulerConfig", "ResilienceConfig", "MeshConfig",
                "ActivationCheckpointingConfig"):
        port, ref = getattr(tc, cls)(), getattr(jc, cls)()
        assert port.to_dict() == ref.to_dict(), cls
    port, ref = tc.SXConfig(), jc.SXConfig()
    for f in dataclasses.fields(tc.SXConfig):
        a, b = getattr(port, f.name), getattr(ref, f.name)
        assert (a.to_dict() if hasattr(a, "to_dict") else a) == \
            (b.to_dict() if hasattr(b, "to_dict") else b), f.name
    for doc in ({"train_batch_size": 32}, {"train_micro_batch_size_per_gpu": 4},
                {"train_batch_size": 32, "gradient_accumulation_steps": 4},
                {"train_batch_size": 32, "train_micro_batch_size_per_gpu": 8},
                {"train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 3}):
        p, r = tc.SXConfig.load(doc), jc.SXConfig.load(doc, world_size=1)
        assert (p.train_batch_size, p.train_micro_batch_size_per_gpu,
                p.gradient_accumulation_steps) == (r.train_batch_size,
                                                   r.train_micro_batch_size_per_gpu,
                                                   r.gradient_accumulation_steps)
    for doc in ({}, {"train_batch_size": 32, "train_micro_batch_size_per_gpu": 8,
                     "gradient_accumulation_steps": 2},
                {"train_batch_size": 4, "fp16": {"enabled": True}, "bf16": {"enabled": True}},
                {"train_batch_size": 4, "fp16": {"hysteresis": 0}},
                {"train_batch_size": 4, "zero_optimization": {"stage": 4}}):
        with pytest.raises(JConfigError):
            jc.SXConfig.load(doc, world_size=1)
        with pytest.raises(ConfigError):
            tc.SXConfig.load(doc)


@pytest.mark.parametrize("name,item", [
    ("OneBitAdam", "item 12"), ("ZeroOneAdam", "item 12"), ("OneBitLamb", "item 12"),
    ("Lamb", "item 14"), ("Lion", "item 14"), ("SGD", "item 14"), ("Adagrad", "item 14"),
    ("Muon", "item 14")])
def test_unported_optimizer_types_raise_naming_their_item(name, item):
    import shuffle_exchange_tpu_torch as sxt

    model = Transformer(tiny(**LLAMA), device="cpu")
    with pytest.raises(ConfigError, match=f"ROADMAP queue A, {item}"):
        sxt.initialize(model=model, device="cpu",
                       config={"train_batch_size": 4, "optimizer": {"type": name}})


def test_optimizer_types_and_the_adam_w_mode_rule():
    from shuffle_exchange_tpu_torch.config import OptimizerConfig
    from shuffle_exchange_tpu_torch.ops.fused_adam import FusedAdamW
    from shuffle_exchange_tpu_torch.runtime.optimizers import AdamL2, build_optimizer, get_base_lr

    def kind(name, **params):
        return type(build_optimizer(OptimizerConfig(type=name, params=params), None, 0.0))

    assert kind("AdamW") is kind("FusedAdam") is kind("CPUAdam") is FusedAdamW
    assert kind("Adam") is AdamL2 and kind("Adam", adam_w_mode=True) is FusedAdamW
    assert kind("FusedAdam", adam_w_mode=False) is AdamL2
    assert kind("AdamW", adam_w_mode=False) is FusedAdamW       # "adamw" is always decoupled
    tx = build_optimizer(OptimizerConfig(type="FusedAdam", params={
        "lr": 3e-4, "betas": [0.8, 0.9], "eps": 1e-6, "weight_decay": 0.1}), None, 0.5)
    assert (tx.b1, tx.b2, tx.eps, tx.weight_decay, tx.max_grad_norm, tx.lr_at(7)) == \
        (0.8, 0.9, 1e-6, 0.1, 0.5, 3e-4)
    # the schedule index: FusedAdam with decoupled decay is the reference's
    # kernel path (count + 1), every other Adam type is optax there (count)
    offset = lambda name, **params: build_optimizer(
        OptimizerConfig(type=name, params=params), None, 0.0).schedule_offset
    assert offset("FusedAdam") == 1
    assert offset("AdamW") == offset("CPUAdam") == offset("Adam") == 0
    assert offset("FusedAdam", adam_w_mode=False) == offset("Adam", adam_w_mode=True) == 0
    assert get_base_lr(OptimizerConfig(params={"learning_rate": 0.5})) == 0.5
    with pytest.raises(ConfigError, match="Unknown optimizer"):
        kind("Nope")
    with pytest.raises(ConfigError, match="No optimizer section"):
        build_optimizer(None, None)


def test_adam_with_l2_decay_follows_optax():
    import jax.numpy as jnp
    import optax

    from shuffle_exchange_tpu_torch.config import OptimizerConfig
    from shuffle_exchange_tpu_torch.runtime.optimizers import build_optimizer

    rng = np.random.default_rng(0)
    p0 = rng.normal(size=(6, 5)).astype(np.float32)
    tx = optax.chain(optax.add_decayed_weights(0.1), optax.adam(1e-2))
    jp, jstate = {"w": jnp.asarray(p0)}, None
    jstate = tx.init(jp)
    port = build_optimizer(OptimizerConfig(type="Adam", params={"lr": 1e-2, "weight_decay": 0.1}),
                           None)
    tp = {"w": torch.from_numpy(p0.copy())}
    state = port.init(tp)
    for _ in range(4):
        g = rng.normal(size=p0.shape).astype(np.float32)
        upd, jstate = tx.update({"w": jnp.asarray(g)}, jstate, jp)
        jp = optax.apply_updates(jp, upd)
        port.update(tp, {"w": torch.from_numpy(g)}, state)
        np.testing.assert_allclose(tp["w"].numpy(), np.asarray(jp["w"]), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("kw,item", [
    ({"method": "RR"}, "item 11"), ({"rings": 2}, "item 11"), ({"shuffle_step": 5}, "item 11"),
    ({"slice_count": 2}, "item 11"), ({"training_data": [1, 2]}, "item 14"),
    ({"collate_fn": len}, "item 14"), ({"mpu": object()}, "item 12")])
def test_initialize_kwargs_of_unported_features_raise(kw, item):
    import shuffle_exchange_tpu_torch as sxt

    with pytest.raises(NotImplementedError, match=f"ROADMAP queue A, {item}"):
        sxt.initialize(model=Transformer(tiny(**LLAMA), device="cpu"), config=_train_cfg(),
                       device="cpu", **kw)
    with pytest.raises(ConfigError, match="needs a model object"):
        sxt.initialize(config=_train_cfg(), device="cpu")


def test_initialize_signature_is_the_jax_one_plus_device():
    import inspect

    import shuffle_exchange_tpu as jsxt
    import shuffle_exchange_tpu_torch as sxt

    ref = inspect.signature(jsxt.initialize).parameters
    port = inspect.signature(sxt.initialize).parameters
    assert list(port) == list(ref) + ["device"]
    for name, p in ref.items():
        assert port[name].default == p.default, name


def test_flash_attention_that_requires_grad_never_takes_the_no_grad_route(monkeypatch):
    """With the kernel gate open, a call whose input requires grad goes
    through the autograd function (forward with lse, backward kernels and
    both counters); the same call under no_grad or on detached tensors
    takes the inference route without lse."""
    calls = []

    def launch(q, k, v, causal, seg, want_lse):
        calls.append(("fwd", want_lse))
        out, lse = tfa.reference_attention_lse(q, k, v, causal, seg)
        return out, (lse if want_lse else None)

    def launch_bwd(q, k, v, out, lse, dout, causal, seg):
        calls.append(("bwd", lse is not None))
        return tfa.reference_attention_bwd(q, k, v, out, dout, causal, seg)

    monkeypatch.setattr(tfa, "use_kernel", lambda t: True)
    monkeypatch.setattr(tfa, "_launch", launch)
    monkeypatch.setattr(tfa, "_launch_bwd", launch_bwd)
    monkeypatch.setattr(tfa.flash_attention, "launches", 0)
    monkeypatch.setattr(tfa.flash_attention_bwd, "launches", 0)
    q = torch.randn(1, 6, 4, 8, requires_grad=True)
    k, v = torch.randn(1, 6, 2, 8), torch.randn(1, 6, 2, 8, requires_grad=True)
    out = tfa.flash_attention(q, k, v)
    assert calls == [("fwd", True)] and out.requires_grad
    out.sum().backward()
    assert calls == [("fwd", True), ("bwd", True)]
    assert q.grad is not None and v.grad is not None and k.grad is None
    assert (tfa.flash_attention.launches, tfa.flash_attention_bwd.launches) == (1, 1)
    with torch.no_grad():
        tfa.flash_attention(q, k, v)
    tfa.flash_attention(q.detach(), k, v.detach())
    assert calls[2:] == [("fwd", False), ("fwd", False)]
    assert (tfa.flash_attention.launches, tfa.flash_attention_bwd.launches) == (3, 1)
