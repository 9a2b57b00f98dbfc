"""Serving at head dims 80 and 96 (Pythia-2.8b, Phi-3-mini) in the PyTorch
port against the JAX package, on the CPU, in f32.

Two tinies, each ``config_from_hf`` of its published config shrunk to two
layers, two heads and a 96-word vocabulary: Phi-3-mini's (d 192: two heads
of 96, MHA, full rotate-half RoPE, SwiGLU + RMSNorm, no biases) and
Pythia-2.8b's (d 160: two heads of 80, rotary_pct 0.25 so rd 20, the
two-layernorm parallel block, exact gelu, biases). Each gets the JAX init
with every norm weight and bias drawn from numpy. Held to the JAX package:

- ``config_from_hf`` field for field on both published configs, and their
  3,821,079,552 and 2,775,208,960 parameters from their shapes;
- the plain B2, B3 and B5 at Dh 80 and 96 (MHA and GQA, and the decode
  kernels' head-chunk edges 13 x 80 and 11 x 96 over one kv head, whose
  last chunk holds one head) over bf16, int8 and fp8 pools, with slopes on
  one pool a group, against the Pallas kernels in interpret mode (f32 and
  the one-byte pools 1e-5, bf16 one bf16 step with P in f32);
- the plain B4 at rd 20 of 80 with biases, pool and no pool, against
  ``fused_qkv_rope_pallas(interpret=True)`` (1e-5), and the plain flash
  forward at 80 and 96 against ``reference_attention`` (1e-5);
- the engines: ``step()`` and ``put()`` logits within 1e-4, ``serve()``,
  ``decode_loop`` and the v1 ``generate`` tokens exact, on "xla" and on
  "pallas" with JAX's kernels in interpret mode (``SXT_FUSED_INTERPRET``):
  the ``routes`` fixture counts JAX's Pallas traces and the port wrappers'
  calls (Phi-3-mini reaches B4, B5 and B6; Pythia-2.8b B4 and B5, its
  exact gelu keeping the MLP on the layer body);
- the launch counters with the kernel gate opened onto the plain versions,
  and the refusals that stay: head dims the kernels are not built for
  (72: not a multiple of 16) and the flash backward at 80 and 96, each
  naming its ROADMAP item.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_falcon import _close, _operands, _slopes, _table
from test_torch_falcon import counted_port  # noqa: F401  (a fixture, extended below)

from shuffle_exchange_tpu.inference import ContinuousBatchingScheduler as JScheduler
from shuffle_exchange_tpu.inference import InferenceConfig as JConfig
from shuffle_exchange_tpu.inference import InferenceEngine as JEngineV1
from shuffle_exchange_tpu.inference import InferenceEngineV2 as JEngine
from shuffle_exchange_tpu.models import Transformer as JTransformer
from shuffle_exchange_tpu.models import hf as jhf
from shuffle_exchange_tpu.models import transformer as jtf
from shuffle_exchange_tpu.ops.flash_attention import reference_attention as jreference
from shuffle_exchange_tpu_torch.inference import (ContinuousBatchingScheduler, InferenceConfig,
                                                  InferenceEngineV2, init_inference)
from shuffle_exchange_tpu_torch.models import Transformer, config_from_hf, param_count
from shuffle_exchange_tpu_torch.models import params_from_numpy
from shuffle_exchange_tpu_torch.models import transformer as ttf

jpa = importlib.import_module("shuffle_exchange_tpu.ops.paged_attention")
jfd = importlib.import_module("shuffle_exchange_tpu.ops.fused_decode")
tpa = importlib.import_module("shuffle_exchange_tpu_torch.ops.paged_attention")
tfd = importlib.import_module("shuffle_exchange_tpu_torch.ops.fused_decode")
tfa = importlib.import_module("shuffle_exchange_tpu_torch.ops.flash_attention")
tie = importlib.import_module("shuffle_exchange_tpu_torch.inference.engine")
tie2 = importlib.import_module("shuffle_exchange_tpu_torch.inference.engine_v2")

T = torch.from_numpy
TOL = 1e-4           # engines: f32 matmuls and softmax in another order
F32_TOL = 1e-5       # plain kernels against the Pallas kernels: f32, another order

# the published configs (microsoft/Phi-3-mini-4k-instruct, EleutherAI/pythia-2.8b),
# as the fields config_from_hf reads them (Phi-3's sliding_window is not read,
# as in the JAX mapping)
PHI3_MINI = {"architectures": ["Phi3ForCausalLM"], "model_type": "phi3", "hidden_size": 3072,
             "intermediate_size": 8192, "num_attention_heads": 32, "num_hidden_layers": 32,
             "num_key_value_heads": 32, "max_position_embeddings": 4096, "rope_theta": 10000.0,
             "rms_norm_eps": 1e-5, "hidden_act": "silu", "vocab_size": 32064,
             "tie_word_embeddings": False, "sliding_window": 2047}
PYTHIA_2B8 = {"architectures": ["GPTNeoXForCausalLM"], "model_type": "gpt_neox",
              "hidden_size": 2560, "intermediate_size": 10240, "num_attention_heads": 32,
              "num_hidden_layers": 32, "max_position_embeddings": 2048, "rotary_pct": 0.25,
              "rotary_emb_base": 10000, "use_parallel_residual": True, "vocab_size": 50304,
              "hidden_act": "gelu", "layer_norm_eps": 1e-5, "tie_word_embeddings": False}
_SMALL = dict(num_hidden_layers=2, vocab_size=96, max_position_embeddings=64)
TINY_HF = {"phi-3-mini": dict(PHI3_MINI, hidden_size=192, num_attention_heads=2,
                              num_key_value_heads=2, intermediate_size=256, **_SMALL),
           "pythia-2.8b": dict(PYTHIA_2B8, hidden_size=160, num_attention_heads=2,
                               intermediate_size=320, **_SMALL)}
KINDS = list(TINY_HF)
#: the fused kernels each tiny's "pallas" decode runs
FUSED = {"phi-3-mini": {"qkv", "attention", "mlp"}, "pythia-2.8b": {"qkv", "attention"}}
JAX_KERNELS = {"qkv": "fused_qkv_rope_pallas", "attention": "fused_paged_decode_attention_pallas",
               "mlp": "fused_mlp_pallas"}


def _tree(kind, seed=1):
    """The JAX init of the ``kind`` tiny with its norm weights and biases
    drawn from numpy, as nested f32 numpy."""
    tree = jax.tree.map(np.asarray, JTransformer(jhf.config_from_hf(TINY_HF[kind])).init(
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


@pytest.fixture(scope="module", params=KINDS)
def models(request):
    kind = request.param
    tree = _tree(kind)
    jm = JTransformer(jhf.config_from_hf(TINY_HF[kind]))
    tm = Transformer(config_from_hf(TINY_HF[kind]), device="cpu")
    state = params_from_numpy(tree)
    tm.load_params(state)
    return kind, jm, jax.tree.map(jnp.asarray, tree), tm, state


def _cfg(cls, decode_kernel, **kw):
    return cls(dtype="float32", max_seq_len=64, kv_block_size=8, num_kv_blocks=40,
               decode_kernel=decode_kernel,
               serving={"token_budget": 16, "max_running": 4, "chunk_min": 4}, **kw)


def _engines(models, decode_kernel):
    _, jm, jp, tm, state = models
    return (JEngine(jm, jp, _cfg(JConfig, decode_kernel)),
            InferenceEngineV2(tm, state, _cfg(InferenceConfig, decode_kernel), device="cpu"))


def _prompts(seed, lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 90, size=int(n)).tolist() for n in lengths]


# ---------------------------------------------------------------------------
# Configs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("hf", [PHI3_MINI, PYTHIA_2B8], ids=KINDS)
def test_config_from_hf_matches_jax_field_for_field(hf):
    got, want = config_from_hf(hf), jhf.config_from_hf(hf)
    for f in dataclasses.fields(got):
        assert getattr(got, f.name) == getattr(want, f.name), f.name
    ttf.check_servable(got)


def test_published_widths_and_parameter_counts():
    phi, py = config_from_hf(PHI3_MINI), config_from_hf(PYTHIA_2B8)
    assert (phi.n_heads, phi.kv_heads, phi.head_dim, phi.ff_dim) == (32, 32, 96, 8192)
    assert phi.activation == "swiglu" and phi.norm == "rmsnorm" and not phi.tie_embeddings
    assert (py.n_heads, py.head_dim, py.rotary_dims, py.ff_dim) == (32, 80, 20, 10240)
    assert py.parallel_block and py.attn_qkv_bias and py.activation == "gelu"
    for cfg, hf, n in ((phi, PHI3_MINI, 3_821_079_552), (py, PYTHIA_2B8, 2_775_208_960)):
        shapes = jax.eval_shape(JTransformer(jhf.config_from_hf(hf)).init, jax.random.PRNGKey(0))
        # the JAX init keeps layernorm biases under RMSNorm too, which it never reads
        leaves = [(jax.tree_util.keystr(p), s) for p, s in
                  jax.tree_util.tree_flatten_with_path(shapes)[0]]
        read = [s for p, s in leaves if cfg.norm == "layernorm" or "ln" not in p or "_b'" not in p]
        assert sum(int(np.prod(s.shape)) for s in read) == param_count(cfg) == n
    # both serve on the fused path as the JAX package decides it
    assert ttf.decode_fusion_eligibility(phi) == {"qkv": None, "mlp": None}
    assert ttf.decode_fusion_eligibility(py)["qkv"] is None
    assert ttf.decode_fusion_eligibility(py)["mlp"] is not None


# ---------------------------------------------------------------------------
# The plain B2 / B3 / B5 at head dims 80 and 96 against the Pallas kernels
# ---------------------------------------------------------------------------

#: (H, KV, Dh): GQA at 96, MHA at 80, then the head-chunk edges (a decode
#: block takes 1024 // Dh heads: 12 at 80, 10 at 96; a one-head last chunk)
GROUPS = [(4, 2, 96), (2, 2, 80), (13, 1, 80), (11, 1, 96)]
GROUP_IDS = ["gqa-96", "mha-80", "g13x80", "g11x96"]
POOLS = ["bf16", "int8", "fp8"]


@pytest.mark.parametrize("pool", POOLS)
@pytest.mark.parametrize("H,KV,Dh", GROUPS, ids=GROUP_IDS)
def test_paged_decode_plain_matches_pallas(H, KV, Dh, pool):
    bs, nblk = 16, 16
    rng = np.random.default_rng(H + KV + Dh)
    lens = np.asarray([37, 1, 50], np.int32)
    table = _table(lens, bs, nblk, rng)
    q = rng.standard_normal((len(lens), 1, H, Dh)).astype(np.float32)
    sl = _slopes(H, pool == "int8")   # slopes ride one pool form a group
    (tq, tk, tv, tsc), (jq, jk, jv, jsc) = _operands(pool, q, nblk, KV, bs, Dh, seed=Dh)
    got = tpa.paged_decode_reference(tq, tk, tv, T(table), T(lens), p_f32=True,
                                     alibi_slopes=None if sl is None else T(sl), **tsc)
    want = jpa.paged_decode_attention_pallas(
        jq, jk, jv, jnp.asarray(table), jnp.asarray(lens),
        alibi_slopes=None if sl is None else jnp.asarray(sl), interpret=True, **jsc)
    assert _close(got, want, pool)
    # the bites: the softmax scale of another head dim, the columns shifted by one
    other = 64 if Dh == 80 else 128
    bad = tpa.paged_decode_reference(tq * (Dh / other) ** 0.5, tk, tv, T(table), T(lens),
                                     p_f32=True, alibi_slopes=None if sl is None else T(sl),
                                     **tsc)
    assert not _close(bad, want, pool)
    assert not _close(got.roll(1, dims=-1), want, pool)


@pytest.mark.parametrize("pool", POOLS)
@pytest.mark.parametrize("H,KV,Dh", GROUPS, ids=GROUP_IDS)
def test_paged_extend_plain_matches_pallas(H, KV, Dh, pool):
    C, bs, nblk = 8, 16, 16
    rng = np.random.default_rng(40 + H + KV + Dh)
    start = np.asarray([5, 0], np.int32)
    nnew = np.asarray([8, 3], np.int32)
    table = _table(start + nnew, bs, nblk, rng)
    q = rng.standard_normal((2, C, H, Dh)).astype(np.float32)
    sl = _slopes(H, pool == "fp8")   # slopes ride one pool form a group
    (tq, tk, tv, tsc), (jq, jk, jv, jsc) = _operands(pool, q, nblk, KV, bs, Dh, seed=Dh + 1)
    got = tpa.paged_extend_reference(tq, tk, tv, T(table), T(start), T(nnew), p_f32=True,
                                     alibi_slopes=None if sl is None else T(sl), **tsc)
    want = jpa.paged_extend_attention_pallas(
        jq, jk, jv, jnp.asarray(table), jnp.asarray(start), jnp.asarray(nnew),
        alibi_slopes=None if sl is None else jnp.asarray(sl), interpret=True, **jsc)
    want = np.asarray(jnp.asarray(want, jnp.float32))
    for b in range(2):   # rows past nnew are padding the engine never reads
        assert _close(got[b, :nnew[b]], want[b, :nnew[b]], pool)


@pytest.mark.parametrize("pool", POOLS)
@pytest.mark.parametrize("H,KV,Dh", GROUPS, ids=GROUP_IDS)
def test_split_decode_plain_matches_pallas(H, KV, Dh, pool):
    bs, nblk = 16, 16
    rng = np.random.default_rng(70 + H + KV + Dh)
    lens = np.asarray([33, 47, 5], np.int32)
    table = _table(lens, bs, nblk, rng)
    q = rng.standard_normal((3, 1, H, Dh)).astype(np.float32)
    sl = _slopes(H, pool == "bf16")   # slopes ride one pool form a group
    (tq, tk, tv, tsc), (jq, jk, jv, jsc) = _operands(pool, q, nblk, KV, bs, Dh, seed=Dh + 2)
    got = tfd.fused_paged_decode_attention(tq, tk, tv, T(table), T(lens), num_splits=3,
                                           alibi_slopes=None if sl is None else T(sl), **tsc)
    want = jfd.fused_paged_decode_attention_pallas(
        jq, jk, jv, jnp.asarray(table), jnp.asarray(lens),
        alibi_slopes=None if sl is None else jnp.asarray(sl), num_splits=3,
        interpret=True, **jsc)
    assert _close(got, want, pool)


@pytest.mark.parametrize("H,KV,Dh,chunk", [(13, 1, 80, (13, 1)), (11, 1, 96, (11, 1)),
                                           (32, 32, 96, (1, 1)), (12, 1, 80, (12, 1)),
                                           (130, 1, 80, (128, 2))],
                         ids=["g13x80", "g11x96", "phi-3-mini", "g12x80", "g130x80"])
def test_decode_head_chunks_at_the_new_dims(H, KV, Dh, chunk):
    """A decode block takes the whole group in one pass up to 128 heads at
    80 and 96 (two passes past that); the split count is B2's positions per
    split in whole table entries, whatever the group."""
    per, n = tpa.decode_passes(H // KV, Dh)
    assert (per, n) == chunk and per <= tpa.DECODE_PASS_HEADS[Dh]
    spb = max(1, tpa.decode_splits(8, KV, 32, 64, 132)[1] // 64)
    assert tfd.attention_splits(8, KV, 32, 64, 132) == tfd.split_count(32, -(-32 // spb))[0]


# ---------------------------------------------------------------------------
# B4 at rd 20 of 80 and the flash forward at 80 / 96
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pooled", [True, False], ids=["pool", "no-pool"])
@pytest.mark.parametrize("H,KV,Dh,rd", [(2, 2, 80, 20), (2, 2, 96, 96)],
                         ids=["pythia-rd20-of-80", "phi-full-96"])
def test_qkv_plain_matches_pallas(H, KV, Dh, rd, pooled):
    rng = np.random.default_rng(Dh + rd)
    B, D, bs = 3, 64, 8
    y = rng.standard_normal((B, D)).astype(np.float32)
    w = [(rng.standard_normal((D, n * Dh)) * D ** -0.5).astype(np.float32) for n in (H, KV, KV)]
    b = [(0.1 * rng.standard_normal(n * Dh)).astype(np.float32) for n in (H, KV, KV)]
    pos = np.asarray([5, 17, 30], np.int32)
    table = np.arange(B * 4, dtype=np.int32).reshape(B, 4) + 1
    pool = [rng.standard_normal((B * 4 + 1, KV, bs, Dh)).astype(np.float32) for _ in range(2)]
    cos_t, sin_t = jtf.rope_table(64, rd, 10000.0)
    cos, sin = np.asarray(cos_t)[pos], np.asarray(sin_t)[pos]
    blk = table[np.arange(B), pos // bs]
    jkw = dict(pool_k=jnp.asarray(pool[0]), pool_v=jnp.asarray(pool[1]), blk=jnp.asarray(blk),
               off=jnp.asarray(pos % bs)) if pooled else {}
    want = jfd.fused_qkv_rope_pallas(jnp.asarray(y), *(jnp.asarray(m) for m in w),
                                     *(jnp.asarray(x) for x in b), cos=jnp.asarray(cos),
                                     sin=jnp.asarray(sin), n_heads=H, kv_heads=KV,
                                     interpret=True, **jkw)
    pk, pv = T(pool[0].copy()), T(pool[1].copy())
    tkw = dict(pool_k=pk, pool_v=pv, block_table=T(table), pos=T(pos)) if pooled else {}
    got = tfd.fused_qkv_rope(T(y), *(T(m) for m in w), T(cos), T(sin), n_heads=H,
                             kv_heads=KV, bq=T(b[0]), bk=T(b[1]), bv=T(b[2]), **tkw)
    got = list(got) + ([pk, pv] if pooled else [])
    for g, wt in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wt).reshape(g.shape), rtol=F32_TOL,
                                   atol=F32_TOL)
    if rd < Dh:   # the pass-through columns stay as projected
        q0 = (y @ w[0] + b[0]).reshape(B, H, Dh)
        np.testing.assert_allclose(got[0].numpy()[..., rd:], q0[..., rd:], rtol=F32_TOL,
                                   atol=F32_TOL)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("H,KV,Dh", [(2, 2, 96), (4, 2, 80)], ids=["mha-96", "gqa-80"])
def test_flash_plain_matches_jax_reference(H, KV, Dh, causal):
    rng = np.random.default_rng(Dh)
    q, k, v = (rng.standard_normal((2, 70, n, Dh)).astype(np.float32) for n in (H, KV, KV))
    got = tfa.flash_attention(T(q), T(k), T(v), causal=causal).numpy()
    want = jreference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal)
    np.testing.assert_allclose(got, np.asarray(want), rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("Dh,item", [(80, "item 4 \\(h\\): training at head dims 80 and 96"),
                                     (96, "item 4 \\(h\\): training at head dims 80 and 96"),
                                     (72, "item 4 \\(h\\)")])
def test_refusals_that_stay_name_their_item(Dh, item, monkeypatch):
    """On a CUDA tensor the wrappers check before any launch (the device
    checks stubbed here): B2 / B3 / B5 and the flash forward take 80 and
    96, the flash backward refuses them naming item 4 (h), and a head dim
    that is no multiple of 16 is refused by every kernel, naming it."""
    for mod in (tpa, tfd):
        monkeypatch.setattr(mod, "pool_kind", lambda *a, **k: 0)
    q = torch.zeros(1, 8, 2, Dh, dtype=torch.bfloat16)
    pool = torch.zeros(2, 2, 16, Dh, dtype=torch.bfloat16)
    lens = torch.ones(1, dtype=torch.int32)
    refused = pytest.raises(ValueError, match=f"head_dim {Dh} not built .*{item}")
    if Dh % 16 == 0:
        tfa.check_operands(q, q, q)
        assert tpa._check_operands(q[:, :1], pool, pool) == 0
    else:
        for check in (lambda: tfa.check_operands(q, q, q),
                      lambda: tpa._check_operands(q[:, :1], pool, pool),
                      lambda: tfd._launch_attention(q[:, :1], pool, pool, lens[:, None], lens,
                                                    None)):
            with pytest.raises(ValueError, match=f"head_dim {Dh} not built .*item 4 \\(h\\)"):
                check()
    with refused:
        tfa.check_operands(q, q, q, backward=True, out=q, dout=q)


# ---------------------------------------------------------------------------
# The engines against the JAX engines
# ---------------------------------------------------------------------------


@pytest.fixture
def routes(monkeypatch):
    """JAX's fused kernels in interpret mode; per fused kernel, JAX's traces
    and the port wrapper's calls."""
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


def _check_routes(counts, kind):
    for key in JAX_KERNELS:
        assert (counts["jax"][key] > 0) == (key in FUSED[kind]), counts
        assert (counts["port"][key] > 0) == (key in FUSED[kind]), counts


@pytest.mark.parametrize("decode_kernel", ["xla", "pallas"])
def test_step_schedule_and_serve_match_jax(models, decode_kernel, request):
    """The ``step()`` schedule's logits within 1e-4 (extend, mixed, decode
    ticks and a new uid mid-decode), then, on the same engines, the
    scheduler's tokens equal."""
    counts = request.getfixturevalue("routes") if decode_kernel == "pallas" else None
    je, te = _engines(models, decode_kernel)
    assert je._decode_kernel == te._decode_kernel == decode_kernel
    p = _prompts(0, (12, 5, 22))
    toks = np.random.default_rng(9).integers(1, 90, size=16).tolist()
    schedule = [
        ([], [], [(0, p[0][:10]), (1, p[1])]),                      # extend only
        ([1], toks[:1], [(0, p[0][10:]), (2, p[2][:8])]),           # mixed
        ([0, 1], toks[1:3], [(2, p[2][8:])]),                       # mixed
        ([0, 1, 2], toks[3:6], []),                                 # decode only
        ([2], toks[8:9], [(3, p[1][:3])]),                          # a new uid mid-decode
    ]
    for tick in schedule:
        jd, jpl = je.step(*tick)
        td, tpl = te.step(*tick)
        np.testing.assert_allclose(td, jd, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(tpl, jpl, rtol=TOL, atol=TOL)
    je.flush([0, 1, 2, 3])     # the serve reuses the schedule's engines (and programs)
    te.flush([0, 1, 2, 3])
    prompts = _prompts(2, (7, 12, 5))
    want = JScheduler(je).serve(prompts, max_new_tokens=6)
    assert ContinuousBatchingScheduler(te).serve(prompts, max_new_tokens=6) == want
    if counts is not None:
        _check_routes(counts, models[0])


@pytest.mark.parametrize("decode_kernel", ["xla", "pallas"])
def test_put_decode_loop_and_v1_generate_match_jax(models, decode_kernel, request):
    """``put()`` logits within 1e-4 and ``decode_loop`` tokens exact, then
    the v1 ``generate`` (B4 without a pool on "pallas") tokens exact."""
    counts = request.getfixturevalue("routes") if decode_kernel == "pallas" else None
    kind, jm, jp, tm, state = models
    je, te = _engines(models, decode_kernel)
    prompts = _prompts(4, (9, 20, 3))
    uids = [0, 1, 2]
    lt, lj = te.put(uids, prompts), je.put(uids, prompts)
    np.testing.assert_allclose(lt, lj, rtol=TOL, atol=TOL)
    first = [int(np.argmax(r)) for r in lt]
    np.testing.assert_array_equal(te.decode_loop(uids, first, 6),
                                  je.decode_loop(uids, first, 6))
    cfg = dict(dtype="float32", max_seq_len=64, decode_kernel=decode_kernel)
    je1, te1 = JEngineV1(jm, jp, JConfig(**cfg)), init_inference(tm, state, cfg, device="cpu")
    rng = np.random.default_rng(11)
    ids = rng.integers(1, 90, size=(3, 13)).astype(np.int32)
    lens = np.asarray([13, 6, 9], np.int32)
    ids[1, 6:] = 0
    ids[2, 9:] = 0
    np.testing.assert_array_equal(te1.generate(ids, prompt_lengths=lens, max_new_tokens=10),
                                  je1.generate(ids, prompt_lengths=lens, max_new_tokens=10))
    if counts is not None:
        _check_routes(counts, kind)


# ---------------------------------------------------------------------------
# Launch accounting, with the kernel gate opened onto the plain versions
# ---------------------------------------------------------------------------


@pytest.fixture
def counted(counted_port, monkeypatch):
    """``counted_port`` with the RMSNorm kernel's gate opened onto its plain
    version too (Phi-3-mini's unfused norms)."""
    rn = importlib.import_module("shuffle_exchange_tpu_torch.ops.rmsnorm")
    monkeypatch.setattr(rn, "use_kernel", lambda t: True)

    def norm(x, w, eps, residual):
        rn.rmsnorm.launches += 1
        return rn.rmsnorm_reference(x, w, eps)

    monkeypatch.setattr(rn, "_launch", norm)
    return counted_port


@pytest.mark.parametrize("decode_kernel", ["pallas", "xla"])
def test_launch_counters_follow_the_programs(models, counted, decode_kernel):
    """Per layer and decode row on "pallas": B4 and B5, and B6 on
    Phi-3-mini (never on Pythia's exact gelu); "xla" decode rows B2. Chunk
    rows the extend kernel; prefill rows the flash kernel; RMSNorm only on
    Phi-3-mini (its unfused norms), never on the layernorm family."""
    kind, *_ = models
    _, te = _engines(models, decode_kernel)
    prompts = _prompts(4, (9, 20, 3))
    uids = [0, 1, 2]
    first = [int(np.argmax(r)) for r in te.put(uids, prompts)]
    te.decode_loop(uids, first, 3)
    te.put([1], [_prompts(5, (11,))[0]])
    by = te.dispatches_by_program
    L, fused = 2, decode_kernel == "pallas"
    dec = by.get("decode", 0) + by.get("mixed", 0) + 3
    ext = by.get("extend", 0) + by.get("mixed", 0)
    pre = by["prefill"]
    want = {k: 0 for k in counted.KERNEL_WRAPPERS}
    want.update(flash_attention=L * pre, paged_extend_attention=L * ext,
                paged_decode_attention=0 if fused else L * dec,
                fused_paged_decode_attention=L * dec if fused else 0,
                fused_qkv_rope=L * dec if fused else 0)
    if kind == "phi-3-mini":   # B6 takes the MLP's norm; each layer's first norm and the final one stay
        want.update(fused_mlp=L * dec if fused else 0,
                    rmsnorm=(2 * L + 1) * (ext + pre) + ((L + 1) if fused else (2 * L + 1)) * dec)
    assert counted.launch_counts() == want
