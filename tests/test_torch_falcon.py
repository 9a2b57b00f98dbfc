"""Falcon serving (multi-query, the 40B's grouped queries, falcon-rw's ALiBi)
of the PyTorch port against the JAX package, on the CPU, in f32.

Three tinies, each ``config_from_hf`` of its published config shrunk to
d 128 (d 64 for falcon-rw), 2 layers and a 96-word vocabulary: Falcon-7B's
multi-query attention (8 query heads over one kv head, a shared-layernorm
parallel block, full rotate-half RoPE, exact gelu, no biases, tied
embeddings), Falcon-40B's ``new_decoder_architecture`` (8 query heads over
2 kv heads, two parallel layernorms) and falcon-rw's sequential ALiBi
blocks (slopes scaled by ``Dh ** -0.5``, every bias). Each gets the JAX
init with every norm weight and bias drawn from numpy, so a dropped bias or
a misplaced norm shows. Held to the JAX package:

- ``config_from_hf`` field for field on the three published configs, and
  Falcon-7B's 6,921,720,704 parameters from its shapes; the leaves and the
  converter both ways bit for bit in each form;
- the plain B2, B3 and B5 at Falcon-7B's group (71 query heads of 64 over
  one kv head) and at the edge groups (16 and 17 heads of 64, 9 of 128, 5
  of 256; B3 also 65 of 64), over bf16, int8 and fp8 pools, against the
  Pallas kernels in interpret mode: f32 and the one-byte pools within 1e-5
  (another summation order), bf16 within one bf16 step (2^-7 of |want|
  plus 1e-5) with the plain versions' P in f32;
- the engines: ``step()`` and ``put()`` logits within 1e-4, ``serve()``,
  ``decode_loop`` and the v1 ``generate`` tokens exact, on "xla" and on
  "pallas" with JAX's kernels in interpret mode (``SXT_FUSED_INTERPRET``).
  The ``routes`` fixture counts JAX's Pallas traces and the port wrappers'
  calls: every form reaches B4 and B5 and never B6 (exact gelu keeps the
  MLP on the layer body, as in JAX);
- the launch counters with the kernel gate opened onto the plain versions:
  B4 + B5 per layer and decode row on "pallas", B2 on "xla", never B6.
"""

import dataclasses
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
from shuffle_exchange_tpu.models import hf as jhf
from shuffle_exchange_tpu_torch.inference import (ContinuousBatchingScheduler, InferenceConfig,
                                                  InferenceEngineV2, init_inference)
from shuffle_exchange_tpu_torch.inference import paged as tpaged
from shuffle_exchange_tpu_torch.models import (Transformer, config_from_hf, param_count,
                                               params_from_numpy, params_to_numpy)
from shuffle_exchange_tpu_torch.models import transformer as ttf

jpa = importlib.import_module("shuffle_exchange_tpu.ops.paged_attention")
jfd = importlib.import_module("shuffle_exchange_tpu.ops.fused_decode")
tpa = importlib.import_module("shuffle_exchange_tpu_torch.ops.paged_attention")
tfd = importlib.import_module("shuffle_exchange_tpu_torch.ops.fused_decode")
tfa = importlib.import_module("shuffle_exchange_tpu_torch.ops.flash_attention")
tal = importlib.import_module("shuffle_exchange_tpu_torch.ops.alibi_attention")
tie = importlib.import_module("shuffle_exchange_tpu_torch.inference.engine")
tie2 = importlib.import_module("shuffle_exchange_tpu_torch.inference.engine_v2")

T = torch.from_numpy
TOL = 1e-4           # engines: f32 matmuls and softmax in another order
F32_TOL = 1e-5       # plain kernels against the Pallas kernels: f32, another order

# the published configs (tiiuae/falcon-7b, tiiuae/falcon-40b,
# tiiuae/falcon-rw-1b), as the fields config_from_hf reads them
FALCON_7B = {"architectures": ["FalconForCausalLM"], "model_type": "falcon", "alibi": False,
             "bias": False, "hidden_size": 4544, "layer_norm_epsilon": 1e-5,
             "multi_query": True, "new_decoder_architecture": False,
             "num_attention_heads": 71, "num_hidden_layers": 32, "parallel_attn": True,
             "vocab_size": 65024}
FALCON_40B = {"architectures": ["FalconForCausalLM"], "model_type": "falcon", "alibi": False,
              "bias": False, "hidden_size": 8192, "layer_norm_epsilon": 1e-5,
              "new_decoder_architecture": True, "num_attention_heads": 128,
              "num_kv_heads": 8, "num_hidden_layers": 60, "parallel_attn": True,
              "vocab_size": 65024}
FALCON_RW_1B = {"architectures": ["FalconForCausalLM"], "model_type": "falcon", "alibi": True,
                "bias": True, "hidden_size": 2048, "layer_norm_epsilon": 1e-5,
                "multi_query": False, "new_decoder_architecture": False,
                "num_attention_heads": 32, "num_hidden_layers": 24, "parallel_attn": False,
                "vocab_size": 50304}
_SMALL = dict(num_hidden_layers=2, vocab_size=96, max_position_embeddings=64)
TINY_HF = {"falcon-7b": dict(FALCON_7B, hidden_size=128, num_attention_heads=8, **_SMALL),
           "falcon-40b": dict(FALCON_40B, hidden_size=128, num_attention_heads=8,
                              num_kv_heads=2, **_SMALL),
           "falcon-rw": dict(FALCON_RW_1B, hidden_size=64, num_attention_heads=4, **_SMALL)}
KINDS = list(TINY_HF)
#: every form's "pallas" decode: B4 (rotate-half RoPE, or none under ALiBi)
#: and B5; exact gelu keeps the MLP on the layer body
FUSED = {"qkv", "attention"}
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
# Configs, leaves, the converter
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("hf", [FALCON_7B, FALCON_40B, FALCON_RW_1B],
                         ids=["falcon-7b", "falcon-40b", "falcon-rw-1b"])
def test_config_from_hf_matches_jax_field_for_field(hf):
    got, want = config_from_hf(hf), jhf.config_from_hf(hf)
    for f in dataclasses.fields(got):
        assert getattr(got, f.name) == getattr(want, f.name), f.name
    ttf.check_servable(got)
    # training takes the parallel forms as serving does
    ttf.check_supported(got)


def test_published_widths_and_parameter_counts():
    f7, f40, rw = (config_from_hf(h) for h in (FALCON_7B, FALCON_40B, FALCON_RW_1B))
    assert (f7.n_heads, f7.kv_heads, f7.head_dim, f7.ff_dim) == (71, 1, 64, 18176)
    assert f7.parallel_block and f7.parallel_shared_ln and not f7.mlp_bias
    assert (f40.kv_heads, f40.head_dim) == (8, 64) and not f40.parallel_shared_ln
    assert rw.position == "alibi" and not rw.parallel_block and rw.mlp_bias
    assert rw.alibi_slope_scale == 64 ** -0.5
    shapes = jax.eval_shape(JTransformer(jhf.config_from_hf(FALCON_7B)).init,
                            jax.random.PRNGKey(0))
    assert sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes)) == param_count(f7)
    assert param_count(f7) == 6_921_720_704


@pytest.mark.parametrize("kind", KINDS)
def test_leaves_and_the_converter_round_trip_bit_for_bit(kind):
    tree = jax.tree.map(np.asarray, JTransformer(jhf.config_from_hf(TINY_HF[kind])).init(
        jax.random.PRNGKey(3)))
    model = Transformer(config_from_hf(TINY_HF[kind]), device="cpu")
    state = params_from_numpy(tree)
    assert {k: tuple(v.shape) for k, v in state.items()} == model.param_shapes()
    assert ("layers.ln2_w" in state) == (kind != "falcon-7b")
    assert ("layers.b_up" in state) == (kind == "falcon-rw")
    assert sum(v.numel() for v in state.values()) == param_count(model.config)
    back = params_to_numpy(state)
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        node = back
        for key in path:
            node = node[key.key]
        np.testing.assert_array_equal(node, leaf)


# ---------------------------------------------------------------------------
# The wide-group plain B2 / B3 / B5 against the Pallas kernels
# ---------------------------------------------------------------------------

#: (H, KV, Dh): Falcon-7B's group, then the edge groups of the kernels'
#: head chunks (1024 / Dh heads a decode block): 16 x 64 exactly one chunk
#: (Falcon-40B's group), 17 x 64 a one-head last chunk, 9 x 128, 5 x 256
GROUPS = [(71, 1, 64), (16, 1, 64), (17, 1, 64), (9, 1, 128), (10, 2, 256)]
GROUP_IDS = ["falcon-7b-71x64", "g16x64", "g17x64", "g9x128", "g5x256"]
POOLS = ["bf16", "int8", "fp8"]
QDTYPES = {"int8": (torch.int8, jnp.int8), "fp8": (torch.float8_e4m3fn, jnp.float8_e4m3fn)}


def _one_bf16_step(got, want) -> bool:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return bool((np.abs(got - want) <= 2 ** -7 * np.abs(want) + 1e-5).all())


def _table(lens, bs, nblk, rng):
    """A -1-padded table of shuffled blocks (block 0 is scratch)."""
    nb = [-(-int(n) // bs) for n in lens]
    ids = rng.permutation(np.arange(1, nblk)).tolist()
    table = np.full((len(lens), max(nb) + 1), -1, np.int32)
    for b, n in enumerate(nb):
        table[b, :n] = [ids.pop() for _ in range(n)]
    return table


def _operands(pool, q, nblk, KV, bs, Dh, seed):
    """(port q, pools, scale kwargs), (JAX q, pools, scale kwargs) holding
    the same values: bf16 q and pools, or f32 q over int8 / fp8 pools with
    their scale planes."""
    rng = np.random.default_rng(seed)
    x = [rng.standard_normal((nblk, KV, bs, Dh)).astype(np.float32) for _ in range(2)]
    if pool == "bf16":
        tq, tk, tv = (T(a).bfloat16() for a in (q, *x))
        jq, jk, jv = (jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (tq, tk, tv))
        return (tq, tk, tv, {}), (jq, jk, jv, {})
    (tk, ks), (tv, vs) = (tpaged.quantize_kv(T(a), QDTYPES[pool][0]) for a in x)
    jk, jv = (jnp.asarray(t.float().numpy()).astype(QDTYPES[pool][1]) for t in (tk, tv))
    return ((T(q), tk, tv, dict(k_scale=ks, v_scale=vs)),
            (jnp.asarray(q), jk, jv, dict(k_scale=jnp.asarray(ks.numpy()),
                                          v_scale=jnp.asarray(vs.numpy()))))


def _close(got, want, pool):
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    if pool == "bf16":
        return _one_bf16_step(got, want)
    return np.allclose(got, want, rtol=F32_TOL, atol=F32_TOL)


def _slopes(H, alibi, scale=1.0):
    return (ttf.alibi_slopes(H) * scale).astype(np.float32) if alibi else None


@pytest.mark.parametrize("pool", POOLS)
@pytest.mark.parametrize("H,KV,Dh", GROUPS, ids=GROUP_IDS)
def test_wide_group_paged_decode_plain_matches_pallas(H, KV, Dh, pool):
    bs, nblk = 16, 16
    rng = np.random.default_rng(H + KV + Dh)
    lens = np.asarray([37, 1, 50], np.int32)
    table = _table(lens, bs, nblk, rng)
    q = rng.standard_normal((len(lens), 1, H, Dh)).astype(np.float32)
    alibi = Dh == 64 and pool == "int8"        # slopes ride one pool form a group
    sl = _slopes(H, alibi)
    (tq, tk, tv, tsc), (jq, jk, jv, jsc) = _operands(pool, q, nblk, KV, bs, Dh, seed=Dh)
    got = tpa.paged_decode_reference(tq, tk, tv, T(table), T(lens), p_f32=True,
                                     alibi_slopes=None if sl is None else T(sl), **tsc)
    want = jpa.paged_decode_attention_pallas(
        jq, jk, jv, jnp.asarray(table), jnp.asarray(lens),
        alibi_slopes=None if sl is None else jnp.asarray(sl), interpret=True, **jsc)
    assert _close(got, want, pool)
    # the bite: each query head reading its neighbour's q
    bad = tpa.paged_decode_reference(tq.roll(1, dims=2), tk, tv, T(table), T(lens), p_f32=True,
                                     alibi_slopes=None if sl is None else T(sl), **tsc)
    assert not _close(bad, want, pool)


@pytest.mark.parametrize("pool", POOLS)
@pytest.mark.parametrize("H,KV,Dh", GROUPS + [(65, 1, 64)], ids=GROUP_IDS + ["g65x64"])
def test_wide_group_paged_extend_plain_matches_pallas(H, KV, Dh, pool):
    C, bs, nblk = 8, 16, 16
    rng = np.random.default_rng(40 + H + KV + Dh)
    start = np.asarray([5, 0], np.int32)
    nnew = np.asarray([8, 3], np.int32)
    table = _table(start + nnew, bs, nblk, rng)
    q = rng.standard_normal((2, C, H, Dh)).astype(np.float32)
    sl = _slopes(H, Dh == 64 and pool == "int8")
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
@pytest.mark.parametrize("H,KV,Dh,splits", [(*g, 3) for g in GROUPS] + [(71, 1, 64, 1)],
                         ids=[f"{i}-3" for i in GROUP_IDS] + [f"{GROUP_IDS[0]}-1"])
def test_wide_group_split_decode_plain_matches_pallas(H, KV, Dh, splits, pool):
    bs, nblk = 16, 16
    rng = np.random.default_rng(70 + H + KV + Dh + splits)
    lens = np.asarray([33, 47, 5], np.int32)
    table = _table(lens, bs, nblk, rng)
    q = rng.standard_normal((3, 1, H, Dh)).astype(np.float32)
    sl = _slopes(H, Dh == 64 and pool == "fp8")
    (tq, tk, tv, tsc), (jq, jk, jv, jsc) = _operands(pool, q, nblk, KV, bs, Dh, seed=Dh + 2)
    got = tfd.fused_paged_decode_attention(tq, tk, tv, T(table), T(lens), num_splits=splits,
                                           alibi_slopes=None if sl is None else T(sl), **tsc)
    want = jfd.fused_paged_decode_attention_pallas(
        jq, jk, jv, jnp.asarray(table), jnp.asarray(lens),
        alibi_slopes=None if sl is None else jnp.asarray(sl), num_splits=splits,
        interpret=True, **jsc)
    assert _close(got, want, pool)


@pytest.mark.parametrize("H,KV,Dh", GROUPS + [(8, 8, 128)], ids=GROUP_IDS + ["mha"])
def test_decode_head_chunks_and_split_counts(H, KV, Dh):
    """A decode block (B2 and B5) takes the whole group in one pass up to
    128 heads at head_dim <= 96 (64 above), walking its split again past
    that; B5's split count is B2's positions per split in whole table
    entries and does not depend on the group (Falcon-7B's 8 rows of 32
    entries of 64 positions on 132 SMs: 8 (sequence, kv head) blocks, so
    splits of 128 positions, 2 entries: 16 splits)."""
    G = H // KV
    per, n = tpa.decode_passes(G, Dh)
    assert (n - 1) * per < G <= n * per
    assert n == 1 and per == G   # every group here fits one pass
    for B, W in ((8, 32), (1, 32), (8, 4)):
        splits = tfd.attention_splits(B, KV, W, 64, 132)
        spb = max(1, tpa.decode_splits(B, KV, W, 64, 132)[1] // 64)
        assert splits == tfd.split_count(W, -(-W // spb))[0]
        assert (splits - 1) * spb < W <= splits * spb   # none empty, the table covered
    if (H, KV, Dh) == (71, 1, 64):
        assert tfd.attention_splits(8, 1, 32, 64, 132) == 16


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


def _check_routes(counts, kernels=("qkv", "attention", "mlp")):
    for key in kernels:
        assert (counts["jax"][key] > 0) == (key in FUSED), counts
        assert (counts["port"][key] > 0) == (key in FUSED), counts


def _routes_if(decode_kernel, request):
    return request.getfixturevalue("routes") if decode_kernel == "pallas" else None


@pytest.mark.parametrize("decode_kernel", ["xla", "pallas"])
def test_step_schedule_and_serve_match_jax(models, decode_kernel, request):
    """The ``step()`` schedule's logits within 1e-4 (extend, mixed, decode
    ticks and a new uid mid-decode), then, on the same engines, the
    scheduler's tokens equal (three prompts over a 16-token budget: chunked
    prefill beside decode rows)."""
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
        _check_routes(counts)


@pytest.mark.parametrize("decode_kernel", ["xla", "pallas"])
def test_put_decode_loop_and_v1_generate_match_jax(models, decode_kernel, request):
    """``put()`` logits within 1e-4 and ``decode_loop`` tokens exact, then
    the v1 ``generate`` (B4 without a pool on "pallas") tokens exact."""
    counts = _routes_if(decode_kernel, request)
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
        _check_routes(counts)


# ---------------------------------------------------------------------------
# Launch accounting, with the kernel gate opened onto the plain versions
# ---------------------------------------------------------------------------


@pytest.fixture
def counted_port(monkeypatch):
    """Every port wrapper takes its "kernel" branch with the plain version
    standing in for the launch, so the launch counters move as on the card."""
    from shuffle_exchange_tpu_torch import ops

    for m in (tfd, tpa, tfa, tal):
        monkeypatch.setattr(m, "use_kernel", lambda t: True)
    monkeypatch.setattr(tfd, "_launch_qkv", lambda y, wq, wk, wv, cos, sin, pk, pv, bt, pos, H,
                        KV, biases: tfd.fused_qkv_rope_reference(
                            y, wq, wk, wv, cos, sin, pk, pv, bt, pos, n_heads=H, kv_heads=KV,
                            bq=biases[0], bk=biases[1], bv=biases[2]))
    monkeypatch.setattr(tfd, "_launch_mlp", lambda *a, **k: tfd.fused_mlp_reference(*a, **k))
    monkeypatch.setattr(tfd, "_launch_attention", lambda q, ck, cv, bt, kl, n, sl=None:
                        tfd.fused_paged_decode_reference(q, ck, cv, bt, kl, 2 if n is None else n,
                                                         sl))
    monkeypatch.setattr(tpa, "_launch", lambda kind, q, ck, cv, bt, lens, sl=None: (
        tpa.paged_decode_reference(q, ck, cv, bt, lens, alibi_slopes=sl) if kind == "decode" else
        tpa.paged_extend_reference(q, ck, cv, bt, lens, torch.full_like(lens, q.shape[1]),
                                   alibi_slopes=sl)))
    monkeypatch.setattr(tfa, "_launch", lambda q, k, v, causal, seg, want_lse:
                        tfa.reference_attention_lse(q, k, v, causal, seg))
    monkeypatch.setattr(tfa, "check_operands", lambda *a, **k: None)
    monkeypatch.setattr(tal, "_launch", lambda q, k, v, slopes, want_lse:
                        tal.reference_alibi_attention_lse(q, k, v, slopes))
    for fn in ops.KERNEL_WRAPPERS.values():
        monkeypatch.setattr(fn, "launches", 0)
    return ops


@pytest.mark.parametrize("decode_kernel", ["pallas", "xla"])
def test_launch_counters_follow_the_programs(models, counted_port, decode_kernel):
    """Per layer and decode row on "pallas": B4 and B5, never B6 (exact
    gelu) nor RMSNorm (layernorm); "xla" decode rows B2. Chunk rows the
    extend kernel; prefill rows the flash kernel (falcon-rw: the ALiBi
    flash kernel)."""
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
    flash = "alibi_flash_attention" if kind == "falcon-rw" else "flash_attention"
    want = {k: 0 for k in counted_port.KERNEL_WRAPPERS}
    want.update({flash: L * by["prefill"]}, paged_extend_attention=L * ext,
                paged_decode_attention=0 if fused else L * dec,
                fused_paged_decode_attention=L * dec if fused else 0,
                fused_qkv_rope=L * dec if fused else 0)
    assert counted_port.launch_counts() == want
