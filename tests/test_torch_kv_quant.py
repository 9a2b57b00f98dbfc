"""int8 / fp8 KV serving of the PyTorch port against the JAX package.

The port's ``kv_cache_dtype`` "int8" / "fp8" (``inference/paged.py``,
``inference/engine_v2.py`` and the scale-plane forms of the paged
kernels' plain versions) meets the JAX package on the same inputs, made
with numpy from a seed:

- ``quantize_kv``: stored bytes (viewed as uint8) and scales bit-equal to
  JAX's for int8 and e4m3, zero rows and rows whose absmax sits at the
  storage maximum included; ``pool_nbytes`` equal to JAX's;
- the three pool writes (the prefill scatter, the chunk scatter, the
  decode append) leave bytes and scales equal to JAX's same writes on
  equal rows; on whole engines in f32 the stored bytes are equal to
  JAX's and the scales equal to f32 rounding (the K/V projections of the
  two frameworks differ in their last bits, and so do their absmax);
- plain B2 / B3 / B5 over the planes (MHA and GQA, with and without ALiBi
  slopes, B5 at 1, 2 and 4 splits) against the JAX Pallas kernels in
  interpret mode, within 1e-5 (f32, another summation order);
- f32 engines in each mode: one-shot ``put()`` logits bit-equal to the
  port's own bf16 mode (the prefill attends the prompt's full-precision
  K/V) and within 1e-4 of JAX's, ``decode_loop`` tokens equal to JAX's
  and decode logits within 1e-4, ``step()`` schedules within 1e-4, the
  scheduler's tokens equal to JAX's scheduler, "pallas" tokens equal to
  "xla" (JAX ``tests/test_kv_quant.py``'s contract) and to JAX's "pallas"
  engine with its fused kernels in interpret mode;
- a BLOOM-shaped tiny (ALiBi, layernorm, biases) over int8 KV, and the
  ``tiny_moe`` int8-KV serve of JAX ``tests/test_moe_serving.py``.

The model and config shapes are those of ``tests/test_kv_quant.py`` so the
JAX programs come from the compile cache that file fills. The CUDA
kernels run only on the card (``chip_smoke.py`` phase 2k).
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
from shuffle_exchange_tpu.inference import engine as jengine
from shuffle_exchange_tpu.inference import paged as jpaged
from shuffle_exchange_tpu.models import Transformer as JTransformer
from shuffle_exchange_tpu.models import tiny as jtiny
from shuffle_exchange_tpu.models.transformer import tiny_moe as jtiny_moe
from shuffle_exchange_tpu_torch.config.config_utils import ConfigError
from shuffle_exchange_tpu_torch.inference import (ContinuousBatchingScheduler, InferenceConfig,
                                                  InferenceEngineV2, init_inference)
from shuffle_exchange_tpu_torch.inference import paged as tpaged
from shuffle_exchange_tpu_torch.models import Transformer, params_from_numpy, tiny, tiny_moe
from shuffle_exchange_tpu_torch.models import transformer as ttf

jpa = importlib.import_module("shuffle_exchange_tpu.ops.paged_attention")
jfd = importlib.import_module("shuffle_exchange_tpu.ops.fused_decode")
tpa = importlib.import_module("shuffle_exchange_tpu_torch.ops.paged_attention")
tfd = importlib.import_module("shuffle_exchange_tpu_torch.ops.fused_decode")
tie2 = importlib.import_module("shuffle_exchange_tpu_torch.inference.engine_v2")

T = torch.from_numpy
F32_TOL = 1e-5       # plain kernels against the Pallas kernels: f32, another order
ENGINE_TOL = 1e-4    # engines: f32 matmuls and softmax in another order
MODES = ["int8", "fp8"]
QDTYPES = {"int8": (torch.int8, jnp.int8), "fp8": (torch.float8_e4m3fn, jnp.float8_e4m3fn)}
MODEL = dict(vocab=97, d=32, layers=2, heads=4, seq=128, activation="swiglu",
             norm="rmsnorm", position="rope", n_kv_heads=2, tie_embeddings=False)
#: the fused-path model of JAX ``test_engine_fused_pallas_path_quantized``
#: (head_dim 16 keeps the layer eligible for the fused QKV kernel)
FUSED_MODEL = dict(MODEL, d=64)


def _bytes(x):
    """A storage tensor or array as uint8 (one-byte kinds) or itself."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.uint8).numpy() if x.element_size() == 1 else x.numpy()
    x = np.asarray(x)
    return x.view(np.uint8) if x.dtype.itemsize == 1 else x


def _rows(kind, seed, shape=(5, 3, 64)):
    """f32 rows to quantize: random, with zero rows, or with rows whose
    absmax is exactly the storage maximum (scale 1)."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * rng.uniform(0.01, 30, shape[:-1])[..., None]).astype(
        np.float32)
    if kind == "zero-rows":
        x[1] = 0.0
        x[3, 2] = 0.0
    elif kind == "absmax-at-max":
        x = np.clip(np.round(x), -100, 100)
        x[..., 0] = 127.0
        x[2, :, 5] = -448.0
        x[2, :, 0] = 448.0
    return x


# ---------------------------------------------------------------------------
# quantize_kv, pool bytes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rows", ["random", "zero-rows", "absmax-at-max", "bf16-input"])
@pytest.mark.parametrize("mode", MODES)
def test_quantize_kv_bytes_and_scales_bit_equal(mode, rows):
    x = _rows(rows, seed=len(rows))
    tq, jq = QDTYPES[mode]
    if rows == "bf16-input":
        tx = T(x).bfloat16()
        jx = jnp.asarray(tx.float().numpy(), jnp.bfloat16)
    else:
        tx, jx = T(x), jnp.asarray(x)
    got_q, got_s = tpaged.quantize_kv(tx, tq)
    want_q, want_s = jpaged.quantize_kv(jx, jq)
    assert got_q.dtype == tq and got_s.dtype == torch.float32
    np.testing.assert_array_equal(_bytes(got_q), _bytes(want_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    if rows == "zero-rows":
        assert (got_s[1] == 1).all() and (_bytes(got_q[1]) == 0).all()
    back = tpaged.dequantize_kv(got_q, got_s)
    np.testing.assert_array_equal(back.numpy(),
                                  np.asarray(jpaged.dequantize_kv(want_q, want_s)))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("mode", ["bf16"] + MODES)
def test_pool_nbytes_equal_jax(mode, dtype):
    dims = (2, 16, 16, 2, 64)   # L, nblk, bs, KV, Dh
    got = tpaged.PagedKVCache.create(*dims, getattr(torch, dtype), "cpu", kv_cache_dtype=mode)
    want = jpaged.PagedKVCache.create(*dims, getattr(jnp, dtype), kv_cache_dtype=mode)
    assert got.pool_nbytes() == want.pool_nbytes()
    assert got.quantized == want.quantized == (mode != "bf16")
    if mode != "bf16":
        assert got.k.dtype == QDTYPES[mode][0] and got.k_scale.shape == (2, 16, 2, 16)
        assert (got.k_scale == 1).all()
    with pytest.raises(ValueError, match="kv_cache_dtype"):
        tpaged.PagedKVCache.create(*dims, torch.float32, "cpu", kv_cache_dtype="int4")


# ---------------------------------------------------------------------------
# the three pool writes on equal rows
# ---------------------------------------------------------------------------


def _pools(mode, L=2, nblk=12, KV=2, bs=8, Dh=16, seed=0):
    """Equal port and JAX pools holding quantized random rows."""
    rng = np.random.default_rng(seed)
    tq, jq = QDTYPES[mode]
    t = tpaged.PagedKVCache.create(L, nblk, bs, KV, Dh, torch.float32, "cpu",
                                   kv_cache_dtype=mode)
    base = rng.standard_normal((2, L, nblk, KV, bs, Dh)).astype(np.float32)
    for i, (data, scale) in enumerate(((t.k, t.k_scale), (t.v, t.v_scale))):
        q, s = tpaged.quantize_kv(T(base[i]), tq)
        data.copy_(q)
        scale.copy_(s)
    j = jpaged.PagedKVCache(*(jnp.asarray(x.float().numpy() if x.element_size() == 1 else
                                          x.numpy()).astype(d)
                              for x, d in ((t.k, jq), (t.v, jq), (t.k_scale, jnp.float32),
                                           (t.v_scale, jnp.float32))))
    return t, j


def _assert_pools_equal(t, j):
    for got, want in zip(t, j):
        np.testing.assert_array_equal(_bytes(got), _bytes(want))


@pytest.mark.parametrize("mode", MODES)
def test_decode_append_writes_jax_bytes(mode):
    """``append_token_kv`` on a layer's (data, scale) views against JAX's
    on the stacked pool: rows quantized per (sequence, kv head), the
    scale plane scattered, the other layer untouched."""
    t, j = _pools(mode)
    rng = np.random.default_rng(1)
    newk, newv = (rng.standard_normal((3, 2, 16)).astype(np.float32) * 5 for _ in range(2))
    bt = np.asarray([[3, 4, -1], [7, -1, -1], [0, 0, 0]], np.int32)
    pos = np.asarray([9, 2, 0], np.int32)
    kp, vp = t.layer(1)
    tpaged.append_token_kv(kp, vp, T(newk), T(newv), T(bt), T(pos))
    (jk, jks), (jv, jvs) = jpaged.append_token_kv(
        (j.k, j.k_scale), (j.v, j.v_scale), jnp.asarray(newk), jnp.asarray(newv),
        jnp.asarray(bt), jnp.asarray(pos), layer=1)
    _assert_pools_equal(t, jpaged.PagedKVCache(jk, jv, jks, jvs))


@pytest.mark.parametrize("mode", MODES)
def test_chunk_scatter_writes_jax_bytes(mode):
    """``write_rows`` (the chunk scatter of ``_extend_layer``) against JAX
    ``engine_v2._extend_layer``'s quantize-on-write scatter on equal
    rows."""
    t, j = _pools(mode, seed=2)
    rng = np.random.default_rng(3)
    B, C, KV, Dh = 2, 5, 2, 16
    k, v = (rng.standard_normal((B, C, KV, Dh)).astype(np.float32) for _ in range(2))
    blk = np.asarray([[2, 2, 2, 5, 5], [9, 9, 0, 0, 0]], np.int32)
    off = np.asarray([[5, 6, 7, 0, 1], [3, 4, 0, 0, 0]], np.int32)
    kp, vp = t.layer(0)
    tpaged.write_rows(kp, vp, T(k).reshape(B * C, KV, Dh), T(v).reshape(B * C, KV, Dh),
                      T(blk).reshape(-1).long(), T(off).reshape(-1).long())
    # JAX engine_v2._extend_layer's write, on layer 0
    planes = []
    for data, scale, x in ((j.k[0], j.k_scale[0], k), (j.v[0], j.v_scale[0], v)):
        xq, sx = jpaged.quantize_kv(jnp.asarray(x), data.dtype)
        scale = scale.at[blk.reshape(-1), :, off.reshape(-1)].set(sx.reshape(B * C, KV))
        data = data.at[blk.reshape(-1), :, off.reshape(-1)].set(
            xq.reshape(B * C, KV, Dh).astype(data.dtype))
        planes.append((data, scale))
    (kd, ks), (vd, vs) = planes
    _assert_pools_equal(t, jpaged.PagedKVCache(j.k.at[0].set(kd), j.v.at[0].set(vd),
                                               j.k_scale.at[0].set(ks),
                                               j.v_scale.at[0].set(vs)))


@pytest.mark.parametrize("mode", MODES)
def test_prefill_scatter_writes_jax_bytes(mode):
    """``write_blocks`` (the batched prefill's scatter) against JAX
    ``engine_v2._paged_prefill_impl``'s on equal rows: [P, tpad] rows laid
    out as whole blocks, scales as [P * nblk, KV, bs]."""
    t, j = _pools(mode, seed=4)
    rng = np.random.default_rng(5)
    P, tpad, KV, Dh, bs = 2, 16, 2, 16, 8
    k, v = (rng.standard_normal((P, tpad, KV, Dh)).astype(np.float32) * 3 for _ in range(2))
    flat = np.asarray([4, 6, 1, 0], np.int32)
    kp, vp = t.layer(1)
    tpaged.write_blocks(kp, T(k), T(flat).long())
    tpaged.write_blocks(vp, T(v), T(flat).long())

    def blocks(x):
        return (x.reshape(P, tpad // bs, bs, KV, Dh).transpose(0, 1, 3, 2, 4)
                .reshape(-1, KV, bs, Dh))

    def sblocks(s):
        return s.reshape(P, tpad // bs, bs, KV).transpose(0, 1, 3, 2).reshape(-1, KV, bs)

    planes = []
    for data, scale, x in ((j.k[1], j.k_scale[1], k), (j.v[1], j.v_scale[1], v)):
        xq, sx = jpaged.quantize_kv(jnp.asarray(x), data.dtype)
        planes.append((data.at[flat].set(blocks(xq).astype(data.dtype)),
                       scale.at[flat].set(sblocks(sx))))
    (kd, ks), (vd, vs) = planes
    _assert_pools_equal(t, jpaged.PagedKVCache(j.k.at[1].set(kd), j.v.at[1].set(vd),
                                               j.k_scale.at[1].set(ks),
                                               j.v_scale.at[1].set(vs)))


# ---------------------------------------------------------------------------
# plain B2 / B3 / B5 over the planes against the Pallas kernels
# ---------------------------------------------------------------------------


def _quant_pool(nblk, KV, bs, Dh, mode, seed):
    """(port (data, scale), JAX (data, scale)) of the same quantized rows."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(2):
        x = rng.standard_normal((nblk, KV, bs, Dh)).astype(np.float32)
        q, s = tpaged.quantize_kv(T(x), QDTYPES[mode][0])
        out.append(((q, s), (jnp.asarray(q.float().numpy()).astype(QDTYPES[mode][1]),
                             jnp.asarray(s.numpy()))))
    return out


def _table(lens, bs, nblk, rng):
    """A -1-padded table of shuffled blocks (block 0 is scratch)."""
    nb = [-(-int(n) // bs) for n in lens]
    ids = rng.permutation(np.arange(1, nblk)).tolist()
    table = np.full((len(lens), max(nb) + 1), -1, np.int32)
    for b, n in enumerate(nb):
        table[b, :n] = [ids.pop() for _ in range(n)]
    return table


HEADS = [(8, 8), (8, 2)]
HEAD_IDS = ["MHA", "GQA-G4"]


def _slopes(H, alibi):
    return ttf.alibi_slopes(H) if alibi else None


@pytest.mark.parametrize("alibi", [False, True], ids=["no-slopes", "alibi"])
@pytest.mark.parametrize("H,KV", HEADS, ids=HEAD_IDS)
@pytest.mark.parametrize("mode", MODES)
def test_paged_decode_planes_match_pallas(mode, H, KV, alibi):
    Dh, bs, nblk = 64, 16, 32
    rng = np.random.default_rng(H + KV + alibi)
    lens = np.asarray([30, 49, 1, 16], np.int32)
    (tk, jk), (tv, jv) = _quant_pool(nblk, KV, bs, Dh, mode, seed=11)
    table = _table(lens, bs, nblk, rng)
    q = rng.standard_normal((len(lens), 1, H, Dh)).astype(np.float32)
    sl = _slopes(H, alibi)
    got = tpa.paged_decode_attention(T(q), tk[0], tv[0], T(table), T(lens),
                                     alibi_slopes=None if sl is None else T(sl),
                                     k_scale=tk[1], v_scale=tv[1]).numpy()
    want = jpa.paged_decode_attention_pallas(
        jnp.asarray(q), jk[0], jv[0], jnp.asarray(table), jnp.asarray(lens),
        alibi_slopes=None if sl is None else jnp.asarray(sl), k_scale=jk[1], v_scale=jv[1],
        interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), rtol=F32_TOL, atol=F32_TOL)
    k, v = jpaged.gather_kv(jk, jv, jnp.asarray(table))
    oracle = jengine.decode_attention(jnp.asarray(q), k, v, jnp.asarray(lens),
                                      alibi_slopes=None if sl is None else jnp.asarray(sl))
    np.testing.assert_allclose(got, np.asarray(oracle), rtol=F32_TOL, atol=F32_TOL)
    # the planes matter: without them (scale 1) the result moves
    unscaled = tpa.paged_decode_reference(T(q), tk[0], tv[0], T(table), T(lens),
                                          alibi_slopes=None if sl is None else T(sl),
                                          k_scale=torch.ones_like(tk[1]),
                                          v_scale=torch.ones_like(tv[1])).numpy()
    assert not np.allclose(got, unscaled, rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("alibi", [False, True], ids=["no-slopes", "alibi"])
@pytest.mark.parametrize("H,KV", HEADS, ids=HEAD_IDS)
@pytest.mark.parametrize("mode", MODES)
def test_paged_extend_planes_match_pallas(mode, H, KV, alibi):
    C, Dh, bs, nblk = 8, 64, 16, 16
    rng = np.random.default_rng(40 + H + KV + alibi)
    start = np.asarray([5, 0], np.int32)
    nnew = np.asarray([8, 3], np.int32)
    (tk, jk), (tv, jv) = _quant_pool(nblk, KV, bs, Dh, mode, seed=12)
    table = _table(start + nnew, bs, nblk, rng)
    q = rng.standard_normal((2, C, H, Dh)).astype(np.float32)
    sl = _slopes(H, alibi)
    got = tpa.paged_extend_attention(T(q), tk[0], tv[0], T(table), T(start), T(nnew),
                                     alibi_slopes=None if sl is None else T(sl),
                                     k_scale=tk[1], v_scale=tv[1]).numpy()
    want = np.asarray(jpa.paged_extend_attention_pallas(
        jnp.asarray(q), jk[0], jv[0], jnp.asarray(table), jnp.asarray(start),
        jnp.asarray(nnew), alibi_slopes=None if sl is None else jnp.asarray(sl),
        k_scale=jk[1], v_scale=jv[1], interpret=True))
    for b in range(2):   # rows past nnew are padding the engine never reads
        np.testing.assert_allclose(got[b, :nnew[b]], want[b, :nnew[b]], rtol=F32_TOL,
                                   atol=F32_TOL)


@pytest.mark.parametrize("splits", [1, 2, 4])
@pytest.mark.parametrize("alibi", [False, True], ids=["no-slopes", "alibi"])
@pytest.mark.parametrize("mode", MODES)
def test_split_decode_planes_match_pallas(mode, alibi, splits):
    H, KV, Dh, bs, nblk = 8, 2, 64, 16, 16
    rng = np.random.default_rng(70 + splits + alibi)
    lens = np.asarray([33, 47, 5], np.int32)
    (tk, jk), (tv, jv) = _quant_pool(nblk, KV, bs, Dh, mode, seed=13)
    table = _table(lens, bs, nblk, rng)
    q = rng.standard_normal((3, 1, H, Dh)).astype(np.float32)
    sl = _slopes(H, alibi)
    got = tfd.fused_paged_decode_attention(T(q), tk[0], tv[0], T(table), T(lens),
                                           num_splits=splits,
                                           alibi_slopes=None if sl is None else T(sl),
                                           k_scale=tk[1], v_scale=tv[1]).numpy()
    want = jfd.fused_paged_decode_attention_pallas(
        jnp.asarray(q), jk[0], jv[0], jnp.asarray(table), jnp.asarray(lens),
        alibi_slopes=None if sl is None else jnp.asarray(sl), k_scale=jk[1], v_scale=jv[1],
        num_splits=splits, interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), rtol=F32_TOL, atol=F32_TOL)


def test_scale_planes_go_together():
    q, pool = torch.zeros(1, 1, 4, 8), torch.zeros(2, 2, 8, 8)
    one = torch.ones(1, 1, dtype=torch.int32)
    for fn in (tpa.paged_decode_attention, tfd.fused_paged_decode_attention):
        with pytest.raises(ValueError, match="k_scale and v_scale"):
            fn(q, pool, pool, one, one[0], k_scale=torch.ones(2, 2, 8))


# ---------------------------------------------------------------------------
# engines
# ---------------------------------------------------------------------------


def _load(shape, make_j, make_t, tree=None):
    jm = JTransformer(make_j(**shape))
    jp = jm.init(jax.random.PRNGKey(0)) if tree is None else jax.tree.map(jnp.asarray, tree)
    tm = Transformer(make_t(**shape), device="cpu")
    state = params_from_numpy(jax.tree.map(np.asarray, jp))
    tm.load_params(state)
    return jm, jp, tm, state


@pytest.fixture(scope="module")
def models():
    return _load(MODEL, jtiny, tiny)


def _cfg(cls, mode, decode_kernel="xla", num_kv_blocks=40, **kw):
    return cls(dtype="float32", max_seq_len=64, kv_block_size=8, num_kv_blocks=num_kv_blocks,
               kv_cache_dtype=mode, decode_kernel=decode_kernel,
               serving={"token_budget": 16, "max_running": 4, "chunk_min": 4}, **kw)


def _engines(models, mode, decode_kernel="xla", **kw):
    jm, jp, tm, state = models
    return (JEngine(jm, jp, _cfg(JConfig, mode, decode_kernel, **kw)),
            InferenceEngineV2(tm, state, _cfg(InferenceConfig, mode, decode_kernel, **kw),
                              device="cpu"))


def _prompts(seed, lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 90, size=int(n)).tolist() for n in lengths]


def _assert_pool_like_jax(t, j):
    """Stored bytes equal; scales within 1e-5 relative (the two frameworks'
    K/V rows, and so their absmax, differ in their last f32 bits)."""
    np.testing.assert_array_equal(_bytes(t.cache.k), _bytes(j.cache.k))
    np.testing.assert_array_equal(_bytes(t.cache.v), _bytes(j.cache.v))
    for got, want in ((t.cache.k_scale, j.cache.k_scale), (t.cache.v_scale, j.cache.v_scale)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_TOL, atol=0)


@pytest.mark.parametrize("mode", MODES)
def test_put_and_decode_loop_match_jax(models, mode):
    """JAX ``test_engine_decode_parity_vs_bf16_oracle``'s schedule: the
    one-shot ``put()`` logits are bit-equal to the port's bf16 mode and
    within 1e-4 of JAX's; ``decode_loop`` tokens equal JAX's and the last
    decode logits are within 1e-4; a chunked extension afterwards within
    1e-4; the pools hold JAX's bytes after every write path."""
    je, te = _engines(models, mode)
    tb = _engines(models, "bf16")[1]
    prompt = _prompts(6, (21,))[0]
    lg = te.put([0], [prompt])
    np.testing.assert_array_equal(lg, tb.put([0], [prompt]))
    np.testing.assert_allclose(lg, np.asarray(je.put([0], [prompt])), rtol=ENGINE_TOL,
                               atol=ENGINE_TOL)
    _assert_pool_like_jax(te, je)
    first = int(np.argmax(lg[0]))
    toks = te.decode_loop([0], [first], 7)
    np.testing.assert_array_equal(toks, np.asarray(je.decode_loop([0], [first], 7)))
    np.testing.assert_allclose(te._seqs[0].last_logits, je._seqs[0].last_logits,
                               rtol=ENGINE_TOL, atol=ENGINE_TOL)
    _assert_pool_like_jax(te, je)
    more = _prompts(7, (19,))
    np.testing.assert_allclose(te.put([0], more), np.asarray(je.put([0], more)),
                               rtol=ENGINE_TOL, atol=ENGINE_TOL)
    _assert_pool_like_jax(te, je)
    assert te.cache.pool_nbytes() == je.cache.pool_nbytes() < tb.cache.pool_nbytes()


@pytest.mark.parametrize("decode_kernel", ["xla", "pallas"])
@pytest.mark.parametrize("mode", MODES)
def test_step_schedule_logits_match_jax(models, mode, decode_kernel, monkeypatch):
    """Extend-only, mixed and decode-only ticks: per-tick logits within
    1e-4 of JAX's engine in the same mode (its "pallas" engine with the
    fused kernels in interpret mode), equal free blocks."""
    if decode_kernel == "pallas":
        monkeypatch.setenv("SXT_FUSED_INTERPRET", "1")
    je, te = _engines(models, mode, decode_kernel)
    p = _prompts(0, (12, 5, 22))
    toks = np.random.default_rng(9).integers(1, 90, size=16).tolist()
    schedule = [([], [], [(0, p[0][:10]), (1, p[1])]),
                ([1], toks[:1], [(0, p[0][10:]), (2, p[2][:8])]),
                ([0, 1], toks[1:3], [(2, p[2][8:])]),
                ([0, 1, 2], toks[3:6], []),
                ([0, 2], toks[6:8], []),
                ([2], toks[8:9], [(3, p[1][:3])])]
    for tick in schedule:
        jd, jpl = je.step(*tick)
        td, tpl = te.step(*tick)
        np.testing.assert_allclose(td, jd, rtol=ENGINE_TOL, atol=ENGINE_TOL)
        np.testing.assert_allclose(tpl, jpl, rtol=ENGINE_TOL, atol=ENGINE_TOL)
        assert te.free_blocks == je.free_blocks
    _assert_pool_like_jax(te, je)


@pytest.mark.parametrize("mode", MODES)
def test_serve_tokens_equal_the_jax_scheduler(models, mode):
    je, te = _engines(models, mode)
    prompts = _prompts(3, (12, 5, 22, 9))
    want = JScheduler(je).serve(prompts, max_new_tokens=8)
    sched = ContinuousBatchingScheduler(te)
    assert sched.serve(prompts, max_new_tokens=8) == want
    assert te.dispatch_count == sched.ticks


@pytest.fixture(scope="module")
def fused_models():
    return _load(FUSED_MODEL, jtiny, tiny)


@pytest.mark.parametrize("mode", MODES)
def test_pallas_path_tokens_equal_xla(fused_models, mode, monkeypatch):
    """JAX ``test_engine_fused_pallas_path_quantized``: on a quantized pool
    the fused path (B4 without a pool, the quantizing append, B5 over the
    planes) gives the "xla" path's tokens and logits within 1e-5, and JAX's
    "pallas" engine's tokens; B4 never writes the pool there."""
    monkeypatch.setenv("SXT_FUSED_INTERPRET", "1")
    pooled = []
    real = tie2.fused_qkv_rope

    def qkv(*a, **kw):
        pooled.append(len(a) > 6 and a[6] is not None)
        return real(*a, **kw)

    monkeypatch.setattr(tie2, "fused_qkv_rope", qkv)
    prompt = _prompts(8, (12,))[0]
    outs = {}
    for dk in ("xla", "pallas"):
        je, te = _engines(fused_models, mode, dk)
        first = int(np.argmax(te.put([0], [prompt])[0]))
        toks = te.decode_loop([0], [first], 6)
        jfirst = int(np.argmax(np.asarray(je.put([0], [prompt]))[0]))
        jtoks = np.asarray(je.decode_loop([0], [jfirst], 6))
        assert [jfirst] + jtoks[0].tolist() == [first] + toks[0].tolist()
        outs[dk] = ([first] + toks[0].tolist(), te._seqs[0].last_logits)
        _assert_pool_like_jax(te, je)
    assert outs["xla"][0] == outs["pallas"][0]
    np.testing.assert_allclose(outs["pallas"][1], outs["xla"][1], rtol=F32_TOL, atol=F32_TOL)
    assert pooled and not any(pooled)


def test_v1_engine_refuses_quantized_kv(models):
    """JAX's v1 engine never reads kv_cache_dtype (its dense cache stays in
    the serving dtype); the port refuses int8/fp8 there rather than
    ignore it, and serves bf16."""
    _, _, tm, state = models
    for mode in MODES:
        with pytest.raises(ConfigError, match="kv_cache_dtype"):
            init_inference(tm, state, {"dtype": "float32", "kv_cache_dtype": mode},
                           device="cpu")
    eng = init_inference(tm, state, {"dtype": "float32", "kv_cache_dtype": "bf16"},
                         device="cpu")
    assert eng.config.kv_cache_dtype == "bf16"


# ---------------------------------------------------------------------------
# BLOOM-shaped ALiBi tiny and tiny_moe over int8 KV
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def bloom():
    from test_torch_train_alibi_gpt2 import SHAPES, _tree

    return _load(SHAPES["bloom"], jtiny, tiny, tree=_tree("bloom", seed=1))


@pytest.mark.parametrize("decode_kernel", ["xla", "pallas"])
def test_bloom_int8_kv_matches_jax(bloom, decode_kernel, monkeypatch):
    """Slopes and scales meet: the BLOOM-shaped tiny (ALiBi, layernorm,
    biases) over int8 KV against JAX's engine in the same mode: put()
    logits within 1e-4 and bit-equal to the bf16 mode, decode_loop
    tokens equal, then the scheduler's tokens equal."""
    if decode_kernel == "pallas":
        monkeypatch.setenv("SXT_FUSED_INTERPRET", "1")
    je, te = _engines(bloom, "int8", decode_kernel)
    tb = _engines(bloom, "bf16", decode_kernel)[1]
    prompt = _prompts(12, (23,))[0]
    lg = te.put([0], [prompt])
    np.testing.assert_array_equal(lg, tb.put([0], [prompt]))
    np.testing.assert_allclose(lg, np.asarray(je.put([0], [prompt])), rtol=ENGINE_TOL,
                               atol=ENGINE_TOL)
    first = int(np.argmax(lg[0]))
    np.testing.assert_array_equal(te.decode_loop([0], [first], 6),
                                  np.asarray(je.decode_loop([0], [first], 6)))
    _assert_pool_like_jax(te, je)
    je, te = _engines(bloom, "int8", decode_kernel)
    prompts = _prompts(13, (9, 17, 4))
    assert (ContinuousBatchingScheduler(te).serve(prompts, max_new_tokens=6)
            == JScheduler(je).serve(prompts, max_new_tokens=6))


MOE = dict(vocab=97, d=32, layers=2, heads=4, seq=128, experts=4, n_kv_heads=2,
           tie_embeddings=False)


def test_moe_int8_kv_serve_matches_jax():
    """JAX ``tests/test_moe_serving.py::test_kv_quant_compose_serves``:
    int8 KV and MoE routing share the tick; the port's scheduler tokens
    equal JAX's scheduler's, and each request's tokens equal the port's
    own one-request ``put()`` + ``decode_loop`` in the same mode."""
    jm, jp, tm, state = _load(MOE, jtiny_moe, tiny_moe)

    def cfg(cls):
        return cls(dtype="float32", max_seq_len=64, kv_block_size=8, num_kv_blocks=40,
                   kv_cache_dtype="int8",
                   serving={"token_budget": 16, "max_running": 4, "chunk_min": 4,
                            "moe": {"moe_impl": "ragged"}})

    prompts = _prompts(17, (5, 8))
    got = ContinuousBatchingScheduler(InferenceEngineV2(tm, state, cfg(InferenceConfig),
                                                        device="cpu")).serve(
        prompts, max_new_tokens=5)
    assert got == JScheduler(JEngine(jm, jp, cfg(JConfig))).serve(prompts, max_new_tokens=5)
    for i, p in enumerate(prompts):
        eng = InferenceEngineV2(tm, state, cfg(InferenceConfig), device="cpu")
        first = int(eng.put([0], [p])[0].argmax())
        assert got[i] == [first] + eng.decode_loop([0], [first], 4)[0].tolist()


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spelling,want", [("bf16", "bf16"), ("BFloat16", "bf16"),
                                           ("int8", "int8"), (" FP8 ", "fp8"),
                                           ("float8", "fp8"), ("e4m3", "fp8")])
def test_kv_cache_dtype_normalizes_as_jax(spelling, want):
    got = InferenceConfig.from_dict({"kv_cache_dtype": spelling}).kv_cache_dtype
    assert got == JConfig.from_dict({"kv_cache_dtype": spelling}).kv_cache_dtype == want
    assert InferenceConfig(kv_cache_dtype=spelling).kv_cache_dtype == want


def test_kv_cache_dtype_rejects_unknown():
    with pytest.raises(ConfigError, match="kv_cache_dtype"):
        InferenceConfig(kv_cache_dtype="int4")
