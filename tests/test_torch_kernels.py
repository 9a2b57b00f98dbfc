"""The PyTorch port's plain kernel versions against the JAX package.

Each kernel of the port's serving slice (RMSNorm, paged decode and paged
extend attention) has a plain PyTorch version that the wrapper takes for
CPU tensors. Here those plain versions meet the JAX package on the same
inputs, made from a numpy seed, in f32:

- RMSNorm against JAX ``rmsnorm_reference`` and the ``rmsnorm`` wrapper;
- paged decode / extend against the Pallas kernels run in interpret mode
  (as ``tests/test_paged_attention.py`` runs them) and against the JAX
  gather oracles, at G in {1, 2, 4}, ragged lengths, scratch-padded block
  tables and chunk rows past ``nnew``.

Tolerances: the plain versions and the JAX gather oracles run the same
dense f32 algorithm, so they agree to 1e-6; the Pallas kernels use an
online softmax over blocks, whose f32 rescaling differs in the last bits,
so they are held to 1e-5. The CUDA and Triton kernels themselves run only
on the card, where ``chip_smoke.py`` holds each against its plain version.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shuffle_exchange_tpu.inference import engine as jengine
from shuffle_exchange_tpu.inference import paged as jpaged
from shuffle_exchange_tpu_torch.inference import paged as tpaged

# the ops packages export functions under their modules' names, so the
# modules are fetched by path
jpa = importlib.import_module("shuffle_exchange_tpu.ops.paged_attention")
jrms = importlib.import_module("shuffle_exchange_tpu.ops.rmsnorm")
tpa = importlib.import_module("shuffle_exchange_tpu_torch.ops.paged_attention")
trms = importlib.import_module("shuffle_exchange_tpu_torch.ops.rmsnorm")

T = torch.from_numpy


def _np(x):
    return np.asarray(x)


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(5, 128), (3, 7, 256), (1, 4096)])
def test_rmsnorm_reference_matches_jax(shape):
    rng = np.random.default_rng(0)
    x = rng.standard_normal(shape).astype(np.float32) * 3
    w = rng.standard_normal(shape[-1]).astype(np.float32)
    want = _np(jrms.rmsnorm_reference(jnp.asarray(x), jnp.asarray(w), 1e-5))
    got = trms.rmsnorm_reference(T(x), T(w), 1e-5).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_rmsnorm_reference_bf16_matches_jax():
    """bf16 in, f32 statistics, bf16 out on both sides: equal to one bf16
    rounding step (the two sums may round to neighbouring bf16 values)."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((16, 256)).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(256)).astype(np.float32)
    want = _np(jrms.rmsnorm_reference(jnp.asarray(x, jnp.bfloat16),
                                      jnp.asarray(w, jnp.bfloat16), 1e-5)).astype(np.float32)
    got = trms.rmsnorm_reference(T(x).bfloat16(), T(w).bfloat16(), 1e-5)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -7, atol=1e-6)


def test_rmsnorm_wrapper_residual_on_cpu_is_plain_and_uncounted():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((4, 128)).astype(np.float32)
    r = rng.standard_normal((4, 128)).astype(np.float32)
    w = rng.standard_normal(128).astype(np.float32)
    before = trms.rmsnorm.launches
    got = trms.rmsnorm(T(x), T(w), eps=1e-6, residual=T(r)).numpy()
    want = _np(jrms.rmsnorm(jnp.asarray(x), jnp.asarray(w), eps=1e-6,
                            residual=jnp.asarray(r)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert trms.rmsnorm.launches == before
    with pytest.raises(ValueError, match="residual shape"):
        trms.rmsnorm(T(x), T(w), residual=T(r[:2]))


# ---------------------------------------------------------------------------
# Paged attention: shared inputs
# ---------------------------------------------------------------------------

SCRATCH = 0


def _tables(lens, bs, width, pad=SCRATCH):
    """Block tables for ragged lengths, padded to ``width`` with ``pad``;
    block 0 is the scratch block, real blocks count up from 1."""
    t = np.full((len(lens), width), pad, np.int32)
    nxt = iter(range(1, 1 + sum(-(-int(n) // bs) for n in lens)))
    for b, n in enumerate(lens):
        for j in range(-(-int(n) // bs)):
            t[b, j] = next(nxt)
    return t


def _pool(nblk, KV, bs, Dh, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((nblk, KV, bs, Dh)).astype(np.float32),
            rng.standard_normal((nblk, KV, bs, Dh)).astype(np.float32))


DECODE_CASES = [  # (H, KV, lens, table width, pad id)
    (8, 8, [16, 30, 49], 4, SCRATCH),
    (8, 4, [1, 64, 17, 33], 5, SCRATCH),
    (8, 2, [33, 47], 4, -1),
]


@pytest.mark.parametrize("H,KV,lens,width,pad", DECODE_CASES,
                         ids=["G1", "G2", "G4-neg-pad"])
def test_paged_decode_plain_matches_jax(H, KV, lens, width, pad):
    B, Dh, bs = len(lens), 32, 16
    rng = np.random.default_rng(H * 10 + KV)
    q = rng.standard_normal((B, 1, H, Dh)).astype(np.float32)
    ck, cv = _pool(1 + sum(-(-n // bs) for n in lens), KV, bs, Dh, seed=KV)
    bt = _tables(lens, bs, width, pad)
    kvl = np.asarray(lens, np.int32)
    got = tpa.paged_decode_attention(T(q), T(ck), T(cv), T(bt), T(kvl)).numpy()
    args = tuple(jnp.asarray(a) for a in (q, ck, cv, bt, kvl))
    oracle = _np(jengine.decode_attention(args[0], *jpaged.gather_kv(args[1], args[2], args[3]),
                                          args[4]))
    np.testing.assert_allclose(got, oracle, rtol=1e-6, atol=1e-6)
    kernel = _np(jpa.paged_decode_attention_pallas(*args, interpret=True))
    np.testing.assert_allclose(got, kernel, rtol=1e-5, atol=1e-5)


EXTEND_CASES = [  # (H, KV, starts, nnew, table width, pad id)
    (4, 4, [5, 0, 30], [8, 3, 6], 4, SCRATCH),
    (8, 4, [17, 9], [4, 1], 3, SCRATCH),
    (8, 2, [5, 0, 30], [8, 3, 6], 4, -1),
]


@pytest.mark.parametrize("H,KV,starts,nnew,width,pad", EXTEND_CASES,
                         ids=["G1", "G2", "G4-neg-pad"])
def test_paged_extend_plain_matches_jax(H, KV, starts, nnew, width, pad):
    """Rows past ``nnew`` are padding: the plain version and the JAX gather
    oracle agree on them too (both cap at ``start + nnew``); the Pallas
    kernel gives them causal rows instead, and the engine never reads
    them, so the kernel comparison covers rows < nnew."""
    B, C, Dh, bs = len(starts), 8, 32, 16
    starts, nnew = np.asarray(starts, np.int32), np.asarray(nnew, np.int32)
    lens = (starts + nnew).tolist()
    rng = np.random.default_rng(H + KV)
    q = rng.standard_normal((B, C, H, Dh)).astype(np.float32)
    ck, cv = _pool(1 + sum(-(-n // bs) for n in lens), KV, bs, Dh, seed=3)
    bt = _tables(lens, bs, width, pad)
    got = tpa.paged_extend_attention(T(q), T(ck), T(cv), T(bt), T(starts), T(nnew)).numpy()
    args = tuple(jnp.asarray(a) for a in (q, ck, cv, bt, starts, nnew))
    kg, vg = jpaged.gather_kv(args[1], args[2], args[3])
    oracle = _np(jengine.extend_attention(args[0], kg, vg, args[4], args[4] + args[5]))
    np.testing.assert_allclose(got, oracle, rtol=1e-6, atol=1e-6)
    kernel = _np(jpa.paged_extend_attention_pallas(*args, interpret=True))
    for b in range(B):
        np.testing.assert_allclose(got[b, :nnew[b]], kernel[b, :nnew[b]], rtol=1e-5, atol=1e-5)


def _bf16(x):
    """numpy f32 -> (torch bf16, jax bf16) holding the same values."""
    t = T(x).bfloat16()
    return t, jnp.asarray(t.float().numpy(), jnp.bfloat16)


@pytest.mark.parametrize("kind,case", [("decode", c) for c in DECODE_CASES]
                         + [("extend", c) for c in EXTEND_CASES],
                         ids=[f"decode-{i}" for i in ("G1", "G2", "G4-neg-pad")]
                         + [f"extend-{i}" for i in ("G1", "G2", "G4-neg-pad")])
def test_paged_plain_p_f32_matches_pallas_in_bf16(kind, case):
    """In bf16 the Pallas kernels keep the softmax weights in f32, as the
    CUDA kernels do; the plain versions with ``p_f32=True`` do the same,
    so the two outputs are bf16 roundings of f32 values that differ only
    in accumulation order: within one bf16 step (2^-7 of |out|), plus
    1e-5 for outputs near zero."""
    H, KV = case[0], case[1]
    Dh, bs, C = 32, 16, 8
    rng = np.random.default_rng(H * 7 + KV)
    if kind == "decode":
        lens, width, pad = case[2:]
        B, C, extra = len(lens), 1, ()
    else:
        starts, nnew, width, pad = (np.asarray(case[2], np.int32),
                                    np.asarray(case[3], np.int32)) + case[4:]
        lens, B = (starts + nnew).tolist(), len(starts)
    q = rng.standard_normal((B, C, H, Dh)).astype(np.float32)
    ck, cv = _pool(1 + sum(-(-n // bs) for n in lens), KV, bs, Dh, seed=KV + 11)
    bt = _tables(lens, bs, width, pad)
    (tq, jq), (tk, jk), (tv, jv) = _bf16(q), _bf16(ck), _bf16(cv)
    if kind == "decode":
        kvl = np.asarray(lens, np.int32)
        got = tpa.paged_decode_reference(tq, tk, tv, T(bt), T(kvl), p_f32=True)
        want = jpa.paged_decode_attention_pallas(jq, jk, jv, jnp.asarray(bt),
                                                 jnp.asarray(kvl), interpret=True)
        rows = [slice(None)] * B
    else:
        got = tpa.paged_extend_reference(tq, tk, tv, T(bt), T(starts), T(nnew), p_f32=True)
        want = jpa.paged_extend_attention_pallas(jq, jk, jv, jnp.asarray(bt), jnp.asarray(starts),
                                                 jnp.asarray(nnew), interpret=True)
        rows = [slice(0, int(n)) for n in nnew]
    assert got.dtype == torch.bfloat16
    got, want = got.float().numpy(), _np(want.astype(jnp.float32))
    for b in range(B):
        g, w = got[b, rows[b]], want[b, rows[b]]
        assert (np.abs(g - w) <= 2 ** -7 * np.abs(w) + 1e-5).all(), np.abs(g - w).max()


def test_gather_kv_matches_jax():
    ck, cv = _pool(9, 2, 8, 16, seed=5)
    bt = np.asarray([[3, 1, -1], [2, 0, 0]], np.int32)
    gk, gv = tpa.gather_kv(T(ck), T(cv), T(bt))
    jk, jv = jpaged.gather_kv(jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(bt))
    np.testing.assert_array_equal(gk.numpy(), _np(jk))
    np.testing.assert_array_equal(gv.numpy(), _np(jv))


def test_append_token_kv_in_place_matches_jax():
    """The port writes the token's K/V into the layer view in place (no
    pool copy); the result equals JAX's functional scatter, and the
    stacked pool the view came from sees the write."""
    L, nblk, KV, bs, Dh = 2, 6, 2, 4, 8
    rng = np.random.default_rng(6)
    pool_k = rng.standard_normal((L, nblk, KV, bs, Dh)).astype(np.float32)
    pool_v = rng.standard_normal((L, nblk, KV, bs, Dh)).astype(np.float32)
    newk = rng.standard_normal((3, KV, Dh)).astype(np.float32)
    newv = rng.standard_normal((3, KV, Dh)).astype(np.float32)
    bt = np.asarray([[1, 2, 0], [3, 0, 0], [4, 5, -1]], np.int32)
    pos = np.asarray([5, 0, 7], np.int32)
    tk, tv = T(pool_k.copy()), T(pool_v.copy())
    ptr = tk.data_ptr()
    tpaged.append_token_kv(tk[1], tv[1], T(newk), T(newv), T(bt), T(pos))
    assert tk.data_ptr() == ptr
    jk, jv = jpaged.append_token_kv(jnp.asarray(pool_k[1]), jnp.asarray(pool_v[1]),
                                    jnp.asarray(newk), jnp.asarray(newv),
                                    jnp.asarray(bt), jnp.asarray(pos))
    np.testing.assert_array_equal(tk[1].numpy(), _np(jk))
    np.testing.assert_array_equal(tv[1].numpy(), _np(jv))
    np.testing.assert_array_equal(tk[0].numpy(), pool_k[0])


@pytest.mark.parametrize("kw", [{"alibi_slopes": np.ones(8, np.float32)},
                                {"k_scale": np.linspace(0.5, 2, 384, dtype=np.float32
                                                        ).reshape(3, 8, 16),
                                 "v_scale": np.linspace(2, 0.5, 384, dtype=np.float32
                                                        ).reshape(3, 8, 16)}],
                         ids=["alibi", "kv-scales"])
@pytest.mark.parametrize("which", ["decode", "extend"])
def test_paged_wrappers_refuse_unported_features(kw, which):
    """Nothing of these is refused any more: ALiBi slopes are served since
    the BLOOM / GPT-2 serving slice and KV scale planes since the int8/fp8
    KV slice. The same call runs and the feature moves the result (a
    dropped slope or scale would leave it as without)."""
    rng = np.random.default_rng(0)
    q = T(rng.standard_normal((1, 1, 8, 32), np.float32))
    ck, cv = (T(rng.standard_normal((3, 8, 16, 32), np.float32)) for _ in range(2))
    bt = torch.ones(1, 1, dtype=torch.int32)
    n = torch.full((1,), 12, dtype=torch.int32)

    def call(**extra):
        if which == "decode":
            return tpa.paged_decode_attention(q, ck, cv, bt, n, **extra)
        return tpa.paged_extend_attention(q, ck, cv, bt, n - 1, torch.ones_like(n), **extra)

    assert not torch.allclose(call(**{k: T(v) for k, v in kw.items()}), call())


def test_paged_wrappers_on_cpu_do_not_count_launches():
    before = (tpa.paged_decode_attention.launches, tpa.paged_extend_attention.launches)
    q = torch.randn(1, 1, 4, 16)
    ck, cv = torch.randn(2, 2, 8, 16), torch.randn(2, 2, 8, 16)
    bt = torch.tensor([[1]], dtype=torch.int32)
    tpa.paged_decode_attention(q, ck, cv, bt, torch.tensor([3]))
    tpa.paged_extend_attention(q, ck, cv, bt, torch.tensor([2]), torch.tensor([1]))
    assert (tpa.paged_decode_attention.launches,
            tpa.paged_extend_attention.launches) == before


def test_jax_stays_on_cpu():
    assert jax.default_backend() == "cpu"
