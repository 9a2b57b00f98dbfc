"""Blocksparse attention of the PyTorch port against the JAX package.

``shuffle_exchange_tpu_torch/ops/sparse_attention.py`` and the element-mask
form of ``ops/flash_attention.py`` (B15 with splash's ``mask_np``) meet
JAX's ``ops/sparse_attention.py`` on the same inputs, made with numpy from
a seed:

- the five ``SparsityConfig`` layouts equal JAX's (BigBird's random blocks
  from its seed);
- the plain ``sparse_attention`` within 1e-5 of JAX ``impl="dense"`` in
  f32 (another summation order), causal and not, MHA and GQA, T < S with
  a given layout; within 3e-3 of JAX ``impl="splash"`` in interpret mode
  at D 128, T = S = 256 (the tolerance JAX's own
  ``tests/test_longcontext.py`` holds the splash path to);
- gradients of q, k and v within 1e-5 of ``jax.grad`` of the dense path;
- a layout with a fully masked query row: that row gives 0 and zero
  gradients, on both sides;
- the tile map the kernels walk: each 64 x 64 tile's state (empty, full,
  partial), the two lists and the partial blocks against the mask itself,
  and a numpy walk of only the listed tiles (the kernels' skipping)
  against the plain version;
- ``impl="dense"`` runs the plain version on the CPU (its refusal on a
  CUDA tensor, and the kernels, are checked on the card by
  ``chip_smoke.py`` phase 2l).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shuffle_exchange_tpu.ops import sparse_attention as jsa
from shuffle_exchange_tpu_torch.ops import sparse_attention as tsa

tfa = importlib.import_module("shuffle_exchange_tpu_torch.ops.flash_attention")

T_ = torch.from_numpy
F32_TOL = 1e-5
SPLASH_TOL = 3e-3

CONFIGS = {
    "dense": lambda m: m.DenseSparsityConfig(block=16),
    "fixed": lambda m: m.FixedSparsityConfig(block=16, num_local_blocks=4, num_global_blocks=1),
    "longformer": lambda m: m.BSLongformerSparsityConfig(block=16, num_sliding_window_blocks=3,
                                                         global_block_indices=(0, 5)),
    "bigbird": lambda m: m.BigBirdSparsityConfig(block=16, num_random_blocks=2,
                                                 num_sliding_window_blocks=3,
                                                 num_global_blocks=1, seed=7),
    "variable": lambda m: m.VariableSparsityConfig(block=16, num_local_blocks=3,
                                                   global_block_indices=(2,)),
}


@pytest.mark.parametrize("seq", [64, 256, 400])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_layouts_equal_jax(name, seq):
    np.testing.assert_array_equal(CONFIGS[name](tsa).make_layout(seq),
                                  CONFIGS[name](jsa).make_layout(seq))


def test_layout_config_errors_match_jax():
    for mod in (tsa, jsa):
        with pytest.raises(ValueError, match="num_global_blocks"):
            mod.FixedSparsityConfig(num_local_blocks=2, num_global_blocks=3)
        with pytest.raises(ValueError, match="not divisible"):
            mod.FixedSparsityConfig(block=16).make_layout(100)


def _qkv(B, T, S, H, KV, D, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, T, H, D)).astype(np.float32),
            rng.standard_normal((B, S, KV, D)).astype(np.float32),
            rng.standard_normal((B, S, KV, D)).astype(np.float32))


CASES = [("fixed", True, 4, 4), ("fixed", False, 4, 2), ("bigbird", True, 4, 1),
         ("longformer", False, 4, 4), ("variable", True, 8, 2), ("dense", True, 4, 2)]


@pytest.mark.parametrize("name,causal,H,KV", CASES)
def test_plain_matches_jax_dense(name, causal, H, KV):
    q, k, v = _qkv(2, 128, 128, H, KV, 32, seed=H + KV + causal)
    cfg_t, cfg_j = CONFIGS[name](tsa), CONFIGS[name](jsa)
    got = tsa.sparse_attention(T_(q), T_(k), T_(v), cfg_t, causal=causal).numpy()
    want = jsa.sparse_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), cfg_j,
                                causal=causal, impl="dense")
    np.testing.assert_allclose(got, np.asarray(want), rtol=F32_TOL, atol=F32_TOL)
    dense = tsa.sparse_attention(T_(q), T_(k), T_(v), cfg_t, causal=causal, impl="dense")
    np.testing.assert_array_equal(dense.numpy(), got)


def test_plain_matches_jax_dense_with_a_given_layout_and_t_below_s():
    """T < S: the layout covers [T/bs, S/bs] and causal aligns the
    diagonal bottom-right (tril(k=S-T)), as JAX's."""
    q, k, v = _qkv(1, 48, 80, 4, 2, 32, seed=3)
    layout = np.random.default_rng(4).random((3, 5)) < 0.6
    layout[:, -1] = True
    got = tsa.sparse_attention(T_(q), T_(k), T_(v), tsa.SparsityConfig(block=16), causal=True,
                               layout=layout).numpy()
    want = jsa.sparse_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                jsa.SparsityConfig(block=16), causal=True, layout=layout,
                                impl="dense")
    np.testing.assert_allclose(got, np.asarray(want), rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("name", ["fixed", "bigbird"])
def test_plain_matches_jax_splash_in_interpret_mode(name):
    """JAX ``tests/test_longcontext.py``'s splash check: D 128, T = S = 256,
    causal; JAX's splash path (interpret mode) against the port's plain
    version."""
    q, k, v = _qkv(1, 256, 256, 4, 2, 128, seed=4)
    got = tsa.sparse_attention(T_(q), T_(k), T_(v), CONFIGS[name](tsa), causal=True).numpy()
    want = jsa.sparse_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                CONFIGS[name](jsa), causal=True, impl="splash")
    np.testing.assert_allclose(got, np.asarray(want), rtol=SPLASH_TOL, atol=SPLASH_TOL)


def _grads_port(q, k, v, dout, **kw):
    tq, tk, tv = (T_(x).requires_grad_() for x in (q, k, v))
    out = tsa.sparse_attention(tq, tk, tv, **kw)
    (out * T_(dout)).sum().backward()
    return out.detach().numpy(), tq.grad.numpy(), tk.grad.numpy(), tv.grad.numpy()


def _grads_jax(q, k, v, dout, **kw):
    def loss(q_, k_, v_):
        return (jsa.sparse_attention(q_, k_, v_, impl="dense", **kw) * jnp.asarray(dout)).sum()

    out = jsa.sparse_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), impl="dense",
                               **kw)
    g = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return (np.asarray(out),) + tuple(np.asarray(x) for x in g)


@pytest.mark.parametrize("name,causal,H,KV", CASES[:4])
def test_gradients_match_jax_grad_of_the_dense_path(name, causal, H, KV):
    q, k, v = _qkv(1, 96, 96, H, KV, 32, seed=10 + H)
    dout = np.random.default_rng(11).standard_normal(q.shape).astype(np.float32)
    got = _grads_port(q, k, v, dout, config=CONFIGS[name](tsa), causal=causal)
    want = _grads_jax(q, k, v, dout, config=CONFIGS[name](jsa), causal=causal)
    for g, w, what in zip(got, want, ("out", "dq", "dk", "dv")):
        np.testing.assert_allclose(g, w, rtol=F32_TOL, atol=F32_TOL, err_msg=what)


def _empty_row_layout():
    """A 4 x 4 block layout whose third query block sees nothing."""
    layout = np.tril(np.ones((4, 4), bool))
    layout[2] = False
    return layout


def test_fully_masked_rows_give_zero_and_zero_gradients():
    q, k, v = _qkv(1, 64, 64, 4, 2, 32, seed=12)
    dout = np.random.default_rng(13).standard_normal(q.shape).astype(np.float32)
    kw = dict(config=tsa.SparsityConfig(block=16), causal=True, layout=_empty_row_layout())
    out, dq, dk, dv = _grads_port(q, k, v, dout, **kw)
    rows = slice(32, 48)
    assert (out[:, rows] == 0).all() and (dq[:, rows] == 0).all()
    assert np.abs(out[:, :32]).min() > 0          # the other rows are not zeroed
    want = _grads_jax(q, k, v, dout, config=jsa.SparsityConfig(block=16), causal=True,
                      layout=_empty_row_layout())
    for g, w, what in zip((out, dq, dk, dv), want, ("out", "dq", "dk", "dv")):
        np.testing.assert_allclose(g, w, rtol=F32_TOL, atol=F32_TOL, err_msg=what)
    # the rows' queries reach no key: moving them changes nothing
    q2 = q.copy()
    q2[:, rows] += 5.0
    np.testing.assert_array_equal(tsa.sparse_attention(T_(q2), T_(k), T_(v), **kw).numpy(),
                                  out)


def test_impl_dense_runs_the_plain_version_on_the_cpu_and_bad_impl_raises():
    q, k, v = _qkv(1, 32, 32, 2, 2, 16, seed=14)
    cfg = tsa.FixedSparsityConfig(block=16, num_local_blocks=1)
    plain = tfa.reference_attention(T_(q), T_(k), T_(v), causal=False, p_f32=True,
                                    mask=tsa.element_mask(cfg.make_layout(32), 16, 32, 32, True))
    for impl in tsa.IMPLS:
        np.testing.assert_array_equal(
            tsa.sparse_attention(T_(q), T_(k), T_(v), cfg, impl=impl).numpy(), plain.numpy())
    with pytest.raises(ValueError, match="impl"):
        tsa.sparse_attention(T_(q), T_(k), T_(v), cfg, impl="triton")
    with pytest.raises(ValueError, match="causal=False"):
        tfa.flash_attention(T_(q), T_(k), T_(v), causal=True, mask=np.ones((32, 32), bool))


def test_sparse_attention_on_cpu_counts_no_launch():
    before = (tfa.flash_attention.launches, tfa.flash_attention_bwd.launches)
    q, k, v = (T_(x).requires_grad_() for x in _qkv(1, 64, 64, 2, 1, 16, seed=15))
    tsa.sparse_attention(q, k, v, tsa.FixedSparsityConfig(block=16)).sum().backward()
    assert (tfa.flash_attention.launches, tfa.flash_attention_bwd.launches) == before


# ---------------------------------------------------------------------------
# the tile map
# ---------------------------------------------------------------------------

TILE_MASKS = {
    "fixed-causal": lambda: tsa.element_mask(CONFIGS["fixed"](tsa).make_layout(512), 16, 512,
                                             512, True),
    "bigbird": lambda: tsa.element_mask(CONFIGS["bigbird"](tsa).make_layout(512), 16, 512, 512,
                                        False),
    "ragged-t-below-s": lambda: np.random.default_rng(5).random((100, 200)) < 0.02,
    "empty-row-tiles": lambda: tsa.element_mask(_empty_row_layout(), 64, 256, 256, True),
}


@pytest.mark.parametrize("name", list(TILE_MASKS))
def test_tile_map_against_the_mask(name):
    m = TILE_MASKS[name]()
    tm = tfa.tile_mask(m)
    assert tfa.tile_mask(m) is tm                   # cached per mask
    T, S = m.shape
    nqt, nkt = -(-T // 64), -(-S // 64)
    assert tm.allowed == int(m.sum())
    rows = set()
    for qt in range(nqt):
        for e in range(tm.row_ptr[qt], tm.row_ptr[qt + 1]):
            rows.add((qt, int(tm.row_kt[e]), int(tm.row_blk[e])))
    cols = {(int(tm.col_qt[e]), kt, int(tm.col_blk[e]))
            for kt in range(nkt) for e in range(tm.col_ptr[kt], tm.col_ptr[kt + 1])}
    assert rows == cols and len(rows) == tm.nnz
    seen = {(qt, kt): blk for qt, kt, blk in rows}
    for qt in range(nqt):
        for kt in range(nkt):
            tile = m[qt * 64:(qt + 1) * 64, kt * 64:(kt + 1) * 64]
            if not tile.any():
                assert (qt, kt) not in seen and tm.state[qt, kt] == 0
            elif tile.shape == (64, 64) and tile.all():
                assert seen[(qt, kt)] == -1 and tm.state[qt, kt] == 1
            else:
                blk = seen[(qt, kt)]
                assert blk >= 0 and tm.state[qt, kt] == 2
                want = np.zeros((64, 64), np.uint8)
                want[:tile.shape[0], :tile.shape[1]] = tile
                np.testing.assert_array_equal(tm.blocks[blk], want)
    for lst, ptr in ((tm.row_kt, tm.row_ptr), (tm.col_qt, tm.col_ptr)):
        for i in range(len(ptr) - 1):          # ascending within each list
            assert (np.diff(lst[ptr[i]:ptr[i + 1]]) > 0).all()


@pytest.mark.parametrize("name", list(TILE_MASKS))
def test_walking_only_the_listed_tiles_gives_the_plain_version(name):
    """A numpy walk of the forward as the kernels do it (online softmax
    over the query tile's listed key tiles only; full tiles unmasked,
    partial ones through their block; masked weights exactly 0) against
    the plain version (f64 walk, f32 plain: within 1e-5): the skipped
    tiles held nothing."""
    m = TILE_MASKS[name]()
    tm = tfa.tile_mask(m)
    T, S = m.shape
    rng = np.random.default_rng(6)
    q = rng.standard_normal((T, 16)).astype(np.float64)
    k = rng.standard_normal((S, 16)).astype(np.float64)
    v = rng.standard_normal((S, 16)).astype(np.float64)
    out = np.zeros((T, 16))
    for qt in range(-(-T // 64)):
        r = slice(qt * 64, min(T, (qt + 1) * 64))
        mx = np.full(r.stop - r.start, -np.inf)
        den = np.zeros(r.stop - r.start)
        acc = np.zeros((r.stop - r.start, 16))
        for e in range(tm.row_ptr[qt], tm.row_ptr[qt + 1]):
            kt, blk = tm.row_kt[e], tm.row_blk[e]
            c = slice(kt * 64, min(S, (kt + 1) * 64))
            s = q[r] @ k[c].T / 4.0
            ok = (np.ones_like(s, bool) if blk < 0
                  else tm.blocks[blk][:s.shape[0], :s.shape[1]].astype(bool))
            s = np.where(ok, s, -np.inf)
            new = np.maximum(mx, s.max(1))
            safe = np.where(np.isfinite(new), new, 0)
            p = np.where(ok, np.exp(s - safe[:, None]), 0)
            scale = np.where(np.isfinite(mx), np.exp(mx - safe), 0)
            den = den * scale + p.sum(1)
            acc = acc * scale[:, None] + p @ v[c]
            mx = new
        out[r] = acc / np.maximum(den, 1e-300)[:, None]
    want = tfa.reference_attention(T_(q[None, :, None]), T_(k[None, :, None]),
                                   T_(v[None, :, None]), causal=False, p_f32=True, mask=tm)
    # the plain version computes in f32: 1e-5
    np.testing.assert_allclose(out, want[0, :, 0].numpy(), rtol=F32_TOL, atol=F32_TOL)
    assert (out[tm.empty_rows] == 0).all()
