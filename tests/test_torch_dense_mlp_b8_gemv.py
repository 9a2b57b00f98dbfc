"""B6, the fused MLP over bf16 weights, and B8's decode rows, redesigned for
Hopper on the tensor-core GEMV of ``ops/csrc/mma_gemv.cuh`` (shared with
B7 and B16's decode rows), on the CPU: what of the design can be held
without the card.

- A plain f32 mirror of B6's arithmetic (passes of up to 16 rows; the
  norm in f32 folded into the up GEMV's A operand; 32-row stages; each
  warp's contiguous run of a chunk's stages, the warps' sums added in warp
  order, split partials in split order; the gated up GEMV's gate and up
  tiles on four warps each; the fragments' column permutation undone at
  the store; ``b_up`` added before the activation, then the residual and
  then ``b_down`` after the down GEMV) meets
  ``fused_mlp_pallas(interpret=True)`` within 1e-5 of the output's largest
  value, gated and plain, for RMSNorm, layernorm with and without ``ln_b``
  and ``apply_norm=False``, with and without fc biases, for each of the
  three activation codes (silu, relu, the tanh gelu), at 1, 8, 16 and 20
  rows (two passes). Mirrors that leave the fragments permuted or drop
  ``b_down`` miss.
- A mirror of B8's GEMV (row groups of 16 rows, the chunks of its plan,
  bf16(q * s) in the B operand) meets JAX's default route over the weight
  JAX dequantizes and casts to bf16; with q * s left in f32 it meets JAX
  ``quant_matmul`` and, where N % 128 and the group size allow,
  ``_quant_matmul_pallas(interpret=True)``, in int8, int4 and e4m3 at 1, 3,
  8, 16 and 40 rows within 1e-5. A mirror that scales a group with its
  neighbour's scales, or leaves the fragments permuted, misses.
- The wrappers hand the C entry points their operands, plan, workspaces
  and counters (a recorded fake library): B6 two GEMVs a pass of up to 16
  rows on ``fused_decode.mlp_plan`` (bf16: whole 32-row stages), B8 the
  GEMV up to ``GEMV_ROWS`` rows on ``quant_matmul.gemv_plan``.
- The kernels only the old routes launched are gone from the sources.
"""

import importlib
import importlib.util
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_decode_gemv_redesign import (ROWS, SMS, STAGE, TILE, _Lib, _act, _q_values,
                                             bf16, gemv_tile)

jfd = importlib.import_module("shuffle_exchange_tpu.ops.fused_decode")
jqm = importlib.import_module("shuffle_exchange_tpu.ops.quant_matmul")
fd = importlib.import_module("shuffle_exchange_tpu_torch.ops.fused_decode")
tqm = importlib.import_module("shuffle_exchange_tpu_torch.ops.quant_matmul")
dg = importlib.import_module("shuffle_exchange_tpu_torch.ops.decode_gemv")
CSRC = Path(fd.__file__).parent / "csrc"


# ---------------------------------------------------------------------------
# B6: the mirror of the bf16 fused MLP on the GEMV
# ---------------------------------------------------------------------------


def _padded(w: np.ndarray) -> np.ndarray:
    """w [K, N] with its columns zero-padded to whole 128-column tiles (TMA's
    zeros past N)."""
    out = np.zeros((w.shape[0], -(-w.shape[1] // TILE) * TILE), np.float32)
    out[:, :w.shape[1]] = w
    return out


def gemv_bf16(A: np.ndarray, W: np.ndarray, K: int, splits: int, chunk: int, parts: int,
              unpermute: bool = True) -> np.ndarray:
    """A [16, K] @ W [K, N] tile by tile as the GEMV sums a bf16 weight."""
    Wp = _padded(W)
    out = np.concatenate([gemv_tile(A, Wp[:, t:t + TILE], None, K, STAGE, "bf16", splits, chunk,
                                    unpermute, parts=parts)
                          for t in range(0, Wp.shape[1], TILE)], axis=1)
    return out[:, :W.shape[1]]


def b6_mirror(resid, y, ln_w, ln_b, ws, biases, norm, activation, apply_norm, plan,
              unpermute=True, drop_b_down=False, eps=1e-5):
    """B6 in f32 over passes of up to 16 rows: yn = norm(y) (RMSNorm, or
    layernorm with ``ln_b`` or none; y itself without the norm), the up
    GEMV (gated: gate and up tiles on 4 warps each), u + b_up, a = act(g) *
    u or act(u), the down GEMV, (resid + down) + b_down."""
    (s1, c1, _), (s2, c2, _) = plan
    gate, up, down = ws
    b_up, b_down = biases
    B, D = y.shape
    F = up.shape[1]
    act = _act(activation)
    out = np.zeros((B, D), np.float32)
    for r0 in range(0, B, ROWS):
        x = y[r0:r0 + ROWS].astype(np.float32)
        if not apply_norm:
            yn = x
        elif norm == "rmsnorm":
            yn = x * (1 / np.sqrt((x * x).mean(-1, keepdims=True) + eps)) * ln_w
        else:
            mean = x.mean(-1, keepdims=True)
            var = ((x - mean) ** 2).mean(-1, keepdims=True)
            yn = (x - mean) * (1 / np.sqrt(var + eps)) * ln_w + (0 if ln_b is None else ln_b)
        A = np.zeros((ROWS, D), np.float32)
        A[:len(x)] = yn
        parts = 4 if gate is not None else 8
        u = gemv_bf16(A, up, D, s1, c1, parts, unpermute)
        if b_up is not None:
            u = u + b_up
        a = act(gemv_bf16(A, gate, D, s1, c1, parts, unpermute)) * u if gate is not None \
            else act(u)
        o = resid[r0:r0 + ROWS] + gemv_bf16(a, down, F, s2, c2, 8, unpermute)[:len(x)]
        if b_down is not None and not drop_b_down:
            o = o + b_down
        out[r0:r0 + ROWS] = o
    return out


B6_D, B6_F = 512, 1024
B6_NORMS = ("rmsnorm", "layernorm", "layernorm_no_bias", "none")
B6_ACTS = ("silu", "relu", "gelu_new")   # the kernel's three activation codes
B6_FORMS = [(norm, gated, biases, act) for norm in B6_NORMS for gated in (True, False)
            for biases in (True, False) for act in B6_ACTS]
B6_ROWS = (1, 8, 16, 20)
_B6 = {}


def _b6_case(norm, gated, biases, act):
    """Inputs (bf16 values in f32) for 20 rows and JAX's output over them
    (each row's output depends on that row only, so fewer rows compare with
    its first rows)."""
    key = (norm, gated, biases, act)
    if key not in _B6:
        rng = np.random.default_rng(B6_FORMS.index(key) + 31)
        D, F, B = B6_D, B6_F, max(B6_ROWS)
        resid, y = (bf16(rng.standard_normal((B, D)) + rng.standard_normal((B, 1)))
                    for _ in range(2))
        ln_w = bf16(1 + 0.1 * rng.standard_normal(D))
        ln_b = bf16(0.1 * rng.standard_normal(D)) if norm == "layernorm" else None
        ws = [bf16(rng.standard_normal(s) * s[0] ** -0.5) for s in ((D, F), (D, F), (F, D))]
        ws[0] = ws[0] if gated else None
        bs = (bf16(0.1 * rng.standard_normal(F)), bf16(0.1 * rng.standard_normal(D))) \
            if biases else (None, None)
        kw = dict(norm="rmsnorm" if norm == "rmsnorm" else "layernorm",
                  activation="swiglu" if gated and act == "silu" else act,
                  apply_norm=norm != "none", eps=1e-5)
        j = lambda a: None if a is None else jnp.asarray(a)
        want = np.asarray(jfd.fused_mlp_pallas(
            j(resid), j(y), j(ln_w), j(ln_b), j(ws[1]), j(ws[2]), j(ws[0]), j(bs[0]), j(bs[1]),
            interpret=True, **kw))
        _B6[key] = (resid, y, ln_w, ln_b, ws, bs, kw, want)
    return _B6[key]


def _b6_run(form, B, **mirror_kw):
    resid, y, ln_w, ln_b, ws, bs, kw, want = _b6_case(*form)
    plan = fd.mlp_plan(B6_D, B6_F, dg.STAGE_ROWS, ws[0] is not None, min(B, ROWS), 2, SMS)
    got = b6_mirror(resid[:B], y[:B], ln_w, ln_b, ws, bs, kw["norm"], kw["activation"],
                    kw["apply_norm"], plan, **mirror_kw)
    return got, want[:B], plan


@pytest.mark.parametrize("B", B6_ROWS)
@pytest.mark.parametrize("norm,gated,biases,act", B6_FORMS)
def test_b6_mirror_matches_the_pallas_kernel(norm, gated, biases, act, B):
    got, want, _ = _b6_run((norm, gated, biases, act), B)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_b6_plans_split_the_down_gemv_and_whole_stages():
    """At the mirror's widths the down GEMV splits K (its partials are
    added in split order), and every chunk is whole 32-row stages."""
    for gated in (True, False):
        (s1, c1, _), (s2, c2, _) = fd.mlp_plan(B6_D, B6_F, dg.STAGE_ROWS, gated, 8, 2, SMS)
        assert c1 % STAGE == 0 and c2 % STAGE == 0 and s2 > 1
        assert s1 * c1 >= B6_D > (s1 - 1) * c1 and s2 * c2 >= B6_F > (s2 - 1) * c2


@pytest.mark.parametrize("bite", ["permutation_in_place", "b_down_dropped"])
@pytest.mark.parametrize("gated", [True, False])
def test_b6_broken_mirrors_miss(bite, gated):
    kw = dict(unpermute=False) if bite == "permutation_in_place" else dict(drop_b_down=True)
    bad, want, _ = _b6_run(("rmsnorm", gated, True, "gelu_new"), 8, **kw)
    assert np.abs(bad - want).max() > 100 * 1e-5 * np.abs(want).max()   # 100x the tolerance


# ---------------------------------------------------------------------------
# B8: the mirror of the quantized matmul's decode rows on the GEMV
# ---------------------------------------------------------------------------


def b8_mirror(x, q, s, gs, fmt, plan, rnd=bf16, unpermute=True, shift=0):
    """x [M, K] @ rnd(q * s) (the B operand: bf16 with the product in f32)
    in row groups of 16 rows, each over ``plan``'s chunks: every 128-column
    tile's stages (int4: 16 packed rows, their low then high nibbles) in
    warp runs and split order. ``shift``: a broken mirror scaling each
    group with its neighbour's scales."""
    splits, chunk = plan
    M, K = x.shape
    gidx = (np.arange(K) // gs + shift) % s.shape[0]
    W = _padded(rnd(q * s[gidx]))
    out = np.zeros((M, W.shape[1]), np.float32)
    for r0 in range(0, M, ROWS):
        A = np.zeros((ROWS, K), np.float32)
        A[:min(ROWS, M - r0)] = x[r0:r0 + ROWS]
        for t in range(0, W.shape[1], TILE):
            res = gemv_tile(A, W[:, t:t + TILE], None, K, gs, fmt, splits, chunk, unpermute)
            out[r0:r0 + ROWS, t:t + TILE] = res[:min(ROWS, M - r0)]
    return out[:, :q.shape[1]]


B8_ROWS = (1, 3, 8, 16, 40)
B8_SHAPES = [(512, 384, 128), (512, 384, 64), (1024, 272, 64)]   # (K, N, gs)
_B8 = {}


def _b8_case(fmt, K, N, gs):
    key = (fmt, K, N, gs)
    if key not in _B8:
        rng = np.random.default_rng(K + N + gs + (fmt == 4) + 2 * (fmt == 8))
        x = bf16(rng.standard_normal((max(B8_ROWS), K)))
        w = (rng.standard_normal((K, N)) * K ** -0.5).astype(np.float32)
        jq = jqm.quantize_weight(jnp.asarray(w), gs, bits=fmt)
        tq = tqm.quantize_weight(torch.from_numpy(w), gs, bits=fmt)
        assert jq.group_size == tq.group_size == gs
        _B8[key] = (x, jq, *_q_values(tq))
    return _B8[key]


def _b8_plan(fmt, M, K, N, gs):
    return tqm.gemv_plan(M, K, N, gs, fmt, SMS)[:2]


@pytest.mark.parametrize("M", B8_ROWS)
@pytest.mark.parametrize("K,N,gs", B8_SHAPES)
@pytest.mark.parametrize("fmt", [8, 4, "fp8"])
def test_b8_mirror_matches_jax(fmt, K, N, gs, M):
    """bf16(q * s) in B against JAX's route over the weight it dequantizes
    to bf16, products summed in f32; q * s in f32 against JAX
    ``quant_matmul`` (its f32 route) and, where N % 128 and gs % 128, the
    Pallas kernel in interpret mode; each at the wrapper's plan and at a
    forced one of several splits."""
    x, jq, q, s = _b8_case(fmt, K, N, gs)
    x = x[:M]
    dense16 = np.asarray(jq.dequantize().astype(jnp.bfloat16).astype(jnp.float32))
    want16 = x @ dense16
    want = np.asarray(jqm.quant_matmul(jnp.asarray(x), jq))
    f32 = lambda a: a
    for plan in (_b8_plan(fmt, M, K, N, gs), (K // (2 * gs), 2 * gs)):
        got = b8_mirror(x, q, s, gs, fmt, plan)
        assert np.abs(got - want16).max() <= 1e-5 * np.abs(want16).max(), plan
        got = b8_mirror(x, q, s, gs, fmt, plan, rnd=f32)
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max(), plan
    if N % 128 == 0 and gs % 128 == 0:
        pallas = np.asarray(jqm._quant_matmul_pallas(jnp.asarray(x), jq, interpret=True))
        assert np.abs(got - pallas).max() <= 1e-5 * np.abs(pallas).max()


@pytest.mark.parametrize("bite", ["neighbour_group_scales", "permutation_in_place"])
@pytest.mark.parametrize("fmt", [8, 4, "fp8"])
def test_b8_broken_mirrors_miss(fmt, bite):
    K, N, gs = B8_SHAPES[1]
    x, jq, q, s = _b8_case(fmt, K, N, gs)
    x = x[:8]
    want = x @ np.asarray(jq.dequantize().astype(jnp.bfloat16).astype(jnp.float32))
    kw = dict(shift=1) if bite == "neighbour_group_scales" else dict(unpermute=False)
    bad = b8_mirror(x, q, s, gs, fmt, _b8_plan(fmt, 8, K, N, gs), **kw)
    assert np.abs(bad - want).max() > 100 * 1e-5 * np.abs(want).max()   # 100x the tolerance


# ---------------------------------------------------------------------------
# The plan at the split sweep's cells
# ---------------------------------------------------------------------------

# (K, unit, tiles, groups, rows, n_out, elt_bytes, splits): the split count
# the plan takes at each cell of the split sweep on the H100
# (scripts/torch_kernel_digest.py --sections gemv_plan; PERF.md section 6),
# each the sweep's fastest but B8's wk (16 splits, ~4% over 8)
SWEPT = [(14336, 32, 32, 1, 8, 4096, 2, 4),      # B6's down GEMV, Llama-3-8B, 8 rows
         (4096, 32, 112, 1, 8, 28672, 4, 1),     # B6's gated up GEMV
         (14336, 256, 32, 1, 8, 4096, 1, 4),     # B7 int8's down GEMV
         (4096, 256, 112, 1, 8, 28672, 2, 1),    # B7 int8's gated up GEMV
         (4096, 256, 112, 1, 8, 14336, 1, 1),    # B8 int8 w_gate, 8 rows
         (4096, 256, 32, 1, 8, 4096, 1, 4),      # B8 int8 wq
         (4096, 256, 8, 1, 8, 1024, 1, 16),      # B8 int8 wk
         (14336, 256, 32, 1, 8, 4096, 1, 4),     # B8 int8 w_down
         (14336, 32, 32, 8, 16, 4096, 2, 1),     # B16 bf16 w_down, 16 rows
         (4096, 32, 112, 8, 16, 14336, 2, 1)]    # B16 bf16 w_gate, 16 rows


@pytest.mark.parametrize("K,unit,tiles,groups,rows,n_out,elt,splits", SWEPT)
def test_plan_takes_the_swept_split_counts(K, unit, tiles, groups, rows, n_out, elt, splits):
    got, chunk = dg.plan(K, unit, tiles, groups, rows, n_out, elt, SMS)
    assert got == splits and chunk == -(-(-(-K // unit)) // splits) * unit


# ---------------------------------------------------------------------------
# The wrappers' C arguments
# ---------------------------------------------------------------------------


@pytest.fixture
def recorded(monkeypatch):
    calls, made = {}, {}
    for mod in (fd, tqm):
        monkeypatch.setattr(mod, "_lib", lambda: _Lib(calls))
        monkeypatch.setattr(mod, "_sms", lambda dev: SMS)
    monkeypatch.setattr(dg, "_COUNTERS", {})
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: type("S", (), {"cuda_stream": 7}))
    # the operand checks want CUDA tensors; these are CPU stand-ins
    monkeypatch.setattr(fd, "_bf16", lambda name, t, device, shape=None: t)
    monkeypatch.setattr(fd, "_vector", lambda name, t, device, n: t)
    real_empty = torch.empty

    def empty(*shape, **kw):
        t = real_empty(*shape, **kw)
        made[t.data_ptr()] = (tuple(t.shape), t.dtype)
        return t

    monkeypatch.setattr(torch, "empty", empty)
    return calls, made


@pytest.mark.parametrize("biases", [True, False])
@pytest.mark.parametrize("gated", [True, False])
@pytest.mark.parametrize("B", [1, 9, 16, 20])
def test_b6_wrapper_hands_the_entry_point_its_plan_and_workspaces(recorded, gated, biases, B):
    calls, made = recorded
    D, F = 512, 1024
    w = [torch.zeros(*s, dtype=torch.bfloat16) for s in ((D, F), (D, F), (F, D))]
    h = torch.zeros(B, D, dtype=torch.bfloat16)
    ln_w, ln_b = torch.ones(D, dtype=torch.bfloat16), torch.zeros(D, dtype=torch.bfloat16)
    b_up, b_down = (torch.zeros(F, dtype=torch.bfloat16), torch.zeros(D, dtype=torch.bfloat16)) \
        if biases else (None, None)
    out = fd._launch_mlp(h, h, ln_w, w[1], w[2], w[0] if gated else None, 1e-5, ln_b=ln_b,
                         b_up=b_up, b_down=b_down, norm="layernorm",
                         activation="swiglu" if gated else "gelu_new")
    args = calls.pop("sxt_fused_mlp_bf16")
    assert not calls and len(args) == len(fd._SIGNATURES["sxt_fused_mlp_bf16"]) == 27
    ptr = lambda t: None if t is None else t.data_ptr()
    assert args[:10] == (h.data_ptr(), h.data_ptr(), ln_w.data_ptr(), ln_b.data_ptr(),
                         ptr(w[0] if gated else None), w[1].data_ptr(), w[2].data_ptr(),
                         ptr(b_up), ptr(b_down), out.data_ptr())
    rows = min(B, ROWS)
    (s1, c1, b1), (s2, c2, b2) = fd.mlp_plan(D, F, STAGE, gated, rows, 2, SMS)
    assert args[14:] == (B, D, F, s1, c1, s2, c2, b1, b2, 1, 0 if gated else 2, 1e-5, 7)
    assert made[args[10]] == ((rows, F), torch.bfloat16)
    assert (args[11] is None) == (s1 == 1) and (args[12] is None) == (s2 == 1)
    if s1 > 1:
        assert made[args[11]] == ((s1, rows, (2 if gated else 1) * F), torch.float32)
    if s2 > 1:
        assert made[args[12]] == ((s2, rows, D), torch.float32)
    if s1 > 1 or s2 > 1:
        counters = dg._COUNTERS[(h.device, 7)]
        assert args[13] == counters.data_ptr() and not counters.any()
        assert counters.numel() >= max(-(-F // TILE), -(-D // TILE))
    else:
        assert args[13] is None


@pytest.mark.parametrize("D,F", [(520, 1024), (512, 1020)])
def test_b6_wrapper_refuses_widths_the_gemv_does_not_take(recorded, D, F):
    """D a multiple of 32 (the up GEMV's A operand reads whole 32-row
    stages of a row), F of 8 (TMA's 16-byte row pitch); refused before any
    launch."""
    calls, _ = recorded
    w = [torch.zeros(*s, dtype=torch.bfloat16) for s in ((D, F), (F, D))]
    h = torch.zeros(8, D, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of 32"):
        fd._launch_mlp(h, h, torch.ones(D, dtype=torch.bfloat16), w[0], w[1], None, 1e-5,
                       ln_b=None, b_up=None, b_down=None, norm="rmsnorm", activation="relu")
    assert not calls


@pytest.mark.parametrize("fmt", [8, 4, "fp8"])
@pytest.mark.parametrize("M", [1, 3, 8, 16, "gemv_rows", "past"])
def test_b8_wrapper_hands_the_gemv_its_plan_and_counters(recorded, fmt, M):
    calls, made = recorded
    M = {"gemv_rows": tqm.GEMV_ROWS, "past": tqm.GEMV_ROWS + 1}.get(M, M)
    K, N, gs = 1024, 272, 64
    qm = tqm.quantize_weight(torch.randn(K, N), gs, bits=fmt).to(None, torch.bfloat16)
    x = torch.zeros(M, K, dtype=torch.bfloat16)
    out = tqm._launch(x, qm)
    args = calls.pop("sxt_quant_matmul_bf16")
    assert not calls and out.shape == (M, N) and args[14:] == (tqm.GEMV_ROWS, 7)
    if M > tqm.GEMV_ROWS:   # the wgmma form: no GEMV plan, blocks or counters
        assert args[5] is None and args[13] == 0
        return
    splits, chunk, blocks = tqm.gemv_plan(M, K, N, gs, qm.bits, SMS)
    groups, tiles = -(-M // ROWS), -(-N // TILE)
    assert (splits, chunk, blocks) == dg.plan(K, gs, tiles, groups, M, N,
                                              0.5 if fmt == 4 else 1, SMS) + (
        dg.blocks(groups * tiles * splits, SMS),)
    assert args[11:14] == (splits, chunk, blocks) and chunk % gs == 0
    if splits == 1:
        assert args[4] is None and args[5] is None
    else:
        assert made[args[4]] == ((splits, M, N), torch.float32)
        counters = dg._COUNTERS[(x.device, 7)]
        assert args[5] == counters.data_ptr() and not counters.any()
        assert counters.numel() >= groups * tiles


# ---------------------------------------------------------------------------
# The replaced kernels
# ---------------------------------------------------------------------------

_DIGEST = importlib.util.spec_from_file_location(
    "torch_kernel_digest", Path(__file__).resolve().parents[1] / "scripts" / "torch_kernel_digest.py")
digest = importlib.util.module_from_spec(_DIGEST)
_DIGEST.loader.exec_module(digest)


@pytest.mark.parametrize("rows,D,tree", [(1, 4096, 512), (2, 4096, 256), (8, 4096, 64),
                                         (16, 4096, 32), (20, 4096, 32), (3, 3072, 256),
                                         (8, 2560, 64), (1, 768, 128), (16, 768, 32)])
def test_b6_rms_statistics_follow_pytorchs_reduction_order(rows, D, tree):
    """B6's RMSNorm sums x^2 in the order of PyTorch's CUDA reduction of the
    plain version's (x * x).mean(-1) (rows_tree threads a row, 4
    accumulators a thread, a halving tree, shuffles down 16 ... 1; the
    digest's ``B6 statistics order`` cells hold it bit-equal to PyTorch's on
    the card): the order's mirror is the mean within f32 rounding, the
    thread count is the C entry point's, and only B6's RMSNorm takes it (B7
    keeps its statistics)."""
    rng = np.random.default_rng(rows * D)
    x = bf16(rng.standard_normal((rows, D)) * 1.5)
    assert digest.rows_tree(rows, D) == tree
    got = digest.sumsq_mean_kernel_order(x)
    want = (x.astype(np.float64) ** 2).mean(-1)
    np.testing.assert_allclose(got, want, rtol=2 ** -20)
    src = (CSRC / "fused_decode.cu").read_text()
    body = src.split("void rms_stats_torch_order(", 1)[1].split("\n}\n", 1)[0]
    assert "for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync" in body
    assert "for (int h = tree / 2; h >= 32; h >>= 1)" in body
    assert "rsqrtf(__fadd_rn(__fmul_rn(s, 1.0f / float(D)), eps))" in body   # no FMA
    assert "act, eps, rows_tree(B, D)};" in src
    assert "if constexpr (FMT == tcg::kBf16 && NORM == kRmsNorm)" in src


def test_b6_adds_each_stage_to_f32_accumulators():
    """B6's GEMVs sum each stage's 32 products on the tensor cores into a
    zeroed accumulator and add it to the f32 sums (``add_stage``: all of K
    on the tensor cores rounded a the other way from the f64 function 3.6x
    as often as the plain version's f32 sums on the card); B7 folds its
    scale groups as before, and B16's and B8's GEMVs keep their form."""
    cuh = (CSRC / "mma_gemv.cuh").read_text()
    body = cuh.split("if constexpr (GSUM) {", 1)[1].split("} else {", 1)[0]
    assert "if constexpr (FMT == kBf16)\n          add_stage(acc, gacc);" in body
    assert "fold_group(acc, gacc," in body
    fused = (CSRC / "fused_decode.cu").read_text()
    assert fused.count("tcg::run<FMT, false, true>(") == 2
    assert "tcg::run<FMT, FMT != tcg::kBf16, false>(" in (CSRC / "grouped_gemm.cu").read_text()
    assert "tcg::run<FMT, true, false>(" in (CSRC / "quant_matmul.cu").read_text()


_ROUNDING = importlib.util.spec_from_file_location(
    "torch_b6_rounding", Path(__file__).resolve().parents[1] / "scripts" / "torch_b6_rounding.py")
rounding = importlib.util.module_from_spec(_ROUNDING)
_ROUNDING.loader.exec_module(rounding)


def test_b6_rounding_reads_yn_and_a_back_through_identity_weights():
    """scripts/torch_b6_rounding.py reads B6's yn and a back through
    identity weights; on the CPU (the plain version on both sides) every
    count is 0, so on the card each counts the kernel's own roundings
    (F = 160 over D = 64: a partial block of a's columns too)."""
    g = torch.Generator().manual_seed(3)
    D, F = 64, 160
    h = torch.randn(8, D, generator=g).bfloat16()
    ln_w = (1 + 0.1 * torch.randn(D, generator=g)).bfloat16()
    wg, wu = [(torch.randn(D, F, generator=g) * D ** -0.5).bfloat16() for _ in range(2)]
    wd = (torch.randn(F, D, generator=g) * F ** -0.5).bfloat16()
    got = rounding.analyse(h, ln_w, wg, wu, wd)
    assert got["ratio"] == 0 and got["yn_mis"] == 0 and got["a_k_p"] == 0
    assert got["a_k_64"] == got["a_p_64"]


def test_dense_widths_off_the_stages_stay_unfused():
    """Dense weights whose D is not a multiple of 32 (the GEMV's stage) or
    whose F is not a multiple of 8 get a reason, so the engine keeps the
    MLP on its layer body instead of calling a kernel that refuses them."""
    def reason(D, F):
        return fd.mlp_weights_fusable(torch.zeros(D, F), torch.zeros(F, D), torch.zeros(D, F))

    assert reason(64, 256) is None and reason(4096, 14336) is None
    assert "multiple of 32" in reason(48, 256) and "multiple of 32" in reason(64, 252)


GONE = ("quant_gemv_kernel", "launch_quant_gemv", "QMats", "make_qmats", "bad_qsplit",
        "kQThreads", "kQTN", "kQTPR", "kQRG", "kQMaxRows", "kQChunk", "kQUnroll",
        "norm_rows_kernel", "norm_input", "act_epilogue_kernel", "residual_epilogue_kernel",
        "q_value", "fp8_to_float", "deq<")


def test_the_replaced_kernels_are_gone():
    """The CUDA-core GEMV of B8's decode rows and B6's norm and epilogue
    kernels exist in no source, and no comment cites them (their header
    is gone, its format enum in mma_gemv.cuh); B6's entry point
    runs the GEMV's two kernels a pass, and the CUDA-core bf16 GEMV
    (``gemv_partial_kernel``) is B4's alone."""
    sources = {p.name: p.read_text() for p in CSRC.iterdir()}
    for gone in GONE:
        assert not any(re.search(rf"\b{re.escape(gone)}", t) for t in sources.values()), gone
    assert "quant_gemv.cuh" not in sources   # its format enum moved into mma_gemv.cuh
    assert "enum QFormat { kQInt8 = 0, kQInt4 = 1, kQFp8 = 2 };" in sources["mma_gemv.cuh"]
    fused = sources["fused_decode.cu"]
    b6 = fused.split("int sxt_fused_mlp_bf16(", 1)[1].split("\n}\n", 1)[0]
    assert "mlp_passes<tcg::kBf16>" in b6 and "<<<" not in b6
    qkv = fused.split("int sxt_fused_qkv_rope_bf16(", 1)[1].split("\n}\n", 1)[0]
    assert fused.count("gemv_partial_kernel<<<") == qkv.count("gemv_partial_kernel<<<") == 1
    py = Path(tqm.__file__).read_text() + Path(fd.__file__).read_text()
    assert "quant_splits" not in py and "mlp_quant_plan" not in py and "environ" not in py
